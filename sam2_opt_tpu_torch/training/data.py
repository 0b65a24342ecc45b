"""VOS training data pipeline (host side, numpy).

A copy of the parts of `sam2_opt_tpu/training/data.py` that the trainer's
PNG path runs (the port imports nothing of the JAX package): the DAVIS/MOSE
folder reader, the frame samplers, the per-video augmentations, the dataset
and the batching (reference sam2/training/dataset/). The SA-V readers
(per-object PNG trees, JSON/RLE manifests) and the mixed-dataset loader are
not ported yet. Pillow is imported where images are read.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class VOSVideo:
    video_name: str
    frames: List[str]           # image paths (aligned with frame_ids)
    masks: Optional[List[str]]  # palette png paths per frame, or None
    segment_loader: Optional[object] = None  # used when masks is None
    frame_ids: Optional[List[int]] = None    # underlying id per frame entry


class VOSRawDataset:
    """Base reader returning (video, segment loader) pairs
    (reference vos_raw_dataset.py:56)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def get_video(self, idx: int) -> VOSVideo:
        raise NotImplementedError


class PNGRawDataset(VOSRawDataset):
    """DAVIS/MOSE-style layout: <img_folder>/<video>/<frame>.jpg and
    <gt_folder>/<video>/<frame>.png (reference PNGRawDataset)."""

    def __init__(self, img_folder: str, gt_folder: str,
                 file_list_txt: Optional[str] = None):
        self.img_folder = img_folder
        self.gt_folder = gt_folder
        if file_list_txt:
            with open(file_list_txt) as f:
                self.video_names = [l.strip() for l in f if l.strip()]
        else:
            self.video_names = sorted(os.listdir(img_folder))

    def __len__(self):
        return len(self.video_names)

    def get_video(self, idx: int) -> VOSVideo:
        name = self.video_names[idx]
        vdir = os.path.join(self.img_folder, name)
        frames = sorted(
            os.path.join(vdir, p) for p in os.listdir(vdir)
            if p.lower().endswith((".jpg", ".jpeg", ".png"))
        )
        gdir = os.path.join(self.gt_folder, name)
        masks = None
        if os.path.isdir(gdir):
            masks = [
                os.path.join(gdir, os.path.splitext(os.path.basename(p))[0] + ".png")
                for p in frames
            ]
        return VOSVideo(name, frames, masks)


@dataclasses.dataclass
class SampledFrames:
    frame_indices: List[int]
    reverse: bool = False


class RandomUniformSampler:
    """Sample num_frames uniformly at random, sorted
    (reference vos_sampler.py:31)."""

    def __init__(self, num_frames: int, max_num_objects: int = 3,
                 reverse_time_prob: float = 0.0):
        self.num_frames = num_frames
        self.max_num_objects = max_num_objects
        self.reverse_time_prob = reverse_time_prob

    def sample(self, num_video_frames: int, rng: random.Random) -> SampledFrames:
        if num_video_frames <= self.num_frames:
            idxs = list(range(num_video_frames))
            idxs += [num_video_frames - 1] * (self.num_frames - len(idxs))
        else:
            start = rng.randint(0, num_video_frames - self.num_frames)
            idxs = list(range(start, start + self.num_frames))
        reverse = rng.random() < self.reverse_time_prob
        return SampledFrames(idxs[::-1] if reverse else idxs, reverse)


class EvalSampler:
    """All frames, in order (reference vos_sampler.py:81)."""

    def sample(self, num_video_frames: int, rng=None) -> SampledFrames:
        return SampledFrames(list(range(num_video_frames)))


def _load_image(path: str, size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def _load_mask(path: str, size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.size != (size, size):
        img = img.resize((size, size), Image.NEAREST)
    return np.asarray(img)


def _resize_mask_bool(mask: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    if mask.shape[0] == size and mask.shape[1] == size:
        return mask.astype(bool)
    img = Image.fromarray(mask.astype(np.uint8) * 255)
    return np.asarray(img.resize((size, size), Image.NEAREST)) > 127


class VideoAugmentations:
    """Per-video consistent photometric + geometric augmentations (reference
    training/dataset/transforms.py: ColorJitter, RandomGrayscale,
    RandomAffine, RandomHorizontalFlip — 528 LoC of torchvision-v2 video
    transforms re-done in PIL/numpy). One parameter draw per video, applied
    to every frame, nearest-resampled for masks."""

    def __init__(self, hflip_prob: float = 0.5, color_jitter_prob: float = 0.8,
                 brightness: float = 0.1, contrast: float = 0.03,
                 saturation: float = 0.03, grayscale_prob: float = 0.05,
                 affine_prob: float = 1.0, degrees: float = 25.0,
                 shear: float = 20.0, affine_tentatives: int = 4,
                 mosaic_prob: float = 0.0, mosaic_grid: int = 2,
                 mosaic_hflip: bool = False):
        """Defaults follow the shipped MOSE finetune recipe
        (configs/sam2.1_training/sam2.1_hiera_b+_MOSE_finetune.yaml):
        RandomAffine(degrees=25, shear=20) applies unconditionally
        (affine_prob=1.0) with the reference's zero-area retry
        (transforms.py:344-358); RandomMosaicVideoAPI exists in the
        reference transform zoo (transforms.py:498-560) but is NOT part of
        the MOSE recipe, so mosaic_prob defaults to 0."""
        self.hflip_prob = hflip_prob
        self.color_jitter_prob = color_jitter_prob
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.grayscale_prob = grayscale_prob
        self.affine_prob = affine_prob
        self.degrees = degrees
        self.shear = shear
        self.affine_tentatives = affine_tentatives
        self.mosaic_prob = mosaic_prob
        self.mosaic_grid = mosaic_grid
        self.mosaic_hflip = mosaic_hflip

    def __call__(self, images: np.ndarray, masks: np.ndarray, rng):
        """images [T,S,S,3] uint8, masks [T,N,S,S] bool -> same shapes."""
        from PIL import Image, ImageEnhance

        if rng.random() < self.hflip_prob:
            images = images[:, :, ::-1].copy()
            masks = masks[:, :, :, ::-1].copy()

        if rng.random() < self.color_jitter_prob:
            b = 1.0 + rng.uniform(-self.brightness, self.brightness)
            c = 1.0 + rng.uniform(-self.contrast, self.contrast)
            s = 1.0 + rng.uniform(-self.saturation, self.saturation)
            frames = []
            for t in range(images.shape[0]):
                im = Image.fromarray(images[t])
                im = ImageEnhance.Brightness(im).enhance(b)
                im = ImageEnhance.Contrast(im).enhance(c)
                im = ImageEnhance.Color(im).enhance(s)
                frames.append(np.asarray(im))
            images = np.stack(frames)

        if rng.random() < self.grayscale_prob:
            gray = (
                images.astype(np.float32) @ np.asarray([0.299, 0.587, 0.114])
            ).astype(np.uint8)
            images = np.repeat(gray[..., None], 3, axis=-1)

        if self.affine_prob > 0 and rng.random() < self.affine_prob:
            # zero-area retry: redraw params while the transform wipes out
            # ANY object's first-frame mask (per object, so a surviving
            # neighbor can't mask a wiped target), then skip (reference
            # RandomAffine tentatives, transforms.py:344-358)
            present = masks[0].any(axis=(-2, -1))  # [N] objects with frame-0 area
            for _ in range(max(self.affine_tentatives, 1)):
                angle = rng.uniform(-self.degrees, self.degrees)
                shear_x = rng.uniform(-self.shear, self.shear)
                a_imgs, a_masks = self._affine(images, masks, angle, shear_x)
                if bool(np.all(a_masks[0].any(axis=(-2, -1)) >= present)):
                    images, masks = a_imgs, a_masks
                    break

        if self.mosaic_prob > 0 and rng.random() < self.mosaic_prob:
            images, masks = self._mosaic(images, masks, rng)
        return images, masks

    def _affine(self, images, masks, angle, shear_x):
        from PIL import Image

        frames, mframes = [], []
        for t in range(images.shape[0]):
            im = Image.fromarray(images[t]).rotate(
                angle, Image.BILINEAR
            ).transform(
                images[t].shape[:2][::-1], Image.AFFINE,
                (1, np.tan(np.radians(shear_x)), 0, 0, 1, 0),
                Image.BILINEAR,
            )
            frames.append(np.asarray(im))
            ms = []
            for n in range(masks.shape[1]):
                m = Image.fromarray(
                    masks[t, n].astype(np.uint8) * 255
                ).rotate(angle, Image.NEAREST).transform(
                    masks[t, n].shape[::-1], Image.AFFINE,
                    (1, np.tan(np.radians(shear_x)), 0, 0, 1, 0),
                    Image.NEAREST,
                )
                ms.append(np.asarray(m) > 127)
            mframes.append(np.stack(ms))
        return np.stack(frames), np.stack(mframes)

    def _mosaic(self, images, masks, rng):
        """Video mosaic (reference RandomMosaicVideoAPI + random_mosaic_frame,
        transforms.py:434-560): every frame becomes a grid of downscaled
        copies of itself (optionally per-cell h-flipped); the target masks
        survive only in one randomly chosen target cell. One draw per video."""
        from PIL import Image

        g = self.mosaic_grid
        T, H, W = images.shape[0], images.shape[1], images.shape[2]
        ty = rng.randrange(g)
        tx = rng.randrange(g)
        flip = (
            np.asarray([[rng.random() < 0.5 for _ in range(g)] for _ in range(g)])
            if self.mosaic_hflip
            else np.zeros((g, g), bool)
        )
        out_imgs = np.zeros_like(images)
        out_masks = np.zeros_like(masks)
        for t in range(T):
            cache = {}
            for gy in range(g):
                for gx in range(g):
                    y0, y1 = gy * H // g, (gy + 1) * H // g
                    x0, x1 = gx * W // g, (gx + 1) * W // g
                    key = (y1 - y0, x1 - x0)
                    if key not in cache:
                        cache[key] = np.asarray(
                            Image.fromarray(images[t]).resize(
                                (key[1], key[0]), Image.BILINEAR
                            )
                        )
                    tile = cache[key]
                    if flip[gy, gx]:
                        tile = tile[:, ::-1]
                    out_imgs[t, y0:y1, x0:x1] = tile
            y0, y1 = ty * H // g, (ty + 1) * H // g
            x0, x1 = tx * W // g, (tx + 1) * W // g
            for n in range(masks.shape[1]):
                m = np.asarray(
                    Image.fromarray(masks[t, n].astype(np.uint8) * 255).resize(
                        (x1 - x0, y1 - y0), Image.NEAREST
                    )
                ) > 127
                if flip[ty, tx]:
                    m = m[:, ::-1]
                out_masks[t, n, y0:y1, x0:x1] = m
        return out_imgs, out_masks


class VOSDataset:
    """Raw dataset + sampler + augmentation -> per-video training sample
    (reference vos_dataset.py:27). Yields dicts of dense numpy arrays:

      images   [T, S, S, 3] uint8
      masks    [T, N_obj, S, S] bool  (padded to max_num_objects)
      obj_valid [N_obj] bool

    `multiplier` is the reference's repeat-factor (vos_dataset.py:43-44):
    each raw video appears `multiplier` times per epoch.
    """

    def __init__(self, raw_dataset: VOSRawDataset, sampler,
                 image_size: int = 1024, max_num_objects: int = 3,
                 hflip_prob: float = 0.5, seed: int = 0,
                 transforms: Optional[VideoAugmentations] = None,
                 multiplier: int = 1):
        self.raw = raw_dataset
        self.sampler = sampler
        self.image_size = image_size
        self.max_num_objects = max_num_objects
        self.transforms = (
            transforms if transforms is not None
            else VideoAugmentations(hflip_prob=hflip_prob)
        )
        if transforms is None and hflip_prob == 0.0:
            # back-compat: hflip_prob=0 historically meant "no augmentation"
            self.transforms = VideoAugmentations(
                hflip_prob=0.0, color_jitter_prob=0.0, grayscale_prob=0.0,
                affine_prob=0.0,
            )
        self.multiplier = max(int(multiplier), 1)
        self._seed = seed
        self._epoch = 0
        self.rng = random.Random(seed)  # kept for callers that seeded it

    def set_epoch(self, epoch: int):
        """Re-key per-item augmentation for a new epoch (the role of torch
        DistributedSampler.set_epoch in the reference's loader,
        training/utils/distributed.py)."""
        self._epoch = int(epoch)

    def _item_rng(self, idx: int) -> random.Random:
        # Index+epoch-keyed (NOT stateful): item idx gets the same sampling
        # and augmentation regardless of access order or which process
        # loads it — required for multi-process data sharding, where each
        # process materializes a different subset of the global batch.
        # Explicit arithmetic (not hash()) so PYTHONHASHSEED randomization
        # cannot desynchronize processes.
        return random.Random(
            (self._seed * 1_000_003 + self._epoch) * 1_000_033 + idx
        )

    def __len__(self):
        return len(self.raw) * self.multiplier

    def _load_frame_segments(self, video: VOSVideo, frame_indices) -> List[Dict]:
        """Per sampled frame: {obj_id: bool mask at native res}."""
        if video.masks is not None:
            out = []
            for i in frame_indices:
                m = _load_mask(video.masks[i], self.image_size)
                out.append({int(v): m == v for v in np.unique(m) if v > 0})
            return out
        if video.segment_loader is not None:
            ids = video.frame_ids or list(range(len(video.frames)))
            return [video.segment_loader.load(ids[i]) for i in frame_indices]
        return [{} for _ in frame_indices]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = self._item_rng(idx)
        video = self.raw.get_video(idx % len(self.raw))
        # Tracked objects must be VISIBLE IN THE FIRST sampled frame — the
        # rollout prompts frame 0 from GT, and an empty first-frame mask
        # yields a bogus prompt. The reference resamples the frame window
        # until the first frame has a target (vos_sampler.py:44-72).
        for _retry in range(100):
            sampled = self.sampler.sample(len(video.frames), rng)
            # only the FIRST frame's segments decide acceptance — decode just
            # that one per retry, and the remaining T-1 once after accepting
            first = self._load_frame_segments(video, sampled.frame_indices[:1])
            visible_ids = sorted(
                oid for oid, seg in first[0].items() if np.any(seg)
            )
            if visible_ids:
                segments = first + self._load_frame_segments(
                    video, sampled.frame_indices[1:]
                )
                break
        else:
            raise RuntimeError(
                f"no visible objects in the first sampled frame of "
                f"{video.video_name} after 100 retries"
            )
        S = self.image_size
        images = np.stack(
            [_load_image(video.frames[i], S) for i in sampled.frame_indices]
        )
        T = images.shape[0]
        N = self.max_num_objects
        masks = np.zeros((T, N, S, S), bool)
        obj_valid = np.zeros((N,), bool)
        obj_ids = list(visible_ids)
        rng.shuffle(obj_ids)
        obj_ids = obj_ids[:N]
        for j, oid in enumerate(obj_ids):
            obj_valid[j] = True
            for t, seg in enumerate(segments):
                if oid in seg:
                    masks[t, j] = _resize_mask_bool(seg[oid], S)

        images, masks = self.transforms(images, masks, rng)
        return {"images": images, "masks": masks, "obj_valid": obj_valid,
                "video_name": video.video_name}


def collate_videos(samples: List[Dict]) -> Dict[str, np.ndarray]:
    """Batch per-video samples into dense arrays
    (reference utils/data_utils.py:36-128 BatchedVideoDatapoint/collate_fn):
    images [B, T, S, S, 3], masks [B, T, N, S, S], obj_valid [B, N]."""
    return {
        "images": np.stack([s["images"] for s in samples]),
        "masks": np.stack([s["masks"] for s in samples]),
        "obj_valid": np.stack([s["obj_valid"] for s in samples]),
    }


def data_loader(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = True,
                batch_rows: Optional[Sequence[int]] = None,
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Simple epoch iterator (replaces torch DataLoader for the host side).

    `batch_rows`: multi-process data sharding (the reference's per-rank
    DistributedSampler, training/utils/distributed.py + trainer.py:291-311).
    `batch_size` is then the GLOBAL batch size; every process builds the
    same shuffled global order from the shared seed but materializes
    (loads + augments) ONLY the rows of each global batch listed in
    `batch_rows` (from `parallel.mesh.process_local_batch_rows`), yielding
    local batches of len(batch_rows) rows tagged with the global size.
    Requires drop_last (a ragged final global batch would shard unevenly).
    """
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed).shuffle(order)
    if batch_rows is not None:
        assert drop_last, "batch_rows (multi-process sharding) needs drop_last"
        rows = list(batch_rows)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            chunk = order[start : start + batch_size]
            out = collate_videos([dataset[chunk[r]] for r in rows])
            out["global_batch_size"] = batch_size
            yield out
        return
    batch = []
    for idx in order:
        batch.append(dataset[idx])
        if len(batch) == batch_size:
            yield collate_videos(batch)
            batch = []
    if batch and not drop_last:
        yield collate_videos(batch)
