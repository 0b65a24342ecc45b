"""VOS training data pipeline (host side, numpy).

A copy of `sam2_opt_tpu/training/data.py` (the port imports nothing of the
JAX package; reference sam2/training/dataset/): the COCO RLE codec, the
segment loaders (palettised PNG, per-object PNG, SA-V JSON/RLE manifests),
the DAVIS/MOSE folder reader and the SA-V reader, the frame samplers, the
per-video augmentations, the dataset, the mixed-dataset loader and the
batching. Pillow is imported where images are read.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import json
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


# COCO RLE codec (pure numpy; the reference decodes SA-V manifests with
# pycocotools, vos_segment_loader.py:17-19,70-73)

def _leb_decode_counts(s) -> List[int]:
    """Decode COCO's compressed LEB128-style counts string."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i, n = 0, len(s)
    while i < n:
        x = k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _leb_encode_counts(counts: Sequence[int]) -> str:
    """Inverse of `_leb_decode_counts`."""
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if (c & 0x10) else x != 0
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def decode_coco_rle(rle: Dict) -> np.ndarray:
    """{"size": [H, W], "counts": str | bytes | list} -> bool [H, W]. Runs
    are column-major (Fortran order), starting with background."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _leb_decode_counts(counts)
    flat = np.zeros(h * w, bool)
    pos, val = 0, False
    for c in counts:
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    return flat.reshape((w, h)).T


def encode_coco_rle(mask: np.ndarray) -> Dict:
    """bool [H, W] -> compressed COCO RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # column-major
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": _leb_encode_counts(counts)}


# segment loaders (reference vos_segment_loader.py)

class PalettisedPNGSegmentLoader:
    """Masks stored as one palettised PNG per frame; pixel value = object id
    (reference PalettisedPNGSegmentLoader :103-148)."""

    def __init__(self, video_png_root: str):
        self.root = video_png_root
        self.frame_id_to_png = {}
        for fn in os.listdir(video_png_root):
            stem, ext = os.path.splitext(fn)
            if ext.lower() == ".png":
                self.frame_id_to_png[int(stem)] = os.path.join(video_png_root, fn)

    def load(self, frame_id: int) -> Dict[int, np.ndarray]:
        from PIL import Image

        with Image.open(self.frame_id_to_png[frame_id]) as img:
            arr = np.asarray(img.convert("P"))
        return {int(v): arr == v for v in np.unique(arr) if v != 0}


class MultiplePNGSegmentLoader:
    """SA-V layout: one binary PNG per object per frame under
    <video>/<obj_id>/<frame:05d>.png; a missing file is an empty mask
    (reference MultiplePNGSegmentLoader :151-227).

    Object ids are <dir name> + 1, the palette convention where 0 is the
    background; `JSONSegmentLoader`'s ids are 0-based masklet indices (the
    SA-V JSON has no background entry), so the two layouts' ids are
    consistent within a video but not comparable across layouts."""

    def __init__(self, video_png_root: str):
        from PIL import Image

        self.root = video_png_root
        sample = _glob.glob(os.path.join(video_png_root, "*", "*.png"))
        if not sample:
            raise FileNotFoundError(f"no per-object masks under {video_png_root}")
        with Image.open(sample[0]) as img:
            self.H, self.W = np.asarray(img).shape[:2]
        self.obj_dirs = sorted(d for d in _glob.glob(os.path.join(video_png_root, "*"))
                               if os.path.isdir(d))

    def load(self, frame_id: int) -> Dict[int, np.ndarray]:
        from PIL import Image

        out = {}
        for d in self.obj_dirs:
            obj_id = int(os.path.basename(d)) + 1  # the background is 0
            path = os.path.join(d, f"{frame_id:05d}.png")
            if os.path.exists(path):
                with Image.open(path) as img:
                    out[obj_id] = np.asarray(img) > 0
            else:
                out[obj_id] = np.zeros((self.H, self.W), bool)
        return out


class JSONSegmentLoader:
    """SA-V manifest: <video>.json with per-frame lists of COCO RLEs (field
    "masklet"), annotated every `ann_every` frames (6 fps annotations on 24
    fps video: ann_every = 4; reference JSONSegmentLoader :23-101). Object
    ids are 0-based masklet indices (see `MultiplePNGSegmentLoader`)."""

    def __init__(self, video_json_path: str, ann_every: int = 1, frames_fps: int = 24):
        self.ann_every = ann_every
        with open(video_json_path) as f:
            data = json.load(f)
        if isinstance(data, list):
            self.frame_annots = data
        else:
            self.frame_annots = data["masklet" if "masklet" in data else "masks"]
            if "fps" in data:
                fps = data["fps"]
                ann_fps = int(fps[0] if isinstance(fps, list) else fps)
                if frames_fps % ann_fps:
                    raise ValueError(f"{video_json_path}: annotations at {ann_fps} fps do not "
                                     f"divide the frames' {frames_fps} fps")
                self.ann_every = frames_fps // ann_fps

    def load(self, frame_id: int, obj_ids: Optional[Sequence[int]] = None
             ) -> Dict[int, np.ndarray]:
        if frame_id % self.ann_every:
            raise ValueError(f"frame {frame_id} is not annotated (every {self.ann_every})")
        rles = self.frame_annots[frame_id // self.ann_every]
        out = {}
        for oid in (range(len(rles)) if obj_ids is None else obj_ids):
            rle = rles[oid] if oid < len(rles) else None
            if rle is not None:
                out[int(oid)] = decode_coco_rle(rle)
        return out

    def get_valid_obj_frames_ids(self, num_frames_min: Optional[int] = None):
        """Per object, the annotated frame ids with a mask (reference
        :83-101); objects with fewer than `num_frames_min` are dropped."""
        num_objects = len(self.frame_annots[0])
        res = {oid: [] for oid in range(num_objects)}
        for ann_idx, annot in enumerate(self.frame_annots):
            for oid in range(num_objects):
                if annot[oid] is not None:
                    res[oid].append(int(ann_idx * self.ann_every))
        if num_frames_min is not None:
            res = {oid: f for oid, f in res.items() if len(f) >= num_frames_min}
        return res


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


class SAVRawDataset(VOSRawDataset):
    """SA-V layout: JPEGImages_24fps/<video>/<frame>.jpg with annotations
    either as per-object PNG trees (Annotations_6fps/<video>/<obj>/<frame>.png)
    or as per-video JSON/RLE manifests (<sav_root>/<video>.json). The
    annotations run at 6 fps on 24 fps frames, so only every `ann_every`-th
    frame is listed (reference JSONRawDataset and vos_segment_loader.py)."""

    def __init__(self, sav_root: str, ann_every: int = 4):
        self.img_root = os.path.join(sav_root, "JPEGImages_24fps")
        self.ann_root = os.path.join(sav_root, "Annotations_6fps")
        self.json_root = sav_root
        self.ann_every = ann_every
        self.video_names = sorted(os.listdir(self.img_root))

    def __len__(self):
        return len(self.video_names)

    def get_video(self, idx: int) -> VOSVideo:
        name = self.video_names[idx]
        vdir = os.path.join(self.img_root, name)
        frames, frame_ids = [], []
        for p in sorted(p for p in os.listdir(vdir) if p.lower().endswith(".jpg")):
            fid = int(os.path.splitext(p)[0])
            if fid % self.ann_every == 0:
                frames.append(os.path.join(vdir, p))
                frame_ids.append(fid)
        loader = None
        png_dir = os.path.join(self.ann_root, name)
        json_path = os.path.join(self.json_root, f"{name}.json")
        if os.path.isdir(png_dir):
            loader = MultiplePNGSegmentLoader(png_dir)
        elif os.path.exists(json_path):
            loader = JSONSegmentLoader(json_path, ann_every=self.ann_every)
        return VOSVideo(name, frames, None, segment_loader=loader, frame_ids=frame_ids)


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


class TorchTrainMixedDataset:
    """Several datasets mixed (reference sam2_datasets.py:70-170): each
    batch comes from one dataset, drawn by probability (by default in
    proportion to its batch count), and an exhausted loader drops out of
    the mix. `phases_per_epoch` splits each dataset's epoch into consecutive
    chunks, so a large dataset interleaves with small ones below an epoch."""

    def __init__(self, datasets: Sequence[VOSDataset], batch_sizes=None,
                 dataset_prob: Optional[Sequence[float]] = None,
                 phases_per_epoch: int = 1, drop_last: bool = True):
        if not datasets:
            raise ValueError("need at least one dataset")
        self.datasets = list(datasets)
        self.batch_sizes = list(batch_sizes) if batch_sizes is not None else [1] * len(datasets)
        if len(self.batch_sizes) != len(self.datasets):
            raise ValueError("one batch size per dataset")
        self.drop_last = drop_last
        self.phases_per_epoch = max(int(phases_per_epoch), 1)
        self._chunks: List[Optional[List[List[int]]]] = [None] * len(self.datasets)
        if dataset_prob is None:
            lens = [len(d) // bs if drop_last else -(-len(d) // bs)
                    for d, bs in zip(self.datasets, self.batch_sizes)]
            total = max(sum(lens), 1)
            dataset_prob = [n / total for n in lens]
        if abs(sum(dataset_prob) - 1.0) >= 1e-6:
            raise ValueError("dataset probabilities must sum to 1")
        self.dataset_prob = list(dataset_prob)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def _phase_indices(self, d_idx: int, epoch: int, rng) -> List[int]:
        """This epoch's chunk of dataset d_idx's indices (the reference
        get_loader's phases, sam2_datasets.py:137-155)."""
        n = len(self.datasets[d_idx])
        if self.phases_per_epoch == 1:
            order = list(range(n))
            rng.shuffle(order)
            return order
        phase = epoch % self.phases_per_epoch
        if phase == 0 or self._chunks[d_idx] is None:
            order = list(range(n))
            random.Random(rng.random()).shuffle(order)
            size = -(-n // self.phases_per_epoch)
            self._chunks[d_idx] = [order[i * size:(i + 1) * size]
                                   for i in range(self.phases_per_epoch)]
        return list(self._chunks[d_idx][phase])

    def get_loader(self, epoch: int, seed: int = 0) -> Iterator[Dict]:
        """Collated batches of one epoch of the mix."""
        rng = random.Random(seed + epoch)
        iters = []
        for d_idx, (ds, bs) in enumerate(zip(self.datasets, self.batch_sizes)):
            idxs = self._phase_indices(d_idx, epoch, rng)

            def batches(ds=ds, bs=bs, idxs=idxs):
                batch = []
                for i in idxs:
                    batch.append(ds[i])
                    if len(batch) == bs:
                        yield collate_videos(batch)
                        batch = []
                if batch and not self.drop_last:
                    yield collate_videos(batch)

            iters.append(batches())
        alive = list(range(len(iters)))
        while alive:
            pick = rng.choices(alive, weights=[self.dataset_prob[i] for i in alive])[0]
            try:
                yield next(iters[pick])
            except StopIteration:
                alive.remove(pick)


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
    Without drop_last a ragged final global batch is padded with copies of
    its last video, so it shards evenly; every batch then carries
    `row_valid` [len(batch_rows)] bool, False on the padding.
    """
    order = list(range(len(dataset)))
    if shuffle:
        random.Random(seed).shuffle(order)
    if batch_rows is not None:
        rows = list(batch_rows)
        end = len(order) - (batch_size - 1 if drop_last else 0)
        for start in range(0, end, batch_size):
            chunk = order[start : start + batch_size]
            valid = np.array([r < len(chunk) for r in rows])
            chunk = chunk + chunk[-1:] * (batch_size - len(chunk))
            out = collate_videos([dataset[chunk[r]] for r in rows])
            out["global_batch_size"] = batch_size
            if not drop_last:
                out["row_valid"] = valid
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
