"""SAM2ImagePredictor — the reference API (sam2/sam2/sam2_image_predictor.py:23-616)
on PyTorch; counterpart of `sam2_opt_tpu/predictors/image.py`.

Inputs and outputs are numpy, as in the reference: images HWC uint8 RGB,
prompts in original-image pixels, masks [M, H, W]. Preprocessing (resize to
the model resolution, /255, ImageNet normalize) runs on the model's device.
`speedup()` switches the model to its bf16 compute copy and runs the encoder
and the prompt decoder as CUDA graph replays, one per input signature.

With `mesh=` (`parallel/mesh.py`; beyond the reference, which runs on one
GPU) the model keeps its tensor-parallel shards over "model"; a batch whose
size divides by the "data" axis is split over it: each rank encodes its
images and the features are all-gathered, and `predict_batch` decodes each
rank's images and all-gathers the outputs, so every rank returns the whole
batch's, as the JAX predictor returns its global arrays.

On a Segment Anything ViT model (`models/vit.py`) it is SAM's predictor:
the transforms of the image, the prompts and the masks are chosen once, at
construction (`Sam2Frame`, `SamFrame`). Such a model takes no mesh.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from sam2_opt_tpu_torch.config import SAM2Config, SamViTConfig
from sam2_opt_tpu_torch.models.model import SAM2Model
from sam2_opt_tpu_torch.models.sam2_base import resize_hw
from sam2_opt_tpu_torch.models.vit import preprocess_shape
from sam2_opt_tpu_torch.ops import common as ops
from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
from sam2_opt_tpu_torch.utils import profiling
from sam2_opt_tpu_torch.utils.transforms import postprocess_masks, resize_to_model


def _squeeze0(a: np.ndarray) -> np.ndarray:
    """torch .squeeze(0): drop the leading axis only when it is 1 (a single
    prompt); several prompts keep their batch axis."""
    return a[0] if a.shape[0] == 1 else a


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Sam2Frame:
    """SAM 2's transforms (reference sam2/utils/transforms.py): the image
    resized to S x S, prompts scaled to S, the low-res logits clamped to
    +-32, the masks hole- and sprinkle-filled, then resized to the image."""

    pad_with_box = True  # the padding point follows a box too

    def __init__(self, cfg: SAM2Config):
        self.size = cfg.image_size

    def to_model(self, x):
        """float [B,3,H,W] in [0,1] -> [B,3,S,S] (torchvision Resize 1024²,
        sam2_image_predictor.py:193; the model normalizes)."""
        return resize_to_model(x, self.size)

    def features(self, out):
        """The encoder seam's output -> (hrf0, hrf1, embed)."""
        return out

    def model_frame(self, orig_hw):
        """(x, y) factors from coordinates normalized over the image to the
        model's frame."""
        return self.size

    def low_res(self, masks):
        return masks.clamp(-32.0, 32.0)

    def postprocess(self, masks, orig_hw, mask_threshold, max_hole_area, max_sprinkle_area):
        return postprocess_masks(masks, orig_hw, mask_threshold, max_hole_area,
                                 max_sprinkle_area)


class SamFrame:
    """SAM's transforms (segment_anything/predictor.py, utils/transforms.py
    `ResizeLongestSide`): the long side resized to S (bilinear with
    antialias, in float), the image normalized and zero-padded at the bottom
    and right to S x S, prompts scaled per axis to the resized image, no
    padding point when a box is given, and the low-res logits, unclamped,
    upsampled to S x S, cropped to the resized image and upsampled to the
    original (modeling/sam.py `postprocess_masks`); no hole filling."""

    pad_with_box = False

    def __init__(self, cfg: SamViTConfig):
        self.size = cfg.image_size
        self.mean = torch.tensor(cfg.pixel_mean)[:, None, None] / 255.0
        self.std = torch.tensor(cfg.pixel_std)[:, None, None] / 255.0

    def to_model(self, x):
        S = self.size
        h, w = preprocess_shape(x.shape[-2], x.shape[-1], S)
        if (h, w) != tuple(x.shape[-2:]):
            x = ops.interpolate(x, (h, w), "bilinear", antialias=True)
        x = (x - self.mean.to(x.device)) / self.std.to(x.device)
        return F.pad(x, (0, S - w, 0, S - h))

    def features(self, embed):
        return None, None, embed

    def model_frame(self, orig_hw):
        h, w = preprocess_shape(*orig_hw, self.size)
        return np.asarray([w, h], np.float32)

    def low_res(self, masks):
        return masks

    def postprocess(self, masks, orig_hw, mask_threshold, max_hole_area, max_sprinkle_area):
        S = self.size
        h, w = preprocess_shape(*orig_hw, S)
        masks = resize_hw(masks.float(), (S, S), "bilinear")[..., :h, :w]
        return resize_hw(masks, tuple(orig_hw), "bilinear")


class SAM2ImagePredictor:
    def __init__(self, sam_model: SAM2Model, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0,
                 mesh=None) -> None:
        self.model = sam_model
        self.mesh = mesh
        sam_vit = isinstance(sam_model.cfg, SamViTConfig)
        if sam_vit and mesh is not None:
            raise ValueError("a Segment Anything ViT model runs on one device: no mesh")
        self._frame = SamFrame(sam_model.cfg) if sam_vit else Sam2Frame(sam_model.cfg)
        if mesh is not None:
            sam_model.shard(mesh)
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area
        self._is_image_set = False
        self._features = None
        self._orig_hw: Optional[List[Tuple[int, int]]] = None
        self._is_batch = False
        # the batch rows this rank encoded (and decodes), when split over "data"
        self._local_rows: Optional[List[int]] = None

    @property
    def cfg(self) -> SAM2Config:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.device

    def speedup(self, backend: str = "cuda", **kwargs):
        """One-line acceleration: bf16 compute, `set_image` and `predict` as
        CUDA graph replays. "int8" also quantizes the encoder's linears:
        pass `calib_dir` with calibration images for activation-quant, omit
        it for weight-only (`SAM2Model.speedup` takes the other arguments:
        dtype, model_root_path, activation_quant, quant_scope,
        max_images)."""
        self.model.speedup(backend, **kwargs)

    def set_runtime_backend(self, backend: str = "eager", args=None):
        self.model.set_runtime_backend(backend, args)

    def release(self):
        self.model.set_runtime_backend("eager")

    # set_image / set_image_batch

    def _resize_to_model(self, images: np.ndarray) -> torch.Tensor:
        """uint8/float [B,H,W,3] -> float [B,3,S,S] on the device, /255 and
        then the frame's transform."""
        with profiling.span("image.upload"):
            x = torch.as_tensor(np.asarray(images), device=self.device)
        with profiling.span("image.resize"):
            return self._frame.to_model(x.permute(0, 3, 1, 2).float() / 255.0)

    def set_image(self, image) -> None:
        """image: np.ndarray HWC (RGB, 0-255) or PIL Image. With the tracer
        on (`utils/profiling.py`) its spans are `image.prepare` (the array
        and its stacking), `image.upload` (the pageable copy to the card),
        `image.resize` (to the model's size and dtype) and the encoder's
        seam."""
        self.reset_predictor()
        with profiling.span("image.prepare"):
            if hasattr(image, "size") and not isinstance(image, np.ndarray):  # PIL
                w, h = image.size
                self._orig_hw = [(h, w)]
                image = np.array(image.convert("RGB"))
            else:
                image = np.asarray(image)
                self._orig_hw = [image.shape[:2]]
        self._set_image_([image])

    def set_image_batch(self, image_list: List[np.ndarray]) -> None:
        self.reset_predictor()
        self._orig_hw = [img.shape[:2] for img in image_list]
        self._set_image_(list(image_list))
        self._is_batch = True

    def _set_image_(self, images: List[np.ndarray]):
        # images of different shapes are resized one by one before stacking
        # (reference SAM2Transforms.forward_batch); same resize either way
        if len({img.shape for img in images}) > 1:
            x = torch.cat([self._resize_to_model(np.asarray(img, np.uint8)[None])
                           for img in images])
        else:
            with profiling.span("image.prepare"):
                batch = np.stack(images).astype(np.uint8)
            x = self._resize_to_model(batch)
        dp = mesh_lib.axis_size(self.mesh, "data")
        if dp > 1 and x.shape[0] % dp == 0:
            self._local_rows = mesh_lib.process_local_batch_rows(self.mesh, x.shape[0])
            feats = self.model.encode_image_e2e(mesh_lib.data_sharded(self.mesh, x))
            hrf0, hrf1, embed = (mesh_lib.all_gather_rows(self.mesh, f) for f in feats)
        else:
            hrf0, hrf1, embed = self._frame.features(self.model.encode_image_e2e(x))
        self._features = {"image_embed": embed, "high_res_feats": [hrf0, hrf1]}
        self._is_image_set = True

    # predict

    def _prep_prompts(self, point_coords, point_labels, box, mask_logits, normalize_coords,
                      img_idx=-1):
        unnorm_coords, labels, unnorm_box, mask_input = None, None, None, None
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_labels must be given with point_coords")
            coords = np.asarray(point_coords, np.float32)
            if normalize_coords:
                h, w = self._orig_hw[img_idx]
                coords = coords / np.asarray([w, h], np.float32)
            unnorm_coords = coords * self._frame.model_frame(self._orig_hw[img_idx])
            labels = np.asarray(point_labels, np.int32)
            if unnorm_coords.ndim == 2:
                unnorm_coords, labels = unnorm_coords[None], labels[None]
        if box is not None:
            b = np.asarray(box, np.float32).reshape(-1, 2, 2)
            if normalize_coords:
                h, w = self._orig_hw[img_idx]
                b = b / np.asarray([w, h], np.float32)
            unnorm_box = b * self._frame.model_frame(self._orig_hw[img_idx])
        if mask_logits is not None:
            mask_input = np.asarray(mask_logits, np.float32)
            if mask_input.ndim == 3:
                mask_input = mask_input[None]
        return mask_input, unnorm_coords, labels, unnorm_box

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None, multimask_output: bool = True,
                return_logits: bool = False, normalize_coords: bool = True,
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Reference-compatible predict (sam2_image_predictor.py:387-454).
        With the tracer on (`utils/profiling.py`) its spans are
        `predict.prompts` (the prompts prepared and uploaded), the decoder's
        seam, `predict.postprocess` (the masks to the image's size,
        thresholded) and `predict.download` (masks, IoUs and logits to the
        host)."""
        if not self._is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) before mask prediction.")
        with profiling.span("predict.prompts"):
            mask_in, unnorm_coords, labels, unnorm_box = self._prep_prompts(
                point_coords, point_labels, box, mask_input, normalize_coords)
        masks, ious, low_res = self._predict(unnorm_coords, labels, unnorm_box, mask_in,
                                             multimask_output, return_logits=return_logits)
        with profiling.span("predict.download"):
            return (_squeeze0(_numpy(masks)), _squeeze0(_numpy(ious)),
                    _squeeze0(_numpy(low_res)))

    def predict_batch(self, point_coords_batch=None, point_labels_batch=None, box_batch=None,
                      mask_input_batch=None, multimask_output: bool = True,
                      return_logits: bool = False, normalize_coords: bool = True):
        """Batched-image prediction (reference sam2_image_predictor.py:325-385)."""
        if not self._is_batch:
            raise RuntimeError("use set_image_batch first")
        rows = self._local_rows or range(self._features["image_embed"].shape[0])
        outs = []
        for i in rows:
            pick = lambda xs: None if xs is None else xs[i]  # noqa: E731
            mask_in, coords, labels, ubox = self._prep_prompts(
                pick(point_coords_batch), pick(point_labels_batch), pick(box_batch),
                pick(mask_input_batch), normalize_coords, img_idx=i)
            masks, ious, low = self._predict(coords, labels, ubox, mask_in, multimask_output,
                                             return_logits=return_logits, img_idx=i)
            outs.append(tuple(_squeeze0(_numpy(t)) for t in (masks, ious, low)))
        if self._local_rows is not None:
            # every rank's images, in data order
            gathered = [None] * mesh_lib.axis_size(self.mesh, "data")
            dist.all_gather_object(gathered, outs, group=self.mesh.get_group("data"))
            outs = [o for part in gathered for o in part]
        all_masks, all_ious, all_low = (list(t) for t in zip(*outs))
        return all_masks, all_ious, all_low

    def _predict(self, point_coords, point_labels, boxes=None, mask_input=None,
                 multimask_output=True, return_logits=False, img_idx: int = -1):
        """Predict on prepared prompts (reference sam2_image_predictor.py:487-589)."""
        with profiling.span("predict.prompts"):
            concat_coords, concat_labels = point_coords, point_labels
            if boxes is not None:
                box_coords = boxes.reshape(-1, 2, 2)
                box_labels = np.tile(np.asarray([[2, 3]], np.int32), (box_coords.shape[0], 1))
                if concat_coords is not None:
                    concat_coords = np.concatenate([box_coords, concat_coords], axis=1)
                    concat_labels = np.concatenate([box_labels, concat_labels], axis=1)
                else:
                    concat_coords, concat_labels = box_coords, box_labels
            if concat_coords is None:
                # mask-only prompt: a single padding point
                B = 1 if mask_input is None else mask_input.shape[0]
                concat_coords = np.zeros((B, 1, 2), np.float32)
                concat_labels = -np.ones((B, 1), np.int32)

        feats = self._features
        sel = (lambda t: t[img_idx][None]) if img_idx >= 0 else (lambda t: t)
        hrf = feats["high_res_feats"]
        low_res_masks, ious = self.model.predict_masks(
            sel(feats["image_embed"]), None if hrf[0] is None else sel(hrf[0]),
            None if hrf[1] is None else sel(hrf[1]), concat_coords, concat_labels,
            mask_input=mask_input, multimask_output=multimask_output,
            pad=boxes is None or self._frame.pad_with_box)

        with profiling.span("predict.postprocess"):
            masks = self.postprocess_masks(low_res_masks, self._orig_hw[img_idx])
            low_res_masks = self._frame.low_res(low_res_masks)
            if not return_logits:
                masks = masks > self.mask_threshold
        return masks, ious, low_res_masks

    def postprocess_masks(self, masks, orig_hw):
        """Low-res logits to the original resolution, by the frame (SAM 2's:
        hole and sprinkle filling, then the resize; reference
        utils/transforms.py:78-120)."""
        return self._frame.postprocess(masks, orig_hw, self.mask_threshold, self.max_hole_area,
                                       self.max_sprinkle_area)

    def get_image_embedding(self):
        if not self._is_image_set:
            raise RuntimeError("An image must be set with .set_image(...)")
        return self._features["image_embed"]

    def reset_predictor(self) -> None:
        self._is_image_set = False
        self._features = None
        self._orig_hw = None
        self._is_batch = False
        self._local_rows = None
