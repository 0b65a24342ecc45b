"""SAM2ImagePredictor — the reference API (sam2/sam2/sam2_image_predictor.py:23-616)
on PyTorch; counterpart of `sam2_opt_tpu/predictors/image.py`.

Inputs and outputs are numpy, as in the reference: images HWC uint8 RGB,
prompts in original-image pixels, masks [M, H, W]. Preprocessing (resize to
the model resolution, /255, ImageNet normalize) runs on the model's device.
`speedup()` switches the model to its bf16 compute copy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.models.model import SAM2Model
from sam2_opt_tpu_torch.utils.transforms import postprocess_masks, resize_to_model


def _squeeze0(a: np.ndarray) -> np.ndarray:
    """torch .squeeze(0): drop the leading axis only when it is 1 (a single
    prompt); several prompts keep their batch axis."""
    return a[0] if a.shape[0] == 1 else a


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SAM2ImagePredictor:
    def __init__(self, sam_model: SAM2Model, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0) -> None:
        self.model = sam_model
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area
        self._is_image_set = False
        self._features = None
        self._orig_hw: Optional[List[Tuple[int, int]]] = None
        self._is_batch = False

    @property
    def cfg(self) -> SAM2Config:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.device

    def speedup(self, backend: str = "cuda"):
        """One-line acceleration: bf16 compute. "int8" raises
        NotImplementedError."""
        self.model.speedup(backend)

    def set_runtime_backend(self, backend: str = "eager"):
        self.model.set_runtime_backend(backend)

    def release(self):
        self.model.set_runtime_backend("eager")

    # set_image / set_image_batch

    def _resize_to_model(self, images: np.ndarray) -> torch.Tensor:
        """uint8/float [B,H,W,3] -> float [B,3,S,S] in [0,1] on the device
        (reference: torchvision Resize 1024² + /255, sam2_image_predictor.py:193)."""
        x = torch.as_tensor(np.asarray(images), device=self.device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        return resize_to_model(x, self.cfg.image_size)

    def set_image(self, image) -> None:
        """image: np.ndarray HWC (RGB, 0-255) or PIL Image."""
        self.reset_predictor()
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
            x = self._resize_to_model(np.stack(images).astype(np.uint8))
        hrf0, hrf1, embed = self.model.encode_image_e2e(x)
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
            unnorm_coords = coords * self.cfg.image_size
            labels = np.asarray(point_labels, np.int32)
            if unnorm_coords.ndim == 2:
                unnorm_coords, labels = unnorm_coords[None], labels[None]
        if box is not None:
            b = np.asarray(box, np.float32).reshape(-1, 2, 2)
            if normalize_coords:
                h, w = self._orig_hw[img_idx]
                b = b / np.asarray([w, h], np.float32)
            unnorm_box = b * self.cfg.image_size
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
        """Reference-compatible predict (sam2_image_predictor.py:387-454)."""
        if not self._is_image_set:
            raise RuntimeError("An image must be set with .set_image(...) before mask prediction.")
        mask_in, unnorm_coords, labels, unnorm_box = self._prep_prompts(
            point_coords, point_labels, box, mask_input, normalize_coords)
        masks, ious, low_res = self._predict(unnorm_coords, labels, unnorm_box, mask_in,
                                             multimask_output, return_logits=return_logits)
        return (_squeeze0(_numpy(masks)), _squeeze0(_numpy(ious)), _squeeze0(_numpy(low_res)))

    def predict_batch(self, point_coords_batch=None, point_labels_batch=None, box_batch=None,
                      mask_input_batch=None, multimask_output: bool = True,
                      return_logits: bool = False, normalize_coords: bool = True):
        """Batched-image prediction (reference sam2_image_predictor.py:325-385)."""
        if not self._is_batch:
            raise RuntimeError("use set_image_batch first")
        all_masks, all_ious, all_low = [], [], []
        for i in range(self._features["image_embed"].shape[0]):
            pick = lambda xs: None if xs is None else xs[i]  # noqa: E731
            mask_in, coords, labels, ubox = self._prep_prompts(
                pick(point_coords_batch), pick(point_labels_batch), pick(box_batch),
                pick(mask_input_batch), normalize_coords, img_idx=i)
            masks, ious, low = self._predict(coords, labels, ubox, mask_in, multimask_output,
                                             return_logits=return_logits, img_idx=i)
            all_masks.append(_squeeze0(_numpy(masks)))
            all_ious.append(_squeeze0(_numpy(ious)))
            all_low.append(_squeeze0(_numpy(low)))
        return all_masks, all_ious, all_low

    def _predict(self, point_coords, point_labels, boxes=None, mask_input=None,
                 multimask_output=True, return_logits=False, img_idx: int = -1):
        """Predict on prepared prompts (reference sam2_image_predictor.py:487-589)."""
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
        low_res_masks, ious = self.model.predict_masks(
            sel(feats["image_embed"]), sel(feats["high_res_feats"][0]),
            sel(feats["high_res_feats"][1]), concat_coords, concat_labels,
            mask_input=mask_input, multimask_output=multimask_output)

        masks = self.postprocess_masks(low_res_masks, self._orig_hw[img_idx])
        low_res_masks = low_res_masks.clamp(-32.0, 32.0)
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks, ious, low_res_masks

    def postprocess_masks(self, masks, orig_hw):
        """Hole and sprinkle filling, then resize to the original resolution
        (reference utils/transforms.py:78-120)."""
        return postprocess_masks(masks, orig_hw, self.mask_threshold, self.max_hole_area,
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
