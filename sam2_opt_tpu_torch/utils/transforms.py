"""SAM2Transforms — pre/postprocessing helper (API of the reference
sam2/sam2/utils/transforms.py:15-120; counterpart of
`sam2_opt_tpu/utils/transforms.py`).

The image predictor inlines these ops; this class serves users of the
reference API who build SAM2Transforms directly. Images come out CHW, as in
the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from sam2_opt_tpu_torch.models.model import default_device
from sam2_opt_tpu_torch.models.sam2_base import image_normalize, resize_hw
from sam2_opt_tpu_torch.ops import common as ops
from sam2_opt_tpu_torch.ops.connected_components import fill_holes_and_sprinkles


def resize_to_model(x, resolution: int):
    """[B, 3, H, W] float -> [B, 3, r, r], bilinear with antialias (the
    reference's torchvision Resize; equal to the JAX package's
    `jax.image.resize(method="linear", antialias=True)`)."""
    if tuple(x.shape[-2:]) == (resolution, resolution):
        return x
    return ops.interpolate(x, (resolution, resolution), "bilinear", antialias=True)


def postprocess_masks(masks, orig_hw, mask_threshold: float, max_hole_area: float,
                      max_sprinkle_area: float):
    """Hole and sprinkle filling, then a bilinear resize to the original
    resolution (reference transforms.py:78-120). masks [B, M, h, w] logits."""
    masks = torch.as_tensor(masks).float()
    if max_hole_area > 0 or max_sprinkle_area > 0:
        masks = fill_holes_and_sprinkles(masks, mask_threshold, max_hole_area, max_sprinkle_area)
    return resize_hw(masks, tuple(orig_hw), "bilinear")


class SAM2Transforms:
    def __init__(self, resolution: int, mask_threshold: float, max_hole_area: float = 0.0,
                 max_sprinkle_area: float = 0.0, device=None):
        """Runs on the card unless `device` names another."""
        self.resolution = resolution
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area
        self.device = default_device(device)

    def to_tensor(self, image: np.ndarray):
        """uint8 HWC -> float CHW in [0, 1]."""
        x = torch.as_tensor(np.asarray(image), device=self.device)
        return x.permute(2, 0, 1).float() / 255.0

    def __call__(self, image: np.ndarray):
        x = resize_to_model(self.to_tensor(image)[None], self.resolution)
        return image_normalize(x)[0]

    def forward_batch(self, img_list):
        return torch.stack([self(img) for img in img_list])

    def transform_coords(self, coords, normalize=False, orig_hw=None):
        """reference transforms.py:48-66."""
        coords = torch.as_tensor(coords, dtype=torch.float32)
        if normalize:
            h, w = orig_hw
            coords = coords / torch.tensor([w, h], dtype=torch.float32)
        return coords * self.resolution

    def transform_boxes(self, boxes, normalize=False, orig_hw=None):
        return self.transform_coords(torch.as_tensor(boxes).reshape(-1, 2, 2), normalize,
                                     orig_hw)

    def postprocess_masks(self, masks, orig_hw):
        """Hole and sprinkle filling, then resize (reference :78-120)."""
        return postprocess_masks(masks, orig_hw, self.mask_threshold, self.max_hole_area,
                                 self.max_sprinkle_area)
