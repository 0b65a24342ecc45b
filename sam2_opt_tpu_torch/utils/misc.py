"""Mask and point helpers of the predictors (counterpart of
`sam2_opt_tpu/utils/misc.py`; reference sam2/sam2/utils/misc.py)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

# the reference API's home of hole filling (misc.py:312-337): background
# components of area <= max_area in the logits get the score 0.1
from sam2_opt_tpu_torch.ops.connected_components import fill_holes_in_mask_scores  # noqa: F401


def mask_to_box(masks):
    """[B, 1, H, W] bool mask -> [B, 1, 4] xyxy box (reference misc.py:66-92);
    an empty mask gives (W, H, -1, -1)."""
    B, _, h, w = masks.shape
    m = masks[:, 0]
    xs = torch.arange(w, dtype=torch.int32, device=m.device)
    ys = torch.arange(h, dtype=torch.int32, device=m.device)
    any_y, any_x = m.any(2), m.any(1)  # [B, h], [B, w]
    x_min = torch.where(any_x, xs, w).amin(1)
    x_max = torch.where(any_x, xs, -1).amax(1)
    y_min = torch.where(any_y, ys, h).amin(1)
    y_max = torch.where(any_y, ys, -1).amax(1)
    return torch.stack([x_min, y_min, x_max, y_max], -1)[:, None, :]


def concat_points(old_point_inputs: Optional[Dict], new_points, new_labels) -> Dict:
    """Append new points to previous ones (reference misc.py:341-349)."""
    if old_point_inputs is None:
        points, labels = new_points, new_labels
    else:
        points = np.concatenate([old_point_inputs["point_coords"], new_points], axis=1)
        labels = np.concatenate([old_point_inputs["point_labels"], new_labels], axis=1)
    return {"point_coords": points, "point_labels": labels}

