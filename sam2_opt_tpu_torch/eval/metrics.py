"""J (region IoU) & F (boundary) metrics for video object segmentation.

The metric math derives from davis2017-evaluation (BSD-3) and
hkchengrex/vos-benchmark (MIT) via the reference sav_benchmark — see
LICENSES/LICENSE_DAVIS and LICENSES/LICENSE_VOS_BENCHMARK. It must stay
numerically identical to be a meaningful benchmark.

Counterpart of `sam2_opt_tpu/eval/metrics.py`. Re-design of
sam2/sav_dataset/utils/sav_benchmark.py:156-314 (itself from
hkchengrex/vos-benchmark and davis2017-evaluation). Numpy, with the boundary
dilation by `scipy.ndimage` (the same binary dilation as `cv2.dilate` with
the disk, zero outside the image); the disk is generated locally (no skimage
dependency).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np


def disk(radius: int) -> np.ndarray:
    """Boolean disk structuring element (skimage.morphology.disk semantics)."""
    radius = int(radius)
    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.uint8)


def seg2bmap(seg: np.ndarray, width=None, height=None) -> np.ndarray:
    """1-pixel-wide binary boundary map (reference _seg2bmap,
    sav_benchmark.py:156-213)."""
    seg = seg.astype(bool)
    assert np.atleast_3d(seg).shape[2] == 1
    width = seg.shape[1] if width is None else width
    height = seg.shape[0] if height is None else height
    h, w = seg.shape[:2]

    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]

    b = seg ^ e | seg ^ s | seg ^ se
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = 0

    if w == width and h == height:
        return b
    bmap = np.zeros((height, width))
    for x in range(w):
        for y in range(h):
            if b[y, x]:
                j = 1 + math.floor((y - 1) + height / h)
                i = 1 + math.floor((x - 1) + width / h)
                bmap[j, i] = 1
    return bmap


def get_iou(intersection, pixel_sum):
    """reference sav_benchmark.py:215-222."""
    if intersection == pixel_sum:
        assert intersection == 0
        return 1
    return intersection / (pixel_sum - intersection)


def _dilate(bmap: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    from scipy import ndimage

    return ndimage.binary_dilation(bmap.astype(bool), structure=kernel.astype(bool)).astype(np.uint8)


def boundary_f_measure(pred: np.ndarray, gt: np.ndarray,
                       boundary: float = 0.008) -> float:
    """Boundary F-score for one binary mask pair (sav_benchmark.py:269-303).

    `boundary` is always a diagonal FRACTION, like the reference
    (sav_benchmark.py:256 scales unconditionally) — NOT the older DAVIS
    f_boundary convention where bound_th >= 1 means a pixel radius."""
    bound_pix = np.ceil(boundary * np.linalg.norm(pred.shape))
    kernel = disk(bound_pix)
    mask_boundary = seg2bmap(pred)
    gt_boundary = seg2bmap(gt)
    mask_dilated = _dilate(mask_boundary, kernel)
    gt_dilated = _dilate(gt_boundary, kernel)

    gt_match = gt_boundary * mask_dilated
    fg_match = mask_boundary * gt_dilated
    n_fg = np.sum(mask_boundary)
    n_gt = np.sum(gt_boundary)
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = np.sum(fg_match) / float(n_fg)
        recall = np.sum(gt_match) / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


class Evaluator:
    """Accumulates per-object J and F over frames (sav_benchmark.py:225-314)."""

    def __init__(self, boundary: float = 0.008, name=None, obj_id=None):
        self.boundary = boundary
        self.name = name
        self.obj_id = obj_id
        self.objects_in_gt = set()
        self.objects_in_masks = set()
        self.object_iou = defaultdict(list)
        self.boundary_f = defaultdict(list)

    def feed_frame(self, mask: np.ndarray, gt: np.ndarray):
        gt_objects = np.unique(gt)
        gt_objects = gt_objects[gt_objects != 0].tolist()
        mask_objects = np.unique(mask)
        mask_objects = mask_objects[mask_objects != 0].tolist()
        self.objects_in_gt.update(set(gt_objects))
        self.objects_in_masks.update(set(mask_objects))

        for obj_idx in self.objects_in_gt.union(self.objects_in_masks):
            obj_mask = mask == obj_idx
            obj_gt = gt == obj_idx
            self.object_iou[obj_idx].append(
                get_iou((obj_mask * obj_gt).sum(), obj_mask.sum() + obj_gt.sum())
            )
            self.boundary_f[obj_idx].append(
                boundary_f_measure(obj_mask, obj_gt, self.boundary)
            )

    def conclude(self) -> Tuple[Dict, Dict]:
        all_iou, all_f = {}, {}
        for object_id in self.objects_in_gt:
            all_iou[object_id] = np.mean(self.object_iou[object_id]) * 100
            all_f[object_id] = np.mean(self.boundary_f[object_id]) * 100
        return all_iou, all_f
