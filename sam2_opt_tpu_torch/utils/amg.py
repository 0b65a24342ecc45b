"""AMG (automatic mask generation) utilities, numpy host-side.

Counterpart of `sam2_opt_tpu/utils/amg.py`, copied so the port imports
nothing of the JAX package. The uncompressed-RLE codec, stability score and
mask->box math keep the semantics of Meta's SAM2 / segment-anything
`sam2/sam2/utils/amg.py` (Apache-2.0; see LICENSES/LICENSE_SAM2_APACHE2) for
output-format compatibility; candidates are a functional records API (dict
of parallel columns + filter/concat functions), and NMS is self-contained.
Differences from the JAX module: the RLE codec is numpy only (no native
library), COCO compression encodes the uncompressed runs directly, and
`remove_small_regions` labels with `scipy.ndimage.label` at
8-connectivity, which gives the regions of `cv2.connectedComponentsWithStats`
in the same raster order.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np

# A "records" value is a dict of equal-length parallel columns: numpy arrays
# or python lists (e.g. RLE dicts). All transformations are pure functions.
Records = Dict[str, Any]


def filter_records(data: Records, keep: np.ndarray) -> Records:
    """Select rows by boolean mask or index array; returns a new dict."""
    keep = np.asarray(keep)
    out: Records = {}
    for name, col in data.items():
        if isinstance(col, np.ndarray):
            out[name] = col[keep]
        elif keep.dtype == bool:
            out[name] = [x for x, k in zip(col, keep) if k]
        else:
            out[name] = [col[i] for i in keep]
    return out


def concat_records(parts: Sequence[Records]) -> Records:
    """Row-concatenate a sequence of records with identical columns."""
    parts = [p for p in parts if p]
    if not parts:
        return {}
    out: Records = {}
    for name in parts[0]:
        cols = [p[name] for p in parts]
        if isinstance(cols[0], np.ndarray):
            out[name] = np.concatenate(cols, axis=0)
        else:
            out[name] = [x for c in cols for x in c]
    return out


def num_records(data: Records) -> int:
    for col in data.values():
        return len(col)
    return 0


def chunked(n: int, *columns) -> Iterator[List[Any]]:
    """Yield aligned length-n slices of the given columns."""
    total = len(columns[0])
    assert all(len(c) == total for c in columns)
    for start in range(0, total, n):
        yield [c[start : start + n] for c in columns]


# --------------------------------------------------------------------- #
# RLE codec (pycoco uncompressed format: column-major runs, background
# first — must stay bit-identical to the upstream codec)
# --------------------------------------------------------------------- #

def mask_to_rle(masks: np.ndarray) -> List[Dict[str, Any]]:
    """[B, H, W] bool -> list of {"size": [H, W], "counts": [...]}."""
    b, h, w = masks.shape
    flat = np.transpose(masks, (0, 2, 1)).reshape(b, h * w)
    out = []
    for i in range(b):
        row = flat[i]
        change = np.flatnonzero(row[1:] != row[:-1]) + 1
        bounds = np.concatenate([[0], change, [h * w]])
        counts = ([] if not row[0] else [0]) + np.diff(bounds).tolist()
        out.append({"size": [h, w], "counts": counts})
    return out


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    value = False
    for count in rle["counts"]:
        mask[idx : idx + count] = value
        idx += count
        value = not value
    return mask.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def _leb_encode_counts(counts: Sequence[int]) -> str:
    """COCO's compressed count string: each count (from the third on, as
    the difference to the count two before) in 5-bit groups, ASCII from 48."""
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1 if (c & 0x10) else x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    """Compressed COCO RLE of an uncompressed one (no pycocotools needed):
    the same column-major runs, LEB-encoded."""
    return {"size": list(uncompressed_rle["size"]),
            "counts": _leb_encode_counts(uncompressed_rle["counts"])}


# --------------------------------------------------------------------- #
# scoring + geometry
# --------------------------------------------------------------------- #

def calculate_stability_score(masks, mask_threshold: float,
                              threshold_offset: float):
    """IoU between the high- and low-thresholded binarizations of the mask
    logits [..., H, W] — the upstream stability definition."""
    masks = np.asarray(masks)
    tight = (masks > (mask_threshold + threshold_offset)).sum(-1).sum(-1)
    loose = (masks > (mask_threshold - threshold_offset)).sum(-1).sum(-1)
    return tight / np.maximum(loose, 1)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n², 2] grid of (x, y) in [0,1], cell-centered."""
    centers = (np.arange(n_per_side) + 0.5) / n_per_side
    xs, ys = np.meshgrid(centers, centers)
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [
        build_point_grid(int(n_per_side / (scale_per_layer ** i)))
        for i in range(n_layers + 1)
    ]


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int,
                        overlap_ratio: float):
    """Pyramid of overlapping XYXY crops: layer i has 2^i crops per side;
    layer 0 is the full image. Returns (crop_boxes, layer_indices)."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes = [[0, 0, im_w, im_h]]
    layer_idxs = [0]
    for layer in range(1, n_layers + 1):
        per_side = 2 ** layer
        overlap = int(overlap_ratio * short_side * (2 / per_side))
        crop_w = int(math.ceil((overlap * (per_side - 1) + im_w) / per_side))
        crop_h = int(math.ceil((overlap * (per_side - 1) + im_h) / per_side))
        # x-major crop order (must match the upstream enumeration so the
        # emitted record order is identical)
        for ix in range(per_side):
            x0 = (crop_w - overlap) * ix
            for iy in range(per_side):
                y0 = (crop_h - overlap) * iy
                crop_boxes.append(
                    [x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)]
                )
                layer_idxs.append(layer)
    return crop_boxes, layer_idxs


def shift_boxes(boxes, crop_box):
    """Translate crop-local XYXY boxes into image coordinates."""
    x0, y0 = crop_box[0], crop_box[1]
    boxes = np.asarray(boxes)
    return boxes + np.asarray([x0, y0, x0, y0], dtype=boxes.dtype)


def shift_points(points, crop_box):
    """Translate crop-local (x, y) points into image coordinates."""
    points = np.asarray(points)
    return points + np.asarray(crop_box[:2], dtype=points.dtype)


# legacy aliases for the upstream names
uncrop_boxes_xyxy = shift_boxes
uncrop_points = shift_points


def uncrop_masks(masks, crop_box, orig_h: int, orig_w: int):
    """Zero-pad crop-local masks back to the full image canvas."""
    x0, y0, x1, y1 = crop_box
    if (x0, y0, x1, y1) == (0, 0, orig_w, orig_h):
        return masks
    widths = [(0, 0)] * (masks.ndim - 2)
    widths += [(y0, orig_h - y1), (x0, orig_w - x1)]
    return np.pad(masks, widths)


def touches_crop_edge(boxes, crop_box, image_box, atol: float = 20.0):
    """True where a (crop-local) box hugs the crop boundary but not the
    image boundary — such masks are clipped artifacts of the crop."""
    boxes_img = shift_boxes(np.asarray(boxes, np.float32), crop_box)
    at_crop = np.abs(boxes_img - np.asarray(crop_box, np.float32)) <= atol
    at_image = np.abs(boxes_img - np.asarray(image_box, np.float32)) <= atol
    return np.any(at_crop & ~at_image, axis=1)


# legacy alias for the upstream name
is_box_near_crop_edge = touches_crop_edge


def box_xyxy_to_xywh(box_xyxy):
    box = np.array(box_xyxy, copy=True)
    box[2] -= box[0]
    box[3] -= box[1]
    return box


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """XYXY bounds of each [..., H, W] bool mask; all-zeros when empty."""
    masks = np.asarray(masks)
    if masks.size == 0:
        return np.zeros((*masks.shape[:-2], 4), np.int64)
    shape = masks.shape
    h, w = shape[-2:]
    flat = masks.reshape(-1, h, w)

    rows_any = flat.any(axis=-1)
    cols_any = flat.any(axis=-2)
    row_idx = np.arange(h)[None, :]
    col_idx = np.arange(w)[None, :]
    top = np.where(rows_any, row_idx, h).min(axis=-1)
    bottom = np.where(rows_any, row_idx, -1).max(axis=-1)
    left = np.where(cols_any, col_idx, w).min(axis=-1)
    right = np.where(cols_any, col_idx, -1).max(axis=-1)

    empty = ~flat.any(axis=(-2, -1))
    out = np.stack([left, top, right, bottom], axis=-1)
    out[empty] = 0
    return out.reshape(*shape[:-2], 4).astype(np.int64)


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str):
    """Fill small holes / drop small islands via 8-connected components.
    Returns (mask, changed)."""
    from scipy import ndimage

    if mode not in ("holes", "islands"):
        raise ValueError(f"mode must be 'holes' or 'islands', got {mode!r}")
    invert = mode == "holes"
    working = (mask ^ invert).astype(np.uint8)
    regions, n = ndimage.label(working, structure=np.ones((3, 3), int))
    n_labels = n + 1
    sizes = np.bincount(regions.ravel(), minlength=n_labels)[1:]
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = [0] + small
    if not invert:
        fill = [i for i in range(n_labels) if i not in fill]
        if not fill:
            fill = [int(np.argmax(sizes)) + 1]
    return np.isin(regions, fill), True


# --------------------------------------------------------------------- #
# NMS (replacement for torchvision.ops.batched_nms)
# --------------------------------------------------------------------- #

def box_nms(boxes: np.ndarray, scores: np.ndarray,
            iou_threshold: float) -> np.ndarray:
    """Greedy NMS over XYXY boxes; kept indices by descending score."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores)
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        lo = np.maximum(boxes[i, :2], boxes[rest, :2])
        hi = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        inter = np.prod(np.clip(hi - lo, 0, None), axis=1)
        area_i = np.prod(boxes[i, 2:] - boxes[i, :2])
        area_r = np.prod(boxes[rest, 2:] - boxes[rest, :2], axis=1)
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def batched_nms(boxes, scores, idxs, iou_threshold: float) -> np.ndarray:
    """Category-aware NMS (torchvision.ops.batched_nms semantics): boxes of
    different categories never suppress each other."""
    boxes = np.asarray(boxes, np.float32)
    if boxes.size == 0:
        return np.zeros((0,), np.int64)
    offsets = np.asarray(idxs, np.float32) * (boxes.max() + 1)
    return box_nms(boxes + offsets[:, None], scores, iou_threshold)
