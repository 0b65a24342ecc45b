"""SAM2AutomaticMaskGenerator — dense grid prompting over the image predictor.

Counterpart of `sam2_opt_tpu/predictors/amg.py`: the same annotation records
as Meta's SAM2 `sam2/sam2/automatic_mask_generator.py` (Apache-2.0; see
LICENSES/LICENSE_SAM2_APACHE2) — output schema, filtering thresholds, crop
pyramid — as a functional pipeline over column-dict records
(`utils/amg.py`): predict a grid chunk, filter rows, deduplicate with NMS.
Each chunk's full-resolution logits stay on the model's device until they are
filtered and binarized (the reference's MaskData works on the device the same
way); the surviving masks come to the host for RLE, NMS and the records.
After `speedup()` each chunk's decoder runs as a CUDA graph replay: a
32-point grid in batches of 64 is one signature.
The HuggingFace-hub loader (`from_pretrained`) is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
from sam2_opt_tpu_torch.utils import amg as A


def stability_score(logits: torch.Tensor, mask_threshold: float, offset: float) -> torch.Tensor:
    """`A.calculate_stability_score` on the device: the IoU of the masks
    thresholded at +-offset, as float64 (numpy's int / int)."""
    tight = (logits > mask_threshold + offset).sum((-1, -2))
    loose = (logits > mask_threshold - offset).sum((-1, -2))
    return tight.double() / loose.clamp(min=1).double()


def mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """`A.batched_mask_to_box` on the device: XYXY bounds of [N, H, W] bool
    masks, zeros where a mask is empty."""
    n, h, w = masks.shape
    if n == 0:
        return torch.zeros((0, 4), dtype=torch.int64, device=masks.device)
    rows, cols = masks.any(-1), masks.any(-2)
    row_idx = torch.arange(h, device=masks.device)
    col_idx = torch.arange(w, device=masks.device)
    top = torch.where(rows, row_idx, h).amin(-1)
    bottom = torch.where(rows, row_idx, -1).amax(-1)
    left = torch.where(cols, col_idx, w).amin(-1)
    right = torch.where(cols, col_idx, -1).amax(-1)
    out = torch.stack([left, top, right, bottom], -1)
    return torch.where(rows.any(-1)[:, None], out, torch.zeros_like(out))


class SAM2AutomaticMaskGenerator:
    def __init__(
        self,
        model,
        points_per_side: Optional[int] = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.8,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        mask_threshold: float = 0.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
        use_m2m: bool = False,
        multimask_output: bool = True,
    ) -> None:
        if (points_per_side is None) == (point_grids is None):
            raise ValueError("Exactly one of points_per_side or point_grid must be provided.")
        if output_mode not in ("binary_mask", "uncompressed_rle", "coco_rle"):
            raise ValueError(f"unknown output_mode {output_mode!r}")
        self.point_grids = (
            point_grids if point_grids is not None
            else A.build_all_layer_point_grids(points_per_side, crop_n_layers,
                                               crop_n_points_downscale_factor))
        self.predictor = (
            model if isinstance(model, SAM2ImagePredictor)
            else SAM2ImagePredictor(model, max_hole_area=min_mask_region_area,
                                    max_sprinkle_area=min_mask_region_area))
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.use_m2m = use_m2m
        self.multimask_output = multimask_output

    # public API

    @torch.inference_mode()
    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """HWC uint8 image -> list of annotation records (upstream schema)."""
        data = self._all_crops(image)

        if self.output_mode == "coco_rle":
            segs = [A.coco_encode_rle(r) for r in data["rles"]]
        elif self.output_mode == "binary_mask":
            segs = [A.rle_to_mask(r) for r in data["rles"]]
        else:
            segs = data["rles"]

        return [
            {
                "segmentation": seg,
                "area": A.area_from_rle(rle),
                "bbox": A.box_xyxy_to_xywh(box).tolist(),
                "predicted_iou": float(iou),
                "point_coords": [point.tolist()],
                "stability_score": float(stab),
                "crop_box": A.box_xyxy_to_xywh(crop).tolist(),
            }
            for seg, rle, box, iou, point, stab, crop in zip(
                segs, data["rles"], data["boxes"], data["iou_preds"], data["points"],
                data["stability_score"], data["crop_boxes"])
        ]

    # pipeline stages

    def _all_crops(self, image: np.ndarray) -> A.Records:
        orig_size = image.shape[:2]
        crop_boxes, layers = A.generate_crop_boxes(orig_size, self.crop_n_layers,
                                                   self.crop_overlap_ratio)
        data = A.concat_records([self._one_crop(image, box, layer, orig_size)
                                 for box, layer in zip(crop_boxes, layers)])
        if len(crop_boxes) > 1:
            # deduplicate across crops, preferring masks from smaller crops
            crop_area = ((data["crop_boxes"][:, 2] - data["crop_boxes"][:, 0])
                         * (data["crop_boxes"][:, 3] - data["crop_boxes"][:, 1])).astype(np.float64)
            keep = A.batched_nms(data["boxes"], 1.0 / np.maximum(crop_area, 1),
                                 np.zeros(len(crop_area)), iou_threshold=self.crop_nms_thresh)
            data = A.filter_records(data, keep)
        if self.min_mask_region_area > 0:
            data = self._clean_small_regions(data, self.min_mask_region_area,
                                             max(self.box_nms_thresh, self.crop_nms_thresh))
        return data

    def _one_crop(self, image, crop_box, layer: int, orig_size) -> A.Records:
        x0, y0, x1, y1 = crop_box
        crop = image[y0:y1, x0:x1, :]
        crop_hw = crop.shape[:2]
        self.predictor.set_image(crop)
        grid = self.point_grids[layer] * np.asarray(crop_hw)[None, ::-1]
        try:
            chunks = [self._one_chunk(pts, crop_hw, crop_box, orig_size)
                      for (pts,) in A.chunked(self.points_per_batch, grid)]
        finally:
            self.predictor.reset_predictor()
        data = A.concat_records(chunks)

        # within-crop dedup, then lift coordinates to the full image
        keep = A.batched_nms(data["boxes"], data["iou_preds"], np.zeros(A.num_records(data)),
                             iou_threshold=self.box_nms_thresh)
        data = A.filter_records(data, keep)
        data["boxes"] = A.shift_boxes(data["boxes"], crop_box)
        data["points"] = A.shift_points(data["points"], crop_box)
        data["crop_boxes"] = np.tile(np.asarray(crop_box)[None], (A.num_records(data), 1))
        return data

    def _one_chunk(self, points, crop_hw, crop_box, orig_size) -> A.Records:
        """Predict one chunk of grid points and run the row filters on the
        device: IoU threshold -> stability threshold -> binarize -> drop
        crop-edge artifacts; then encode the survivors' RLE on the host."""
        orig_h, orig_w = orig_size
        h, w = crop_hw
        points = np.asarray(points, np.float32)
        model_pts = points / np.asarray([w, h], np.float32) * self.predictor.cfg.image_size
        labels = np.ones((len(points), 1), np.int32)

        logits, iou_preds, low_res = self.predictor._predict(
            model_pts[:, None, :], labels, multimask_output=self.multimask_output,
            return_logits=True)
        slots = logits.shape[1]
        logits = logits.flatten(0, 1)
        iou_preds = iou_preds.flatten(0, 1)
        points = np.repeat(points, slots, axis=0)
        if self.use_m2m:
            logits, iou_preds = self._refine_m2m(points, low_res.flatten(0, 1), crop_hw)

        keep = torch.ones_like(iou_preds, dtype=torch.bool)
        if self.pred_iou_thresh > 0.0:
            keep &= iou_preds > self.pred_iou_thresh
        stability = stability_score(logits, self.mask_threshold, self.stability_score_offset)
        if self.stability_score_thresh > 0.0:
            keep &= stability >= self.stability_score_thresh
        keep = keep.cpu().numpy()
        rows = torch.as_tensor(np.flatnonzero(keep), device=logits.device)
        masks = logits[rows] > self.mask_threshold
        boxes = mask_to_box(masks).cpu().numpy()
        data: A.Records = {
            "iou_preds": iou_preds[rows].float().cpu().numpy(),
            "points": points[keep],
            "stability_score": stability[rows].cpu().numpy(),
            "boxes": boxes,
        }
        edge = A.touches_crop_edge(boxes, crop_box, [0, 0, orig_w, orig_h])
        if edge.any():
            data = A.filter_records(data, ~edge)
            masks = masks[torch.as_tensor(~edge, device=masks.device)]

        x0, y0, x1, y1 = crop_box
        masks_full = F.pad(masks, (x0, orig_w - x1, y0, orig_h - y1))
        data["rles"] = A.mask_to_rle(masks_full.cpu().numpy())
        return data

    def _refine_m2m(self, points, low_res, crop_hw):
        """One refinement pass: feed each mask's low-res logits back with its
        point (single-mask output). Returns (logits, iou_preds)."""
        h, w = crop_hw
        model_pts = points / np.asarray([w, h], np.float32) * self.predictor.cfg.image_size
        labels = np.ones((len(model_pts), 1), np.int32)
        masks, ious = [], []
        for start in range(0, len(model_pts), self.points_per_batch):
            end = start + self.points_per_batch
            m, i, _ = self.predictor._predict(
                model_pts[start:end, None, :], labels[start:end],
                mask_input=low_res[start:end, None].cpu().numpy(),
                multimask_output=False, return_logits=True)
            masks.append(m[:, 0])
            ious.append(i[:, 0])
        return torch.cat(masks), torch.cat(ious)

    def _clean_small_regions(self, data: A.Records, min_area: int,
                             nms_thresh: float) -> A.Records:
        """Fill small holes / drop small islands in every mask, then NMS away
        duplicates created by the cleanup (unchanged masks win ties)."""
        if A.num_records(data) == 0:
            return data
        cleaned, untouched = [], []
        for rle in data["rles"]:
            mask = A.rle_to_mask(rle)
            mask, filled = A.remove_small_regions(mask, min_area, "holes")
            mask, dropped = A.remove_small_regions(mask, min_area, "islands")
            cleaned.append(mask)
            untouched.append(float(not (filled or dropped)))
        masks = np.stack(cleaned)
        boxes = A.batched_mask_to_box(masks)
        keep = A.batched_nms(boxes, np.asarray(untouched), np.zeros(len(untouched)),
                             iou_threshold=nms_thresh)
        rles = list(data["rles"])
        out_boxes = np.array(data["boxes"], copy=True)
        for i in keep:
            if untouched[i] == 0.0:
                rles[i] = A.mask_to_rle(masks[i][None])[0]
                out_boxes[i] = boxes[i]
        data = dict(data)
        data["rles"] = rles
        data["boxes"] = out_boxes
        return A.filter_records(data, keep)
