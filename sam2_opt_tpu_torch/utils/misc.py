"""Mask and point helpers of the predictors and the asynchronous frame
loader (counterpart of `sam2_opt_tpu/utils/misc.py`; reference
sam2/sam2/utils/misc.py)."""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

from sam2_opt_tpu_torch.ops.connected_components import connected_components
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


def get_connected_components(mask):
    """8-connectivity labels and areas of [N, H, W] or [N, 1, H, W] binary
    masks (the reference's `_C.get_connected_componnets` surface,
    csrc/connected_components.cu:213): labels 0 on the background and
    1..N per component, areas the area of each pixel's component, both
    int32 in the input's shape."""
    m = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask) else mask)
    channel = m.dim() == 4
    labels, areas = connected_components((m[:, 0] if channel else m).bool())
    return (labels[:, None], areas[:, None]) if channel else (labels, areas)


class AsyncVideoFrameLoader:
    """Decodes JPEG frames on a background thread ahead of the tracking loop
    (reference misc.py:104-149): uint8 [S, S, 3] frames, at most `lookahead`
    ahead of the consumer, frames behind it evicted; a frame behind the
    window or a forward seek beyond it is decoded on demand on the
    consumer's thread; an exception of the worker is raised again there."""

    def __init__(self, paths, image_size: int, lookahead: int = 32):
        self.paths = list(paths)
        self.image_size = image_size
        self.lookahead = max(int(lookahead), 1)
        self.frames: Dict[int, np.ndarray] = {}
        self._consumed = -1  # highest index returned to the consumer
        self.exception: Optional[BaseException] = None
        self._cv = threading.Condition()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _decode(self, idx: int) -> np.ndarray:
        from PIL import Image

        from sam2_opt_tpu_torch.io.video import _resize_uint8

        with Image.open(self.paths[idx]) as img:
            return _resize_uint8(np.asarray(img.convert("RGB")), self.image_size)

    def _worker(self):
        try:
            i, n = 0, len(self.paths)
            while i < n:
                with self._cv:
                    # bounded lookahead: a long video is never all resident
                    while i - self._consumed > self.lookahead and self.exception is None:
                        self._cv.wait(timeout=60)
                    # a seek may have moved the window past i (the skipped
                    # frames are decoded on demand): follow it
                    i = max(i, self._consumed + 1)
                    if i >= n:
                        break
                frame = self._decode(i)
                with self._cv:
                    self.frames[i] = frame
                    for k in [k for k in self.frames if k < self._consumed - 1]:
                        del self.frames[k]
                    self._cv.notify_all()
                i += 1
        except BaseException as e:  # handed to the consumer, which raises it
            with self._cv:
                self.exception = e
                self._cv.notify_all()

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        if not 0 <= idx < len(self.paths):
            raise IndexError(idx)
        with self._cv:
            if self.exception is not None:
                raise self.exception
            if idx in self.frames:
                self._consumed = max(self._consumed, idx)
                self._cv.notify_all()
                return self.frames[idx]
            # behind the window (evicted or skipped by a seek), or a forward
            # seek beyond it: waiting for the latter would deadlock (the
            # worker waits for _consumed to advance), so move the window to
            # idx and decode it here, outside the lock
            on_demand = idx <= self._consumed or idx - self._consumed > self.lookahead
            if on_demand:
                self._consumed = max(self._consumed, idx)
                self._cv.notify_all()
        if on_demand:
            return self._decode(idx)
        with self._cv:
            # another consumer may seek past idx while this one waits: the
            # worker then never decodes it, so decode it here
            while idx not in self.frames and self.exception is None and idx > self._consumed:
                self._cv.wait(timeout=60)
            if self.exception is not None:
                raise self.exception
            if idx in self.frames:
                self._consumed = max(self._consumed, idx)
                self._cv.notify_all()
                return self.frames[idx]
        return self._decode(idx)
