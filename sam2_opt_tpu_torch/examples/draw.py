"""Visualization helpers (counterpart of `examples/draw.py`; reference
draw.py:10-65)."""

from __future__ import annotations

import os

import numpy as np


def gen_image_writer(output_path: str):
    """Returns write(image_bgr) that saves numbered PNGs (reference draw.py:10)."""
    os.makedirs(output_path, exist_ok=True)
    count = [0]

    def write(image):
        import cv2

        cv2.imwrite(os.path.join(output_path, f"{count[0]:05d}.png"), image)
        count[0] += 1

    return write


def gen_video_writer(output_path: str, fps: float, width: int, height: int):
    """Returns (write(frame_bgr), release) closures (reference draw.py:21)."""
    import cv2

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    return writer.write, writer.release


_COLORS = np.array(
    [
        [255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0],
        [255, 0, 255], [0, 255, 255], [128, 255, 0], [255, 128, 0],
    ],
    np.float32,
)


def draw_mask(image: np.ndarray, mask: np.ndarray, obj_idx: int = 0,
              alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend a binary mask onto an image (reference draw.py:39)."""
    color = _COLORS[obj_idx % len(_COLORS)]
    out = image.astype(np.float32)
    m = mask.astype(bool)
    out[m] = out[m] * (1 - alpha) + color * alpha
    return out.astype(np.uint8)


def save_masks(image: np.ndarray, masks, writer, alpha: float = 0.5):
    """Blend all masks and emit through a writer (reference draw.py:49)."""
    out = image
    for i, mask in enumerate(masks):
        out = draw_mask(out, np.asarray(mask) > 0, i, alpha)
    writer(out[..., ::-1])  # RGB -> BGR for cv2 writers
    return out
