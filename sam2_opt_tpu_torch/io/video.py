"""Video frame loading (counterpart of `sam2_opt_tpu/io/video.py`; reference
sam2/sam2/utils/misc.py:172-309).

Frames are resized to the model resolution with torch (bilinear with
antialias, as `utils/transforms.py::resize_to_model`) on the model's device,
one at a time, and kept as uint8 [T, 3, S, S], as the JAX package keeps
uint8 frames. Sources: an ndarray [T, H, W, 3] (uint8, or float in [0, 1]
or [0, 255]), a directory of JPEG or PNG frames read through Pillow, or a
video file (mp4) decoded through OpenCV, as the JAX loader reads them. cv2
is imported only when a video file is read.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np
import torch

from sam2_opt_tpu_torch.models.model import default_device
from sam2_opt_tpu_torch.utils.transforms import resize_to_model


def _to_uint8(arr: np.ndarray) -> np.ndarray:
    """Float frames in [0, 1] (max below 2) or [0, 255] -> uint8, as the JAX
    package reads them."""
    if not np.issubdtype(arr.dtype, np.floating):
        return arr.astype(np.uint8)
    scale = 255.0 if float(arr.max()) < 2.0 else 1.0
    return np.clip(np.rint(arr * scale), 0, 255).astype(np.uint8)


def _frame_paths(path: str):
    """JPEG or PNG frames named by frame number (misc.py:213-277): bare
    integer stems, or a unique trailing digit run."""
    names = [n for n in os.listdir(path)
             if os.path.splitext(n)[-1].lower() in (".jpg", ".jpeg", ".png")]
    if not names:
        raise RuntimeError(f"no JPEG or PNG frames found in {path}")

    def frame_no(name):
        m = re.search(r"(\d+)\D*$", os.path.splitext(name)[0])
        if m is None:
            raise RuntimeError(f"cannot order frame file {name!r} in {path}: no frame number")
        return int(m.group(1))

    keys = [frame_no(n) for n in names]
    if len(set(keys)) != len(keys):
        raise RuntimeError(f"ambiguous frame ordering in {path}: frame numbers repeat")
    return [os.path.join(path, n) for _, n in sorted(zip(keys, names))]


def _read_frame(path: str) -> np.ndarray:
    """uint8 [H, W, 3] RGB of one frame file."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _resize_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """HWC uint8 RGB -> (size, size): OpenCV's area (down) or bilinear (up)
    interpolation, Pillow's bilinear without OpenCV. The frames of
    `utils.misc.AsyncVideoFrameLoader`, as the JAX package resizes them."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR))
    interp = cv2.INTER_AREA if img.shape[0] > size else cv2.INTER_LINEAR
    return cv2.resize(img, (size, size), interpolation=interp)


def _read_mp4(path: str):
    """uint8 [H, W, 3] RGB frames of a video file, decoded through OpenCV
    (the reference decodes with decord, misc.py:280-309)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {path}")
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return frames


def _resize_frame(frame_hwc: np.ndarray, image_size: int, device) -> torch.Tensor:
    """uint8 [H, W, 3] -> uint8 [3, S, S], resized on `device`."""
    x = torch.as_tensor(np.array(frame_hwc), device=device).permute(2, 0, 1)[None]
    x = resize_to_model(x.float(), image_size)
    return x[0].round().clamp(0, 255).to(torch.uint8)


def load_video_frames(video_path, image_size: int = 1024, offload_video_to_cpu: bool = False,
                      device=None) -> Tuple[torch.Tensor, int, int]:
    """Load a video resized to the model resolution. Returns (frames uint8
    [T, 3, S, S], video_height, video_width); the frames stay on `device`
    (the card unless the caller names another) unless `offload_video_to_cpu`."""
    device = default_device(device)
    if isinstance(video_path, np.ndarray):
        if video_path.ndim != 4 or video_path.shape[-1] != 3:
            raise ValueError(f"video array must be [T, H, W, 3], got {video_path.shape}")
        frames = list(_to_uint8(video_path))
    elif isinstance(video_path, str) and os.path.isdir(video_path):
        frames = [_read_frame(p) for p in _frame_paths(video_path)]
    elif isinstance(video_path, str):
        frames = _read_mp4(video_path)
    else:
        raise NotImplementedError(f"unsupported video source {type(video_path)}: an ndarray "
                                  f"[T, H, W, 3], a JPEG or PNG directory or a video file")
    video_h, video_w = frames[0].shape[:2]
    store = "cpu" if offload_video_to_cpu else device
    out = torch.stack([_resize_frame(f, image_size, device).to(store) for f in frames])
    return out, video_h, video_w
