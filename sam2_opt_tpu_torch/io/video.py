"""Video frame loading (counterpart of `sam2_opt_tpu/io/video.py`; reference
sam2/sam2/utils/misc.py:172-309).

The frames are the JAX loader's uint8 frames, byte for byte, decoded and
resized on the host as it does them, then uploaded to the model's device as
uint8 [T, 3, S, S]:
- a directory of JPEG frames: the native threaded libjpeg decode and its
  half-pixel bilinear resize (`io/native.py`, the shared `csrc/sam2io.cpp`)
  when that library builds, else Pillow and `_resize_uint8`. Which of the
  two runs follows the JAX package's choice, which depends on the library
  too (`native.available()` says which);
- a directory holding PNG frames: Pillow and `_resize_uint8`;
- a video file (mp4): OpenCV's decode and `_resize_uint8`;
- an ndarray [T, H, W, 3] (uint8, or float in [0, 1] or [0, 255]):
  `_resize_uint8` where its frames are not already S x S.
cv2 is imported only where it resizes or decodes.
"""

from __future__ import annotations

import os
import re
from typing import Tuple

import numpy as np
import torch

from sam2_opt_tpu_torch.io import native
from sam2_opt_tpu_torch.models.model import default_device


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


def _jpeg_dir_native(paths, image_size: int):
    """(frames, h, w) of a JPEG directory from the native decode, or None
    where it is unavailable or a file fails (the JAX `_load_jpeg_dir` fast
    path)."""
    if not all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
        return None
    dims = native.jpeg_dims(paths[0])
    if dims is None:
        return None
    frames = native.decode_jpeg_batch(paths, image_size)
    return None if frames is None else (frames, *dims)


def _host_frames(video_path, image_size: int):
    """(uint8 [T, S, S, 3] frames, video_height, video_width) on the host,
    as the JAX loader makes them."""
    if isinstance(video_path, np.ndarray):
        if video_path.ndim != 4 or video_path.shape[-1] != 3:
            raise ValueError(f"video array must be [T, H, W, 3], got {video_path.shape}")
        frames = _to_uint8(video_path)
        h, w = frames.shape[1:3]
        if (h, w) != (image_size, image_size):
            frames = np.stack([_resize_uint8(f, image_size) for f in frames])
        return frames, h, w
    if isinstance(video_path, str) and os.path.isdir(video_path):
        paths = _frame_paths(video_path)
        decoded = _jpeg_dir_native(paths, image_size)
        if decoded is not None:
            return decoded
        frames = [_read_frame(p) for p in paths]
    elif isinstance(video_path, str):
        frames = _read_mp4(video_path)
    else:
        raise NotImplementedError(f"unsupported video source {type(video_path)}: an ndarray "
                                  f"[T, H, W, 3], a JPEG or PNG directory or a video file")
    h, w = frames[0].shape[:2]
    return np.stack([_resize_uint8(f, image_size) for f in frames]), h, w


def load_video_frames(video_path, image_size: int = 1024, offload_video_to_cpu: bool = False,
                      device=None) -> Tuple[torch.Tensor, int, int]:
    """Load a video resized to the model resolution. Returns (frames uint8
    [T, 3, S, S], video_height, video_width); the frames stay on `device`
    (the card unless the caller names another) unless `offload_video_to_cpu`."""
    device = default_device(device)
    frames, video_h, video_w = _host_frames(video_path, image_size)
    store = "cpu" if offload_video_to_cpu else device
    out = torch.from_numpy(frames).to(store).permute(0, 3, 1, 2).contiguous()
    return out, video_h, video_w
