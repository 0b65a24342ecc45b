"""PNG frames in the port: a folder of `.png` frames (RGB, gray and palette
images) through the port's `io/video.py`, equal byte for byte to the JAX
loader's uint8 frames at the same model size (both decode with Pillow and
resize with `_resize_uint8`)."""

import numpy as np
import pytest
import torch
from PIL import Image

from sam2_opt_tpu.io.video import load_video_frames as jax_load_video_frames
from sam2_opt_tpu_torch.io.video import load_video_frames


def _frame_image(frame: np.ndarray, mode: str, rng) -> Image.Image:
    if mode == "RGB":
        return Image.fromarray(frame)
    if mode == "L":
        return Image.fromarray(frame[..., 1])
    img = Image.fromarray((frame[..., 0] % 7).astype(np.uint8), mode="P")
    img.putpalette([int(v) for v in rng.integers(0, 256, 768)])
    return img


@pytest.mark.parametrize("mode", ["RGB", "L", "P"])
def test_png_frame_folder_matches_jax_loader(tmp_path, mode):
    rng = np.random.default_rng(1)
    video = (rng.random((3, 64, 64, 3)) * 255).astype(np.uint8)
    for t, frame in enumerate(video):
        _frame_image(frame, mode, rng).save(tmp_path / f"{t:05d}.png")
    jax_frames, h, w = jax_load_video_frames(str(tmp_path), image_size=32)
    assert (h, w) == (64, 64)
    frames, h, w = load_video_frames(str(tmp_path), 32, device="cpu")
    assert (h, w) == (64, 64) and frames.shape == (3, 3, 32, 32) and frames.dtype == torch.uint8
    np.testing.assert_array_equal(frames.permute(0, 2, 3, 1).numpy(), jax_frames.frames)
