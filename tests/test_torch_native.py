"""The port's native sam2io bindings (`sam2_opt_tpu_torch/io/native.py`) and
its video frames (`io/video.py::load_video_frames`) against the JAX
package's, on the CPU.

- the library the port builds from the shared `csrc/sam2io.cpp` (into
  `build/`, its name hashed): RLE and boxes equal to the JAX package's
  `native` module, JPEG sizes and decodes byte for byte;
- the frames of every source equal the JAX loader's byte for byte: a JPEG
  directory (the native decode), a PNG directory, uint8 and float ndarrays
  (one already at the model size, which neither resizes), an mp4; and a
  JPEG directory without the library on both sides (Pillow and
  `_resize_uint8`).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from sam2_opt_tpu.io import native as jax_native
from sam2_opt_tpu.io.video import load_video_frames as jax_load_video_frames
from sam2_opt_tpu_torch.io import native
from sam2_opt_tpu_torch.io.video import load_video_frames
from sam2_opt_tpu_torch.kernels._build import BUILD_DIR

SIZE = 48


@pytest.fixture(scope="module")
def libs():
    if not jax_native.available():
        pytest.skip("the JAX package's native sam2io does not load here")
    assert native.available(), native.build_error()
    return True


def _video(seed=4, T=3, H=40, W=72):
    """Blocky frames, so a JPEG keeps them close to the source."""
    rng = np.random.default_rng(seed)
    return (np.kron(rng.random((T, H // 8, W // 8, 3)), np.ones((1, 8, 8, 1))) * 255).astype(
        np.uint8)


def _write(tmp_path, video, ext):
    d = tmp_path / ext
    d.mkdir()
    for t, frame in enumerate(video):
        Image.fromarray(frame).save(d / f"{t:05d}.{ext}")
    return str(d)


def _jax_frames(source, size=SIZE):
    frames, h, w = jax_load_video_frames(source, image_size=size)
    return frames.frames, h, w


def _port_frames(source, size=SIZE):
    frames, h, w = load_video_frames(source, size, device="cpu")
    assert frames.dtype == torch.uint8 and frames.shape[1:] == (3, size, size)
    return frames.permute(0, 2, 3, 1).numpy(), h, w


def test_library_is_built_from_the_shared_source(libs):
    path = native.library_path()
    assert path.parent == BUILD_DIR and path.name.startswith("libsam2io-") and path.exists()
    assert native.SOURCE.name == "sam2io.cpp" and native.SOURCE.parent.name == "csrc"
    assert native.build_error() is None


def test_rle_and_box_match_jax(libs):
    rng = np.random.default_rng(0)
    masks = [rng.random(s) > 0.5 for s in ((33, 57), (64, 64))]
    first = np.zeros((9, 11), bool)
    first[0, 0] = first[4:7, 3:8] = True
    for mask in masks + [first, np.zeros((5, 6), bool)]:
        ours, ref = native.rle_encode(mask), jax_native.rle_encode(mask)
        assert ours == ref
        assert np.array_equal(native.rle_decode(ours), mask)
        assert np.array_equal(native.mask_to_box(mask), jax_native.mask_to_box(mask))


def test_jpeg_decode_matches_jax(libs, tmp_path):
    d = _write(tmp_path, _video(), "jpg")
    paths = [f"{d}/{t:05d}.jpg" for t in range(3)]
    assert native.jpeg_dims(paths[0]) == jax_native.jpeg_dims(paths[0]) == (40, 72)
    assert native.jpeg_dims(f"{d}/missing.jpg") is None
    for size in (SIZE, 96):
        ours = native.decode_jpeg_batch(paths, size)
        assert ours.shape == (3, size, size, 3)
        assert np.array_equal(ours, jax_native.decode_jpeg_batch(paths, size))
    assert native.decode_jpeg_batch(paths + [f"{d}/missing.jpg"], SIZE) is None


@pytest.mark.parametrize("source", ["jpeg_dir", "png_dir", "uint8", "float01", "float255",
                                    "at_size", "mp4"])
def test_frames_equal_jax_loader(libs, tmp_path, source):
    video = _video()
    if source == "jpeg_dir":
        src = _write(tmp_path, video, "jpg")
    elif source == "png_dir":
        src = _write(tmp_path, video, "png")
    elif source == "uint8":
        src = video
    elif source == "float01":
        src = video.astype(np.float32) / 255.0
    elif source == "float255":
        src = video.astype(np.float32)
    elif source == "at_size":
        src = _video(H=SIZE, W=SIZE)
    else:
        import cv2

        src = str(tmp_path / "clip.mp4")
        writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 24, (72, 40))
        for frame in video:
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
    ours, h, w = _port_frames(src)
    ref, rh, rw = _jax_frames(src)
    assert (h, w) == (rh, rw) and np.array_equal(ours, ref)


def test_jpeg_dir_without_the_library_takes_pillow_path(libs, tmp_path, monkeypatch):
    """Where the library does not build, both packages decode a JPEG
    directory with Pillow and `_resize_uint8`; the frames still agree, and
    differ from the native decode's."""
    d = _write(tmp_path, _video(), "jpg")
    native_frames, _, _ = _port_frames(d)
    monkeypatch.setattr(native, "_LIB", False)
    monkeypatch.setattr(jax_native, "_LIB", False)
    assert not native.available() and native.rle_encode(np.ones((2, 2), bool)) is None
    ours, _, _ = _port_frames(d)
    ref, _, _ = _jax_frames(d)
    assert np.array_equal(ours, ref) and not np.array_equal(ours, native_frames)
