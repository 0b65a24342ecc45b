"""The port's video input (`sam2_opt_tpu_torch/io/video.py`,
`utils/misc.py`, `predictors/video.py::init_state`) against the JAX
package's, on the CPU:

- an mp4 written with OpenCV: the port's frames equal the JAX loader's
  byte for byte (the same decode and resize), and a file that will not
  open raises;
- `AsyncVideoFrameLoader`: the JAX package's own cases
  (`tests/test_utils_misc.py`: ordering, the bounded lookahead, a forward
  seek without deadlock, the error trampoline), and every frame equal to
  the JAX loader's;
- `get_connected_components` equal to JAX's, labels and areas;
- `init_state(offload_state_to_cpu=True, async_loading_frames=True)`
  records both flags and gives the masks of the run without them, each
  within 1e-4 of one JAX run at the tiny config (hiera_t, 128 px), the
  object-score bias raised by 10 on both sides so tracked frames carry
  network logits.
"""

import copy
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sam2_opt_tpu.io.video import load_video_frames as jax_load_video_frames
from sam2_opt_tpu.models.model import SAM2Model as JaxSAM2Model
from sam2_opt_tpu.predictors.video import SAM2VideoPredictor as JaxVideoPredictor
from sam2_opt_tpu.utils import misc as jax_misc
from sam2_opt_tpu_torch.io.video import load_video_frames
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor
from sam2_opt_tpu_torch.utils import misc

torch.set_num_threads(2)

ATOL = 1e-4


def _write_mp4(path, video):
    import cv2

    T, H, W, _ = video.shape
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 24, (W, H))
    for frame in video:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def test_mp4_frames_match_jax_loader(tmp_path):
    rng = np.random.default_rng(2)
    video = (np.kron(rng.random((4, 6, 6, 3)), np.ones((1, 8, 8, 1))) * 255).astype(np.uint8)
    path = tmp_path / "clip.mp4"
    _write_mp4(path, video)
    # mp4 is lossy: the source pixels are not the reference, the JAX
    # loader's frames are
    jax_frames, h, w = jax_load_video_frames(str(path), image_size=32)
    assert (h, w) == (48, 48) and jax_frames.frames.shape == (4, 32, 32, 3)
    frames, h, w = load_video_frames(str(path), 32, device="cpu")
    assert (h, w) == (48, 48) and frames.shape == (4, 3, 32, 32) and frames.dtype == torch.uint8
    np.testing.assert_array_equal(frames.permute(0, 2, 3, 1).numpy(), jax_frames.frames)
    # the decode is close to the source, and kept on the CPU when asked
    decoded, _, _ = jax_load_video_frames(str(path), image_size=48)
    assert np.abs(decoded.frames.astype(int) - video).mean() < 8
    kept, _, _ = load_video_frames(str(path), 32, offload_video_to_cpu=True, device="cpu")
    assert torch.equal(kept, frames)
    with pytest.raises(RuntimeError, match="cannot open"):
        load_video_frames(str(tmp_path / "missing.mp4"), 32, device="cpu")


def _jpeg_paths(tmp_path, n, value=None, shape=(40, 50)):
    paths = []
    for t in range(n):
        p = str(tmp_path / f"{t:03d}.jpg")
        arr = (np.full(shape + (3,), t * 20, np.uint8) if value else
               (np.random.default_rng(t).random(shape + (3,)) * 255).astype(np.uint8))
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def test_async_frame_loader_matches_jax(tmp_path):
    paths = _jpeg_paths(tmp_path, 4)
    loader = misc.AsyncVideoFrameLoader(paths, image_size=32)
    want = jax_misc.AsyncVideoFrameLoader(paths, image_size=32)
    assert len(loader) == 4
    for i in (3, 0, 1, 2):  # out of order
        got = loader[i]
        assert got.shape == (32, 32, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want[i])


def test_async_frame_loader_error_trampoline(tmp_path):
    loader = misc.AsyncVideoFrameLoader([str(tmp_path / "missing.jpg")], image_size=32)
    loader.thread.join(timeout=30)
    assert not loader.thread.is_alive()
    with pytest.raises(FileNotFoundError):
        loader[0]


def test_async_loader_bounded_lookahead_and_bounds(tmp_path):
    """At most about `lookahead` frames resident ahead of the consumer,
    evicted frames decoded on demand, IndexError out of range."""
    paths = _jpeg_paths(tmp_path, 12, value=True, shape=(8, 8))
    loader = misc.AsyncVideoFrameLoader(paths, image_size=8, lookahead=3)
    deadline = time.time() + 10
    while time.time() < deadline and len(loader.frames) < 4:
        time.sleep(0.05)
    time.sleep(0.3)
    assert len(loader.frames) <= 6, "the worker decoded far past the lookahead"
    for i in range(12):
        assert abs(int(np.asarray(loader[i]).mean().round()) - min(i * 20, 255)) <= 1
    assert len(loader.frames) <= 6
    assert int(np.asarray(loader[0]).mean().round()) == 0
    with pytest.raises(IndexError):
        loader[12]
    with pytest.raises(IndexError):
        loader[-1]


def test_async_loader_forward_seek_no_deadlock(tmp_path):
    """A frame beyond the prefetch window is a seek: decoded on demand, the
    worker follows the moved window, skipped frames decode on demand."""
    paths = _jpeg_paths(tmp_path, 12, value=True, shape=(8, 8))
    loader = misc.AsyncVideoFrameLoader(paths, image_size=8, lookahead=3)
    t0 = time.time()
    f9 = loader[9]
    assert time.time() - t0 < 30, "the forward seek hung"
    assert abs(int(np.asarray(f9).mean().round()) - 180) <= 1
    assert abs(int(np.asarray(loader[10]).mean().round()) - 200) <= 1
    assert abs(int(np.asarray(loader[2]).mean().round()) - 40) <= 1


def test_connected_components_match_jax():
    rng = np.random.default_rng(3)
    m = rng.random((2, 1, 24, 32)) > 0.6
    m[0, 0, 2:6, 2:6] = True
    labels, areas = misc.get_connected_components(m)
    want_labels, want_areas = jax_misc.get_connected_components(m)
    assert labels.shape == (2, 1, 24, 32) and labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_array_equal(areas.numpy(), np.asarray(want_areas))
    flat, _ = misc.get_connected_components(torch.as_tensor(m[:, 0]))
    assert torch.equal(flat, labels[:, 0])


T, S = 3, 128


def _video():
    """uint8 [T, 128, 128, 3]: 8x8 random colour blocks and a textured 32x32
    square moving 8 px right per frame."""
    rng = np.random.default_rng(0)
    bg = np.kron(rng.random((16, 16, 3)), np.ones((8, 8, 1)))
    square = np.kron(rng.random((4, 4, 3)) * 0.5 + 0.5, np.ones((8, 8, 1)))
    frames = []
    for t in range(T):
        f = bg.copy()
        f[40:72, 20 + 8 * t:52 + 8 * t] = square
        frames.append(f)
    return (np.stack(frames) * 255).astype(np.uint8)


def _track(predictor, **flags):
    state = predictor.init_state(_video(), **flags)
    first = predictor.add_new_points_or_box(
        state, 0, 1, points=np.array([[36.0, 56.0]], np.float32), labels=np.array([1]))[2]
    outs = [first] + [m for _, _, m in predictor.propagate_in_video(state)]
    return state, [np.asarray(x) for x in outs]


@pytest.fixture(scope="module")
def weights(tiny128_params):
    params = copy.deepcopy(jax.tree_util.tree_map(np.asarray, tiny128_params))
    head = params["sam_mask_decoder"]["pred_obj_score_head"]["layers"][2]
    head["bias"] = head["bias"] + 10.0
    return params


@pytest.fixture(scope="module")
def jax_masks(tiny128_cfg, weights):
    """One JAX run of the click and the propagation, for the module."""
    return _track(JaxVideoPredictor(JaxSAM2Model(weights, tiny128_cfg)))[1]


@pytest.mark.parametrize("flags", [
    {},
    {"offload_state_to_cpu": True},
    {"async_loading_frames": True},
    {"offload_state_to_cpu": True, "async_loading_frames": True},
], ids=["none", "offload_state", "async_frames", "both"])
def test_init_state_flags_give_the_same_masks(tiny128_cfg, weights, jax_masks, flags):
    predictor = SAM2VideoPredictor(build_sam2(cfg=tiny128_cfg,
                                              state_dict=state_dict_from_params(weights),
                                              device="cpu"))
    state, outs = _track(predictor, **flags)
    assert state["offload_state_to_cpu"] == flags.get("offload_state_to_cpu", False)
    assert state["async_loading_frames"] == flags.get("async_loading_frames", False)
    assert len(outs) == len(jax_masks) == T + 1
    for got, want in zip(outs, jax_masks):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # tracked frames carry network logits
    assert np.ptp(outs[-1]) > 0.05 and np.abs(outs[-1]).max() < 100
    if flags:
        _, plain = _track(predictor)
        for a, b in zip(outs, plain):
            np.testing.assert_array_equal(a, b)
