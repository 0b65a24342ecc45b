"""The video slice end to end: the port's SAM2VideoPredictor against the JAX
package's, on the same weights and the same 6-frame 128² video, fp32 on the
CPU, with the default fill_hole_area=8.

Weights: the JAX `tiny128_params` with the object-score head's last bias
raised by 10 on both sides, so every tracked frame scores the object present
and its logits come from the network (random weights otherwise give every
tracked frame NO_OBJ_SCORE, and the comparison would see constants).

The script: a click on frame 0 for object 1 and a negative one added to it
(`clear_old_points=False`, fed the first click's logits), `add_new_mask` on
frame 2 for object 2, forward propagation (frames 1 and 3-5 track both
objects as one batch), a correction click on the tracked frame 4, reverse
propagation from frame 5, `remove_object(2)`. Every returned
video-res logit map and every stored low-res logit map is held at atol 1e-4
(measured: below 1e-6; the module tests hold single modules at 1e-4). The
bf16 gate mirrors tests/test_accuracy_gate.py: per-frame mask mIoU > 0.97.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from sam2_opt_tpu.models.model import SAM2Model as JaxSAM2Model
from sam2_opt_tpu.predictors.video import SAM2VideoPredictor as JaxVideoPredictor
from sam2_opt_tpu_torch import build_sam2_video_predictor
from sam2_opt_tpu_torch.io.video import load_video_frames
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_rope
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

torch.set_num_threads(2)

T, S = 6, 128
ATOL = 1e-4


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


def _mask2():
    yy, xx = np.mgrid[0:S, 0:S]
    return (xx - 96) ** 2 + (yy - 30) ** 2 < 12 ** 2


@pytest.fixture(scope="module")
def weights(tiny128_params):
    params = copy.deepcopy(jax.tree_util.tree_map(np.asarray, tiny128_params))
    head = params["sam_mask_decoder"]["pred_obj_score_head"]["layers"][2]
    head["bias"] = head["bias"] + 10.0
    return params


def _run(predictor, video):
    """The script of the module docstring; returns every output, in order."""
    outs = []
    state = predictor.init_state(video)
    outs.append(predictor.add_new_points_or_box(
        state, 0, 1, points=np.array([[36.0, 56.0]], np.float32), labels=np.array([1]))[2])
    outs.append(predictor.add_new_points_or_box(
        state, 0, 1, points=np.array([[20.0, 100.0]], np.float32), labels=np.array([0]),
        clear_old_points=False)[2])
    outs.append(predictor.add_new_mask(state, 2, 2, _mask2())[2])
    outs += [m for _, _, m in predictor.propagate_in_video(state)]
    outs.append(predictor.add_new_points_or_box(
        state, 4, 1, points=np.array([[68.0, 56.0]], np.float32), labels=np.array([1]))[2])
    outs += [m for _, _, m in predictor.propagate_in_video(state, start_frame_idx=5, reverse=True)]
    lows = [out["pred_masks"] for obj in state["output_dict_per_obj"].values()
            for frames in obj.values() for out in frames.values()]
    obj_ids, updated = predictor.remove_object(state, 2)
    assert obj_ids == [1]
    outs += [m for _, m in updated]
    return [np.asarray(x) for x in outs], [np.asarray(x) for x in lows], state


def test_full_loop_matches_jax(tiny128_cfg, weights):
    video = _video()
    jax_outs, jax_lows, _ = _run(JaxVideoPredictor(JaxSAM2Model(weights, tiny128_cfg)), video)
    predictor = SAM2VideoPredictor(build_sam2(cfg=tiny128_cfg,
                                              state_dict=state_dict_from_params(weights),
                                              device="cpu"))
    assert predictor.fill_hole_area == 8
    k1, k2 = flash_attention.launches, flash_attention_rope.launches
    outs, lows, state = _run(predictor, video)
    # CPU tensors run the plain versions: no kernel launches
    assert (flash_attention.launches, flash_attention_rope.launches) == (k1, k2)
    assert len(outs) == len(jax_outs) == 4 + T + T + 1 and len(lows) == len(jax_lows) == 2 * T
    for a, b in zip(outs + lows, jax_outs + jax_lows):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    # the tracked frames carry network logits, not placeholder scores
    tracked = np.stack(lows)
    assert np.abs(tracked).max() < 100 and np.ptp(tracked) > 0.05
    assert state["obj_ids"] == [1] and len(state["output_dict_per_obj"]) == 1


def test_bf16_video_mask_miou(tiny128_cfg, weights):
    predictor = SAM2VideoPredictor(build_sam2(cfg=tiny128_cfg,
                                              state_dict=state_dict_from_params(weights),
                                              device="cpu"))
    video = _video()
    fp32, _, _ = _run(predictor, video)
    predictor.speedup()
    assert predictor.model.compute_dtype == torch.bfloat16
    bf16, _, _ = _run(predictor, video)
    ious = []
    for a, b in zip(fp32, bf16):
        for ma, mb in zip(a > 0, b > 0):
            if ma.any() or mb.any():
                ious.append((ma & mb).sum() / (ma | mb).sum())
    assert len(ious) > T and min(ious) > 0.97, ious


def test_video_loader_sources(tmp_path):
    """ndarray uint8 and float frames, and a JPEG directory, resized to the
    model size with torch (bilinear, antialias) and kept as uint8."""
    from PIL import Image

    rng = np.random.default_rng(1)
    video = (rng.random((3, 60, 90, 3)) * 255).astype(np.uint8)
    frames, h, w = load_video_frames(video, 32, device="cpu")
    assert (h, w) == (60, 90) and frames.shape == (3, 3, 32, 32) and frames.dtype == torch.uint8
    same, _, _ = load_video_frames(video.astype(np.float32) / 255.0, 32, device="cpu")
    assert torch.equal(frames, same)
    for i, f in enumerate(video):
        Image.fromarray(f).save(tmp_path / f"frame_{i:03d}.jpg")
    decoded = np.stack([np.asarray(Image.open(tmp_path / f"frame_{i:03d}.jpg")) for i in range(3)])
    from_dir, h, w = load_video_frames(str(tmp_path), 32, device="cpu")
    assert (h, w) == (60, 90)
    assert torch.equal(from_dir, load_video_frames(decoded, 32, device="cpu")[0])
    with pytest.raises(NotImplementedError):
        load_video_frames(str(tmp_path / "clip.mp4"), 32, device="cpu")


def test_video_builder_options(monkeypatch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_sam2_video_predictor("hiera_t", device="cpu", vos_optimized=True)
    monkeypatch.setenv("SAM2_VERSION_TRACK", "dam4sam")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_sam2_video_predictor("hiera_t", device="cpu")
