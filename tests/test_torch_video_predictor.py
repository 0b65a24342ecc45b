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
propagation from frame 5, `remove_object(2)`; once as is and once under
`SAM2_TPU_FUSED_KV_PROJ=1` (K4's route), against one JAX run. Every returned
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
from sam2_opt_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_kv_proj,
    flash_attention_rope,
)
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


@pytest.fixture(scope="module")
def jax_outputs(tiny128_cfg, weights):
    """The JAX predictor's outputs of the script, run once for the module
    (on the CPU it takes its unfused memory attention whatever the
    switches say)."""
    outs, lows, _ = _run(JaxVideoPredictor(JaxSAM2Model(weights, tiny128_cfg)), _video())
    return outs, lows


def _port_matches_jax(tiny128_cfg, weights, jax_outputs):
    jax_outs, jax_lows = jax_outputs
    predictor = SAM2VideoPredictor(build_sam2(cfg=tiny128_cfg,
                                              state_dict=state_dict_from_params(weights),
                                              device="cpu"))
    assert predictor.fill_hole_area == 8
    counts = (flash_attention.launches, flash_attention_rope.launches,
              flash_attention_kv_proj.launches)
    outs, lows, state = _run(predictor, _video())
    # CPU tensors run the plain versions: no kernel launches
    assert (flash_attention.launches, flash_attention_rope.launches,
            flash_attention_kv_proj.launches) == counts
    assert len(outs) == len(jax_outs) == 4 + T + T + 1 and len(lows) == len(jax_lows) == 2 * T
    for a, b in zip(outs + lows, jax_outs + jax_lows):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    # the tracked frames carry network logits, not placeholder scores
    tracked = np.stack(lows)
    assert np.abs(tracked).max() < 100 and np.ptp(tracked) > 0.05
    assert state["obj_ids"] == [1] and len(state["output_dict_per_obj"]) == 1


def test_full_loop_matches_jax(tiny128_cfg, weights, jax_outputs):
    _port_matches_jax(tiny128_cfg, weights, jax_outputs)


def test_full_loop_matches_jax_flash_routes(tiny128_cfg, weights, jax_outputs, monkeypatch):
    """Under `SAM2_TPU_FLASH=1` the port takes the card's default memory
    attention routes on CPU tensors: self- and cross-attention (the latter
    over memory frames and object pointers, more keys than queries) run
    K2's plain version (a spy sees both), and the loop still matches the
    same JAX outputs."""
    import sam2_opt_tpu_torch.models.memory_attention as ma

    calls = {"self": 0, "cross": 0}
    rope_ref = ma.flash_attention_rope_ref

    def spy(q, k, *a):
        calls["cross" if k.shape[-2] > q.shape[-2] else "self"] += 1
        return rope_ref(q, k, *a)

    monkeypatch.setattr(ma, "flash_attention_rope_ref", spy)
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    _port_matches_jax(tiny128_cfg, weights, jax_outputs)
    assert calls["cross"] > 0 and calls["cross"] == calls["self"], calls


def test_full_loop_matches_jax_fused_kv_proj(tiny128_cfg, weights, jax_outputs, monkeypatch):
    """Under `SAM2_TPU_FUSED_KV_PROJ=1` memory attention's cross-attention
    takes K4's plain version (a spy sees it, and K2's plain version serve
    only self-attention), and the loop still matches the same JAX outputs.
    The port's side sets `SAM2_TPU_FLASH=1`, which puts the kernel routes
    (their plain versions) on CPU tensors."""
    import sam2_opt_tpu_torch.models.memory_attention as ma

    calls = {"kv_proj": 0, "rope": 0}
    kv_ref, rope_ref = ma.flash_attention_kv_proj_ref, ma.flash_attention_rope_ref
    monkeypatch.setattr(ma, "flash_attention_kv_proj_ref",
                        lambda *a: calls.__setitem__("kv_proj", calls["kv_proj"] + 1) or kv_ref(*a))
    monkeypatch.setattr(ma, "flash_attention_rope_ref",
                        lambda *a: calls.__setitem__("rope", calls["rope"] + 1) or rope_ref(*a))
    monkeypatch.setenv("SAM2_TPU_FUSED_KV_PROJ", "1")
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    _port_matches_jax(tiny128_cfg, weights, jax_outputs)
    assert calls["kv_proj"] > 0 and calls["kv_proj"] == calls["rope"]


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
    model size as the JAX loader resizes them and kept as uint8, equal to
    its frames byte for byte; a path that is neither a directory nor a
    video file that opens raises."""
    from PIL import Image

    from sam2_opt_tpu.io.video import load_video_frames as jax_load_video_frames

    def jax_frames(source):
        return torch.from_numpy(jax_load_video_frames(source, image_size=32)[0].frames).permute(
            0, 3, 1, 2)

    rng = np.random.default_rng(1)
    video = (rng.random((3, 60, 90, 3)) * 255).astype(np.uint8)
    frames, h, w = load_video_frames(video, 32, device="cpu")
    assert (h, w) == (60, 90) and frames.shape == (3, 3, 32, 32) and frames.dtype == torch.uint8
    assert torch.equal(frames, jax_frames(video))
    same, _, _ = load_video_frames(video.astype(np.float32) / 255.0, 32, device="cpu")
    assert torch.equal(frames, same)
    for i, f in enumerate(video):
        Image.fromarray(f).save(tmp_path / f"frame_{i:03d}.jpg")
    from_dir, h, w = load_video_frames(str(tmp_path), 32, device="cpu")
    assert (h, w) == (60, 90)
    assert torch.equal(from_dir, jax_frames(str(tmp_path)))
    with pytest.raises(RuntimeError, match="cannot open video"):
        load_video_frames(str(tmp_path / "clip.mp4"), 32, device="cpu")


def test_video_builder_options(monkeypatch):
    from sam2_opt_tpu_torch.predictors.variants import (
        SAM2VideoPredictorDAM4SAM,
        SAM2VideoPredictorVOS,
    )

    vos = build_sam2_video_predictor("hiera_t", device="cpu", vos_optimized=True)
    assert isinstance(vos, SAM2VideoPredictorVOS) and vos.model._use_graphs
    monkeypatch.setenv("SAM2_VERSION_TRACK", "dam4sam")
    assert isinstance(build_sam2_video_predictor("hiera_t", device="cpu"),
                      SAM2VideoPredictorDAM4SAM)
    monkeypatch.setenv("SAM2_VERSION_TRACK", "nonsense")
    with pytest.raises(ValueError, match="SAM2_VERSION_TRACK"):
        build_sam2_video_predictor("hiera_t", device="cpu")
