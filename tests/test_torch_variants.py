"""The predictor variants (`sam2_opt_tpu_torch/predictors/variants.py`:
VOS, Legacy, DAM4SAM, and `select_video_predictor_cls`) against the JAX
package's `sam2_opt_tpu/predictors/variants.py`, on the CPU at the tiny
config (hiera_t, 128 px).

- the five tests of `tests/test_dam4sam.py`, on the port: RAM selection
  past occluded frames, the all-occluded fallback, the SAM2_VERSION_TRACK
  switch (and `build_sam2_video_predictor`'s choice, `vos_optimized`
  included), DAM4SAM end to end, the Legacy contract;
- DAM4SAM's `_gather_memory` on the same fake output dicts as JAX's, in
  several memory states: the same frames selected, in the same slots, and
  equal `tpos_idx`, `valid`, pointers and `ptr_pos`;
- a 5-frame DAM4SAM run (a click, propagation with `return_all_masks`, a
  frame promoted with `add_to_drm`, propagation again) against JAX's on the
  same weights, the object-score bias raised by 10 on both sides so tracked
  frames carry network logits: every video-res mask, multimask slot and
  stored low-res logit map within 1e-4 (measured: below 1e-6), the IoUs
  within 1e-4, `n_pixels_pos` equal.
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_opt_tpu.models.model import SAM2Model as JaxSAM2Model
from sam2_opt_tpu.predictors import variants as jv
from sam2_opt_tpu_torch import build_sam2_video_predictor
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors import variants as pv
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

torch.set_num_threads(2)

ATOL = 1e-4


@pytest.fixture(scope="module")
def model(tiny128_cfg):
    return build_sam2(cfg=tiny128_cfg, seed=0, device="cpu")


@pytest.fixture()
def dam_predictor(model):
    model.set_runtime_backend("eager")
    return pv.SAM2VideoPredictorDAM4SAM(model, fill_hole_area=0)


def _fake_out(frame_value, g, visible=True, nchw=True):
    shape = (1, 64, g, g) if nchw else (1, g, g, 64)
    lib = torch if nchw else jnp
    return {
        "maskmem_features": lib.full(shape, float(frame_value), dtype=lib.bfloat16),
        "pred_masks": lib.zeros((1, 1, 32, 32), dtype=lib.float32),
        "obj_ptr": lib.full((1, 256), float(frame_value), dtype=lib.float32),
        "object_score_logits": lib.full((1, 1), 10.0, dtype=lib.float32),
        "n_pixels_pos": 100 if visible else 0,
    }


def test_ram_selection_skips_invisible_frames(dam_predictor):
    """RAM picks the most recent visible frames, walking back past occluded
    ones (reference sam2_base_dam4sam.py:640-680); DRM (cond) frames take
    tpos slot 0."""
    p = dam_predictor
    g = p.cfg.image_embedding_size
    # frames 0..8 tracked; frames 7 and 8 occluded (target invisible)
    output_dict = {
        "cond_frame_outputs": {0: _fake_out(0, g)},
        "non_cond_frame_outputs": {t: _fake_out(t, g, visible=t not in (7, 8))
                                   for t in range(1, 9)},
    }
    mem = p._gather_memory({"num_frames": 20}, output_dict, frame_idx=9, reverse=False)
    vals = [float(f[0, 0, 0, 0]) for f in mem.feats]
    picked = sorted(v for v, ok in zip(vals, mem.valid[0]) if ok)
    # cond frame 0 + the 6 most recent visible frames (1..6); never 7 or 8
    assert picked == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0], picked
    # object pointers also skip invisible frames
    picked_ptrs = sorted(float(x[0, 0]) for x, ok in zip(mem.ptrs, mem.ptr_valid[0]) if ok)
    assert 7.0 not in picked_ptrs and 8.0 not in picked_ptrs
    assert 6.0 in picked_ptrs and 0.0 in picked_ptrs


def test_ram_all_occluded_falls_back_to_cond_only(dam_predictor):
    p = dam_predictor
    g = p.cfg.image_embedding_size
    output_dict = {
        "cond_frame_outputs": {0: _fake_out(0, g)},
        "non_cond_frame_outputs": {t: _fake_out(t, g, visible=False) for t in range(1, 5)},
    }
    mem = p._gather_memory({"num_frames": 10}, output_dict, frame_idx=5, reverse=False)
    assert mem.valid[0].sum() == 1  # only the DRM / cond frame remains


def test_env_track_switch(monkeypatch):
    """SAM2_VERSION_TRACK selects the class as in JAX; build_sam2_video_predictor
    builds it, and `vos_optimized` the VOS variant on CUDA graphs."""
    for track, cls, jax_cls in (("dam4sam", pv.SAM2VideoPredictorDAM4SAM,
                                 jv.SAM2VideoPredictorDAM4SAM),
                                ("legacy", pv.SAM2VideoPredictorLegacy,
                                 jv.SAM2VideoPredictorLegacy),
                                ("official", SAM2VideoPredictor, jv.SAM2VideoPredictor),
                                ("", SAM2VideoPredictor, jv.SAM2VideoPredictor)):
        monkeypatch.setenv("SAM2_VERSION_TRACK", track)
        assert pv.select_video_predictor_cls() is cls
        assert jv.select_video_predictor_cls() is jax_cls
        if track:
            built = build_sam2_video_predictor("hiera_t", device="cpu")
            assert type(built) is cls and built.fill_hole_area == 8
    monkeypatch.setenv("SAM2_VERSION_TRACK", "nonsense")
    with pytest.raises(ValueError, match="unknown SAM2_VERSION_TRACK"):
        pv.select_video_predictor_cls()
    vos = build_sam2_video_predictor("hiera_t", device="cpu", vos_optimized=True)
    assert type(vos) is pv.SAM2VideoPredictorVOS
    assert vos.model.backend == "cuda" and vos.model._use_graphs
    assert vos.model.compute_dtype == torch.bfloat16
    monkeypatch.delenv("SAM2_VERSION_TRACK")
    assert type(build_sam2_video_predictor("hiera_t", device="cpu")) is SAM2VideoPredictor


def test_dam4sam_end_to_end(dam_predictor):
    """Clicks, propagation with the multimask extras, `add_to_drm`: the
    promoted frame becomes a conditioning (DRM) frame; reset clears the
    promotion bookkeeping."""
    p = dam_predictor
    rng = np.random.default_rng(9)
    video = (rng.random((5, 128, 128, 3)) * 255).astype(np.uint8)
    state = p.init_state(video)
    p.add_new_points_or_box(state, frame_idx=0, obj_id=1,
                            points=np.array([[60.0, 60.0]], np.float32),
                            labels=np.array([1], np.int32))
    outs = list(p.propagate_in_video(state, return_all_masks=True))
    assert len(outs) == 5
    frame_idx, obj_ids, masks, (all_masks, all_ious) = outs[2]
    assert obj_ids == [1] and masks.shape[-2:] == (128, 128)
    assert len(all_masks) == 3 and all_ious.shape == (3,)
    assert all(m.shape[-2:] == (128, 128) for m in all_masks)
    obj_out = state["output_dict_per_obj"][0]
    assert all("n_pixels_pos" in o for o in obj_out["non_cond_frame_outputs"].values())

    # promote frame 2 into DRM; preflight moves it to the cond outputs
    f, ids, m = p.add_to_drm(state, 2, 1)
    assert f == 2 and state["adds_in_drm_per_obj"][0] == [2]
    p.propagate_in_video_preflight(state)
    assert 2 in obj_out["cond_frame_outputs"]
    assert 2 not in obj_out["non_cond_frame_outputs"]
    # a later frame's memory now treats frame 2 as DRM (cond)
    mem = p._gather_memory(state, obj_out, frame_idx=4, reverse=False)
    assert mem.valid[0].sum() >= 2
    p.reset_state(state)
    assert state["adds_in_drm_per_obj"] == {}


def test_legacy_track_contract(model):
    """No new objects after tracking starts, a box after the start warns,
    reset clears the flag (reference sam2_video_predictor_legacy.py:107,
    138-162, 216-224, 848-877)."""
    model.set_runtime_backend("eager")
    p = pv.SAM2VideoPredictorLegacy(model, fill_hole_area=0)
    video = (np.random.default_rng(10).random((3, 128, 128, 3)) * 255).astype(np.uint8)
    state = p.init_state(video)
    assert state["tracking_has_started"] is False
    with pytest.raises(RuntimeError, match="No points are provided"):
        p.propagate_in_video(state)
    p.reset_state(state)  # the failed call had locked the objects, as in JAX
    assert state["tracking_has_started"] is False
    p.add_new_points_or_box(state, 0, 1, points=np.array([[60.0, 60.0]], np.float32),
                            labels=np.array([1], np.int32))
    list(p.propagate_in_video(state))
    assert state["tracking_has_started"] is True
    with pytest.raises(RuntimeError, match="Cannot add new object id 2 after tracking starts"):
        p.add_new_points_or_box(state, 1, 2, points=np.array([[30.0, 30.0]], np.float32),
                                labels=np.array([1], np.int32))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        p.add_new_points_or_box(state, 1, 1, box=np.array([20, 20, 90, 90]))
    assert any("after tracking starts" in str(x.message) for x in w)
    p.reset_state(state)
    assert state["tracking_has_started"] is False


def _memory_states():
    """(name, cond frames, {frame: visible}, frame_idx, reverse, num_frames)."""
    vis = lambda hidden, n: {t: t not in hidden for t in range(n)}  # noqa: E731
    return [
        ("occluded tail", [0], vis({7, 8}, 9), 9, False, 20),
        ("occluded gaps", [0], vis({3, 5, 6, 9}, 12), 12, False, 30),
        ("two DRM frames", [0, 4], vis({6}, 10), 10, False, 10),
        ("three DRM frames, stride walk", [0, 3, 11], vis({10, 12}, 14), 14, False, 40),
        ("all occluded", [0], vis(set(range(1, 6)), 6), 6, False, 10),
        ("reverse", [9], vis({5}, 10), 2, True, 10),
        ("frame 0 in RAM", [5], vis(set(), 5), 2, False, 8),
    ]


@pytest.mark.parametrize("case", _memory_states(), ids=lambda c: c[0])
def test_gather_memory_matches_jax(model, tiny128_cfg, tiny128_params, case):
    """DAM4SAM's memory selection on the same fake outputs as the JAX
    package's: the same frames in the same slots, equal tpos indices,
    validity, pointer values and pointer positions."""
    name, cond, visible, frame_idx, reverse, num_frames = case
    g = tiny128_cfg.image_embedding_size
    p = pv.SAM2VideoPredictorDAM4SAM(model, fill_hole_area=0)
    jp = jv.SAM2VideoPredictorDAM4SAM(JaxSAM2Model(tiny128_params, tiny128_cfg),
                                      fill_hole_area=0)

    def outputs(nchw):
        return {"cond_frame_outputs": {t: _fake_out(t, g, nchw=nchw) for t in cond},
                "non_cond_frame_outputs": {t: _fake_out(t, g, v, nchw=nchw)
                                           for t, v in visible.items() if t not in cond}}

    mem = p._gather_memory({"num_frames": num_frames}, outputs(True), frame_idx, reverse)
    ref = jp._gather_memory({"num_frames": num_frames}, outputs(False), frame_idx, reverse)
    assert len(mem.feats) == len(ref.feats) and len(mem.ptrs) == len(ref.ptrs)
    np.testing.assert_array_equal(mem.valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(mem.tpos_idx, np.asarray(ref.tpos_idx))
    np.testing.assert_array_equal(mem.ptr_valid, np.asarray(ref.ptr_valid))
    np.testing.assert_array_equal(mem.ptr_pos, np.asarray(ref.ptr_pos))
    frames = [float(f[0, 0, 0, 0]) for f in mem.feats]
    assert frames == [float(np.asarray(f, np.float32)[0, 0, 0, 0]) for f in ref.feats]
    assert [float(x[0, 0]) for x in mem.ptrs] == [float(np.asarray(x)[0, 0]) for x in ref.ptrs]
    assert mem.valid[0].sum() >= 1


def _video(T=5, S=128):
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


def _dam_script(p):
    """A click on frame 0, propagation with all masks, frame 2 promoted to
    the DRM, propagation again from frame 3. Returns every yielded array
    (video-res masks, multimask slots, IoUs) and every stored output's
    (pred_masks, all_pred_masks, n_pixels_pos), in order."""
    state = p.init_state(_video())
    outs = [p.add_new_points_or_box(state, 0, 1, points=np.array([[36.0, 56.0]], np.float32),
                                    labels=np.array([1], np.int32))[2]]

    def run(**kw):
        for _, _, masks, (all_masks, ious) in p.propagate_in_video(
                state, return_all_masks=True, **kw):
            outs.extend([masks, *all_masks, ious])

    run()
    outs.append(p.add_to_drm(state, 2, 1)[2])
    run(start_frame_idx=3)
    obj = state["output_dict_per_obj"][0]
    stored = [(o["pred_masks"], o["all_pred_masks"], o["n_pixels_pos"])
              for frames in (obj["cond_frame_outputs"], obj["non_cond_frame_outputs"])
              for _, o in sorted(frames.items()) if o.get("all_pred_masks") is not None]
    return [np.asarray(x) for x in outs], stored


@pytest.fixture(scope="module")
def raised_params(tiny128_params):
    params = copy.deepcopy(jax.tree_util.tree_map(np.asarray, tiny128_params))
    head = params["sam_mask_decoder"]["pred_obj_score_head"]["layers"][2]
    head["bias"] = head["bias"] + 10.0
    return params


@pytest.fixture(scope="module")
def jax_dam_run(tiny128_cfg, raised_params):
    return _dam_script(jv.SAM2VideoPredictorDAM4SAM(JaxSAM2Model(raised_params, tiny128_cfg),
                                                    fill_hole_area=0))


def test_dam4sam_run_matches_jax(tiny128_cfg, raised_params, jax_dam_run):
    p = pv.SAM2VideoPredictorDAM4SAM(
        build_sam2(cfg=tiny128_cfg, state_dict=state_dict_from_params(raised_params),
                   device="cpu"), fill_hole_area=0)
    outs, stored = _dam_script(p)
    jax_outs, jax_stored = jax_dam_run
    # a click frame, 5 + 2 propagated frames of (mask, 3 slots, IoUs), add_to_drm
    assert len(outs) == len(jax_outs) == 1 + 7 * 5 + 1
    for a, b in zip(outs, jax_outs):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    assert len(stored) == len(jax_stored) == 5
    for (masks, all_masks, n_pos), (j_masks, j_all, j_n_pos) in zip(stored, jax_stored):
        np.testing.assert_allclose(masks.numpy(), np.asarray(j_masks), rtol=0, atol=ATOL)
        np.testing.assert_allclose(all_masks.numpy(), np.asarray(j_all), rtol=0, atol=ATOL)
        assert all_masks.shape[1] == 3 and n_pos == j_n_pos
    # tracked frames carry network logits and a visible target
    assert all(n_pos > 0 for _, _, n_pos in stored)
    assert np.ptp(np.stack([m.numpy() for m, _, _ in stored])) > 0.05
