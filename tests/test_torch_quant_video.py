"""Int8 in the video predictor (`speedup("int8")`, both scopes) against the
JAX package's, on the CPU at the tiny config (hiera_t, 128 px, the JAX
`tiny128_params` carried across):

- mirrors of `tests/test_quant.py`'s video tests on the port alone:
  weight-only int8 leaves memory attention in float; the tracking scope,
  calibrated, at IoU >= 0.97 per frame of the fp32 path;
- the tracking scope with network logits on every frame against JAX's
  int8 predictor on the same int8 tree (logits within 2e-2 of their scale,
  masks at IoU >= 0.98 per frame, the drop against fp32 within 0.01 of
  JAX's);
- quantized k/v projections keep K4's route off;
- every int8 seam free of host syncs (`tests/test_torch_executor.py`'s
  dispatch mode), since a CUDA graph could not capture them.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sam2_opt_tpu.quant import int8 as jq
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor
from sam2_opt_tpu_torch.quant import int8 as q8

torch.set_num_threads(2)

# the tracking scope's video against JAX's on the same int8 tree: every
# rounding of the two-way transformer's tokens and of memory attention's
# inputs can flip where the two packages' fp32 inputs differ by an ulp; one
# int8 step is 1/127 (0.8%) of a tensor's absmax, and a tracked frame's
# logits (on random weights, up to ~0.3) move by 1.2e-2 of their scale
TRACK_LOGIT_RTOL = 2e-2
POINT = dict(point_coords=np.array([[40.0, 60.0]], np.float32), point_labels=np.array([1]))


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, cfg):
    return build_sam2(cfg=cfg, state_dict=state_dict_from_params(_np_params(params)),
                      device="cpu")


def _image(seed=5):
    return (np.random.default_rng(seed).random((128, 128, 3)) * 255).astype(np.uint8)


def _calib_dir(path, n=1, seed=5):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.random((128, 128, 3)) * 255).astype(np.uint8)).save(
            path / f"calib{i}.jpg")
    return str(path)


def _video(seed=8, T=3):
    return (np.random.default_rng(seed).random((T, 128, 128, 3)) * 255).astype(np.uint8)


def _track(vp, video):
    state = vp.init_state(video)
    vp.add_new_points_or_box(state, 0, 1, points=np.array([[40.0, 60.0]], np.float32),
                             labels=np.array([1], np.int32))
    return {f: np.asarray(m) for f, _, m in vp.propagate_in_video(state)}


def test_video_speedup_int8_scopes(tmp_path, tiny128_cfg, tiny128_params):
    """The video predictor, as JAX's `test_video_predictor_speedup_int8` and
    `..._tracking_scope` run it (the same weights, so tracked frames score
    the object absent on both sides; `test_int8_tracking_matches_jax` holds
    network logits): weight-only int8 leaves memory attention in float; the
    tracking scope, calibrated, reaches memory attention's q and k
    projections (run on split weights, recorded at their call sites), its
    FFN and the two-way transformer, and every frame stays at IoU >= 0.97
    of the fp32 path."""
    video = _video()
    vp = SAM2VideoPredictor(_port_model(tiny128_params, tiny128_cfg), fill_hole_area=0)
    model = vp.model
    ref = _track(vp, video)
    vp.speedup("int8")
    m = model._compute
    assert q8.is_quantized(m.image_encoder.trunk.blocks[0].attn.qkv)
    assert not q8.is_quantized(m.memory_attention.layers[0].self_attn.q_proj)
    assert all(np.isfinite(v).all() for v in _track(vp, video).values())

    vp.speedup("int8", calib_dir=_calib_dir(tmp_path, n=2, seed=8), dtype=torch.float32,
               quant_scope="tracking")
    layer = model._compute.memory_attention.layers[0]
    for proj in (layer.self_attn.q_proj, layer.cross_attn_image.k_proj, layer.linear1,
                 model._compute.sam_mask_decoder.transformer.layers[0].self_attn.q_proj):
        assert q8.is_quantized(proj) and proj.act_scale is not None
    assert sum(q8.is_quantized(x) and x.act_scale is not None
               for x in model._compute.modules()) == 123
    assert not q8.is_quantized(model.module.memory_attention.layers[0].self_attn.q_proj)
    got = _track(vp, video)
    assert set(got) == set(ref) == {0, 1, 2}
    for f in ref:
        a, b = ref[f][0, 0] > 0, got[f][0, 0] > 0
        u = (a | b).sum()
        assert (1.0 if u == 0 else (a & b).sum() / u) >= 0.97, f


def test_int8_tracking_matches_jax(tmp_path, tiny128_cfg, tiny128_params):
    """The tracking scope with network logits on every frame (the
    object-score bias raised by 10 on both sides): JAX's int8 tree (the
    tracking pattern, activation scales from the port's calibration on two
    images) carried across, tracked over 3 frames by both predictors in
    fp32: logits within TRACK_LOGIT_RTOL of their max |logit| and masks at
    IoU >= 0.98 per frame (measured: 1.2e-2 of the scale, IoU >= 0.9908;
    the same tree weight-only: 2.4e-7 absolute). Against fp32 both packages
    drop alike on these random weights (frame 1 at IoU 0.908 in each, held
    within 0.01 of each other), which JAX's own gate, on frames scored
    absent, does not see."""
    from sam2_opt_tpu.models.model import SAM2Model as JaxSAM2Model
    from sam2_opt_tpu.predictors.video import SAM2VideoPredictor as JaxVideoPredictor
    from sam2_opt_tpu_torch.quant.calibrate import (
        ImageEncodeCalibratorDataset,
        collect_tracking_activation_scales,
    )

    params = copy.deepcopy(_np_params(tiny128_params))
    head = params["sam_mask_decoder"]["pred_obj_score_head"]["layers"][2]
    head["bias"] = head["bias"] + 10.0
    port = _port_model(params, tiny128_cfg)
    ds = ImageEncodeCalibratorDataset(_calib_dir(tmp_path, n=2, seed=8), image_size=128)
    scales = collect_tracking_activation_scales(port.module, tiny128_cfg, ds.batches(),
                                                q8.TRACKING_QUANT_PATTERN)
    tree = _np_params(jq.quantize_params(params, jq.TRACKING_QUANT_PATTERN, scales))
    jm = JaxSAM2Model(params, tiny128_cfg)
    jm.set_runtime_backend("xla", {"dtype": jnp.float32})
    jm._compute_params = jax.tree_util.tree_map(jnp.asarray, tree)
    video = _video()
    ref = {f: np.asarray(m) for f, m in _track(JaxVideoPredictor(jm, fill_hole_area=0),
                                                video).items()}
    got = _track(SAM2VideoPredictor(build_sam2(cfg=tiny128_cfg,
                                               state_dict=state_dict_from_params(tree),
                                               device="cpu"), fill_hole_area=0), video)
    fp32 = _track(SAM2VideoPredictor(port, fill_hole_area=0), video)
    assert set(got) == set(ref) == set(fp32) == {0, 1, 2}

    def iou(a, b):
        a, b = a[0, 0] > 0, b[0, 0] > 0
        return (a & b).sum() / (a | b).sum()

    # both packages' int8 drop alike against fp32 (the cause: chip_smoke.py,
    # INT8_TRACKED_IOU_MIN's comment)
    for f in ref:
        assert abs(iou(fp32[f], got[f]) - iou(fp32[f], ref[f])) <= 0.01, f
    for f in ref:
        assert np.abs(got[f] - ref[f]).max() <= TRACK_LOGIT_RTOL * np.abs(ref[f]).max(), f
        a, b = ref[f][0, 0] > 0, got[f][0, 0] > 0
        assert a.any() and (a & b).sum() / (a | b).sum() >= 0.98, f


def test_quantized_kv_projections_skip_k4(tmp_path, tiny128_cfg, tiny128_params, monkeypatch):
    """Under `SAM2_TPU_FUSED_KV_PROJ=1` (with `SAM2_TPU_FLASH=1`, the kernel
    routes' plain versions on CPU tensors) single-head cross-attention goes
    to K4 while its k/v projections hold raw weights, and to K2's route once
    they are int8 (JAX memory_attention.py:183-186)."""
    import sam2_opt_tpu_torch.models.memory_attention as ma

    calls = {"kv_proj": 0, "rope": 0}
    kv_ref, rope_ref = ma.flash_attention_kv_proj_ref, ma.flash_attention_rope_ref
    monkeypatch.setattr(ma, "flash_attention_kv_proj_ref",
                        lambda *a: calls.__setitem__("kv_proj", calls["kv_proj"] + 1) or kv_ref(*a))
    monkeypatch.setattr(ma, "flash_attention_rope_ref",
                        lambda *a: calls.__setitem__("rope", calls["rope"] + 1) or rope_ref(*a))
    monkeypatch.setenv("SAM2_TPU_FUSED_KV_PROJ", "1")
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    vp = SAM2VideoPredictor(_port_model(tiny128_params, tiny128_cfg), fill_hole_area=0)
    video = _video(T=2)
    _track(vp, video)
    assert calls["kv_proj"] == calls["rope"] == 4  # one tracked frame, 4 layers
    vp.speedup("int8", dtype=torch.float32, quant_scope="tracking")
    _track(vp, video)
    assert calls["kv_proj"] == 4 and calls["rope"] == 12


class _HostSyncs(TorchDispatchMode):
    """The ops that read a tensor on the host or copy host data into one
    (`tests/test_torch_executor.py`): each would fail inside a capture."""

    FORBIDDEN = {"_local_scalar_dense", "lift_fresh", "lift_fresh_copy", "nonzero",
                 "is_nonzero", "masked_select", "item", "_unique2", "unique_dim",
                 "unique_consecutive", "equal"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.FORBIDDEN:
            self.seen.append(func.__name__)
        return func(*args, **(kwargs or {}))


def test_int8_seams_have_no_host_sync(tmp_path, tiny128_cfg, tiny128_params):
    """Every seam `speedup("int8")` captures on the card (the encoder, the
    prompt decoder, the tracking steps, the memory encoder), here in the
    tracking scope with activation scales, runs on the CPU through
    `SAM2Model.run` without a host read or a host copy: the int8 products'
    padding, the scales and the rounding stay on the device."""
    model = _port_model(tiny128_params, tiny128_cfg)
    model.speedup("int8", calib_dir=_calib_dir(tmp_path), quant_scope="tracking")

    def script():
        pred = SAM2ImagePredictor(model)
        pred.set_image(_image())
        pred.predict(**POINT)
        _track(SAM2VideoPredictor(model, fill_hole_area=0), _video(T=2))

    script()  # per-device constants are built on a seam's first call
    seams, run = [], model.run

    def spy(name, fn, args):
        def checked(*a):
            with _HostSyncs() as mode:
                out = fn(*a)
            seams.append((name, mode.seen))
            return out
        return run(name, checked, args)

    model.run = spy
    try:
        script()
    finally:
        del model.run
    names = {name[0] if isinstance(name, tuple) else name for name, _ in seams}
    assert {"encode_image_e2e", "predict_masks", "track_init", "track_cond"} <= names, names
    assert all(not seen for _, seen in seams), [s for s in seams if s[1]]
