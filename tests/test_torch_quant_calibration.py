"""Int8 calibration (`sam2_opt_tpu_torch/quant/calibrate.py`) against the
JAX package's `sam2_opt_tpu/quant/calibrate.py`, on the CPU at the tiny
config: two calibration images written in `tmp_path`, the same weights
(the JAX `tiny128_params` carried across).

- the dataset: the same files give the same arrays;
- the scales of both collectors (encoder and tracking) within 1e-4
  relative of JAX's, over the same set of layers (measured: 6.1e-7 and
  1.1e-5); the tracking collector
  reaches memory attention's q and k projections, which run on split
  weights (their call sites run the projections' pre-hooks).

JAX's collectors run the model eagerly, op by op (66 s from a cold start on
this suite's CPU), so the JAX side here runs the same steps as one jitted
function per image: JAX's `_LinearCapture` names the layers, sets its
switches and turns the records into scales, and only its per-call host
read becomes an output of the jitted function. The tracking steps are
those of JAX's `collect_tracking_activation_scales`: encode, an init step
with a centre click and the memory encoded, one conditioned step against
a full-capacity bank of that frame's memory and pointer. The encoder
collector's records are the first of those steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_opt_tpu.quant import calibrate as jcal
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.quant import calibrate as cal
from sam2_opt_tpu_torch.quant import int8 as q8

torch.set_num_threads(2)

SCALE_RTOL = 1e-4


@pytest.fixture(scope="module")
def calib_dir(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(8)
    for i in range(2):
        Image.fromarray((rng.random((160, 144, 3)) * 255).astype(np.uint8)).save(
            path / f"calib{i}.jpg")
    (path / "notes.txt").write_text("not an image")
    return str(path)


def _jax_scales(params, cfg, batches):
    """JAX's tracking capture over `batches`: {weight name: scale} and the
    names recorded by its encoder step alone."""
    from sam2_opt_tpu.models import sam2_base as base
    from sam2_opt_tpu.models import video_core as vc
    from sam2_opt_tpu.ops import common as ops

    with jcal._LinearCapture(params, q8.TRACKING_QUANT_PATTERN) as cap:
        trace = []

        def record(p, x):
            w = p.get("weight")
            if w is not None and not isinstance(w, dict) and np.ndim(w) == 2:
                name = cap._id_to_name.get(id(w))
                if name is not None and cap.rx.search(name):
                    trace.append((name, jnp.max(jnp.abs(x))))
            return cap._orig_linear(p, x)

        ops.linear = record  # in place of the capture's host-reading shim

        def steps(img):
            """The body of JAX's collect_tracking_activation_scales."""
            trace.clear()
            B, S_img = img.shape[0], cfg.image_size
            f0, f1, f2 = base.forward_image(params, cfg, base.image_normalize(img))[
                "backbone_fpn"]
            n_encoder = len(trace)
            init = vc.track_step_init(
                params, cfg, (f0, f1, f2), jnp.full((B, 1, 2), S_img / 2.0, jnp.float32),
                jnp.ones((B, 1), jnp.int32), None, multimask_output=True,
                run_mem_encoder=True)
            S, P = cfg.num_maskmem, cfg.max_obj_ptrs_in_encoder
            mm = init["maskmem_features"].astype(f2.dtype)
            mem = vc.MemoryInput(
                feats=tuple(mm for _ in range(S)),
                tpos_idx=jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S)),
                valid=jnp.ones((B, S), bool),
                ptrs=tuple(init["obj_ptr"] for _ in range(P)),
                ptr_pos=jnp.broadcast_to(
                    (jnp.arange(P, dtype=jnp.float32) / max(P - 1, 1))[None], (B, P)),
                ptr_valid=jnp.ones((B, P), bool))
            vc.track_step_conditioned(params, cfg, (f0, f1, f2), mem, multimask_output=True,
                                      run_mem_encoder=True)
            names.extend(n for n, _ in trace[len(names):])  # set at trace time
            encoder_names.extend(n for n, _ in trace[len(encoder_names):n_encoder])
            return [v for _, v in trace]

        names, encoder_names = [], []
        run = jax.jit(steps)
        for batch in batches:
            for name, v in zip(names, run(jnp.asarray(batch))):
                cap.records.setdefault(name, []).append(float(v))
    return cap.scales(99.99), set(encoder_names)


@pytest.fixture(scope="module")
def scales(tiny128_cfg, tiny128_params, calib_dir):
    """(port encoder, port tracking, JAX tracking, JAX encoder names)."""
    params = jax.tree_util.tree_map(np.asarray, tiny128_params)
    module = build_sam2(cfg=tiny128_cfg, state_dict=state_dict_from_params(params),
                        device="cpu").module
    ds = cal.ImageEncodeCalibratorDataset(calib_dir, image_size=128)
    encoder = cal.collect_activation_scales(module, tiny128_cfg, ds.batches())
    tracking = cal.collect_tracking_activation_scales(module, tiny128_cfg, ds.batches(),
                                                      q8.TRACKING_QUANT_PATTERN)
    jds = jcal.ImageEncodeCalibratorDataset(calib_dir, image_size=128)
    jax_tracking, jax_encoder_names = _jax_scales(
        jax.tree_util.tree_map(jnp.asarray, params), tiny128_cfg, jds.batches())
    return encoder, tracking, jax_tracking, jax_encoder_names


def test_dataset_matches_jax(calib_dir):
    """The same files (PNG/JPEG only, sorted, capped) give the same arrays;
    a directory without images raises the same error."""
    ds = cal.ImageEncodeCalibratorDataset(calib_dir, image_size=128, max_images=5)
    ref = jcal.ImageEncodeCalibratorDataset(calib_dir, image_size=128, max_images=5)
    assert [p.rsplit("/", 1)[1] for p in ds.paths] == ["calib0.jpg", "calib1.jpg"]
    assert ds.paths == ref.paths and len(ds) == len(ref) == 2
    for a, b in zip(ds.batches(), ref.batches()):
        assert a.shape == (1, 128, 128, 3) and np.array_equal(a, b)
    assert len(cal.ImageEncodeCalibratorDataset(calib_dir, max_images=1)) == 1


@pytest.mark.parametrize("collector", ["encoder", "tracking"])
def test_scales_match_jax(scales, collector):
    """Each collector's {weight name: scale} within 1e-4 relative of
    JAX's, on the same layers: the trunk's 51 linears for the encoder, 123
    with memory attention (q/k/v/out, FFN) and the two-way transformer for
    the tracking scope."""
    encoder, tracking, jax_tracking, jax_encoder_names = scales
    got = encoder if collector == "encoder" else tracking
    ref = ({k: v for k, v in jax_tracking.items() if k in jax_encoder_names}
           if collector == "encoder" else jax_tracking)
    assert set(got) == set(ref) and len(got) == (51 if collector == "encoder" else 123)
    for name, v in got.items():
        assert abs(v - ref[name]) <= SCALE_RTOL * ref[name], (name, v, ref[name])
    if collector == "tracking":
        for proj in ("self_attn.q_proj", "self_attn.k_proj", "cross_attn_image.q_proj",
                     "cross_attn_image.k_proj", "cross_attn_image.v_proj"):
            assert f"memory_attention.layers.0.{proj}.weight" in got
