"""Int8 (`sam2_opt_tpu_torch/quant/`, `speedup("int8")`) against the JAX
package's `sam2_opt_tpu/quant/`, on the CPU at the tiny config (hiera_t,
128 px, the JAX `tiny128_params` carried across).

- the quantized weights and scales bitwise equal to JAX's `quantize_params`
  on the same tree, and the same quantized layer names per scope;
- `QuantLinear` against `quantized_linear` with and without an activation
  scale, fp32, within 1e-6 of max |y|, at token-side row counts too (fewer
  than `torch._int_mm`'s CUDA minimum of 17, which the port pads);
- the image predictor on JAX's int8 tree (weight-only, and with activation
  scales), carried across, against JAX's int8 predictor on the same tree:
  masks at mIoU >= 0.99, low-res logits within 1e-2 of their max |logit|
  (measured: weight-only 7.5e-7 of the scale and mIoU 1.0, act-quant
  7.8e-3 and 0.9965);
- mirrors of `tests/test_quant.py`'s image gates on the port alone: the
  one-line `speedup("int8")` at mIoU 0.98 (fp32) and 0.95 (bf16),
  weight-only at 0.98, the empty calibration directory, the quantized
  `_perm_proj`; the fp32 master untouched and `speedup("eager")` bitwise
  the fp32 path again.

The video predictor's int8 is in `tests/test_torch_quant_video.py`, the
calibrated scales against JAX's collectors in
`tests/test_torch_quant_calibration.py`, the int8 product on the card in
`tests/test_torch_int_mm.py`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_opt_tpu.quant import int8 as jq
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
from sam2_opt_tpu_torch.quant import int8 as q8
from sam2_opt_tpu_torch.quant.calibrate import collect_activation_scales

torch.set_num_threads(2)

SCOPES = {"encoder": q8.DEFAULT_QUANT_PATTERN, "tracking": q8.TRACKING_QUANT_PATTERN}
# int8 predictor vs JAX's on the same int8 tree: the act-quant path rounds
# each input to int8, where 1e-7 of difference can move one element by one
# step at a .5 boundary (measured: act-quant 7.8e-3 of the logits' scale,
# weight-only 7.5e-7)
LOGIT_RTOL = 1e-2
POINT = dict(point_coords=np.array([[40.0, 60.0]], np.float32), point_labels=np.array([1]))


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, cfg):
    return build_sam2(cfg=cfg, state_dict=state_dict_from_params(_np_params(params)),
                      device="cpu")


def _jax_quantized(tree, prefix=()):
    """{dotted name: quantized leaf dict} of a JAX tree."""
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, dict) and "w_int8" in v:
            out[".".join(path)] = v
        elif isinstance(v, dict):
            out.update(_jax_quantized(v, path))
    return out


def _image(seed=5):
    return (np.random.default_rng(seed).random((128, 128, 3)) * 255).astype(np.uint8)


def _miou(a_set, b_set):
    ious = []
    for a, b in zip(a_set > 0, b_set > 0):
        u = (a | b).sum()
        ious.append(1.0 if u == 0 else (a & b).sum() / u)
    return float(np.mean(ious))


def _calib_dir(path, n=1, seed=5):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray((rng.random((128, 128, 3)) * 255).astype(np.uint8)).save(
            path / f"calib{i}.jpg")
    return str(path)


@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_quantized_weights_match_jax(tiny128_cfg, tiny128_params, scope):
    """The same layers quantized per scope, and every int8 weight, scale
    and bias bitwise equal to JAX's `quantize_params` (int8 transposed to
    [out, in])."""
    jax_q = _jax_quantized(jq.quantize_params(_np_params(tiny128_params), SCOPES[scope]))
    module = copy.deepcopy(_port_model(tiny128_params, tiny128_cfg).module)
    names = q8.quantize_module(module, SCOPES[scope])
    assert set(names) == set(jax_q) and len(names) == len(jax_q) > 0
    assert len(names) == (51 if scope == "encoder" else 123)
    for name in names:
        layer, ref = module.get_submodule(name), jax_q[name]
        assert q8.is_quantized(layer) and not hasattr(layer, "weight")
        assert layer.w_int8.dtype == torch.int8 and layer.w_scale.dtype == torch.float32
        np.testing.assert_array_equal(layer.w_int8.numpy(), np.asarray(ref["w_int8"]).T)
        np.testing.assert_array_equal(layer.w_scale.numpy(), np.asarray(ref["w_scale"]))
        np.testing.assert_array_equal(layer.bias.numpy(), np.asarray(ref["bias"]))
        assert layer.act_scale is None


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("rows", [(2, 7), (3, 40)])
def test_quant_linear_matches_jax(act, rows):
    """`QuantLinear` against the JAX `quantized_linear` on the same weights,
    fp32, within 1e-6 of max |y|; 14 rows are the token side, padded to
    17 for `torch._int_mm`."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 96)).astype(np.float32)  # JAX layout [in, out]
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((*rows, 64)).astype(np.float32)
    qw, sc = jq.quantize_weight(w)
    p = {"w_int8": jnp.asarray(qw), "w_scale": jnp.asarray(sc), "bias": jnp.asarray(b)}
    sa = float(np.abs(x).max() / 127.0)
    if act:
        p["act_scale"] = jnp.asarray(sa, jnp.float32)
    ref = np.asarray(jq.quantized_linear(p, jnp.asarray(x)))
    layer = q8.QuantLinear(torch.from_numpy(qw.T.copy()), torch.from_numpy(sc),
                           torch.from_numpy(b), torch.tensor(sa) if act else None)
    got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_perm_proj_quantized_matches_permuted_output():
    """The split RoPE layout permutes a projection's output channels: the
    permuted `QuantLinear` (int8 rows, scales and bias alike) gives the
    permuted output of the unpermuted one, as JAX's `_perm_proj`."""
    from sam2_opt_tpu.models.memory_attention import _perm_proj

    rng = np.random.default_rng(9)
    w = rng.standard_normal((32, 64)).astype(np.float32) * 0.1
    b = rng.standard_normal((64,)).astype(np.float32)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    qw, sc = jq.quantize_weight(w)
    p = {"w_int8": jnp.asarray(qw), "w_scale": jnp.asarray(sc), "bias": jnp.asarray(b),
         "act_scale": jnp.float32(0.05)}
    perm = rng.permutation(64)
    layer = q8.QuantLinear(torch.from_numpy(qw.T.copy()), torch.from_numpy(sc),
                           torch.from_numpy(b), torch.tensor(0.05))
    y = layer(torch.from_numpy(x)).numpy()
    y_perm = layer.permuted(torch.from_numpy(perm))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_perm, y[:, perm], rtol=1e-6, atol=1e-6)
    jax_perm = np.asarray(jq.quantized_linear(_perm_proj(p, perm), jnp.asarray(x)))
    np.testing.assert_allclose(y_perm, jax_perm, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def int8_trees(tiny128_cfg, tiny128_params):
    """JAX int8 trees (weight-only, and with activation scales calibrated on
    one image by the port) and JAX's int8 fp32 image predictor's outputs on
    each: masks, IoUs and low-res logits."""
    from sam2_opt_tpu.models.model import SAM2Model as JaxSAM2Model
    from sam2_opt_tpu.predictors.image import SAM2ImagePredictor as JaxPredictor

    params = _np_params(tiny128_params)
    model = _port_model(tiny128_params, tiny128_cfg)
    img = np.asarray(_image(), np.float32)[None] / 255.0
    scales = collect_activation_scales(model.module, tiny128_cfg, [img])
    trees, outs = {}, {}
    for name, act in (("weight-only", None), ("act-quant", scales)):
        trees[name] = _np_params(jq.quantize_params(params, jq.DEFAULT_QUANT_PATTERN, act))
        jm = JaxSAM2Model(params, tiny128_cfg)
        jm.set_runtime_backend("xla", {"dtype": jnp.float32})
        jm._compute_params = jax.tree_util.tree_map(jnp.asarray, trees[name])
        pred = JaxPredictor(jm)
        pred.set_image(_image())
        outs[name] = [np.asarray(a) for a in pred.predict(**POINT, return_logits=True)]
    return trees, outs


@pytest.mark.parametrize("name", ["weight-only", "act-quant"])
def test_int8_predictor_matches_jax(tiny128_cfg, int8_trees, name):
    """JAX's int8 tree carried across (`state_dict_from_params` keeps int8;
    `build_sam2` gives the module its quantized layers) runs the same int8
    function: masks mIoU >= 0.99, logits within 1e-2 of their scale."""
    trees, outs = int8_trees
    model = build_sam2(cfg=tiny128_cfg, state_dict=state_dict_from_params(trees[name]),
                       device="cpu")
    n_quant = sum(q8.is_quantized(m) for m in model.module.modules())
    n_act = sum(q8.is_quantized(m) and m.act_scale is not None for m in model.module.modules())
    assert n_quant == 51 and n_act == (51 if name == "act-quant" else 0)
    pred = SAM2ImagePredictor(model)
    pred.set_image(_image())
    masks, ious, low = pred.predict(**POINT, return_logits=True)
    j_masks, j_ious, j_low = outs[name]
    assert _miou(masks, j_masks) >= 0.99
    assert np.abs(low - j_low).max() <= LOGIT_RTOL * np.abs(j_low).max()
    np.testing.assert_allclose(ious, j_ious, atol=1e-3)


def test_speedup_int8_one_liner(tmp_path, tiny128_cfg, tiny128_params):
    """`speedup("int8", calib_dir=...)` (JAX `test_speedup_int8_one_liner`):
    fp32 int8 at mIoU >= 0.98 of the fp32 masks, bf16 int8 >= 0.95,
    weight-only fp32 >= 0.98 (JAX `test_int8_mask_accuracy_gate`); the
    aliases and `model_root_path`; the fp32 master untouched, and
    speedup("eager") bitwise the fp32 path again."""
    model = _port_model(tiny128_params, tiny128_cfg)
    master = {k: v.clone() for k, v in model.module.state_dict().items()}
    pred = SAM2ImagePredictor(model)
    calib = _calib_dir(tmp_path)
    pred.set_image(_image())
    ref, _, ref_low = pred.predict(**POINT, return_logits=True)

    def run(backend, **kw):
        pred.speedup(backend, **kw)
        pred.set_image(_image())
        return pred.predict(**POINT)[0]

    fp32 = run("int8", calib_dir=calib, dtype=torch.float32)
    qkv = model._compute.image_encoder.trunk.blocks[0].attn.qkv
    assert q8.is_quantized(qkv) and qkv.act_scale is not None, "act-quant not active"
    assert model._compute is not model.module and model.compute_dtype == torch.float32
    assert _miou(ref, fp32) >= 0.98
    assert _miou(ref, run("int8_trt", model_root_path=calib, dtype=torch.float32)) >= 0.98
    weight_only = run("trt_int8", dtype=torch.float32)
    assert model._compute.image_encoder.trunk.blocks[0].attn.qkv.act_scale is None
    assert _miou(ref, weight_only) >= 0.98
    bf16 = run("int8", calib_dir=calib)
    assert model.compute_dtype == torch.bfloat16 and model._use_graphs
    assert _miou(ref, bf16) >= 0.95
    # the master never changed: eager gives the fp32 path's bits back
    assert not any(q8.is_quantized(m) for m in model.module.modules())
    assert all(torch.equal(v, master[k]) for k, v in model.module.state_dict().items())
    pred.speedup("eager")
    pred.set_image(_image())
    again, _, again_low = pred.predict(**POINT, return_logits=True)
    assert np.array_equal(again_low, ref_low) and np.array_equal(again, ref)


def test_speedup_int8_refusals(tmp_path, tiny128_cfg, tiny128_params):
    """An empty calibration directory, a calibration that matches no linear
    and an unknown scope raise; none leaves a quantized model behind."""
    model = _port_model(tiny128_params, tiny128_cfg)
    pred = SAM2ImagePredictor(model)
    (tmp_path / "engine.bin").write_bytes(b"\x00")  # non-image content only
    with pytest.raises(ValueError, match="no calibration images"):
        pred.speedup("int8", model_root_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="produced no scales"):
        model.quantize_int8(calib_dir=_calib_dir(tmp_path), pattern=r"no_such_layer\.weight$")
    with pytest.raises(ValueError, match="unknown quant scope"):
        pred.speedup("int8", quant_scope="decoder")
    assert model._compute is model.module and model.backend == "eager"
