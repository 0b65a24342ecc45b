"""Modules of the PyTorch port against the JAX package, at fp32 on the CPU.

Both packages run the same weights (the JAX `tiny128_params`, carried into
the port by the weight bridge) on the same numpy inputs. The JAX side runs
under `jax.jit` with `highest` matmul precision (tests/conftest.py).
Tolerances: 1e-4 (rtol and atol) for features after the 12-block trunk,
where the two frameworks sum in different orders; 1e-5 for single ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_opt_tpu.models import hiera as jax_hiera
from sam2_opt_tpu.models import mask_decoder as jax_md
from sam2_opt_tpu.models import prompt_encoder as jax_pe
from sam2_opt_tpu.models import sam2_base as jax_base
from sam2_opt_tpu.ops import common as jax_ops
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models import hiera
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.ops import common as ops
from sam2_opt_tpu_torch.config import model_config

torch.set_num_threads(2)

FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-5, atol=1e-5)


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


@pytest.fixture(scope="module")
def port(tiny128_params):
    module = base.SAM2Base(model_config("hiera_t", image_size=128))
    module.load_state_dict(
        state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params)), strict=True)
    return module.eval()


@pytest.mark.parametrize("size", [(32, 32), (32, 48), (16, 24)])
def test_hiera_pos_embed_matches_jax_cubic(tiny128_cfg, tiny128_params, port, size):
    """jax.image.resize(method="cubic") semantics, not torch's bicubic: the
    7x7 -> 32x32 case is the one hiera_t takes at 128 px."""
    trunk = tiny128_params["image_encoder"]["trunk"]
    ref = jax_hiera.hiera_pos_embed(trunk, *size, tiny128_cfg.trunk)
    t = port.image_encoder.trunk
    with torch.no_grad():
        out = hiera.hiera_pos_embed(t.pos_embed, t.pos_embed_window, *size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **OP_TOL)


def test_forward_image_matches_jax(tiny128_cfg, tiny128_params, port):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jax_base.forward_image(p, tiny128_cfg, x))(tiny128_params, img)
    with torch.no_grad():
        out = base.forward_image(port, torch.from_numpy(nchw(img)))
    for a, b in zip(out["backbone_fpn"], ref["backbone_fpn"]):
        np.testing.assert_allclose(a.detach().numpy(), nchw(b), **FEAT_TOL)
    for a, b in zip(out["vision_pos_enc"], ref["vision_pos_enc"]):
        np.testing.assert_allclose(a.detach().numpy(), nchw(b), **OP_TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_prompt_encoder_matches_jax(tiny128_cfg, tiny128_params, port, with_mask):
    rng = np.random.default_rng(2)
    coords = (rng.random((2, 3, 2)) * 128).astype(np.float32)
    labels = np.array([[1, 0, -1], [2, 3, 1]], np.int32)
    s = 4 * tiny128_cfg.image_embedding_size
    mask = rng.standard_normal((2, s, s, 1)).astype(np.float32) if with_mask else None
    ref_sparse, ref_dense = jax.jit(
        lambda p, c, l, m: jax_pe.prompt_encoder(p, tiny128_cfg, c, l, m)
    )(tiny128_params["sam_prompt_encoder"], coords, labels, mask)
    with torch.no_grad():
        sparse, dense = port.sam_prompt_encoder(
            torch.from_numpy(coords), torch.from_numpy(labels),
            None if mask is None else torch.from_numpy(nchw(mask)))
    np.testing.assert_allclose(sparse.detach().numpy(), np.asarray(ref_sparse), **OP_TOL)
    np.testing.assert_allclose(dense.detach().numpy(), nchw(ref_dense), **OP_TOL)
    e = tiny128_cfg.image_embedding_size
    ref_pe = jax_pe.get_dense_pe(tiny128_params["sam_prompt_encoder"], (e, e))
    np.testing.assert_allclose(port.sam_prompt_encoder.get_dense_pe((e, e)).detach().numpy(),
                               nchw(ref_pe), **OP_TOL)


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_matches_jax(tiny128_cfg, tiny128_params, port, multimask):
    """Includes the stability-based dynamic multimask (multimask=False)."""
    cfg = tiny128_cfg
    rng = np.random.default_rng(3)
    e, C = cfg.image_embedding_size, cfg.hidden_dim
    embed = rng.standard_normal((2, e, e, C)).astype(np.float32)
    pe = rng.standard_normal((1, e, e, C)).astype(np.float32)
    sparse = rng.standard_normal((2, 3, C)).astype(np.float32)
    dense = rng.standard_normal((2, e, e, C)).astype(np.float32)
    hrf0 = rng.standard_normal((2, 4 * e, 4 * e, C // 8)).astype(np.float32)
    hrf1 = rng.standard_normal((2, 2 * e, 2 * e, C // 4)).astype(np.float32)
    ref = jax.jit(lambda p, *a: jax_md.mask_decoder(
        p, cfg, a[0], a[1], a[2], a[3], multimask_output=multimask,
        high_res_features=(a[4], a[5])))(tiny128_params["sam_mask_decoder"],
                                         embed, pe, sparse, dense, hrf0, hrf1)
    t = lambda x: torch.from_numpy(nchw(x))  # noqa: E731
    with torch.no_grad():
        out = port.sam_mask_decoder(t(embed), t(pe), torch.from_numpy(sparse), t(dense),
                                    multimask_output=multimask, high_res_features=(t(hrf0), t(hrf1)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FEAT_TOL)


def test_resize_ops_match_jax():
    """Bilinear antialiased downscale (the predictor's resize to the model
    resolution), bilinear upscale (mask postprocessing) and torch-legacy
    nearest."""
    rng = np.random.default_rng(4)
    x = rng.random((1, 300, 200, 3)).astype(np.float32)
    ref = jax.image.resize(x, (1, 128, 128, 3), method="linear", antialias=True)
    out = ops.interpolate(torch.from_numpy(nchw(x)), (128, 128), "bilinear", antialias=True)
    np.testing.assert_allclose(out.detach().numpy(), nchw(ref), **OP_TOL)
    m = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    ref = jax_base.resize_hw(jnp.asarray(m), (150, 200), "bilinear")
    out = base.resize_hw(torch.from_numpy(m), (150, 200), "bilinear")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **OP_TOL)
    ref = jax_ops.interpolate(jnp.asarray(x), (70, 45), method="nearest")
    out = ops.interpolate(torch.from_numpy(nchw(x)), (70, 45), "nearest")
    np.testing.assert_array_equal(out.detach().numpy(), nchw(ref))


def test_bf16_layer_norm_matches_jax_bf16():
    """The bf16 path's LayerNorm (one-pass variance over fp32 sums, scale and
    shift rounded to bf16, elementwise math in bf16) against the JAX
    package's bf16 form: within one bf16 ulp (2**-8 relative), because the
    two frameworks sum the fp32 means in different orders."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((4, 9, 48)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal((2, 48)).astype(np.float32)
    ref = jax.jit(lambda p, x: jax_ops.layer_norm(p, x, eps=1e-6))(
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x, jnp.bfloat16))
    out = ops.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                         torch.from_numpy(b), eps=1e-6)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2 ** -8)


def test_window_partition_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13, 10, 4)).astype(np.float32)
    ref, ref_pad = jax_ops.window_partition(jnp.asarray(x), 4)
    out, pad = ops.window_partition(torch.from_numpy(x), 4)
    assert pad == ref_pad
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    back = ops.window_unpartition(out, 4, pad, (13, 10))
    np.testing.assert_array_equal(back.detach().numpy(), x)
