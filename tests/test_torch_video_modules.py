"""Modules of the port's video slice against the JAX package, fp32 on the CPU.

Both packages run the same weights (the JAX `tiny128_params` through the
weight bridge: hiera_t at 128 px, an 8x8 feature grid, so 64 tokens per
frame) on the same numpy inputs; the JAX side runs under `jax.jit` with
`highest` matmul precision (tests/conftest.py). Tolerances:
- RoPE tables and rotations: 1e-6 (the same float32 formulas);
- memory attention, memory encoder, SAM heads, memory encode and the two
  tracking steps: 1e-4 rtol and atol (4 attention layers or a conv stack,
  summed in different orders; the JAX memory attention runs its unfused
  interleaved-RoPE path on the CPU, the port the split layout through K2's
  plain version; the JAX memory encoder its packed downsampler, which its own
  tests hold to the plain one);
- connected components and hole / sprinkle filling: exact (the same bounded
  label propagation).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_opt_tpu.models import memory_attention as jax_ma
from sam2_opt_tpu.models import memory_encoder as jax_me
from sam2_opt_tpu.models import sam2_base as jax_base
from sam2_opt_tpu.models import video_core as jax_vc
from sam2_opt_tpu.ops import connected_components as jax_cc
from sam2_opt_tpu.ops import posenc as jax_posenc
from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.models import video_core as vc
from sam2_opt_tpu_torch.ops import connected_components as cc
from sam2_opt_tpu_torch.ops import posenc

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
OP_TOL = dict(rtol=1e-6, atol=1e-6)


def nchw(x):
    return np.transpose(np.asarray(x, np.float32), (0, 3, 1, 2))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def port(tiny128_params):
    module = base.SAM2Base(model_config("hiera_t", image_size=128))
    module.load_state_dict(
        state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params)), strict=True)
    return module.eval()


def test_rope_tables_and_rotations_match_jax():
    cos, sin = posenc.axial_rope_cos_sin(256, 8, 8)
    ref_cos, ref_sin = jax_posenc.axial_rope_cos_sin(256, 8, 8)
    np.testing.assert_array_equal(cos.numpy(), ref_cos)
    np.testing.assert_array_equal(sin.numpy(), ref_sin)
    ch, sh = posenc.rope_half_tables(256, 8, 8)
    ref_ch, ref_sh = jax_posenc.rope_half_tables(256, 8, 8)
    np.testing.assert_array_equal(ch.numpy(), ref_ch)
    np.testing.assert_array_equal(sh.numpy(), ref_sh)
    np.testing.assert_array_equal(posenc.split_perm(8, 2).numpy(), jax_posenc.split_perm(8, 2))

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1, 64, 256)).astype(np.float32)
    np.testing.assert_allclose(posenc.apply_rotary(t(x), cos, sin).numpy(),
                               np.asarray(jax_posenc.apply_rotary(jnp.asarray(x), ref_cos, ref_sin)),
                               **OP_TOL)
    np.testing.assert_allclose(
        posenc.apply_rotary_split(t(x), ch, sh).numpy(),
        np.asarray(jax_posenc.apply_rotary_split(jnp.asarray(x), ref_ch, ref_sh)), **OP_TOL)
    # the split layout is the interleaved one, permuted
    perm = posenc.split_perm(256)
    np.testing.assert_allclose(posenc.apply_rotary_split(t(x)[..., perm], ch, sh).numpy(),
                               posenc.apply_rotary(t(x), cos, sin)[..., perm].numpy(), **OP_TOL)
    pos = rng.uniform(-1, 1, (2, 16)).astype(np.float32)
    np.testing.assert_allclose(posenc.get_1d_sine_pe(t(pos), 256).numpy(),
                               np.asarray(jax_posenc.get_1d_sine_pe(jnp.asarray(pos), 256)),
                               **OP_TOL)


def _memory(rng, B, frames, ptrs):
    """Memory tokens [B, frames*64 + 4*ptrs, 64], positions and a mask with
    one invalid frame slot and some invalid pointers per batch row."""
    S = frames * 64 + 4 * ptrs
    memory = rng.standard_normal((B, S, 64)).astype(np.float32)
    memory_pos = rng.standard_normal((B, S, 64)).astype(np.float32) * 0.1
    mask = np.ones((B, S), bool)
    for b in range(B):
        slot = rng.integers(frames)
        mask[b, slot * 64:(slot + 1) * 64] = False
        mask[b, frames * 64:] = np.repeat(rng.random(ptrs) > 0.4, 4)
    return memory, memory_pos, mask


def test_memory_attention_matches_jax(tiny128_cfg, tiny128_params, port):
    rng = np.random.default_rng(1)
    B, frames, ptrs = 2, 3, 16
    curr = rng.standard_normal((B, 64, 256)).astype(np.float32)
    curr_pos = rng.standard_normal((B, 64, 256)).astype(np.float32) * 0.1
    memory, memory_pos, mask = _memory(rng, B, frames, ptrs)
    ref = jax.jit(lambda p, *a: jax_ma.memory_attention(
        p, tiny128_cfg.memory_attention, *a, kv_mask=mask, num_frame_tokens=frames * 64))(
        tiny128_params["memory_attention"], curr, memory, curr_pos, memory_pos)
    with torch.no_grad():
        out = port.memory_attention(t(curr), t(memory), t(curr_pos), t(memory_pos),
                                    kv_mask=t(mask), num_frame_tokens=frames * 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_memory_encoder_matches_jax(tiny128_cfg, tiny128_params, port):
    rng = np.random.default_rng(2)
    pix = rng.standard_normal((2, 8, 8, 256)).astype(np.float32)
    masks = (rng.standard_normal((2, 128, 128, 1)) * 10).astype(np.float32)
    ref, ref_pos = jax.jit(lambda p, x, m: jax_me.memory_encoder(
        p, tiny128_cfg.memory_encoder, x, m))(tiny128_params["memory_encoder"], pix, masks)
    with torch.no_grad():
        out, pos = port.memory_encoder(t(nchw(pix)), t(nchw(masks)))
    np.testing.assert_allclose(out.numpy(), nchw(ref), **TOL)
    np.testing.assert_allclose(pos.numpy(), nchw(ref_pos), **OP_TOL)


def _features(rng, B=1):
    return (rng.standard_normal((B, 32, 32, 32)).astype(np.float32),
            rng.standard_normal((B, 16, 16, 64)).astype(np.float32),
            rng.standard_normal((B, 8, 8, 256)).astype(np.float32))


def _assert_outputs(out, ref):
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("multimask,with_mask", [(True, False), (False, True)])
def test_forward_sam_heads_matches_jax(tiny128_cfg, tiny128_params, port, multimask, with_mask):
    """Returns the reference 7-tuple; a mask prompt runs the prompt encoder's
    mask branch."""
    cfg = tiny128_cfg
    rng = np.random.default_rng(3)
    hrf0, hrf1, embed = _features(rng, 2)
    coords = (rng.random((2, 2, 2)) * 128).astype(np.float32)
    labels = np.array([[1, 0], [1, -1]], np.int32)
    mask = (rng.standard_normal((2, 32, 32, 1)) * 4).astype(np.float32) if with_mask else None
    ref = jax.jit(lambda p, e, c, l, m, h0, h1: jax_base.forward_sam_heads(
        p, cfg, e, c, l, m, (h0, h1), multimask_output=multimask))(
        tiny128_params, embed, coords, labels, mask, hrf0, hrf1)
    with torch.no_grad():
        out = base.forward_sam_heads(port, cfg, t(nchw(embed)), t(coords), t(labels),
                                     None if mask is None else t(nchw(mask)),
                                     (t(nchw(hrf0)), t(nchw(hrf1))), multimask_output=multimask)
    _assert_outputs(out, ref)


def test_use_mask_as_output_and_encode_new_memory_match_jax(tiny128_cfg, tiny128_params, port):
    """The mask passthrough (with its pointer from the SAM heads), then the
    memory encode of its high-res logits, binarized as from clicks and not."""
    cfg = tiny128_cfg
    rng = np.random.default_rng(4)
    hrf0, hrf1, embed = _features(rng, 2)
    mask = np.zeros((2, 1, 128, 128), np.float32)
    mask[0, 0, 30:90, 20:70] = 1.0
    ref = jax.jit(lambda p, e, h0, h1, m: jax_base.use_mask_as_output(p, cfg, e, (h0, h1), m))(
        tiny128_params, embed, hrf0, hrf1, mask)
    with torch.no_grad():
        out = base.use_mask_as_output(port, cfg, t(nchw(embed)), (t(nchw(hrf0)), t(nchw(hrf1))),
                                      t(mask))
    _assert_outputs(out, ref)

    scores = np.array([[2.0], [-1.0]], np.float32)
    high = (rng.standard_normal((2, 1, 128, 128)) * 5).astype(np.float32)
    bcfg = dataclasses.replace(cfg, binarize_mask_from_pts_for_mem_enc=True)
    for from_pts in (False, True):
        ref_feats, ref_pos = jax.jit(lambda p, x, m, s: jax_base.encode_new_memory(
            p, bcfg, x, m, s, is_mask_from_pts=from_pts))(tiny128_params, embed, high, scores)
        with torch.no_grad():
            feats, pos = base.encode_new_memory(port, bcfg, t(nchw(embed)), t(high), t(scores),
                                                from_pts)
        np.testing.assert_allclose(feats.numpy(), nchw(ref_feats), **TOL)
        np.testing.assert_allclose(pos.numpy(), nchw(ref_pos), **OP_TOL)


def _mem_inputs(rng, B=2, slots=7, ptrs=16):
    feats = [(rng.standard_normal((B, 8, 8, 64)) * 0.5).astype(np.float32) for _ in range(slots)]
    feats = [np.asarray(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32)) for f in feats]
    ptr_list = [rng.standard_normal((B, 256)).astype(np.float32) * 0.5 for _ in range(ptrs)]
    tpos_idx = np.tile(np.array([6, 5, 4, 3, 2, 1, 0], np.int32)[:slots], (B, 1))
    valid = np.ones((B, slots), bool)
    valid[0, 4:] = False
    ptr_pos = np.tile((np.arange(ptrs) / 15).astype(np.float32), (B, 1))
    ptr_valid = np.ones((B, ptrs), bool)
    ptr_valid[1, 10:] = False
    jax_mem = jax_vc.MemoryInput(
        feats=tuple(jnp.asarray(f, jnp.bfloat16) for f in feats), tpos_idx=tpos_idx, valid=valid,
        ptrs=tuple(jnp.asarray(p) for p in ptr_list), ptr_pos=ptr_pos, ptr_valid=ptr_valid)
    port_mem = vc.MemoryInput(
        feats=tuple(t(nchw(f)).bfloat16() for f in feats), tpos_idx=tpos_idx, valid=valid,
        ptrs=tuple(t(p) for p in ptr_list), ptr_pos=ptr_pos, ptr_valid=ptr_valid)
    return jax_mem, port_mem


def _assert_track(out, ref):
    assert sorted(out) == sorted(k for k in ref if k != "all_pred_masks")
    for key in out:
        a = out[key].float().numpy()
        b = np.asarray(ref[key], np.float32)
        if key == "maskmem_features":
            # stored in bf16 on both sides: one bf16 ulp (2^-8 relative)
            np.testing.assert_allclose(a, nchw(b), rtol=2 ** -7, atol=1e-3)
        else:
            np.testing.assert_allclose(a, b, **TOL)


def test_track_steps_match_jax(tiny128_cfg, tiny128_params, port):
    """track_step_init with a point (no memory) and track_step_conditioned
    over a fixed-capacity memory of two objects, with the memory encoder."""
    cfg = tiny128_cfg
    rng = np.random.default_rng(5)
    hrf0, hrf1, embed = _features(rng)
    coords = np.array([[[40.0, 60.0]]], np.float32)
    labels = np.array([[1]], np.int32)
    ref = jax.jit(lambda p, f, c, l: jax_vc.track_step_init(
        p, cfg, f, c, l, None, multimask_output=True, run_mem_encoder=True))(
        tiny128_params, (hrf0, hrf1, embed), coords, labels)
    feats = (t(nchw(hrf0)), t(nchw(hrf1)), t(nchw(embed)))
    with torch.no_grad():
        out = vc.track_step_init(port, cfg, feats, t(coords), t(labels), None,
                                 multimask_output=True, run_mem_encoder=True)
    _assert_track(out, ref)

    jax_mem, port_mem = _mem_inputs(rng)
    f2 = tuple(np.repeat(f, 2, axis=0) for f in (hrf0, hrf1, embed))
    ref = jax.jit(lambda p, f, m: jax_vc.track_step_conditioned(
        p, cfg, f, m, multimask_output=True, run_mem_encoder=True))(tiny128_params, f2, jax_mem)
    with torch.no_grad():
        out = vc.track_step_conditioned(port, cfg, tuple(t(nchw(f)) for f in f2), port_mem,
                                        multimask_output=True, run_mem_encoder=True)
    _assert_track(out, ref)


def _random_masks(seed, shape=(3, 48, 56)):
    """Blobby binary masks: thresholded smoothed noise, so components, holes
    and islands of many sizes appear."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    for _ in range(2):
        x = (x + np.roll(x, 1, -1) + np.roll(x, -1, -1) + np.roll(x, 1, -2)
             + np.roll(x, -1, -2)) / 5
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_connected_components_match_jax_exactly(seed):
    logits = _random_masks(seed)
    for mask in (logits > 0, logits <= 0, np.random.default_rng(seed).random(logits.shape) > 0.5):
        ref_labels, ref_areas = jax_cc.connected_components(jnp.asarray(mask))
        labels, areas = cc.connected_components(t(mask))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
        np.testing.assert_array_equal(areas.numpy(), np.asarray(ref_areas))


@pytest.mark.parametrize("seed", [2, 3])
def test_hole_and_sprinkle_filling_match_jax_exactly(seed):
    logits = _random_masks(seed)[:, None]
    ref = jax_cc.fill_holes_and_sprinkles(jnp.asarray(logits), 0.0, 8.0, 8.0)
    out = cc.fill_holes_and_sprinkles(t(logits), 0.0, 8.0, 8.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy() != logits).any()  # something was filled
    ref = jax_cc.fill_holes_in_mask_scores(jnp.asarray(logits), 8)
    out = cc.fill_holes_in_mask_scores(t(logits), 8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert torch.equal(cc.fill_holes_in_mask_scores(t(logits), 0), t(logits))


def test_mask_to_box_and_concat_points_match_jax():
    from sam2_opt_tpu.utils import misc as jax_misc
    from sam2_opt_tpu_torch.utils import misc

    masks = np.zeros((3, 1, 20, 30), bool)
    masks[0, 0, 4:9, 7:25] = True
    masks[1, 0, 19, 0] = True  # masks[2] stays empty
    np.testing.assert_array_equal(misc.mask_to_box(t(masks)).numpy(),
                                  np.asarray(jax_misc.mask_to_box(jnp.asarray(masks))))
    old = {"point_coords": np.ones((1, 2, 2), np.float32), "point_labels": np.ones((1, 2))}
    new_pts, new_labels = np.zeros((1, 1, 2), np.float32), np.zeros((1, 1))
    for prev in (None, old):
        out = misc.concat_points(prev, new_pts, new_labels)
        ref = jax_misc.concat_points(prev, new_pts, new_labels)
        for key in ("point_coords", "point_labels"):
            np.testing.assert_array_equal(out[key], ref[key])
