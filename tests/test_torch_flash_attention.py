"""K1, the masked flash-attention forward, and K2, its RoPE-fused form, in
the PyTorch port.

`flash_attention_ref` (the plain version the wrapper runs on CPU tensors) is
held against the JAX package's Pallas kernel in interpret mode: out and the
row log-sum-exp, at fp32, atol 2e-5 (the two sum 384 fp32 products in
different orders; the JAX kernel test holds K1 to SDPA at the same bound).
K2's plain version is held the same way against the JAX `_kernel_rope`.
The `gpu` tests hold the CUDA kernels against their plain versions on the
card and skip without one. JAX is imported inside the JAX comparison only, so
the `gpu` tests also run where JAX is not installed:
`python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py`.
"""

import math

import numpy as np
import pytest
import torch

from sam2_opt_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_ref,
    flash_attention_rope,
    flash_attention_rope_ref,
)
from sam2_opt_tpu_torch.ops.posenc import apply_rotary_split

torch.set_num_threads(2)

CASES = [
    # B, H, Sq, Skv, D, mask: None | "random" | "random+empty row"
    (1, 2, 256, 384, 72, None),
    (1, 2, 256, 384, 72, "random"),
    (2, 1, 200, 300, 56, None),
    (2, 1, 200, 300, 56, "random+empty row"),
]


def _inputs(B, H, Sq, Skv, D, mask, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, s, D)).astype(np.float32) for s in (Sq, Skv, Skv))
    kv_mask = None
    if mask is not None:
        kv_mask = rng.random((B, Skv)) > 0.3
        if mask == "random+empty row":
            kv_mask[-1] = False  # every query row of the last batch sees no key
    return q, k, v, kv_mask


def _jax_k1(q, k, v, kv_mask):
    """out and lse of the Pallas kernel (interpret mode), unpadded."""
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels import flash_attention as jfa

    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    out = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
                              block_q=128, block_k=128, interpret=True)
    sq_pad, skv_pad = -(-Sq // 128) * 128, -(-Skv // 128) * 128
    pad = lambda x, s: jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, s - x.shape[2]),  # noqa: E731
                                                (0, 128 - D))).reshape(B * H, s, 128)
    m = np.ones((B, Skv), bool) if kv_mask is None else kv_mask
    maskf = jnp.pad(jnp.asarray(m, jnp.float32), ((0, 0), (0, skv_pad - Skv)))
    maskf = jnp.broadcast_to(maskf[:, None, :], (B, H, skv_pad)).reshape(B * H, 1, skv_pad)
    _, lse = jfa._forward_impl(1.0 / math.sqrt(D), 128, 128, True, False,
                               pad(q, sq_pad), pad(k, skv_pad), pad(v, skv_pad), maskf)
    return np.asarray(out), np.asarray(lse)[:, :Sq, 0].reshape(B, H, Sq)


@pytest.mark.parametrize("B,H,Sq,Skv,D,mask", CASES)
def test_ref_matches_jax_kernel(B, H, Sq, Skv, D, mask):
    q, k, v, kv_mask = _inputs(B, H, Sq, Skv, D, mask)
    ref_out, ref_lse = _jax_k1(q, k, v, kv_mask)
    out, lse = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   None if kv_mask is None else torch.from_numpy(kv_mask))
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=2e-5)
    if mask == "random+empty row":
        assert not out[-1].any() and (lse[-1] == -1e30).all()


def test_wrapper_runs_ref_on_cpu_and_validates():
    q, k, v, _ = _inputs(1, 2, 64, 80, 72, None)
    q, k, v = map(torch.from_numpy, (q, k, v))
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v)
    ref_out, ref_lse = flash_attention_ref(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_attention.launches == before  # the count is of kernel launches only
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :1], v)
    with pytest.raises(ValueError):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, kv_mask=torch.ones(1, 79, dtype=torch.bool))


FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Skv,D,mask", CASES + [(1, 8, 1000, 1500, 96, "random+empty row"),
                                                       (1, 3, 130, 70, 8, None),
                                                       (1, 1, 65, 4100, 128, "random")])
def test_cuda_kernel_matches_ref(B, H, Sq, Skv, D, mask, dtype):
    """fp32: the kernel runs true fp32 FMAs, rtol 1e-5 + atol 1e-5. bf16:
    inputs rounded to bf16 for both, P rounded to bf16 against the running
    (kernel) or final (plain) row max, the output rounded to bf16: one ulp is
    at most 2^-7 of |out|, so rtol 1e-2 + atol 1e-3 (sound runs at the
    hiera-L shape differ by at most 9.8e-4, where |out| is typically 0.02)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, kv_mask = _inputs(B, H, Sq, Skv, D, mask)
    dev = lambda x: torch.from_numpy(x).cuda().to(dtype)  # noqa: E731
    q, k, v = dev(q), dev(k), dev(v)
    m = None if kv_mask is None else torch.from_numpy(kv_mask).cuda()
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, m)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = flash_attention_ref(q, k, v, m)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_takes_strided_qkv_views(dtype):
    """q/k/v as the Hiera block hands them over: head-major views into one
    interleaved [B, S, 3, H, D] projection (no copies). Tolerances as above.
    A bf16 view whose rows are not 16-byte aligned is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, S, H, D = 2, 300, 3, 72
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, D)).astype(np.float32))
    q, k, v = qkv.cuda().to(dtype).unbind(2)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out, lse = flash_attention(q, k, v)
    ref_out, ref_lse = flash_attention_ref(q, k, v)
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    if dtype == torch.bfloat16:
        odd = torch.zeros(B, H, S, D + 4, device="cuda", dtype=dtype)[..., :D]
        with pytest.raises(ValueError):
            flash_attention(odd, k, v)


# K2: the RoPE-fused forward. B, Sq, Skv, D, n_identity (unrotated trailing
# rows, the object pointers), mask: None | "random" | "random+empty row"
ROPE_CASES = [
    (1, 256, 384, 256, 64, "random"),
    (2, 256, 384, 256, 64, "random+empty row"),
    (1, 256, 256, 256, 0, None),
]


def _rope_inputs(B, Sq, Skv, D, n_identity, mask, seed=0):
    q, k, v, kv_mask = _inputs(B, 1, Sq, Skv, D, mask, seed)
    rng = np.random.default_rng(seed + 1)
    ang = rng.uniform(-np.pi, np.pi, (Skv, D // 2)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    cos[Skv - n_identity:], sin[Skv - n_identity:] = 1.0, 0.0
    return q, k, v, cos, sin, kv_mask


@pytest.mark.parametrize("B,Sq,Skv,D,n_identity,mask", ROPE_CASES)
def test_rope_ref_matches_jax_kernel(B, Sq, Skv, D, n_identity, mask):
    """`flash_attention_rope_ref` against the JAX package's K2 (`_kernel_rope`,
    Pallas interpret mode, fp32, 128-blocks): out within 2e-5, as K1 (the two
    sum 256-wide dot products in different orders); the empty row gives 0."""
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels import flash_attention as jfa

    q, k, v, cos, sin, kv_mask = _rope_inputs(B, Sq, Skv, D, n_identity, mask)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_mask=None if kv_mask is None else jnp.asarray(kv_mask),
                              rope_cos_k=jnp.asarray(cos), rope_sin_k=jnp.asarray(sin),
                              block_q=128, block_k=128, interpret=True)
    t = torch.from_numpy
    out, lse = flash_attention_rope_ref(t(q), t(k), t(v), t(cos), t(sin),
                                        None if kv_mask is None else t(kv_mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    if mask == "random+empty row":
        assert not out[-1].any() and (lse[-1] == -1e30).all()


def test_rope_wrapper_runs_ref_on_cpu_and_validates():
    q, k, v, cos, sin, m = map(torch.from_numpy, _rope_inputs(1, 64, 96, 256, 8, "random"))
    before = flash_attention_rope.launches
    out, lse = flash_attention_rope(q, k, v, cos, sin, m)
    ref_out, ref_lse = flash_attention_rope_ref(q, k, v, cos, sin, m)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_attention_rope.launches == before
    # identity tables reduce K2 to K1
    one, zero = torch.ones_like(cos), torch.zeros_like(sin)
    plain = flash_attention_ref(q, k, v, m)
    assert torch.equal(flash_attention_rope(q, k, v, one, zero, m)[0], plain[0])
    with pytest.raises(ValueError):
        flash_attention_rope(q, k, v, cos[:-1], sin[:-1], m)
    with pytest.raises(ValueError):
        flash_attention_rope(q, k, v, cos.double(), sin.double(), m)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,D,n_identity,mask", ROPE_CASES + [
    (1, 1000, 1500, 256, 16, "random+empty row"), (2, 130, 70, 64, 0, "random"),
    (1, 65, 4100, 128, 100, None), (1, 64, 8192, 256, 64, "random")])
def test_cuda_rope_kernel_matches_ref(B, Sq, Skv, D, n_identity, mask, dtype):
    """K2 against its plain version on the card, both rotating K in fp32
    from the same inputs with one rounding; the long-kv cases split the kv
    axis over many CTAs and merge the splits (32 splits at Skv = 8192).
    fp32: rtol 1e-5 + atol 1e-5.
    bf16: each side rounds P to bf16 (2^-9 relative) against another row max
    (running or final) and rounds out (2^-9 relative), so per element
    |out - ref| <= 2^-8 * (P . |V|) + 2^-8 * |ref|. K1's flat rtol 1e-2 +
    atol 1e-3 is not a bound: at 70 keys a sound run differs by 1.25e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, cos, sin, kv_mask = _rope_inputs(B, Sq, Skv, D, n_identity, mask)
    dev = lambda x: torch.from_numpy(x).cuda().to(dtype)  # noqa: E731
    q, k, v, cos, sin = map(dev, (q, k, v, cos, sin))
    m = None if kv_mask is None else torch.from_numpy(kv_mask).cuda()
    before = flash_attention_rope.launches
    out, lse = flash_attention_rope(q, k, v, cos, sin, m)
    torch.cuda.synchronize()
    assert flash_attention_rope.launches == before + 1
    ref_out, ref_lse = flash_attention_rope_ref(q, k, v, cos, sin, m)
    if dtype == torch.bfloat16:
        kr = apply_rotary_split(k.float(), cos.float(), sin.float()).to(dtype)
        s = torch.matmul(q.float(), kr.float().transpose(-1, -2)) / math.sqrt(D)
        if m is not None:
            s = s.masked_fill(~m[:, None, None, :], float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, -1))
        bound = 2 ** -8 * (torch.matmul(p, v.float().abs()) + ref_out.float().abs())
        err = (out.float() - ref_out.float()).abs()
        assert bool((err <= bound + 1e-6).all()), (err - bound).max().item()
    else:
        torch.testing.assert_close(out, ref_out, **FP32_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    if mask == "random+empty row":
        assert not out[-1].any() and bool((lse[-1] == -1e30).all())
