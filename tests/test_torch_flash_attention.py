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
    rope_rotate,
)
from sam2_opt_tpu_torch.ops.posenc import apply_rotary_split

torch.set_num_threads(2)

CASES = [
    # B, H, Sq, Skv, D, mask: None | "random" | "block" (+ "+empty row")
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
        if mask.startswith("block"):  # whole 64-key tiles masked, the rest valid
            kv_mask[:] = True
            kv_mask[:, 64:192] = False
        if mask.startswith("tiles"):  # whole 128-key tiles masked, the rest valid
            kv_mask[:] = True
            kv_mask[:, 128:384] = False
        if mask.endswith("empty row"):
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


GPU_CASES = CASES + [(1, 8, 1000, 1500, 96, "random+empty row"), (1, 3, 130, 70, 8, None),
                     (1, 1, 65, 4100, 128, "random"), (2, 1, 1000, 1500, 256, "random+empty row"),
                     (1, 1, 4096, 7 * 4096 + 64, 256, "random")]
# bf16 at D <= 128 (the wgmma kernel): 128 query rows a CTA and 128 keys a
# stage, one below and one above each; D from 8 to 128 (56 and 72 at N = D,
# the others padded to 16); whole 128-key tiles masked (skipped); a batch row
# with no valid key; one query row; B*H = 64 at 4096 rows, hiera-b+'s
# global blocks of an 8-frame training batch
BF16_CASES = [
    (1, 2, 127, 129, 72, None), (1, 2, 129, 127, 72, None), (1, 1, 255, 257, 56, "random"),
    (1, 1, 257, 255, 80, None), (2, 2, 200, 300, 8, None), (1, 2, 300, 200, 80, "random"),
    (1, 2, 333, 520, 120, "random"), (1, 1, 130, 129, 128, None), (1, 2, 200, 640, 72, "tiles"),
    (2, 2, 300, 300, 72, "random+empty row"), (2, 2, 300, 520, 56, "tiles+empty row"),
    (1, 2, 1, 300, 72, None), (2, 1, 1, 1, 56, None), (8, 8, 4096, 4096, 56, None),
]
# fp32 (three-pass TF32): 128 query rows a CTA, 64 keys a tile up to D = 64
# and 32 above, one below and one above each; D from 8 to 256 (8 and 120
# padded to 16 and 128 in shared memory); whole 64-key tiles masked; a batch
# row with no valid key; small grids whose kv axis splits
FP32_CASES = [
    (1, 2, 127, 63, 8, None), (1, 2, 129, 65, 8, "random"), (2, 2, 127, 65, 56, "block+empty row"),
    (1, 2, 129, 63, 56, None), (1, 2, 127, 33, 72, "random"), (1, 2, 129, 31, 72, None),
    (2, 1, 129, 33, 120, "random+empty row"), (1, 1, 127, 31, 120, None),
    (1, 2, 127, 65, 128, "block"), (1, 2, 129, 31, 128, "random"),
    (1, 1, 127, 33, 256, "random"), (2, 1, 129, 31, 256, "block+empty row"),
    (1, 1, 1, 300, 256, None), (1, 1, 65, 8200, 256, "block"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Skv,D,mask,dtype",
                         [c + (dt,) for c in GPU_CASES for dt in (torch.bfloat16, torch.float32)]
                         + [c + (torch.bfloat16,) for c in BF16_CASES]
                         + [c + (torch.float32,) for c in FP32_CASES])
def test_cuda_kernel_matches_ref(B, H, Sq, Skv, D, mask, dtype):
    """fp32: the kernel runs three TF32 products per fp32 product (about
    2^-21 of each), each tile's into a zeroed partial, rtol 1e-5 + atol
    1e-5. bf16: inputs rounded to bf16 for both, P rounded to bf16 against
    the running (kernel) or final (plain) row max, the output rounded to
    bf16: one ulp is at most 2^-7 of |out|, so rtol 1e-2 + atol 1e-3 (sound
    runs at the hiera-L shape differ by at most 9.8e-4, where |out| is
    typically 0.02).
    D = 256 is memory attention under SAM2_TPU_FUSED_ROPE=0, up to its
    cross shape (the body K2 runs on the rotated K, the kv axis split).
    Fully masked rows give 0 and lse -1e30."""
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
    if mask is not None and mask.endswith("empty row"):
        assert not out[-1].any() and bool((lse[-1] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [72, 56])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_takes_strided_qkv_views(dtype, D):
    """q/k/v as the Hiera block hands them over: head-major views into one
    interleaved [B, S, 3, H, D] projection (no copies), at hiera-L's and
    hiera-b+'s head dims. Tolerances as above. A bf16 view whose rows are
    not 16-byte aligned is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, S, H = 2, 300, 3
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


# K2 on the card: D = 256 runs 128 query rows a CTA and 64 keys a stage in
# bf16 (32 keys a tile in fp32), so Sq 127/129 and Skv 63/65 sit one below
# and one above each tile; whole 64-key tiles masked; a batch row with no
# valid key; B = 2; identity rows at the end; the cross shape (28,736 keys,
# which tests fp32's per-tile partials); D = 64 and 128 through the D <= 128
# bodies
ROPE_CUDA_CASES = ROPE_CASES + [
    (1, 1000, 1500, 256, 16, "random+empty row"), (2, 130, 70, 64, 0, "random"),
    (1, 65, 4100, 128, 100, None), (1, 64, 8192, 256, 64, "random"),
    (1, 127, 63, 256, 8, None), (1, 129, 65, 256, 8, "random"),
    (2, 129, 63, 256, 0, "random+empty row"), (1, 127, 65, 256, 16, "block"),
    (2, 300, 400, 256, 64, "block+empty row"), (1, 4096, 7 * 4096 + 64, 256, 64, "random"),
    (1, 200, 300, 64, 8, "block"), (1, 129, 127, 128, 8, "random"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,D,n_identity,mask", ROPE_CUDA_CASES)
def test_cuda_rope_kernel_matches_ref(B, Sq, Skv, D, n_identity, mask, dtype):
    """K2 against its plain version on the card, both rotating K in fp32
    from the same inputs with one rounding; the long-kv cases split the kv
    axis over many CTAs and merge the splits.
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


def test_rope_rotate_runs_plain_on_cpu_and_validates():
    """On CPU tensors K2's rotation alone is the plain rotation; the counter
    does not move; mismatched tables are refused."""
    _, k, _, cos, sin, _ = map(lambda x: None if x is None else torch.from_numpy(x),
                               _rope_inputs(2, 8, 96, 64, 16, None))
    before = rope_rotate.launches
    kr = rope_rotate(k, cos, sin)
    assert torch.equal(kr, apply_rotary_split(k, cos, sin))
    assert rope_rotate.launches == before
    with pytest.raises(ValueError):
        rope_rotate(k, cos[:-1], sin[:-1])
    with pytest.raises(ValueError):
        rope_rotate(k, cos.double(), sin.double())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Skv,D,n_identity", [
    (1, 1, 7 * 4096 + 64, 256, 64), (2, 1, 4096, 256, 0), (2, 3, 130, 128, 8), (1, 2, 65, 64, 1)])
def test_cuda_rope_rotate_matches_plain_bitwise(B, H, Skv, D, n_identity, dtype):
    """K2's rotation kernel alone equals the plain rotation (fp32 from the
    inputs, one rounding per operation, one to k's dtype) bit for bit, on k
    as a strided head-major view of a [B, Skv, H, D] projection; one launch
    on its count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, _, cos, sin, _ = _rope_inputs(1, 8, Skv, D, n_identity, None)
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.standard_normal((B, Skv, H, D)).astype(np.float32))
    k = k.cuda().to(dtype).transpose(1, 2)
    cos, sin = (torch.from_numpy(x).cuda().to(dtype) for x in (cos, sin))
    before = rope_rotate.launches
    kr = rope_rotate(k, cos, sin)
    torch.cuda.synchronize()
    assert rope_rotate.launches == before + 1
    assert kr.is_contiguous() and kr.shape == k.shape
    assert torch.equal(kr, apply_rotary_split(k.float(), cos.float(), sin.float()).to(dtype))


# K3: the backward. The plain version against the JAX package's Pallas flash
# backward (`_flash_bwd`, interpret mode, padded to 128 as `_jax_k1` pads),
# fp32: each of dq/dk/dv within 1e-5 of its own max |g| (the two sum the
# same fp32 products in different orders).
BWD_CASES = [  # B, H, Sq, Skv, D, mask
    (1, 2, 200, 300, 56, None),
    (2, 1, 200, 300, 56, "random+empty row"),
    (1, 2, 256, 384, 72, "random"),
    (2, 1, 130, 260, 72, "random+empty row"),
]


def _rel_close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (err, scale)


def _jax_k3(q, k, v, kv_mask, do):
    """(dq, dk, dv) of the Pallas backward on the padded layout, unpadded."""
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels import flash_attention as jfa

    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    sq_pad, skv_pad = -(-Sq // 128) * 128, -(-Skv // 128) * 128
    pad = lambda x, s: jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, s - x.shape[2]),  # noqa: E731
                                                (0, 128 - D))).reshape(B * H, s, 128)
    m = np.ones((B, Skv), bool) if kv_mask is None else kv_mask
    maskf = jnp.pad(jnp.asarray(m, jnp.float32), ((0, 0), (0, skv_pad - Skv)))
    maskf = jnp.broadcast_to(maskf[:, None, :], (B, H, skv_pad)).reshape(B * H, 1, skv_pad)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = pad(q, sq_pad), pad(k, skv_pad), pad(v, skv_pad), pad(do, sq_pad)
    out, lse = jfa._forward_impl(scale, 128, 128, True, False, qf, kf, vf, maskf)
    dq, dk, dv = jfa._flash_bwd(scale, True, qf, kf, vf, maskf, dof, out, lse)
    unpad = lambda x, s: np.asarray(x).reshape(B, H, -1, 128)[:, :, :s, :D]  # noqa: E731
    return unpad(dq, Sq), unpad(dk, Skv), unpad(dv, Skv)


@pytest.mark.parametrize("B,H,Sq,Skv,D,mask", BWD_CASES)
def test_bwd_ref_matches_jax_kernel(B, H, Sq, Skv, D, mask):
    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention_bwd_ref

    q, k, v, kv_mask = _inputs(B, H, Sq, Skv, D, mask)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    ref = _jax_k3(q, k, v, kv_mask, do)
    t = torch.from_numpy
    m = None if kv_mask is None else t(kv_mask)
    out, lse = flash_attention_ref(t(q), t(k), t(v), m)
    grads = flash_attention_bwd_ref(t(q), t(k), t(v), out, lse, t(do), m)
    for got, want in zip(grads, ref):
        _rel_close(got.numpy(), want)
    if mask == "random+empty row":  # rows that see no key, and keys no row sees
        assert not grads[0][-1].any() and not grads[1][-1].any() and not grads[2][-1].any()


def test_bwd_rope_matches_jax_grad():
    """The port's K2 Function (plain forward and backward on the CPU) against
    `jax.grad` of the JAX K2 (Pallas interpret mode, its `_attn_rope_bwd`):
    D 64, 32 pointer identity rows, a random mask with an empty batch row."""
    import jax
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels import flash_attention as jfa

    q, k, v, cos, sin, kv_mask = _rope_inputs(2, 200, 288, 64, 32, "random+empty row")
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, kv_mask=jnp.asarray(kv_mask), rope_cos_k=jnp.asarray(cos),
                                  rope_sin_k=jnp.asarray(sin), block_q=128, block_k=128,
                                  interpret=True)
        return jnp.sum(out * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = flash_attention_rope(tq, tk, tv, torch.from_numpy(cos), torch.from_numpy(sin),
                                  torch.from_numpy(kv_mask))
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for got, want in zip(grads, ref):
        _rel_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rope", [False, True])
def test_autograd_functions_match_autograd_of_plain_forward(rope):
    """On CPU tensors both Functions run the plain forward and the plain
    backward (K3's plain version); their gradients equal autograd through the
    plain forward (1e-5 of max |g|)."""
    q, k, v, cos, sin, kv_mask = map(torch.from_numpy,
                                     _rope_inputs(2, 70, 96, 64, 16, "random+empty row"))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(q.shape).astype(np.float32))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    if rope:
        out = flash_attention_rope(*qkv, cos, sin, kv_mask)[0]
        plain = flash_attention_rope_ref(*qkv, cos, sin, kv_mask)[0]
    else:
        out = flash_attention(*qkv, kv_mask)[0]
        plain = flash_attention_ref(*qkv, kv_mask)[0]
    got = torch.autograd.grad(out, qkv, g)
    want = torch.autograd.grad(plain, qkv, g)
    for a, b in zip(got, want):
        _rel_close(a.numpy(), b.numpy())


def _assert_bwd_within(got, ref, bounds):
    """fp32 (bounds None): each gradient within 1e-4 of its own max |g| (the
    two sum in different orders); bf16: within the per-element bounds of
    `flash_attention_bwd_bf16_bound`."""
    for name, a, b, i in zip(("dq", "dk", "dv"), got, ref, range(3)):
        err = (a - b).abs()
        if bounds is None:
            assert err.max().item() <= 1e-4 * b.abs().max().item(), (name, err.max().item())
        else:
            over = (err - bounds[i]).max().item()
            assert over <= 1e-6 * b.abs().max().item(), (name, over)


# The card's K3 tiles (bf16): K3a 64 keys per CTA and 64 query rows per
# stage; K3b 128 query rows per CTA and 64 keys per stage (32 above D =
# 128); cases one below and one above each, whole masked key tiles, D from 8
# to 256 (56 and 200 padded by the loads), B*H = 64.
BWD_CUDA_CASES = BWD_CASES + [
    (1, 1, 65, 4100, 256, "random+empty row"), (2, 1, 300, 700, 128, "random"),
    (1, 3, 130, 70, 8, None), (1, 1, 100, 90, 200, None),
    (1, 1, 63, 65, 256, "random"), (1, 1, 65, 63, 256, None),
    (1, 2, 127, 31, 256, "random"), (1, 2, 129, 33, 256, None),
    (2, 1, 129, 65, 64, "block+empty row"), (1, 1, 127, 63, 128, None),
    (2, 1, 200, 700, 56, "block+empty row"), (1, 2, 190, 260, 72, "block"),
    (2, 1, 300, 520, 200, "block+empty row"), (8, 8, 130, 200, 56, "random"),
]
# bf16 shapes whose grid alone would leave SMs idle: the streamed axis splits
# over several CTAs and a second kernel sums their partials
BWD_SPLIT_CASES = [
    (1, 1, 1000, 130, 256, "random"), (1, 1, 200, 4100, 256, "block+empty row"),
    (1, 1, 700, 300, 64, None), (2, 1, 900, 100, 200, "random+empty row"),
]


def _cuda_bwd(q, k, v, do, m):
    """(dq, dk, dv) of K3a and K3b on the card and of their plain versions,
    and the bf16 bounds (None for fp32); one launch of each kernel."""
    from sam2_opt_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_bf16_bound,
        flash_attention_bwd_delta,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_ref,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_ref,
    )

    out, lse = flash_attention_ref(q, k, v, m)
    delta = flash_attention_bwd_delta(out, do)
    before = (flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, m)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, m)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    ref = (flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, m),
           *flash_attention_bwd_dkdv_ref(q, k, v, do, lse, delta, m))
    bounds = None if q.dtype == torch.float32 else flash_attention_bwd_bf16_bound(
        q, k, v, do, lse, delta, m)
    return (dq, dk, dv), ref, bounds


def _cuda_bwd_case(B, H, Sq, Skv, D, mask, dtype):
    q, k, v, kv_mask = _inputs(B, H, Sq, Skv, D, mask)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    dev = lambda x: torch.from_numpy(x).cuda().to(dtype)  # noqa: E731
    m = None if kv_mask is None else torch.from_numpy(kv_mask).cuda()
    return dev(q), dev(k), dev(v), dev(do), m


def _check_cuda_bwd(B, H, Sq, Skv, D, mask, dtype):
    got, ref, bounds = _cuda_bwd(*_cuda_bwd_case(B, H, Sq, Skv, D, mask, dtype))
    _assert_bwd_within(got, ref, bounds)
    if mask is not None and mask.endswith("empty row"):
        assert not got[0][-1].any() and not got[1][-1].any() and not got[2][-1].any()
    if mask is not None and mask.startswith("block"):  # keys no row sees
        assert not got[1][:, :, 64:192].any() and not got[2][:, :, 64:192].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Skv,D,mask", BWD_CUDA_CASES)
def test_cuda_bwd_kernels_match_ref(B, H, Sq, Skv, D, mask, dtype):
    """K3a and K3b against their plain versions on the card (bounds in
    `_assert_bwd_within`); one launch of each; fully masked rows give zero dq and
    unseen keys zero dk/dv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_cuda_bwd(B, H, Sq, Skv, D, mask, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Sq,Skv,D,mask", BWD_SPLIT_CASES)
def test_cuda_bwd_split_and_combine(B, H, Sq, Skv, D, mask):
    """bf16 shapes on which both kernels split their streamed axis (checked
    through `bwd_splits`, and `bwd_tiling` reporting the same split), against
    the plain versions as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sam2_opt_tpu_torch.kernels.flash_attention import bwd_splits, bwd_tiling

    dev = torch.cuda.current_device()
    assert bwd_splits(False, dev, 1, B, H, Sq, Skv, D) > 1 or bwd_splits(
        True, dev, 1, B, H, Sq, Skv, D) > 1
    assert bwd_splits(False, dev, 0, B, H, Sq, Skv, D) == 1  # fp32 never splits
    for is_dq in (False, True):
        for code, dtype in ((0, torch.float32), (1, torch.bfloat16)):
            t = bwd_tiling(is_dq, dtype, B, H, Sq, Skv, D)
            assert t["n_split"] == bwd_splits(is_dq, dev, code, B, H, Sq, Skv, D)
            rows = Sq if is_dq else Skv
            assert t["ctas"] == B * H * -(-rows // t["cta_rows"]) * t["n_split"]
    _check_cuda_bwd(B, H, Sq, Skv, D, mask, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bwd_takes_strided_qkv_views(dtype):
    """K3 on q/k/v as Hiera hands them over: strided views of one
    [B, S, 3, H, D] projection, B*H = 64, D = 56."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, S, H, D = 8, 300, 8, 56
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3, H, D)).astype(np.float32)).cuda().to(dtype)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    assert q.stride() == (S * 3 * H * D, D, 3 * H * D, 1)
    do = torch.from_numpy(rng.standard_normal((B, H, S, D)).astype(np.float32)).cuda().to(dtype)
    m = torch.from_numpy(rng.random((B, S)) > 0.3).cuda()
    _assert_bwd_within(*_cuda_bwd(q, k, v, do, m))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Sq,Skv,D,mask", [(2, 1, 300, 700, 256, "block+empty row"),
                                               BWD_SPLIT_CASES[0], BWD_SPLIT_CASES[1]])
def test_cuda_bwd_is_deterministic(B, H, Sq, Skv, D, mask, dtype):
    """No atomics: two launches on the same inputs give bitwise-equal dQ, dK
    and dV, with and without the split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sam2_opt_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_delta,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
    )

    q, k, v, do, m = _cuda_bwd_case(B, H, Sq, Skv, D, mask, dtype)
    out, lse = flash_attention_ref(q, k, v, m)
    delta = flash_attention_bwd_delta(out, do)
    runs = [(flash_attention_bwd_dq(q, k, v, do, lse, delta, m),
             *flash_attention_bwd_dkdv(q, k, v, do, lse, delta, m)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_autograd_through_kernels(dtype):
    """Both Functions on the card: gradients of K1 on strided q/k/v views
    (as Hiera hands them over, D = 56) and of K2 (D = 256, identity rows)
    launch K3 once each and agree with the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sam2_opt_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_dkdv,
        flash_attention_bwd_ref,
    )

    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 300, 3, 2, 56)).astype(np.float32))
    qkv = qkv.cuda().to(dtype).requires_grad_()
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    out, lse = flash_attention(q, k, v)
    g = torch.randn_like(out)
    before = flash_attention_bwd_dkdv.launches
    (grad,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dkdv.launches == before + 1
    ref = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), lse, g)
    ref = torch.stack([r.transpose(1, 2) for r in ref], 2).to(dtype).float()
    assert (grad.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()

    q, k, v, cos, sin, kv_mask = _rope_inputs(1, 300, 500, 256, 20, "random")
    q, k, v = (torch.from_numpy(x).cuda().to(dtype).requires_grad_() for x in (q, k, v))
    cos, sin = (torch.from_numpy(x).cuda().to(dtype) for x in (cos, sin))
    m = torch.from_numpy(kv_mask).cuda()
    out, _ = flash_attention_rope(q, k, v, cos, sin, m)
    got = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    plain = flash_attention_rope_ref(q, k, v, cos, sin, m)[0]
    want = torch.autograd.grad(plain, (q, k, v), torch.ones_like(plain))
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * b.float().abs().max().item()
