"""K4, flash attention with the memory K/V projections fused in, in the
PyTorch port.

The plain version (`flash_attention_kv_proj_ref`, what the wrapper runs on
CPU tensors) is held against the JAX package's Pallas kernel
(`flash_attention_kv_proj`, interpret mode, 128-blocks) at fp32 within 2e-5,
the JAX kernel test's own bound; the port's autograd seam on CPU tensors
against `jax.grad` through the JAX kernel's custom VJP within 2e-4, that
test's gradient bound. Memory attention's cross-attention under
`SAM2_TPU_FUSED_KV_PROJ=1` is held against the JAX `rope_cross_attention`
with the same switch set on the JAX side (its module test never sets it),
and `SAM2_TPU_FUSED_ROPE=0` against the JAX unfused branch, within 1e-4.
The `gpu` tests hold the CUDA kernel against its plain version on the card
and skip without one; JAX is imported inside the JAX comparisons only:
`python -m pytest --noconftest -m gpu tests/test_torch_kv_proj.py`.
"""

import numpy as np
import pytest
import torch

from sam2_opt_tpu_torch.kernels.flash_attention import (
    flash_attention_kv_proj,
    flash_attention_ref,
    flash_attention_kv_proj_ref,
    kv_proj_rotate,
    kv_proj_rotate_ref,
)

torch.set_num_threads(2)

# B, D, Dm, frame side (Sq = side², one frame of spatial keys), pointer keys,
# mask: "random" (a quarter of the keys masked) or "random+empty row"
CASES = [
    (1, 64, 32, 16, 16, "random"),          # the JAX kernel test's shapes
    (2, 256, 64, 16, 16, "random+empty row"),  # memory attention's widths
]


def _inputs(B, D, Dm, side, n_ptr, mask, seed=31, reps=1):
    """numpy fp32: q [B, 1, Sq, D] (rotated by the caller), mem_k/mem_v
    [B, Skv, Dm], wk/wv [D, Dm] (nn.Linear layout), bk/bv [D], the split
    RoPE tables with identity rows for the pointers, the kv mask."""
    from sam2_opt_tpu_torch.ops.posenc import rope_half_tables

    rng = np.random.default_rng(seed)
    Sq = side * side
    Skv = reps * Sq + n_ptr
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    q = f(B, 1, Sq, D, scale=0.3)
    mem_k, mem_v = f(B, Skv, Dm, scale=0.3), f(B, Skv, Dm, scale=0.3)
    wk, wv = f(D, Dm, scale=0.2), f(D, Dm, scale=0.2)
    bk, bv = f(D, scale=0.05), f(D, scale=0.05)
    c, s = (x.numpy() for x in rope_half_tables(D, side, side, 10000.0))
    cos = np.concatenate([np.tile(c, (reps, 1)), np.ones((n_ptr, D // 2), np.float32)])
    sin = np.concatenate([np.tile(s, (reps, 1)), np.zeros((n_ptr, D // 2), np.float32)])
    m = rng.random((B, Skv)) > 0.25
    m[:, :4] = True
    if mask == "random+empty row":
        m[-1] = False
    return dict(q=q, mem_k=mem_k, mem_v=mem_v, wk=wk, bk=bk, wv=wv, bv=bv, cos=cos, sin=sin,
                mask=m)


ARGS = ("q", "mem_k", "mem_v", "wk", "bk", "wv", "bv")


def _jax_k4(x, **arrays):
    """The JAX kernel (interpret mode, 128-blocks) on the JAX layouts: weights
    [Dm, D]."""
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels.flash_attention import flash_attention_kv_proj as jax_k4

    a = {**{k: x[k] for k in ARGS}, **arrays}
    return jax_k4(jnp.asarray(a["q"]), jnp.asarray(a["mem_k"]), jnp.asarray(a["mem_v"]),
                  jnp.asarray(a["wk"]).T, jnp.asarray(a["bk"]), jnp.asarray(a["wv"]).T,
                  jnp.asarray(a["bv"]), kv_mask=jnp.asarray(x["mask"]),
                  rope_cos_k=jnp.asarray(x["cos"]), rope_sin_k=jnp.asarray(x["sin"]),
                  block_q=128, block_k=128, interpret=True)


def _port(x, dtype=torch.float32, fn=flash_attention_kv_proj_ref):
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return fn(*(t(x[k]) for k in ARGS), t(x["cos"]), t(x["sin"]), torch.from_numpy(x["mask"]))


@pytest.mark.parametrize("B,D,Dm,side,n_ptr,mask", CASES)
def test_ref_matches_jax_kernel(B, D, Dm, side, n_ptr, mask):
    x = _inputs(B, D, Dm, side, n_ptr, mask)
    want = np.asarray(_jax_k4(x))
    out, lse = _port(x)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=2e-5)
    if mask == "random+empty row":  # a row that sees no key: out 0, lse -1e30
        assert not out[-1].any() and bool((lse[-1] == -1e30).all())


def test_seam_matches_jax_grad():
    """All seven gradients of the port's Function on CPU tensors (plain
    forward, the JAX `_attn_rope_kvproj_bwd` in torch with K3's plain
    version) against `jax.grad` through the JAX kernel's custom VJP."""
    import jax
    import jax.numpy as jnp

    x = _inputs(*CASES[0])
    g = np.random.default_rng(5).standard_normal(x["q"].shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(_jax_k4(x, **dict(zip(ARGS, a))) * g)

    want = jax.grad(loss, argnums=tuple(range(7)))(*(jnp.asarray(x[k]) for k in ARGS))
    want = [np.asarray(w) for w in want]
    leaves = [torch.from_numpy(x[k]).requires_grad_() for k in ARGS]
    out, _ = flash_attention_kv_proj(*leaves, torch.from_numpy(x["cos"]),
                                     torch.from_numpy(x["sin"]), torch.from_numpy(x["mask"]))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip(ARGS, got, want):
        assert np.abs(a.numpy() - b).max() < 2e-4, name


def test_wrapper_runs_ref_on_cpu_and_validates():
    """CPU tensors run the plain version (no launch); under autograd the
    seam's gradients equal autograd through the plain version; bad shapes
    and dtypes raise; without bk the output moves."""
    x = _inputs(*CASES[1])
    before = flash_attention_kv_proj.launches
    out, lse = _port(x, fn=flash_attention_kv_proj)
    ref, ref_lse = _port(x)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert flash_attention_kv_proj.launches == before
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(out.shape).astype(np.float32))
    grads = []
    for fn in (flash_attention_kv_proj, flash_attention_kv_proj_ref):
        leaves = [torch.from_numpy(x[k]).requires_grad_() for k in ARGS]
        o, _ = fn(*leaves, torch.from_numpy(x["cos"]), torch.from_numpy(x["sin"]),
                  torch.from_numpy(x["mask"]))
        grads.append(torch.autograd.grad(o, leaves, g))
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    args = [t[k] for k in ARGS] + [t["cos"], t["sin"], t["mask"]]
    with pytest.raises(ValueError):
        flash_attention_kv_proj(*args[:3], t["wk"][:, :-1], *args[4:])
    with pytest.raises(ValueError):
        flash_attention_kv_proj(*args[:7], t["cos"].double(), *args[8:])
    with pytest.raises(ValueError):
        flash_attention_kv_proj(t["q"].expand(-1, 2, -1, -1), *args[1:])
    no_bias, _ = flash_attention_kv_proj_ref(*args[:4], torch.zeros_like(t["bk"]), *args[5:])
    assert (no_bias - ref).abs().max() > 1e-3


def test_kv_proj_rotate_ref_matches_jax_unfused_branch():
    """K4's first kernel's plain version (`kv_proj_rotate_ref`, what
    `kv_proj_rotate` runs on CPU tensors) against what the JAX package's
    unfused branch of `rope_cross_attention` computes before its attention:
    the K projection rotated by `apply_rotary_split`, and the V projection,
    fp32 within 1e-5 (the sums run in other orders)."""
    import jax.numpy as jnp

    from sam2_opt_tpu.ops import posenc as jax_posenc

    x = _inputs(*CASES[1])
    want_k = jax_posenc.apply_rotary_split(
        jnp.asarray(x["mem_k"]) @ jnp.asarray(x["wk"]).T + jnp.asarray(x["bk"]),
        jnp.asarray(x["cos"]), jnp.asarray(x["sin"]))
    want_v = jnp.asarray(x["mem_v"]) @ jnp.asarray(x["wv"]).T + jnp.asarray(x["bv"])
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    args = (t["mem_k"], t["wk"], t["bk"], t["mem_v"], t["wv"], t["bv"], t["cos"], t["sin"])
    kr, vp = kv_proj_rotate_ref(*args)
    np.testing.assert_allclose(kr.numpy(), np.asarray(want_k), rtol=0, atol=1e-5)
    np.testing.assert_allclose(vp.numpy(), np.asarray(want_v), rtol=0, atol=1e-5)
    before = kv_proj_rotate.launches
    got = kv_proj_rotate(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, (kr, vp)))
    assert kv_proj_rotate.launches == before
    with pytest.raises(ValueError):
        kv_proj_rotate(*args[:6], t["cos"][:-1], t["sin"][:-1])
    with pytest.raises(ValueError):
        kv_proj_rotate(t["mem_k"].double(), *args[1:])
    with pytest.raises(ValueError):
        kv_proj_rotate(t["mem_k"], t["wk"][:, :-1], *args[2:])


def test_bf16_close_to_fp32():
    """The plain version in bf16 (inputs, projections and K rounded to bf16)
    stays within 3e-2 of max |out| of the fp32 one."""
    x = _inputs(*CASES[1])
    out32, _ = _port(x)
    out16, _ = _port(x, torch.bfloat16)
    assert (out16.float() - out32).abs().max() <= 3e-2 * out32.abs().max()


# --------------------------------------------------------------------------- #
# memory attention's cross-attention under the switches
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fused_rope", ["1", "0"])
def test_rope_cross_attention_matches_jax(monkeypatch, fused_rope):
    """The JAX `rope_cross_attention` with SAM2_TPU_FLASH=1,
    SAM2_TPU_FUSED_KV_PROJ=1 and SAM2_TPU_FUSED_ROPE as given (its Pallas
    kernels in interpret mode) against the port's cross-attention under the
    same switches, on the same weights, within 1e-4. A spy shows the port
    took K4's plain version with the switch on (and K2's with it off), and
    with SAM2_TPU_FUSED_ROPE=0 K1's plain version on K rotated in torch."""
    import jax.numpy as jnp

    import sam2_opt_tpu.kernels.flash_attention as fa
    from sam2_opt_tpu.config import MemoryAttentionConfig as JaxConfig
    from sam2_opt_tpu.models import memory_attention as jma
    from sam2_opt_tpu_torch.config import MemoryAttentionConfig
    from sam2_opt_tpu_torch.models import memory_attention as ma

    side, n_ptr = 32, 32  # 1024 queries x 1056 keys: the JAX kernel gate q * kv >= 1024²
    cfg, jcfg = MemoryAttentionConfig(rope_feat_sizes=(side, side)), JaxConfig(
        rope_feat_sizes=(side, side))
    rng = np.random.default_rng(23)
    dm, dkv = cfg.d_model, cfg.kv_in_dim
    Skv = side * side + n_ptr

    def lin(i, o):
        return {"weight": (rng.standard_normal((i, o)) * 0.05).astype(np.float32),
                "bias": (rng.standard_normal(o) * 0.01).astype(np.float32)}

    p = {"q_proj": lin(dm, dm), "k_proj": lin(dkv, dm), "v_proj": lin(dkv, dm),
         "out_proj": lin(dm, dm)}
    q_in = rng.standard_normal((1, side * side, dm)).astype(np.float32)
    k_in = rng.standard_normal((1, Skv, dkv)).astype(np.float32)
    v_in = rng.standard_normal((1, Skv, dkv)).astype(np.float32)
    m = rng.random((1, Skv)) > 0.3
    m[:, :8] = True

    orig, orig_kv = fa.flash_attention, fa.flash_attention_kv_proj
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **kw: orig(
        *a, block_q=512, block_k=512, interpret=True, **kw))
    monkeypatch.setattr(fa, "flash_attention_kv_proj", lambda *a, **kw: orig_kv(
        *a, block_q=512, block_k=512, interpret=True, **kw))
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    monkeypatch.setenv("SAM2_TPU_FUSED_ROPE", fused_rope)
    monkeypatch.setenv("SAM2_TPU_FUSED_KV_PROJ", "1")
    jp = {k: {n: jnp.asarray(a) for n, a in d.items()} for k, d in p.items()}
    want = np.asarray(jma.rope_cross_attention(jp, jcfg, jnp.asarray(q_in), jnp.asarray(k_in),
                                               jnp.asarray(v_in), jnp.asarray(m), side * side))

    attn = ma.RoPEAttention(dm, cfg.num_heads, kv_in_dim=dkv)
    with torch.no_grad():
        for name, d in p.items():
            getattr(attn, name).weight.copy_(torch.from_numpy(d["weight"].T))
            getattr(attn, name).bias.copy_(torch.from_numpy(d["bias"]))
    calls = []
    for name in ("flash_attention_kv_proj_ref", "flash_attention_rope_ref", "flash_attention_ref"):
        fn = getattr(ma, name)
        monkeypatch.setattr(ma, name, lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))

    def port():
        with torch.no_grad():
            return ma._rope_attention(attn, cfg, torch.from_numpy(q_in), torch.from_numpy(k_in),
                                      torch.from_numpy(v_in), torch.from_numpy(m), 1, n_ptr,
                                      cross=True).numpy()

    np.testing.assert_allclose(port(), want, rtol=0, atol=1e-4)
    expect = "flash_attention_kv_proj_ref" if fused_rope == "1" else "flash_attention_ref"
    assert calls == [expect]
    monkeypatch.setenv("SAM2_TPU_FUSED_KV_PROJ", "0")
    np.testing.assert_allclose(port(), want, rtol=0, atol=1e-4)
    assert calls[1:] == ["flash_attention_rope_ref" if fused_rope == "1" else "flash_attention_ref"]


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

# The card's kernels against their plain version. fp32: rtol 1e-5 + atol
# 1e-5 (the projections sum 64 products in other orders; the attention runs
# K1's three-pass TF32 products, about 2^-21 of each). bf16: K2's rtol 1e-2 + atol 1e-3 (an element of K or V, rounded
# from an fp32 projection summed in another order, may land one bf16 ulp
# from the plain version's; both round P and out as K2 does).
GPU_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-3)}


def _card_inputs(B, Sq, Skv, n_ptr, dtype, seed, bias=0.5, Dm=64, exact=False):
    """CUDA tensors at memory attention's widths (D 256, Dm 64 unless given):
    random memory, weights ~ 1/sqrt(fan-in), biases `bias` x N(0, 1), the
    real tables for (Skv - n_ptr) / 4096 frames of 64 x 64 plus identity
    rows, a mask with a quarter of the keys masked and batch row B - 1 fully
    masked if B > 1. With `exact`, the memory, weights and biases lie on the
    dyadic grids of `_exact_projection` instead."""
    from sam2_opt_tpu_torch.models.memory_attention import _rope_half_tables

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(*s, device="cuda", generator=gen) * scale).to(dtype)  # noqa: E731
    reps = (Skv - n_ptr) // 4096
    c, s = _rope_half_tables(256, 64, 64, 10000.0, max(reps, 1), n_ptr, torch.device("cuda"), dtype)
    c, s = c[:Skv].contiguous(), s[:Skv].contiguous()
    mask = torch.rand(B, Skv, device="cuda", generator=gen) > 0.25
    if B > 1:
        mask[-1] = False
    w = Dm ** -0.5
    args = [r(B, 1, Sq, 256), r(B, Skv, Dm), r(B, Skv, Dm), r(256, Dm, scale=w),
            r(256, scale=bias), r(256, Dm, scale=w), r(256, scale=bias), c, s, mask]
    if exact:
        mem_k, wk, bk, mem_v, wv, bv = _exact_projection(B, Skv, Dm, dtype,
                                                         np.random.default_rng(seed))
        args[1:7] = [mem_k, mem_v, wk, bk, wv, bv]
    return args


def _exact_projection(B, Skv, Dm, dtype, rng):
    """mem_k, wk, bk, mem_v, wv, bv on dyadic grids (the memory in multiples
    of 2^-3, the weights of 2^-4, the biases of 2^-6, all small), the memory
    as strided views of one [B, Skv, 2, Dm] tensor: every product and partial
    sum of the projections is exact in fp32, so any two orders of the sums
    agree bit for bit."""
    grid = lambda shape, step: torch.from_numpy(  # noqa: E731
        rng.integers(-4, 5, shape).astype(np.float32) * step).cuda().to(dtype)
    mem = grid((B, Skv, 2, Dm), 2.0 ** -3)
    return (mem[:, :, 0], grid((256, Dm), 2.0 ** -4), grid((256,), 2.0 ** -6),
            mem[:, :, 1], grid((256, Dm), 2.0 ** -4), grid((256,), 2.0 ** -6))


GPU_CASES = [  # B, Sq, Skv, n_ptr, Dm, exact
    (1, 4096, 7 * 4096 + 64, 64, 64, False),   # the tracked frame's cross shape
    (2, 4096, 2 * 4096 + 32, 32, 64, False),   # two objects (training), row 1 fully masked
    (2, 1000, 1500, 0, 64, False),             # ragged, row 1 fully masked
    (1, 130, 70, 6, 64, False),                # one kv tile more than a whole one
    # the projection kernel's row tiles (32 rows in both dtypes) across the
    # batch boundary, both memory widths; row 1 of each B = 2 case fully
    # masked. With this few keys one key can hold much of a row's weight,
    # and a K element that the kernel's and the plain version's fp32 sums
    # round one bf16 ulp apart (both are fp32 sums, in other orders) moves
    # that row's lse past 1e-5 (7.6e-5 in a first run): these cases take
    # exact projections (`_exact_projection`), so they hold the kernels'
    # tiling to the plain version at the unchanged tolerance, and the four
    # cases above keep random projections, where each key's weight is small
    (2, 200, 63, 7, 32, True), (2, 200, 65, 1, 64, True), (2, 129, 127, 0, 32, True),
    (2, 64, 129, 9, 64, True), (1, 300, 129, 4, 32, True),
]
TILE_EDGE_CASES = [case[:5] for case in GPU_CASES if case[5]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,n_ptr,Dm,exact", GPU_CASES)
def test_cuda_kernel_matches_ref(B, Sq, Skv, n_ptr, Dm, exact, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _card_inputs(B, Sq, Skv, n_ptr, dtype, seed=B * Sq + Skv, Dm=Dm, exact=exact)
    before = flash_attention_kv_proj.launches
    out, lse = flash_attention_kv_proj(*args)
    torch.cuda.synchronize()
    assert flash_attention_kv_proj.launches == before + 1
    ref, ref_lse = flash_attention_kv_proj_ref(*args)
    rtol, atol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    if B > 1:
        assert not out[-1].any() and bool((lse[-1] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,n_ptr,Dm", TILE_EDGE_CASES)
def test_cuda_kernel_random_tile_edges(B, Sq, Skv, n_ptr, Dm, dtype):
    """The exact cases' tile-edge shapes on random projections, so the
    kernel's rounding of kp and vp is covered at the edges too: out against
    the plain version at GPU_TOL, and lse against the plain attention on the
    projection kernel's own kr and vp (where the two sides' fp32 sums round
    one ulp apart, the lse follows kr, not the attention) at 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _card_inputs(B, Sq, Skv, n_ptr, dtype, seed=B * Sq + Skv + 1, Dm=Dm)
    before = flash_attention_kv_proj.launches
    out, lse = flash_attention_kv_proj(*args)
    torch.cuda.synchronize()
    assert flash_attention_kv_proj.launches == before + 1
    ref, _ = flash_attention_kv_proj_ref(*args)
    rtol, atol = GPU_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    q, mem_k, mem_v, wk, bk, wv, bv, c, s, mask = args
    kr, vp = kv_proj_rotate(mem_k, wk, bk, mem_v, wv, bv, c, s)
    _, want_lse = flash_attention_ref(q, kr[:, None], vp[:, None], mask)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    if B > 1:
        assert not out[-1].any() and bool((lse[-1] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bias", [0.05, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gradients_match_plain(dtype, bias):
    """The seven gradients through K4 (backward: K3 and the projection
    products) against autograd of the plain version, beside a witness: the
    unfused route K4 replaces (two F.linear, K2 forward, K3 backward) under
    the same check. fp32 within 1e-4 of max |g|. bf16 within 2e-2, or,
    where the witness itself misses 2e-2, within twice its error: K3 takes
    delta = rowsum(dO * O) from the bf16 output on either route, and a large
    bias shared by every key magnifies that rounding in dQ and dbk (see
    `chip_smoke.py::phase_k4_grads`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.nn.functional as F

    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention_rope

    def unfused(q, mk, mv, wk, bk, wv, bv, c, s, mask):
        return flash_attention_rope(q, F.linear(mk, wk, bk)[:, None],
                                    F.linear(mv, wv, bv)[:, None], c, s, mask)

    args = _card_inputs(1, 1024, 2 * 4096 + 32, 32, dtype, seed=3, bias=bias)
    g = torch.randn(1, 1, 1024, 256, device="cuda").to(dtype)
    grads = []
    for fn in (flash_attention_kv_proj, unfused, flash_attention_kv_proj_ref):
        leaves = [a.clone().requires_grad_() for a in args[:7]]
        out, _ = fn(*leaves, *args[7:])
        grads.append(torch.autograd.grad(out, leaves, g))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    bad = []
    for name, got, witness, want in zip(("q", "mem_k", "mem_v", "wk", "bk", "wv", "bv"), *grads):
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item() / scale
        witness_err = (witness.float() - want.float()).abs().max().item() / scale
        lim = tol if dtype == torch.float32 else max(tol, 2 * witness_err)
        if err > lim:
            bad.append((name, err, witness_err))
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Skv,Dm", [(2, 63, 32), (2, 65, 64), (1, 127, 64), (2, 129, 32),
                                      (1, 7 * 4096 + 64, 64)])
def test_cuda_kv_proj_rotate_matches_plain_bitwise(B, Skv, Dm, dtype):
    """K4's first kernel alone equals `_project` + the plain rotation bit
    for bit, on memory given as strided views: on `_exact_projection`'s
    inputs the kernel's and the plain version's sums agree in any order, so
    every rounding after them (kp to q's dtype, the rotation's products,
    sums and its last rounding) must land on the same value. One launch on
    its count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sam2_opt_tpu_torch.models.memory_attention import _rope_half_tables

    mem_k, wk, bk, mem_v, wv, bv = _exact_projection(B, Skv, Dm, dtype,
                                                     np.random.default_rng(B * Skv + Dm))
    reps, n_ptr = max((Skv - 64) // 4096, 1), Skv % 4096 if Skv > 4096 else 8
    c, s = _rope_half_tables(256, 64, 64, 10000.0, reps, n_ptr, torch.device("cuda"), dtype)
    c, s = c[:Skv].contiguous(), s[:Skv].contiguous()
    before = kv_proj_rotate.launches
    kr, vp = kv_proj_rotate(mem_k, wk, bk, mem_v, wv, bv, c, s)
    torch.cuda.synchronize()
    assert kv_proj_rotate.launches == before + 1
    assert kr.is_contiguous() and vp.is_contiguous() and kr.shape == vp.shape == (B, Skv, 256)
    want_k, want_v = kv_proj_rotate_ref(mem_k, wk, bk, mem_v, wv, bv, c, s)
    assert torch.equal(kr, want_k)
    assert torch.equal(vp, want_v)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_all_masked_memory(dtype):
    """A memory bank with no valid slot (every kv tile skipped) gives out 0
    and lse -1e30 on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _card_inputs(1, 300, 700, 0, dtype, seed=4)
    args[-1] = torch.zeros_like(args[-1])
    out, lse = flash_attention_kv_proj(*args)
    assert not out.any() and bool((lse == -1e30).all())
