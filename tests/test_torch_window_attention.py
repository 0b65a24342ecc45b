"""K5, K6 and K7, the per-window attention kernels, in the PyTorch port,
and K9 and K10, the window bench tool's kernels (the same CUDA kernel).

The plain versions the wrappers run on CPU tensors are held against the JAX
package's Pallas kernels: K5 (`window_attention`) and K6
(`window_flash_3d`) in interpret mode, K7 (`packed_window_attention`), which
picks interpret mode itself off the TPU. fp32 within 2e-5, the JAX tests'
own bound (the two sum the same products in other orders); bf16 within one
bf16 ulp of |out| plus 2^-9 (p . |v|), what one ulp of a rounded
probability moves it by (both round p and out to bf16 from fp32 values that
may differ in their last bits). The `gpu` tests hold the CUDA kernel against the
plain version on the card and skip without one; JAX is imported inside the
JAX comparisons only, so they also run where JAX is not installed:
`python -m pytest --noconftest -m gpu tests/test_torch_window_attention.py`.
"""

import numpy as np
import pytest
import torch

from sam2_opt_tpu_torch.kernels.window_attention import (
    packed_window_attention,
    window_attention,
    window_attention_3d,
    window_attention_bf16_bound,
    window_attention_heads,
    window_attention_nshd_ref,
    window_attention_ref,
    window_flash_3d,
)

torch.set_num_threads(2)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _jax(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)


def _torch(x, dtype):
    return torch.from_numpy(x).to(DTYPES[dtype])


def _pv_abs(q, k, v):
    """p . |v| in fp32 on the [..., S, D] layout (p: the fp32 softmax)."""
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) / q.shape[-1] ** 0.5, -1)
    return torch.matmul(p, v.float().abs())


def _assert_matches(got, want, dtype, pv_abs=None):
    """fp32: 2e-5. bf16: one ulp of |want| (2^(floor(log2 |want|) - 7)), plus
    what one ulp of a rounded probability moves the output by, 2^-9 (p . |v|)
    (the two round p from fp32 values that may differ in their last bits)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 2e-5, err.max()
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -40))) - 7)
        bound = ulp + 2.0 ** -9 * pv_abs.numpy()
        assert (err <= bound).all(), (err - bound).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,S,D", [(8, 64, 96), (6, 49, 56)])
def test_k5_ref_matches_jax_kernel(N, S, D, dtype):
    from sam2_opt_tpu.kernels.window_attention import window_attention as jax_k5

    q, k, v = _arrays([(N, S, D)] * 3, seed=11)
    want = jax_k5(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype), interpret=True)
    tq, tk, tv = _torch(q, dtype), _torch(k, dtype), _torch(v, dtype)
    _assert_matches(window_attention_ref(tq, tk, tv), want, dtype, _pv_abs(tq, tk, tv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,S,H,D", [(4, 64, 2, 72), (3, 49, 2, 56)])
def test_k6_ref_matches_jax_kernel(N, S, H, D, dtype):
    from sam2_opt_tpu.kernels.window_attention import window_flash_3d as jax_k6

    q, k, v = _arrays([(N, S, H, D)] * 3, seed=12)
    want = jax_k6(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype), interpret=True)
    tq, tk, tv = _torch(q, dtype), _torch(k, dtype), _torch(v, dtype)
    pv = _pv_abs(*(x.transpose(1, 2) for x in (tq, tk, tv))).transpose(1, 2)
    _assert_matches(window_flash_3d(tq, tk, tv), want, dtype, pv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,Sq,Skv,H,D", [(12, 16, 16, 4, 72), (6, 16, 64, 2, 72)])
def test_k7_ref_matches_jax_kernel(N, Sq, Skv, H, D, dtype):
    """K7 also with Sq != Skv (its packed block-diagonal mask on the TPU)."""
    from sam2_opt_tpu.kernels.window_attention import packed_window_attention as jax_k7

    q, k, v = _arrays([(N, Sq, H, D), (N, Skv, H, D), (N, Skv, H, D)], seed=13)
    want = jax_k7(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    tq, tk, tv = _torch(q, dtype), _torch(k, dtype), _torch(v, dtype)
    pv = _pv_abs(*(x.transpose(1, 2) for x in (tq, tk, tv))).transpose(1, 2)
    _assert_matches(packed_window_attention(tq, tk, tv), want, dtype, pv)


@pytest.mark.parametrize("which", ["k6", "k7"])
def test_gradients_match_jax_custom_vjp(which):
    """The port's Function (plain forward, `_packed_vjp_bwd` in torch) against
    `jax.grad` through the JAX custom VJPs, fp32, each gradient within 1e-4
    of its max |g|."""
    import jax
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels import window_attention as jwa

    skv = 64 if which == "k7" else 16
    q, k, v, g = _arrays([(4, 16, 2, 32), (4, skv, 2, 32), (4, skv, 2, 32), (4, 16, 2, 32)],
                         seed=14, scale=0.5)
    if which == "k6":
        jfn, tfn = (lambda *a: jwa.window_flash_3d(*a, interpret=True)), window_flash_3d
    else:
        jfn, tfn = jwa.packed_window_attention, packed_window_attention
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * g), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(tfn(tq, tk, tv), (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


def test_wrappers_run_plain_version_on_cpu_and_validate():
    """On CPU tensors each wrapper returns its plain version and launches
    nothing; K5's plain version stays differentiable there; bad shapes and
    dtypes raise."""
    q, k, v = (torch.from_numpy(x) for x in _arrays([(3, 16, 2, 24)] * 3, seed=15))
    before = (window_attention.launches, window_flash_3d.launches,
              packed_window_attention.launches)
    ref = window_attention_nshd_ref(q, k, v)
    assert torch.equal(window_flash_3d(q, k, v), ref)
    assert torch.equal(packed_window_attention(q, k, v), ref)
    # K5 on the [B, heads, S, D] layout that flash_or_sdpa hands over
    qt, kt, vt = (x.transpose(1, 2).requires_grad_() for x in (q, k, v))
    out = window_attention(qt, kt, vt)
    assert torch.equal(out.transpose(1, 2), ref) and out.grad_fn is not None
    assert (window_attention.launches, window_flash_3d.launches,
            packed_window_attention.launches) == before
    with pytest.raises(ValueError):
        window_flash_3d(q, k[:, :8], v[:, :8])  # K6 needs Sq == Skv
    with pytest.raises(ValueError):
        packed_window_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        window_attention(q[..., 0, :], k[..., 0, :], v[:, :8, 0, :])


def test_flash_or_sdpa_routes_window_kernel(monkeypatch):
    """`SAM2_TPU_WINDOW_KERNEL=1` routes unmasked equal-length attention of
    up to 1024 tokens to K5 (here its plain version), as the JAX package's
    `flash_or_sdpa` does; a kv mask or unequal lengths stay plain. Both
    packages also require `SAM2_TPU_FLASH` on, which the CPU needs set."""
    import sam2_opt_tpu_torch.kernels.window_attention as wa
    from sam2_opt_tpu_torch.ops import common as ops

    calls = []
    monkeypatch.setattr(wa, "window_attention",
                        lambda *a: calls.append(1) or wa.window_attention_ref(*a))
    q, k, v = (torch.from_numpy(x) for x in _arrays([(2, 2, 64, 32)] * 3, seed=16))
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    base = ops.flash_or_sdpa(q, k, v)
    monkeypatch.setenv("SAM2_TPU_WINDOW_KERNEL", "1")
    out = ops.flash_or_sdpa(q, k, v)
    torch.testing.assert_close(out, base, rtol=2e-5, atol=2e-5)
    ops.flash_or_sdpa(q, k, v, kv_mask=torch.ones(2, 64, dtype=torch.bool))
    ops.flash_or_sdpa(q[:, :, :16], k, v)
    assert len(calls) == 1


# On the card: the kernel against its plain version. fp32 runs three-pass
# TF32 products (about 2^-21 of |q k| each) against the plain version's fp32
# matmul, 1e-5; bf16 within `window_attention_bf16_bound`.
GPU_CASES = [  # N, Sq, Skv, H, D
    (64, 64, 64, 2, 72), (256, 16, 16, 4, 72), (4, 256, 256, 8, 72), (4, 64, 64, 16, 72),
    (8, 49, 49, 3, 56), (2, 196, 196, 4, 96), (6, 16, 64, 2, 72), (2, 1024, 1024, 1, 64),
    (3, 40, 24, 2, 8), (2, 100, 100, 1, 128),
    # the fp32 kernel's tiling: 16 query rows a warp, 64 a CTA; kv tiles of 32
    # keys, a window of up to 2 tiles loaded once, a 2-stage ring above
    (4, 1, 1, 2, 72), (6, 17, 17, 2, 120), (2, 15, 15, 3, 56), (2, 31, 31, 3, 72),
    (2, 33, 33, 3, 72), (2, 63, 63, 2, 128), (2, 65, 65, 2, 72), (2, 95, 95, 2, 72),
    (2, 97, 97, 2, 8), (1, 255, 255, 2, 72), (1, 257, 257, 2, 56), (1, 1024, 1024, 2, 72),
    (3, 15, 97, 2, 56), (2, 97, 31, 2, 120), (4, 17, 33, 2, 8),
    # pairs not a multiple of a CTA's: 4 per CTA at 16 rows, 2 at 32
    (5, 16, 16, 1, 72), (3, 32, 32, 1, 56),
    # the bf16 mma.sync kernel's tiling: a warp per 16 query rows, up to 16
    # warps a pair (8 above D = 96), the window's K and V resident in shared
    # memory up to 200 KB a CTA (S = 512 at D = 72), two stages of 128 keys
    # above; D = 56, 72, 96 and 128 around each
    (2, 128, 128, 2, 72), (1, 127, 127, 3, 72), (1, 129, 129, 3, 56), (2, 255, 255, 2, 72),
    (2, 256, 256, 3, 56), (2, 256, 256, 2, 96), (1, 256, 256, 2, 128), (1, 257, 257, 2, 72),
    (1, 512, 512, 2, 72), (1, 512, 512, 1, 128), (1, 1024, 1024, 1, 96),
    (1, 1000, 1000, 1, 128), (2, 256, 64, 2, 72), (2, 64, 300, 2, 72), (3, 130, 257, 1, 80),
    (7, 8, 8, 1, 72), (5, 256, 256, 1, 72),
    # packed pairs (16 or 32 rows) whose windows do not fit 4 or 2 to a CTA:
    # resident in fewer pairs a CTA, or streamed in 2 or 1
    (3, 16, 200, 2, 72), (2, 32, 300, 2, 128), (3, 16, 600, 2, 72), (3, 16, 1024, 2, 56),
    (5, 16, 1024, 1, 56), (2, 32, 1024, 2, 128),
    # the bf16 wgmma kernel (more than 64 query rows over up to 256 keys):
    # up to 4 blocks of 64 rows a CTA, which its two warpgroups take in turn;
    # a last CTA with fewer blocks, and a warpgroup with none
    (1, 300, 200, 2, 72), (2, 65, 65, 2, 72), (2, 192, 192, 1, 112), (1, 100, 250, 2, 40),
]


def _assert_kernel_close(out, ref, q, k, v, dtype):
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    else:
        err = (out.float() - ref.float()).abs()
        assert bool((err <= window_attention_bf16_bound(q, k, v, ref)).all()), err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,Sq,Skv,H,D", GPU_CASES)
def test_cuda_kernel_matches_ref(N, Sq, Skv, H, D, dtype):
    """K7 on every case (Sq may differ from Skv), K6 where Sq == Skv, on
    strided views of one [N, S, 3, H, D] projection where Sq == Skv; one
    launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = DTYPES[dtype]
    if Sq == Skv:
        (qkv,) = _arrays([(N, Sq, 3, H, D)], seed=17)
        q, k, v = torch.from_numpy(qkv).cuda().to(tdt).unbind(2)
    else:
        q, k, v = (torch.from_numpy(x).cuda().to(tdt) for x in _arrays(
            [(N, Sq, H, D), (N, Skv, H, D), (N, Skv, H, D)], seed=17))
    ref = window_attention_nshd_ref(q, k, v)
    kernels = [packed_window_attention] + ([window_flash_3d] if Sq == Skv else [])
    for fn in kernels:
        before = fn.launches
        out = fn(q, k, v)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and out.is_contiguous()
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        _assert_kernel_close(t(out), t(ref), t(q), t(k), t(v), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_k5_layouts_and_autograd(dtype):
    """K5 on [N, S, D] and on flash_or_sdpa's [B, heads, S, D] views (its
    output a view of a [B, S, heads, D] buffer); under autograd it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = DTYPES[dtype]
    (qkv,) = _arrays([(8, 49, 3, 2, 72)], seed=18)
    q, k, v = (x.transpose(1, 2) for x in torch.from_numpy(qkv).cuda().to(tdt).unbind(2))
    flat = [x.reshape(16, 49, 72) for x in (q, k, v)]
    for args in ((q, k, v), flat):
        before = window_attention.launches
        out = window_attention(*args)
        torch.cuda.synchronize()
        assert window_attention.launches == before + 1
        _assert_kernel_close(out, window_attention_ref(*args), *args, dtype)
    assert out.shape == (16, 49, 72)
    assert window_attention(q, k, v).transpose(1, 2).is_contiguous()
    with pytest.raises(RuntimeError, match="no backward"):
        window_attention(*(x.detach().requires_grad_() for x in flat))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["k9", "k10"])
def test_k9_k10_run_plain_version_on_cpu(which, dtype):
    """K9 (`window_attention_heads`) and K10 (`window_attention_3d`), the
    bench tool's kernels, run the plain version on CPU tensors (their
    function is K6's: `_attn_batched` of the tool equals the window kernels'
    `_kernel`), launch nothing, and refuse unequal q and kv lengths."""
    fn = window_attention_heads if which == "k9" else window_attention_3d
    q, k, v = (_torch(x, dtype) for x in _arrays([(4, 64, 2, 72)] * 3, seed=20))
    before = fn.launches
    assert torch.equal(fn(q, k, v), window_attention_nshd_ref(q, k, v))
    assert fn.launches == before
    with pytest.raises(ValueError):
        fn(q, k[:, :16], v[:, :16])


def _jax_tool_kernels():
    """`kern_h` and `kern_3d` of the JAX tool `tools/bench_window_flash.py`,
    its own code, with `pl.pallas_call` in interpret mode. Importing the
    tool runs its whole benchmark, so its kernel functions are taken from its
    source and run alone."""
    import ast
    import functools
    import math
    import pathlib
    import types

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "bench_window_flash.py"
    tree = ast.parse(path.read_text())
    keep = {"_attn_batched", "_kern_h", "kern_h", "_kern_3d", "kern_3d"}
    tree.body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in keep]
    interpret = types.SimpleNamespace(BlockSpec=pl.BlockSpec,
                                      pallas_call=functools.partial(pl.pallas_call, interpret=True))
    ns = {"jax": jax, "jnp": jnp, "pl": interpret, "functools": functools, "math": math}
    exec(compile(tree, str(path), "exec"), ns)
    return ns["kern_h"], ns["kern_3d"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["k9", "k10"])
def test_k9_k10_match_jax_tool_kernels(which, dtype):
    """K9 and K10 on CPU tensors (their plain version) against the JAX
    tool's Pallas kernels `kern_h` and `kern_3d` in interpret mode, on the
    same inputs (two window blocks per grid step): fp32 within 2e-5, bf16
    within one ulp of |out| plus 2^-9 (p . |v|) (`_assert_matches`)."""
    kern_h, kern_3d = _jax_tool_kernels()
    jfn, fn = (kern_h, window_attention_heads) if which == "k9" else (kern_3d, window_attention_3d)
    q, k, v = _arrays([(4, 16, 2, 24)] * 3, seed=22)
    want = jfn(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype), 2)
    tq, tk, tv = _torch(q, dtype), _torch(k, dtype), _torch(v, dtype)
    pv = _pv_abs(*(x.transpose(1, 2) for x in (tq, tk, tv))).transpose(1, 2)
    _assert_matches(fn(tq, tk, tv), want, dtype, pv)


def test_bench_tool_runs_on_cpu():
    """The ported bench tool's entry point with `--device cpu`: one row per
    hiera-L window shape, both kernels within the bf16 bound of the plain
    version (here: the plain version itself) and close to the einsum path,
    no times (a CPU run measures no device)."""
    from sam2_opt_tpu_torch.tools import bench_window_flash as bw

    rows = bw.main(["--device", "cpu"])
    assert [(r["N"], r["S"], r["H"], r["D"]) for r in rows] == [s[1:] for s in bw.SHAPES]
    for r in rows:
        assert r["kern_h_within_bound"] and r["kern_3d_within_bound"]
        assert r["kern_h_err_vs_einsum"] < 0.05 and r["kern_3d_err_vs_einsum"] < 0.05
        assert r["kern_h_us"] is None and r["sdpa_us"] is None


@pytest.mark.gpu
@pytest.mark.parametrize("N,S,H,D", [(1024, 64, 2, 72), (1024, 16, 4, 72), (16, 256, 8, 72),
                                     (16, 64, 16, 72)])
def test_cuda_k9_k10_match_ref(N, S, H, D):
    """K9 and K10 at the bench tool's four shapes, bf16, within
    `window_attention_bf16_bound`, one launch each, contiguous output; under
    autograd both raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = (torch.from_numpy(x).cuda().to(torch.bfloat16)
               for x in _arrays([(N, S, H, D)] * 3, seed=21))
    ref = window_attention_nshd_ref(q, k, v)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    for fn in (window_attention_heads, window_attention_3d):
        before = fn.launches
        out = fn(q, k, v)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and out.is_contiguous()
        _assert_kernel_close(t(out), t(ref), t(q), t(k), t(v), "bfloat16")
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q.detach().requires_grad_(), k, v)


@pytest.mark.gpu
def test_cuda_gradients_through_k6_k7():
    """Autograd through K6 and K7 on the card equals autograd through the
    plain version (fp32, 1e-4 of max |g|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, g = (torch.from_numpy(x).cuda() for x in _arrays([(4, 64, 2, 72)] * 4, seed=19))
    for fn in (window_flash_3d, packed_window_attention):
        a = [x.clone().requires_grad_() for x in (q, k, v)]
        b = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(fn(*a), a, g)
        want = torch.autograd.grad(window_attention_nshd_ref(*b), b, g)
        for x, y in zip(got, want):
            assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()
