"""K8, the fused two-layer GELU MLP, in the PyTorch port.

`fused_mlp_ref` (the plain version the wrapper runs on CPU tensors) is held
against the JAX package's Pallas kernel in interpret mode: fp32 at rtol
1e-4 + atol 1e-4 on the shapes of `tests/test_hiera_fast_paths.py:89-90`
(the JAX test's own bound), bf16 with `fast_act` at a ragged token count,
and the gradients of the port's Function against `jax.grad` through the
JAX custom VJP. The port's weights are the JAX ones transposed
(`nn.Linear`'s [out, in]). The `gpu` tests hold the CUDA kernel against its
plain version on the card and skip without one:
`python -m pytest --noconftest -m gpu tests/test_torch_fused_mlp.py`.
"""

import numpy as np
import pytest
import torch

from sam2_opt_tpu_torch.kernels.fused_mlp import fused_mlp, fused_mlp_bf16_bound, fused_mlp_ref

torch.set_num_threads(2)


def _params(n, c, h, c_out=None, seed=5):
    """x [n, c], JAX-layout w1 [c, h], b1, w2 [h, c_out], b2, fp32 numpy."""
    c_out = c if c_out is None else c_out
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in (
        ((n, c), 0.5), ((c, h), 0.05), ((h,), 0.1), ((h, c_out), 0.05), ((c_out,), 0.1))]


def _port(x, w1, b1, w2, b2, dtype=torch.float32):
    """The port's arguments: weights transposed to [out, in]."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    return t(x), t(w1.T), t(b1), t(w2.T), t(b2)


@pytest.mark.parametrize("n,c,h,bh", [(384, 144, 576, 0), (256, 288, 1152, 384), (130, 64, 256, 0)])
def test_ref_matches_jax_kernel_fp32(n, c, h, bh):
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels.fused_mlp import fused_mlp as jax_k8

    args = _params(n, c, h)
    want = jax_k8(*(jnp.asarray(a) for a in args), block_tokens=128, block_hidden=bh,
                  interpret=True)
    got = fused_mlp(*_port(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ref_matches_jax_kernel_bf16_fast_act():
    """bf16, fast_act, N = 203 (not a multiple of the token block) and a
    3-D input: both round h to bf16 before tanh-GELU and g and out to bf16.
    GELU of a bf16 value may differ by one bf16 ulp (torch computes it in
    fp32 and rounds once), which moves out by 2^-8 of |g| . |w2| at most;
    the bound is one ulp of |out| plus that."""
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels.fused_mlp import fused_mlp as jax_k8

    x, w1, b1, w2, b2 = _params(203, 64, 256, seed=6)
    x = x.reshape(7, 29, 64)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = np.asarray(jax_k8(jb(x), jb(w1), jb(b1), jb(w2), jb(b2), block_tokens=64,
                             interpret=True, fast_act=True), np.float32)
    tx, tw1, tb1, tw2, tb2 = _port(x, w1, b1, w2, b2, torch.bfloat16)
    got = fused_mlp(tx, tw1, tb1, tw2, tb2, fast_act=True).float().numpy()
    assert got.shape == (7, 29, 64)
    h = torch.matmul(tx.float(), tw1.float().t()) + tb1.float()
    g_abs = torch.nn.functional.gelu(h, approximate="tanh").abs()
    spread = (2.0 ** -8 * torch.matmul(g_abs, tw2.float().abs().t())).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -40))) - 7)
    err = np.abs(got - want)
    assert (err <= ulp + spread).all(), (err - ulp - spread).max()


def test_gradients_match_jax_custom_vjp():
    """The port's Function on the CPU (plain forward, the JAX `_bwd` in
    torch) against `jax.grad` through the JAX custom VJP, fp32: every
    gradient within 1e-4 of its max |g|; weight gradients come back in
    [out, in]."""
    import jax
    import jax.numpy as jnp

    from sam2_opt_tpu.kernels.fused_mlp import fused_mlp as jax_k8

    args = _params(64, 32, 128, seed=7)
    r = np.random.default_rng(8).standard_normal((64, 32)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_k8(*a, block_tokens=32, interpret=True) * r),
                    argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args))
    ts = [t.requires_grad_() for t in _port(*args)]
    got = torch.autograd.grad(fused_mlp(*ts), ts, torch.from_numpy(r))
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        if i in (1, 3):
            b = b.T
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max(), i


def test_wrapper_runs_ref_on_cpu_and_validates():
    args = _port(*_params(40, 32, 128))
    before = fused_mlp.launches
    assert torch.equal(fused_mlp(*args), fused_mlp_ref(*args))
    assert fused_mlp.launches == before
    x, w1, b1, w2, b2 = args
    with pytest.raises(ValueError):
        fused_mlp(x, w1.t(), b1, w2, b2)
    with pytest.raises(ValueError):
        fused_mlp(x, w1, b1[:-1], w2, b2)
    with pytest.raises(ValueError):
        fused_mlp(x.double(), w1, b1, w2, b2)


# On the card, bf16: the kernel against its plain version within
# `fused_mlp_bf16_bound`.
GPU_SHAPES = [  # N, C (hidden 4C, C_out C): hiera-L and b+ stages, then ragged and edge cases
    (65536, 144), (16384, 288), (4096, 576), (1024, 1152),
    (65536, 112), (16384, 224), (4096, 448), (1024, 896),
    (1000, 144), (77, 72), (130, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("n,c", GPU_SHAPES)
def test_cuda_kernel_matches_ref(n, c):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w1, b1, w2, b2 = (t.cuda() for t in _port(*_params(n, c, 4 * c, seed=9), torch.bfloat16))
    before = fused_mlp.launches
    out = fused_mlp(x, w1, b1, w2, b2, fast_act=True)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    ref = fused_mlp_ref(x, w1, b1, w2, b2, fast_act=True)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= fused_mlp_bf16_bound(x, w1, b1, w2, ref)).all()), err.max().item()


@pytest.mark.gpu
def test_cuda_gradients_and_refusals():
    """Autograd through the kernel equals autograd through the plain version
    (the same backward; bf16, 2e-2 of max |g|); fp32 and fast_act=False raise
    on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [t.cuda() for t in _port(*_params(200, 64, 256, seed=10), torch.bfloat16)]
    a = [t.clone().requires_grad_() for t in args]
    g = torch.randn(200, 64, device="cuda", dtype=torch.bfloat16)
    got = torch.autograd.grad(fused_mlp(*a, fast_act=True), a, g)
    b = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(fused_mlp_ref(*b, fast_act=True), b, g)
    for x, y in zip(got, want):
        assert (x.float() - y.float()).abs().max().item() <= 2e-2 * y.float().abs().max().item()
    with pytest.raises(ValueError):
        fused_mlp(*(t.float() for t in args), fast_act=True)
    with pytest.raises(ValueError):
        fused_mlp(*args, fast_act=False)
