"""Fused two-layer GELU MLP (K8): the CUDA kernel's wrapper, its plain
version and the autograd Function that joins them.

The port of `sam2_opt_tpu/kernels/fused_mlp.py` (`_kernel`, :40): y =
gelu_tanh(x . w1 + b1) . w2 + b2 with the hidden activation kept on the SM
(`csrc/fused_mlp.cu`), routed from the Hiera block MLPs under
`SAM2_TPU_FUSED_MLP=1` in bf16. The weights keep `nn.Linear`'s [out, in]
layout: w1 [H, C], w2 [C_out, H] (the JAX package's are [in, out]).

On a CUDA tensor `fused_mlp` launches the kernel (bf16 only; fp32 raises) or
raises; on a CPU tensor it runs `fused_mlp_ref`. It is differentiable
through `_FusedMLP`, whose backward is the JAX `_bwd` (:142-166, an XLA
recompute there) in plain torch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sam2_opt_tpu_torch.kernels import _build

MAX_OUT = 1152  # the widest output the kernel keeps in registers (hiera-L stage 4)


def _gelu_tanh(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def fused_mlp_ref(x, w1, b1, w2, b2, fast_act: bool = False):
    """Plain form with the kernel's numerics (the JAX `_kernel`, :48-66):
    h = fp32(x . w1^T) + fp32(b1); with `fast_act` h is rounded to x's dtype
    before tanh-GELU and the result is in x's dtype, else GELU runs in fp32
    and is rounded after (`_reference_mlp`, :111-124); out = fp32(g . w2^T)
    + fp32(b2), rounded to x's dtype."""
    h = torch.matmul(x.float(), w1.float().t()) + b1.float()
    g = _gelu_tanh(h.to(x.dtype)) if fast_act else _gelu_tanh(h).to(x.dtype)
    return (torch.matmul(g.float(), w2.float().t()) + b2.float()).to(x.dtype)


def _gelu_tanh_grad(h):
    k0, k1 = math.sqrt(2.0 / math.pi), 0.044715
    t = torch.tanh(k0 * (h + k1 * h ** 3))
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * k0 * (1.0 + 3.0 * k1 * h * h)


def _fused_mlp_bwd(x, w1, b1, w2, dy):
    """The JAX `_bwd` in plain torch on 2-D x [N, C] (its activation in
    fp32 whatever `fast_act` was): gradients of x, w1, b1, w2, b2 in their
    own dtypes, weights in [out, in]."""
    h = torch.matmul(x.float(), w1.float().t()) + b1.float()
    g = _gelu_tanh(h).to(x.dtype)
    dg = torch.matmul(dy.float(), w2.float())
    dh = dg * _gelu_tanh_grad(h)
    dhc = dh.to(x.dtype)
    dx = torch.matmul(dhc.float(), w1.float()).to(x.dtype)
    dw1 = torch.matmul(dhc.float().t(), x.float()).to(w1.dtype)
    dw2 = torch.matmul(dy.float().t(), g.float()).to(w2.dtype)
    return dx, dw1, dh.sum(0).to(b1.dtype), dw2, dy.float().sum(0).to(w2.dtype)


def fused_mlp_bf16_bound(x, w1, b1, w2, ref):
    """Per-element bound on |kernel - plain version| for bf16 inputs with
    fast_act. Both sum the same exact products in fp32 in other orders, so
    a rounding of h or g to bf16 may land one ulp (at most 2^-7 relative)
    apart: g then moves by at most 2^-7 (|g| + |h gelu'(h)|), which reaches
    the output through |w2|; and out, rounded to the nearest bf16 on each
    side, may land one ulp apart. So |out - ref| <= 2^-7 ((|g| + |h
    gelu'(h)|) . |w2|^T + |ref|), h and g in fp32."""
    h = torch.matmul(x.float(), w1.float().t()) + b1.float()
    e = _gelu_tanh(h).abs() + (h * _gelu_tanh_grad(h)).abs()
    return 2.0 ** -7 * (torch.matmul(e, w2.float().abs().t()) + ref.float().abs())


def _library():
    """sam2_fused_mlp_fwd: x, w1, b1, w2, b2, out, N, C, H, C_out, 4 row
    strides (x, w1, w2, out), stream."""
    fn = _build.load("fused_mlp").sam2_fused_mlp_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 6 + [i] * 4 + [ll] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


def _forward_2d(x, w1, b1, w2, b2, fast_act):
    if x.device.type == "cpu":
        return fused_mlp_ref(x, w1, b1, w2, b2, fast_act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or not fast_act:
        raise ValueError("fused_mlp: the kernel runs bf16 with fast_act=True (the route's "
                         f"numerics), got {x.dtype}, fast_act={fast_act}")
    N, C = x.shape
    H, C_out = w1.shape[0], w2.shape[0]
    if C % 8 or H % 8 or C_out % 8 or C_out > MAX_OUT:
        raise ValueError(f"fused_mlp: C {C}, H {H}, C_out {C_out} must be multiples of 8, "
                         f"C_out at most {MAX_OUT}")
    if x.stride(-1) != 1 or x.stride(0) % 8 or x.data_ptr() % 16:
        # the kernel reads x in 16-byte row chunks
        x = x.clone(memory_format=torch.contiguous_format)
    for name, t in (("w1", w1), ("w2", w2)):
        if t.stride(-1) != 1 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"fused_mlp: {name} rows must be unit-stride and 16-byte aligned")
    b1, b2 = b1.contiguous(), b2.contiguous()
    out = torch.empty((N, C_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library()(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), N, C, H, C_out, x.stride(0), w1.stride(0), w2.stride(0),
            out.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: cudaError {err}")
    fused_mlp.launches += 1
    return out


class _FusedMLP(torch.autograd.Function):
    """K8 forward, the plain recompute backward (the JAX `_fused_mlp_core`
    custom VJP)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, fast_act):
        ctx.save_for_backward(x, w1, b1, w2)
        return _forward_2d(x, w1, b1, w2, b2, fast_act)

    @staticmethod
    def backward(ctx, dy):
        return (*_fused_mlp_bwd(*ctx.saved_tensors, dy), None)


def fused_mlp(x, w1, b1, w2, b2, fast_act: bool = False):
    """x [..., C], w1 [H, C], b1 [H], w2 [C_out, H], b2 [C_out] -> [...,
    C_out], as `fused_mlp_ref`; differentiable in every tensor. One dtype and
    device for all five."""
    if w1.dim() != 2 or w2.dim() != 2 or w1.shape[1] != x.shape[-1] or w2.shape[1] != w1.shape[0]:
        raise ValueError(f"fused_mlp: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if b1.shape != (w1.shape[0],) or b2.shape != (w2.shape[0],):
        raise ValueError(f"fused_mlp: biases {tuple(b1.shape)}, {tuple(b2.shape)}")
    ts = (x, w1, b1, w2, b2)
    if len({t.dtype for t in ts}) != 1 or len({t.device for t in ts}) != 1:
        raise ValueError("fused_mlp: x, weights and biases must share one dtype and device")
    out = _FusedMLP.apply(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, fast_act)
    return out.reshape(*x.shape[:-1], w2.shape[0])


fused_mlp.launches = 0
