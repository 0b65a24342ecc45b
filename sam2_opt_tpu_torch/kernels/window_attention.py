"""Per-window softmax attention: the CUDA kernel's three wrappers, their
plain version and the autograd Function of the two differentiable ones.

The JAX package has three Pallas kernels for Hiera's windowed attention
(`sam2_opt_tpu/kernels/window_attention.py`), one function in three TPU
layouts. Here one hand-written kernel (`csrc/window_attention.cu`) serves
all three, the layout passed as strides:
- K5, `window_attention`: `[N, S, D]` (or `[B, heads, S, D]`), routed from
  `ops.flash_or_sdpa` under `SAM2_TPU_WINDOW_KERNEL=1`; no gradient, as in
  the JAX package;
- K6, `window_flash_3d`: `[N, S, heads, d]`, from the split-qkv window route;
- K7, `packed_window_attention`: q `[N, Sq, heads, d]`, k/v `[N, Skv, heads,
  d]`, from the packed window route. On the TPU it packed windows
  block-diagonally to shape the MXU's products; its function is K6's.

Numerics (the Pallas kernels' `_kernel`, :25-40): logits q.k in fp32 times
1/sqrt(D), minus the row max, exponentiated, divided by the row sum; p
rounded to v's dtype; p.v in fp32, rounded to q's dtype. No masking: the
zero-padded tokens of `window_partition` attend, as in the JAX package.

On a CUDA tensor each wrapper launches the kernel or raises; on a CPU tensor
it runs `window_attention_ref`. K6 and K7 are differentiable through
`_WindowAttention`, whose backward is the JAX `_packed_vjp_bwd` (:230-244, an
XLA recompute there) in plain torch. K5 under autograd on the card raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sam2_opt_tpu_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TOKENS = 1024  # K5's gate (`ops/common.py:255` in the JAX package)


def window_attention_ref(q, k, v):
    """Plain per-window attention on [..., S, D] (leading dims are
    independent windows and heads), with the kernels' numerics."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def window_attention_nshd_ref(q, k, v):
    """`window_attention_ref` on K6's and K7's [N, S, heads, d] layout."""
    return window_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2)).transpose(1, 2)


def window_attention_bf16_bound(q, k, v, ref):
    """Per-element bound on |kernel - plain version| for bf16 inputs on the
    [..., S, D] layout. Both round the normalized p to bf16 from fp32 values
    that may differ in their last bits, so a p may land one bf16 ulp (at most
    2^-7 of |p|) apart, and both round out to the nearest bf16, which may
    land one ulp apart: |out - ref| <= 2^-7 (p . |v| + |ref|), p the fp32
    softmax."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    return 2.0 ** -7 * (torch.matmul(torch.softmax(s, -1), v.float().abs()) + ref.float().abs())


def _check(q, k, v, what):
    if not (q.dim() == k.dim() == v.dim()):
        raise ValueError(f"{what}: q, k and v must have one rank")
    if k.shape != v.shape:
        raise ValueError(f"{what}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: dtypes must all be float32 or bfloat16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k and v must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")


def _library():
    """sam2_window_attention_fwd: q, k, v, out, dtype, N, H, Sq, Skv, D, 12
    strides (window, head, row for q, k, v, out), scale, stream."""
    fn = _build.load("window_attention").sam2_window_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 4 + [i] * 6 + [ll] * 12 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, out, strides, what):
    """One launch on [N, H, S, D] problems given by (window, head, row)
    strides of q, k, v and out; raises on a refused launch. `strides` is
    ((N, H, Sq, Skv, D), q_strides, k_strides, v_strides, out_strides)."""
    (N, H, Sq, Skv, D), *tensor_strides = strides
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"{what}: head dim {D} unsupported on the card (a multiple of 8 up to 128)")
    if Sq > MAX_TOKENS or Skv > MAX_TOKENS or Sq < 1 or Skv < 1:
        raise ValueError(f"{what}: windows of {Sq} x {Skv} tokens (1 to {MAX_TOKENS} each)")
    per_chunk = 8 if q.dtype == torch.bfloat16 else 4  # elements in 16 bytes
    for name, t, st in zip("qkvo", (q, k, v, out), tensor_strides):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must have unit stride along the head dim")
        # the kernel copies rows in 16-byte chunks
        if t.data_ptr() % 16 or any(s % per_chunk for s in st):
            raise ValueError(f"{what}: {name} rows must be 16-byte aligned")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         _DTYPES[q.dtype], N, H, Sq, Skv, D,
                         *(s for st in tensor_strides for s in st), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _nshd_forward(q, k, v, wrapper, what):
    """K6/K7 forward on [N, S, heads, d]: the kernel on CUDA tensors (out
    [N, Sq, heads, d] contiguous), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_nshd_ref(q, k, v)
    N, Sq, H, D = q.shape
    out = torch.empty((N, Sq, H, D), dtype=q.dtype, device=q.device)
    sd = lambda t: (t.stride(0), t.stride(2), t.stride(1))  # noqa: E731  (window, head, row)
    _launch(q, k, v, out, ((N, H, Sq, k.shape[1], D), sd(q), sd(k), sd(v), sd(out)), what)
    wrapper.launches += 1
    return out


def _packed_vjp_bwd(q, k, v, do):
    """The JAX `_packed_vjp_bwd` in plain torch: the exact softmax-recompute
    backward in fp32 on [N, S, heads, d], gradients in the inputs' dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", qf, kf) * scale, dim=-1)
    dp = torch.einsum("nqhd,nkhd->nhqk", dof, vf)
    dv = torch.einsum("nhqk,nqhd->nkhd", p, dof)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, kf) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _WindowAttention(torch.autograd.Function):
    """K6 or K7 forward, the plain recompute backward (the JAX custom VJPs
    `_window_flash_3d_vjp` and `packed_window_attention`)."""

    @staticmethod
    def forward(ctx, q, k, v, wrapper, what):
        ctx.save_for_backward(q, k, v)
        return _nshd_forward(q, k, v, wrapper, what)

    @staticmethod
    def backward(ctx, dout):
        return (*_packed_vjp_bwd(*ctx.saved_tensors, dout), None, None)


def _check_nshd(q, k, v, what, same_len):
    _check(q, k, v, what)
    if q.dim() != 4:
        raise ValueError(f"{what}: q, k and v must be [N, S, heads, head_dim]")
    N, Sq, H, D = q.shape
    if k.shape[0] != N or k.shape[2:] != (H, D) or (same_len and k.shape[1] != Sq):
        raise ValueError(f"{what}: shape mismatch q {tuple(q.shape)}, k {tuple(k.shape)}")


def window_flash_3d(q, k, v):
    """K6: q/k/v [N, S, heads, d] (unit stride along d, any other strides,
    e.g. views of one [N, S, 3, heads, d] projection) -> out [N, S, heads,
    d], contiguous, so the output projection reads it without a copy.
    Differentiable (backward: `_packed_vjp_bwd`)."""
    _check_nshd(q, k, v, "window_flash_3d", same_len=True)
    return _WindowAttention.apply(q, k, v, window_flash_3d, "window_flash_3d")


window_flash_3d.launches = 0


def packed_window_attention(q, k, v):
    """K7: q [N, Sq, heads, d], k/v [N, Skv, heads, d] -> [N, Sq, heads, d];
    Sq may differ from Skv. Differentiable, as K6."""
    _check_nshd(q, k, v, "packed_window_attention", same_len=False)
    return _WindowAttention.apply(q, k, v, packed_window_attention, "packed_window_attention")


packed_window_attention.launches = 0


def window_attention(q, k, v):
    """K5: q/k/v [N, S, D] or [B, heads, S, D] (unit stride along D, any
    other strides), one window length for q and kv -> out in q's layout. A
    4-D out is a [B, heads, S, D] view of a [B, S, heads, D] buffer, so the
    caller's merge of heads back into channels costs no copy.

    Not differentiable, as in the JAX package: on a CUDA tensor under
    autograd it raises (its plain version, on the CPU, is differentiable)."""
    _check(q, k, v, "window_attention")
    if q.dim() not in (3, 4) or q.shape != k.shape:
        raise ValueError("window_attention: q, k and v must be [N, S, D] or [B, heads, S, D] "
                         f"of one shape, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return window_attention_ref(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("window_attention (K5) has no backward, as in the JAX package; "
                           "use window_flash_3d or packed_window_attention under autograd")
    if q.dim() == 3:
        N, S, D = q.shape
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        sd = lambda t: (t.stride(0), 0, t.stride(1))  # noqa: E731
        H = 1
    else:
        N, H, S, D = q.shape
        out = torch.empty((N, S, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
        sd = lambda t: (t.stride(0), t.stride(1), t.stride(2))  # noqa: E731
    _launch(q, k, v, out, ((N, H, S, S, D), sd(q), sd(k), sd(v), sd(out)), "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0
