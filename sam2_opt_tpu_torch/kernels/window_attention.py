"""Per-window softmax attention: the CUDA kernel's five wrappers, their
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

The JAX package's window bench tool (`tools/bench_window_flash.py`) has two
more Pallas kernels of K6's function, and the same kernel serves them too
(the design of K5-K7, three wrappers over one kernel, now five), run by
the tool's port `sam2_opt_tpu_torch.tools.bench_window_flash`:
- K9, `window_attention_heads` (`_kern_h`): `[N, S, heads, d]`, heads a
  stride of the launch;
- K10, `window_attention_3d` (`_kern_3d`): the same after contiguous copies
  to `[N * heads, S, d]` and back, as the tool's transposes do.
Neither has a gradient (the tool defines no VJP).

Numerics (the Pallas kernels' `_kernel`, :25-40): logits q.k in fp32 times
1/sqrt(D), minus the row max, exponentiated, divided by the row sum; p
rounded to v's dtype; p.v in fp32, rounded to q's dtype. No masking: the
zero-padded tokens of `window_partition` attend, as in the JAX package.

Each wrapper checks its arguments and calls an operator of the same name
in the `sam2_opt_tpu_torch` namespace (`_build.operator`), which
`torch.export` traces as one node: on a CUDA tensor it launches the kernel
(and counts the launch) or raises; on a CPU tensor it runs
`window_attention_ref`, its output laid out as the kernel's. K6 and K7 are
differentiable: their operators' backward is the JAX `_packed_vjp_bwd`
(:230-244, an XLA recompute there) in plain torch. K5, K9 and K10 under
autograd raise on the card and run the plain version on the CPU.
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


def _nshd_cuda(q, k, v, wrapper, what):
    """K6/K7/K9 on [N, S, heads, d] CUDA tensors: out [N, Sq, heads, d]
    contiguous."""
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


def _nshd_operator(name, wrapper, differentiable):
    """The operator `sam2_opt_tpu_torch::<name>` on [N, S, heads, d]: the
    plain version on the CPU (contiguous, as the kernel writes it), the
    kernel on the card counted on `wrapper`; K6 and K7 (`differentiable`)
    with the plain recompute backward (the JAX custom VJPs
    `_window_flash_3d_vjp` and `packed_window_attention`)."""
    @_build.operator(name, "(Tensor q, Tensor k, Tensor v) -> Tensor")
    def op(q, k, v):
        return window_attention_nshd_ref(q, k, v).contiguous()

    op.register_kernel("cuda")(lambda q, k, v: _nshd_cuda(q, k, v, wrapper, name))
    op.register_fake(lambda q, k, v: torch.empty_like(q, memory_format=torch.contiguous_format))
    if differentiable:
        def save(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        op.register_autograd(lambda ctx, dout: _packed_vjp_bwd(*ctx.saved_tensors, dout),
                             setup_context=save)
    return op


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
    return _window_flash_3d_op(q, k, v)


window_flash_3d.launches = 0
_window_flash_3d_op = _nshd_operator("window_flash_3d", window_flash_3d, differentiable=True)


def packed_window_attention(q, k, v):
    """K7: q [N, Sq, heads, d], k/v [N, Skv, heads, d] -> [N, Sq, heads, d];
    Sq may differ from Skv. Differentiable, as K6."""
    _check_nshd(q, k, v, "packed_window_attention", same_len=False)
    return _packed_window_op(q, k, v)


packed_window_attention.launches = 0
_packed_window_op = _nshd_operator("packed_window_attention", packed_window_attention,
                                   differentiable=True)


def _no_backward(q, k, v, what):
    """True where autograd needs the gradient of a kernel that has none
    (K5, K9, K10): on the card that raises, on the CPU the caller runs the
    plain version, which is differentiable."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return False
    if q.device.type == "cuda":
        raise RuntimeError(f"{what} has no backward, as in the JAX package")
    return True


def window_attention(q, k, v):
    """K5: q/k/v [N, S, D] or [B, heads, S, D] (unit stride along D, any
    other strides), one window length for q and kv -> out in q's layout. A
    4-D out is a [B, heads, S, D] view of a [B, S, heads, D] buffer, so the
    caller's merge of heads back into channels costs no copy.

    Not differentiable, as in the JAX package: on a CUDA tensor under
    autograd it raises (use window_flash_3d or packed_window_attention
    under autograd); on the CPU under autograd the plain version runs."""
    _check(q, k, v, "window_attention")
    if q.dim() not in (3, 4) or q.shape != k.shape:
        raise ValueError("window_attention: q, k and v must be [N, S, D] or [B, heads, S, D] "
                         f"of one shape, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if _no_backward(q, k, v, "window_attention (K5)"):
        return window_attention_ref(q, k, v)
    return _window_attention_op(q, k, v)


def _window_attention_layout(out):
    """K5's output layout: contiguous [N, S, D], or a [B, heads, S, D] view
    of a [B, S, heads, D] buffer."""
    return out.contiguous() if out.dim() == 3 else out.transpose(1, 2).contiguous().transpose(1, 2)


@_build.operator("window_attention", "(Tensor q, Tensor k, Tensor v) -> Tensor")
def _window_attention_op(q, k, v):
    return _window_attention_layout(window_attention_ref(q, k, v))


@_window_attention_op.register_kernel("cuda")
def _window_attention_cuda(q, k, v):
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
_window_attention_op.register_fake(lambda q, k, v: _window_attention_layout(torch.empty_like(q)))


def window_attention_heads(q, k, v):
    """K9 (the bench tool's `_kern_h`): q/k/v [N, S, heads, d], one window
    length for q and kv, unit stride along d -> out [N, S, heads, d],
    contiguous. The TPU kernel looped over heads inside a block of windows;
    here the heads are a stride of the same launch. Not differentiable: on a
    CUDA tensor under autograd it raises."""
    _check_nshd(q, k, v, "window_attention_heads", same_len=True)
    if _no_backward(q, k, v, "window_attention_heads (K9)"):
        return window_attention_nshd_ref(q, k, v)
    return _window_heads_op(q, k, v)


window_attention_heads.launches = 0
_window_heads_op = _nshd_operator("window_attention_heads", window_attention_heads,
                                  differentiable=False)


def window_attention_3d(q, k, v):
    """K10 (the bench tool's `_kern_3d`): q/k/v [N, S, heads, d] -> out
    [N, S, heads, d]. As the tool's XLA transposes do (:96, :105), q, k and v
    are copied to contiguous [N * heads, S, d] first, the kernel runs on that
    layout, and its output is copied back to [N, S, heads, d]. Not
    differentiable: on a CUDA tensor under autograd it raises."""
    _check_nshd(q, k, v, "window_attention_3d", same_len=True)
    if _no_backward(q, k, v, "window_attention_3d (K10)"):
        return window_attention_nshd_ref(q, k, v)
    return _window_3d_op(q, k, v)


@_build.operator("window_attention_3d", "(Tensor q, Tensor k, Tensor v) -> Tensor")
def _window_3d_op(q, k, v):
    return window_attention_nshd_ref(q, k, v).contiguous()


@_window_3d_op.register_kernel("cuda")
def _window_3d_cuda(q, k, v):
    N, S, H, D = q.shape
    flat = [t.transpose(1, 2).reshape(N * H, S, D) for t in (q, k, v)]
    out = torch.empty_like(flat[0])
    launch_3d(*flat, out)
    window_attention_3d.launches += 1
    return out.view(N, H, S, D).transpose(1, 2).contiguous()


window_attention_3d.launches = 0
_window_3d_op.register_fake(lambda q, k, v: torch.empty_like(q, memory_format=torch.contiguous_format))


def launch_3d(q, k, v, out):
    """K10's kernel alone on [N * heads, S, d] tensors (16-byte aligned
    rows), into `out`; counts nothing (the bench tool times it)."""
    M, S, D = q.shape
    sd = lambda t: (t.stride(0), 0, t.stride(1))  # noqa: E731  (window, head, row)
    _launch(q, k, v, out, ((M, 1, S, S, D), sd(q), sd(k), sd(v), sd(out)), "window_attention_3d")
