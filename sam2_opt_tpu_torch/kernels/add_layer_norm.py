"""Residual add + LayerNorm of the Hiera block, with the window partition
and unpartition folded in: the CUDA kernel's wrapper, its plain version and
the operator that joins them.

It replaces no TPU kernel: the JAX package leaves this chain to XLA, which
fuses it into one pass. The bf16 trunk runs it in inference
(`models/hiera.py::MultiScaleBlock`) twice a block: at the block's entry
(norm1, its output in window order) and after the attention (its output
gathered from window order, the residual add, norm2).

`add_layer_norm` calls the operator `sam2_opt_tpu_torch::add_layer_norm`
(`_build.operator`), which `torch.export` traces as one node: on a CUDA
tensor it launches `csrc/add_layer_norm.cu` (bf16 only) or raises; on a CPU
tensor it runs `add_layer_norm_ref`, which is the eager chain itself
(`ops.window_unpartition`, the add, `ops.layer_norm`, `ops.window_partition`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from sam2_opt_tpu_torch.kernels import _build
from sam2_opt_tpu_torch.ops import common as ops

MAX_C = 1280  # five 16-byte vectors a lane of the row's warp (Hiera's widest stage: 1152)


def window_grid(ws: int, H: int, W: int) -> Tuple[int, int, int]:
    """(ws, Hp, Wp): ws x ws windows over H x W padded up to multiples of ws
    (`ops.window_partition`'s padding); () for ws 0, raster order."""
    return (ws, H + (-H) % ws, W + (-W) % ws) if ws > 0 else ()


def add_layer_norm_ref(residual, delta, weight, bias, eps: float,
                       delta_window: Sequence[int] = (), out_window: Sequence[int] = ()):
    """The eager chain: (sum, normed). residual [B, H, W, C]; delta None, or
    [B, H, W, C], or in window order [B * nW, ws, ws, C] where
    `delta_window` = (ws, Hp, Wp); sum = residual + delta (residual where
    delta is None); normed = `ops.layer_norm(sum)`, in window order (padded
    rows zero) where `out_window` = (ws, Hp, Wp)."""
    H, W = residual.shape[1], residual.shape[2]
    x = residual
    if delta is not None:
        if delta_window:
            ws, Hp, Wp = delta_window
            delta = ops.window_unpartition(delta, ws, (Hp, Wp), (H, W))
        x = residual + delta
    normed = ops.layer_norm(x, weight, bias, eps)
    if out_window:
        normed, _ = ops.window_partition(normed, out_window[0])
    return x, normed


def _check_windows(name, window, H, W):
    if not window:
        return
    if len(window) != 3 or tuple(window) != window_grid(window[0], H, W):
        raise ValueError(f"add_layer_norm: {name} {tuple(window)} is not (ws, Hp, Wp) over "
                         f"{H}x{W} tokens")


def _normed_shape(residual, out_window):
    B, H, W, C = residual.shape
    if out_window:
        ws, Hp, Wp = out_window
        return (B * (Hp // ws) * (Wp // ws), ws, ws, C)
    return (B, H, W, C)


def _library():
    """sam2_add_layer_norm_bf16: residual, delta, weight, bias, sum, normed,
    B, H, W, C, delta's (ws, Hp, Wp), normed's (ws, Hp, Wp), eps, stream."""
    fn = _build.load("add_layer_norm").sam2_add_layer_norm_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 10 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


@_build.operator("add_layer_norm", "(Tensor residual, Tensor? delta, Tensor weight, Tensor bias, "
                                   "float eps, int[] delta_window, int[] out_window) "
                                   "-> (Tensor, Tensor)")
def _add_layer_norm_op(residual, delta, weight, bias, eps, delta_window, out_window):
    x, normed = add_layer_norm_ref(residual, delta, weight, bias, eps, delta_window, out_window)
    # an operator's output may not alias its input: without delta the sum is
    # the residual, which the wrapper hands back in the empty output's place
    return (x if delta is not None else residual.new_empty(0)), normed


@_add_layer_norm_op.register_kernel("cuda")
def _add_layer_norm_cuda(residual, delta, weight, bias, eps, delta_window, out_window):
    ts = (residual, weight, bias) + ((delta,) if delta is not None else ())
    if any(t.dtype != torch.bfloat16 for t in ts):
        raise ValueError("add_layer_norm: the kernel runs bf16 (residual, delta, weight and bias), "
                         f"got {[t.dtype for t in ts]}")
    B, H, W, C = residual.shape
    if C % 8 or C > MAX_C:
        raise ValueError(f"add_layer_norm: C {C} must be a multiple of 8, at most {MAX_C}")
    residual = residual.contiguous()
    weight, bias = weight.contiguous(), bias.contiguous()
    d = tuple(delta_window) or (0, 0, 0)
    if delta is not None:
        delta = delta.contiguous()
        if delta.numel() != (B * d[1] * d[2] * C if delta_window else residual.numel()):
            raise ValueError(f"add_layer_norm: delta {tuple(delta.shape)} against residual "
                             f"{tuple(residual.shape)}, delta_window {tuple(delta_window)}")
    o = tuple(out_window) or (0, 0, 0)
    total = torch.empty((B, H, W, C), dtype=residual.dtype, device=residual.device) \
        if delta is not None else residual.new_empty(0)
    normed = residual.new_empty(_normed_shape(residual, out_window))
    with torch.cuda.device(residual.device):
        stream = torch.cuda.current_stream(residual.device).cuda_stream
        err = _library()(
            residual.data_ptr(), delta.data_ptr() if delta is not None else None,
            weight.data_ptr(), bias.data_ptr(), total.data_ptr() if delta is not None else None,
            normed.data_ptr(), B, H, W, C, *d, *o, eps, stream)
    if err != 0:
        raise RuntimeError(f"add_layer_norm kernel launch failed: cudaError {err}")
    add_layer_norm.launches += 1
    return total, normed


@_add_layer_norm_op.register_fake
def _add_layer_norm_fake(residual, delta, weight, bias, eps, delta_window, out_window):
    total = residual.new_empty(residual.shape) if delta is not None else residual.new_empty(0)
    return total, residual.new_empty(_normed_shape(residual, out_window))


def add_layer_norm(residual, delta: Optional[torch.Tensor], weight, bias, eps: float,
                   delta_window: Sequence[int] = (), out_window: Sequence[int] = ()):
    """(sum, normed) as `add_layer_norm_ref`; without delta, sum is
    `residual` itself. Windows are (ws, Hp, Wp) from `window_grid`. Not
    differentiable: the trunk takes it only without grad."""
    if residual.dim() != 4:
        raise ValueError(f"add_layer_norm: residual {tuple(residual.shape)} is not [B, H, W, C]")
    H, W, C = residual.shape[1:]
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"add_layer_norm: weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)} for C {C}")
    _check_windows("delta_window", delta_window, H, W)
    _check_windows("out_window", out_window, H, W)
    if delta_window and delta is None:
        raise ValueError("add_layer_norm: delta_window without delta")
    total, normed = _add_layer_norm_op(residual, delta, weight, bias, float(eps),
                                       list(delta_window), list(out_window))
    return (residual if delta is None else total), normed


add_layer_norm.launches = 0
