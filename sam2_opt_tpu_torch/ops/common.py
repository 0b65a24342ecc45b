"""Core numeric primitives of the PyTorch port.

Counterpart of `sam2_opt_tpu/ops/common.py`, in PyTorch's layouts: feature
maps are NCHW outside the Hiera trunk (which works on NHWC tokens, as the
reference trunk does). The JAX package's `linear`, `conv2d` and
`conv_transpose2d` are `nn.Linear`, `nn.Conv2d` and `nn.ConvTranspose2d`
here, with torch's weight layouts ([out, in], OIHW, IOHW), which
`io/weights.py` fills from the JAX layouts. The bf16 path keeps the JAX
package's deliberate departures from fp32: bf16 attention logits, tanh GELU
and one-pass LayerNorm variance.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis (torch nn.LayerNorm semantics).

    fp32 inputs use the exact form. Other dtypes keep the elementwise math in
    the input dtype with fp32 reductions and a one-pass variance, as the JAX
    package's bf16 path does (`sam2_opt_tpu/ops/common.py:44-51`).
    """
    if x.dtype == torch.float32:
        return F.layer_norm(x, x.shape[-1:], weight, bias, eps)
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    w32 = weight.float()
    scale = (rstd * w32).to(x.dtype)
    shift = (bias.float() - mean * rstd * w32).to(x.dtype)
    return x * scale + shift


def layer_norm_2d(x, weight, bias, eps: float = 1e-6):
    """Reference LayerNorm2d (sam2_utils.py:141): normalizes NCHW over C."""
    return layer_norm(x.movedim(1, -1), weight, bias, eps).movedim(-1, 1)


def gelu(x):
    """Exact erf GELU in fp32 (torch nn.GELU default); the tanh form in
    lower precision, as the JAX package's bf16 path does."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return F.gelu(x, approximate="tanh")


def max_pool2d(x, window: Tuple[int, int], stride: Tuple[int, int]):
    """NHWC max pool, ceil_mode=False (torch default)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(0, 2, 3, 1)


def window_partition(x, window_size: int):
    """[B,H,W,C] -> [B*nW, ws, ws, C] with zero padding on the bottom/right
    (reference backbones/utils.py:16-36). Returns (windows, (Hp, Wp))."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    """Inverse of window_partition (reference backbones/utils.py:39-60)."""
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size, window_size, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :]


def interpolate(x, size: Tuple[int, int], method: str = "bilinear", antialias: bool = False):
    """NCHW spatial resize, torch F.interpolate(align_corners=False).

    'nearest' is torch's legacy floor indexing, written out as the JAX
    package does (src = floor(dst * in / out)).
    """
    H, W = x.shape[-2:]
    h, w = size
    if method == "nearest":
        rows = torch.floor(torch.arange(h, device=x.device) * (H / h)).long()
        cols = torch.floor(torch.arange(w, device=x.device) * (W / w)).long()
        return x[..., rows, :][..., cols]
    if method != "bilinear":
        raise ValueError(f"unsupported resize method {method!r}")
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=antialias)


def upsample2x_nearest(x):
    """Exact 2x nearest upsample of NCHW (the FPN top-down path)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def scaled_dot_product_attention(q, k, v, mask=None):
    """torch SDPA semantics on [..., heads, seq, head_dim], written as plain
    matmul + softmax.

    `mask` (optional) is a bool tensor broadcastable to [..., q_len, kv_len],
    True = attend. fp32 inputs keep fp32 logits; bf16 inputs keep bf16 logits
    (the JAX package's default fast-softmax path). Fully masked rows give 0.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if mask is not None:
        probs = torch.nan_to_num(probs, nan=0.0)
    return torch.matmul(probs.to(v.dtype), v)


def use_window_kernel() -> bool:
    """Opt-in per-window attention kernel (K5) for small unmasked windows,
    `SAM2_TPU_WINDOW_KERNEL=1` as in the JAX package (`ops/common.py:232`);
    read at every call."""
    return os.environ.get("SAM2_TPU_WINDOW_KERNEL", "0") == "1"


def flash_or_sdpa(q, k, v, kv_mask=None, min_seq: int = 1024):
    """Dispatch on [B, heads, seq, head_dim]: the hand-written flash kernel
    (K1, differentiable: its backward is K3) for CUDA tensors with q_len *
    kv_len >= min_seq²; else, under `use_window_kernel()`, the window kernel
    (K5) for unmasked attention with q_len == kv_len <= 1024 (its plain
    version on CPU tensors); else plain attention. kv_mask: [B, Skv] bool or
    None."""
    if q.is_cuda and q.shape[-2] * k.shape[-2] >= min_seq * min_seq:
        from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, kv_mask=kv_mask)[0]
    if (kv_mask is None and use_window_kernel()
            and q.shape[-2] == k.shape[-2] <= 1024):
        from sam2_opt_tpu_torch.kernels.window_attention import window_attention

        return window_attention(q, k, v)
    mask = None if kv_mask is None else kv_mask[:, None, None, :]
    return scaled_dot_product_attention(q, k, v, mask=mask)


def separate_heads(x, num_heads: int):
    """[B, N, C] -> [B, heads, N, C/heads]"""
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def recombine_heads(x):
    """[B, heads, N, Ch] -> [B, N, C]"""
    B, H, N, Ch = x.shape
    return x.transpose(1, 2).reshape(B, N, H * Ch)


class GELU(nn.Module):
    """`gelu` as a module, for the activation slots of the reference's
    nn.Sequential stacks."""

    def forward(self, x):
        return gelu(x)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm whose forward is `layer_norm` (bf16 one-pass variance)."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class LayerNorm2d(nn.Module):
    """Reference LayerNorm2d over the channels of NCHW (sam2_utils.py:141)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        return layer_norm_2d(x, self.weight, self.bias, self.eps)


class MLP(nn.Module):
    """Reference MLP (sam2_utils.py:112): a Linear stack with an activation
    between layers; keys `layers.{i}`."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 activation: Callable = F.relu, sigmoid_output: bool = False):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.activation = activation
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class Attention(nn.Module):
    """Reference `Attention` (sam/transformer.py:222): q/k/v projections,
    plain attention, output projection. Inputs [B, N, C]."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1,
                 kv_in_dim: Optional[int] = None):
        super().__init__()
        internal = embedding_dim // downsample_rate
        kv_in_dim = embedding_dim if kv_in_dim is None else kv_in_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(kv_in_dim, internal)
        self.v_proj = nn.Linear(kv_in_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def forward(self, q, k, v):
        q = separate_heads(self.q_proj(q), self.num_heads)
        k = separate_heads(self.k_proj(k), self.num_heads)
        v = separate_heads(self.v_proj(v), self.num_heads)
        out = scaled_dot_product_attention(q, k, v)
        return self.out_proj(recombine_heads(out))
