"""Positional encodings: 2-D sine PE, random-Fourier PE, 1-D sine PE and
axial RoPE.

Counterpart of `sam2_opt_tpu/ops/posenc.py`, numerically matching the
reference position_encoding_fix.py and sam2_utils.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sine_pos_embed_2d(h: int, w: int, num_pos_feats: int, temperature: float = 10000.0,
                      normalize: bool = True, scale: float | None = None,
                      device=None) -> torch.Tensor:
    """2-D sine positional embedding, returns [H, W, C] (channels-last).

    Matches reference PositionEmbeddingSine.forward
    (position_encoding_fix.py:79-112): 1-indexed row/col positions normalized
    by the last position, interleaved sin/cos per axis, y-half first.
    """
    half = num_pos_feats // 2
    if scale is None:
        scale = 2 * math.pi
    y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / half)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()], dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


def random_fourier_encode(gaussian_matrix, coords):
    """Random-Fourier features for coords normalized to [0,1]
    (reference PositionEmbeddingRandom._pe_encoding, position_encoding_fix.py:129)."""
    coords = 2.0 * coords - 1.0
    coords = coords @ gaussian_matrix.to(coords.dtype)
    coords = 2.0 * math.pi * coords
    return torch.cat([coords.sin(), coords.cos()], dim=-1)


def random_fourier_grid(gaussian_matrix, h: int, w: int):
    """Dense PE grid [H, W, C] (reference PositionEmbeddingRandom.forward)."""
    dev = gaussian_matrix.device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    grid = torch.stack(torch.meshgrid(x, y, indexing="xy"), dim=-1)  # [H, W, 2] (x, y)
    return random_fourier_encode(gaussian_matrix, grid)


def get_1d_sine_pe(pos_inds, dim: int, temperature: float = 10000.0):
    """1-D sine PE (reference sam2_utils.py:64): cat(sin, cos), not
    interleaved. pos_inds [...] -> [..., dim] fp32."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos_inds.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / pe_dim)
    pos = pos_inds[..., None].float() / dim_t
    return torch.cat([pos.sin(), pos.cos()], dim=-1)


def axial_rope_cos_sin(dim: int, end_x: int, end_y: int, theta: float = 10000.0):
    """Axial RoPE tables [end_x*end_y, dim] fp32 on the CPU (reference
    position_encoding_fix.py:166-183). Row-major token order: t_x = t % end_x,
    t_y = t // end_x; the first half of the channels carries x-frequencies.
    Computed in numpy float32 as the JAX package does, so the tables are the
    same numbers."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(end_x * end_y, dtype=np.float32)
    freqs_all = np.concatenate([np.outer(t % end_x, freqs), np.outer(np.floor(t / end_x), freqs)],
                               axis=-1)
    return torch.from_numpy(np.cos(freqs_all)), torch.from_numpy(np.sin(freqs_all))


def apply_rotary(x, cos, sin):
    """Rotate interleaved (even, odd) channel pairs (reference
    position_encoding_fix.py:192-205). x [..., seq, dim]; cos/sin [seq, dim]
    of which only the even columns are used."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[..., 0::2], sin[..., 0::2]
    return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)


def rope_half_tables(dim: int, end_x: int, end_y: int, theta: float = 10000.0):
    """Per-pair RoPE tables [N, dim/2] for the split channel layout: the even
    columns of `axial_rope_cos_sin`'s tables."""
    cos, sin = axial_rope_cos_sin(dim, end_x, end_y, theta)
    return cos[:, 0::2].contiguous(), sin[:, 0::2].contiguous()


def split_perm(head_dim: int, num_heads: int = 1) -> torch.Tensor:
    """Channel permutation from the interleaved pair layout (x0, y0, x1, y1,
    ...) to the split layout (x0, x1, ..., y0, y1, ...), per head. Applied to
    the output channels of the q and k projections alike, it leaves q . k^T
    unchanged and makes the rotation two contiguous half-width operations."""
    base = torch.cat([torch.arange(0, head_dim, 2), torch.arange(1, head_dim, 2)])
    return torch.cat([h * head_dim + base for h in range(num_heads)])


def apply_rotary_split(x, cos_half, sin_half):
    """Rotation in the split layout: x [..., seq, dim] whose first dim/2
    channels are the pairs' first halves (see `split_perm`); cos/sin
    [seq, dim/2]. Each output is x1*c - x2*s or x1*s + x2*c, rounded once
    per operation in x's dtype."""
    d_half = cos_half.shape[-1]
    x1, x2 = x[..., :d_half], x[..., d_half:2 * d_half]
    out = torch.cat([x1 * cos_half - x2 * sin_half, x1 * sin_half + x2 * cos_half], dim=-1)
    if x.shape[-1] > 2 * d_half:
        out = torch.cat([out, x[..., 2 * d_half:]], dim=-1)
    return out
