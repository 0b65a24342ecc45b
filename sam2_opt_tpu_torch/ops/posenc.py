"""Positional encodings: 2-D sine PE and random-Fourier PE.

Counterpart of `sam2_opt_tpu/ops/posenc.py:18-77`, numerically matching the
reference position_encoding_fix.py. Axial RoPE arrives with the video slice.
"""

from __future__ import annotations

import math

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
