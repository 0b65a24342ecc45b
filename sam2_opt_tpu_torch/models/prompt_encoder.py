"""SAM prompt encoder.

Counterpart of `sam2_opt_tpu/models/prompt_encoder.py`; module and parameter
names follow the reference sam2/sam2/modeling/sam/prompt_encoder.py:19-246.
Point prompts are random-Fourier PE plus label-conditional learned
embeddings; mask prompts go through the small downscaling conv stack.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.ops import common as ops
from sam2_opt_tpu_torch.ops import posenc


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        C, mc = cfg.hidden_dim, cfg.mask_in_chans
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(C // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, C) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, C)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, 2), ops.LayerNorm2d(mc // 4), ops.GELU(),
            nn.Conv2d(mc // 4, mc, 2, 2), ops.LayerNorm2d(mc), ops.GELU(),
            nn.Conv2d(mc, C, 1),
        )
        self.no_mask_embed = nn.Embedding(1, C)

    @property
    def _gaussian(self):
        return self.pe_layer.positional_encoding_gaussian_matrix

    def embed_points(self, coords, labels, input_image_size: Tuple[int, int], pad: bool = True):
        """[B,P,2] coords (model-frame pixels) + [B,P] labels -> [B,P(+1),C].
        Labels: 1 pos, 0 neg, 2/3 box corners, -1 padding
        (reference prompt_encoder.py:124-166)."""
        B = coords.shape[0]
        coords = coords + 0.5
        if pad:
            coords = torch.cat([coords, coords.new_zeros(B, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(B, 1)], dim=1)
        h, w = input_image_size
        norm = coords / torch.tensor([w, h], dtype=coords.dtype, device=coords.device)
        pe = posenc.random_fourier_encode(self._gaussian, norm)
        lab = labels[..., None]
        emb = torch.where(lab == -1, torch.zeros_like(pe) + self.not_a_point_embed.weight[0], pe)
        for i in range(4):
            emb = torch.where(lab == i, emb + self.point_embeddings[i].weight[0], emb)
        return emb

    def embed_masks(self, masks):
        """Dense mask prompt [B,1,256,256] -> [B,C,64,64]
        (reference prompt_encoder.py:59-67 mask_downscaling)."""
        return self.mask_downscaling(masks)

    def get_dense_pe(self, embed_size: Tuple[int, int]):
        """Dense positional encoding [1,C,H,W] (reference prompt_encoder.py:113)."""
        return posenc.random_fourier_grid(self._gaussian, *embed_size).permute(2, 0, 1)[None]

    def forward(self, coords, labels, mask_input=None):
        """Returns (sparse [B,P+1,C], dense [B,C,64,64]). `coords`/`labels`
        are always present (callers pad with one -1 point when there are no
        clicks); a box is two corner points with labels 2/3."""
        cfg = self.cfg
        sparse = self.embed_points(coords, labels, (cfg.image_size, cfg.image_size))
        if mask_input is not None:
            dense = self.embed_masks(mask_input)
        else:
            s = cfg.image_embedding_size
            dense = self.no_mask_embed.weight[0][None, :, None, None].expand(
                coords.shape[0], -1, s, s)
        return sparse, dense
