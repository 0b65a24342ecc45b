"""Memory encoder: mask downsampler, pixel-feature projection, ConvNeXt
fuser, output projection and sine positional encoding.

Counterpart of `sam2_opt_tpu/models/memory_encoder.py` (reference
sam2/sam2/modeling/memory_encoder.py:19-251) in its plain form, NCHW. The
JAX package's phase-packed mask downsampler is a TPU layout of the same
convolutions and is not ported.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch
from torch import nn

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.ops import common as ops
from sam2_opt_tpu_torch.ops import posenc


class CXBlock(nn.Module):
    """ConvNeXt block (reference memory_encoder.py:64-119): depthwise 7x7
    conv, channel LayerNorm, pointwise MLP x4, layer scale, residual."""

    def __init__(self, dim: int, kernel_size: int, padding: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size, padding=padding, groups=dim)
        self.norm = ops.LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = self.norm(self.dwconv(x)).movedim(1, -1)
        y = self.gamma * self.pwconv2(ops.gelu(self.pwconv1(y)))
        return x + y.movedim(-1, 1)


@lru_cache(maxsize=8)
def _sine_pe(h: int, w: int, c: int, device, dtype):
    """[1, c, h, w] sine PE, a constant per shape (built outside inference
    mode, so training can use what a predictor cached)."""
    with torch.inference_mode(False):
        return posenc.sine_pos_embed_2d(h, w, c).permute(2, 0, 1)[None].to(device, dtype)


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        mec = cfg.memory_encoder
        self.cfg = mec
        layers, c_in = [], 1
        num_ds = int(math.log2(mec.mask_total_stride) // math.log2(mec.mask_downsampler_stride))
        for _ in range(num_ds):
            c_out = c_in * mec.mask_downsampler_stride ** 2
            layers += [nn.Conv2d(c_in, c_out, mec.mask_downsampler_kernel,
                                 mec.mask_downsampler_stride, mec.mask_downsampler_padding),
                       ops.LayerNorm2d(c_out), ops.GELU()]
            c_in = c_out
        layers.append(nn.Conv2d(c_in, mec.in_dim, 1))
        # reference mask_downsampler (memory_encoder.py:19-60): [B,1,S,S] -> [B,in_dim,S/16,S/16]
        self.mask_downsampler = nn.Module()
        self.mask_downsampler.encoder = nn.Sequential(*layers)
        self.pix_feat_proj = nn.Conv2d(mec.in_dim, mec.in_dim, 1)
        self.fuser = nn.Module()
        self.fuser.layers = nn.ModuleList(
            CXBlock(mec.in_dim, mec.cx_kernel_size, mec.cx_padding)
            for _ in range(mec.fuser_num_layers))
        self.out_proj = nn.Conv2d(mec.in_dim, mec.out_dim, 1)

    def forward(self, pix_feat, masks, apply_sigmoid: bool = False):
        """pix_feat [B, in_dim, h, w], masks [B, 1, 16h, 16w] (already scaled:
        SAM2Base pre-scales, the reference's skip_mask_sigmoid) ->
        (features [B, out_dim, h, w], pos [1, out_dim, h, w])."""
        if apply_sigmoid:
            masks = torch.sigmoid(masks)
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler.encoder(masks)
        for block in self.fuser.layers:
            x = block(x)
        x = self.out_proj(x)
        h, w = x.shape[-2:]
        return x, _sine_pe(h, w, self.cfg.pos_num_feats, x.device, x.dtype)
