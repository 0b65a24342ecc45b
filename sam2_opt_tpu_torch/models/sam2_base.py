"""SAM2 core module: the parameter tree of the reference model, image
encoding and the image-path helpers.

Counterpart of `sam2_opt_tpu/models/sam2_base.py` (`resize_hw`,
`forward_image`, `image_normalize`). `SAM2Base` holds every parameter of the
reference `sd["model"]` under its reference name, so a reference checkpoint
or the JAX package's parameters (through `io/weights.py`) load with
`load_state_dict(strict=True)`. The memory attention and memory encoder are
parameter containers here: the video slice gives them their forward.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Tuple

import torch
from torch import nn

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.models.hiera import ImageEncoder
from sam2_opt_tpu_torch.models.mask_decoder import MaskDecoder
from sam2_opt_tpu_torch.models.prompt_encoder import PromptEncoder
from sam2_opt_tpu_torch.ops import common as ops

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class MemoryAttentionLayer(nn.Module):
    def __init__(self, d: int, ff: int, kv_in_dim: int):
        super().__init__()
        self.self_attn = ops.Attention(d, 1)
        self.cross_attn_image = ops.Attention(d, 1, kv_in_dim=kv_in_dim)
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)
        self.norm1, self.norm2, self.norm3 = (ops.LayerNorm(d) for _ in range(3))


class MemoryAttention(nn.Module):
    """Parameters of the reference memory attention (memory_attention.py)."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        mac = cfg.memory_attention
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(mac.d_model, mac.dim_feedforward, mac.kv_in_dim)
            for _ in range(mac.num_layers))
        self.norm = ops.LayerNorm(mac.d_model)


class CXBlock(nn.Module):
    def __init__(self, dim: int, kernel_size: int, padding: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size, padding=padding, groups=dim)
        self.norm = ops.LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))


class MemoryEncoder(nn.Module):
    """Parameters of the reference memory encoder (memory_encoder.py)."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        mec = cfg.memory_encoder
        layers, c_in = [], 1
        num_ds = int(math.log2(mec.mask_total_stride) // math.log2(mec.mask_downsampler_stride))
        for _ in range(num_ds):
            c_out = c_in * mec.mask_downsampler_stride ** 2
            layers += [nn.Conv2d(c_in, c_out, mec.mask_downsampler_kernel,
                                 mec.mask_downsampler_stride, mec.mask_downsampler_padding),
                       ops.LayerNorm2d(c_out), nn.Identity()]
            c_in = c_out
        layers.append(nn.Conv2d(c_in, mec.in_dim, 1))
        self.mask_downsampler = nn.Module()
        self.mask_downsampler.encoder = nn.Sequential(*layers)
        self.pix_feat_proj = nn.Conv2d(mec.in_dim, mec.in_dim, 1)
        self.fuser = nn.Module()
        self.fuser.layers = nn.ModuleList(
            CXBlock(mec.in_dim, mec.cx_kernel_size, mec.cx_padding)
            for _ in range(mec.fuser_num_layers))
        self.out_proj = nn.Conv2d(mec.in_dim, mec.out_dim, 1)


class SAM2Base(nn.Module):
    """Every parameter of the reference SAM2.1 model, under its reference key."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        C = cfg.hidden_dim
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg.trunk, cfg.neck, scalp=cfg.scalp)
        self.memory_attention = MemoryAttention(cfg)
        self.memory_encoder = MemoryEncoder(cfg)
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg)
        if not cfg.use_obj_ptrs_in_encoder:
            self.obj_ptr_proj = nn.Identity()
        elif cfg.use_mlp_for_obj_ptr_proj:
            self.obj_ptr_proj = ops.MLP(C, C, C, 3)
        else:
            self.obj_ptr_proj = nn.Linear(C, C)
        self.obj_ptr_tpos_proj = (nn.Linear(C, cfg.mem_dim) if cfg.proj_tpos_enc_in_obj_ptrs
                                  else nn.Identity())
        self.mask_downsample = nn.Conv2d(1, 1, 4, 4)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, C))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, C))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, C))
        self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, cfg.mem_dim))


def resize_hw(x, size: Tuple[int, int], method: str = "bilinear", antialias: bool = False):
    """Resize the last two axes of [..., H, W] (torch F.interpolate
    semantics, align_corners=False)."""
    *lead, H, W = x.shape
    out = ops.interpolate(x.reshape(-1, 1, H, W), size, method=method, antialias=antialias)
    return out.reshape(*lead, *size)


def forward_image(model: SAM2Base, img):
    """Normalized image batch [B, 3, S, S] -> backbone features (reference
    sam2_base_official.py:566-582): the image encoder, then the two high-res
    FPN levels through the mask decoder's conv_s0/conv_s1.
    Returns {"backbone_fpn": [B,C/8,4h,4w], [B,C/4,2h,2w], [B,C,h,w];
    "vision_pos_enc": three NCHW maps}."""
    out = model.image_encoder(img)
    fpn = list(out["backbone_fpn"])
    if model.cfg.use_high_res_features_in_sam:
        fpn[0] = model.sam_mask_decoder.conv_s0(fpn[0])
        fpn[1] = model.sam_mask_decoder.conv_s1(fpn[1])
    return {"backbone_fpn": fpn, "vision_pos_enc": list(out["vision_pos_enc"])}


def image_normalize(img, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """ImageNet normalization of [B, 3, H, W] images in [0, 1]
    (reference utils/transforms.py:27-31)."""
    mean = torch.tensor(mean, dtype=img.dtype, device=img.device)[:, None, None]
    std = torch.tensor(std, dtype=img.dtype, device=img.device)[:, None, None]
    return (img - mean) / std
