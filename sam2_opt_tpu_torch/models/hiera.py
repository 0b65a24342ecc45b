"""Hiera hierarchical ViT trunk + FPN neck.

Counterpart of `sam2_opt_tpu/models/hiera.py`. Modules and parameter names
follow the reference trunk and neck (sam2/sam2/modeling/backbones/hieradet.py,
image_encoder.py). The trunk works on NHWC tokens and returns NCHW maps; the
neck is NCHW.

The JAX package's opt-in trunk routes are here, under the same environment
switches, defaults and precedence, read at every call (PyTorch runs
eagerly): the bf16 window routes to the packed (K7) and per-window (K6)
kernels, the window kernel in `ops.flash_or_sdpa` (K5), and the fused block
MLP (K8). Its XLA layout routes (token-flat window runs, global blocks in
window order, the space-to-depth patch embed) run no kernel and equal the
plain form, so they are not ported.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sam2_opt_tpu_torch.config import FpnNeckConfig, HieraConfig
from sam2_opt_tpu_torch.kernels.fused_mlp import fused_mlp
from sam2_opt_tpu_torch.kernels.window_attention import packed_window_attention, window_flash_3d
from sam2_opt_tpu_torch.ops import common as ops
from sam2_opt_tpu_torch.ops import posenc


def _packed_window_max_tokens() -> int:
    """bf16 windows of at most this many tokens route to the packed window
    kernel (K7): `SAM2_TPU_PACKED_WINDOW=<tokens>`, default 0 (off); an
    unparsable value is off (the JAX package's `hiera.py:60-74`)."""
    try:
        return int(os.environ.get("SAM2_TPU_PACKED_WINDOW", "") or 0)
    except ValueError:
        return 0


def _flash_window_min_tokens() -> int:
    """Smallest window of the split route that runs the per-window kernel
    (K6): `SAM2_TPU_FLASH_WINDOW_MIN`, default 0 = off; a value <= 0 or an
    unparsable one is off (`hiera.py:77-96`)."""
    try:
        v = int(os.environ.get("SAM2_TPU_FLASH_WINDOW_MIN", "0"))
    except ValueError:
        return 1 << 30
    return v if v > 0 else 1 << 30


def _split_window_min_tokens() -> int:
    """Smallest bf16 window taken by the split route:
    `SAM2_TPU_SPLIT_WINDOW_MIN`, default 64, also when unparsable
    (`hiera.py:141-151`)."""
    try:
        return int(os.environ.get("SAM2_TPU_SPLIT_WINDOW_MIN", "64"))
    except ValueError:
        return 64


def _use_fused_mlp() -> bool:
    """The fused block MLP (K8) in bf16: `SAM2_TPU_FUSED_MLP=1`, default off
    (`hiera.py:253-264`)."""
    return os.environ.get("SAM2_TPU_FUSED_MLP", "0") == "1"


def _split_window_attention(q, k, v):
    """The split route (`hiera.py:154-213`) on [N, S, heads, d] views of the
    block's one qkv projection: the per-window kernel (K6) from
    `SAM2_TPU_FLASH_WINDOW_MIN` tokens up, else plain attention with bf16
    logits. Returns [N, S, heads, d]."""
    if q.shape[1] >= _flash_window_min_tokens():
        return window_flash_3d(q, k, v)
    return ops.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)


class MultiScaleAttention(nn.Module):
    """Windowed/global attention with optional query pooling
    (reference hieradet.py:39-81). x: [B, H, W, C] -> [B, H', W', C_out]."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_stride=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_stride = q_stride
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x):
        B, H, W, _ = x.shape
        S = H * W
        qkv = self.qkv(x.reshape(B, S, -1)).reshape(B, S, 3, self.num_heads, -1)
        q, k, v = qkv.unbind(2)
        # the bf16 window routes, in the JAX package's order (hiera.py:221-231):
        # packed (K7), then split (K6 or plain bf16 attention)
        if self.q_stride is None and x.dtype == torch.bfloat16:
            if S <= _packed_window_max_tokens():
                return self.proj(packed_window_attention(q, k, v).reshape(B, H, W, -1))
            if _split_window_min_tokens() <= S <= 1024:
                return self.proj(_split_window_attention(q, k, v).reshape(B, H, W, -1))
        if self.q_stride is not None:
            q = ops.max_pool2d(q.reshape(B, H, W, -1), self.q_stride, self.q_stride)
            H, W = q.shape[1], q.shape[2]
            q = q.reshape(B, H * W, self.num_heads, -1)
        # the global blocks (4096 tokens at 1024²) route to the flash kernel
        # on CUDA; windowed blocks to K5 under SAM2_TPU_WINDOW_KERNEL=1, else
        # plain matmul + softmax
        out = ops.flash_or_sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(B, H, W, -1))


class MultiScaleBlock(nn.Module):
    """One Hiera block (reference hieradet.py:84-166)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, window_size: int,
                 q_pool: bool, q_stride, mlp_ratio: float):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window_size = window_size
        self.q_stride = tuple(q_stride) if q_pool else None
        self.norm1 = ops.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_stride=self.q_stride)
        self.norm2 = ops.LayerNorm(dim_out, eps=1e-6)
        self.mlp = ops.MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, activation=ops.gelu)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_stride is not None:
                shortcut = ops.max_pool2d(shortcut, self.q_stride, self.q_stride)

        H, W = x.shape[1], x.shape[2]
        ws = self.window_size
        pad_hw = (H, W)
        if ws > 0:
            x, pad_hw = ops.window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride is not None:
            ws = ws // self.q_stride[0]
            H, W = shortcut.shape[1], shortcut.shape[2]
            if ws > 0:
                pad_hw = (H + (ws - H % ws) % ws, W + (ws - W % ws) % ws)
        if self.window_size > 0:
            x = ops.window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self._mlp(self.norm2(x))

    def _mlp(self, xn):
        """The block MLP; in bf16 under `SAM2_TPU_FUSED_MLP=1` the fused
        kernel (K8), where both layers hold a raw weight (`hiera.py:267-283`)."""
        l1, l2 = self.mlp.layers
        if (xn.dtype == torch.bfloat16 and _use_fused_mlp()
                and isinstance(getattr(l1, "weight", None), torch.Tensor)
                and isinstance(getattr(l2, "weight", None), torch.Tensor)):
            return fused_mlp(xn, l1.weight, l1.bias, l2.weight, l2.bias, fast_act=True)
        return self.mlp(xn)


def _cubic_resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of `jax.image.resize(method="cubic")` along one
    axis: the Keys kernel with a = -0.5 at half-pixel sample positions,
    columns renormalized where taps fall outside the input (as
    `jax.image.scale_and_translate` builds them). This is not torch's
    bicubic (a = -0.75, clamped edges)."""
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.t().contiguous().to(device)


def hiera_pos_embed(pos_embed, pos_embed_window, h: int, w: int):
    """Interpolated global + tiled window positional embedding
    (reference hieradet.py:273-281), as the JAX package computes it.
    pos_embed [1,C,bh,bw], pos_embed_window [1,C,ws,ws]; returns [1,h,w,C]
    in fp32."""
    wh = _cubic_resize_matrix(pos_embed.shape[-2], h, pos_embed.device)
    ww = _cubic_resize_matrix(pos_embed.shape[-1], w, pos_embed.device)
    pos = torch.einsum("ih,bchw,jw->bcij", wh, pos_embed.float(), ww)
    win = pos_embed_window.float()
    pos = pos + win.tile(1, 1, h // win.shape[-2], w // win.shape[-1])
    return pos.permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_kernel, cfg.patch_stride,
                              cfg.patch_padding)

    def forward(self, x):
        return self.proj(x)


class Hiera(nn.Module):
    """Full trunk: [B, 3, H, W] image -> 4-scale NCHW feature pyramid,
    highest resolution first (reference hieradet.py:283-299)."""

    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.embed_dim, *cfg.window_pos_embed_bkg_spatial_size))
        ws0 = cfg.window_spec[0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, cfg.embed_dim, ws0, ws0))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(s["dim"], s["dim_out"], s["num_heads"], s["window_size"],
                            s["q_pool"], cfg.q_stride, cfg.mlp_ratio)
            for s in cfg.block_plan())
        self.stage_ends = set(cfg.stage_ends)
        self.remat_blocks = cfg.remat_blocks  # the trainer sets it per step

    def forward(self, x) -> List[torch.Tensor]:
        x = self.patch_embed(x).permute(0, 2, 3, 1)
        x = x + hiera_pos_embed(self.pos_embed, self.pos_embed_window,
                                x.shape[1], x.shape[2]).to(x.dtype)
        outputs = []
        for i, blk in enumerate(self.blocks):
            # remat_blocks: the backward recomputes one block at a time
            # (the JAX package's per-block jax.checkpoint, hiera.py:429,460)
            if self.remat_blocks and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
            if i in self.stage_ends:
                outputs.append(x.permute(0, 3, 1, 2))
        return outputs


class FpnNeck(nn.Module):
    """FPN neck (reference image_encoder.py:45-134). Lateral 1x1 convs;
    top-down 2x-nearest fusion only on `fpn_top_down_levels`."""

    def __init__(self, cfg: FpnNeckConfig):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList(
            nn.Sequential(OrderedDict(conv=nn.Conv2d(c, cfg.d_model, 1)))
            for c in cfg.backbone_channel_list)

    def forward(self, xs: List[torch.Tensor]):
        """xs highest-res first (NCHW). Returns (features, pos) lists in the
        same order, NCHW."""
        n = len(xs) - 1
        out, pos = [None] * len(xs), [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](xs[i])
            if i in self.cfg.fpn_top_down_levels and prev is not None:
                top_down = ops.upsample2x_nearest(prev.float()).to(lateral.dtype)
                prev = lateral + top_down
                if self.cfg.fuse_type == "avg":
                    prev = prev / 2
            else:
                prev = lateral
            out[i] = prev
            B, _, h, w = prev.shape
            pe = posenc.sine_pos_embed_2d(h, w, self.cfg.pos_num_feats, device=prev.device)
            pos[i] = pe.permute(2, 0, 1)[None].expand(B, -1, -1, -1).to(prev.dtype)
        return out, pos


class ImageEncoder(nn.Module):
    """Trunk + neck with `scalp` lowest-res levels dropped
    (reference image_encoder.py:14-42)."""

    def __init__(self, trunk_cfg: HieraConfig, neck_cfg: FpnNeckConfig, scalp: int = 1):
        super().__init__()
        self.trunk = Hiera(trunk_cfg)
        self.neck = FpnNeck(neck_cfg)
        self.scalp = scalp

    def forward(self, x):
        features, pos = self.neck(self.trunk(x))
        if self.scalp > 0:
            features, pos = features[: -self.scalp], pos[: -self.scalp]
        return {"vision_features": features[-1], "vision_pos_enc": pos,
                "backbone_fpn": features}
