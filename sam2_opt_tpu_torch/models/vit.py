"""SAM's ViT image encoder, and the Segment Anything module around it.

The plain ViT of Segment Anything (reference
segment_anything/modeling/image_encoder.py `ImageEncoderViT`, `Block`,
`Attention`, `add_decomposed_rel_pos`), with module and parameter names as
upstream: a 16x16 patch embedding and a learned absolute position
embedding, then blocks whose attention is windowed (the 64x64 grid padded
with zeros to whole 14x14 windows, the padded tokens attending as keys) or
global, each with a decomposed relative-position bias on its logits, then a
1x1 and a 3x3 convolution, each followed by LayerNorm2d. The prompt encoder
and mask decoder are the port's (`SamViT`), under SAM's flags
(`config.SamViTConfig`). It runs through `SAM2Model` and
`SAM2ImagePredictor` like the SAM 2 presets.

Routes, as the Hiera block's: without grad a bf16 block runs its LayerNorms,
the residual add and the window padding, partition and unpartition as two
`add_layer_norm` calls, and its attention on the relative-position flash
kernel (`kernels.flash_attention.flash_attention_relpos`) where
`ops.use_flash_attention` holds (CUDA tensors by default; a shape the
kernel does not serve raises rather than falling back): q's products with
the two tables are one small bf16 product before the kernel, which gathers
the bias terms from them.
fp32, grad and the CPU run the eager chain: the same products gathered into
the bias terms (upstream's einsum over the gathered tables, summed in
another order), the logits formed in full as upstream forms them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sam2_opt_tpu_torch.config import SamViTConfig, ViTConfig
from sam2_opt_tpu_torch.kernels.add_layer_norm import (
    add_layer_norm,
    add_layer_norm_ref,
    window_grid,
)
from sam2_opt_tpu_torch.kernels.flash_attention import (
    flash_attention_relpos,
    relpos_products,
    relpos_terms_from_products,
)
from sam2_opt_tpu_torch.models.mask_decoder import MaskDecoder
from sam2_opt_tpu_torch.models.prompt_encoder import PromptEncoder
from sam2_opt_tpu_torch.ops import common as ops
from sam2_opt_tpu_torch.utils import profiling


def eager_attention(q, k, v, rel_h, rel_w, scale: float):
    """The upstream chain: logits (q * scale) k^T [B, heads, S, S] formed in
    full, the bias added over the key grid, softmax, then p . v (fp32
    softmax for lower precisions)."""
    B, n, S, _ = q.shape
    Kh, Kw = rel_h.shape[-1], rel_w.shape[-1]
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = (attn.view(B, n, S, Kh, Kw) + rel_h[..., :, None] + rel_w[..., None, :]).view(
        B, n, S, Kh * Kw)
    return attn.float().softmax(dim=-1).to(v.dtype) @ v


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)  # [B, H, W, C]


class Attention(nn.Module):
    """Multi-head attention with the decomposed relative-position bias
    (reference image_encoder.py `Attention`). x [B, H, W, C] -> same."""

    def __init__(self, dim: int, num_heads: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        head_dim = dim // num_heads
        # zeros, as upstream's rel_pos_zero_init
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, head_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # [B, heads, S, d] views of one projection
        # a shape the kernel does not serve raises on the card
        if (x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
                and ops.use_flash_attention(x)):
            out = flash_attention_relpos(q, k, v, self.rel_pos_h, self.rel_pos_w)
        else:
            rel = relpos_products(q, self.rel_pos_h, self.rel_pos_w)
            rel_h, rel_w = relpos_terms_from_products(rel, H, W)
            out = eager_attention(q, k, v, rel_h, rel_w, self.scale)
        return self.proj(out.transpose(1, 2).reshape(B, H, W, -1))


class MLPBlock(nn.Module):
    """lin1, exact GELU, lin2 (reference modeling/common.py `MLPBlock`)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    """One ViT block (reference image_encoder.py `Block`); window_size 0 is
    a global block."""

    def __init__(self, cfg: ViTConfig, window_size: int, grid: int):
        super().__init__()
        dim = cfg.embed_dim
        self.window_size = window_size
        self.norm1 = ops.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, cfg.num_heads, window_size if window_size > 0 else grid)
        self.norm2 = ops.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * cfg.mlp_ratio))

    def forward(self, x):
        # without grad a bf16 block runs norm1 with the window padding and
        # partition, and the unpartition, residual add and norm2, as two
        # `add_layer_norm` calls (the kernel on the card); otherwise the
        # same chain eagerly
        aln = (add_layer_norm if x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
               else add_layer_norm_ref)
        n1, n2 = self.norm1, self.norm2
        grid = window_grid(self.window_size, x.shape[1], x.shape[2])
        shortcut, x = aln(x, None, n1.weight, n1.bias, n1.eps, out_window=grid)
        x, xn = aln(shortcut, self.attn(x), n2.weight, n2.bias, n2.eps, delta_window=grid)
        return x + self.mlp(xn)


class ImageEncoderViT(nn.Module):
    """[B, 3, S, S] normalized, padded images -> [B, out_chans, S/16, S/16].
    Stage events (`utils/profiling.py`): `vit.period<n>` at each global
    block (each period ends with one), `vit.neck` at the neck's end."""

    def __init__(self, cfg: ViTConfig, image_size: int):
        super().__init__()
        self.cfg = cfg
        grid = image_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size, grid)
            for i in range(cfg.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, cfg.out_chans, 1, bias=False),
            ops.LayerNorm2d(cfg.out_chans, eps=1e-6),
            nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False),
            ops.LayerNorm2d(cfg.out_chans, eps=1e-6))

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        period = 0
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.cfg.global_attn_indexes:
                period += 1
                profiling.stage(f"vit.period{period}", x)
        x = self.neck(x.permute(0, 3, 1, 2))
        profiling.stage("vit.neck", x)
        return x


class SamViT(nn.Module):
    """Every parameter of a Segment Anything model: the ViT encoder under
    upstream's `image_encoder.*` keys, the prompt encoder and mask decoder
    under the port's `sam_prompt_encoder.*` / `sam_mask_decoder.*`
    (upstream's `prompt_encoder.*` / `mask_decoder.*`)."""

    def __init__(self, cfg: SamViTConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg.encoder, cfg.image_size)
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg)


def encode_e2e(m: SamViT, images):
    """The `set_image` seam of a SAM ViT model: [B, 3, S, S] images,
    normalized and zero-padded by the predictor -> the image embedding
    [B, C, S/16, S/16] (SAM adds no no-memory embedding)."""
    return m.image_encoder(images)


def preprocess_shape(h: int, w: int, long_side: int):
    """(new_h, new_w) with the long side `long_side` (reference
    utils/transforms.py `ResizeLongestSide.get_preprocess_shape`)."""
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)

