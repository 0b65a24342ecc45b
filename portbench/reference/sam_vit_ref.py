"""Plain fp32 Segment Anything: the benchmark's reference for SAM ViT cells.

Upstream's forward pass (segment_anything/modeling/image_encoder.py,
prompt_encoder.py, mask_decoder.py, transformer.py) and its predictor's
pre- and post-processing (predictor.py, utils/transforms.py
`ResizeLongestSide`, sam.py `preprocess` / `postprocess_masks`), in fp32
plain torch: every attention forms its logits [heads, S, S] in full, the
decomposed relative-position bias added to them as upstream's
`add_decomposed_rel_pos` adds it. Imports nothing of the port and nothing of
JAX; the two-way transformer's blocks are the SAM 2 reference's
(`sam2_ref.TwoWayBlock`), which SAM 2 copied from SAM unchanged.

State-dict keys are the port's: `image_encoder.*` as upstream,
`sam_prompt_encoder.*` and `sam_mask_decoder.*` for upstream's
`prompt_encoder.*` and `mask_decoder.*`; one seeded state dict loads into
both. Callers keep TF32 off (`sam2_ref.plain_fp32()`). Under
`sam2_ref.rounded(model)`, the comparison's control, every product's inputs
are rounded (the relative-position terms' too).

Departures from upstream, each also in the benchmark configuration's
`assumed`:
- upstream resizes the image through PIL on uint8 (bilinear, antialiased,
  rounded to uint8); here the resize runs in float on the device
  (`F.interpolate(..., antialias=True)`) in the program and the reference
  alike, and is not rounded;
- the sparse prompts: upstream embeds the points, then the box; the port
  puts the box's two corners first. The two-way transformer does not see
  the order of its tokens, so only the order of sums differs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import sam2_ref


@dataclasses.dataclass(frozen=True)
class Encoder:
    embed_dim: int
    depth: int
    num_heads: int
    global_attn_indexes: Tuple[int, ...]
    window_size: int
    patch_size: int
    mlp_ratio: float
    out_chans: int


@dataclasses.dataclass(frozen=True)
class Config:
    encoder: Encoder
    image_size: int
    hidden_dim: int
    mask_in_chans: int
    num_multimask_outputs: int
    sam_mask_decoder_depth: int
    sam_mask_decoder_mlp_dim: int
    sam_mask_decoder_num_heads: int
    iou_head_depth: int
    iou_head_hidden_dim: int
    pixel_mean: Tuple[float, float, float]
    pixel_std: Tuple[float, float, float]

    @property
    def grid(self) -> int:
        return self.image_size // self.encoder.patch_size


def config_from_json(model: dict) -> Config:
    """The reference's configuration from the `model` group of a benchmark
    configuration file (keys it does not use are ignored)."""
    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names}

    return Config(encoder=Encoder(**pick(Encoder, model["encoder"])),
                  **pick(Config, {k: v for k, v in model.items() if k != "encoder"}))


def _round(x):
    return x if sam2_ref._ROUND is None else sam2_ref._ROUND(x)


# image encoder (image_encoder.py)


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """[q, k, d] (image_encoder.py `get_rel_pos`; the tables have the
    length the grid needs, so no resize)."""
    q = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, hw):
    """attn [B, S, S] + rel_h[.., kh] + rel_w[.., kw] with the unscaled q
    [B, S, d] (image_encoder.py `add_decomposed_rel_pos`)."""
    H, W = hw
    Rh, Rw = get_rel_pos(H, H, rel_pos_h), get_rel_pos(W, W, rel_pos_w)
    B, _, dim = q.shape
    r_q = _round(q).reshape(B, H, W, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, _round(Rh))
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, _round(Rw))
    attn = (attn.view(B, H, W, H, W) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :])
    return attn.view(B, H * W, H * W)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, input_size):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, dim // num_heads))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, dim // num_heads))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, -1).unbind(0)
        attn = _round(q * self.scale) @ _round(k).transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W))
        attn = attn.softmax(dim=-1)
        x = (_round(attn) @ _round(v)).view(B, self.num_heads, H, W, -1)
        return self.proj(x.permute(0, 2, 3, 1, 4).reshape(B, H, W, -1))


class MLPBlock(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.lin1, self.lin2 = nn.Linear(dim, hidden), nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    def __init__(self, e: Encoder, window_size: int, grid: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(e.embed_dim, eps=1e-6)
        self.attn = Attention(e.embed_dim, e.num_heads, window_size if window_size > 0 else grid)
        self.norm2 = nn.LayerNorm(e.embed_dim, eps=1e-6)
        self.mlp = MLPBlock(e.embed_dim, int(e.embed_dim * e.mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = sam2_ref.window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = sam2_ref.window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        e = cfg.encoder
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, e.embed_dim, e.patch_size, e.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, e.embed_dim))
        self.blocks = nn.ModuleList(
            Block(e, 0 if i in e.global_attn_indexes else e.window_size, cfg.grid)
            for i in range(e.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(e.embed_dim, e.out_chans, 1, bias=False), sam2_ref.LayerNorm2d(e.out_chans),
            nn.Conv2d(e.out_chans, e.out_chans, 3, padding=1, bias=False),
            sam2_ref.LayerNorm2d(e.out_chans))

    def forward(self, x):
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# prompt encoder (prompt_encoder.py)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        C, mc = cfg.hidden_dim, cfg.mask_in_chans
        self.cfg = cfg
        self.pe_layer = nn.Module()
        self.pe_layer.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, C // 2))
        self.point_embeddings = nn.ModuleList(sam2_ref.Embedding(1, C) for _ in range(4))
        self.not_a_point_embed = sam2_ref.Embedding(1, C)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, 2), sam2_ref.LayerNorm2d(mc // 4), sam2_ref.GELU(),
            nn.Conv2d(mc // 4, mc, 2, 2), sam2_ref.LayerNorm2d(mc), sam2_ref.GELU(),
            nn.Conv2d(mc, C, 1))
        self.no_mask_embed = sam2_ref.Embedding(1, C)

    @property
    def gaussian(self):
        return self.pe_layer.positional_encoding_gaussian_matrix

    def dense_pe(self):
        s = self.cfg.grid
        x = (torch.arange(s, dtype=torch.float32, device=self.gaussian.device) + 0.5) / s
        grid = torch.stack(torch.meshgrid(x, x, indexing="xy"), -1)
        return sam2_ref.fourier(self.gaussian, grid).permute(2, 0, 1)[None]

    def forward(self, points, boxes, masks):
        """points (coords [B, P, 2], labels [B, P]) or None, boxes [B, 4] or
        None in the model's frame, masks [B, 1, 256, 256] or None
        (prompt_encoder.py:136-170): the padding point only without a box."""
        S, parts = self.cfg.image_size, []
        if points is not None:
            coords, labels = points
            coords = coords + 0.5
            if boxes is None:
                coords = torch.cat([coords, coords.new_zeros(coords.shape[0], 1, 2)], 1)
                labels = torch.cat([labels, -labels.new_ones(labels.shape[0], 1)], 1)
            emb = sam2_ref.fourier(self.gaussian, coords / S)
            lab = labels[..., None]
            emb = torch.where(lab == -1, self.not_a_point_embed.weight[0].expand_as(emb), emb)
            emb = torch.where(lab == 0, emb + self.point_embeddings[0].weight[0], emb)
            emb = torch.where(lab == 1, emb + self.point_embeddings[1].weight[0], emb)
            parts.append(emb)
        if boxes is not None:
            corners = sam2_ref.fourier(self.gaussian, (boxes.reshape(-1, 2, 2) + 0.5) / S)
            corners = torch.stack([corners[:, 0] + self.point_embeddings[2].weight[0],
                                   corners[:, 1] + self.point_embeddings[3].weight[0]], 1)
            parts.append(corners)
        sparse = torch.cat(parts, 1)
        if masks is not None:
            dense = self.mask_downscaling(masks)
        else:
            s = self.cfg.grid
            dense = self.no_mask_embed.weight[0][None, :, None, None].expand(
                sparse.shape[0], -1, s, s)
        return sparse, dense


# mask decoder (mask_decoder.py)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        C = cfg.hidden_dim
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            sam2_ref.TwoWayBlock(C, cfg.sam_mask_decoder_num_heads, cfg.sam_mask_decoder_mlp_dim,
                                 i == 0) for i in range(cfg.sam_mask_decoder_depth))
        self.transformer.final_attn_token_to_image = sam2_ref.Attention(
            C, cfg.sam_mask_decoder_num_heads, downsample_rate=2)
        self.transformer.norm_final_attn = nn.LayerNorm(C)
        self.iou_token = sam2_ref.Embedding(1, C)
        self.mask_tokens = sam2_ref.Embedding(self.num_mask_tokens, C)
        self.output_upscaling = nn.ModuleList([
            nn.ConvTranspose2d(C, C // 4, 2, 2), sam2_ref.LayerNorm2d(C // 4), nn.Identity(),
            nn.ConvTranspose2d(C // 4, C // 8, 2, 2), nn.Identity()])
        self.output_hypernetworks_mlps = nn.ModuleList(
            sam2_ref.MLP(C, C, C // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = sam2_ref.MLP(C, cfg.iou_head_hidden_dim, self.num_mask_tokens,
                                                cfg.iou_head_depth)

    def forward(self, image_emb, image_pe, sparse, dense, multimask_output: bool):
        """(masks, ious) (mask_decoder.py:75-165)."""
        B = sparse.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], 1)
        src = image_emb.expand(B, -1, -1, -1) + dense
        _, C, H, W = src.shape
        keys = src.flatten(2).transpose(1, 2)
        key_pe = image_pe.expand(B, -1, -1, -1).flatten(2).transpose(1, 2)
        queries = tokens
        for layer in self.transformer.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = self.transformer.norm_final_attn(
            queries + self.transformer.final_attn_token_to_image(q, k, keys))
        iou_out, mask_out = queries[:, 0], queries[:, 1:1 + self.num_mask_tokens]
        dc1, ln1, _, dc2, _ = self.output_upscaling
        up = F.gelu(dc2(F.gelu(ln1(dc1(keys.transpose(1, 2).reshape(B, C, H, W))))))
        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        b, c, h, w = up.shape
        masks = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        ious = self.iou_prediction_head(iou_out)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, sl], ious[:, sl]


class SamViT(nn.Module):
    """Every parameter of Segment Anything under the port's keys."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg)


def build(cfg: Config, state_dict, device) -> SamViT:
    """The reference model holding `state_dict`, fp32, on `device`."""
    with torch.device("meta"):
        model = SamViT(cfg)
    model.load_state_dict({k: v.float() for k, v in state_dict.items()}, strict=True, assign=True)
    return model.to(device).eval()


# the predictor (predictor.py, utils/transforms.py, sam.py)


def preprocess_shape(h: int, w: int, long_side: int):
    scale = long_side * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


class PredictorRef:
    """`SamPredictor`'s `set_image` and `predict` on the reference model."""

    def __init__(self, model: SamViT, device):
        self.model, self.device = model, device

    @torch.no_grad()
    def set_image(self, image: np.ndarray):
        cfg, S = self.model.cfg, self.model.cfg.image_size
        self.hw = image.shape[:2]
        self.input_hw = preprocess_shape(*self.hw, S)
        x = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        x = x.permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=self.input_hw, mode="bilinear", align_corners=False,
                          antialias=True)
        mean = torch.tensor(cfg.pixel_mean, device=self.device)[:, None, None]
        std = torch.tensor(cfg.pixel_std, device=self.device)[:, None, None]
        x = F.pad((x - mean) / std, (0, S - self.input_hw[1], 0, S - self.input_hw[0]))
        self.embed = self.model.image_encoder(x)

    @torch.no_grad()
    def predict(self, point_coords=None, point_labels=None, box=None, mask_input=None,
                multimask_output: bool = True):
        """(mask logits [M, H, W], ious [M], low-res logits [M, 256, 256]) on
        the device; coordinates in image pixels, `mask_input` [1, 256, 256]."""
        m, S = self.model, self.model.cfg.image_size
        (h, w), (nh, nw) = self.hw, self.input_hw
        scale = torch.tensor([nw / w, nh / h], dtype=torch.float32, device=self.device)
        points = boxes = None
        if point_coords is not None:
            coords = torch.as_tensor(np.asarray(point_coords, np.float32),
                                     device=self.device) * scale
            points = (coords[None], torch.as_tensor(np.asarray(point_labels),
                                                    device=self.device).long()[None])
        if box is not None:
            boxes = (torch.as_tensor(np.asarray(box, np.float32).reshape(2, 2),
                                     device=self.device) * scale).reshape(1, 4)
        mask = None if mask_input is None else torch.as_tensor(
            mask_input, dtype=torch.float32, device=self.device)[None]
        sparse, dense = m.sam_prompt_encoder(points, boxes, mask)
        low, ious = m.sam_mask_decoder(self.embed, m.sam_prompt_encoder.dense_pe(), sparse,
                                       dense, multimask_output)
        masks = F.interpolate(low, (S, S), mode="bilinear", align_corners=False)
        masks = F.interpolate(masks[..., :nh, :nw], (h, w), mode="bilinear", align_corners=False)
        return masks[0], ious[0], low[0]

