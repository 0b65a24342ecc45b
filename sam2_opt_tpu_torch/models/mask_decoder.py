"""SAM mask decoder + two-way transformer.

Counterpart of `sam2_opt_tpu/models/mask_decoder.py`; module and parameter
names follow the reference sam2/sam2/modeling/sam/transformer.py:51-294 and
sam/mask_decoder.py:16-382. Maps are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.ops import common as ops


class TwoWayAttentionBlock(nn.Module):
    """Reference TwoWayAttentionBlock (transformer.py:188-219)."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, skip_first_layer_pe: bool):
        super().__init__()
        self.self_attn = ops.Attention(dim, num_heads)
        self.norm1 = ops.LayerNorm(dim)
        self.cross_attn_token_to_image = ops.Attention(dim, num_heads, downsample_rate=2)
        self.norm2 = ops.LayerNorm(dim)
        self.mlp = ops.MLP(dim, mlp_dim, dim, 2, activation=F.relu)
        self.norm3 = ops.LayerNorm(dim)
        self.norm4 = ops.LayerNorm(dim)
        self.cross_attn_image_to_token = ops.Attention(dim, num_heads, downsample_rate=2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """Reference TwoWayTransformer (transformer.py:97-141)."""

    def __init__(self, depth: int, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, num_heads, mlp_dim, skip_first_layer_pe=i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = ops.Attention(dim, num_heads, downsample_rate=2)
        self.norm_final_attn = ops.LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding/image_pe [B, N_img, C], point_embedding
        [B, N_pts, C]. Returns (queries, keys)."""
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        C = cfg.hidden_dim
        self.cfg = cfg
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(cfg.sam_mask_decoder_depth, C,
                                             cfg.sam_mask_decoder_num_heads,
                                             cfg.sam_mask_decoder_mlp_dim)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, C)
        self.obj_score_token = nn.Embedding(1, C)
        # slots 2 and 4 are the reference nn.Sequential's parameter-free GELUs
        self.output_upscaling = nn.ModuleList([
            nn.ConvTranspose2d(C, C // 4, 2, 2), ops.LayerNorm2d(C // 4), nn.Identity(),
            nn.ConvTranspose2d(C // 4, C // 8, 2, 2), nn.Identity(),
        ])
        self.conv_s0 = nn.Conv2d(C, C // 8, 1)
        self.conv_s1 = nn.Conv2d(C, C // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            ops.MLP(C, C, C // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = ops.MLP(
            C, cfg.iou_head_hidden_dim, self.num_mask_tokens, cfg.iou_head_depth,
            sigmoid_output=cfg.iou_prediction_use_sigmoid)
        self.pred_obj_score_head = ops.MLP(C, C, 1, 3)

    def build_decoder_tokens(self, sparse_prompt_embeddings):
        """[obj_score, iou, mask x4] output tokens ++ sparse prompts
        (reference mask_decoder.py:184-202)."""
        parts = ([self.obj_score_token.weight] if self.cfg.pred_obj_scores else []) + [
            self.iou_token.weight, self.mask_tokens.weight]
        out = torch.cat(parts, dim=0).to(sparse_prompt_embeddings.dtype)
        B = sparse_prompt_embeddings.shape[0]
        return torch.cat([out[None].expand(B, -1, -1), sparse_prompt_embeddings], dim=1)

    def predict_masks(self, src, tokens, pos_src, hrf0, hrf1):
        """Decoder core (reference mask_decoder.py:262-316). src/pos_src
        [B,C,h,w], tokens [B,T,C], hrf0 [B,C/8,4h,4w], hrf1 [B,C/4,2h,2w].
        Returns (masks [B,4,4h,4w], iou_pred [B,4], mask_tokens_out [B,4,C],
        object_score_logits [B,1])."""
        cfg = self.cfg
        B, C, H, W = src.shape
        s = 1 if cfg.pred_obj_scores else 0
        hs, src_out = self.transformer(src.flatten(2).transpose(1, 2),
                                       pos_src.flatten(2).transpose(1, 2), tokens)
        iou_token_out = hs[:, s, :]
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens, :]

        src_img = src_out.transpose(1, 2).reshape(B, C, H, W)
        dc1, ln1, _, dc2, _ = self.output_upscaling
        up = ops.gelu(ln1(dc1(src_img) + hrf1))
        up = ops.gelu(dc2(up) + hrf0)
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i, :]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1)  # [B, M, C/8]
        b, c, h, w = up.shape
        masks = torch.matmul(hyper_in.float(), up.float().reshape(b, c, h * w))
        masks = masks.reshape(b, -1, h, w).to(src.dtype)

        iou_pred = self.iou_prediction_head(iou_token_out)
        if cfg.pred_obj_scores:
            object_score_logits = self.pred_obj_score_head(hs[:, 0, :])
        else:
            object_score_logits = 10.0 * iou_pred.new_ones(B, 1)
        return masks, iou_pred, mask_tokens_out, object_score_logits

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool, high_res_features,
                repeat_image: bool = False):
        """Full decoder (reference mask_decoder.py:116-224). Returns (masks,
        iou_pred, sam_tokens_out, object_score_logits)."""
        cfg = self.cfg
        tokens = self.build_decoder_tokens(sparse_prompt_embeddings)
        B = tokens.shape[0]
        src = image_embeddings
        hrf0, hrf1 = high_res_features
        if repeat_image and src.shape[0] != B:
            reps = B // src.shape[0]
            src = src.repeat_interleave(reps, 0)
            hrf0, hrf1 = hrf0.repeat_interleave(reps, 0), hrf1.repeat_interleave(reps, 0)
        src = src + dense_prompt_embeddings
        pos_src = image_pe.expand(src.shape)
        masks, iou_pred, mask_tokens_out, object_score_logits = self.predict_masks(
            src, tokens, pos_src, hrf0, hrf1)

        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
        elif cfg.dynamic_multimask_via_stability:
            out_masks, out_iou = dynamic_multimask_via_stability(
                masks, iou_pred, cfg.dynamic_multimask_stability_delta,
                cfg.dynamic_multimask_stability_thresh)
        else:
            out_masks, out_iou = masks[:, 0:1], iou_pred[:, 0:1]
        if multimask_output and cfg.use_multimask_token_for_obj_ptr:
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return out_masks, out_iou, sam_tokens_out, object_score_logits


def stability_scores(masks, delta: float):
    flat = masks.flatten(-2)
    area_i = (flat > delta).sum(-1).float()
    area_u = (flat > -delta).sum(-1).float()
    return torch.where(area_u > 0, area_i / area_u.clamp_min(1), 1.0)


def dynamic_multimask_via_stability(all_masks, all_iou, delta: float = 0.05,
                                    thresh: float = 0.98):
    """Single-mask output with a fallback to the best multimask slot when the
    single mask's stability is low (reference mask_decoder.py:346-382)."""
    multimask, multi_iou = all_masks[:, 1:], all_iou[:, 1:]
    best = multi_iou.argmax(-1)
    idx = torch.arange(all_masks.shape[0], device=all_masks.device)
    best_masks = multimask[idx, best][:, None]
    best_iou = multi_iou[idx, best][:, None]
    single_masks, single_iou = all_masks[:, 0:1], all_iou[:, 0:1]
    stable = stability_scores(single_masks, delta) >= thresh  # [B, 1]
    masks_out = torch.where(stable[..., None, None], single_masks, best_masks)
    iou_out = torch.where(stable, single_iou, best_iou)
    return masks_out, iou_out
