"""SAM2 core module: the parameter tree of the reference model, image
encoding, SAM heads and the memory encode / condition steps.

Counterpart of `sam2_opt_tpu/models/sam2_base.py`. `SAM2Base` holds every
parameter of the reference `sd["model"]` under its reference name, so a
reference checkpoint or the JAX package's parameters (through
`io/weights.py`) load with `load_state_dict(strict=True)`. The functions
take the module and, where the video predictor overrides it, the config:

    forward_image         (reference sam2_base_official.py:548-582)
    forward_sam_heads     (reference :338-494)
    use_mask_as_output    (reference :496-546)
    encode_new_memory     (reference :978-1026)
    condition_features    (reference :797-976 step 2 + memory attention)

Feature maps are NCHW; masks are [B, M, H, W].
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.models.hiera import ImageEncoder
from sam2_opt_tpu_torch.models.mask_decoder import MaskDecoder
from sam2_opt_tpu_torch.models.memory_attention import MemoryAttention
from sam2_opt_tpu_torch.models.memory_encoder import MemoryEncoder
from sam2_opt_tpu_torch.models.prompt_encoder import PromptEncoder
from sam2_opt_tpu_torch.ops import common as ops

# A large negative placeholder score for missing objects
# (reference sam2_base_official.py:21).
NO_OBJ_SCORE = -1024.0

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


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


def forward_sam_heads(m: SAM2Base, cfg: SAM2Config, backbone_features, point_coords,
                      point_labels, mask_inputs=None, high_res_features=None,
                      multimask_output: bool = False):
    """Prompt encoder + mask decoder (reference :338-494). backbone_features
    [B,C,h,w]; point_coords [B,P,2] model-frame pixels; point_labels [B,P]
    (1 pos, 0 neg, 2/3 box, -1 pad); mask_inputs [B,1,4h,4w] prompt logits or
    None. Returns the reference 7-tuple (low_res_multimasks,
    high_res_multimasks, ious, low_res_masks, high_res_masks, obj_ptr,
    object_score_logits), masks fp32."""
    dtype = backbone_features.dtype
    coords = point_coords.float()
    if mask_inputs is not None:
        mask_inputs = mask_inputs.to(dtype)
    sparse, dense = m.sam_prompt_encoder(coords, point_labels, mask_inputs)
    s = cfg.image_embedding_size
    image_pe = m.sam_prompt_encoder.get_dense_pe((s, s)).to(dtype)
    low_res_multimasks, ious, sam_output_tokens, object_score_logits = m.sam_mask_decoder(
        backbone_features, image_pe, sparse.to(dtype), dense.to(dtype),
        multimask_output=multimask_output, high_res_features=high_res_features)
    if cfg.pred_obj_scores:
        is_obj_appearing = object_score_logits > 0  # [B, 1]
        low_res_multimasks = torch.where(is_obj_appearing[:, :, None, None], low_res_multimasks,
                                         NO_OBJ_SCORE)
    low_res_multimasks = low_res_multimasks.float()
    size = (cfg.image_size, cfg.image_size)
    high_res_multimasks = resize_hw(low_res_multimasks, size, "bilinear")

    sam_output_token = sam_output_tokens[:, 0]
    if multimask_output:
        best = ious.argmax(-1)
        rows = torch.arange(best.shape[0], device=best.device)
        low_res_masks = low_res_multimasks[rows, best][:, None]
        high_res_masks = high_res_multimasks[rows, best][:, None]
        if sam_output_tokens.shape[1] > 1:
            sam_output_token = sam_output_tokens[rows, best]
    else:
        low_res_masks, high_res_masks = low_res_multimasks, high_res_multimasks

    # MLP for SAM 2.1, Linear without use_mlp, Identity without pointers
    obj_ptr = m.obj_ptr_proj(sam_output_token)
    if cfg.pred_obj_scores:
        lambda_is_obj = (torch.sigmoid(object_score_logits) if cfg.soft_no_obj_ptr
                         else (object_score_logits > 0).to(obj_ptr.dtype))
        if cfg.fixed_no_obj_ptr:
            obj_ptr = lambda_is_obj * obj_ptr
        obj_ptr = obj_ptr + (1.0 - lambda_is_obj) * m.no_obj_ptr[0]
    return (low_res_multimasks, high_res_multimasks, ious, low_res_masks, high_res_masks,
            obj_ptr, object_score_logits)


def use_mask_as_output(m: SAM2Base, cfg: SAM2Config, backbone_features, high_res_features,
                       mask_inputs):
    """Mask passthrough (reference :496-546): +-10 logits from the binary
    input mask [B,1,H,W]; obj_ptr still comes from the SAM heads, prompted
    with the mask through the learned stride-4 `mask_downsample` conv."""
    out_scale, out_bias = 20.0, -10.0
    mask_float = mask_inputs.float()
    high_res_masks = mask_float * out_scale + out_bias
    low_res_masks = resize_hw(high_res_masks, (high_res_masks.shape[-2] // 4,
                                               high_res_masks.shape[-1] // 4),
                              "bilinear", antialias=True)
    B = mask_inputs.shape[0]
    ious = mask_float.new_ones(B, 1)
    if not cfg.use_obj_ptrs_in_encoder:
        obj_ptr = mask_float.new_zeros(B, cfg.hidden_dim)
    else:
        dtype = backbone_features.dtype
        sam_mask_prompt = m.mask_downsample(mask_float.to(dtype))
        coords = mask_float.new_zeros(B, 1, 2)
        labels = -torch.ones(B, 1, dtype=torch.int32, device=mask_float.device)
        obj_ptr = forward_sam_heads(m, cfg, backbone_features, coords, labels,
                                    mask_inputs=sam_mask_prompt,
                                    high_res_features=high_res_features)[5]
    lambda_is_obj = (mask_float.reshape(B, -1) > 0).any(1, keepdim=True).float()
    object_score_logits = out_scale * lambda_is_obj + out_bias
    if cfg.pred_obj_scores:
        if cfg.fixed_no_obj_ptr:
            obj_ptr = lambda_is_obj * obj_ptr
        obj_ptr = obj_ptr + (1.0 - lambda_is_obj) * m.no_obj_ptr[0]
    return (low_res_masks, high_res_masks, ious, low_res_masks, high_res_masks, obj_ptr,
            object_score_logits)


def encode_new_memory(m: SAM2Base, cfg: SAM2Config, pix_feat, pred_masks_high_res,
                      object_score_logits, is_mask_from_pts: bool = False):
    """Encode a prediction into a memory slot (reference :978-1026).
    pix_feat [B,C,h,w] raw frame features, pred_masks_high_res [B,1,S,S]
    logits, object_score_logits [B,1]. Returns (maskmem_features
    [B,mem_dim,h,w], maskmem_pos [1,mem_dim,h,w])."""
    dtype = pix_feat.dtype
    if cfg.binarize_mask_from_pts_for_mem_enc and is_mask_from_pts:
        mask_for_mem = (pred_masks_high_res > 0).to(dtype)
    else:
        mask_for_mem = torch.sigmoid(pred_masks_high_res).to(dtype)
    if cfg.sigmoid_scale_for_mem_enc != 1.0:
        mask_for_mem = mask_for_mem * cfg.sigmoid_scale_for_mem_enc
    if cfg.sigmoid_bias_for_mem_enc != 0.0:
        mask_for_mem = mask_for_mem + cfg.sigmoid_bias_for_mem_enc
    feats, pos = m.memory_encoder(pix_feat, mask_for_mem)
    if cfg.no_obj_embed_spatial:
        is_obj_appearing = (object_score_logits > 0).to(feats.dtype)  # [B, 1]
        feats = feats + ((1.0 - is_obj_appearing)[:, :, None, None]
                         * m.no_obj_embed_spatial[0][None, :, None, None])
    return feats, pos


def condition_features(m: SAM2Base, curr_feat, curr_pos, memory, memory_pos, kv_mask,
                       num_frame_tokens: int):
    """Cross-attend the current features [B,C,h,w] (positions curr_pos
    [B, hw, C]) to the memory bank tokens [B,S,mem_dim] (reference
    :963-976). Returns conditioned [B,C,h,w]."""
    B, C, H, W = curr_feat.shape
    out = m.memory_attention(curr_feat.flatten(2).transpose(1, 2), memory, curr_pos, memory_pos,
                             kv_mask=kv_mask, num_frame_tokens=num_frame_tokens)
    return out.transpose(1, 2).reshape(B, C, H, W)


def no_mem_features(m: SAM2Base, curr_feat):
    """Initial-frame path: add the learned no-memory embedding (reference
    :953-957) to [B,C,h,w] features."""
    return curr_feat + m.no_mem_embed[0, 0].to(curr_feat.dtype)[:, None, None]


def apply_non_overlapping_constraints(pred_masks):
    """Keep only the argmax object per pixel (reference :1191-1207);
    pred_masks [N_obj, 1, H, W]."""
    if pred_masks.shape[0] == 1:
        return pred_masks
    max_obj_inds = pred_masks.argmax(0, keepdim=True)
    batch_obj_inds = torch.arange(pred_masks.shape[0], device=pred_masks.device)[:, None, None, None]
    keep = max_obj_inds == batch_obj_inds
    return torch.where(keep, pred_masks, pred_masks.clamp(max=-10.0))
