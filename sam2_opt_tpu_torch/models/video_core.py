"""Video tracking core: one tracking step over a fixed-capacity memory.

Counterpart of `sam2_opt_tpu/models/video_core.py` (reference
sam2_base_official.py:797-1179, `_prepare_memory_conditioned_features` and
`track_step`). The predictor chooses which memories take part (frame-index
arithmetic on the host); this module turns them into one padded memory:

    spatial memory : S slots x [B, mem_dim, g, g]  + per-slot tpos index + validity
    object pointers: P slots x [B, C]              + per-pointer tpos value + validity

The positional encodings the reference stores per frame (maskmem_pos_enc,
the current frame's sine PE) are constants per shape, cached per device and
dtype. Memory features are stored in bf16 in both precisions (reference
:885-888).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.ops import posenc
from sam2_opt_tpu_torch.ops.common import constant_cache


class MemoryInput(NamedTuple):
    """The memory for one tracking step, batched over objects (B objects
    tracked together; the reference loops objects at B = 1). The index and
    mask fields are host arrays as the predictor gathers them, or device
    tensors after `on_device`, which a step captured into a CUDA graph needs."""

    feats: tuple           # S x [B, mem_dim, g, g] spatial memory features (bf16)
    tpos_idx: np.ndarray   # [B, S] int index into maskmem_tpos_enc
    valid: np.ndarray      # [B, S] bool
    ptrs: tuple            # P x [B, C] object pointers (fp32)
    ptr_pos: np.ndarray    # [B, P] float32 normalized temporal distance
    ptr_valid: np.ndarray  # [B, P] bool


def on_device(mem: MemoryInput, device) -> MemoryInput:
    """The host fields as device tensors, copied before the step: a copy
    from pageable host memory cannot be captured into a CUDA graph."""
    return mem._replace(
        tpos_idx=torch.as_tensor(mem.tpos_idx, device=device).long(),
        valid=torch.as_tensor(mem.valid, device=device),
        ptr_pos=torch.as_tensor(mem.ptr_pos, device=device),
        ptr_valid=torch.as_tensor(mem.ptr_valid, device=device))


@constant_cache(maxsize=8)
def _sine_tokens(h: int, w: int, c: int, device, dtype):
    """[h*w, c] sine PE of a feature grid, a constant per shape (built
    outside inference mode, so training can use what a predictor cached)."""
    with torch.inference_mode(False):
        return posenc.sine_pos_embed_2d(h, w, c).reshape(h * w, c).to(device, dtype)


def _memory_tokens(m: base.SAM2Base, cfg: SAM2Config, mem: MemoryInput, dtype):
    """Padded kv tokens, their positions and the validity mask for memory
    attention (reference :870-948). Spatial tokens get the memory encoder's
    sine PE plus the learned temporal slot embedding; each pointer gets the
    1-D sine temporal PE through obj_ptr_tpos_proj and is split into
    C / mem_dim tokens. Returns (tokens, positions, kv_mask, spatial count)."""
    feats, device = mem.feats, mem.feats[0].device
    S = len(feats)
    B, D, gh, gw = feats[0].shape
    L = gh * gw
    C = cfg.hidden_dim
    tokens_per_ptr = C // D

    spatial = torch.stack([f.flatten(2).transpose(1, 2) for f in feats], 1)  # [B, S, L, D]
    spatial = spatial.reshape(B, S * L, D).to(dtype)
    tpos_idx = torch.as_tensor(mem.tpos_idx, device=device).long()
    tpos = m.maskmem_tpos_enc[tpos_idx][:, :, :, 0].to(dtype)  # [B, S, 1, D]
    spatial_pos = (_sine_tokens(gh, gw, D, device, dtype)[None, None] + tpos).reshape(B, S * L, D)

    ptrs = torch.stack([x.float() for x in mem.ptrs], 1)  # [B, P, C]
    P = ptrs.shape[1]
    ptr_pos = torch.as_tensor(mem.ptr_pos, device=device)
    if not cfg.add_tpos_enc_to_obj_ptrs:
        ptr_pe = torch.zeros(B, P, D, dtype=dtype, device=device)
    elif cfg.proj_tpos_enc_in_obj_ptrs:
        ptr_pe = m.obj_ptr_tpos_proj(posenc.get_1d_sine_pe(ptr_pos, C).to(dtype))  # [B, P, D]
    else:
        ptr_pe = posenc.get_1d_sine_pe(ptr_pos, D).to(dtype)
    ptr_tokens = ptrs.to(dtype).reshape(B, P * tokens_per_ptr, D)
    ptr_pos_tokens = ptr_pe.repeat_interleave(tokens_per_ptr, dim=1)  # [B, P*t, D]

    valid = torch.as_tensor(mem.valid, device=device)[:, :, None].expand(B, S, L)
    ptr_valid = torch.as_tensor(mem.ptr_valid, device=device)[:, :, None]
    kv_mask = torch.cat([valid.reshape(B, S * L),
                         ptr_valid.expand(B, P, tokens_per_ptr).reshape(B, P * tokens_per_ptr)], 1)
    return (torch.cat([spatial, ptr_tokens], 1), torch.cat([spatial_pos, ptr_pos_tokens], 1),
            kv_mask, S * L)


def condition_on_memory(m: base.SAM2Base, cfg: SAM2Config, curr_feat, mem: MemoryInput):
    """Memory-conditioned current-frame features [B,C,h,w] (reference
    :797-976, non-initial path)."""
    B, C, H, W = curr_feat.shape
    dtype = curr_feat.dtype
    tokens, positions, kv_mask, num_frame_tokens = _memory_tokens(m, cfg, mem, dtype)
    curr_pos = _sine_tokens(H, W, C, curr_feat.device, dtype).expand(B, H * W, C)
    return base.condition_features(m, curr_feat, curr_pos, tokens, positions, kv_mask,
                                   num_frame_tokens)


def _finalize(m: base.SAM2Base, cfg: SAM2Config, raw_embed, sam_outputs, run_mem_encoder: bool,
              is_mask_from_pts: bool, keep_multimasks: bool = False):
    """The stored per-frame outputs. The memory encoder reads the raw frame
    features, not the memory-conditioned ones (reference track_step
    :1167-1177). Hole filling runs after this step, as the reference applies
    fill_holes_in_mask_scores after track_step. `keep_multimasks` adds every
    multimask slot as `all_pred_masks` (fp32), for the DAM4SAM track's
    distractor analysis (reference sam2_base_dam4sam.py:447-501)."""
    low_res_multimasks, _, ious, low_res_masks, high_res_masks, obj_ptr, object_score_logits = \
        sam_outputs
    out = {
        "pred_masks": low_res_masks,
        "obj_ptr": obj_ptr.float(),
        "object_score_logits": object_score_logits.float(),
        "ious": ious.float(),
    }
    if keep_multimasks:
        out["all_pred_masks"] = low_res_multimasks.float()
    if run_mem_encoder and cfg.num_maskmem > 0:
        maskmem, _ = base.encode_new_memory(m, cfg, raw_embed, high_res_masks,
                                            object_score_logits, is_mask_from_pts)
        out["maskmem_features"] = _stored_memory(maskmem)
    return out


def track_step_init(m: base.SAM2Base, cfg: SAM2Config, feats: Tuple, point_coords, point_labels,
                    mask_inputs, prev_sam_mask_logits=None, multimask_output: bool = True,
                    run_mem_encoder: bool = False, keep_multimasks: bool = False):
    """Initial conditioning frame: the no-memory embedding path (reference
    :951-957 + track_step). feats = (hrf0, hrf1, embed) NCHW, batch 1;
    point_coords [1,P,2] / point_labels [1,P] or None; mask_inputs
    [1,1,S,S] binary or None; prev_sam_mask_logits [1,1,S/4,S/4] or None."""
    hrf0, hrf1, embed = feats
    pix_feat = base.no_mem_features(m, embed)
    return _track_with_features(m, cfg, (hrf0, hrf1, pix_feat), embed, point_coords,
                                point_labels, mask_inputs, prev_sam_mask_logits,
                                multimask_output, run_mem_encoder,
                                is_mask_from_pts=point_coords is not None,
                                keep_multimasks=keep_multimasks)


def track_step_conditioned(m: base.SAM2Base, cfg: SAM2Config, feats: Tuple, mem: MemoryInput,
                           point_coords=None, point_labels=None, prev_sam_mask_logits=None,
                           multimask_output: bool = True, run_mem_encoder: bool = True,
                           mask_inputs=None, keep_multimasks: bool = False):
    """Tracked frame: memory attention + SAM heads + memory encoder
    (reference track_step :1114-1179, non-initial branch). `mask_inputs`
    reaches here only when use_mask_input_as_output_without_sam is False."""
    hrf0, hrf1, embed = feats
    pix_feat = condition_on_memory(m, cfg, embed, mem)
    return _track_with_features(m, cfg, (hrf0, hrf1, pix_feat), embed, point_coords,
                                point_labels, mask_inputs, prev_sam_mask_logits,
                                multimask_output, run_mem_encoder,
                                is_mask_from_pts=point_coords is not None,
                                keep_multimasks=keep_multimasks)


def _track_with_features(m, cfg, feats, raw_embed, point_coords, point_labels, mask_inputs,
                         prev_sam_mask_logits, multimask_output, run_mem_encoder,
                         is_mask_from_pts, keep_multimasks=False):
    hrf0, hrf1, pix_feat = feats
    if mask_inputs is not None and cfg.use_mask_input_as_output_without_sam:
        # the reference runs the pointer's SAM heads on the raw backbone
        # features, on initial and tracked frames alike (:1051-1058)
        sam_outputs = base.use_mask_as_output(m, cfg, raw_embed, (hrf0, hrf1), mask_inputs)
    else:
        B, device = pix_feat.shape[0], pix_feat.device
        if point_coords is None:
            point_coords = torch.zeros(B, 1, 2, device=device)
            point_labels = -torch.ones(B, 1, dtype=torch.int32, device=device)
        mask_prompt = None
        if prev_sam_mask_logits is not None:
            mask_prompt = prev_sam_mask_logits
        elif mask_inputs is not None:
            # a dense SAM prompt, antialias-downsized to the prompt grid
            # (reference _forward_sam_heads :402-416)
            prompt_hw = (pix_feat.shape[-2] * 4, pix_feat.shape[-1] * 4)
            mask_prompt = mask_inputs.float()
            if tuple(mask_prompt.shape[-2:]) != prompt_hw:
                mask_prompt = base.resize_hw(mask_prompt, prompt_hw, "bilinear", antialias=True)
        sam_outputs = base.forward_sam_heads(m, cfg, pix_feat, point_coords, point_labels,
                                             mask_inputs=mask_prompt,
                                             high_res_features=(hrf0, hrf1),
                                             multimask_output=multimask_output)
    return _finalize(m, cfg, raw_embed, sam_outputs, run_mem_encoder, is_mask_from_pts,
                     keep_multimasks)


def encode_memory_only(m: base.SAM2Base, cfg: SAM2Config, embed, high_res_masks,
                       object_score_logits, is_mask_from_pts: bool):
    """Standalone memory-encoder run (reference _run_memory_encoder
    :911-945). Returns bf16 features [B, mem_dim, g, g]."""
    maskmem, _ = base.encode_new_memory(m, cfg, embed, high_res_masks, object_score_logits,
                                        is_mask_from_pts)
    return _stored_memory(maskmem)


def _stored_memory(maskmem):
    """bf16, contiguous like the bank's zero slots (the memory encoder's
    convolutions may hand back channels-last): a tracking step captured as a
    CUDA graph is keyed on its inputs' strides, so one layout keeps one
    graph per memory capacity however many slots are filled."""
    return maskmem.to(torch.bfloat16, memory_format=torch.contiguous_format)
