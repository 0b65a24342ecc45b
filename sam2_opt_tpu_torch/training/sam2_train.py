"""SAM2 video training forward: simulated interactive tracking.

Counterpart of `sam2_opt_tpu/training/sam2_train.py` (reference
sam2/training/model/sam2.py:25-541, SAM2Train): the tracker runs over T
frames of one video; the initial conditioning frames get a sampled point,
box or mask prompt, later frames are tracked from memory, and correction
clicks are sampled from the error region between prediction and ground truth
(reference sam2_utils.py:156-323).

Randomness comes from an explicit `torch.Generator`. Every random number a
frame needs is drawn before the frame runs and handed to it as a uniform
tensor, so a frame recomputed under `torch.utils.checkpoint` samples the
same clicks. The two packages draw different numbers from the same seed;
tests replace the samplers in both with one deterministic pick.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.models import video_core as vc
from sam2_opt_tpu_torch.training import losses as L


def _uniform(gen: torch.Generator, *shape):
    return torch.rand(*shape, generator=gen, device=gen.device)


def sample_random_points_from_errors(u, gt_masks, pred_masks):
    """Correction clicks drawn uniformly from the error region (reference
    sam2_utils.py:202-260). u [B, num_pts] uniform in [0, 1) picks the
    pixel; gt/pred [B, 1, H, W] bool. Where the prediction is exact, a
    negative click on the background (sam2_utils.py:236-242). Returns
    (coords [B, num_pts, 2] xy, labels [B, num_pts] int32)."""
    B, _, H, W = gt_masks.shape
    gt, pred = gt_masks[:, 0], pred_masks[:, 0]
    fp = ~gt & pred
    fn = gt & ~pred
    error = fp | fn
    any_error = error.reshape(B, -1).any(-1)
    pool = torch.where(any_error[:, None, None], error, ~gt).reshape(B, -1)
    # an empty pool (an all-foreground exact mask) draws from every pixel, as
    # a categorical over equal logits does
    pool = pool | ~pool.any(-1, keepdim=True)
    cum = pool.long().cumsum(-1)                                  # [B, HW]
    total = cum[:, -1:]
    target = (u.double() * total).long().clamp(max=total - 1) + 1  # [B, num_pts] in 1..total
    idx = torch.searchsorted(cum, target)                          # the target-th pool pixel
    coords = torch.stack([(idx % W).float(), (idx // W).float()], -1)
    labels = fn.reshape(B, -1).gather(1, idx).int()  # FN clicks positive, FP and fallback negative
    return coords, labels


def sample_box_points(u, masks, noise: float = 0.1, noise_bound: int = 20):
    """Box prompt as two corner points (labels 2/3) from a GT mask, jittered
    by u [B, 4] uniform in [-1, 1) times min(noise * box side, noise_bound)
    (reference sam2_utils.py:156-199). masks [B, 1, H, W] bool."""
    B, _, H, W = masks.shape
    ys = masks[:, 0].any(2)  # [B, H]
    xs = masks[:, 0].any(1)  # [B, W]
    yi = torch.arange(H, device=masks.device)
    xi = torch.arange(W, device=masks.device)
    y0 = torch.where(ys, yi, H).amin(1).float()
    y1 = torch.where(ys, yi, -1).amax(1).float()
    x0 = torch.where(xs, xi, W).amin(1).float()
    x1 = torch.where(xs, xi, -1).amax(1).float()
    if noise > 0:
        bw, bh = x1 - x0, y1 - y0
        mag = (torch.stack([bw, bh, bw, bh], -1) * noise).clamp(max=float(noise_bound))
        jitter = u * mag
        x0 = (x0 + jitter[:, 0]).clamp(0, W - 1)
        y0 = (y0 + jitter[:, 1]).clamp(0, H - 1)
        x1 = (x1 + jitter[:, 2]).clamp(0, W - 1)
        y1 = (y1 + jitter[:, 3]).clamp(0, H - 1)
    coords = torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y1], -1)], 1)
    labels = torch.tensor([2, 3], dtype=torch.int32, device=masks.device).expand(B, 2)
    return coords, labels


def _init_prompt(u, gt_masks, use_box: bool):
    """Initial prompt in a static [B, 2] layout: the two jittered box corners
    (labels 2/3), or one positive click from the GT mask plus one padding
    point (label -1). u: [B, 4] in [-1, 1) for a box, [B, 1] in [0, 1) for a
    click."""
    if use_box:
        return sample_box_points(u, gt_masks)
    coords, labels = sample_random_points_from_errors(u, gt_masks, torch.zeros_like(gt_masks))
    B = coords.shape[0]
    return (torch.cat([coords, coords.new_zeros(B, 1, 2)], 1),
            torch.cat([labels, -torch.ones_like(labels[:, :1])], 1))


def _training_memory(cfg: SAM2Config, frame_idx: int, num_frames: int, cond_mems: Dict,
                     noncond_mems: Dict, cond_ptrs: Dict, noncond_ptrs: Dict, mem_cap: int,
                     ptr_cap: int) -> vc.MemoryInput:
    """The memory of one tracked frame, chosen as the reference's training
    mode chooses it (sam2_base_official.py:616-760, stride 1): every
    initial-conditioning frame with temporal row num_maskmem - 1; the last
    num_maskmem - 1 non-conditioning frames, a frame at distance d with row
    d - 1; pointers of all conditioning frames plus non-conditioning ones at
    distances 1..max_obj_ptrs-1, at (frame_idx - t) / (min(T, max_ptrs) - 1).
    Padded to `mem_cap` slots and `ptr_cap` pointers."""
    entries = [(cfg.num_maskmem - 1, cond_mems[t]) for t in sorted(cond_mems)]
    for d in range(cfg.num_maskmem - 1, 0, -1):
        if frame_idx - d in noncond_mems:
            entries.append((d - 1, noncond_mems[frame_idx - d]))
    assert len(entries) <= mem_cap, (len(entries), mem_cap)
    any_mem = entries[0][1]
    B = any_mem.shape[0]
    pad = mem_cap - len(entries)
    feats = tuple(f for _, f in entries) + (torch.zeros_like(any_mem),) * pad
    tpos = [r for r, _ in entries] + [0] * pad
    valid = [True] * len(entries) + [False] * pad

    max_obj_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
    t_diff_max = max(max_obj_ptrs - 1, 1)
    ptr_entries = [((frame_idx - t) / t_diff_max, cond_ptrs[t]) for t in sorted(cond_ptrs)]
    for d in range(1, max_obj_ptrs):
        t = frame_idx - d
        if t < 0:
            break
        if t in noncond_ptrs:
            ptr_entries.append((d / t_diff_max, noncond_ptrs[t]))
    assert len(ptr_entries) <= ptr_cap, (len(ptr_entries), ptr_cap)
    any_ptr = ptr_entries[0][1]
    ppad = ptr_cap - len(ptr_entries)
    ptrs = tuple(p for _, p in ptr_entries) + (torch.zeros_like(any_ptr),) * ppad
    ppos = [x for x, _ in ptr_entries] + [0.0] * ppad
    pvalid = [True] * len(ptr_entries) + [False] * ppad

    tile = lambda x, dtype: np.tile(np.asarray(x, dtype)[None], (B, 1))  # noqa: E731
    return vc.MemoryInput(feats=feats, tpos_idx=tile(tpos, np.int32), valid=tile(valid, bool),
                          ptrs=ptrs, ptr_pos=tile(ppos, np.float32),
                          ptr_valid=tile(pvalid, bool))


def forward_tracking(m: base.SAM2Base, cfg: SAM2Config, images, gt_masks, gen: torch.Generator,
                     num_init_cond_frames: int = 1, use_box_input: bool = False,
                     use_mask_input: bool = False, num_correction_clicks: int = 1,
                     use_remat: bool = True, remat_frames: bool = False,
                     frames_to_add_correction_pt: Tuple[int, ...] = (), obj_valid=None):
    """Simulated interactive tracking over T frames of one video (reference
    model/sam2.py:269-447). images [T, S, S, 3] in [0, 1] in the compute
    dtype, gt_masks [T, B_obj, S, S] bool, `gen` on the images' device.

    Initial frames get a point, box (`use_box_input`) or GT-mask
    (`use_mask_input`) prompt; under point input they, and the tracked frames
    in `frames_to_add_correction_pt`, get `num_correction_clicks` correction
    clicks, and every correction step is supervised. `use_remat` runs the
    batched encoder under `torch.utils.checkpoint`, `remat_frames` each
    frame's step. Returns per-frame lists of steps of (high-res multimask
    logits, ious, object scores) and the per-frame targets."""
    T, B = images.shape[0], gt_masks.shape[1]
    grad = torch.is_grad_enabled()

    def encode(img):
        out = base.forward_image(m, base.image_normalize(img.permute(0, 3, 1, 2)))
        return tuple(out["backbone_fpn"])

    feats_all = checkpoint(encode, images, use_reentrant=False) if use_remat and grad else \
        encode(images)

    outs_masks, outs_ious, outs_scores, targets = [], [], [], []
    cond_mems, noncond_mems, cond_ptrs, noncond_ptrs = {}, {}, {}, {}
    mem_cap = num_init_cond_frames + cfg.num_maskmem - 1
    ptr_cap = num_init_cond_frames + min(T, cfg.max_obj_ptrs_in_encoder) - 1

    for t in range(T):
        gt_t = gt_masks[t][:, None]  # [B, 1, S, S]
        f0, f1, f2 = (f[t:t + 1].expand(B, -1, -1, -1) for f in feats_all)
        is_init = t < num_init_cond_frames
        correct_here = ((is_init and not use_mask_input)
                        or (not is_init and t in frames_to_add_correction_pt))
        n_clicks = num_correction_clicks if correct_here else 0
        # every random number of the frame, drawn before it runs
        init_u = None
        if is_init and not use_mask_input:
            init_u = _uniform(gen, B, 4) * 2 - 1 if use_box_input else _uniform(gen, B, 1)
        click_u = _uniform(gen, n_clicks, B, 1) if n_clicks else None
        mem = None
        if not is_init:
            mem = _training_memory(cfg, t, T, cond_mems, noncond_mems, cond_ptrs, noncond_ptrs,
                                   mem_cap, ptr_cap)

        def one_frame(f0, f1, f2, gt_t, mem, init_u, click_u, _is_init=is_init,
                      _n_clicks=n_clicks):
            if _is_init:
                pix_feat = base.no_mem_features(m, f2)
                coords = labels = None
                if not use_mask_input:
                    coords, labels = _init_prompt(init_u, gt_t, use_box_input)
            else:
                pix_feat = vc.condition_on_memory(m, cfg, f2, mem)
                coords = pix_feat.new_zeros(B, 1, 2, dtype=torch.float32)
                labels = -torch.ones(B, 1, dtype=torch.int32, device=pix_feat.device)

            def sam_step(coords, labels, mask_prompt=None):
                return base.forward_sam_heads(m, cfg, pix_feat, coords, labels,
                                              mask_inputs=mask_prompt,
                                              high_res_features=(f0, f1), multimask_output=True)

            if _is_init and use_mask_input:
                # GT mask as the prompt (reference _use_mask_as_output)
                outs = base.use_mask_as_output(m, cfg, pix_feat, (f0, f1), gt_t.float())
            else:
                outs = sam_step(coords, labels)
            _, high_mm, ious, low_res, high_res, obj_ptr, obj_score = outs
            step_masks, step_ious, step_scores = [high_mm], [ious], [obj_score]
            for ci in range(_n_clicks):
                c2, l2 = sample_random_points_from_errors(click_u[ci], gt_t, high_res > 0)
                coords = torch.cat([coords, c2], 1)
                labels = torch.cat([labels, l2], 1)
                outs = sam_step(coords, labels, low_res.clamp(-32.0, 32.0))
                _, high_mm, ious, low_res, high_res, obj_ptr, obj_score = outs
                step_masks.append(high_mm)
                step_ious.append(ious)
                step_scores.append(obj_score)
            # is_mask_from_pts: True iff this frame had point inputs
            had_points = (_is_init and not use_mask_input) or _n_clicks > 0
            maskmem, _ = base.encode_new_memory(m, cfg, f2, high_res, obj_score,
                                                is_mask_from_pts=had_points)
            return tuple(step_masks), tuple(step_ious), tuple(step_scores), maskmem, obj_ptr

        args = (f0, f1, f2, gt_t, mem, init_u, click_u)
        if remat_frames and grad:
            out = checkpoint(one_frame, *args, use_reentrant=False)
        else:
            out = one_frame(*args)
        step_masks, step_ious, step_scores, maskmem, obj_ptr = out
        outs_masks.append(list(step_masks))
        outs_ious.append(list(step_ious))
        outs_scores.append(list(step_scores))
        targets.append(gt_t)
        if obj_valid is not None:
            # padded object slots never enter memory
            vb = obj_valid.to(maskmem.dtype)
            maskmem = maskmem * vb[:, None, None, None]
            obj_ptr = obj_ptr * vb[:, None].to(obj_ptr.dtype)
        if is_init:
            cond_mems[t], cond_ptrs[t] = maskmem, obj_ptr
        else:
            noncond_mems[t], noncond_ptrs[t] = maskmem, obj_ptr
            # only the last num_maskmem-1 / max_obj_ptrs-1 can be chosen again
            for old in [k for k in noncond_mems if k <= t - cfg.num_maskmem]:
                noncond_mems.pop(old)
            for old in [k for k in noncond_ptrs if k <= t - min(T, cfg.max_obj_ptrs_in_encoder)]:
                noncond_ptrs.pop(old)
    return outs_masks, outs_ious, outs_scores, targets


def video_train_loss(m: base.SAM2Base, cfg: SAM2Config, images, gt_masks, gen, obj_valid=None,
                     **kwargs):
    """Scalar training loss of one video (reference loss_fns.py:126
    MultiStepMultiMasksAndIous), summed over frames; every correction step
    is supervised. `obj_valid` ([N_obj] bool) excludes padded object slots
    from every term and from the object count. Returns (loss, aux)."""
    masks, ious, scores, targets = forward_tracking(m, cfg, images, gt_masks, gen,
                                                    obj_valid=obj_valid, **kwargs)
    B = gt_masks.shape[1]
    num_objects = float(B) if obj_valid is None else obj_valid.float().sum().clamp_min(1.0)
    total = 0.0
    aux = {"loss_mask": 0.0, "loss_dice": 0.0, "loss_iou": 0.0, "loss_class": 0.0}
    for mm, ii, ss, tgt in zip(masks, ious, scores, targets):
        ld = L.multistep_multimasks_and_ious(mm, ii, ss, tgt.float(), num_objects,
                                             pred_obj_scores=cfg.pred_obj_scores,
                                             obj_valid=obj_valid)
        total = total + ld["core_loss"]
        for k in aux:
            aux[k] = aux[k] + ld[k]
    return total, aux
