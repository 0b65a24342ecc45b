"""Segmentation losses (reference sam2/training/loss_fns.py).

Counterpart of `sam2_opt_tpu/training/losses.py`: dice / sigmoid-focal / IoU
losses and the multi-step multi-mask combination of SAM2 training: for each
step's multimask outputs, supervise the argmin-loss mask slot, plus the IoU
head and the occlusion (object-score) head. The loss math runs in fp32
whatever the rollout's compute dtype.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def dice_loss(inputs, targets, num_objects, loss_on_multimask=False):
    """reference loss_fns.py:20-49. inputs/targets: [N, M, H, W] logits/binary."""
    probs = torch.sigmoid(inputs)
    lead = 2 if loss_on_multimask else 1
    flat_p = probs.reshape(*probs.shape[:lead], -1)
    flat_t = targets.reshape(*targets.shape[:lead], -1)
    numerator = 2 * (flat_p * flat_t).sum(-1)
    denominator = flat_p.sum(-1) + flat_t.sum(-1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    if loss_on_multimask:
        return loss / num_objects  # [N, M]
    return loss.sum() / num_objects


def sigmoid_focal_loss(inputs, targets, num_objects, alpha=0.25, gamma=2.0,
                       loss_on_multimask=False):
    """reference loss_fns.py:52-90."""
    prob = torch.sigmoid(inputs)
    ce_loss = inputs.clamp_min(0) - inputs * targets + torch.log1p(torch.exp(-inputs.abs()))
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce_loss * ((1 - p_t) ** gamma)
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    if loss_on_multimask:
        return loss.reshape(*loss.shape[:2], -1).mean(-1) / num_objects
    return loss.reshape(loss.shape[0], -1).mean(-1).sum() / num_objects


def iou_loss(inputs, targets, pred_ious, num_objects, use_l1_loss=True):
    """L1 (or L2) between predicted IoU and the IoU of the thresholded masks
    (reference loss_fns.py:93-123). inputs/targets [N,M,H,W], pred_ious [N,M]."""
    pred_mask = (inputs.reshape(*inputs.shape[:2], -1) > 0).float()
    gt_mask = (targets.reshape(*targets.shape[:2], -1) > 0).float()
    area_i = (pred_mask * gt_mask).sum(-1)
    area_u = pred_mask.sum(-1) + gt_mask.sum(-1) - area_i
    actual_ious = area_i / area_u.clamp_min(1.0)
    if use_l1_loss:
        loss = (pred_ious - actual_ious).abs()
    else:
        loss = (pred_ious - actual_ious) ** 2
    return loss / num_objects  # [N, M]


def multistep_multimasks_and_ious(
    outs_multimasks: List[torch.Tensor],   # per step: [N, M, H, W] logits
    outs_ious: List[torch.Tensor],         # per step: [N, M]
    outs_obj_scores: List[torch.Tensor],   # per step: [N, 1]
    target_masks,                          # [N, 1, H, W] binary
    num_objects,
    weight_dict=None,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    pred_obj_scores: bool = True,
    obj_valid=None,
) -> Dict[str, torch.Tensor]:
    """reference MultiStepMultiMasksAndIous (loss_fns.py:126-307): per-step
    multimask losses, supervising the argmin-loss slot; weights follow the
    MOSE recipe {mask:20, dice:1, iou:1, class:1}. `obj_valid` ([N] bool)
    marks real object slots: padded slots contribute zero to every term, and
    `num_objects` is then the count of valid objects."""
    if weight_dict is None:
        weight_dict = {"loss_mask": 20.0, "loss_dice": 1.0, "loss_iou": 1.0, "loss_class": 1.0}
    losses = {"loss_mask": 0.0, "loss_dice": 0.0, "loss_iou": 0.0, "loss_class": 0.0}
    for masks, ious, obj_scores in zip(outs_multimasks, outs_ious, outs_obj_scores):
        # fp32 whatever the compute dtype (bf16 logits lose too much in the
        # log-sigmoid and focal terms)
        masks, ious, obj_scores = masks.float(), ious.float(), obj_scores.float()
        target = target_masks.float().expand_as(masks)
        target_obj = (target_masks.reshape(target_masks.shape[0], -1) > 0).any(
            -1, keepdim=True).float()

        loss_mm = sigmoid_focal_loss(masks, target, num_objects, focal_alpha, focal_gamma,
                                     loss_on_multimask=True)
        loss_md = dice_loss(masks, target, num_objects, loss_on_multimask=True)
        loss_mi = iou_loss(masks, target, ious, num_objects)
        if pred_obj_scores:
            loss_class = sigmoid_focal_loss(obj_scores, target_obj, num_objects, alpha=-1.0,
                                            gamma=0.0, loss_on_multimask=True)
            # mask losses only where the object exists
            loss_mm = loss_mm * target_obj
            loss_md = loss_md * target_obj
            loss_mi = loss_mi * target_obj
        else:
            loss_class = masks.new_zeros(masks.shape[0], 1)
        if obj_valid is not None:
            v = obj_valid.float()[:, None]
            loss_mm, loss_md, loss_mi, loss_class = (x * v for x in
                                                     (loss_mm, loss_md, loss_mi, loss_class))

        # the slot with the lowest focal + dice loss; the IoU term is not part
        # of the choice, "to be consistent w/ SAM" (loss_fns.py:268-281)
        combined = loss_mm * weight_dict["loss_mask"] + loss_md * weight_dict["loss_dice"]
        best = combined.argmin(-1, keepdim=True)  # [N, 1]
        losses["loss_mask"] = losses["loss_mask"] + loss_mm.gather(-1, best).sum()
        losses["loss_dice"] = losses["loss_dice"] + loss_md.gather(-1, best).sum()
        losses["loss_iou"] = losses["loss_iou"] + loss_mi.gather(-1, best).sum()
        losses["loss_class"] = losses["loss_class"] + loss_class.sum()

    losses["core_loss"] = sum(weight_dict[k] * v for k, v in losses.items())
    return losses
