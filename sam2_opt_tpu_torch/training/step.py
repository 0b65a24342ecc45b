"""The image fine-tune step, data- and tensor-parallel.

Counterpart of `sam2_opt_tpu/training/step.py` (reference
Trainer._run_step / SAM2Train forward, training/trainer.py:845,
training/model/sam2.py:107 at `num_frames=1`): encode, one click at each
mask's centre, the SAM heads with multimask output, the multimask losses,
the gradients and an AdamW update. With a mesh (`parallel/mesh.py`) every
rank takes its rows of the global batch, the loss and the gradients are
averaged over "data" and the TP rule's linears are column-parallel over
"model" (`parallel/tp.py`; the replicated gradients are averaged over
"model" too), where the JAX package's GSPMD inserts the collectives.
"""

from __future__ import annotations

import collections
from typing import Dict, NamedTuple

import torch

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
from sam2_opt_tpu_torch.parallel import tp as tp_lib
from sam2_opt_tpu_torch.training import losses as L
from sam2_opt_tpu_torch.training.optimizer import ScheduledOptimizer, constant_schedule

METRICS = ("loss_mask", "loss_dice", "loss_iou", "loss_class")


class TrainState(NamedTuple):
    model: base.SAM2Base  # its parameters are the fp32 masters, updated in place
    opt_state: Dict
    step: int
    sharded: Dict[str, int]  # {name: dim} of the TP shards (`tp.shard_module`)


def sample_center_points(masks):
    """The centre-of-mass click of each mask (a simple stand-in for the
    reference's error-region sampling, sam2_utils.py:202-317).
    masks [B, 1, H, W] binary -> coords [B, 1, 2] (x, y), labels [B, 1]."""
    B, _, H, W = masks.shape
    m = masks[:, 0].float()
    total = m.sum((1, 2)).clamp(min=1.0)
    ys = (m * torch.arange(H, device=m.device)[None, :, None]).sum((1, 2)) / total
    xs = (m * torch.arange(W, device=m.device)[None, None, :]).sum((1, 2)) / total
    coords = torch.stack([xs, ys], -1)[:, None, :]
    return coords, torch.ones(B, 1, dtype=torch.int32, device=masks.device)


def forward_loss(model: base.SAM2Base, cfg: SAM2Config, images, gt_masks):
    """images [B, S, S, 3] in [0, 1]; gt_masks [B, 1, S, S] binary. Returns
    (loss, {loss parts})."""
    img = base.image_normalize(images.permute(0, 3, 1, 2))
    hrf0, hrf1, embed = base.forward_image(model, img)["backbone_fpn"]
    embed = base.no_mem_features(model, embed)
    coords, labels = sample_center_points(gt_masks)
    coords = coords * (cfg.image_size / gt_masks.shape[-1])
    _, high_res_multimasks, ious, _, _, _, object_score_logits = base.forward_sam_heads(
        model, cfg, embed, coords, labels, high_res_features=(hrf0, hrf1),
        multimask_output=True)
    target = base.resize_hw(gt_masks.float(), tuple(high_res_multimasks.shape[-2:]), "bilinear")
    target = (target >= 0.5).float()
    loss_dict = L.multistep_multimasks_and_ious(
        [high_res_multimasks], [ious], [object_score_logits], target, float(gt_masks.shape[0]),
        pred_obj_scores=cfg.pred_obj_scores)
    return loss_dict["core_loss"], loss_dict


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 0.1,
                   grad_clip: float = 0.1) -> ScheduledOptimizer:
    """AdamW after global-norm clipping (reference optimizer.py defaults):
    the JAX package's `optax.chain(clip_by_global_norm, adamw)`, whose
    weight decay reaches every parameter."""
    opt = ScheduledOptimizer({}, constant_schedule(learning_rate), weight_decay=weight_decay,
                             grad_clip_norm=grad_clip)
    opt.decay_mask = collections.defaultdict(lambda: True)
    return opt


def init_train_state(model: base.SAM2Base, optimizer, mesh=None) -> TrainState:
    """The state of step 0; under a mesh the model first keeps its TP
    shards (`parallel/tp.py`)."""
    sharded = tp_lib.shard_module(model, mesh) if mesh is not None else {}
    return TrainState(model, optimizer.init(dict(model.named_parameters())), 0, sharded)


def make_train_step(cfg: SAM2Config, optimizer, mesh=None):
    """`step(state, images, gt_masks) -> (state, metrics)` on the global
    batch (every rank is handed the same); under a mesh each rank computes
    its rows, and the loss and the gradients are averaged over "data"
    (`tp.reduce_step`)."""

    def step(state: TrainState, images, gt_masks):
        model = state.model
        if mesh is not None:
            images, gt_masks = mesh_lib.data_sharded(mesh, images), mesh_lib.data_sharded(
                mesh, gt_masks)
        names, params = zip(*model.named_parameters())
        loss, aux = forward_loss(model, cfg, images, gt_masks)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        scalars = torch.stack([loss.detach()] + [aux[k].detach() for k in METRICS])
        scalars, grads, norm = tp_lib.reduce_step(mesh, scalars, dict(zip(names, grads)),
                                                  state.sharded)
        updates, opt_state = optimizer.update(grads, state.opt_state, dict(zip(names, params)),
                                              optimizer.lr_at(0.0), **norm)
        with torch.no_grad():
            for n, p in zip(names, params):
                p.add_(updates[n])
        metrics = {"loss": scalars[0], **dict(zip(METRICS, scalars[1:]))}
        return state._replace(opt_state=opt_state, step=state.step + 1), metrics

    return step
