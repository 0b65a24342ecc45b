"""Trainer: the training loop (re-design of sam2/training/trainer.py:141-1113).

Counterpart of `sam2_opt_tpu/training/trainer.py` on one device: the step
(forward-tracking rollout over each video of the batch, loss, backward,
optimizer update) as a plain function, with
- remat "none" / "encoder" / "blocks" / "blocks_frames" through
  `torch.utils.checkpoint`;
- gradient accumulation over strided micro-batches;
- mixed precision: the rollout in bf16 through bf16 copies of the fp32
  master parameters, differentiated with respect to the masters
  (`torch.func.functional_call`); loss math, gradients and the optimizer
  stay fp32;
- a frozen image encoder (gradients and updates zeroed);
- meters, TensorBoard logging where available, atomic checkpoints with
  resume discovery, a hard stop on a non-finite loss, and a val loop.
A mesh (data or tensor parallelism) and bf16 gradient collectives are not
ported yet (ROADMAP, Queue A item 13).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.models.sam2_base import SAM2Base
from sam2_opt_tpu_torch.training import sam2_train
from sam2_opt_tpu_torch.training.checkpoints import CheckpointManager
from sam2_opt_tpu_torch.training.meters import AverageMeter, MemMeter, ProgressMeter
from sam2_opt_tpu_torch.training.optimizer import build_optimizer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainConfig:
    """Trainer knobs (reference OptimConf / CheckpointConf / LoggingConf,
    trainer.py:73-140); the JAX package's `TrainConfig`."""

    num_epochs: int = 1
    batch_size: int = 1
    num_frames: int = 4
    max_num_objects: int = 1
    base_lr: float = 5e-6
    weight_decay: float = 0.1
    grad_clip_norm: float = 0.1
    layer_decay: float = 0.9  # reference MOSE yaml layer_decay_value
    num_correction_clicks: int = 1
    # initial-prompt sampling (reference model/sam2.py knobs)
    prob_to_use_pt_input: float = 0.5
    prob_to_use_box_input: float = 0.5
    max_init_cond_frames: int = 1
    # frames receiving correction clicks, the initial ones included
    # (reference num_frames_to_correct_for_train, model/sam2.py:36)
    num_frames_to_correct: int = 1
    log_dir: str = "logs"
    checkpoint_dir: str = "checkpoints_train"
    save_freq_epochs: int = 1
    log_scalar_frequency: int = 10
    seed: int = 0
    freeze_image_encoder: bool = False
    # "none" | "encoder" (checkpoint the whole batched encoder) | "blocks"
    # (checkpoint every trunk block) | "blocks_frames" (blocks, and each
    # rollout frame's step)
    remat: str = "encoder"
    # sequential strided micro-batches per optimizer update
    grad_accum_steps: int = 1
    # "bfloat16": mixed precision, fp32 master weights / loss / optimizer
    # (the reference MOSE recipe's `amp: bfloat16`)
    compute_dtype: str = "float32"
    # bf16 gradient collectives: needs a mesh, not ported yet
    comms_dtype: Optional[str] = None


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet: the port trains on one device "
                               "(ROADMAP.md, Queue A item 13)")


class _LossAndGrads(nn.Module):
    """Holds the model so `functional_call` can swap its parameters for their
    bf16 copies for the whole forward AND backward (a checkpointed region
    recomputes inside the backward and must see the same copies)."""

    def __init__(self, model: SAM2Base):
        super().__init__()
        self.model = model

    def forward(self, loss_fn, masters, *args):
        loss, aux = loss_fn(self.model, *args)
        grads = torch.autograd.grad(loss, masters, allow_unused=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def build_train_step(model_cfg: SAM2Config, tcfg: TrainConfig, optimizer, mesh=None, *,
                     use_box: bool = False, use_mask: bool = False, n_init: int = 1,
                     correct_frames=()):
    """The training step, `step(model, opt_state, images, masks, obj_valid,
    gen, lr) -> (opt_state, metrics)`: images [B, T, S, S, 3] float in [0, 1],
    masks [B, T, N, S, S] bool, obj_valid [B, N] bool on the model's device,
    `gen` a torch.Generator there; the model's parameters are updated in
    place. Videos are looped and their losses averaged (the JAX step vmaps
    them); `grad_accum_steps` runs strided micro-batches (rows a, a + A, ...)
    before the one update."""
    if mesh is not None:
        raise _not_ported("a device mesh")
    if tcfg.comms_dtype:
        raise _not_ported("comms_dtype")
    cfg = model_cfg
    remat_blocks = tcfg.remat in ("blocks", "blocks_frames")
    use_remat = tcfg.remat == "encoder"
    remat_frames = tcfg.remat == "blocks_frames"
    accum = max(int(tcfg.grad_accum_steps), 1)
    compute_dtype = _DTYPES[tcfg.compute_dtype]
    frozen = tcfg.freeze_image_encoder

    def batch_loss(model, images, masks, obj_valid, gen):
        losses, auxs = [], []
        for b in range(images.shape[0]):
            loss, aux = sam2_train.video_train_loss(
                model, cfg, images[b], masks[b], gen, obj_valid=obj_valid[b],
                num_correction_clicks=tcfg.num_correction_clicks, use_box_input=use_box,
                use_mask_input=use_mask, num_init_cond_frames=n_init,
                frames_to_add_correction_pt=correct_frames, use_remat=use_remat,
                remat_frames=remat_frames)
            losses.append(loss)
            auxs.append(aux)
        n = len(losses)
        return sum(losses) / n, {k: sum(torch.as_tensor(a[k]) for a in auxs) / n for k in auxs[0]}

    def grads_of(model, images, masks, obj_valid, gen):
        names, masters = zip(*model.named_parameters())
        wrapper = _LossAndGrads(model)
        if compute_dtype == torch.float32:
            loss, aux, grads = wrapper(batch_loss, masters, images, masks, obj_valid, gen)
        else:
            # bf16 copies of the masters (and of the floating buffers, as the
            # JAX package casts its whole tree); the casts are in the graph,
            # so the gradients arrive at the fp32 masters
            cast = {f"model.{n}": p.to(compute_dtype) for n, p in zip(names, masters)}
            cast.update({f"model.{n}": b.to(compute_dtype) for n, b in model.named_buffers()
                         if b.is_floating_point()})
            loss, aux, grads = torch.func.functional_call(
                wrapper, cast, (batch_loss, masters, images.to(compute_dtype), masks, obj_valid,
                                gen))
        grads = {n: torch.zeros_like(p) if g is None else g.float()
                 for n, p, g in zip(names, masters, grads)}
        return loss, aux, grads

    def accum_grads(model, images, masks, obj_valid, gen):
        B = images.shape[0]
        if B % accum:
            raise ValueError(f"batch size {B} is not divisible by grad_accum_steps {accum}; "
                             "pick a batch size that is a multiple of grad_accum_steps")
        total = None
        for a in range(accum):
            # micro-batch a = rows a, a + accum, ... (the JAX package's strided split)
            out = grads_of(model, images[a::accum], masks[a::accum], obj_valid[a::accum], gen)
            if total is None:
                total = out
            else:
                total = (total[0] + out[0], {k: total[1][k] + out[1][k] for k in out[1]},
                         {n: total[2][n] + out[2][n] for n in out[2]})
        if accum == 1:
            return total
        inv = 1.0 / accum
        return (total[0] * inv, {k: v * inv for k, v in total[1].items()},
                {n: g * inv for n, g in total[2].items()})

    def step(model: SAM2Base, opt_state, images, masks, obj_valid, gen, lr: float):
        model.image_encoder.trunk.remat_blocks = remat_blocks
        loss, aux, grads = accum_grads(model, images, masks, obj_valid, gen)
        params = dict(model.named_parameters())
        if frozen:
            # zero the frozen encoder's gradients so they neither enter the
            # clip norm nor move the moments ...
            grads = {n: torch.zeros_like(g) if n.startswith("image_encoder") else g
                     for n, g in grads.items()}
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        with torch.no_grad():
            for n, p in params.items():
                # ... and skip their updates: weight decay would otherwise
                # shrink them (the reference freezes with requires_grad=False)
                if not (frozen and n.startswith("image_encoder")):
                    p.add_(updates[n])
        return opt_state, {"loss": loss, **aux}

    return step


class TensorBoardLogger:
    """TensorBoard writer (reference utils/logger.py:27-150); a no-op where
    tensorboard is not installed."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            os.makedirs(log_dir, exist_ok=True)
            self._writer = SummaryWriter(log_dir)
        except ImportError:
            pass

    def log(self, name: str, value, step: int):
        if self._writer is not None:
            self._writer.add_scalar(name, float(value), step)

    def close(self):
        if self._writer is not None:
            self._writer.close()


class Trainer:
    """Single-device trainer over a `SAM2Base` whose parameters are the fp32
    masters; the device is the model's."""

    def __init__(self, model_cfg: SAM2Config, model: SAM2Base, train_cfg: TrainConfig,
                 mesh=None):
        if mesh is not None:
            raise _not_ported("a device mesh")
        self.cfg = model_cfg
        self.tcfg = train_cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.optimizer = build_optimizer(
            dict(model.named_parameters()), base_lr=train_cfg.base_lr,
            weight_decay=train_cfg.weight_decay, grad_clip_norm=train_cfg.grad_clip_norm,
            layer_decay=train_cfg.layer_decay, trunk_depth=model_cfg.trunk.depth)
        self.opt_state = self.optimizer.init(dict(model.named_parameters()))
        self.steps = 0
        self.epoch = 0
        self.best_val_loss = float("inf")
        self.step_losses: list = []
        self.step_seconds: list = []  # host wall time of each step, ending in a sync
        self.ckpt = CheckpointManager(train_cfg.checkpoint_dir)
        self.tb = TensorBoardLogger(train_cfg.log_dir)
        self._step_fns = {}
        self._gen = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self._pyrng = random.Random(train_cfg.seed)

    def save_checkpoint(self):
        self.ckpt.save(self.steps, {
            "params": self.model.state_dict(), "opt_state": self.opt_state,
            "steps": self.steps, "epoch": self.epoch, "best_val_loss": self.best_val_loss})

    def load_checkpoint(self) -> bool:
        """Resume auto-discovery; True when resumed."""
        restored = self.ckpt.restore(map_location=self.device)
        if restored is None:
            return False
        self.model.load_state_dict(restored["params"], strict=True)
        self.opt_state = restored["opt_state"]
        self.steps = int(restored["steps"])
        self.epoch = int(restored["epoch"])
        self.best_val_loss = float(restored["best_val_loss"])
        logging.info("resumed from step %d (epoch %d)", self.steps, self.epoch)
        return True

    def _place_batch(self, batch, N):
        images = torch.as_tensor(np.asarray(batch["images"]), device=self.device).float() / 255.0
        masks = torch.as_tensor(np.asarray(batch["masks"]), device=self.device)
        obj_valid = torch.as_tensor(np.asarray(
            batch.get("obj_valid", np.ones((images.shape[0], N), bool))), device=self.device)
        return images, masks, obj_valid

    def run(self, train_loader_fn, val_loader_fn=None, steps_per_epoch: Optional[int] = None):
        """train_loader_fn(epoch) -> iterator of collated batches.
        `steps_per_epoch` sizes the lr schedule; without it the count
        measured in epoch 0 sizes the later epochs."""
        self.load_checkpoint()
        total_steps = steps_per_epoch and steps_per_epoch * self.tcfg.num_epochs
        while self.epoch < self.tcfg.num_epochs:
            steps_before = self.steps
            self.train_epoch(train_loader_fn(self.epoch), total_steps, steps_per_epoch)
            if total_steps is None and self.steps > steps_before:
                total_steps = (self.steps - steps_before) * self.tcfg.num_epochs
            if val_loader_fn is not None:
                self.val_epoch(val_loader_fn(self.epoch))
            self.epoch += 1
            if self.epoch % self.tcfg.save_freq_epochs == 0:
                self.save_checkpoint()
        self.save_checkpoint()
        self.tb.close()

    def _sample_prompt_kind(self, T: int):
        """Per-step initial-prompt form and correction frames (reference
        prepare_prompt_inputs, model/sam2.py:146-267): a fresh subset of
        tracked frames each step, as the reference draws it."""
        use_mask = self._pyrng.random() >= self.tcfg.prob_to_use_pt_input
        use_box = (not use_mask) and self._pyrng.random() < self.tcfg.prob_to_use_box_input
        n_init = self._pyrng.randint(1, max(self.tcfg.max_init_cond_frames, 1))
        extra = max(self.tcfg.num_frames_to_correct - n_init, 0)
        correct_frames = ()
        if not use_mask and extra > 0 and T > n_init:
            pool = list(range(n_init, T))
            correct_frames = tuple(sorted(self._pyrng.sample(pool, min(extra, len(pool)))))
        return use_box, use_mask, n_init, correct_frames

    def train_epoch(self, loader, total_steps: Optional[int], steps_per_epoch):
        loss_meter = AverageMeter("loss", fmt=":.4f")
        data_time = AverageMeter("data_s", fmt=":.2f")
        step_time = AverageMeter("step_s", fmt=":.2f")
        mem = MemMeter("mem")
        progress = ProgressMeter(steps_per_epoch or 0, [loss_meter, data_time, step_time, mem],
                                 prefix=f"epoch {self.epoch} ")
        t_data = time.time()
        for batch in loader:
            data_time.update(time.time() - t_data)
            T, N = batch["images"].shape[1], batch["masks"].shape[2]
            images, masks, obj_valid = self._place_batch(batch, N)
            # the schedule's position; with the length unknown, assume an
            # epoch 10x longer than seen so far (at least 1000 steps)
            denom = total_steps or self.tcfg.num_epochs * max(10 * (self.steps + 1), 1000)
            where = min(self.steps / max(denom, 1), 1.0 - 1e-6)
            lr = self.optimizer.lr_at(where)
            skey = self._sample_prompt_kind(T)
            step_fn = self._step_fns.get(skey)
            if step_fn is None:
                use_box, use_mask, n_init, correct_frames = skey
                step_fn = self._step_fns[skey] = build_train_step(
                    self.cfg, self.tcfg, self.optimizer, use_box=use_box, use_mask=use_mask,
                    n_init=n_init, correct_frames=correct_frames)
            t0 = time.time()
            self.opt_state, metrics = step_fn(self.model, self.opt_state, images, masks,
                                              obj_valid, self._gen, lr)
            loss = float(metrics["loss"])  # synchronizes with the device
            self.step_seconds.append(time.time() - t0)
            step_time.update(self.step_seconds[-1])
            if not np.isfinite(loss):
                raise FloatingPointError(f"Loss is {loss} at step {self.steps}: aborting "
                                         "(the reference trainer raises on NaN losses)")
            loss_meter.update(loss)
            self.step_losses.append(loss)
            mem.update()
            if self.steps % self.tcfg.log_scalar_frequency == 0:
                self.tb.log("train/loss", loss, self.steps)
                self.tb.log("train/lr", lr, self.steps)
                progress.display(self.steps)
            self.steps += 1
            t_data = time.time()
        return loss_meter.avg

    @torch.no_grad()
    def val_epoch(self, loader):
        """Forward-only validation loss (reference val_epoch :583-650): point
        prompt, no correction clicks, fp32."""
        loss_meter = AverageMeter("val_loss", fmt=":.4f")
        for batch in loader:
            images, masks, obj_valid = self._place_batch(batch, batch["masks"].shape[2])
            losses = [sam2_train.video_train_loss(
                self.model, self.cfg, images[b], masks[b], self._gen, obj_valid=obj_valid[b],
                num_correction_clicks=0)[0] for b in range(images.shape[0])]
            loss_meter.update(float(sum(losses) / len(losses)), n=images.shape[0])
        self.tb.log("val/loss", loss_meter.avg, self.steps)
        self.best_val_loss = min(self.best_val_loss, loss_meter.avg)
        return loss_meter.avg
