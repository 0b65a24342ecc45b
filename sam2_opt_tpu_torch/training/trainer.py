"""Trainer: the training loop (re-design of sam2/training/trainer.py:141-1113).

Counterpart of `sam2_opt_tpu/training/trainer.py`: the step
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
- a ("data", "model") mesh (`parallel/mesh.py`): each rank runs the step on
  its rows of the global batch and the fp32 gradients are averaged over
  "data" before the clip norm, so every rank applies the same update; the
  linears of the TP rule are column-parallel over "model" (`parallel/tp.py`);
  `comms_dtype="bfloat16"` rounds the gradients to bf16 for that all-reduce
  (JAX `trainer.py:189-235`);
- randomness per video: every training video draws its clicks from a
  generator keyed by the seed, the step and its global row, every val video
  from one keyed by the seed and its index, so a DP layout takes the step
  (and the val loss) one process takes over the same videos;
- meters, rank 0's TensorBoard logging where available, atomic checkpoints
  (rank 0 writes, every rank restores) with resume discovery, a hard stop on
  a non-finite loss, and a val loop.
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
from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
from sam2_opt_tpu_torch.parallel import tp as tp_lib
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
    # "bfloat16": the data-parallel gradient all-reduce in bf16 (the
    # reference DDP comms hook, trainer.py:300-311); needs bf16 compute, a
    # tp = 1 mesh and no accumulation
    comms_dtype: Optional[str] = None


TRAIN_STREAM, VAL_STREAM = 0, 1


def row_generators(seed: int, step: int, rows, device, stream: int = TRAIN_STREAM) -> list:
    """One generator per video, keyed by the seed, the stream (training or
    val), the step and the video's global row, so the draws do not depend on
    which rank runs the row (JAX splits one key per global row,
    `trainer.py:159`). Every key is a non-negative integer."""
    return [torch.Generator(device=device).manual_seed(int(np.random.SeedSequence(
        [seed, stream, step, row]).generate_state(1, np.uint64)[0] >> 1)) for row in rows]


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
                     sharded: Optional[Dict[str, int]] = None, use_box: bool = False,
                     use_mask: bool = False, n_init: int = 1, correct_frames=()):
    """The training step, `step(model, opt_state, images, masks, obj_valid,
    gens, lr) -> (opt_state, metrics)`: images [B, T, S, S, 3] float in
    [0, 1], masks [B, T, N, S, S] bool, obj_valid [B, N] bool on the model's
    device, this rank's rows of the global batch under a mesh; `gens` one
    torch.Generator there per video (`row_generators`), or one shared by
    every video; the model's parameters are updated in place. Videos are
    looped and their losses averaged (the JAX step vmaps them);
    `grad_accum_steps` runs strided micro-batches (rows a, a + A, ...)
    before the one update. Under a mesh the loss, its parts and the
    gradients are averaged over "data" before the update, and the clip norm
    counts every TP shard once: `sharded` is {name: dim} of the model's TP
    shards, as `tp.shard_module` returned it (`tp.reduce_step`)."""
    sharded = sharded or {}
    cfg = model_cfg
    remat_blocks = tcfg.remat in ("blocks", "blocks_frames")
    use_remat = tcfg.remat == "encoder"
    remat_frames = tcfg.remat == "blocks_frames"
    accum = max(int(tcfg.grad_accum_steps), 1)
    compute_dtype = _DTYPES[tcfg.compute_dtype]
    frozen = tcfg.freeze_image_encoder
    comms_dtype = _DTYPES[tcfg.comms_dtype] if tcfg.comms_dtype else None
    if comms_dtype is not None:
        # the JAX package's errors (trainer.py:144-149, 207-215)
        if comms_dtype != compute_dtype:
            raise ValueError(f"comms_dtype={tcfg.comms_dtype} requires compute_dtype to match "
                             f"(got {tcfg.compute_dtype}): the gradient collectives inherit "
                             "the dtype the loss is differentiated in")
        if mesh is None or mesh_lib.axis_size(mesh, "model") != 1:
            raise ValueError("comms_dtype requires a data-parallel mesh (tp=1): the bf16 "
                             "gradient all-reduce runs over 'data' only")
        if accum != 1:
            raise ValueError("comms_dtype with grad_accum_steps>1 is not supported")

    def batch_loss(model, images, masks, obj_valid, gens):
        losses, auxs = [], []
        for b in range(images.shape[0]):
            loss, aux = sam2_train.video_train_loss(
                model, cfg, images[b], masks[b], gens[b], obj_valid=obj_valid[b],
                num_correction_clicks=tcfg.num_correction_clicks, use_box_input=use_box,
                use_mask_input=use_mask, num_init_cond_frames=n_init,
                frames_to_add_correction_pt=correct_frames, use_remat=use_remat,
                remat_frames=remat_frames)
            losses.append(loss)
            auxs.append(aux)
        n = len(losses)
        return sum(losses) / n, {k: sum(torch.as_tensor(a[k]) for a in auxs) / n for k in auxs[0]}

    def grads_of(model, images, masks, obj_valid, gens):
        names, masters = zip(*model.named_parameters())
        wrapper = _LossAndGrads(model)
        if compute_dtype == torch.float32:
            loss, aux, grads = wrapper(batch_loss, masters, images, masks, obj_valid, gens)
        else:
            # bf16 copies of the masters (and of the floating buffers, as the
            # JAX package casts its whole tree); the casts are in the graph,
            # so the gradients arrive at the fp32 masters
            cast = {f"model.{n}": p.to(compute_dtype) for n, p in zip(names, masters)}
            cast.update({f"model.{n}": b.to(compute_dtype) for n, b in model.named_buffers()
                         if b.is_floating_point()})
            loss, aux, grads = torch.func.functional_call(
                wrapper, cast, (batch_loss, masters, images.to(compute_dtype), masks, obj_valid,
                                gens))
        # comms_dtype: each rank's gradients are rounded to bf16 here,
        # reduced so (tp.reduce_step) and upcast after, as the JAX
        # package rounds its per-shard gradients before the pmean
        keep = comms_dtype or torch.float32
        grads = {n: torch.zeros_like(p, dtype=keep) if g is None else g.to(keep)
                 for n, p, g in zip(names, masters, grads)}
        return loss, aux, grads

    def accum_grads(model, images, masks, obj_valid, gens):
        B = images.shape[0]
        if B % accum:
            raise ValueError(f"batch size {B} is not divisible by grad_accum_steps {accum}; "
                             "pick a batch size that is a multiple of grad_accum_steps")
        total = None
        for a in range(accum):
            # micro-batch a = rows a, a + accum, ... (the JAX package's strided split)
            out = grads_of(model, images[a::accum], masks[a::accum], obj_valid[a::accum],
                           gens[a::accum])
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

    def step(model: SAM2Base, opt_state, images, masks, obj_valid, gens, lr: float):
        model.image_encoder.trunk.remat_blocks = remat_blocks
        if isinstance(gens, torch.Generator):
            gens = [gens] * images.shape[0]
        loss, aux, grads = accum_grads(model, images, masks, obj_valid, gens)
        params = dict(model.named_parameters())
        if frozen:
            # zero the frozen encoder's gradients so they neither enter the
            # clip norm nor move the moments ...
            grads = {n: torch.zeros_like(g) if n.startswith("image_encoder") else g
                     for n, g in grads.items()}
        keys = list(aux)
        scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=loss.device)
                               for v in [loss] + [aux[k] for k in keys]])
        scalars, grads, norm = tp_lib.reduce_step(mesh, scalars, grads, sharded)
        updates, opt_state = optimizer.update(grads, opt_state, params, lr, **norm)
        with torch.no_grad():
            for n, p in params.items():
                # ... and skip their updates: weight decay would otherwise
                # shrink them (the reference freezes with requires_grad=False)
                if not (frozen and n.startswith("image_encoder")):
                    p.add_(updates[n])
        return opt_state, {"loss": scalars[0], **dict(zip(keys, scalars[1:]))}

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
    """The trainer over a `SAM2Base` whose parameters are the fp32 masters;
    the device is the model's. With a mesh, every rank builds the same model
    and calls `run` with the same loader: rank 0's parameters are broadcast,
    the TP rule shards the model, each rank trains on its rows of each
    global batch (a loader built with `batch_rows` yields just those, tagged
    with `global_batch_size`; an untagged batch is the global one), rank 0
    logs and writes the checkpoints, and every rank restores them."""

    def __init__(self, model_cfg: SAM2Config, model: SAM2Base, train_cfg: TrainConfig,
                 mesh=None):
        self.cfg = model_cfg
        self.tcfg = train_cfg
        self.model = model
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.sharded = {}
        if mesh is not None:
            # every rank starts from rank 0's weights (DDP broadcasts them),
            # then keeps its TP shards
            with torch.no_grad():
                for p in model.parameters():
                    mesh_lib.replicated(mesh, p.data)
            self.sharded = tp_lib.shard_module(model, mesh)
        self.optimizer = build_optimizer(
            dict(model.named_parameters()), base_lr=train_cfg.base_lr,
            weight_decay=train_cfg.weight_decay, grad_clip_norm=train_cfg.grad_clip_norm,
            layer_decay=train_cfg.layer_decay, trunk_depth=model_cfg.trunk.depth)
        self.opt_state = self.optimizer.init(dict(model.named_parameters()))
        self.steps = 0
        self.epoch = 0
        self.best_val_loss = float("inf")
        self.step_losses: list = []  # global-batch mean losses
        self.step_seconds: list = []  # host wall time of each step, ending in a sync
        self.rank0 = mesh_lib.is_rank0()
        self.ckpt = CheckpointManager(train_cfg.checkpoint_dir)
        self.tb = TensorBoardLogger(train_cfg.log_dir, enabled=self.rank0)
        self._step_fns = {}
        self._pyrng = random.Random(train_cfg.seed)

    def row_generators(self, rows):
        """The per-video generators of this step's global rows `rows`."""
        return row_generators(self.tcfg.seed, self.steps, rows, self.device)

    def save_checkpoint(self):
        """Every rank gathers the TP shards into whole tensors; rank 0 writes;
        all wait for the file (JAX `trainer.py:445-461`)."""
        state = mesh_lib.fetch_global(
            {"params": self.model.state_dict(), "opt_state": self.opt_state},
            self.mesh, self.sharded)
        if self.rank0:
            self.ckpt.save(self.steps, {**state, "steps": self.steps, "epoch": self.epoch,
                                        "best_val_loss": self.best_val_loss})
        mesh_lib.barrier()

    def load_checkpoint(self) -> bool:
        """Resume auto-discovery on every rank, each keeping its TP shards of
        the whole tensors; True when resumed."""
        restored = self.ckpt.restore(map_location="cpu")
        if restored is None:
            return False
        params = mesh_lib.place_like(self.model.state_dict(), restored["params"], self.mesh,
                                     self.sharded)
        self.model.load_state_dict(params, strict=True)
        self.opt_state = mesh_lib.place_like(self.opt_state, restored["opt_state"], self.mesh,
                                             self.sharded)
        self.steps = int(restored["steps"])
        self.epoch = int(restored["epoch"])
        self.best_val_loss = float(restored["best_val_loss"])
        logging.info("resumed from step %d (epoch %d)", self.steps, self.epoch)
        return True

    def _place_batch(self, batch, N):
        """(images, masks, obj_valid, global rows) of this rank on its device."""
        n = np.asarray(batch["images"]).shape[0]
        gbs = int(batch.get("global_batch_size", 0))
        rows = mesh_lib.process_local_batch_rows(self.mesh, gbs or n)
        if gbs and len(rows) != n:
            raise ValueError(f"the loader gave {n} rows of the global {gbs}; this rank owns "
                             f"{len(rows)}: build it with batch_rows=process_local_batch_rows"
                             "(mesh, global_batch_size)")
        take = slice(None) if gbs else slice(rows[0], rows[-1] + 1)
        images = torch.as_tensor(np.asarray(batch["images"])[take],
                                 device=self.device).float() / 255.0
        masks = torch.as_tensor(np.asarray(batch["masks"])[take], device=self.device)
        obj_valid = torch.as_tensor(np.asarray(
            batch.get("obj_valid", np.ones((n, N), bool)))[take], device=self.device)
        return images, masks, obj_valid, rows

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
        tracked frames each step, as the reference draws it; every rank draws
        the same, from the shared seed."""
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
            images, masks, obj_valid, rows = self._place_batch(batch, N)
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
                    self.cfg, self.tcfg, self.optimizer, self.mesh, sharded=self.sharded,
                    use_box=use_box,
                    use_mask=use_mask, n_init=n_init, correct_frames=correct_frames)
            t0 = time.time()
            self.opt_state, metrics = step_fn(self.model, self.opt_state, images, masks,
                                              obj_valid, self.row_generators(rows), lr)
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
                if self.rank0:
                    progress.display(self.steps)
            self.steps += 1
            t_data = time.time()
        return loss_meter.avg

    @torch.no_grad()
    def val_epoch(self, loader):
        """Forward-only validation loss (reference val_epoch :583-650): point
        prompt, no correction clicks, fp32; the mean over every video of the
        loader. Under a mesh each rank runs its rows and the sums are added
        over "data"; rows a loader marks invalid (`row_valid`, the padding of
        a ragged last global batch) count for nothing. The clicks of video v
        come from `row_generators(seed, 0, [v], stream=VAL_STREAM)`, as in
        one process."""
        loss_meter = AverageMeter("val_loss", fmt=":.4f")
        first = 0  # the global index of the batch's first video
        for batch in loader:
            images, masks, obj_valid, rows = self._place_batch(batch, batch["masks"].shape[2])
            gens = row_generators(self.tcfg.seed, 0, [first + r for r in rows], self.device,
                                  stream=VAL_STREAM)
            first += int(batch.get("global_batch_size", 0)) or images.shape[0]
            losses = torch.stack([sam2_train.video_train_loss(
                self.model, self.cfg, images[b], masks[b], gens[b], obj_valid=obj_valid[b],
                num_correction_clicks=0)[0].float() for b in range(images.shape[0])])
            valid = torch.as_tensor(np.asarray(batch.get("row_valid", np.ones(len(rows), bool))),
                                    device=losses.device)
            stats = torch.stack([torch.where(valid, losses, 0.0).sum(), valid.sum().float()])
            # the mean over "data" of (sum, count): their ratio is the global one
            total, count = mesh_lib.all_reduce_mean(self.mesh, [stats])[0].tolist()
            if count > 0:
                loss_meter.update(total / count,
                                  n=round(count * mesh_lib.axis_size(self.mesh, "data")))
        self.tb.log("val/loss", loss_meter.avg, self.steps)
        self.best_val_loss = min(self.best_val_loss, loss_meter.avg)
        return loss_meter.avg
