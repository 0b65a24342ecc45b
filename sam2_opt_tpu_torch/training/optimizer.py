"""Optimizer: parameter groups, layer-wise lr decay, per-step schedules.

Counterpart of `sam2_opt_tpu/training/optimizer.py` (reference
sam2/training/optimizer.py:1-502). The update is optax's chain as the JAX
package builds it, written out in a few lines of torch:

    clip_by_global_norm -> scale_by_adam -> add_decayed_weights -> x (-lr * scale)

over the model's parameters, keyed by their reference names. Buffers are not
optimized and do not enter the global clip norm; this includes the prompt
encoder's `positional_encoding_gaussian_matrix`, a buffer in the reference
and here but a parameter (lr 0, no decay) in the JAX tree, whose gradient
enters the JAX clip norm.
"""

from __future__ import annotations

import fnmatch
import math
import re
from typing import Callable, Dict, Optional

import torch

# --------------------------------------------------------------------- #
# schedules by `where` in [0, 1), the fraction of training done
# --------------------------------------------------------------------- #


def cosine_schedule(start: float, end: float):
    def fn(where: float) -> float:
        return end + 0.5 * (start - end) * (1 + math.cos(math.pi * where))

    return fn


def linear_schedule(start: float, end: float):
    def fn(where: float) -> float:
        return start + (end - start) * where

    return fn


def constant_schedule(value: float):
    return lambda where: value


def warmup_cosine_schedule(base: float, warmup_frac: float = 0.03, end: float = 0.0,
                           warmup_init: float = 0.0):
    cos = cosine_schedule(base, end)

    def fn(where: float) -> float:
        if where < warmup_frac:
            return warmup_init + (base - warmup_init) * (where / warmup_frac)
        return cos((where - warmup_frac) / max(1 - warmup_frac, 1e-8))

    return fn


# --------------------------------------------------------------------- #
# parameter groups
# --------------------------------------------------------------------- #


def hiera_layer_id(name: str, num_layers: int) -> int:
    """reference hieradet.py:301-314 get_layer_id."""
    if "rel_pos" in name:
        return num_layers + 1
    if "pos_embed" in name or "patch_embed" in name:
        return 0
    if "blocks" in name:
        m = re.search(r"blocks\.(\d+)", name)
        if m:
            return int(m.group(1)) + 1
    return num_layers + 1


def layer_decay_lr_scales(params: Dict[str, torch.Tensor], layer_decay: float, trunk_depth: int,
                          trunk_prefix: str = "image_encoder.trunk") -> Dict[str, float]:
    """Per-parameter lr multipliers of layer-wise lr decay over the trunk
    (reference layer_decay_param_modifier, optimizer.py:422-472)."""
    num_layers = trunk_depth + 1
    scales = {}
    for name in params:
        if name.startswith(trunk_prefix):
            layer_id = hiera_layer_id(name[len(trunk_prefix) + 1:], trunk_depth)
            scales[name] = layer_decay ** (num_layers - layer_id)
        else:
            scales[name] = 1.0
    return scales


def default_weight_decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True = weight decay applies. The reference MOSE recipe excludes only
    biases and LayerNorm weights (every 1-D '.weight' here is a LayerNorm
    scale); everything else, layer-scale gamma, pos_embed and embedding
    tokens included, is decayed."""
    return {name: not (name.endswith("bias") or (name.endswith("weight") and p.dim() == 1))
            for name, p in params.items()}


class ScheduledOptimizer:
    """AdamW whose lr follows `where` in [0, 1) (reference Optimizer wrapper,
    optimizer.py:29-76), with optax's exact update:

        g <- g * min(1, clip / ||g||)                         (global norm)
        mu <- b1 mu + (1 - b1) g,  nu <- b2 nu + (1 - b2) g^2
        u = mu / (1 - b1^n) / (sqrt(nu / (1 - b2^n)) + eps) + wd * p   (wd by mask)
        p <- p - lr * scale * u

    `init(params)` gives the state; `update(grads, state, params, lr)` gives
    (updates, state) with the updates still to be added to the parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], lr_schedule: Callable[[float], float],
                 weight_decay: float = 0.1, grad_clip_norm: Optional[float] = 0.1,
                 layer_decay: Optional[float] = None, trunk_depth: int = 48, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 pattern_lr_overrides: Optional[Dict[str, float]] = None):
        self.lr_schedule = lr_schedule
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.lr_scales = None
        if layer_decay is not None or pattern_lr_overrides:
            scales = layer_decay_lr_scales(params, layer_decay if layer_decay is not None else 1.0,
                                           trunk_depth)
            # SET semantics, as the reference's overrides: '*pos_embed*' -> 1.0
            # replaces the decayed scale
            for name in scales:
                for pat, value in (pattern_lr_overrides or {}).items():
                    if fnmatch.fnmatch(name, pat):
                        scales[name] = value
            self.lr_scales = scales
        self.decay_mask = default_weight_decay_mask(params)

    def init(self, params: Dict[str, torch.Tensor]):
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def lr_at(self, where: float) -> float:
        return float(self.lr_schedule(float(where)))

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state, params: Dict[str, torch.Tensor],
               lr: float):
        grads = {n: grads[n] for n in params}
        if self.grad_clip_norm is not None:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
            clip = norm >= self.grad_clip_norm
            grads = {n: torch.where(clip, g / norm * self.grad_clip_norm, g)
                     for n, g in grads.items()}
        count = state["count"] + 1
        # bias corrections in fp32 from the fp32-rounded decays, as optax
        # computes them (1 - 0.999 ** 1 is 1.3e-5 off its float64 value)
        c1, c2 = (1.0 - torch.tensor(b, dtype=torch.float32) ** count
                  for b in (self.b1, self.b2))
        device = next(iter(params.values())).device
        c1, c2 = c1.to(device), c2.to(device)
        mu, nu, updates = {}, {}, {}
        for n, g in grads.items():
            mu[n] = (1 - self.b1) * g + self.b1 * state["mu"][n]
            nu[n] = (1 - self.b2) * g * g + self.b2 * state["nu"][n]
            u = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + self.eps)
            if self.weight_decay and self.decay_mask[n]:
                u = u + self.weight_decay * params[n]
            scale = 1.0 if self.lr_scales is None else self.lr_scales[n]
            updates[n] = u * (-lr * scale)
        return updates, {"count": count, "mu": mu, "nu": nu}


def build_optimizer(params: Dict[str, torch.Tensor], base_lr: float = 5e-6,
                    trunk_lr_scale: float = 0.6, weight_decay: float = 0.1,
                    grad_clip_norm: float = 0.1, layer_decay: float = 0.9,
                    warmup_frac: float = 0.03, trunk_depth: int = 48) -> ScheduledOptimizer:
    """The MOSE fine-tune optimizer (reference
    configs/sam2.1_training/sam2.1_hiera_b+_MOSE_finetune.yaml:240-278):
    cosine base_lr -> base_lr / 10 after a short linear warmup; the image
    encoder at the vision lr (trunk_lr_scale = 3e-6 / 5e-6) on top of layer
    decay 0.9 over the trunk, with '*pos_embed*' -> 1.0; AdamW wd 0.1 except
    biases and LayerNorm weights."""
    opt = ScheduledOptimizer(
        params,
        lr_schedule=warmup_cosine_schedule(base_lr, warmup_frac=warmup_frac, end=base_lr / 10.0),
        weight_decay=weight_decay, grad_clip_norm=grad_clip_norm, layer_decay=layer_decay,
        trunk_depth=trunk_depth, pattern_lr_overrides={"*pos_embed*": 1.0})
    if trunk_lr_scale and trunk_lr_scale != 1.0 and opt.lr_scales is not None:
        opt.lr_scales = {n: s * trunk_lr_scale if n.startswith("image_encoder") else s
                         for n, s in opt.lr_scales.items()}
    return opt
