"""Tensor parallelism: column-parallel linears over the mesh's "model" axis.

The JAX package shards the linears its TP rule selects (`parallel/mesh.py`)
and lets GSPMD insert the collectives. Here each selected `nn.Linear`
becomes a `ColumnParallelLinear`:

- storage: rank t of the "model" group holds rows [t n, (t + 1) n) of the
  weight and of the bias, n = out / tp;
- forward: the rank computes its slice of the output and all-gathers the
  whole output over "model" (`_GatherFromModel`), so every module
  downstream (K1 at Hiera's global blocks included) sees the tensors it
  sees without TP;
- backward: the all-gather's backward takes the rank's slice of the output
  gradient, with no communication; the input reaches the linear through
  `_CopyToModel` (Megatron's "f"), whose backward all-reduces the partial
  input gradients over "model".

Every other parameter is replicated. Every rank of a "model" group computes
its gradient from the same activations, but kernels with atomics (the
convolutions' weight gradients on the card) may round it differently from
rank to rank, so the step averages it over "model" (`average_replicated`)
and every rank applies one update to one copy. `reduce_step` holds the
collectives of a training step under a mesh, for both training steps.

A sharded model refuses the fused block MLP (K8, `SAM2_TPU_FUSED_MLP=1`):
K8 takes whole weights, and a block whose MLP holds shards raises
(`models/hiera.py`) instead of gathering them on every call.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from sam2_opt_tpu_torch.parallel import mesh as mesh_lib


class ModelGroup:
    """The "model" process group, its size and this rank's index; a deep
    copy (the bf16 compute copy of a sharded model) shares it, as process
    groups cannot be copied."""

    def __init__(self, mesh):
        self.group = mesh.get_group("model")
        self.size = mesh_lib.axis_size(mesh, "model")
        self.rank = mesh_lib.axis_rank(mesh, "model")

    def __deepcopy__(self, memo):
        return self


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over "model" backward."""

    @staticmethod
    def forward(ctx, x, mg: ModelGroup):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mg.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the ranks' slices along `dim` forward; this rank's
    slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mg: ModelGroup, dim: int):
        ctx.mg, ctx.dim, ctx.n = mg, dim, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(mg.size)]
        dist.all_gather(parts, x.contiguous(), group=mg.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.mg.rank * ctx.n, ctx.n).contiguous(), None, None


class ColumnParallelLinear(nn.Module):
    """A linear whose output features are split over "model" (module
    docstring); parameters keep the linear's names."""

    def __init__(self, linear: nn.Linear, mg: ModelGroup):
        super().__init__()
        self.mg = mg
        self.in_features, self.out_features = linear.in_features, linear.out_features
        n = linear.out_features // mg.size
        rows = slice(mg.rank * n, (mg.rank + 1) * n)
        self.weight = nn.Parameter(linear.weight.detach()[rows].clone())
        self.bias = (None if linear.bias is None
                     else nn.Parameter(linear.bias.detach()[rows].clone()))

    def forward(self, x):
        if torch.is_grad_enabled() and x.requires_grad:
            x = _CopyToModel.apply(x, self.mg)
        return _GatherFromModel.apply(F.linear(x, self.weight, self.bias), self.mg, x.dim() - 1)

    def extra_repr(self):
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"shard={self.mg.rank}/{self.mg.size}")


def shard_module(module: nn.Module, mesh) -> Dict[str, int]:
    """Replace, in place, each `nn.Linear` the TP rule selects by a
    `ColumnParallelLinear` (nothing at tp = 1). Returns {parameter name:
    sharded dim} of the parameters that are now shards. Raises when the rule
    selects a tensor that is not a linear's output rows, so the rule and the
    modules cannot disagree quietly."""
    tp = mesh_lib.axis_size(mesh, "model")
    if tp == 1:
        return {}
    selected = {n: d for n, p in module.named_parameters()
                if (d := mesh_lib.tp_spec_for_param(n, p.shape, tp)) is not None}
    mg = ModelGroup(mesh)
    sharded = {}
    for name, sub in list(module.named_modules()):
        if not isinstance(sub, nn.Linear) or f"{name}.weight" not in selected:
            continue
        if selected[f"{name}.weight"] != 0:
            raise ValueError(f"the TP rule shards {name}.weight on dim {selected[name + '.weight']}")
        parent_name, _, attr = name.rpartition(".")
        parent = module.get_submodule(parent_name) if parent_name else module
        setattr(parent, attr, ColumnParallelLinear(sub, mg))
        sharded[f"{name}.weight"] = 0
        if sub.bias is not None:
            sharded[f"{name}.bias"] = 0
    stray = set(selected) - set(sharded)
    if stray:
        raise ValueError(f"the TP rule selects tensors that are no linear's rows: {sorted(stray)}")
    return sharded


def global_grad_norm(grads: Dict[str, torch.Tensor], sharded: Dict[str, int], mesh):
    """The whole model's gradient norm on a rank holding TP shards: the
    replicated gradients' squares plus the shards' squares summed over
    "model"."""
    square = lambda names: sum((grads[n].float() ** 2).sum() for n in names)  # noqa: E731
    part = square([n for n in grads if n in sharded])
    part = torch.as_tensor(part, dtype=torch.float32, device=next(iter(grads.values())).device)
    dist.all_reduce(part, group=mesh.get_group("model"))
    return torch.sqrt(square([n for n in grads if n not in sharded]) + part)


def reduce_step(mesh, scalars: torch.Tensor, grads: Dict[str, torch.Tensor],
                sharded: Dict[str, int]):
    """The collectives of a training step on this rank's rows: the mean over
    "data" of the step's scalars (the loss and its parts, fp32) and of its
    gradients (bucketed in their own dtype, bf16 under `comms_dtype`), the
    scalars and the replicated gradients also over "model"; `sharded` is
    `shard_module`'s return. Returns (scalars, fp32 gradients, the keyword
    arguments of the optimizer's update: the global norm where this rank
    holds shards). Without a mesh: the gradients in fp32, no collective."""
    names = list(grads)
    reduced = mesh_lib.all_reduce_mean(mesh, [scalars] + [grads[n] for n in names])
    scalars = mesh_lib.all_reduce_mean(mesh, reduced[:1], axis="model")[0]
    grads = average_replicated(mesh, {n: g.float() for n, g in zip(names, reduced[1:])},
                               sharded)
    norm = {"grad_norm": global_grad_norm(grads, sharded, mesh)} if sharded else {}
    return scalars, grads, norm


def average_replicated(mesh, grads: Dict[str, torch.Tensor], sharded: Dict[str, int]):
    """The replicated gradients averaged over "model" (module docstring);
    the shards as they are."""
    if mesh_lib.axis_size(mesh, "model") == 1:
        return grads
    names = [n for n in grads if n not in sharded]
    return {**grads, **dict(zip(names, mesh_lib.all_reduce_mean(
        mesh, [grads[n] for n in names], axis="model")))}
