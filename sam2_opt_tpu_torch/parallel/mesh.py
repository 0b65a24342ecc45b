"""Device mesh and sharding helpers over `torch.distributed`.

Counterpart of `sam2_opt_tpu/parallel/mesh.py`. The reference trains with
DDP over NCCL, data parallelism only (training/utils/distributed.py); the
JAX package makes data parallelism a mesh axis ("data") and shards the big
linears over a second axis ("model"). Here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the world's ranks, one
process per rank:

- rank = d * tp + t, as JAX's `devices.reshape(dp, tp)`; a rank's "data"
  group holds the ranks with its t, its "model" group those with its d;
- the collectives XLA inserts are explicit here: the gradient all-reduce
  over "data" (`training/trainer.py`, `training/step.py`), the
  column-parallel linears' all-gather and input-gradient all-reduce over
  "model" (`parallel/tp.py`);
- the process group comes up from torchrun's variables (`RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
  `MASTER_PORT`) within `SAM2_DIST_INIT_TIMEOUT` seconds (600), NCCL on
  "cuda" and gloo on "cpu" unless the caller names a backend. NCCL takes
  one device per rank: several ranks on one card need gloo, named by the
  caller.

Left out: `aligned_compile` and `coordination_barrier` serialise XLA
compiles across processes so that a slow compile does not race the
collective handshake. The port compiles nothing at the step (the kernels
are built before any collective), so where the JAX package barriers, this
module's `barrier` is a `dist.barrier`.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sam2_opt_tpu_torch.io.weights import is_transposed_linear

AXES = ("data", "model")
# the JAX rule's (`_tp_spec_for_param`) size floor and parameter names
TP_MIN_FEATURES = 1024
TP_NAME_KEYS = ("mlp", "qkv", "linear1")


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: Optional[str] = None, device="cuda") -> None:
    """The default process group, once: from torchrun's variables, or a
    world of one process (an in-process store) when `WORLD_SIZE` is unset."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = backend or default_backend(device)
    timeout = datetime.timedelta(seconds=float(os.environ.get("SAM2_DIST_INIT_TIMEOUT", "600")))
    if "WORLD_SIZE" not in os.environ:
        rank, world, local_rank, local_world = 0, 1, 0, 1
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if backend == "nccl" and local_world > n:
            raise RuntimeError(
                f"NCCL needs a device per rank: {local_world} ranks on this host, {n} CUDA "
                "device(s); run several ranks on one device over backend='gloo'")
        torch.cuda.set_device(local_rank % n)
    if world == 1 and "WORLD_SIZE" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, rank=rank, world_size=world, timeout=timeout)


def make_mesh(dp: Optional[int] = None, tp: int = 1, backend: Optional[str] = None,
              device="cuda") -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the world (the process
    group comes up first where it is not up); `dp` None or -1: all ranks
    over "data" after `tp`."""
    init_distributed(backend, device)
    n = dist.get_world_size()
    if dp is None or dp < 0:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp ({dp}) * tp ({tp}) != world size ({n})")
    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(dp, tp),
                      mesh_dim_names=AXES)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 1 if mesh is None else mesh.size(AXES.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# --------------------------------------------------------------------- #
# the tensor-parallel rule
# --------------------------------------------------------------------- #


def tp_spec_for_param(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dimension of the port's tensor `name` (torch layout) that the TP
    rule shards over "model", or None (replicated): exactly the tensors the
    JAX `_tp_spec_for_param` shards. That rule reads the JAX layout, where a
    linear's kernel is [in, out]: a 2-D kernel with out >= 1024 and divisible
    by `tp`, or a 1-D bias of that length, under "mlp", "qkv" or "linear1".
    A torch `Linear.weight` is [out, in], so its out features are dim 0."""
    if not any(k in name for k in TP_NAME_KEYS):
        return None
    shape = tuple(shape)
    if len(shape) == 2:
        out_dim = 0 if is_transposed_linear(name, 2) else 1
        if shape[out_dim] >= TP_MIN_FEATURES and shape[out_dim] % tp == 0:
            return out_dim
    if len(shape) == 1 and shape[0] >= TP_MIN_FEATURES and shape[0] % tp == 0:
        return 0
    return None


# --------------------------------------------------------------------- #
# batches over "data"
# --------------------------------------------------------------------- #


def process_local_batch_rows(mesh: Optional[DeviceMesh], global_batch_size: int) -> List[int]:
    """The global-batch rows this rank owns: its data index's contiguous
    block, as JAX's P("data") batch sharding gives each device."""
    dp = axis_size(mesh, "data")
    if global_batch_size % dp:
        raise ValueError(f"global batch {global_batch_size} is not divisible by dp={dp}")
    per = global_batch_size // dp
    d = axis_rank(mesh, "data")
    return list(range(d * per, (d + 1) * per))


def data_sharded(mesh: Optional[DeviceMesh], x):
    """This rank's rows (axis 0) of a global batch `x`."""
    rows = process_local_batch_rows(mesh, x.shape[0])
    return x[rows[0]:rows[-1] + 1]


def replicated(mesh: Optional[DeviceMesh], x: torch.Tensor) -> torch.Tensor:
    """`x` as rank 0 holds it, on every rank (in place)."""
    if mesh is not None and dist.get_world_size() > 1:
        dist.broadcast(x, src=0)
    return x


def all_gather_rows(mesh: Optional[DeviceMesh], x: torch.Tensor) -> torch.Tensor:
    """Every data rank's `x` (equal shapes) concatenated on axis 0 in data
    order: the global batch from its shards."""
    dp = axis_size(mesh, "data")
    if dp == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dp)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts, 0)


# --------------------------------------------------------------------- #
# checkpoints: TP shards <-> whole tensors
# --------------------------------------------------------------------- #


def _map_named(tree, fn, name=""):
    """fn(name, leaf) over a nested dict whose tensor leaves are keyed by
    parameter names (a state dict, the optimizer's {"mu": {name: ...}})."""
    if isinstance(tree, Mapping):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    return fn(name, tree)


def fetch_global(tree, mesh: Optional[DeviceMesh] = None, sharded: Mapping[str, int] = None):
    """Host copy of a state tree whose `sharded` entries ({name: dim}) are
    TP shards: each is gathered over "model" into its whole tensor, so every
    rank holds the same host state (the checkpoint-save counterpart of
    `place_like`)."""
    sharded = sharded or {}
    tp = axis_size(mesh, "model")

    def one(name, x):
        if not isinstance(x, torch.Tensor):
            return x
        if tp > 1 and name in sharded:
            parts = [torch.empty_like(x) for _ in range(tp)]
            dist.all_gather(parts, x.contiguous(), group=mesh.get_group("model"))
            x = torch.cat(parts, sharded[name])
        return x.detach().cpu()

    return _map_named(tree, one)


def place_like(template, host_tree, mesh: Optional[DeviceMesh] = None,
               sharded: Mapping[str, int] = None):
    """Whole host values onto the template's devices, dtypes and TP shards:
    the restore counterpart of `fetch_global`."""
    sharded = sharded or {}
    tp, t = axis_size(mesh, "model"), axis_rank(mesh, "model")

    def one(name, h, tmpl):
        if not isinstance(h, torch.Tensor):
            return h
        if tp > 1 and name in sharded:
            n = h.shape[sharded[name]] // tp
            h = h.narrow(sharded[name], t * n, n)
        if isinstance(tmpl, torch.Tensor):
            return h.to(device=tmpl.device, dtype=tmpl.dtype).clone()
        return h

    def walk(h, tm, name=""):
        if isinstance(h, Mapping):
            return {k: walk(v, tm.get(k) if isinstance(tm, Mapping) else None, k)
                    for k, v in h.items()}
        return one(name, h, tm)

    return walk(host_tree, template)


# --------------------------------------------------------------------- #
# gradient collectives
# --------------------------------------------------------------------- #

# elements per all-reduce bucket (128 MiB of fp32)
GRAD_BUCKET_ELEMS = 1 << 25


def all_reduce_mean(mesh: Optional[DeviceMesh], tensors: Sequence[torch.Tensor],
                    axis: str = "data", dtype: Optional[torch.dtype] = None
                    ) -> List[torch.Tensor]:
    """The mean over `axis` of each tensor (the same list on every rank of
    the axis). Tensors are packed in order into flat buckets of `dtype`
    (their own when None), each bucket summed by one all-reduce and divided
    by the axis size in that dtype, then unpacked in the tensors' dtypes:
    with `dtype=torch.bfloat16` the reduction itself runs in bf16, as the
    JAX package's pmean of bf16 gradients does. Without a mesh the tensors
    come back as they are; an axis of one rank still runs its all-reduce
    (at dp 1 the trainer's gradients pass the NCCL group as DDP's do)."""
    if mesh is None:
        return list(tensors)
    n = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    i = 0
    while i < len(tensors):
        bucket_dtype = dtype or tensors[i].dtype
        j, size = i, 0
        while j < len(tensors) and (dtype or tensors[j].dtype) == bucket_dtype and (
                j == i or size + tensors[j].numel() <= GRAD_BUCKET_ELEMS):
            size += tensors[j].numel()
            j += 1
        flat = torch.cat([t.reshape(-1).to(bucket_dtype) for t in tensors[i:j]])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        offset = 0
        for k in range(i, j):
            t = tensors[k]
            out[k] = flat[offset:offset + t.numel()].view(t.shape).to(t.dtype)
            offset += t.numel()
        i = j
    return out
