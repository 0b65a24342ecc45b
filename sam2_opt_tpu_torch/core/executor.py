"""Executor layer: CUDA graphs per input signature.

Counterpart of `sam2_opt_tpu/core/executor.py`, where `speedup()` compiles
each seam into an XLA executable per input signature. On the card the
counterpart of an executable is a `torch.cuda.CUDAGraph`: `GraphExecutor.run`
captures a seam once per signature (the input shapes and dtypes plus the
caller's static flags, as JAX's jit keys are, and the route switches) and
replays it afterwards,
which takes the host's launch overhead of the seam's hundreds to thousands
of kernels off the critical path.

- First call of a signature: warm up on a side stream (which builds each
  kernel library, sets its `cudaFuncSetAttribute` and fills the wrappers'
  host caches), capture into static input buffers, replay.
- Later calls: copy the inputs into the static buffers, replay, and copy
  the outputs out. The predictors keep outputs across calls (the features
  cache, the memory bank, object pointers), and a static output handed back
  would be overwritten by the next replay.
- The kernel wrappers launch on the current stream and allocate scratch with
  `torch.empty`, which comes from the graph's pool under capture. TMA
  descriptors are built on the host with capture-time pointers, so a static
  buffer is never rebound, only copied into.
- One lock serialises copy-in, replay and copy-out, and capture: the demo
  server runs one thread per request. Capture uses
  `capture_error_mode="thread_local"`, so other threads' host work (their
  bookkeeping outside the graphs) does not break it.
- A capture or replay that fails raises; nothing falls back to eager. When
  every tensor is on the CPU, which only an explicit `device="cpu"` gives,
  the seam runs eagerly: the CPU has no graphs. Tensors on both raise.
- Counters, always on, added under the lock (`counters()`): per seam name
  its replays, captures and the bytes copied in and out; the seconds callers
  waited for the lock. With the tracer on (`utils/profiling.py`) each call
  records the spans `graph.lock_wait`, `graph.copy_in`, `graph.replay`,
  `graph.copy_out` (or `graph.capture`), each `:<seam>`, and a graph
  captured then holds its seam's stage events, read before its next replay.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional

import torch
from torch.utils import _pytree as pytree

from sam2_opt_tpu_torch.utils import profiling


class LRUCache:
    """Bounded dict of captured graphs. Long-lived servers accumulate one
    graph per signature (keys include video resolution, object count and
    memory capacity); without eviction that leaks graphs and their pools.
    Default capacity via SAM2_TPU_JIT_CACHE_SIZE (128), as the JAX package's."""

    def __init__(self, maxsize: Optional[int] = None):
        if maxsize is None:
            maxsize = int(os.environ.get("SAM2_TPU_JIT_CACHE_SIZE", "128"))
        self.maxsize = max(int(maxsize), 1)
        self._d = OrderedDict()

    def get(self, key, default=None):
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return default

    def __getitem__(self, key):
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key, value):
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = value
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __contains__(self, key):
        return key in self._d

    def __len__(self):
        return len(self._d)

    def keys(self):
        return list(self._d)

    def values(self):
        return list(self._d.values())

    def clear(self):
        self._d.clear()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


class _Graph:
    """One captured signature: the graph, its static input buffers (None
    where the input leaf is not a tensor), its static outputs, the bytes its
    capture added to the shared pool, the bytes a call copies in and out,
    and the stage events its replays record (empty with the tracer off)."""

    __slots__ = ("graph", "inputs", "outputs", "out_spec", "pool_bytes", "in_bytes",
                 "out_bytes", "events")

    def __init__(self, graph, inputs, outputs, out_spec, pool_bytes, events):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.out_spec, self.pool_bytes, self.events = out_spec, pool_bytes, events
        self.in_bytes, self.out_bytes = _nbytes(inputs), _nbytes(outputs)


def seam_name(name: Hashable) -> str:
    """A seam's name without its static flags."""
    return str(name[0] if isinstance(name, tuple) else name)


def signature(name: Hashable, args) -> tuple:
    """The key of a seam call: the caller's name and static flags, the
    argument tree's structure, each tensor leaf's shape, dtype and strides
    (the static buffer keeps the layout, e.g. channels-last, that picks the
    eager call's kernels), every other leaf (None, a Python number) by
    value, the route switches (`SAM2_TPU_*`) and whether the tracer is on.
    The seams read the switches while they run, so only at a capture: a
    switch changed later keys a new graph instead of being ignored by the
    replays; a graph captured with the tracer off holds no stage events."""
    leaves, spec = pytree.tree_flatten(args)
    switches = tuple(sorted((k, v) for k, v in os.environ.items() if k.startswith("SAM2_TPU_")))
    return (name, str(spec), tuple(
        (tuple(x.shape), x.dtype, x.stride(), x.device.type) if isinstance(x, torch.Tensor)
        else ("=", x) for x in leaves), switches, profiling.enabled())


class GraphExecutor:
    """`run(name, fn, args)`: fn(*args) through one CUDA graph per
    signature, bounded by an LRU cache. All graphs draw on one memory pool.
    Sharing is safe here because replays are serialised by the lock, every
    replay's outputs are copied out before the lock is released, and the
    static inputs are allocated outside the pool: a replay may overwrite
    another graph's dead temporaries or stale static outputs, never a live
    input or a result handed back."""

    def __init__(self, maxsize: Optional[int] = None):
        self._graphs = LRUCache(maxsize)
        self._lock = threading.Lock()
        self._pool = None
        self.captures = 0
        self._seams = {}
        self._lock_wait_s = 0.0

    def __len__(self):
        return len(self._graphs)

    def clear(self):
        """Drop every graph; the next capture starts a new pool (a pool whose
        graphs are all freed is released and its handle cannot be reused)."""
        with self._lock:
            self._graphs.clear()
            self._pool = None

    def pool_bytes(self) -> list:
        """Per cached graph, the bytes its capture added to the shared pool
        (the device memory newly reserved while it was captured)."""
        with self._lock:
            return [g.pool_bytes for g in self._graphs.values()]

    def keys(self) -> list:
        with self._lock:
            return self._graphs.keys()

    def counters(self) -> dict:
        """A copy of the counters: total captures, the seconds callers waited
        for the lock, and per seam name its replays, captures and the bytes
        copied into the static inputs and out of the static outputs."""
        with self._lock:
            return {"captures": self.captures, "lock_wait_s": self._lock_wait_s,
                    "seams": {k: dict(v) for k, v in self._seams.items()}}

    def run(self, name: Hashable, fn: Callable, args: tuple) -> Any:
        leaves, spec = pytree.tree_flatten(args)
        devices = {x.device.type for x in leaves if isinstance(x, torch.Tensor)}
        if devices <= {"cpu"}:
            return fn(*args)
        if devices != {"cuda"}:
            raise ValueError(f"{name}: a seam's tensors must all be on the card or all on "
                             f"the CPU, got {sorted(devices)}")
        key, seam = signature(name, args), seam_name(name)
        t_call = time.perf_counter()
        with self._lock:
            t_held = time.perf_counter()
            self._lock_wait_s += t_held - t_call
            if profiling.enabled():
                profiling.record(f"graph.lock_wait:{seam}", t_call, t_held)
            count = self._seams.get(seam)
            if count is None:
                count = self._seams[seam] = {"replays": 0, "captures": 0, "copy_in_bytes": 0,
                                             "copy_out_bytes": 0}
            entry = self._graphs.get(key)
            if entry is None:
                with profiling.span("graph.capture", seam):
                    entry = self._capture(fn, leaves, spec)
                self._graphs[key] = entry
                count["captures"] += 1
            else:
                with profiling.span("graph.copy_in", seam):
                    for buf, x in zip(entry.inputs, leaves):
                        if buf is not None:
                            buf.copy_(x)
            if entry.events:  # the last replay's, before this one records over them
                profiling.TRACER.read(entry.events)
            with profiling.span("graph.replay", seam):
                t_launch = time.perf_counter()
                entry.graph.replay()
            if entry.events:
                profiling.TRACER.launched(seam, t_launch, entry.events)
            with profiling.span("graph.copy_out", seam):
                outs = [o.clone() if isinstance(o, torch.Tensor) else o for o in entry.outputs]
            count["replays"] += 1
            count["copy_in_bytes"] += entry.in_bytes
            count["copy_out_bytes"] += entry.out_bytes
        return pytree.tree_unflatten(outs, entry.out_spec)

    def _capture(self, fn, leaves, spec) -> _Graph:
        # static buffers outside the graph's pool, filled with this call's
        # inputs, in their layout
        inputs = [x.clone() if isinstance(x, torch.Tensor) else None for x in leaves]
        static_args = pytree.tree_unflatten(
            [b if b is not None else x for b, x in zip(inputs, leaves)], spec)
        stream = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn(*static_args)
        stream.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, events = torch.cuda.CUDAGraph(), []
        try:
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                # read inside the context: entering it empties the allocator's cache
                reserved = torch.cuda.memory_reserved()
                with profiling.TRACER.collect(events):
                    out = fn(*static_args)
        except BaseException:
            # the failed capture's hold on the pool is in doubt: later
            # captures start a new one (graphs already cached keep theirs)
            self._pool = None
            raise
        outputs, out_spec = pytree.tree_flatten(out)
        self.captures += 1
        return _Graph(graph, inputs, outputs, out_spec, torch.cuda.memory_reserved() - reserved,
                      events)
