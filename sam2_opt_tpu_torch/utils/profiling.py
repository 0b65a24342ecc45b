"""Profiling and timing utilities (counterpart of
`sam2_opt_tpu/utils/profiling.py`; reference SURVEY.md §5):
- `timed`: a decorator that times a call, synchronising the CUDA devices
  its outputs lie on (the reference's `test_torch_cuda_time`);
- `trace`: a `torch.profiler` capture of CPU and CUDA activity, written as
  a Chrome trace under `log_dir`;
- `Timer` and `fps_benchmark`: the wall-clock FPS harness (reference
  sam2/benchmark.py:72-92);
- the tracer, off by default (`enable()`): host spans (`span`), device stage
  events inside the seams (`stage`), read into `TRACER.spans` and
  `TRACER.stages` on the `time.perf_counter` clock.

The tracer's records:

- a span is `(name, thread id, t0, t1)`, what the host was doing from t0 to
  t1. It never waits for the device. Under a running `torch.profiler` it is
  also a `record_function` range of that name;
- a stage reading is `(seam, t, ((stage, ms), ...))`: the device time from
  each stage boundary of one seam call to the next, `t` the host time of the
  call's launch. A boundary is a timing CUDA event recorded on the current
  stream; under a CUDA graph capture it becomes a node of the graph, so every
  replay records it again. The executor reads a graph's events before its next
  replay overwrites them, and `drain()` reads the rest.

Both buffers are bounded (`DEFAULT_CAPACITY` records): a full one drops its
oldest record, counted in `TRACER.dropped`, the time of the newest one dropped
in `TRACER.last_drop_t`. A stage reading whose events had not completed when read
is counted in `TRACER.skipped`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree


def _sync(out) -> None:
    """Wait for the CUDA work behind every tensor in `out`."""
    devices = {t.device for t in _pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def timed(label: Optional[str] = None, sync: bool = True):
    """Decorator that times a function, synchronising its outputs' CUDA
    devices first (the test_torch_cuda_time equivalent). Collects the
    seconds of every call on the function object (`fn.timings`)."""

    def deco(fn: Callable):
        timings: List[float] = []

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                _sync(out)
            dt = time.perf_counter() - t0
            timings.append(dt)
            name = label or fn.__name__
            print(f"[timed] {name}: {dt*1000:.2f} ms "
                  f"(avg {sum(timings)/len(timings)*1000:.2f} ms over "
                  f"{len(timings)})")
            return out

        wrapper.timings = timings
        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler capture of CPU and CUDA activity over the block,
    written as a Chrome trace (`trace.json`, viewable in Perfetto or
    chrome://tracing) under `log_dir`; yields the profiler, whose
    `key_averages()` sums the kernels by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Accumulating section timer."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        self.sections[name] = self.sections.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def summary(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total {total:.3f}s"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v:.3f}s ({100*v/max(total,1e-9):.0f}%)")
        return "\n".join(lines)


def fps_benchmark(step_fn: Callable[[], object], warmup: int = 3,
                  iters: int = 20) -> float:
    """Wall-clock FPS of a repeated step (reference sam2/benchmark.py:72-92),
    each timed pass ending in a sync of its outputs' CUDA devices."""
    for _ in range(warmup):
        _sync(step_fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = step_fn()
    _sync(out)
    return iters / (time.perf_counter() - t0)


# the tracer

DEFAULT_CAPACITY = 1 << 17


class _NoSpan:
    """The span handed out while tracing is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "t0", "rf")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name, self.rf = tracer, name, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.tracer.record(self.name, self.t0, t1)
        return False


class Tracer:
    """Spans and stage readings of the program, on `time.perf_counter`.
    Off until `enable()`; `TRACER` is the one the program records into."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.on = False
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self):
        """Empty the buffers and the counts (the on/off state stays)."""
        with self._lock:
            self.spans = collections.deque(maxlen=self.capacity)
            self.stages = collections.deque(maxlen=self.capacity)
            # the events of seam calls not read yet, by id of their list
            self._pending: "collections.OrderedDict[int, tuple]" = collections.OrderedDict()
            self.dropped, self.last_drop_t, self.skipped = 0, -math.inf, 0

    def _append(self, buf, rec):
        # under self._lock; a full buffer drops its oldest record
        if len(buf) == buf.maxlen:
            self.dropped += 1
            old = buf[0]
            self.last_drop_t = max(self.last_drop_t, old[3] if buf is self.spans else old[1])
        buf.append(rec)

    def record(self, name: str, t0: float, t1: float):
        """A span measured by the caller."""
        with self._lock:
            self._append(self.spans, (name, threading.get_ident(), t0, t1))

    # stage events

    def _collector(self):
        return getattr(self._local, "events", None)

    @contextlib.contextmanager
    def collect(self, events: list):
        """Gather into `events` the stage boundaries recorded in this thread
        inside the block, the block's start first, while tracing is on. The
        caller runs the block on the card."""
        if not self.on:
            yield events
            return
        prev = self._collector()
        self._local.events = events
        try:
            self.stage("start")
            yield events
        finally:
            self._local.events = prev

    def stage(self, name: str):
        events = self._collector()
        if events is None:
            return
        ev = torch.cuda.Event(enable_timing=True,
                              external=torch.cuda.is_current_stream_capturing())
        ev.record()
        events.append((name, ev))

    def launched(self, seam: str, t: float, events: list):
        """A seam call launched at host time t records `events`; they are
        read by `read(events)` (a graph's, before its next replay records
        over them) or by `drain()`."""
        if len(events) < 2:
            return
        with self._lock:
            self._pending[id(events)] = (seam, t, events)
            while len(self._pending) > self.capacity:
                self._read(*self._pending.popitem(last=False)[1])

    def read(self, events: list):
        """Read `events` into `stages` if they are pending."""
        with self._lock:
            pending = self._pending.pop(id(events), None)
            if pending is not None:
                self._read(*pending)

    def _read(self, seam, t, events):
        # under self._lock
        if not events[-1][1].query():
            self.skipped += 1
            return
        ms = tuple((name, a.elapsed_time(b)) for (_, a), (name, b) in zip(events, events[1:]))
        self._append(self.stages, (seam, t, ms))

    def drain(self):
        """Read every seam call's events still pending."""
        with self._lock:
            while self._pending:
                self._read(*self._pending.popitem(last=False)[1])


TRACER = Tracer()


def enable(on: bool = True):
    """Turn the tracer on or off. Graphs captured with it off are captured
    anew when it is on, so that their replays carry the stage events."""
    TRACER.on = bool(on)


def enabled() -> bool:
    return TRACER.on


def span(name: str, detail=None):
    """Context manager recording a host span named `name` (`name:detail`
    when `detail` is given); while tracing is off, one shared no-op."""
    if not TRACER.on:
        return _NO_SPAN
    return _Span(TRACER, name if detail is None else f"{name}:{detail}")


def record(name: str, t0: float, t1: float):
    """A span the caller timed itself, recorded when tracing is on."""
    if TRACER.on:
        TRACER.record(name, t0, t1)


def stage(name: str, x: torch.Tensor):
    """Mark the end of stage `name` inside a seam on the device that holds
    `x`: nothing on the CPU, while tracing is off, or outside a seam."""
    if TRACER.on and x.is_cuda:
        TRACER.stage(name)


def drain():
    """Read the stage events still pending into `TRACER.stages`."""
    TRACER.drain()
