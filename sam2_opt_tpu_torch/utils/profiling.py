"""Profiling and timing utilities (counterpart of
`sam2_opt_tpu/utils/profiling.py`; reference SURVEY.md §5):
- `timed`: a decorator that times a call, synchronising the CUDA devices
  its outputs lie on (the reference's `test_torch_cuda_time`);
- `trace`: a `torch.profiler` capture of CPU and CUDA activity, written as
  a Chrome trace under `log_dir`;
- `Timer` and `fps_benchmark`: the wall-clock FPS harness (reference
  sam2/benchmark.py:72-92).
"""

from __future__ import annotations

import contextlib
import functools
import os
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
