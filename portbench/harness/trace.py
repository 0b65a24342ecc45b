"""The device trace of a traced run, and what is read from it.

`torch.profiler` records the traced units (CUPTI lists every kernel inside
a CUDA graph replay). The chrome trace is written under TMPDIR, read once
and deleted. Device operations are kernels, copies and sets. Busy time is
the union of their intervals inside the traced units' host intervals; an
idle gap is a stretch of a traced unit in which no device operation ran,
named by the innermost harness span and the outermost host operation open
at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """Device operations and host ranges of the traced units, on the host
    clock (seconds of `time.perf_counter`)."""

    def __init__(self, ops, host_ops, spans, units):
        self.ops = ops            # [(t0, t1, name)] device operations, sorted
        self.host_ops = host_ops  # [(t0, t1, name)] outermost host operations
        self.spans = spans        # [(t0, t1, name)] harness spans
        self.units = units        # [(t0, t1)] traced units

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device time, inside the traced units, of the operations
        whose name matches."""
        rx = re.compile(pattern)
        return sum(t1 - t0 for _, ops in self._in_units() for t0, t1, name in ops
                   if rx.search(name))

    def _in_units(self):
        """(unit, its device operations clipped to it) for each traced unit."""
        starts = [op[0] for op in self.ops]
        for u0, u1 in self.units:
            lo = bisect.bisect_left(starts, u0 - 1.0)
            hi = bisect.bisect_right(starts, u1)
            yield (u0, u1), [(max(t0, u0), min(t1, u1), name) for t0, t1, name in
                             self.ops[lo:hi] if min(t1, u1) > max(t0, u0)]

    def _busy_intervals(self):
        """Per traced unit, the union of its device operations' intervals."""
        for unit, ops in self._in_units():
            merged, cur = [], None
            for t0, t1, _ in ops:
                if cur and t0 <= cur[1]:
                    cur[1] = max(cur[1], t1)
                else:
                    if cur:
                        merged.append(tuple(cur))
                    cur = [t0, t1]
            if cur:
                merged.append(tuple(cur))
            yield unit, merged

    def window_seconds(self) -> float:
        return sum(u1 - u0 for u0, u1 in self.units)

    def busy_seconds(self) -> float:
        return sum(t1 - t0 for _, busy in self._busy_intervals() for t0, t1 in busy)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        acc: Dict[str, float] = defaultdict(float)
        for _, ops in self._in_units():
            for t0, t1, name in ops:
                acc[name] += t1 - t0
        return sorted(acc.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle seconds of the traced units summed by what the host was in:
        the harness span (they do not nest) and the outermost host operation
        open at each gap's middle."""
        spans = sorted(self.spans)
        acc: Dict[str, float] = defaultdict(float)
        for (u0, u1), busy in self._busy_intervals():
            prev, gaps = u0, []
            for t0, t1 in busy:
                if t0 > prev:
                    gaps.append((prev, t0))
                prev = max(prev, t1)
            if u1 > prev:
                gaps.append((prev, u1))
            for g0, g1 in gaps:
                mid = 0.5 * (g0 + g1)
                span = _holding(spans, mid) or "between spans"
                host = _holding(self.host_ops, mid)
                acc[f"{span} / {host}" if host else span] += g1 - g0
        return sorted(acc.items(), key=lambda kv: -kv[1])[:n]


def _holding(ranges, t):
    """Name of the range of the sorted, non-overlapping `ranges` that holds t."""
    i = bisect.bisect_right(ranges, (t, float("inf"), "")) - 1
    return ranges[i][2] if i >= 0 and ranges[i][1] >= t else None


class Profiler:
    """Starts and stops torch.profiler around traced units and turns its
    trace into a `Trace` on the host clock."""

    def __init__(self, sync, cuda: bool = True):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch, self._sync = torch, sync
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=activities)
        self.units: List[Tuple[float, float]] = []

    def __enter__(self):
        self._sync()
        self.prof.__enter__()
        # the trace's clock: a marker range at a known host time
        self._t_mark = time.perf_counter()
        with self._torch.profiler.record_function("portbench_clock_mark"):
            pass
        return self

    def __exit__(self, *exc):
        self._sync()
        self.prof.__exit__(*exc)
        return False

    def read(self, spans) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        mark = next(e for e in events if e.get("name") == "portbench_clock_mark")
        offset = self._t_mark - mark["ts"] * 1e-6  # trace us -> host seconds
        ops, host = [], []
        tid = mark.get("tid")
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0 = e["ts"] * 1e-6 + offset
            t1 = t0 + e["dur"] * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                ops.append((t0, t1, e["name"]))
            elif cat in ("cpu_op", "cuda_runtime", "cuda_driver") and e.get("tid") == tid:
                host.append((t0, t1, e["name"]))
        ops.sort()
        host.sort()
        outer, end = [], -1.0
        for t0, t1, name in host:
            if t0 >= end:
                outer.append((t0, t1, name))
                end = t1
        span_ranges = [(s.t0, s.t1, s.name) for s in spans]
        return Trace(ops, outer, span_ranges, list(self.units))
