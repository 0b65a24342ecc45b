"""What a per-layer metric reader sees of a traced run, and the reductions
the readers share. A reader returns None where it finds nothing to read;
the metric is then left out of the result line.

Span statistics come from the run's untraced units (the profiler slows the
traced ones); device statistics from the traced units' trace. A roofline
share is the least time of the kernel's work in the traced units (from the
cell's own schedule, `harness/flops.py`) over the kernel's device time.
"""

from __future__ import annotations

import statistics

from portbench.harness import flops


class RunView:
    def __init__(self, ctx, trace):
        self.window, self.trace, self.config = ctx.window, trace, ctx.config

    def units(self, traced: bool):
        return [u for u in self.window.units if u.done and u.traced == traced]

    def span_ms(self, name: str):
        return [1e3 * s.seconds for s in self.window.finished_spans(name, traced=False)]


def median_ms(run: RunView, span: str):
    xs = run.span_ms(span)
    return statistics.median(xs) if xs else None


def mean_ms(run: RunView, span: str):
    xs = run.span_ms(span)
    return statistics.fmean(xs) if xs else None


def mfu_pct(run: RunView):
    """Model operations of the untraced units over their time, as a share
    of the bf16 peak."""
    units = run.units(traced=False)
    seconds = sum(u.t1 - u.t0 for u in units)
    if not units or seconds <= 0:
        return None
    return 100.0 * sum(u.work["flops"] for u in units) / seconds / flops.PEAK_BF16


def idle_pct(run: RunView):
    if run.trace is None or run.trace.window_seconds() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_seconds() / run.trace.window_seconds())


def roofline_pct(run: RunView, calls: str, bound, pattern: str):
    """Least time of the traced units' `calls` (a key of the units' work)
    under `bound`, over the device time of kernels matching `pattern`."""
    if run.trace is None:
        return None
    least = sum(bound(*c) for u in run.units(traced=True) for c in u.work.get(calls, []))
    spent = run.trace.kernel_seconds(pattern)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
