"""The port's own records of a traced run, on the harness's clock.

The port's tracer (`sam2_opt_tpu_torch/utils/profiling.py`, turned on before
the model is built) keeps host spans `(name, thread, t0, t1)` and
device stage readings `(seam, t_launch, ((stage, ms), ...))`, both on
`time.perf_counter`, the clock of the window, its units and spans and of the
device trace (`harness/trace.py` maps the trace onto it). A record belongs to
the unit or harness span whose interval holds it.

Every function returns None where there is nothing sound to read: the
program has no tracer (a checkout before it), the tracer dropped a record
inside the window, or an interval it reduces holds none of the records asked
for (a stage reading is missing where its events had not completed).
"""

from __future__ import annotations

import bisect
import statistics
import sys
from collections import defaultdict

from portbench.harness.trace import _holding


class Records:
    def __init__(self, spans, stages):
        self.spans = sorted(spans, key=lambda s: s[2])     # (name, thread, t0, t1)
        self.stages = sorted(stages, key=lambda s: s[1])   # (seam, t, ((stage, ms), ...))
        self._span_t0 = [s[2] for s in self.spans]
        self._stage_t = [s[1] for s in self.stages]

    def spans_in(self, t0: float, t1: float):
        lo = bisect.bisect_left(self._span_t0, t0)
        hi = bisect.bisect_right(self._span_t0, t1)
        return [s for s in self.spans[lo:hi] if s[3] <= t1]

    def stages_in(self, t0: float, t1: float):
        return self.stages[bisect.bisect_left(self._stage_t, t0):
                           bisect.bisect_right(self._stage_t, t1)]


def records(run):
    """The port's records, or None (no tracer; a record dropped in the
    window; no finished unit)."""
    try:
        from sam2_opt_tpu_torch.utils import profiling
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    units = [u for u in run.window.units if u.done]
    if tracer is None or not units:
        return None
    tracer.drain()
    if tracer.dropped and tracer.last_drop_t >= min(u.t0 for u in units):
        return None
    return Records(list(tracer.spans), list(tracer.stages))


def untraced_units(run):
    return [(u.t0, u.t1) for u in run.units(traced=False)]


def harness_spans(run, name: str, traced: bool = False):
    return [(s.t0, s.t1) for s in run.window.finished_spans(name, traced=traced)]


def span_ms(recs: Records, intervals, names):
    """Per interval, the summed ms of the program spans named in `names`
    inside it; None if an interval holds none."""
    out = []
    for t0, t1 in intervals:
        xs = [s[3] - s[2] for s in recs.spans_in(t0, t1) if s[0] in names]
        if not xs:
            return None
        out.append(1e3 * sum(xs))
    return out


def stage_ms(recs: Records, intervals, seam: str, stages):
    """Per interval, {stage: ms} summed over the seam's readings launched
    inside it; None if an interval lacks one of `stages`."""
    out = []
    for t0, t1 in intervals:
        acc = defaultdict(float)
        for s, _, readings in recs.stages_in(t0, t1):
            if s == seam:
                for name, ms in readings:
                    acc[name] += ms
        if not set(stages) <= set(acc):
            return None
        out.append({k: acc[k] for k in stages})
    return out


def median_span_ms(run, intervals, names):
    recs = records(run)
    xs = span_ms(recs, intervals, names) if recs is not None else None
    return statistics.median(xs) if xs else None


def note_span_medians(run, intervals, names, label: str):
    """Notes on stderr each span's median over the intervals (ms)."""
    recs = records(run)
    per = {n: span_ms(recs, intervals, {n}) if recs is not None else None for n in names}
    medians = {n: round(statistics.median(xs), 4) for n, xs in per.items() if xs}
    print(f"portbench: {label}, median ms: {medians}", file=sys.stderr)


def median_stage_ms(run, intervals, seam: str, stages):
    recs = records(run)
    xs = stage_ms(recs, intervals, seam, stages) if recs is not None else None
    return statistics.median(sum(x.values()) for x in xs) if xs else None


def idle_by_span(run):
    """Idle seconds of the traced units: ({innermost program span open at a
    gap's middle: seconds}, {"<harness span> / <host operation>": seconds}
    of the gaps at whose middle no program span is open), or None without a
    device trace or records."""
    trace, recs = run.trace, records(run)
    if trace is None or recs is None:
        return None
    harness = sorted(trace.spans)
    by_span, unattributed = defaultdict(float), defaultdict(float)
    for (u0, u1), busy in trace._busy_intervals():
        held = recs.spans_in(u0, u1)
        prev = u0
        for t0, t1 in list(busy) + [(u1, u1)]:
            if t0 > prev:
                mid = 0.5 * (prev + t0)
                inner = [s for s in held if s[2] <= mid <= s[3]]
                if inner:
                    by_span[max(inner, key=lambda s: s[2])[0]] += t0 - prev
                else:
                    host = _holding(trace.host_ops, mid)
                    where = _holding(harness, mid) or "between spans"
                    unattributed[f"{where} / {host}" if host else where] += t0 - prev
            prev = max(prev, t1)
    return dict(by_span), dict(unattributed)


def _replays(run, seam: str, until: str):
    """Per traced harness span `until` that launched the seam's graph once:
    (the launch's host time, the span's end, the device operations that
    start between them, the seam's stage readings {stage: ms} there)."""
    trace, recs = run.trace, records(run)
    if trace is None or recs is None:
        return []
    starts = [op[0] for op in trace.ops]
    out = []
    for h0, h1 in harness_spans(run, until, traced=True):
        launches = [s for s in recs.spans_in(h0, h1) if s[0] == f"graph.replay:{seam}"]
        if len(launches) != 1:
            continue
        t0 = launches[0][2]
        ops = trace.ops[bisect.bisect_left(starts, t0):bisect.bisect_right(starts, h1)]
        readings = defaultdict(float)
        for name, _, rs in recs.stages_in(h0, h1):
            if name == seam:
                for stage, ms in rs:
                    readings[stage] += ms
        out.append((t0, h1, ops, dict(readings)))
    return out


def replay_device_ms(run, seam: str, until: str):
    """Per traced harness span `until` that launched the seam's graph once:
    (the seam's stage readings summed, the union of the trace's device
    operations from the launch to the span's end, which adds the copies of
    the graph's outputs), in ms."""
    out = []
    for _, h1, ops, readings in _replays(run, seam, until):
        busy, cur = 0.0, None
        for a, b, _ in ops:
            b = min(b, h1)
            if cur and a <= cur[1]:
                cur[1] = max(cur[1], b)
            else:
                busy += (cur[1] - cur[0]) if cur else 0.0
                cur = [a, b]
        busy += (cur[1] - cur[0]) if cur else 0.0
        out.append((sum(readings.values()), 1e3 * busy))
    return out or None


def ops_by_stage(run, seam: str, until: str, stages, top: int = 3):
    """The device operations of the seam's replays in the traced units, each
    placed in the stage that its start falls in (stage boundaries laid from
    the first operation by the unit's own readings): {stage: [(name, ms)]},
    the `top` of each by time."""
    acc = defaultdict(lambda: defaultdict(float))
    for _, _, ops, readings in _replays(run, seam, until):
        if not ops or not set(stages) <= set(readings):
            continue
        edges, t = [], ops[0][0]
        for stage in stages:
            t += 1e-3 * readings[stage]
            edges.append(t)
        for a, b, name in ops:
            k = bisect.bisect_left(edges, a)
            acc[stages[k] if k < len(stages) else "after"][name] += 1e3 * (b - a)
    return {k: sorted(v.items(), key=lambda kv: -kv[1])[:top] for k, v in acc.items()}
