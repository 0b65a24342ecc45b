"""Median over the untraced requests of the encoder seam's device time from
its stage events, the seam's start to the neck's end inside its CUDA graph
replay: the trunk's four stages and the neck.

Also notes on stderr, from the same run: each stage's median, and per
traced request the stages' sum beside the device trace's busy time from the
replay's launch to the end of `set_image` (the graph and the copies of its
outputs), with the trace's top operations in each stage."""

import statistics
import sys

from portbench.harness import program_trace as pt

SEAM = "encode_image_e2e"
STAGES = ("trunk.stage1", "trunk.stage2", "trunk.stage3", "trunk.stage4", "neck")


def read(run):
    value = pt.median_stage_ms(run, pt.untraced_units(run), SEAM, STAGES)
    if value is None:
        return None
    recs = pt.records(run)
    per = pt.stage_ms(recs, pt.untraced_units(run), SEAM, STAGES)
    note = {k: round(statistics.median(x[k] for x in per), 4) for k in STAGES}
    print(f"portbench: encoder stages, median ms: {note}", file=sys.stderr)
    pairs = pt.replay_device_ms(run, SEAM, "set_image")
    if pairs:
        events = statistics.median(p[0] for p in pairs)
        busy = statistics.median(p[1] for p in pairs)
        print(f"portbench: encoder, traced requests, median ms: stage events {events:.4f}, "
              f"trace busy {busy:.4f} (ratio {events / busy:.4f}, {len(pairs)} replays)",
              file=sys.stderr)
        for stage, ops in pt.ops_by_stage(run, SEAM, "set_image", STAGES).items():
            top = ", ".join(f"{name[:60]} {ms:.1f}" for name, ms in ops)
            print(f"portbench: encoder {stage}, traced ms: {top}", file=sys.stderr)
    return value
