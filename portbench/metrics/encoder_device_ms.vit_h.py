"""Median over the untraced requests of the SAM ViT encoder seam's device
time from its stage events, the seam's start to the neck's end inside its
CUDA graph replay: four periods of seven windowed blocks and one global
block each, and the neck. Notes on stderr each stage's median."""

import statistics
import sys

from portbench.harness import program_trace as pt

SEAM = "encode_image_e2e"
STAGES = ("vit.period1", "vit.period2", "vit.period3", "vit.period4", "vit.neck")


def read(run):
    value = pt.median_stage_ms(run, pt.untraced_units(run), SEAM, STAGES)
    if value is not None:
        per = pt.stage_ms(pt.records(run), pt.untraced_units(run), SEAM, STAGES)
        note = {k: round(statistics.median(x[k] for x in per), 4) for k in STAGES}
        print(f"portbench: encoder stages, median ms: {note}", file=sys.stderr)
    return value
