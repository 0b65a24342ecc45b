"""Model operations per second of the untraced units, as a share of the
card's bf16 peak (`harness/flops.py` counts them)."""

from portbench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
