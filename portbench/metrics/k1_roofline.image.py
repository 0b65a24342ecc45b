"""K1 (`flash_fwd_*` kernels): the least time of the global-attention
blocks' attention over K1's device time, in the traced requests."""

from portbench.harness import flops
from portbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1", flops.k1_bound_s, r"flash_fwd_")
