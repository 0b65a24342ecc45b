"""K2 (`flash_rope_*` kernels: the rotation, the attention body, the
combine): the least time of memory attention's self- and cross-attention,
over the memory tokens present at each frame, over K2's device time, in
the traced sessions."""

from portbench.harness import flops
from portbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k2", lambda B, Sq, Skv, D, valid: flops.k2_bound_s(
        B, Sq, Skv, D, valid_keys=valid), r"flash_rope_")
