"""The relative-position attention kernel (`flash_relpos_*`): the least
time of the traced requests' windowed and global attention calls
(`harness/flops_vit.py`) over its device time."""

from portbench.harness import flops_vit
from portbench.harness.readers import roofline_pct


def read(run):
    return roofline_pct(run, "relpos", flops_vit.relpos_bound_s, r"flash_relpos_")
