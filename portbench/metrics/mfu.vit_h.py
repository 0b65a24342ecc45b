"""Model operations per second of the untraced requests, as a share of the
card's bf16 peak; the requests' work is ViT-H's count
(`harness/flops_vit.py`)."""

from portbench.harness.readers import mfu_pct


def read(run):
    return mfu_pct(run)
