"""Median time of one `predict`, its logits on the host."""

from portbench.harness.readers import median_ms


def read(run):
    return median_ms(run, "predict")
