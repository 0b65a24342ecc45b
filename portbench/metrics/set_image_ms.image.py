"""Median time of `set_image`, the features ready on the card."""

from portbench.harness.readers import median_ms


def read(run):
    return median_ms(run, "set_image")
