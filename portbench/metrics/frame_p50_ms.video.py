"""Median time of a tracked frame: the generator asked, the frame's
video-resolution logits on the host."""

from portbench.harness.readers import median_ms


def read(run):
    return median_ms(run, "frame")
