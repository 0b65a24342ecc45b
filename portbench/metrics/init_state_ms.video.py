"""Mean time of a session's `init_state` and its clicks on frame 0."""

from portbench.harness.readers import mean_ms


def read(run):
    return mean_ms(run, "init_state")
