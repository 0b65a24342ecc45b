"""Share of the traced units' time in which no kernel, copy or set ran on
the card."""

from portbench.harness.readers import idle_pct


def read(run):
    return idle_pct(run)
