"""Share of the traced requests' device-idle time at whose middle no host
span of the port is open: the device trace's idle gaps joined, on one
clock, to the port's spans. Notes on stderr the idle time by the innermost
span open, and the rest by the harness's span and host operation."""

import sys

from portbench.harness import program_trace as pt


def _ms(d):
    return {k: round(1e3 * v, 3) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}


def read(run):
    idle = pt.idle_by_span(run)
    if idle is None:
        return None
    by_span, unattributed = idle
    total = sum(by_span.values()) + sum(unattributed.values())
    if total <= 0:
        return None
    print(f"portbench: idle by program span, traced ms: {_ms(by_span)}", file=sys.stderr)
    print(f"portbench: idle in no program span, traced ms: {_ms(unattributed)}", file=sys.stderr)
    return 100.0 * sum(unattributed.values()) / total
