"""The measured window, its clock and the harness's spans.

One clock (`time.perf_counter`) serves the window and every span. A span
is recorded around each of the harness's own calls into the port (a
session's `init_state` and clicks, a tracked frame, `set_image`, a
`predict`); in a traced run each span is also a `record_function` range, so
the trace shows which call the host was in during each idle gap.

The window accumulates only the time the system works for the client: a
unit (a session, an image request) is timed from its first call to its last
result on the host, and the client's preparation of its next input (the
synthetic video or image, made on the card from the seed) lies outside it.
The window ends at the first unit boundary after `seconds` of such time:
every unit counted ran whole, and its time is all in the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class Span:
    name: str
    unit: int
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Unit:
    """One unit of work: its index, kind, whether it was traced, its time
    on the clock and what it asked of the model (filled by the driver)."""

    index: int
    kind: str
    traced: bool = False
    t0: float = 0.0
    t1: float = 0.0
    done: bool = False
    work: dict = dataclasses.field(default_factory=dict)


class Window:
    def __init__(self, seconds: float, sync):
        self.seconds = float(seconds)
        self.sync = sync  # waits for the device: every span ends on results the host holds
        self.spans: List[Span] = []
        self.units: List[Unit] = []
        self._profiling = False
        self._unit: Optional[Unit] = None

    def busy_seconds(self) -> float:
        return sum(u.t1 - u.t0 for u in self.units if u.done)

    def open(self) -> bool:
        return self.busy_seconds() < self.seconds

    @contextlib.contextmanager
    def unit(self, kind: str, traced: bool = False):
        u = Unit(len(self.units), kind, traced)
        self.units.append(u)
        self._unit, self._profiling = u, traced
        self.sync()
        u.t0 = time.perf_counter()
        try:
            yield u
            self.sync()
            u.t1 = time.perf_counter()
            u.done = True
        finally:
            self._unit, self._profiling = None, False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self._profiling:
            import torch

            rf = torch.profiler.record_function(name)
        with rf:
            t0 = time.perf_counter()
            yield
            self.sync()
            t1 = time.perf_counter()
        self.spans.append(Span(name, self._unit.index if self._unit else -1, t0, t1))

    def finished_spans(self, name: str, traced: Optional[bool] = None) -> List[Span]:
        """Spans of finished units, optionally only (un)traced ones."""
        ok = {u.index for u in self.units if u.done and (traced is None or u.traced == traced)}
        return [s for s in self.spans if s.name == name and s.unit in ok]
