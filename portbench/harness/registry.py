"""Finds a cell's pieces by name: its entry in BENCHMARK.json, its
configuration file, its traffic file, its driver and its per-layer metric
readers. A new cell of an existing driver is two data files (or one, with a
configuration already there), a new per-layer metric one reader file; no
file that is already there changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]


class Registry:
    def __init__(self, root: Path = PORTBENCH.parent, bench: Path = PORTBENCH):
        """`root` holds BENCHMARK.json; `bench` holds configs/, workloads/
        and metrics/ (tests point both at a temporary copy)."""
        self.root, self.bench = Path(root), Path(bench)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"{path} not found: run from the root of a checkout")
        self.spec = json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next((c for c in self.spec["configs"] if c["name"] == name), None)
        if entry is None:
            raise KeyError(f"no config {name!r} in BENCHMARK.json")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, cell: str) -> dict:
        return json.loads((self.bench / "workloads" / f"{cell}.json").read_text())

    @staticmethod
    def driver(name: str):
        return importlib.import_module(f"portbench.drivers.{name}")

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]

    def reader(self, metric: str):
        """`read(run)` of metrics/<metric>.py."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
