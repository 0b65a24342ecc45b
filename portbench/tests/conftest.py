"""A tiny copy of the benchmark for CPU tests: the cells' own traffic files
and limits at toy sizes (hiera-t at 256 px, small frames), the real metric
readers, and a BENCHMARK.json naming them. A traffic file that
BENCHMARK.json does not name yet (a cell whose comparison is still to be
proven on the card, see PERF.md) is named in the tiny copy, so that its
driver stays tested."""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_SIZES = {
    "video": dict(height=64, width=96, frames=[9, 10, 8], warm_frames=2, shapes=2),
    "image": dict(height=90, width=120, warm_requests=1, traced_requests=2, check_requests=2),
}


def _lists(x):
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return [_lists(v) for v in x]
    return x


def make_tiny(dest: Path) -> Path:
    """Writes the tiny benchmark under `dest`; returns it (the root, which
    holds BENCHMARK.json and portbench/)."""
    from sam2_opt_tpu_torch.config import model_config

    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = dest / "portbench"
    (bench / "configs").mkdir(parents=True, exist_ok=True)
    (bench / "workloads").mkdir(exist_ok=True)
    shutil.copytree(REPO / "portbench" / "metrics", bench / "metrics", dirs_exist_ok=True)
    for entry in spec["configs"]:
        config = json.loads((REPO / entry["file"]).read_text())
        config["overrides"] = {"image_size": 256}
        config["variant"] = "hiera_t"
        config["model"] = _lists(dataclasses.asdict(model_config("hiera_t", image_size=256)))
        (bench / "configs" / Path(entry["file"]).name).write_text(json.dumps(config))
    named = {cell["name"] for cell in spec["workloads"]}
    for path in sorted((REPO / "portbench" / "workloads").glob("*.json")):
        if path.stem not in named:
            config, traffic_name = path.stem.split(".", 1)
            spec["workloads"].append({"name": path.stem, "config": f"sam2.1_{config}",
                                      "traffic": traffic_name, "chips": 1, "why": "not named yet"})
        traffic = json.loads(path.read_text())
        traffic.update(TINY_SIZES[traffic["driver"]])
        (bench / "workloads" / path.name).write_text(json.dumps(traffic))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))


def run_cell(root: Path, cell: str, *extra, seed: int = 3000000017, seconds: float = 1.0,
             trace: int = 0, capsys=None):
    """Runs a tiny cell on the CPU through `run.main`; returns (rc, result
    line as a dict or None)."""
    from portbench import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace), *extra], root=root, bench=root / "portbench",
                  device="cpu")
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out else None
    return rc, line
