"""The harness finds a cell's pieces by name: a configuration, a traffic
file and a per-layer metric dropped in as new files are found and run, and
no file that was already there changes."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

from conftest import make_tiny, run_cell


def _hashes(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_every_cell_resolves():
    from portbench.harness.registry import Registry

    reg = Registry()
    for cell in reg.spec["workloads"]:
        config, traffic = reg.config(cell["config"]), reg.traffic(cell["name"])
        assert config["name"] == cell["config"]
        assert callable(reg.driver(traffic["driver"]).run)
        assert set(traffic["limits"])
        assert reg.end_to_end(cell["name"]) and reg.per_layer(cell["name"])
        for m in reg.per_layer(cell["name"]):
            assert callable(reg.reader(m["name"]))


def test_new_cell_config_and_metric_are_new_files_only(tmp_path, capsys):
    root = make_tiny(tmp_path)
    bench = root / "portbench"
    before = _hashes(bench)
    # a new configuration, a new cell of the image driver and a new metric
    config = json.loads((bench / "configs/sam2.1_hiera_large.json").read_text())
    config["name"] = "tiny_new"
    (bench / "configs/tiny_new.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "workloads/hiera_large.image_3prompt.json").read_text())
    traffic.update(height=80, width=100)
    (bench / "workloads/tiny_new.image_small.json").write_text(json.dumps(traffic))
    (bench / "metrics/requests_done.image.py").write_text(
        "def read(run):\n    return float(len(run.units(traced=False)) + len(run.units(True)))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny_new",
                                file="portbench/configs/tiny_new.json"))
    spec["workloads"].append({"name": "tiny_new.image_small", "config": "tiny_new",
                              "traffic": "image_small", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("image_p95_ms",):
            m["workloads"].append("tiny_new.image_small")
    spec["per_layer"].append({"name": "requests_done.image", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "image predictor and encoder", "moves": "image_p95_ms",
                              "workloads": ["tiny_new.image_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    rc, line = run_cell(root, "tiny_new.image_small", trace=1, capsys=capsys)
    assert rc == 0 and line["metrics"]["requests_done.image"]["value"] >= 1
    rc, line = run_cell(root, "tiny_new.image_small", capsys=capsys)
    assert rc == 0 and set(line["metrics"]) == {"image_p95_ms", "setup_s"}
    after = _hashes(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_per_layer_selection_follows_workloads():
    from portbench.harness.registry import Registry

    reg = Registry()
    image = {m["name"] for m in reg.per_layer("hiera_large.image_3prompt")}
    assert "k1_roofline.image" in image and not any(n.endswith(".video") for n in image)
    assert callable(reg.reader("k2_roofline.video"))
