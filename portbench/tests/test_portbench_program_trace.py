"""The readers of the port's own records (`harness/program_trace.py`,
`metrics/{image_input_ms,encoder_device_ms,decoder_device_ms,masks_out_ms,
idle_unattributed_pct}.image.py`): a tiny image cell on the CPU with the
port's tracer on reads the host spans (the CPU records no stage event, so
the device readers find nothing); a program without a tracer, or with a
record dropped inside the window, gives nothing and raises nothing."""

from __future__ import annotations

import json
import types

import pytest
from conftest import make_tiny, run_cell

NEW = {"image_input_ms.image": "program_span", "encoder_device_ms.image": "program_span",
       "decoder_device_ms.image": "program_span", "masks_out_ms.image": "program_span",
       "idle_unattributed_pct.image": "device_trace"}
CELL = "hiera_large.image_3prompt"


@pytest.fixture
def root(tmp_path):
    root = make_tiny(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, source in NEW.items():
        spec["per_layer"].append({"name": name, "unit": "%" if "pct" in name else "ms",
                                  "better": "lower", "source": source, "layer": "test",
                                  "moves": "image_p95_ms", "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tracer():
    from sam2_opt_tpu_torch.utils import profiling

    profiling.TRACER.reset()
    profiling.enable()
    yield profiling.TRACER
    profiling.enable(False)
    profiling.TRACER.reset()


def test_host_span_readers_on_cpu(root, tracer, capsys):
    # seconds enough for an untraced request before and after the traced ones
    rc, line = run_cell(root, CELL, trace=1, seconds=4.0, capsys=capsys)
    assert rc == 0 and line["correct"]
    got = line["metrics"]
    assert got["image_input_ms.image"]["value"] > 0
    assert got["masks_out_ms.image"]["value"] > 0
    assert 0 <= got["idle_unattributed_pct.image"]["value"] < 100
    assert "encoder_device_ms.image" not in got and "decoder_device_ms.image" not in got
    assert "set_image_ms.image" in got and "predict_ms.image" in got


def test_no_tracer_reads_nothing(root, monkeypatch, capsys):
    import sam2_opt_tpu_torch.utils

    # the readers' view of a program before the tracer: a profiling module
    # without one (the port's modules keep the one they imported)
    monkeypatch.setattr(sam2_opt_tpu_torch.utils, "profiling", types.ModuleType("profiling"))
    rc, line = run_cell(root, CELL, trace=1, seconds=4.0, capsys=capsys)
    assert rc == 0 and not set(NEW) & set(line["metrics"])
    assert "set_image_ms.image" in line["metrics"]


def _run(units, spans=(), stages=(), dropped=0, last_drop_t=float("-inf")):
    unit = [types.SimpleNamespace(t0=a, t1=b, done=True, traced=False) for a, b in units]
    window = types.SimpleNamespace(units=unit)
    run = types.SimpleNamespace(window=window, trace=None,
                                units=lambda traced: [u for u in unit if u.traced == traced])
    tracer = types.SimpleNamespace(spans=list(spans), stages=list(stages), dropped=dropped,
                                   last_drop_t=last_drop_t, drain=lambda: None)
    return run, tracer


def test_program_trace_reductions(monkeypatch):
    from portbench.harness import program_trace as pt
    from sam2_opt_tpu_torch.utils import profiling

    spans = [("image.upload", 1, 0.1, 0.2), ("image.resize", 1, 0.2, 0.25),
             ("image.upload", 1, 1.1, 1.4), ("other", 1, 1.4, 1.5)]
    stages = [("enc", 0.3, (("a", 2.0), ("b", 3.0))), ("enc", 1.3, (("a", 4.0), ("b", 1.0))),
              ("dec", 1.35, (("a", 9.0),))]
    run, tracer = _run([(0.0, 1.0), (1.0, 2.0)], spans, stages)
    monkeypatch.setattr(profiling, "TRACER", tracer)
    units = pt.untraced_units(run)
    assert pt.median_span_ms(run, units, {"image.upload", "image.resize"}) == \
        pytest.approx(1e3 * (0.15 + 0.3) / 2)
    assert pt.median_stage_ms(run, units, "enc", ("a", "b")) == pytest.approx(5.0)
    assert pt.median_stage_ms(run, units, "dec", ("a",)) is None   # missing in unit 0
    assert pt.median_span_ms(run, units, {"image.resize"}) is None  # none in unit 1
    # a record dropped before the window is harmless; one inside it is not
    tracer.dropped, tracer.last_drop_t = 3, -1.0
    assert pt.records(run) is not None
    tracer.last_drop_t = 0.5
    assert pt.records(run) is None
    assert pt.median_stage_ms(run, units, "enc", ("a", "b")) is None
