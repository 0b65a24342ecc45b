"""The port's tracer (`sam2_opt_tpu_torch/utils/profiling.py`) and the graph
executor's counters (`core/executor.py`).

On the CPU: spans off (one shared no-op, no record), on (nested, on the
`perf_counter` clock, per thread), a full buffer counting its drops, the
image predictor's spans in order, no stage event off the card, the tracer
keying the graphs' signature, and the counters through `GET /healthy`.
On the card (`gpu`): a captured seam's stage readings, against CUDA events
around its replay, read at every replay; a graph captured with the tracer
off captured anew once it is on; the counters of real replays. The card
tests: `python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_tracing.py`.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.core.executor import GraphExecutor, signature
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
from sam2_opt_tpu_torch.serve.inference_api import InferenceAPI
from sam2_opt_tpu_torch.serve.server import DemoServer
from sam2_opt_tpu_torch.utils import profiling

torch.set_num_threads(2)

IMAGE_SPANS = ["image.prepare", "image.upload", "image.resize", "seam:encode_image_e2e"]
PREDICT_SPANS = ["predict.prompts", "seam:predict_masks", "predict.postprocess",
                 "predict.download"]
ENCODER_STAGES = ["trunk.stage1", "trunk.stage2", "trunk.stage3", "trunk.stage4", "neck"]


@pytest.fixture
def tracer():
    """The tracer on, emptied; off and emptied again afterwards."""
    profiling.TRACER.reset()
    profiling.enable()
    yield profiling.TRACER
    profiling.enable(False)
    profiling.TRACER.reset()


def _collapsed(names):
    """Consecutive repeats as one (a span name may close in two modules)."""
    return [n for i, n in enumerate(names) if i == 0 or names[i - 1] != n]


def test_tracing_off_records_nothing():
    profiling.enable(False)
    profiling.TRACER.reset()
    assert profiling.span("a") is profiling.span("b", "seam")
    with profiling.span("a"):
        profiling.record("b", 0.0, 1.0)
        profiling.stage("c", torch.ones(2))
    profiling.drain()
    t = profiling.TRACER
    assert not t.spans and not t.stages and t.dropped == 0 and t.skipped == 0


def test_spans_nest_on_the_perf_counter_clock(tracer):
    t0 = time.perf_counter()
    with profiling.span("outer"):
        with profiling.span("inner", "detail"):
            time.sleep(0.002)
    t1 = time.perf_counter()
    (inner, tid_i, i0, i1), (outer, tid_o, o0, o1) = tracer.spans
    assert (inner, outer) == ("inner:detail", "outer")
    assert t0 <= o0 <= i0 < i1 <= o1 <= t1 and i1 - i0 >= 0.002
    assert tid_i == tid_o == threading.get_ident()


def test_spans_keep_their_threads(tracer):
    idents, both = {}, threading.Barrier(2, timeout=30)

    def work(name):
        idents[name] = threading.get_ident()
        both.wait()  # both alive at once: their idents differ
        for _ in range(50):
            with profiling.span(name):
                pass

    threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert len(tracer.spans) == 100
    assert {(name, tid) for name, tid, _, _ in tracer.spans} == set(idents.items())
    assert idents["t0"] != idents["t1"]


def test_full_buffer_counts_its_drops():
    tracer = profiling.Tracer(capacity=4)
    for i in range(6):
        tracer.record(f"s{i}", float(i), i + 0.5)
    assert [s[0] for s in tracer.spans] == ["s2", "s3", "s4", "s5"]
    assert tracer.dropped == 2 and tracer.last_drop_t == 1.5


def test_image_predictor_spans_in_order(tracer):
    model = build_sam2(cfg=model_config("hiera_t", image_size=128), seed=0, device="cpu")
    pred = SAM2ImagePredictor(model)
    image = (np.random.default_rng(0).random((60, 90, 3)) * 255).astype(np.uint8)
    t0 = time.perf_counter()
    pred.set_image(image)
    n_image = len(tracer.spans)
    _, _, low = pred.predict(point_coords=np.array([[30.0, 20.0]]), point_labels=np.array([1]))
    pred.predict(box=np.array([10.0, 10.0, 50.0, 40.0]), mask_input=low[:1],
                 multimask_output=False)
    t1 = time.perf_counter()
    spans = list(tracer.spans)
    names = [s[0] for s in sorted(spans, key=lambda s: s[2])]
    assert _collapsed(names[:n_image]) == IMAGE_SPANS
    assert _collapsed(names[n_image:]) == PREDICT_SPANS * 2
    assert all(t0 <= s[2] <= s[3] <= t1 for s in spans)
    # the CPU runs the seams eagerly: no stage events, no replays
    profiling.drain()
    assert not tracer.stages and model.graphs.counters()["seams"] == {}


def test_stage_records_nothing_on_cpu(tracer):
    profiling.stage("x", torch.ones(2))
    assert not tracer._pending
    model = build_sam2(cfg=model_config("hiera_t", image_size=128), seed=0, device="cpu")
    model.encode_image_e2e(torch.rand(1, 3, 128, 128))
    profiling.drain()
    assert not tracer.stages and tracer.skipped == 0
    assert [s[0] for s in tracer.spans] == ["image.resize", "seam:encode_image_e2e"]


def test_tracer_keys_the_graph_signature():
    x = torch.ones(2, 3)
    profiling.enable(False)
    off = signature("seam", (x,))
    profiling.enable(True)
    try:
        assert signature("seam", (x,)) != off
    finally:
        profiling.enable(False)
    assert signature("seam", (x,)) == off


class _Predictor:
    def __init__(self):
        self.model = type("Model", (), {"graphs": GraphExecutor()})()


def test_healthy_reports_executor_counters():
    predictor = _Predictor()
    graphs = predictor.model.graphs
    graphs._seams["encode_image_e2e"] = {"replays": 3, "captures": 1, "copy_in_bytes": 96,
                                         "copy_out_bytes": 192}
    graphs._lock_wait_s, graphs.captures = 0.25, 1
    srv = DemoServer(InferenceAPI(predictor), port=0).start_background()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthy", timeout=30) as r:
            body = json.loads(r.read())
    finally:
        srv.shutdown()
    assert body["ok"] is True and body["numSessions"] == 0
    assert body["graphs"] == graphs.counters() == {
        "captures": 1, "lock_wait_s": 0.25,
        "seams": {"encode_image_e2e": {"replays": 3, "captures": 1, "copy_in_bytes": 96,
                                       "copy_out_bytes": 192}}}
    # a copy: the caller's dict does not alias the executor's
    graphs.counters()["seams"]["encode_image_e2e"]["replays"] = 0
    assert graphs.counters()["seams"]["encode_image_e2e"]["replays"] == 3


# on the card


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _staged(w):
    def fn(x):
        y = x
        for _ in range(4):
            y = y @ w
        profiling.stage("a", y)
        for _ in range(8):
            y = y @ w
        profiling.stage("b", y)
        return y
    return fn


@pytest.mark.gpu
def test_stage_readings_of_a_replay_on_card(tracer):
    """Readings are positive, sum to within 10% of CUDA events around the
    replay, and are read once per replay (skipped and counted where a replay
    had not finished when the next one came)."""
    _gpu()
    w = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16) / 45.0
    x = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    ex, fn = GraphExecutor(), _staged(w)
    ex.run("staged", fn, (x,))
    (entry,) = ex._graphs.values()
    assert [n for n, _ in entry.events] == ["start", "a", "b"]
    for _ in range(3):
        b0, b1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        b0.record()
        entry.graph.replay()
        b1.record()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for (_, a), (_, b) in zip(entry.events, entry.events[1:])]
        assert all(m > 0 for m in ms)
        assert abs(sum(ms) - b0.elapsed_time(b1)) <= 0.1 * b0.elapsed_time(b1)
    profiling.TRACER.reset()
    for _ in range(5):
        ex.run("staged", fn, (x,))
        torch.cuda.synchronize()
    profiling.drain()
    stages = list(tracer.stages)
    assert len(stages) == 5 and tracer.skipped == 0
    assert [t for _, t, _ in stages] == sorted({t for _, t, _ in stages})
    assert all(seam == "staged" and [n for n, _ in r] == ["a", "b"] and min(m for _, m in r) > 0
               for seam, _, r in stages)
    for _ in range(4):  # no wait between replays
        ex.run("staged", fn, (x,))
    profiling.drain()
    assert len(tracer.stages) + tracer.skipped == 9
    c = ex.counters()["seams"]["staged"]
    assert c["replays"] == 10 and c["captures"] == 1
    assert c["copy_in_bytes"] == c["copy_out_bytes"] == 10 * x.numel() * 2


@pytest.mark.gpu
def test_image_seams_stage_readings_on_card(tracer):
    _gpu()
    pred = SAM2ImagePredictor(build_sam2(cfg=model_config("hiera_t", image_size=256), seed=0))
    pred.speedup()
    image = (np.random.default_rng(0).random((120, 160, 3)) * 255).astype(np.uint8)
    for _ in range(2):
        pred.set_image(image)
        pred.predict(point_coords=np.array([[60.0, 40.0]]), point_labels=np.array([1]))
        torch.cuda.synchronize()
    profiling.drain()
    by_seam = {}
    for seam, _, readings in tracer.stages:
        by_seam.setdefault(seam, []).append(readings)
    assert [[n for n, _ in r] for r in by_seam["encode_image_e2e"]] == [ENCODER_STAGES] * 2
    assert [[n for n, _ in r] for r in by_seam["predict_masks"]] == \
        [["prompt_encoder", "mask_decoder"]] * 2
    assert all(ms > 0 for rs in by_seam.values() for r in rs for _, ms in r)
    names = {s[0] for s in tracer.spans}
    for seam in ("encode_image_e2e", "predict_masks"):
        assert {f"graph.{p}:{seam}" for p in ("lock_wait", "capture", "copy_in", "replay",
                                               "copy_out")} <= names
    c = pred.model.graphs.counters()
    assert c["seams"]["encode_image_e2e"]["replays"] == 2
    assert c["seams"]["encode_image_e2e"]["captures"] == 1 and c["lock_wait_s"] >= 0


@pytest.mark.gpu
def test_eager_seam_stage_readings_on_card(tracer):
    """A seam run eagerly on the card (graphs off, as `chip_smoke.py` runs
    the same dtype) records the same stage events."""
    _gpu()
    model = build_sam2(cfg=model_config("hiera_t", image_size=256), seed=0)
    model.speedup()
    model._use_graphs = False
    model.encode_image_e2e(torch.rand(1, 3, 256, 256, device="cuda"))
    torch.cuda.synchronize()
    profiling.drain()
    ((seam, _, readings),) = tracer.stages
    assert seam == "encode_image_e2e" and [n for n, _ in readings] == ENCODER_STAGES
    assert all(ms > 0 for _, ms in readings) and model.graphs.captures == 0


@pytest.mark.gpu
def test_graph_captured_with_tracing_off_is_captured_anew_on_card():
    _gpu()
    profiling.enable(False)
    profiling.TRACER.reset()
    w = torch.randn(256, 256, device="cuda") / 16.0
    x = torch.randn(256, 256, device="cuda")
    ex, fn = GraphExecutor(), _staged(w)
    ex.run("staged", fn, (x,))
    assert ex.captures == 1 and not next(iter(ex._graphs.values())).events
    profiling.enable(True)
    try:
        ex.run("staged", fn, (x,))
        torch.cuda.synchronize()
        assert ex.captures == 2
        assert ex.counters()["seams"]["staged"] == {
            "replays": 2, "captures": 2, "copy_in_bytes": 2 * x.numel() * 4,
            "copy_out_bytes": 2 * x.numel() * 4}
        profiling.drain()
        assert [[n for n, _ in r] for _, _, r in profiling.TRACER.stages] == [["a", "b"]]
    finally:
        profiling.enable(False)
        profiling.TRACER.reset()
