"""The port's executor (`sam2_opt_tpu_torch/core/executor.py`): its LRU cache
held against the JAX package's, the signature keys, the graphs cleared on a
backend change, and the seams free of host syncs, which a CUDA graph could
not capture. CPU tensors run eagerly (the CPU has no graphs); the
graph-versus-eager cases are `gpu`-marked and run on the card:
`python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_executor.py`.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.core.executor import GraphExecutor, LRUCache, signature
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

torch.set_num_threads(2)


def _lru_script(cache):
    """Inserts, hits, a re-insert and evictions; returns what is left, in
    order, and what each lookup saw."""
    seen = []
    for k in "abc":
        cache[k] = k.upper()
    seen.append(cache.get("a"))          # a becomes the newest
    cache["d"] = "D"                     # evicts b
    seen += [cache.get("b"), "b" in cache, cache["c"]]
    cache["a"] = "A2"                    # re-insert moves a to the end
    cache["e"] = "E"                     # evicts d
    seen += [cache.get("d", "missing"), len(cache)]
    return seen, [(k, cache[k]) for k in list(cache._d)]


def test_lru_matches_jax():
    from sam2_opt_tpu.core.executor import LRUCache as JaxLRUCache

    assert _lru_script(LRUCache(3)) == _lru_script(JaxLRUCache(3))
    seen, left = _lru_script(LRUCache(3))
    assert seen == ["A", None, False, "C", "missing", 3]
    assert [k for k, _ in left] == ["c", "a", "e"]
    assert LRUCache(0).maxsize == 1


def test_lru_default_size_from_env(monkeypatch):
    from sam2_opt_tpu.core.executor import LRUCache as JaxLRUCache

    assert LRUCache().maxsize == JaxLRUCache().maxsize == 128
    monkeypatch.setenv("SAM2_TPU_JIT_CACHE_SIZE", "5")
    assert LRUCache().maxsize == JaxLRUCache().maxsize == 5
    assert GraphExecutor()._graphs.maxsize == 5


def test_signature_keys(monkeypatch):
    x, y = torch.zeros(2, 3), torch.zeros(1, 4, dtype=torch.int32)
    monkeypatch.delenv("SAM2_TPU_FUSED_KV_PROJ", raising=False)
    base = signature(("predict_masks", True, False), (x, y, None))
    assert base == signature(("predict_masks", True, False), (x + 1, y * 2, None))
    monkeypatch.setenv("SAM2_TPU_FUSED_KV_PROJ", "1")
    switched = signature(("predict_masks", True, False), (x, y, None))  # a route switch
    monkeypatch.delenv("SAM2_TPU_FUSED_KV_PROJ")
    others = [
        signature(("predict_masks", False, False), (x, y, None)),   # a static flag
        signature(("predict_masks", True, False), (x[:1], y, None)),  # a shape
        signature(("predict_masks", True, False), (x.double(), y, None)),  # a dtype
        signature(("predict_masks", True, False), (torch.zeros(3, 2).t(), y, None)),  # a layout
        signature(("predict_masks", True, False), (x, y, x)),      # a prompt present
        signature(("predict_masks", True, False), ((x, y), None)),  # the structure
        signature(("predict_masks", True, False), (x, y, 3)),      # a constant leaf
        switched,
    ]
    assert len({base, *others}) == 1 + len(others)


def test_cpu_tensors_run_eagerly():
    """On CPU tensors the executor calls fn every time and keeps nothing."""
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"sum": a + b, "b": (b, None)}

    ex = GraphExecutor()
    a, b = torch.ones(3), torch.arange(3.0)
    for _ in range(2):
        out = ex.run("add", fn, (a, b))
    assert len(calls) == 2 and len(ex) == 0 and ex.captures == 0
    assert torch.equal(out["sum"], a + b) and out["b"][1] is None


def test_mixed_devices_raise():
    """A seam whose tensors are not all on one kind of device is refused
    before anything runs, whichever tensor comes first."""
    calls = []
    ex = GraphExecutor()
    cpu, meta = torch.ones(3), torch.ones(3, device="meta")
    for args in ((cpu, meta), (meta, cpu)):
        with pytest.raises(ValueError, match="all on the CPU"):
            ex.run("add", lambda a, b: calls.append(1), args)
    assert not calls and len(ex) == 0 and ex.captures == 0


@pytest.fixture(scope="module")
def tiny_model():
    return build_sam2(cfg=model_config("hiera_t", image_size=128), seed=0, device="cpu")


def test_backend_change_clears_graphs(tiny_model):
    model = tiny_model
    try:
        model.speedup()
        assert model.backend == "cuda" and model.compute_dtype == torch.bfloat16
        assert model._use_graphs
        model.graphs._graphs["stale"] = object()
        model.set_runtime_backend("cuda", {"dtype": torch.float32})
        assert len(model.graphs) == 0 and model._compute is model.module
        assert model.compute_dtype == torch.float32 and model._use_graphs
        model.graphs._graphs["stale"] = object()
        model.set_runtime_backend("cuda", {"dtype": torch.bfloat16})
        assert len(model.graphs) == 0 and model._use_graphs
        model.graphs._graphs["stale"] = object()
        model.set_runtime_backend("eager")
        assert len(model.graphs) == 0 and not model._use_graphs
        with pytest.raises(ValueError):
            model.set_runtime_backend("cuda", {"dtype": torch.float16})
    finally:
        model.set_runtime_backend("eager")


class _HostSyncs(TorchDispatchMode):
    """Records the ops that read a tensor's value on the host or copy host
    data into a tensor: inside a CUDA graph capture each would fail."""

    FORBIDDEN = {"_local_scalar_dense", "lift_fresh", "lift_fresh_copy", "nonzero",
                 "is_nonzero", "masked_select", "item", "_unique2", "unique_dim",
                 "unique_consecutive", "equal"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.FORBIDDEN:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def _seam_script(model):
    rng = np.random.default_rng(0)
    pred = SAM2ImagePredictor(model)
    pred.set_image((rng.random((96, 128, 3)) * 255).astype(np.uint8))
    _, _, low = pred.predict(point_coords=np.array([[50.0, 40.0]]), point_labels=np.array([1]))
    pred.predict(point_coords=np.array([[50.0, 40.0]]), point_labels=np.array([1]),
                 mask_input=low[:1], multimask_output=False)
    video = (rng.random((4, 64, 64, 3)) * 255).astype(np.uint8)
    vp = SAM2VideoPredictor(model)
    state = vp.init_state(video)
    vp.add_new_points_or_box(state, 0, 1, points=np.array([[30.0, 30.0]]), labels=np.array([1]))
    vp.add_new_mask(state, 0, 2, np.pad(np.ones((20, 20), bool), 22))
    list(vp.propagate_in_video(state))  # two objects: one batched step a frame
    vp.remove_object(state, 2)
    list(vp.propagate_in_video(state))  # one object: the conditioned step


def test_seams_have_no_host_sync(tiny_model):
    """Every seam that `speedup()` captures, run through `SAM2Model.run` on
    the CPU (where it runs eagerly), reads nothing back to the host and
    copies nothing from it: the image encoder, the prompt decoder with and
    without a mask prompt, the init, conditioned and batched tracking steps
    and the memory encoder. As the executor warms a seam up before it
    captures it, the script runs once first, which builds the constants
    cached per device. Host work between the seams (memory selection, hole
    filling, consolidation) is outside the mode."""
    model = tiny_model
    _seam_script(model)
    seams = []
    run = model.run

    def spy(name, fn, args):
        def checked(*a):
            with _HostSyncs() as mode:
                out = fn(*a)
            seams.append((name, mode.seen))
            return out
        return run(name, checked, args)

    model.run = spy
    try:
        _seam_script(model)
    finally:
        del model.run
    names = {name[0] if isinstance(name, tuple) else name for name, _ in seams}
    assert names == {"encode_image", "encode_image_e2e", "predict_masks", "track_init",
                     "track_cond", "track_batch", "memenc"}, names
    assert all(not seen for _, seen in seams), [s for s in seams if s[1]]


def test_tracking_step_has_one_signature(tiny_model):
    """As the memory bank fills (1 to 5 real slots of 7), the conditioned
    step keeps one signature: stored memories have the zero slots' layout,
    so a video captures one tracking graph per object count and capacity."""
    model = tiny_model
    keys = {}
    run = model.run

    def spy(name, fn, args):
        keys.setdefault(name[0] if isinstance(name, tuple) else name, set()).add(
            signature(name, args))
        return run(name, fn, args)

    model.run = spy
    try:
        vp = SAM2VideoPredictor(model)
        video = (np.random.default_rng(1).random((6, 64, 64, 3)) * 255).astype(np.uint8)
        state = vp.init_state(video)
        vp.add_new_points_or_box(state, 0, 1, points=np.array([[30.0, 30.0]]),
                                 labels=np.array([1]))
        list(vp.propagate_in_video(state))
    finally:
        del model.run
    assert len(keys["track_cond"]) == 1 and len(keys["encode_image"]) == 1, {
        k: len(v) for k, v in keys.items()}


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sam2_opt_tpu_torch.kernels import _build

    _build.build_all()


def _masks_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_image_graphs_match_eager_on_card(dtype):
    """set_image and predict through graphs against the same dtype eagerly:
    fp32 logits within 1e-6 of their scale (bitwise expected), bf16 masks
    at mIoU >= 0.999; one graph per signature, replayed on the second call."""
    _gpu()
    model = build_sam2(cfg=model_config("hiera_t", image_size=256), seed=0)
    pred = SAM2ImagePredictor(model)
    image = (np.random.default_rng(0).random((200, 300, 3)) * 255).astype(np.uint8)
    prompt = dict(point_coords=np.array([[150.0, 100.0]]), point_labels=np.array([1]))
    outs = []
    for graphs in (False, True):
        pred.set_runtime_backend("cuda", {"dtype": dtype})
        model._use_graphs = graphs  # False: the same dtype eagerly
        for _ in range(2):
            pred.set_image(image)
            masks, ious, low = pred.predict(**prompt, return_logits=True)
        outs.append((masks, low))
    assert len(model.graphs) == 2 and model.graphs.captures == 2
    (eager_m, eager_low), (graph_m, graph_low) = outs
    if dtype == torch.float32:
        assert np.abs(graph_low - eager_low).max() <= 1e-6 * np.abs(eager_low).max()
    else:
        a, b = eager_m > 0, graph_m > 0
        assert (a & b).sum() / max((a | b).sum(), 1) >= 0.999


@pytest.mark.gpu
def test_video_graphs_match_eager_on_card():
    """Three tracked frames through graphs (init, conditioned, memory
    encoder) against fp32 eager: logits within 1e-6 of their scale."""
    _gpu()
    vp = SAM2VideoPredictor(build_sam2(cfg=model_config("hiera_t", image_size=256), seed=0))
    with torch.no_grad():
        vp.model.module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    video = (np.random.default_rng(0).random((4, 120, 160, 3)) * 255).astype(np.uint8)
    runs = []
    for backend, args in (("eager", None), ("cuda", {"dtype": torch.float32})):
        vp.set_runtime_backend(backend, args)
        state = vp.init_state(video)
        vp.add_new_points_or_box(state, 0, 1, points=np.array([[80.0, 60.0]]),
                                 labels=np.array([1]))
        runs.append([m.float().cpu() for _, _, m in vp.propagate_in_video(state)])
    kinds = {k[0][0] if isinstance(k[0], tuple) else k[0] for k in vp.model.graphs.keys()}
    assert {"encode_image", "track_init", "track_cond", "memenc"} <= kinds
    for a, b in zip(*runs):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


@pytest.mark.gpu
def test_failed_capture_raises_on_card():
    """A seam that reads a value back to the host cannot be captured: the
    executor raises and runs nothing eagerly in its place; nor does it run a
    seam whose tensors lie on the card and on the CPU."""
    _gpu()
    ex = GraphExecutor()
    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError):
        ex.run("host read", lambda t: t * t.sum().item(), (x,))
    for args in ((x, x.cpu()), (x.cpu(), x)):
        with pytest.raises(ValueError, match="all on the CPU"):
            ex.run("mixed", lambda a, b: a + b.to(a.device), args)
    assert len(ex) == 0
    out = ex.run("plain", lambda t: t * 2, (x,))
    assert torch.equal(out, x * 2) and len(ex) == 1 and ex.captures == 1
