"""The port's demo server and session API (`sam2_opt_tpu_torch/serve/`): the
four tests of tests/test_serve.py on the port, on the CPU, with the JAX
tiny128 weights. The HTTP responses are held against the port's video
predictor called in-process on the same frames (tests/
test_torch_video_predictor.py holds that predictor against JAX's): every
decoded RLE mask equals its logits > 0, exactly. The video is a folder of
PNG frames."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor
from sam2_opt_tpu_torch.serve.inference_api import InferenceAPI
from sam2_opt_tpu_torch.serve.server import DemoServer
from sam2_opt_tpu_torch.utils.amg import rle_to_mask

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def predictor(tiny128_cfg, tiny128_params):
    sd = state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    return SAM2VideoPredictor(build_sam2(cfg=tiny128_cfg, state_dict=sd, device="cpu"),
                              fill_hole_area=0)


@pytest.fixture(scope="module")
def server(predictor):
    srv = DemoServer(InferenceAPI(predictor), port=0).start_background()
    yield srv
    srv.shutdown()


def _post(server, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.read()


def _decoded(frame):
    return {r["objectId"]: rle_to_mask(r["mask"]) for r in frame["results"]}


def test_http_session_flow(server, predictor, tmp_path):
    rng = np.random.default_rng(0)
    vdir = tmp_path / "vid"
    vdir.mkdir()
    for t in range(3):
        Image.fromarray((rng.random((96, 128, 3)) * 255).astype(np.uint8)).save(vdir / f"{t}.png")

    status, body = _post(server, "/start_session", {"video_path": str(vdir)})
    assert status == 200
    sid = json.loads(body)["sessionId"]

    status, body = _post(server, "/add_points", {
        "sessionId": sid, "frameIndex": 0, "objectId": 1, "points": [[60, 40]], "labels": [1]})
    assert status == 200
    out = json.loads(body)
    assert out["frameIndex"] == 0 and out["results"][0]["objectId"] == 1
    assert out["results"][0]["mask"]["size"] == [96, 128]

    status, body = _post(server, "/propagate_in_video", {"sessionId": sid, "startFrameIndex": 0})
    assert status == 200
    frames = [json.loads(line) for line in body.decode().strip().split("\n")]
    assert [f["frameIndex"] for f in frames] == [0, 1, 2]

    # the same calls straight through the predictor
    state = predictor.init_state(str(vdir))
    _, _, masks = predictor.add_new_points_or_box(state, 0, 1, points=np.array([[60.0, 40.0]]),
                                                  labels=np.array([1]))
    assert np.array_equal(_decoded(out)[1], masks[0, 0].numpy() > 0)
    for frame, (t, ids, masks) in zip(frames, predictor.propagate_in_video(state)):
        assert frame["frameIndex"] == t and ids == [1]
        assert np.array_equal(_decoded(frame)[1], masks[0, 0].numpy() > 0)

    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server, "/add_points", {"sessionId": "nope", "frameIndex": 0, "objectId": 1,
                                      "points": [[1, 1]], "labels": [1]})
    assert exc.value.code == 404

    status, _ = _post(server, "/close_session", {"sessionId": sid})
    assert status == 200


def test_healthy(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthy", timeout=30) as resp:
        assert resp.status == 200
        assert json.loads(resp.read())["ok"] is True


def test_propagation_blocks_same_session_mutation(predictor):
    """A streamed propagation holds the SESSION lock: a concurrent add_points
    on the same session waits for the stream to finish; cancellation is not
    blocked."""
    api = InferenceAPI(predictor)
    video = (np.random.default_rng(0).random((3, 64, 64, 3)) * 255).astype(np.uint8)
    sid = api.start_session(video)
    api.add_points(sid, 0, 1, points=[[32.0, 32.0]], labels=[1])

    stream = api.propagate_in_video(sid)
    next(stream)  # stream open: session lock held
    events = []

    def mutate():
        api.add_points(sid, 0, 2, points=[[10.0, 10.0]], labels=[1])
        events.append("mutated")

    t = threading.Thread(target=mutate)
    t.start()
    time.sleep(0.5)
    assert events == [], "mutation ran while the stream held the session"
    assert api.cancel_propagate_in_video(sid)
    assert list(stream) == []
    t.join(timeout=60)
    assert not t.is_alive() and events == ["mutated"]
    api.close_session(sid)


def test_cancel_survives_restart(predictor):
    """Cancel-then-restart: the cancel aimed at the in-flight stream stops it
    although a new stream starts before the old one observes the cancel."""
    api = InferenceAPI(predictor)
    video = (np.random.default_rng(0).random((4, 64, 64, 3)) * 255).astype(np.uint8)
    sid = api.start_session(video)
    api.add_points(sid, 0, 1, points=[[32.0, 32.0]], labels=[1])

    stream_a = api.propagate_in_video(sid)
    next(stream_a)  # A holds the session lock
    assert api.cancel_propagate_in_video(sid)

    b_frames = []

    def run_b():
        for frame in api.propagate_in_video(sid):
            b_frames.append(frame["frameIndex"])

    t = threading.Thread(target=run_b)
    t.start()
    time.sleep(0.2)
    t0 = time.time()
    assert list(stream_a) == []
    assert time.time() - t0 < 30
    t.join(timeout=120)
    assert not t.is_alive()
    assert b_frames == [0, 1, 2, 3], "restarted stream was wrongly canceled"
    api.close_session(sid)
