"""The port's profiling utilities (`sam2_opt_tpu_torch/utils/profiling.py`)
against the JAX package's, and its examples (`sam2_opt_tpu_torch/examples/`)
run on the CPU.

- `Timer.summary` gives the JAX text for the same sections; `timed` keeps
  every call's seconds and prints the JAX line; `trace` writes a Chrome
  trace; `fps_benchmark` returns a rate;
- `examples.image` at hiera_t (1024 px, random weights from seed 0, fp32
  eager) on a synthetic image writes its PNG, its masks those of the same
  calls in this process; `examples.video` on the first frame of a JPEG
  folder (its click frame: a tracked frame at 1024 px costs ~13 s of CPU
  here; `chip_smoke.py` phase 26 tracks 3 frames) writes its mp4;
  `examples.benchmark_compare` scores a prediction equal to its ground
  truth at J&F 100.
"""

import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from sam2_opt_tpu.utils import profiling as jax_profiling
from sam2_opt_tpu_torch.utils import profiling

torch.set_num_threads(2)


def test_timer_summary_matches_jax():
    ours, ref = profiling.Timer(), jax_profiling.Timer()
    sections = {"encode": 0.25, "decode": 0.0625, "track": 1.5}
    for timer in (ours, ref):
        timer.sections.update(sections)
        with timer.section("encode"):
            pass
    # the same sections, timed apart: set them equal, then compare the text
    ours.sections = dict(ref.sections)
    assert ours.summary() == ref.summary()
    assert profiling.Timer().summary() == jax_profiling.Timer().summary() == "total 0.000s"


def test_timed_collects_timings(capsys):
    @profiling.timed("double")
    def double(x):
        return x * 2

    for _ in range(3):
        assert torch.equal(double(torch.ones(4)), torch.full((4,), 2.0))
    assert len(double.timings) == 3 and all(t >= 0 for t in double.timings)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert re.fullmatch(r"\[timed\] double: \d+\.\d\d ms \(avg \d+\.\d\d ms over 3\)", lines[-1])
    assert profiling.timed()(lambda: None).__name__ == "<lambda>"


def test_trace_and_fps_benchmark(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.matmul(x, x)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in ev.key for ev in prof.key_averages())
    assert profiling.fps_benchmark(lambda: torch.matmul(x, x), warmup=1, iters=3) > 0


def _image(seed=0):
    rng = np.random.default_rng(seed)
    return (np.kron(rng.random((12, 16, 3)), np.ones((64, 64, 1))) * 255).astype(np.uint8)


def test_example_image_on_cpu(tmp_path):
    from sam2_opt_tpu_torch import build_sam2_image_predictor
    from sam2_opt_tpu_torch.examples import image as ex_image

    image = _image()
    path = tmp_path / "image.png"
    Image.fromarray(image).save(path)
    masks, ious = ex_image.main(str(path), variant="hiera_t", output_dir=str(tmp_path / "out"),
                                device="cpu")
    assert masks.shape == (3, 768, 1024) and ious.shape == (3,)
    assert os.listdir(tmp_path / "out") == ["00000.png"]
    predictor = build_sam2_image_predictor("hiera_t", device="cpu")
    predictor.set_image(image)
    want, want_ious, _ = predictor.predict(point_coords=ex_image.POINTS,
                                           point_labels=np.array([1, 1], np.int32))
    assert np.array_equal(masks, want) and np.array_equal(ious, want_ious)


def test_example_video_on_cpu(tmp_path):
    from sam2_opt_tpu_torch.examples import video as ex_video

    frames = tmp_path / "frames"
    frames.mkdir()
    image = _image(1)
    for t in range(3):
        Image.fromarray(np.roll(image, 24 * t, axis=1)[:480, :640]).save(frames / f"{t:05d}.jpg")
    results = ex_video.main(str(frames), variant="hiera_t",
                            output_path=str(tmp_path / "demo.mp4"), max_frames=1, device="cpu")
    assert [f for f, _ in results] == [0]
    assert all(m.shape == (1, 1, 480, 640) and np.isfinite(m).all() for _, m in results)
    assert os.path.getsize(tmp_path / "demo.mp4") > 0


def test_example_benchmark_compare(tmp_path, capsys):
    from sam2_opt_tpu_torch.eval.vos_inference import save_ann_png
    from sam2_opt_tpu_torch.examples import benchmark_compare

    for root in ("gt", "pred"):
        for t in range(4):
            mask = np.zeros((24, 32), np.uint8)
            mask[4 + t:14 + t, 6:20] = 1
            save_ann_png(str(tmp_path / root / "video0" / "1" / f"{t:05d}.png"), mask)
    jf, j, f = benchmark_compare.main(["--gt_root", str(tmp_path / "gt"),
                                       "--pred_root", str(tmp_path / "pred")])
    assert jf == j == f == pytest.approx(100.0)
    assert "J&F: 100.0" in capsys.readouterr().out
