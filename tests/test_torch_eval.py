"""The port's VOS evaluation (`sam2_opt_tpu_torch/eval/`): the tests of
tests/test_eval.py on the port, with the J&F metrics held against JAX's
`eval.metrics` on random masks (numpy only; exact, since both run the same
numpy arithmetic and the two dilations are the same binary dilation), the
benchmark folders written as PNGs with Pillow, and the VOS
inference on the port's video predictor with the JAX tiny128 weights."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sam2_opt_tpu.eval import metrics as jax_metrics
from sam2_opt_tpu_torch.eval.metrics import Evaluator, boundary_f_measure, get_iou, seg2bmap
from sam2_opt_tpu_torch.eval.sav_benchmark import benchmark

torch.set_num_threads(2)


def test_iou_analytic():
    assert get_iou(0, 0) == 1  # both empty
    assert get_iou(50, 150) == 0.5


def test_perfect_match_scores_100():
    ev = Evaluator()
    gt = np.zeros((64, 64), np.uint8)
    gt[20:40, 20:40] = 1
    for _ in range(3):
        ev.feed_frame(mask=gt, gt=gt)
    iou, f = ev.conclude()
    assert iou[1] == 100.0 and f[1] == 100.0


def test_half_overlap_iou():
    ev = Evaluator()
    gt = np.zeros((64, 64), np.uint8)
    gt[0:20, 0:20] = 1
    pred = np.zeros_like(gt)
    pred[0:20, 10:30] = 1  # half horizontal overlap
    ev.feed_frame(mask=pred, gt=gt)
    iou, _ = ev.conclude()
    assert abs(iou[1] - 100 / 3) < 1e-6  # inter 200, union 600


def test_seg2bmap_simple():
    seg = np.zeros((16, 16), bool)
    seg[2:12, 2:12] = True
    b = seg2bmap(seg)
    assert 0 < b.sum() < seg.sum()  # only the rim marked


def test_boundary_f_empty_cases():
    empty = np.zeros((32, 32), bool)
    full = np.zeros((32, 32), bool)
    full[8:24, 8:24] = True
    assert boundary_f_measure(empty, empty) == 1.0
    assert boundary_f_measure(empty, full) == 0.0
    assert boundary_f_measure(full, empty) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    """Random blob masks over a few frames: every boundary map, F, J and the
    concluded per-object scores equal JAX's exactly."""
    rng = np.random.default_rng(seed)
    ours, theirs = Evaluator(), jax_metrics.Evaluator()
    for _ in range(3):
        gt = np.kron(rng.integers(0, 4, (12, 16)), np.ones((6, 6), int)).astype(np.uint8)
        pred = np.where(rng.random(gt.shape) < 0.1, rng.integers(0, 4, gt.shape), gt)
        pred = pred.astype(np.uint8)
        a, b = pred == 1, gt == 1
        assert np.array_equal(seg2bmap(a), jax_metrics.seg2bmap(a))
        for bound in (0.008, 0.05):
            assert boundary_f_measure(a, b, bound) == jax_metrics.boundary_f_measure(a, b, bound)
        ours.feed_frame(mask=pred, gt=gt)
        theirs.feed_frame(mask=pred, gt=gt)
    assert ours.conclude() == theirs.conclude()


def _write_png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


def test_benchmark_folders_davis_layout(tmp_path):
    gt_root, pred_root = tmp_path / "gt", tmp_path / "pred"
    for vid in ("video_a", "video_b"):
        for t in range(4):
            mask = np.zeros((32, 48), np.uint8)
            mask[5:20, 8:30] = 1
            _write_png(str(gt_root / vid / f"{t:05d}.png"), mask)
            _write_png(str(pred_root / vid / f"{t:05d}.png"), mask)
    jf, j, f, _ = benchmark([str(gt_root)], [str(pred_root)], num_processes=1, verbose=False)
    assert jf[0] == 100.0 and j[0] == 100.0 and f[0] == 100.0


def test_benchmark_folders_sav_layout(tmp_path):
    """Also through the worker pool, which the port starts with spawn."""
    gt_root, pred_root = tmp_path / "gt", tmp_path / "pred"
    for obj in ("000", "001"):
        for t in range(4):
            mask = np.zeros((32, 48), np.uint8)
            mask[4:16, 4:20] = 1
            _write_png(str(gt_root / "sav_000001" / obj / f"{t:05d}.png"), mask)
            pred = mask if obj == "000" else np.zeros_like(mask)
            _write_png(str(pred_root / "sav_000001" / obj / f"{t:05d}.png"), pred)
    for processes in (1, 2):
        _, j, _, _ = benchmark([str(gt_root)], [str(pred_root)], num_processes=processes,
                               verbose=False)
        assert abs(j[0] - 50.0) < 1e-6  # one perfect object, one missed


def test_put_per_obj_mask_lowest_id_wins():
    from sam2_opt_tpu_torch.eval.vos_inference import put_per_obj_mask

    a = np.zeros((4, 4), bool)
    a[:, :3] = True  # obj 1
    b = np.zeros((4, 4), bool)
    b[:, 1:] = True  # obj 3
    mask = put_per_obj_mask({1: a, 3: b}, 4, 4)
    assert (mask[:, 1:3] == 1).all()
    assert (mask[:, 0] == 1).all() and (mask[:, 3] == 3).all()


@pytest.fixture(scope="module")
def vos_fixture(tmp_path_factory, tiny128_cfg, tiny128_params):
    """Synthetic 3-frame DAVIS-layout video (PNG frames) where object 2
    first appears in frame 1."""
    from sam2_opt_tpu_torch.eval.vos_inference import davis_palette, save_ann_png
    from sam2_opt_tpu_torch.io.weights import state_dict_from_params
    from sam2_opt_tpu_torch.models.model import build_sam2
    from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

    root = tmp_path_factory.mktemp("vos")
    vdir = root / "JPEGImages" / "vid0"
    vdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for t in range(3):
        img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
        img[20:40, 10:30] = (230, 210, 60)
        Image.fromarray(img).save(vdir / f"{t:05d}.png")
    ann0 = np.zeros((64, 64), np.uint8)
    ann0[20:40, 10:30] = 1
    ann1 = ann0.copy()
    ann1[45:60, 40:60] = 2
    for t, ann in ((0, ann0), (1, ann1)):
        save_ann_png(str(root / "Annotations" / "vid0" / f"{t:05d}.png"), ann, davis_palette())
    sd = state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    predictor = SAM2VideoPredictor(build_sam2(cfg=tiny128_cfg, state_dict=sd, device="cpu"),
                                   fill_hole_area=0)
    return root, predictor


def test_vos_inference_joint(vos_fixture, tmp_path):
    """The joint path seeds frame 0 only: the late object is absent. The
    written palette PNGs carry the input palette and score finite J&F."""
    from sam2_opt_tpu_torch.eval.vos_inference import davis_palette, load_ann_png, vos_inference

    root, predictor = vos_fixture
    out = vos_inference(predictor, str(root / "JPEGImages"), str(root / "Annotations"),
                        str(tmp_path / "out"), "vid0")
    assert set(out) == {0, 1, 2}
    for t in out:
        assert set(out[t]) == {1}
    mask, palette = load_ann_png(str(tmp_path / "out" / "vid0" / "00002.png"))
    assert mask.shape == (64, 64) and palette[:48] == davis_palette()[:48]
    jf, _, _, _ = benchmark([str(root / "Annotations")], [str(tmp_path / "out")],
                            strict=False, num_processes=1, verbose=False,
                            skip_first_and_last=False)
    assert np.isfinite(jf[0])


def test_vos_inference_separate_tracks_late_object(vos_fixture, tmp_path):
    from sam2_opt_tpu_torch.eval.vos_inference import vos_separate_inference_per_object

    root, predictor = vos_fixture
    out = vos_separate_inference_per_object(predictor, str(root / "JPEGImages"),
                                            str(root / "Annotations"), str(tmp_path / "out2"),
                                            "vid0")
    assert set(out) == {0, 1, 2}
    for t in out:
        assert set(out[t]) == {1, 2}
    assert out[0][1][20:40, 10:30].mean() > 0.9
    assert out[1][2][45:60, 40:60].mean() > 0.9
    assert not out[0][2].any()
    assert (tmp_path / "out2" / "vid0" / "00002.png").exists()


def test_benchmark_skips_empty_gt_track(tmp_path):
    gt_root, pred_root = tmp_path / "gt", tmp_path / "pred"
    full = np.zeros((32, 48), np.uint8)
    full[4:16, 4:20] = 1
    empty = np.zeros_like(full)
    for t in range(4):
        _write_png(str(gt_root / "sav_000002" / "000" / f"{t:05d}.png"), full)
        _write_png(str(pred_root / "sav_000002" / "000" / f"{t:05d}.png"), full)
        _write_png(str(gt_root / "sav_000002" / "001" / f"{t:05d}.png"), full if t == 0 else empty)
        _write_png(str(pred_root / "sav_000002" / "001" / f"{t:05d}.png"), empty)
    with pytest.warns(UserWarning, match="no non-empty GT"):
        jf, j, _, _ = benchmark([str(gt_root)], [str(pred_root)], num_processes=1,
                                verbose=False)
    assert jf[0] == 100.0 and j[0] == 100.0


def test_benchmark_and_cli_match_jax(tmp_path, monkeypatch, capsys):
    """Imperfect predictions in both layouts: the port's `benchmark` gives
    JAX's J&F, J, F and per-video scores exactly, and the evaluator CLI
    runs on them."""
    from sam2_opt_tpu.eval.sav_benchmark import benchmark as jax_benchmark
    from sam2_opt_tpu_torch.eval import sav_evaluator

    rng = np.random.default_rng(5)
    gt_root, pred_root = tmp_path / "gt", tmp_path / "pred"
    for t in range(5):
        gt = np.kron(rng.integers(0, 3, (4, 6)), np.ones((8, 8), int)).astype(np.uint8)
        pred = np.where(rng.random(gt.shape) < 0.15, rng.integers(0, 3, gt.shape), gt)
        _write_png(str(gt_root / "davis_vid" / f"{t:05d}.png"), gt)
        _write_png(str(pred_root / "davis_vid" / f"{t:05d}.png"), pred)
        for obj in ("000", "001"):
            _write_png(str(gt_root / "sav_vid" / obj / f"{t:05d}.png"), gt == int(obj) + 1)
            _write_png(str(pred_root / "sav_vid" / obj / f"{t:05d}.png"), pred == int(obj) + 1)
    ours = benchmark([str(gt_root)], [str(pred_root)], num_processes=1, verbose=False)
    theirs = jax_benchmark([str(gt_root)], [str(pred_root)], num_processes=1, verbose=False)
    assert ours == theirs and 0 < ours[0][0] < 100
    monkeypatch.setattr("sys.argv", ["sav_evaluator", "--gt_root", str(gt_root), "--pred_root",
                                     str(pred_root), "--num_processes", "1"])
    sav_evaluator.main()
    assert "J&F" in capsys.readouterr().out
