"""The port's automatic mask generator against the JAX package's, on the CPU.

`sam2_opt_tpu_torch/utils/amg.py` against `sam2_opt_tpu/utils/amg.py` on
random masks, logits and boxes (numpy only, no JAX jit): exact, as both run
the same integer and float64 arithmetic; `remove_small_regions` labels with
scipy where JAX uses OpenCV, and must give the same regions. The device
helpers of `predictors/amg.py` (stability score, mask -> box) against the
numpy versions, exact. Then one JAX AMG run on the tiny128 config at 4
points per side, with crops and small-region cleanup, held against the port
on the same weights: the same records in the same order, each mask at IoU
>= 0.99 and its scores within 1e-3 (both frameworks sum the 12-block trunk in
different orders; the image predictor test holds logits at 1e-3).
"""

import jax
import numpy as np
import pytest
import torch

from sam2_opt_tpu.models.model import SAM2Model as JaxSAM2Model
from sam2_opt_tpu.predictors.amg import SAM2AutomaticMaskGenerator as JaxAMG
from sam2_opt_tpu.utils import amg as J
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors import amg as port_amg
from sam2_opt_tpu_torch.utils import amg as P

torch.set_num_threads(2)


def _masks(seed, n=6, h=40, w=52, p=0.5):
    rng = np.random.default_rng(seed)
    masks = rng.random((n, h, w)) > p
    masks[0] = False  # one empty mask
    masks[1, 10:20, 5:30] = True
    return masks


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_and_boxes_match_jax(seed):
    masks = _masks(seed)
    ours, theirs = P.mask_to_rle(masks), J.mask_to_rle(masks)
    assert ours == theirs
    for rle, m in zip(ours, masks):
        assert np.array_equal(P.rle_to_mask(rle), J.rle_to_mask(rle))
        assert np.array_equal(P.rle_to_mask(rle), m)
        assert P.area_from_rle(rle) == J.area_from_rle(rle) == m.sum()
        assert P.coco_encode_rle(rle) == J.coco_encode_rle(rle)
    assert np.array_equal(P.batched_mask_to_box(masks), J.batched_mask_to_box(masks))
    assert np.array_equal(port_amg.mask_to_box(torch.from_numpy(masks)).numpy(),
                          J.batched_mask_to_box(masks))


def test_scores_grids_and_crops_match_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((5, 32, 32)) * 3).astype(np.float32)
    for thr, off in ((0.0, 1.0), (0.5, 0.25)):
        ref = J.calculate_stability_score(logits, thr, off)
        assert np.array_equal(P.calculate_stability_score(logits, thr, off), ref)
        assert np.array_equal(port_amg.stability_score(torch.from_numpy(logits), thr, off).numpy(),
                              ref)
    for n, layers, scale in ((7, 0, 1), (8, 2, 2)):
        for a, b in zip(P.build_all_layer_point_grids(n, layers, scale),
                        J.build_all_layer_point_grids(n, layers, scale)):
            assert np.array_equal(a, b)
    for size, layers, ratio in (((480, 640), 2, 0.34), ((97, 61), 1, 512 / 1500)):
        assert P.generate_crop_boxes(size, layers, ratio) == J.generate_crop_boxes(size, layers,
                                                                                   ratio)


def test_boxes_nms_and_uncrop_match_jax():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 80, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (40, 2))], 1).astype(np.float32)
    scores = rng.random(40).astype(np.float32)
    cats = rng.integers(0, 3, 40)
    for thr in (0.3, 0.7):
        assert np.array_equal(P.box_nms(boxes, scores, thr), J.box_nms(boxes, scores, thr))
        assert np.array_equal(P.batched_nms(boxes, scores, cats, thr),
                              J.batched_nms(boxes, scores, cats, thr))
    crop = [10, 20, 90, 100]
    assert np.array_equal(P.touches_crop_edge(boxes, crop, [0, 0, 120, 140]),
                          J.touches_crop_edge(boxes, crop, [0, 0, 120, 140]))
    assert np.array_equal(P.shift_boxes(boxes, crop), J.shift_boxes(boxes, crop))
    assert np.array_equal(P.shift_points(boxes[:, :2], crop), J.shift_points(boxes[:, :2], crop))
    assert np.array_equal(P.box_xyxy_to_xywh(boxes[0]), J.box_xyxy_to_xywh(boxes[0]))
    masks = _masks(4, h=80, w=80)
    assert np.array_equal(P.uncrop_masks(masks, crop, 140, 120), J.uncrop_masks(masks, crop,
                                                                                  140, 120))


@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_jax(mode):
    """scipy.ndimage.label at 8-connectivity against JAX's
    cv2.connectedComponentsWithStats: the same mask and the same flag."""
    for seed in range(6):
        mask = _masks(seed, n=2, h=48, w=64, p=0.55 + 0.05 * (seed % 3))[1]
        for area in (2, 8, 40, 4000):
            ours = P.remove_small_regions(mask, area, mode)
            theirs = J.remove_small_regions(mask, area, mode)
            assert ours[1] == theirs[1] and np.array_equal(ours[0], theirs[0]), (seed, area)


# random weights give near-duplicate masks: the NMS thresholds are raised so
# that more than one record survives
AMG_ARGS = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
                stability_score_thresh=0.0, crop_n_layers=1, min_mask_region_area=20,
                box_nms_thresh=0.95, crop_nms_thresh=0.95)


def _image():
    rng = np.random.default_rng(0)
    image = (np.kron(rng.random((6, 8, 3)), np.ones((16, 16, 1))) * 255).astype(np.uint8)
    image[30:70, 40:90] = (230, 200, 40)
    return image


@pytest.fixture(scope="module")
def jax_records(tiny128_cfg, tiny128_params):
    return JaxAMG(JaxSAM2Model(tiny128_params, tiny128_cfg), **AMG_ARGS).generate(_image())


def test_generator_matches_jax(tiny128_cfg, tiny128_params, jax_records):
    import sam2_opt_tpu_torch

    sd = state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    model = build_sam2(cfg=tiny128_cfg, state_dict=sd, device="cpu")
    amg = sam2_opt_tpu_torch.SAM2AutomaticMaskGenerator(model, **AMG_ARGS)
    ours = amg.generate(_image())
    assert len(jax_records) >= 3 and len(ours) == len(jax_records)
    for a, b in zip(ours, jax_records):
        assert a["segmentation"].shape == b["segmentation"].shape == _image().shape[:2]
        inter = np.logical_and(a["segmentation"], b["segmentation"]).sum()
        union = np.logical_or(a["segmentation"], b["segmentation"]).sum()
        assert union == 0 or inter / union >= 0.99
        assert a["crop_box"] == b["crop_box"] and a["point_coords"] == b["point_coords"]
        assert abs(a["predicted_iou"] - b["predicted_iou"]) < 1e-3
        assert abs(a["stability_score"] - b["stability_score"]) < 1e-3
        assert np.abs(np.asarray(a["bbox"]) - np.asarray(b["bbox"])).max() <= 1
    rle = port_amg.SAM2AutomaticMaskGenerator(model, output_mode="coco_rle", **AMG_ARGS)
    assert [r["segmentation"] for r in rle.generate(_image())] == [
        P.coco_encode_rle(P.mask_to_rle(a["segmentation"][None])[0]) for a in ours]
