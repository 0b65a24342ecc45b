"""The slice end to end: the port's SAM2ImagePredictor against the JAX
package's, on the same weights (JAX `tiny128_params` through the weight
bridge) and the same 128² structured image, at fp32 on the CPU.

Tolerances: low-res logits atol 1e-3 and IoUs atol 1e-4 (after the 12-block
trunk and the two-way decoder both frameworks sum in different orders; the
module tests hold features to 1e-4); binary masks equal except where the
JAX logit is within 1e-3 of the threshold. The bf16 gate mirrors
tests/test_accuracy_gate.py: mask mIoU > 0.97 and IoUs within 0.05 of fp32.
"""

import jax
import numpy as np
import pytest
import torch

from sam2_opt_tpu.models.model import SAM2Model as JaxSAM2Model
from sam2_opt_tpu.predictors.image import SAM2ImagePredictor as JaxPredictor
from sam2_opt_tpu.utils.transforms import SAM2Transforms as JaxTransforms
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor
from sam2_opt_tpu_torch.utils.transforms import SAM2Transforms

torch.set_num_threads(2)

PROMPTS = {
    "point": dict(point_coords=np.array([[64, 64]], np.float32), point_labels=np.array([1])),
    "box": dict(box=np.array([20, 24, 100, 110], np.float32)),
    "points+box": dict(point_coords=np.array([[60, 70], [30, 90]], np.float32),
                       point_labels=np.array([1, 0]), box=np.array([10, 20, 110, 120], np.float32)),
}


def _image():
    rng = np.random.default_rng(0)
    return (np.kron(rng.random((8, 8, 3)), np.ones((16, 16, 1))) * 255).astype(np.uint8)


def _miou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


@pytest.fixture(scope="module")
def predictors(tiny128_cfg, tiny128_params):
    jax_pred = JaxPredictor(JaxSAM2Model(tiny128_params, tiny128_cfg))
    sd = state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    port_pred = SAM2ImagePredictor(build_sam2(cfg=tiny128_cfg, state_dict=sd, device="cpu"))
    image = _image()
    jax_pred.set_image(image)
    port_pred.set_image(image)
    return jax_pred, port_pred


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_predict_matches_jax(predictors, prompt, multimask):
    jax_pred, port_pred = predictors
    logits, ref_ious, ref_low = jax_pred.predict(**PROMPTS[prompt], multimask_output=multimask,
                                                 return_logits=True)
    masks, ious, low = port_pred.predict(**PROMPTS[prompt], multimask_output=multimask)
    logits = np.asarray(logits)
    assert masks.shape == logits.shape and masks.dtype == bool
    np.testing.assert_allclose(low, np.asarray(ref_low), rtol=0, atol=1e-3)
    np.testing.assert_allclose(ious, np.asarray(ref_ious), rtol=0, atol=1e-4)
    agree = (masks == (logits > 0.0)) | (np.abs(logits) < 1e-3)
    assert agree.all(), f"{(~agree).sum()} mask pixels differ away from the threshold"


@pytest.mark.parametrize("prompt", ["point", "box"])
def test_predict_with_hole_filling_matches_jax(predictors, prompt):
    """max_hole_area=8 and max_sprinkle_area=8 on both predictors: the masks
    are postprocessed from the low-res logits (held at 1e-3 above) with exact
    connected components, so they agree except within 1e-3 of the threshold."""
    jax_pred, port_pred = predictors
    for pred in predictors:
        pred.max_hole_area = pred.max_sprinkle_area = 8.0
    try:
        logits, _, _ = jax_pred.predict(**PROMPTS[prompt], return_logits=True)
        filled, _, _ = port_pred.predict(**PROMPTS[prompt], return_logits=True)
        masks, _, _ = port_pred.predict(**PROMPTS[prompt])
    finally:
        for pred in predictors:
            pred.max_hole_area = pred.max_sprinkle_area = 0.0
    plain, _, _ = port_pred.predict(**PROMPTS[prompt], return_logits=True)
    logits = np.asarray(logits)
    np.testing.assert_allclose(filled, logits, rtol=0, atol=1e-3)
    assert (filled != plain).any(), "nothing was filled"
    agree = (masks == (logits > 0.0)) | (np.abs(logits) < 1e-3)
    assert agree.all(), f"{(~agree).sum()} mask pixels differ away from the threshold"


def test_bf16_speedup_mask_miou(tiny128_cfg, tiny128_params):
    sd = state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    predictor = SAM2ImagePredictor(build_sam2(cfg=tiny128_cfg, state_dict=sd, device="cpu"))
    image, prompt = _image(), PROMPTS["point"]
    predictor.set_image(image)
    masks_fp32, ious_fp32, _ = predictor.predict(**prompt)
    predictor.speedup()
    assert predictor.model.compute_dtype == torch.bfloat16
    predictor.set_image(image)
    masks_bf16, ious_bf16, _ = predictor.predict(**prompt)
    ious = [_miou(a, b) for a, b in zip(masks_fp32, masks_bf16) if a.sum() + b.sum() > 0]
    assert ious, "degenerate: all masks empty"
    assert min(ious) > 0.97, ious
    assert np.abs(ious_fp32 - ious_bf16).max() < 0.05


def test_transforms_match_jax():
    """SAM2Transforms (the reference's helper API) against the JAX package's:
    image to normalized model input, prompt coordinates and boxes, mask
    postprocessing, without and with hole and sprinkle filling; 1e-5, single
    resize ops summed in different orders.
    The port's images are CHW, the JAX package's HWC."""
    rng = np.random.default_rng(7)
    image = (rng.random((100, 150, 3)) * 255).astype(np.uint8)
    jax_t, port_t = JaxTransforms(128, 0.0), SAM2Transforms(128, 0.0, device="cpu")
    np.testing.assert_allclose(port_t(image).permute(1, 2, 0).numpy(), np.asarray(jax_t(image)),
                               rtol=1e-5, atol=1e-5)
    coords, box = np.array([[10.0, 20.0], [140.0, 90.0]]), np.array([5.0, 6.0, 120.0, 80.0])
    for normalize in (False, True):
        np.testing.assert_allclose(
            port_t.transform_coords(coords, normalize, (100, 150)).numpy(),
            np.asarray(jax_t.transform_coords(coords, normalize, (100, 150))), rtol=1e-6)
        np.testing.assert_allclose(
            port_t.transform_boxes(box, normalize, (100, 150)).numpy(),
            np.asarray(jax_t.transform_boxes(box, normalize, (100, 150))), rtol=1e-6)
    masks = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(port_t.postprocess_masks(masks, (100, 150)).numpy(),
                               np.asarray(jax_t.postprocess_masks(masks, (100, 150))),
                               rtol=1e-5, atol=1e-5)
    # hole and sprinkle filling before the resize: exact components
    jax_t, port_t = JaxTransforms(128, 0.0, 8.0, 8.0), SAM2Transforms(128, 0.0, 8.0, 8.0, device="cpu")
    np.testing.assert_allclose(port_t.postprocess_masks(masks, (100, 150)).numpy(),
                               np.asarray(jax_t.postprocess_masks(masks, (100, 150))),
                               rtol=1e-5, atol=1e-5)


def test_unported_options_raise(predictors, tiny128_cfg):
    _, port_pred = predictors
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_pred.model.speedup("int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SAM2VideoPredictor(port_pred.model).init_state(_image()[None], async_loading_frames=True)
    with pytest.raises(ValueError):  # bf16 on "cuda" is the one reduced precision
        port_pred.speedup("tensorrt")
    with pytest.raises(TypeError):
        port_pred.speedup(dtype=torch.float16)
    with pytest.raises(TypeError):
        SAM2ImagePredictor(port_pred.model, model_root_path="models")
    assert port_pred.model.compute_dtype == torch.float32
