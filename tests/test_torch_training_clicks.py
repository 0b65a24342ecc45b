"""The port's training rollout against the JAX package's with clicks, fp32
on the CPU: configuration (b), a point prompt on the initial frame and one
correction click on it and on tracked frame 2 (3 frames, 2 objects, the
weights of `test_torch_training_rollout.py`).

The two packages draw their clicks from different generators, so both
samplers are replaced here by one deterministic pick: the argmax, over the
sampler's own pool (the error region, or the background where the
prediction is exact), of a fixed noise drawn from a numpy seed. The JAX
source is untouched. Tolerances as in `test_torch_training_rollout.py`.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_opt_tpu.training import sam2_train as jax_train
from sam2_opt_tpu_torch.training import sam2_train
from test_torch_training_rollout import N_OBJ, S, assert_grads, assert_loss_and_aux, run_both

torch.set_num_threads(2)

NOISE = np.random.default_rng(5).random((N_OBJ, S * S)).astype(np.float32)


def _pool(gt, pred, xp):
    B = gt.shape[0]
    fn = gt & ~pred
    error = (~gt & pred) | fn
    any_error = error.reshape(B, -1).any(-1)
    return xp.where(any_error[:, None], error.reshape(B, -1), ~gt.reshape(B, -1)), fn.reshape(B, -1)


def jax_pick(rng, gt_masks, pred_masks, num_pts=1):
    pool, fn = _pool(gt_masks[:, 0], pred_masks[:, 0], jnp)
    idx = jnp.argmax(jnp.where(pool, NOISE[:pool.shape[0]], -1.0), -1)
    coords = jnp.stack([idx % S, idx // S], -1).astype(jnp.float32)[:, None]
    return coords, jnp.take_along_axis(fn, idx[:, None], 1).astype(jnp.int32)


def port_pick(u, gt_masks, pred_masks):
    pool, fn = _pool(gt_masks[:, 0], pred_masks[:, 0], torch)
    idx = torch.where(pool, torch.from_numpy(NOISE[:pool.shape[0]]), -1.0).argmax(-1)
    coords = torch.stack([idx % S, idx // S], -1).float()[:, None]
    return coords, fn.gather(1, idx[:, None]).int()


@contextlib.contextmanager
def patched_samplers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, "sample_random_points_from_errors", jax_pick)
        mp.setattr(sam2_train, "sample_random_points_from_errors", port_pick)
        yield


@pytest.fixture(scope="module")
def clicks(tiny128_cfg, tiny128_params):
    with patched_samplers():
        return run_both(tiny128_cfg, tiny128_params, use_mask_input=False, use_box_input=False,
                        num_correction_clicks=1, frames_to_add_correction_pt=(2,))


def test_click_rollout_loss_matches_jax(clicks):
    ref, got = clicks
    assert_loss_and_aux(ref, got)


def test_click_rollout_grads_match_jax(clicks):
    ref, got = clicks
    worst = assert_grads(ref, got)
    print(f"worst gradient error / max|g|: {worst:.2e}")
    # the point prompt reaches the prompt encoder's point embeddings
    assert got[2]["sam_prompt_encoder.point_embeddings.1.weight"].abs().max() > 0


def test_port_sampler_draws_uniformly_from_the_pool():
    """The port's own sampler: u picks the pool pixels in raster order, FN
    clicks are positive, and an exact prediction gives a negative background
    click."""
    gt = torch.zeros(2, 1, 8, 8, dtype=torch.bool)
    gt[:, :, 2:4, 2:4] = True
    pred = gt.clone()
    pred[0, 0, 2, 2] = False  # one FN pixel in row 0; row 1 is exact
    u = torch.tensor([[0.0, 0.99], [0.0, 0.99]])
    coords, labels = sam2_train.sample_random_points_from_errors(u, gt, pred)
    assert coords[0].tolist() == [[2.0, 2.0], [2.0, 2.0]] and labels[0].tolist() == [1, 1]
    assert coords[1].tolist() == [[0.0, 0.0], [7.0, 7.0]] and labels[1].tolist() == [0, 0]
    box, box_labels = sam2_train.sample_box_points(torch.zeros(2, 4), gt)
    assert box[0].tolist() == [[2.0, 2.0], [3.0, 3.0]] and box_labels[0].tolist() == [2, 3]
