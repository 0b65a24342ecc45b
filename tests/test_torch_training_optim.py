"""The port's optimizer and data pipeline against the JAX package's.

- Optimizer: two updates from the same gradients, with layer-wise lr decay,
  the trunk lr scale and the weight-decay mask, against optax through the
  JAX `build_optimizer`; parameters and Adam moments elementwise within
  1e-6 relative (plus 1e-6 of the tensor's max |x|: the same fp32 formulas).
  The JAX tree holds `positional_encoding_gaussian_matrix` as a parameter
  (lr 0, no decay) whose gradient enters the global clip norm; in the port,
  as in the reference, it is a buffer. Its JAX gradient is zeroed here
  before optax sees it.
- Schedules, layer ids, lr scales and the decay mask: equal.
- Data: `VOSDataset` + `data_loader` yield batches byte-identical to the
  JAX ones on the same PNG folder and seed, augmentations on.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from sam2_opt_tpu.training import data as jax_data
from sam2_opt_tpu.training import optimizer as jax_opt
from sam2_opt_tpu.utils.misc import keystr_to_dotted
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.training import data
from sam2_opt_tpu_torch.training import optimizer as opt
from test_training import _make_davis_dataset

GAUSSIAN = "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"


def test_schedules_and_layer_ids_match_jax():
    for args in ((1.0, 0.1), (5e-6, 0.03, 5e-7)):
        a, b = opt.warmup_cosine_schedule(*args), jax_opt.warmup_cosine_schedule(*args)
        for where in (0.0, 0.01, 0.1, 0.5, 0.99):
            assert a(where) == b(where)
    for name in ("patch_embed.proj.weight", "pos_embed", "blocks.5.attn.qkv.weight",
                 "blocks.11.mlp.layers.0.bias", "rel_pos_h", "unknown.thing"):
        assert opt.hiera_layer_id(name, 12) == jax_opt.hiera_layer_id(name, 12)


def test_lr_scales_and_decay_mask_match_jax(tiny128_cfg, tiny128_params):
    params = state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    params.pop(GAUSSIAN)
    depth = tiny128_cfg.trunk.depth
    ref = jax_opt.build_optimizer(tiny128_params, trunk_depth=depth)
    got = opt.build_optimizer(params, trunk_depth=depth)
    flat = lambda tree: {keystr_to_dotted(jax.tree_util.keystr(p)): v  # noqa: E731
                         for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    ref_scales = flat(ref.lr_scales)
    assert ref_scales.pop(GAUSSIAN) == 0.0
    assert got.lr_scales == ref_scales
    ref_mask = flat(jax_opt.default_weight_decay_mask(tiny128_params))
    assert ref_mask.pop(GAUSSIAN) is False
    assert got.decay_mask == ref_mask
    assert got.lr_scales["image_encoder.trunk.pos_embed"] == pytest.approx(0.6)
    assert got.lr_scales["sam_mask_decoder.iou_token.weight"] == 1.0


def _adam_moments(state):
    return next(s for s in state if hasattr(s, "mu"))


def test_optimizer_matches_optax(tiny128_cfg, tiny128_params):
    depth = tiny128_cfg.trunk.depth
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32), tiny128_params)
    grads["sam_prompt_encoder"]["pe_layer"]["positional_encoding_gaussian_matrix"][...] = 0.0
    lr = 1e-3

    tx = jax_opt.build_optimizer(tiny128_params, trunk_depth=depth)
    params, state = tiny128_params, tx.init(tiny128_params)

    @jax.jit
    def update(params, state):
        updates, state = tx.update(grads, state, params, lr)
        return optax.apply_updates(params, updates), state

    for _ in range(2):
        params, state = update(params, state)

    to_port = lambda tree: state_dict_from_params(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    port_params = to_port(tiny128_params)
    port_grads = to_port(grads)
    for d in (port_params, port_grads):
        d.pop(GAUSSIAN)
    tx2 = opt.build_optimizer(port_params, trunk_depth=depth)
    state2 = tx2.init(port_params)
    for _ in range(2):
        updates2, state2 = tx2.update(port_grads, state2, port_params, lr)
        port_params = {n: p + updates2[n] for n, p in port_params.items()}
    assert state2["count"] == 2

    moments = _adam_moments(state)
    for want, got in ((to_port(params), port_params), (to_port(moments.mu), state2["mu"]),
                      (to_port(moments.nu), state2["nu"])):
        for name, value in got.items():
            w = want[name].numpy()
            np.testing.assert_allclose(value.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(), err_msg=name)
    moved = port_params["image_encoder.trunk.blocks.0.attn.qkv.weight"]
    assert not torch.equal(moved, to_port(tiny128_params)["image_encoder.trunk.blocks.0.attn.qkv.weight"])


@pytest.mark.parametrize("epoch", [0, 1])
def test_data_batches_are_byte_identical_to_jax(tmp_path, epoch):
    img_root, gt_root = _make_davis_dataset(tmp_path, num_videos=3, num_frames=4, size=64)

    def batches(pkg):
        ds = pkg.VOSDataset(pkg.PNGRawDataset(img_root, gt_root),
                            pkg.RandomUniformSampler(num_frames=3, max_num_objects=2),
                            image_size=64, max_num_objects=2, seed=5)
        ds.set_epoch(epoch)
        out = list(pkg.data_loader(ds, batch_size=2, seed=3 + epoch, drop_last=False))
        evals = pkg.VOSDataset(pkg.PNGRawDataset(img_root, gt_root), pkg.EvalSampler(),
                               image_size=48, max_num_objects=2, hflip_prob=0.0)
        return out + list(pkg.data_loader(evals, 1, shuffle=False, drop_last=False))

    got, want = batches(data), batches(jax_data)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape
            assert g[key].tobytes() == w[key].tobytes(), key
