"""The port's image fine-tune step (`training/step.py`) against the JAX
package's (`sam2_opt_tpu/training/step.py`), fp32 on the CPU, and under
data and tensor parallelism against one process.

Both packages run the `tiny128_params` (hiera_t at 128 px, the object-score
head's last bias raised by 10 so the masks carry gradient) on the same two
images and masks; JAX's loss and gradients come from one module-scoped
`jax.jit(jax.value_and_grad(forward_loss))`. Tolerances: the loss and its
parts within 1e-5 relative, every gradient within 1e-3 of the largest |g|;
`make_optimizer`'s update from the same gradients within 1e-6 of optax's
(relative, plus 1e-12); the centre clicks within 1e-5 pixels. The step under
dp 2 and dp 1 x tp 2 (gloo ranks, `tests/_torch_parallel_worker.py`): the
loss within 1e-5 relative, gradients within 1e-3 of the largest |g| and the
global norm within 1e-5 of one process's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as w
from sam2_opt_tpu.training import step as jax_step
from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.training import step as st
from test_torch_training_rollout import jax_params, port_module

torch.set_num_threads(2)

S, B = 128, 2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3  # of the largest |g|
BUFFERS = ("sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",)


def batch():
    rng = np.random.default_rng(31)
    images = rng.random((B, S, S, 3)).astype(np.float32)
    gt = np.zeros((B, 1, S, S), np.float32)
    gt[0, :, 20:84, 30:90] = 1
    gt[1, :, 64:120, 8:56] = 1
    return images, gt


@pytest.fixture(scope="module")
def jax_ref(tiny128_cfg, tiny128_params):
    """JAX's (loss, parts, gradients as a state dict, params)."""
    images, gt = batch()
    params = jax_params(tiny128_params)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jax_step.forward_loss(p, tiny128_cfg, jnp.asarray(images), jnp.asarray(gt)),
        has_aux=True))
    (loss, aux), grads = fn(params)
    return (float(loss), {k: float(aux[k]) for k in st.METRICS},
            jax.tree_util.tree_map(np.asarray, grads), params)


@pytest.fixture(scope="module")
def port_ref(tiny128_params):
    images, gt = batch()
    module = port_module(tiny128_params)
    loss, aux = st.forward_loss(module, model_config("hiera_t", image_size=S),
                                torch.from_numpy(images), torch.from_numpy(gt))
    loss.backward()
    return (loss.item(), {k: aux[k].item() for k in st.METRICS},
            {n: p.grad for n, p in module.named_parameters()})


def test_forward_loss_matches_jax(jax_ref, port_ref):
    assert abs(port_ref[0] - jax_ref[0]) <= LOSS_RTOL * abs(jax_ref[0])
    for k in st.METRICS:
        assert abs(port_ref[1][k] - jax_ref[1][k]) <= LOSS_RTOL * abs(jax_ref[1][k]) + 1e-7, k


def test_gradients_match_jax(jax_ref, port_ref):
    want = state_dict_from_params(jax_ref[2])
    got = port_ref[2]
    assert sorted(got) == sorted(n for n in want if n not in BUFFERS)
    gmax = max(g.abs().max().item() for g in want.values())
    for name, g in got.items():
        have = torch.zeros_like(want[name]) if g is None else g
        err = (have - want[name]).abs().max().item()
        assert err <= GRAD_TOL * gmax, (name, err, gmax)


def test_make_optimizer_matches_optax(jax_ref):
    """One update from the same gradients: the port's AdamW after clipping
    against optax.chain(clip_by_global_norm, adamw), both at their defaults
    (every parameter decays)."""
    _, _, grads, params = jax_ref
    # scale the gradients so the global norm exceeds the clip (0.1)
    grads = jax.tree_util.tree_map(lambda g: g * 10.0, grads)
    params = jax.tree_util.tree_map(np.asarray, params)
    # one flat leaf: the chain is elementwise after the global norm, so this
    # is the tree's update, compiled as one small graph
    leaves, treedef = jax.tree_util.tree_flatten(grads)

    def flat(tree):
        return np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(tree)])

    opt = jax_step.make_optimizer()
    out = np.asarray(jax.jit(lambda g, p: opt.update(g, opt.init(p), p)[0])(flat(grads),
                                                                             flat(params)))
    cuts = np.cumsum([x.size for x in leaves])[:-1]
    updates = jax.tree_util.tree_unflatten(
        treedef, [u.reshape(x.shape) for u, x in zip(np.split(out, cuts), leaves)])
    want = state_dict_from_params(jax.tree_util.tree_map(np.asarray, updates))
    names = [n for n in want if n not in BUFFERS]
    p_sd = state_dict_from_params(jax.tree_util.tree_map(np.asarray, params))
    g_sd = state_dict_from_params(grads)
    port = st.make_optimizer()
    # the JAX tree clips over its buffer's gradient too
    norm = torch.sqrt(sum((g_sd[n] ** 2).sum() for n in g_sd))
    got, _ = port.update({n: g_sd[n] for n in names}, port.init({n: p_sd[n] for n in names}),
                         {n: p_sd[n] for n in names}, port.lr_at(0.0), grad_norm=norm)
    assert norm > 0.1
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=1e-12,
                                   err_msg=n)


def test_sample_center_points_matches_jax():
    _, gt = batch()
    want_xy, want_labels = jax_step.sample_center_points(jnp.asarray(gt))
    xy, labels = st.sample_center_points(torch.from_numpy(gt))
    np.testing.assert_allclose(xy.numpy(), np.asarray(want_xy), atol=1e-5)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))


def test_step_updates_the_model():
    """One step with `make_optimizer` moves the fp32 parameters and counts."""
    cfg = w.tiny_cfg()
    model = w.tiny_model(cfg).module
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = st.make_optimizer()
    images, gt = (torch.from_numpy(a) for a in batch())
    state, metrics = st.make_train_step(cfg, opt)(st.init_train_state(model, opt), images, gt)
    assert state.step == 1 and state.opt_state["count"] == 1
    assert sorted(metrics) == sorted(("loss",) + st.METRICS)
    assert np.isfinite(float(metrics["loss"]))
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert moved and all(p.dtype == torch.float32 for p in model.parameters())


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    return w.launch(2, ["step_dp2", "step_tp2"], str(tmp_path_factory.mktemp("step")))


@pytest.mark.parametrize("job", ["step_dp2", "step_tp2"])
def test_step_layout_matches_one_process(layouts, job):
    want = w.image_step(None)
    gmax = max(g.abs().max().item() for g in want["grads"].values())
    for got in layouts[job]:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-5)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            assert (got["grads"][name] - g).abs().max().item() <= GRAD_TOL * gmax, name
