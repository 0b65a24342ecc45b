"""The port's training rollout against the JAX package's, fp32 on the CPU.

Both packages run the same weights (the JAX `tiny128_params` through the
weight bridge: hiera_t at 128 px) over the same 3-frame, 2-object video.
This file: configuration (a), the GT mask as the initial prompt and no
correction clicks, which draws no random number. The JAX loss and its
gradient come from one `jax.jit(jax.value_and_grad(...))`; the JAX gradients
are mapped to the port's names and layouts with `state_dict_from_params`
(`positional_encoding_gaussian_matrix`, a buffer in the port, is left out).
Tolerances: the loss within 1e-5 relative, each aux term within 1e-5
relative (plus 1e-6), each parameter's gradient within 1e-3 of its own max
|g| (3 frames of rollout, 4 attention layers each, summed in different
orders) plus 1e-9 of the model's largest gradient: the mask decoder's
k-projection biases have a zero gradient in exact arithmetic (softmax is
shift-invariant) and its other attention projections here gradients 1e7
times below the largest, so both sides hold rounding noise there (measured:
up to 1.4 times the tensor's own max |g|, 1.7e-9 absolute, against a largest
gradient of 23.8; every other tensor within 1.1e-5 of its own max |g|).
The losses alone are held to 1e-6 on random logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam2_opt_tpu.training import losses as jax_losses
from sam2_opt_tpu.training import sam2_train as jax_train
from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.training import losses as L
from sam2_opt_tpu_torch.training import sam2_train

torch.set_num_threads(2)

T, N_OBJ, S = 3, 2, 128
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3  # of each gradient's own max |g|
GRAD_FLOOR = 1e-9  # of the model's largest gradient
BUFFERS = ("sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",)


def video():
    """[T, S, S, 3] frames in [0, 1] and [T, 2, S, S] masks: two textured
    squares moving over a textured background."""
    rng = np.random.default_rng(21)
    bg = np.kron(rng.random((S // 16, S // 16, 3)), np.ones((16, 16, 1)))
    frames = np.repeat(bg[None], T, 0).astype(np.float32)
    masks = np.zeros((T, N_OBJ, S, S), bool)
    for t in range(T):
        for j, (y, x, size) in enumerate(((20 + 4 * t, 30 + 6 * t, 48), (70, 80 - 5 * t, 32))):
            frames[t, y:y + size, x:x + size] = rng.random(3) * 0.5 + 0.5
            masks[t, j, y:y + size, x:x + size] = True
    return frames, masks


def port_module(tiny128_params):
    module = base.SAM2Base(model_config("hiera_t", image_size=S))
    module.load_state_dict(
        state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params)), strict=True)
    # raise the object-score head's last bias (in both packages' weights),
    # so tracked objects score present and the mask losses carry gradient
    with torch.no_grad():
        module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    return module


def jax_params(tiny128_params):
    params = jax.tree_util.tree_map(jnp.asarray, tiny128_params)
    head = params["sam_mask_decoder"]["pred_obj_score_head"]["layers"][2]
    return {**params, "sam_mask_decoder": {
        **params["sam_mask_decoder"], "pred_obj_score_head": {
            **params["sam_mask_decoder"]["pred_obj_score_head"],
            "layers": {**params["sam_mask_decoder"]["pred_obj_score_head"]["layers"],
                       2: {**head, "bias": head["bias"] + 10.0}}}}}


def run_both(tiny128_cfg, tiny128_params, **kwargs):
    """(JAX (loss, aux, grads as a state dict), port (loss, aux, grads))."""
    frames, masks = video()
    params = jax_params(tiny128_params)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jax_train.video_train_loss(p, tiny128_cfg, jnp.asarray(frames),
                                             jnp.asarray(masks), jax.random.PRNGKey(0),
                                             use_remat=False, **kwargs), has_aux=True))
    (loss, aux), grads = fn(params)
    ref = (float(loss), {k: float(v) for k, v in aux.items()},
           state_dict_from_params(jax.tree_util.tree_map(np.asarray, grads)))
    return ref, run_port(tiny128_params, **kwargs)


def run_port(tiny128_params, **kwargs):
    """The port's (loss, aux, grads) of the rollout."""
    frames, masks = video()
    module = port_module(tiny128_params)
    cfg = model_config("hiera_t", image_size=S)
    loss, aux = sam2_train.video_train_loss(module, cfg, torch.from_numpy(frames),
                                            torch.from_numpy(masks), torch.Generator(),
                                            use_remat=False, **kwargs)
    loss.backward()
    grads = {n: p.grad for n, p in module.named_parameters()}
    return loss.item(), {k: v.item() for k, v in aux.items()}, grads


def assert_loss_and_aux(ref, got):
    assert abs(got[0] - ref[0]) <= LOSS_RTOL * abs(ref[0]), (got[0], ref[0])
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        assert abs(got[1][k] - ref[1][k]) <= LOSS_RTOL * abs(ref[1][k]) + 1e-6, k


def assert_grads(ref, got):
    """Every parameter's gradient; returns the worst error / max |g| among
    the tensors whose max |g| is at least 1e-6 of the model's largest."""
    assert sorted(got[2]) == sorted(n for n in ref[2] if n not in BUFFERS)
    worst, bad = 0.0, []
    floor = GRAD_FLOOR * max(np.abs(g.numpy()).max() for g in ref[2].values())
    for name, g in got[2].items():
        want = ref[2][name].numpy()
        have = np.zeros_like(want) if g is None else g.numpy()
        scale = np.abs(want).max()
        err = np.abs(have - want).max()
        if err > GRAD_TOL * scale + floor:
            bad.append((name, float(err), float(scale)))
        if scale >= 1e3 * floor:
            worst = max(worst, err / scale)
    assert not bad, bad
    return worst


@pytest.fixture(scope="module")
def mask_input(tiny128_cfg, tiny128_params):
    return run_both(tiny128_cfg, tiny128_params, use_mask_input=True, num_correction_clicks=0)


def test_mask_input_rollout_loss_matches_jax(mask_input):
    ref, got = mask_input
    assert_loss_and_aux(ref, got)
    assert got[1]["loss_mask"] > 0  # the tracked frames' mask losses are live


def test_mask_input_rollout_grads_match_jax(mask_input):
    ref, got = mask_input
    worst = assert_grads(ref, got)
    print(f"worst gradient error / max|g|: {worst:.2e}")
    # memory attention's q/k projections are on the gradient path
    for layer in (0, 3):
        for attn in ("self_attn", "cross_attn_image"):
            assert got[2][f"memory_attention.layers.{layer}.{attn}.q_proj.weight"].abs().max() > 0


def test_mask_input_rollout_flash_routes_matches_jax(mask_input, tiny128_params, monkeypatch):
    """The port's rollout under `SAM2_TPU_FLASH=1`, the card's default
    memory attention routes on CPU tensors: self- and cross-attention (over
    memory frames and object pointers) run K2's plain version, a spy sees
    both in every layer of every tracked frame, and loss and gradients
    match the same JAX result at the tolerances above."""
    import sam2_opt_tpu_torch.models.memory_attention as ma

    calls = {"self": 0, "cross": 0}
    rope_ref = ma.flash_attention_rope_ref

    def spy(q, k, *a):
        calls["cross" if k.shape[-2] > q.shape[-2] else "self"] += 1
        return rope_ref(q, k, *a)

    monkeypatch.setattr(ma, "flash_attention_rope_ref", spy)
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    ref, _ = mask_input
    got = run_port(tiny128_params, use_mask_input=True, num_correction_clicks=0)
    assert calls == {"self": 4 * (T - 1), "cross": 4 * (T - 1)}, calls  # 4 layers a frame
    assert_loss_and_aux(ref, got)
    assert_grads(ref, got)


def test_mask_input_rollout_fused_kv_proj_matches_jax(mask_input, tiny128_params, monkeypatch):
    """The port's rollout under `SAM2_TPU_FUSED_KV_PROJ=1`, where memory
    attention's cross-attention runs K4's plain version (on the card, K4 and
    its backward), against the same JAX result (the JAX package takes its
    unfused path on the CPU either way): loss and gradients at the
    tolerances above; the cross-attention's k/v projections, now inside K4,
    get a nonzero gradient. The port's side sets `SAM2_TPU_FLASH=1`, which
    puts the kernel routes (their plain versions) on CPU tensors."""
    import sam2_opt_tpu_torch.models.memory_attention as ma

    calls = []
    kv_ref = ma.flash_attention_kv_proj_ref
    monkeypatch.setattr(ma, "flash_attention_kv_proj_ref", lambda *a: calls.append(1) or kv_ref(*a))
    monkeypatch.setenv("SAM2_TPU_FUSED_KV_PROJ", "1")
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    ref, _ = mask_input
    got = run_port(tiny128_params, use_mask_input=True, num_correction_clicks=0)
    assert len(calls) == 4 * (T - 1)  # 4 layers per tracked frame
    assert_loss_and_aux(ref, got)
    assert_grads(ref, got)
    for layer in (0, 3):
        for proj in ("k_proj", "v_proj"):
            assert got[2][f"memory_attention.layers.{layer}.cross_attn_image.{proj}.weight"].abs().max() > 0


def test_mask_input_rollout_rope_off_matches_jax(mask_input, tiny128_params, monkeypatch):
    """The port's rollout under `SAM2_TPU_FUSED_ROPE=0` with
    `SAM2_TPU_FLASH=1`: memory attention rotates K in torch and runs K1's
    plain version at D = 256 (on the card, K1 forward and K3 backward) in
    place of K2's; a spy sees it in the self- and the cross-attention of
    every layer of every tracked frame, and loss and gradients match the
    same JAX result at the tolerances above."""
    import sam2_opt_tpu_torch.models.memory_attention as ma

    calls = {"self": 0, "cross": 0}
    k1_ref = ma.flash_attention_ref

    def spy(q, k, *a):
        assert q.shape[-1] == 256
        calls["cross" if k.shape[-2] > q.shape[-2] else "self"] += 1
        return k1_ref(q, k, *a)

    def no_rope(*a):
        raise AssertionError("K2's route runs under SAM2_TPU_FUSED_ROPE=0")

    monkeypatch.setattr(ma, "flash_attention_ref", spy)
    monkeypatch.setattr(ma, "flash_attention_rope_ref", no_rope)
    monkeypatch.setenv("SAM2_TPU_FUSED_ROPE", "0")
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    ref, _ = mask_input
    got = run_port(tiny128_params, use_mask_input=True, num_correction_clicks=0)
    assert calls == {"self": 4 * (T - 1), "cross": 4 * (T - 1)}, calls  # 4 layers a frame
    assert_loss_and_aux(ref, got)
    assert_grads(ref, got)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    masks = [rng.standard_normal((3, 3, 32, 32)).astype(np.float32) * 4 for _ in range(2)]
    ious = [rng.random((3, 3)).astype(np.float32) for _ in range(2)]
    scores = [rng.standard_normal((3, 1)).astype(np.float32) for _ in range(2)]
    target = rng.random((3, 1, 32, 32)) > 0.5
    target[2] = False  # an absent object
    valid = np.array([True, True, False])
    for obj_valid in (None, valid):
        ref = jax_losses.multistep_multimasks_and_ious(
            [jnp.asarray(m) for m in masks], [jnp.asarray(i) for i in ious],
            [jnp.asarray(s) for s in scores], jnp.asarray(target), 2.0,
            obj_valid=None if obj_valid is None else jnp.asarray(obj_valid))
        got = L.multistep_multimasks_and_ious(
            [torch.from_numpy(m) for m in masks], [torch.from_numpy(i) for i in ious],
            [torch.from_numpy(s) for s in scores], torch.from_numpy(target), 2.0,
            obj_valid=None if obj_valid is None else torch.from_numpy(obj_valid))
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6, atol=1e-7)
    x = torch.from_numpy(masks[0])
    t = torch.from_numpy(target.astype(np.float32)).expand_as(x)
    np.testing.assert_allclose(
        L.dice_loss(x, t, 3.0).numpy(),
        np.asarray(jax_losses.dice_loss(jnp.asarray(masks[0]), jnp.asarray(t.numpy()), 3.0)),
        rtol=1e-6)
    np.testing.assert_allclose(
        L.sigmoid_focal_loss(x, t, 3.0).numpy(),
        np.asarray(jax_losses.sigmoid_focal_loss(jnp.asarray(masks[0]), jnp.asarray(t.numpy()),
                                                 3.0)), rtol=1e-6)
