"""The port's trainer end to end on the CPU (tiny config: hiera_t at 128 px),
the counterpart of `tests/test_training.py`'s trainer tests:

- the CLI (`python -m sam2_opt_tpu_torch.training.train --device cpu`) runs
  2 steps on a PNG folder, checkpoints, and a fresh trainer resumes;
- bf16 compute keeps fp32 master weights, moves them, and its loss is
  within 10% of fp32's on the same data;
- `grad_accum_steps=2` equals the full batch (loss 1e-5 relative, updated
  parameters 2e-4 relative + 1e-7, as the JAX test holds it);
- the remat modes recompute without changing the step (clicks on, so a
  recomputed frame must draw the same clicks): loss 1e-5, parameters as
  above;
- a frozen image encoder does not move while the rest does;
- a mesh, `comms_dtype` and `--dp` raise.
"""

import numpy as np
import pytest
import torch

from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.training.optimizer import build_optimizer
from sam2_opt_tpu_torch.training.trainer import TrainConfig, Trainer, build_train_step
from test_training import _make_davis_dataset

torch.set_num_threads(2)

S, T = 128, 2


@pytest.fixture(scope="module")
def cfg():
    return model_config("hiera_t", image_size=S)


def model(cfg, seed=0):
    """Random weights with the object-score head's last bias raised by 10:
    random weights score objects near 0, where bf16 rounding flips them
    between present and absent (absent replaces every logit by -1024)."""
    m = build_sam2("hiera_t", cfg=cfg, seed=seed, device="cpu").module
    with torch.no_grad():
        m.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += 10.0
    return m


def batch(B, seed):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((B, T, S, S, 3)).astype(np.float32))
    masks = torch.zeros(B, T, 1, S, S, dtype=torch.bool)
    masks[:, :, :, 20:80, 50:110] = True
    return images, masks, torch.ones(B, 1, dtype=torch.bool)


def one_step(cfg, tcfg, data, seed=0, **kwargs):
    """(loss, {name: updated parameter}) of one step from seed-0 weights."""
    m = model(cfg)
    opt = build_optimizer(dict(m.named_parameters()), trunk_depth=cfg.trunk.depth)
    step = build_train_step(cfg, tcfg, opt, **kwargs)
    _, metrics = step(m, opt.init(dict(m.named_parameters())), *data,
                      torch.Generator().manual_seed(seed), 1e-4)
    return float(metrics["loss"]), {n: p.detach().clone() for n, p in m.named_parameters()}


def assert_same_step(a, b):
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5)
    for name in a[1]:
        np.testing.assert_allclose(a[1][name].numpy(), b[1][name].numpy(), rtol=2e-4, atol=1e-7,
                                   err_msg=name)


def test_cli_trains_checkpoints_and_resumes(tmp_path, cfg):
    from sam2_opt_tpu_torch.training.train import main

    img_root, gt_root = _make_davis_dataset(tmp_path, num_videos=2, num_frames=3, size=S)
    ckpt = tmp_path / "ckpt"
    trainer = main(["--img_folder", img_root, "--gt_folder", gt_root, "--variant", "hiera_t",
                    "--image-size", str(S), "--num-epochs", "1", "--num-frames", "2",
                    "--max-objects", "1", "--checkpoint-dir", str(ckpt),
                    "--log-dir", str(tmp_path / "logs"), "--device", "cpu"])
    assert trainer.steps == 2 and len(trainer.step_losses) == 2
    assert all(np.isfinite(trainer.step_losses))
    assert trainer.ckpt.latest_step() == 2
    assert trainer.device.type == "cpu"

    fresh = Trainer(cfg, model(cfg, seed=1),
                    TrainConfig(checkpoint_dir=str(ckpt), log_dir=str(tmp_path / "logs2")))
    assert fresh.load_checkpoint()
    assert fresh.steps == 2 and fresh.epoch == 1 and fresh.opt_state["count"] == 2
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_bf16_keeps_fp32_masters_and_tracks_fp32_loss(cfg):
    data = batch(2, 17)
    before = {n: p.detach().clone() for n, p in model(cfg).named_parameters()}
    out = {dt: one_step(cfg, TrainConfig(batch_size=2, num_frames=T, compute_dtype=dt), data)
           for dt in ("float32", "bfloat16")}
    l32, l16 = out["float32"][0], out["bfloat16"][0]
    assert np.isfinite(l16) and abs(l16 - l32) / abs(l32) < 0.1, (l16, l32)
    moved = False
    for name, p in out["bfloat16"][1].items():
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all()), name
        moved = moved or not torch.equal(p, before[name])
    assert moved, "the bf16 step did not update the parameters"


def test_grad_accum_matches_full_batch(cfg):
    data = batch(4, 11)
    full, accum = (one_step(cfg, TrainConfig(batch_size=4, num_frames=T, num_correction_clicks=0,
                                             grad_accum_steps=a, remat="none"), data,
                            use_mask=True) for a in (1, 2))
    assert_same_step(full, accum)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        one_step(cfg, TrainConfig(batch_size=3, grad_accum_steps=2), batch(3, 1), use_mask=True)


@pytest.mark.parametrize("remat", ["encoder", "blocks", "blocks_frames"])
def test_remat_modes_match_no_remat(cfg, remat):
    data = batch(1, 13)
    kwargs = dict(correct_frames=(1,))
    ref = one_step(cfg, TrainConfig(num_frames=T, remat="none"), data, **kwargs)
    assert_same_step(ref, one_step(cfg, TrainConfig(num_frames=T, remat=remat), data, **kwargs))


def test_frozen_encoder_stays_put(cfg):
    data = batch(1, 19)
    before = {n: p.detach().clone() for n, p in model(cfg).named_parameters()}
    _, after = one_step(cfg, TrainConfig(freeze_image_encoder=True), data, use_mask=True)
    moved = [n for n, p in after.items() if not torch.equal(p, before[n])]
    assert moved and not any(n.startswith("image_encoder") for n in moved)


def test_training_after_inference_mode(cfg):
    """The shape constants cached while a predictor runs under inference mode
    (RoPE tables, sine encodings) serve a later training step."""
    from sam2_opt_tpu_torch.models import memory_attention, memory_encoder, video_core
    from sam2_opt_tpu_torch.training.sam2_train import video_train_loss

    for cached in (memory_attention._rope_half_tables, memory_encoder._sine_pe,
                   video_core._sine_tokens):
        cached.cache_clear()
    m = model(cfg)
    images, masks, _ = batch(1, 23)
    kwargs = dict(use_mask_input=True, num_correction_clicks=0)
    with torch.inference_mode():
        video_train_loss(m, cfg, images[0], masks[0], torch.Generator(), **kwargs)
    loss, _ = video_train_loss(m, cfg, images[0], masks[0], torch.Generator(), **kwargs)
    loss.backward()
    assert m.memory_attention.layers[0].self_attn.q_proj.weight.grad.abs().max() > 0


def test_parallel_options_raise(cfg, tmp_path):
    from sam2_opt_tpu_torch.training.train import main

    opt = build_optimizer(dict(model(cfg).named_parameters()), trunk_depth=cfg.trunk.depth)
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        build_train_step(cfg, TrainConfig(comms_dtype="bfloat16"), opt)
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        build_train_step(cfg, TrainConfig(), opt, mesh=object())
    with pytest.raises(NotImplementedError, match="Queue A item 13"):
        main(["--img_folder", str(tmp_path), "--gt_folder", str(tmp_path), "--dp", "2",
              "--device", "cpu"])
