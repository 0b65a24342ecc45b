"""The port's native checkpoint format and its CLI
(`sam2_opt_tpu_torch/io/checkpoints.py`), on the CPU at the tiny config
(hiera_t, 128 px, the JAX package's `tiny128` weights):

- `save_params` -> `load_params` gives the state_dict back bit for bit, and
  `build_from_any` a model with the same weights and the same `set_image`
  logits, from a variant name and from a yaml path; an int8 model's
  quantized layers come back int8;
- a reference-layout `.pt` (the state_dict under "model") converts with
  `convert_pt_to_native`, and `build_from_any` reads either file;
- `python -m sam2_opt_tpu_torch.io.checkpoints convert|inspect`, and its
  usage on bad arguments.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.io import checkpoints as io_ckpt
from sam2_opt_tpu_torch.io.hydra_config import config_to_yaml
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models.model import build_sam2
from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _logits(model):
    image = (np.random.default_rng(0).random((96, 128, 3)) * 255).astype(np.uint8)
    predictor = SAM2ImagePredictor(model)
    predictor.set_image(image)
    _, _, low = predictor.predict(point_coords=np.array([[60.0, 40.0]], np.float32),
                                  point_labels=np.array([1], np.int32))
    return np.asarray(low)


@pytest.fixture(scope="module")
def cfg():
    return model_config("hiera_t", image_size=128)  # tiny128_cfg, as the port's dataclass


@pytest.fixture(scope="module")
def tiny_model(cfg, tiny128_params):
    return build_sam2(cfg=cfg, state_dict=state_dict_from_params(tiny128_params), device="cpu")


def test_native_round_trip_is_bitwise(tmp_path, cfg, tiny_model):
    path = str(tmp_path / "tiny.pth")
    sd = tiny_model.module.state_dict()
    io_ckpt.save_params(path, sd)
    assert os.listdir(tmp_path) == ["tiny.pth"]  # no temporary file left
    _same_state(io_ckpt.load_params(path), sd)
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(config_to_yaml(cfg))
    model = io_ckpt.build_from_any(str(yaml_path), path, device="cpu")
    assert model.cfg == cfg
    _same_state(model.module.state_dict(), sd)
    np.testing.assert_array_equal(_logits(model), _logits(tiny_model))
    # a variant name builds the variant's own config (1024 px) on the weights
    model = io_ckpt.build_from_any("hiera_t", path, device="cpu")
    assert model.cfg.image_size == 1024
    _same_state(model.module.state_dict(), sd)
    # no checkpoint: random weights from the seed, as build_sam2 draws them
    drawn = io_ckpt.build_from_any(str(yaml_path), None, seed=3, device="cpu")
    _same_state(drawn.module.state_dict(),
                build_sam2(cfg=cfg, seed=3, device="cpu").module.state_dict())


def test_int8_state_dict_round_trip(tmp_path, cfg, tiny_model):
    from sam2_opt_tpu_torch.quant.int8 import quantize_module

    module = build_sam2(cfg=cfg, state_dict=tiny_model.module.state_dict(),
                        device="cpu").module
    quantize_module(module)
    sd = module.state_dict()
    assert any(v.dtype == torch.int8 for v in sd.values())
    path = str(tmp_path / "int8.pth")
    io_ckpt.save_params(path, sd)
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(config_to_yaml(cfg))
    _same_state(io_ckpt.build_from_any(str(yaml_path), path, device="cpu").module.state_dict(),
                sd)


def test_reference_checkpoint_converts(tmp_path, cfg, tiny_model):
    sd = tiny_model.module.state_dict()
    pt = str(tmp_path / "sam2.1_hiera_tiny.pt")
    torch.save({"model": {k: v.half() if k.endswith("pos_embed") else v
                          for k, v in sd.items()}}, pt)
    native = str(tmp_path / "tiny.pth")
    converted = io_ckpt.convert_pt_to_native(pt, native)
    assert all(v.dtype == torch.float32 for v in converted.values())  # as load_checkpoint reads
    _same_state(io_ckpt.load_params(native), converted)
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text(config_to_yaml(cfg))
    from_pt = io_ckpt.build_from_any(str(yaml_path), pt, device="cpu")
    _same_state(from_pt.module.state_dict(), converted)
    _same_state(io_ckpt.build_from_any(str(yaml_path), native, device="cpu").module.state_dict(),
                converted)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "sam2_opt_tpu_torch.io.checkpoints", *args],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)


def test_cli_convert_and_inspect(tmp_path, tiny_model):
    sd = tiny_model.module.state_dict()
    pt = str(tmp_path / "ref.pt")
    torch.save({"model": sd}, pt)
    native = str(tmp_path / "out.pth")
    out = _cli("convert", pt, native)
    n = sum(v.numel() for v in sd.values())
    assert out.returncode == 0, out.stderr
    assert f"converted {pt} -> {native} ({n / 1e6:.1f}M params)" in out.stdout
    _same_state(io_ckpt.load_params(native), {k: v.float() for k, v in sd.items()})
    out = _cli("inspect", native)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    first = next(iter(sd))
    assert lines[0] == f"{first}: {tuple(sd[first].shape)} torch.float32"
    assert len(lines) == 21 and lines[-1] == f"... {len(sd)} tensors, {n / 1e6:.1f}M params"
    # in-process, as the module's main() runs it; usage on bad arguments
    assert io_ckpt.main(["inspect", native]) == 0
    for bad in ([], ["convert", pt], ["inspect"], ["export", native]):
        assert io_ckpt.main(bad) == 1
