"""The plain reference against the port: the same state dict loads into
both, and every driver's comparison reads the port's fp32 path as equal to
the reference at a tiny size (hiera-t, 256 px) on the CPU."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO, run_cell


@pytest.mark.parametrize("variant", ["hiera_t", "hiera_l"])
def test_state_dict_layout_matches_the_port(variant):
    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.models.sam2_base import SAM2Base

    from conftest import _lists
    import dataclasses

    from portbench.reference import sam2_ref

    cfg = model_config(variant)
    with torch.device("meta"):
        port = SAM2Base(cfg).state_dict()
        ref = sam2_ref.SAM2(sam2_ref.config_from_json(_lists(dataclasses.asdict(cfg)))).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: tuple(v.shape)
                                                           for k, v in ref.items()}


def test_config_file_is_the_ports_preset():
    from sam2_opt_tpu_torch.config import model_config

    from portbench.harness import program

    config = json.loads((REPO / "portbench/configs/sam2.1_hiera_large.json").read_text())
    assert program._mismatches(model_config(config["variant"]), config["model"]) == []
    changed = dict(config["model"], num_maskmem=6)
    assert program._mismatches(model_config(config["variant"]), changed)


@pytest.mark.parametrize("cell", ["hiera_large.video_1obj", "hiera_large.image_3prompt"])
def test_fp32_port_equals_reference(tiny_root, cell, monkeypatch, capsys):
    """The port's fp32 eager path (no `speedup()`) against the reference:
    equal to rounding (1e-4 of the logits' scale), so what the bf16 runs
    read on the card is the port's precision and not a difference of
    semantics."""
    from portbench.harness import program

    monkeypatch.setattr(program, "speedup", lambda ctx, predictor: None)
    rc, line = run_cell(tiny_root, cell, capsys=capsys)
    assert rc == 0 and line["correct"] is True
    for name, check in line["checks"].items():
        assert check["value"] < 1e-4, (name, check)
