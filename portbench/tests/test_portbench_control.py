"""The comparison fails what it must. On the CPU: the faults a cell can
have, planted in the port underneath a tiny run of the port's fp32 path,
turn `correct` false under the cell's own limits (the video driver's too,
whose cell BENCHMARK.json does not name yet). On the card (`gpu`), at each
cell's own size on three seeds: the control is not correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import REPO, run_cell

VIDEO = ["hiera_large.video_1obj"]


def _fp32(monkeypatch):
    from portbench.harness import program

    monkeypatch.setattr(program, "speedup", lambda ctx, predictor: None)


def _alter_video_answer(monkeypatch):
    """One tracked frame's logits come out negated where they are made."""
    from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

    orig, calls = SAM2VideoPredictor._fill_holes, []

    def fill(self, pred_masks):
        calls.append(1)
        out = orig(self, pred_masks)
        return -out if len(calls) == 6 else out

    monkeypatch.setattr(SAM2VideoPredictor, "_fill_holes", fill)


def _state_unchanged(monkeypatch):
    """Each tracking step hands back the memory it was given: the bank
    keeps the clicked frame's memory and never takes a tracked frame's."""
    from sam2_opt_tpu_torch.models import video_core

    orig = video_core._finalize

    def finalize(m, cfg, raw_embed, sam_outputs, run_mem_encoder, is_mask_from_pts,
                 keep_multimasks=False):
        out = orig(m, cfg, raw_embed, sam_outputs, False, is_mask_from_pts, keep_multimasks)
        if run_mem_encoder and not is_mask_from_pts:
            out["maskmem_features"] = raw_embed.new_zeros(
                raw_embed.shape[0], cfg.mem_dim, *raw_embed.shape[-2:], dtype=torch.bfloat16)
        elif run_mem_encoder:
            out = orig(m, cfg, raw_embed, sam_outputs, True, is_mask_from_pts, keep_multimasks)
        return out

    monkeypatch.setattr(video_core, "_finalize", finalize)


def _alter_image_answer(monkeypatch):
    """The second `predict` of every request answers with negated logits."""
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor

    orig, calls = SAM2ImagePredictor.postprocess_masks, []

    def post(self, masks, orig_hw):
        calls.append(1)
        out = orig(self, masks, orig_hw)
        return -out if len(calls) % 3 == 2 else out

    monkeypatch.setattr(SAM2ImagePredictor, "postprocess_masks", post)


FAULTS = [(cell, fault) for cell in VIDEO for fault in (_alter_video_answer, _state_unchanged)]
FAULTS += [("hiera_large.image_3prompt", _alter_image_answer)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(tiny_root, cell, fault, monkeypatch, capsys):
    _fp32(monkeypatch)
    fault(monkeypatch)
    rc, line = run_cell(tiny_root, cell, capsys=capsys)
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["hiera_large.image_3prompt"])
def test_control_is_not_correct_on_the_card(cell):
    """The control, the reference rounded to fp8 in the port's place, at
    the cell's own size on three seeds, through the benchmark's command (a
    short window at the cell's load): not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read at the cell's own size")
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                              "--seed", str(seed), "--seconds", "10", "--trace", "0",
                              "--control", "fp8"], cwd=REPO, capture_output=True, text=True,
                             env=dict(os.environ), timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is False, (seed, line["checks"])

