"""The SAM ViT cell's driver (`drivers/sam_image.py`) on the CPU at a toy
size, through `run.main` from a tiny copy of its files: the port's answers
(bf16 through `speedup()`, eagerly on the CPU) pass the cell's comparison,
`--trace 1` reads its per-layer metrics where the CPU has them, and the
operation count follows the configuration. The tiny copy holds this cell alone (`conftest.make_tiny`
builds SAM 2 cells). On the card (`gpu`), at the cell's own size: the two
faults of the relative-position bias planted in the kernel's route (dropped
from the global blocks; rel_h and rel_w swapped) and the fp8 control are not
correct."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from conftest import REPO, run_cell

CELL = "sam_vit_h.image_3prompt"
SMALL = {"encoder.embed_dim": 64, "encoder.num_heads": 4, "encoder.depth": 4,
         "encoder.global_attn_indexes": [1, 3], "encoder.window_size": 4, "image_size": 160}


def _lists(x):
    if isinstance(x, dict):
        return {k: _lists(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_lists(v) for v in x]
    return x


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    from sam2_opt_tpu_torch.config import sam_vit_config

    dest = tmp_path_factory.mktemp("tiny_vit")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    spec["workloads"] = [cell]
    spec["configs"] = [c for c in spec["configs"] if c["name"] == cell["config"]]
    bench = dest / "portbench"
    for sub in ("configs", "workloads"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(REPO / "portbench" / "metrics", bench / "metrics")
    config = json.loads((REPO / spec["configs"][0]["file"]).read_text())
    config["overrides"] = SMALL
    config["model"] = _lists(dataclasses.asdict(sam_vit_config("vit_h", **dict(SMALL))))
    (bench / "configs" / "sam_vit_h.json").write_text(json.dumps(config))
    traffic = json.loads((REPO / "portbench" / "workloads" / f"{CELL}.json").read_text())
    traffic.update(height=90, width=120, warm_requests=1, traced_requests=2, check_requests=2)
    (bench / "workloads" / f"{CELL}.json").write_text(json.dumps(traffic))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


def test_port_passes_the_comparison(root, capsys):
    rc, line = run_cell(root, CELL, capsys=capsys)
    assert rc == 0 and line["correct"], line
    assert set(line["metrics"]) == {"image_p95_ms", "setup_s"}
    assert 0 < line["checks"]["logit_rms"]["value"] < 0.1


def test_trace_reads_what_the_cpu_has(root, capsys):
    rc, line = run_cell(root, CELL, trace=1, capsys=capsys)
    assert rc == 0 and line["correct"]
    # mfu is read from the host's clock; stage events and kernels need the card
    assert set(line["metrics"]) == {"mfu.vit_h"}


def test_vit_h_counts():
    from portbench.harness import flops_vit

    model = json.loads((REPO / "portbench/configs/sam_vit_h.json").read_text())["model"]
    assert flops_vit.encoder_flops(model) == pytest.approx(5.961e12, rel=1e-3)
    calls = flops_vit.relpos_calls(model)
    assert len(calls) == 32 and calls[7] == (1, 16, 4096, 4096, 80, 64, 64)
    assert calls[0] == (25, 16, 196, 196, 80, 14, 14)
    # the global blocks are bound by operations, the windows by bytes
    assert flops_vit.relpos_bound_s(*calls[7]) == pytest.approx(4 * 16 * 4096 ** 2 * 80 / 989e12)
    assert flops_vit.relpos_bound_s(*calls[0]) > 4 * 400 * 196 ** 2 * 80 / 989e12


def _drop_global_bias(monkeypatch):
    """The global blocks' attention runs without its bias (K1)."""
    from sam2_opt_tpu_torch.kernels import flash_attention as fa
    from sam2_opt_tpu_torch.models import vit

    relpos = vit.flash_attention_relpos

    def kernel(q, k, v, rel_pos_h, rel_pos_w):
        if rel_pos_h.shape[0] == 2 * 64 - 1:  # a global block's table (64 x 64 tokens)
            return fa.flash_attention(q, k, v)[0]
        return relpos(q, k, v, rel_pos_h, rel_pos_w)

    monkeypatch.setattr(vit, "flash_attention_relpos", kernel)


def _swap_rel_h_rel_w(monkeypatch):
    """Every block adds rel_w where rel_h belongs and the other way round."""
    from sam2_opt_tpu_torch.models import vit

    relpos = vit.flash_attention_relpos
    monkeypatch.setattr(vit, "flash_attention_relpos",
                        lambda q, k, v, th, tw: relpos(q, k, v, tw, th))


FAULTS = (_drop_global_bias, _swap_rel_h_rel_w)


def _card_run(cell, seed, *extra):
    """One run of the full-size cell in this process (a short window)."""
    from portbench import run

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the comparison is read at the cell's own size")
    return run.main(["--workload", cell, "--seed", str(seed), "--seconds", "5", "--trace", "0",
                     *extra])


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct_on_the_card(fault, monkeypatch, capsys):
    """Each fault of the relative-position bias, planted in the port under
    the full-size cell: not correct."""
    fault(monkeypatch)
    assert _card_run(CELL, 2 ** 31 + 21) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with capsys.disabled():
        print(json.dumps({"fault": fault.__name__, "checks": line["checks"]}))
    assert line["correct"] is False, line["checks"]


@pytest.mark.gpu
def test_control_is_not_correct_on_the_card(capsys):
    """The control, the reference rounded to fp8 in the port's place, on
    three seeds at the cell's own size: not correct."""
    lines = {}
    for seed in (2 ** 31 + 31, 2 ** 31 + 32, 2 ** 31 + 33):
        assert _card_run(CELL, seed, "--control", "fp8") == 0
        lines[seed] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        with capsys.disabled():
            print(json.dumps({"control": seed, "checks": lines[seed]["checks"]}))
    assert not any(line["correct"] for line in lines.values()), lines
