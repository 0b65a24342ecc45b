"""The yardstick's arithmetic: the attention bounds are those of the port's
kernel table (PERF.md section 6, bf16 at 989 TFLOP/s), and the model
counts equal torch's own count of the reference's products where no
window pads (hiera-L at 256 px)."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO, _lists
from portbench.harness import flops


def test_attention_bounds_match_the_kernel_table():
    ms = lambda s: round(1e3 * s, 4)  # noqa: E731
    assert ms(flops.k1_bound_s(1, 8, 4096, 4096, 72)) == 0.0391
    assert ms(flops.k2_bound_s(1, 4096, 7 * 4096 + 64, 256)) == 0.1222
    assert ms(flops.k2_bound_s(1, 4096, 4096, 256)) == 0.0174
    assert ms(flops.k3_bound_s(64, 1, 4096, 4096, 56, "dkdv")) == 0.4864
    assert ms(flops.k3_bound_s(64, 1, 4096, 4096, 56, "dq")) == 0.3648
    # masked keys need no work
    assert flops.k2_bound_s(1, 4096, 28736, 256, valid_keys=4096) < flops.k2_bound_s(
        1, 4096, 28736, 256)


def test_hiera_large_counts():
    model = json.loads((REPO / "portbench/configs/sam2.1_hiera_large.json").read_text())["model"]
    assert 1.75e12 < flops.trunk_flops(model, 1024) < 1.85e12
    assert flops.k1_calls(model) == [(1, 8, 4096, 4096, 72)] * 3  # blocks 23, 33, 43
    assert 0.59e12 < flops.memory_attention_flops(model, 1, 28736) < 0.62e12


@pytest.fixture(scope="module")
def small():
    from sam2_opt_tpu_torch.config import model_config

    from portbench.harness import weights
    from portbench.reference import sam2_ref

    model = _lists(dataclasses.asdict(model_config("hiera_l", image_size=256)))
    cfg = sam2_ref.config_from_json(model)
    ref = sam2_ref.build(cfg, weights.make_state_dict(cfg, 1, "cpu"), "cpu").requires_grad_(False)
    return model, ref


def _counted(fn):
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


def test_encoder_count_equals_torch_count(small):
    model, ref = small
    x = torch.rand(1, 3, 256, 256)
    assert _counted(lambda: ref.encode(x)) == pytest.approx(flops.encoder_flops(model), rel=1e-6)


def test_memory_attention_count_equals_torch_count(small):
    model, ref = small
    g = model["image_size"] // model["backbone_stride"]
    n_keys = 3 * g * g + 5 * 4
    curr, pos = torch.rand(2, g * g, 256), torch.rand(2, g * g, 256)
    mem, mem_pos = torch.rand(2, n_keys, 64), torch.rand(2, n_keys, 64)
    got = _counted(lambda: ref.memory_attention(curr, mem, pos, mem_pos, 3 * g * g))
    assert got == pytest.approx(flops.memory_attention_flops(model, 2, n_keys), rel=1e-6)


def test_memory_encoder_count_equals_torch_count(small):
    model, ref = small
    g = model["image_size"] // model["backbone_stride"]
    feats, masks = torch.rand(3, 256, g, g), torch.rand(3, 1, 256, 256)
    got = _counted(lambda: ref.memory_encoder(feats, masks))
    assert got == pytest.approx(flops.memory_encoder_flops(model, 3), rel=1e-6)


@pytest.mark.parametrize("n_points,mask", [(1, False), (3, True)])
def test_decoder_count_is_close_to_torch_count(small, n_points, mask):
    """Within 1%: the hypernetwork and head MLPs are counted roughly."""
    model, ref = small
    g = model["image_size"] // model["backbone_stride"]
    emb, hrf0, hrf1 = torch.rand(1, 256, g, g), torch.rand(1, 32, 4 * g, 4 * g), \
        torch.rand(1, 64, 2 * g, 2 * g)
    coords, labels = torch.rand(1, n_points, 2) * 256, torch.ones(1, n_points, dtype=torch.long)
    m_in = torch.rand(1, 1, 4 * g, 4 * g) if mask else None

    def go():
        sparse, dense = ref.sam_prompt_encoder(coords, labels, m_in)
        ref.sam_mask_decoder(emb, ref.sam_prompt_encoder.dense_pe(), sparse, dense, True,
                             hrf0, hrf1)

    assert _counted(go) == pytest.approx(flops.decoder_flops(model, 1, n_points, mask), rel=1e-2)
