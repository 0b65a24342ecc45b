"""The Hiera block's fused residual add + LayerNorm (`kernels/add_layer_norm.py`,
`csrc/add_layer_norm.cu`) and its route in the bf16 trunk.

On the CPU:
- the operator's plain version equals the eager chain it replaces
  (`ops.window_unpartition`, the residual add, `ops.layer_norm`,
  `ops.window_partition`) bit for bit, at hiera-L's four stage widths with
  fewer rows, a q-pool block's windows (half the entry's), a global block
  (raster on both sides) and hiera-b+'s padded windows of 14 and 7, in bf16
  and fp32;
- the bf16 trunk without grad takes the route, two calls a block, and gives
  the same bits as the eager chain it takes with grad (hiera-t, whose
  windows of 14 and 7 pad, and hiera-L: 96 calls a forward);
- the wrapper's argument checks.

On the card (`gpu`, no JAX imported here):
`python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_add_layer_norm.py`:
the kernel against its plain version at hiera-L's four stage shapes, a
global block and hiera-b+'s padded stage 3, one image and two
(`set_image_batch`), every pair of orders (the entry raster too, as a
q-pool block's), and `add_layer_norm.launches` counting 96 per hiera-L
`set_image`.
"""

import pytest
import torch

from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.kernels import add_layer_norm as aln
from sam2_opt_tpu_torch.models import hiera
from sam2_opt_tpu_torch.ops import common as ops

torch.set_num_threads(2)

EPS = 1e-6
# (C, H, W, ws of the entry's windows, ws of the attention's windows): rows
# cut down from hiera-L's stages at 1024² (256², 128², 64², 32² tokens), a
# q-pool block (its attention's windows half the entry's, over the pooled
# grid), a global block, hiera-b+'s padded stage 3 and 4 windows
CASES = {
    "L stage 1": (144, 16, 24, 8, 8),
    "L stage 2": (288, 12, 8, 4, 4),
    "L stage 3": (576, 16, 16, 16, 16),
    "L stage 4": (1152, 8, 8, 8, 8),
    "q-pool": (576, 16, 16, 8, 4),
    "global": (576, 9, 11, 0, 0),
    "B+ ws 14": (448, 20, 17, 14, 14),
    "B+ ws 7": (896, 9, 10, 7, 7),
}


def _tensors(C, H, W, ws_delta, dtype, B=2, seed=0, device="cpu"):
    """residual [B, H, W, C], delta in window order over the attention's
    grid (raster for ws 0), weight, bias; values of a trained trunk's
    spread (a mean per row, norms near 1)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    residual = r(B, H, W, C) * 2.0 + r(B, H, W, 1)
    delta = r(B, H, W, C)
    if ws_delta:
        delta, _ = ops.window_partition(delta, ws_delta)
    weight, bias = 1.0 + 0.3 * r(C), 0.2 * r(C)
    return [t.to(device, dtype) for t in (residual, delta, weight, bias)]


def _eager_entry(x, weight, bias, ws):
    """Block entry today: norm1, then the partition."""
    xn = ops.layer_norm(x, weight, bias, EPS)
    return ops.window_partition(xn, ws)[0] if ws else xn


def _eager_after_attention(shortcut, attn, weight, bias, ws):
    """After the attention today: unpartition, the residual add, norm2."""
    H, W = shortcut.shape[1:3]
    if ws:
        attn = ops.window_unpartition(attn, ws, aln.window_grid(ws, H, W)[1:], (H, W))
    x = shortcut + attn
    return x, ops.layer_norm(x, weight, bias, EPS)


def _op(*args):
    return torch.ops.sam2_opt_tpu_torch.add_layer_norm(*args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_equals_eager_chain(case, dtype):
    C, H, W, ws_in, ws_attn = CASES[case]
    residual, delta, weight, bias = _tensors(C, H, W, ws_attn, dtype)
    # the block's entry: no delta, normed in the entry's window order
    win = aln.window_grid(ws_in, H, W)
    total, normed = aln.add_layer_norm(residual, None, weight, bias, EPS, out_window=win)
    assert total is residual
    want = _eager_entry(residual, weight, bias, ws_in)
    assert normed.shape == want.shape and torch.equal(normed, want)
    if ws_in and win[1:] != (H, W):  # padded rows are zeros, as F.pad after the norm
        grid = ops.window_unpartition(normed, ws_in, win[1:], win[1:])
        assert not grid[:, H:].any() and not grid[:, :, W:].any()
    # after the attention: delta gathered from window order, raster out
    total, normed = aln.add_layer_norm(residual, delta, weight, bias, EPS,
                                       delta_window=aln.window_grid(ws_attn, H, W))
    want_sum, want = _eager_after_attention(residual, delta, weight, bias, ws_attn)
    assert torch.equal(total, want_sum) and torch.equal(normed, want)
    # both at once, through the operator itself
    total, normed = _op(residual, delta, weight, bias, EPS, list(aln.window_grid(ws_attn, H, W)),
                        list(win))
    assert torch.equal(total, want_sum) and torch.equal(normed, _eager_entry(want_sum, weight,
                                                                             bias, ws_in))


def test_plain_version_raster_delta():
    residual, delta, weight, bias = _tensors(144, 6, 5, 0, torch.bfloat16)
    total, normed = aln.add_layer_norm(residual, delta, weight, bias, EPS)
    want_sum, want = _eager_after_attention(residual, delta, weight, bias, 0)
    assert torch.equal(total, want_sum) and torch.equal(normed, want)


def test_operator_without_delta_returns_no_alias():
    residual, _, weight, bias = _tensors(144, 4, 4, 0, torch.bfloat16)
    total, normed = _op(residual, None, weight, bias, EPS, [], [8, 8, 8])
    assert total.numel() == 0 and normed.shape == (2, 8, 8, 144)


@pytest.mark.parametrize("bad", ["window", "shape", "delta_window alone"])
def test_wrapper_rejects(bad):
    residual, delta, weight, bias = _tensors(144, 10, 10, 8, torch.bfloat16)
    with pytest.raises(ValueError):
        if bad == "window":  # Hp must be H padded up to a multiple of ws
            aln.add_layer_norm(residual, None, weight, bias, EPS, out_window=(8, 24, 16))
        elif bad == "shape":
            aln.add_layer_norm(residual, None, weight[:-8], bias[:-8], EPS)
        else:
            aln.add_layer_norm(residual, None, weight, bias, EPS, delta_window=(8, 16, 16))


def _randomize(module, seed=0):
    """Weights of a trained trunk's spread: norms 1 + N(0, 0.1), biases N(0,
    0.1), the rest as initialized."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "norm" in name and name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("bias") or "pos_embed" in name:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return module


def _counting(monkeypatch):
    calls = []
    real = hiera.add_layer_norm

    def spy(*args, **kwargs):
        calls.append(kwargs.get("out_window", ()) or kwargs.get("delta_window", ()))
        return real(*args, **kwargs)

    monkeypatch.setattr(hiera, "add_layer_norm", spy)
    return calls


@pytest.mark.parametrize("variant,size", [("hiera_t", 128), ("hiera_t", 224)])
def test_trunk_route_equals_eager_forward(variant, size, monkeypatch):
    """The bf16 trunk without grad (inference mode, as the encoder's seams
    run) takes the route, two calls a block, and gives the eager chain's
    bits; with grad it takes the eager chain. hiera-t's stage 3 and 4
    windows (14, 7) pad at both sizes (8 and 4 tokens a side at 128 px, 14
    and 7 at 224 px: no padding there)."""
    trunk = _randomize(hiera.Hiera(model_config(variant).trunk)).to(torch.bfloat16)
    x = torch.randn(1, 3, size, size, generator=torch.Generator().manual_seed(1)).bfloat16()
    calls = _counting(monkeypatch)
    want = trunk(x)
    assert calls == []
    with torch.inference_mode():
        got = trunk(x)
    assert len(calls) == 2 * len(trunk.blocks)
    assert any(calls), "no block took a window order"
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b.detach())


def test_trunk_route_not_in_fp32(monkeypatch):
    trunk = hiera.Hiera(model_config("hiera_t").trunk)
    calls = _counting(monkeypatch)
    with torch.inference_mode():
        trunk(torch.zeros(1, 3, 64, 64))
    assert calls == []


def test_hiera_l_trunk_calls_96(monkeypatch):
    """hiera-L's 48 blocks call the operator twice each per forward, as a
    `set_image` does at 1024² (its window grids at 64 px, where every
    window pads, differ; the count does not)."""
    trunk = hiera.Hiera(model_config("hiera_l").trunk).to(torch.bfloat16)
    calls = _counting(monkeypatch)
    with torch.inference_mode():
        trunk(torch.zeros(1, 3, 64, 64, dtype=torch.bfloat16))
    assert len(calls) == 96


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

# hiera-L's four stages at 1024² (tokens a side, C, window) and hiera-b+'s
# stage 3 (64² tokens in windows of 14, padded to 70²)
CARD_SHAPES = {
    "L stage 1": (256, 144, 8),
    "L stage 2": (128, 288, 4),
    "L stage 3": (64, 576, 16),
    "L stage 4": (32, 1152, 8),
    "B+ stage 3": (64, 448, 14),
    "L global": (64, 576, 0),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def kernel_bound(x, scale, shift, ref):
    """Per-element bound on |kernel - plain| in bf16. The two sum a row's
    x and x^2 in fp32 in other orders, so mean and rstd differ in their
    last fp32 bits and scale and shift may each round one bf16 ulp (2^-8 of
    their size: 8 significant bits) apart. That moves bf16(x * scale) by
    2^-8 |x scale| before its own rounding, which may then land one ulp of
    it apart, and the sum by 2^-8 |shift|; the final rounding may land one
    ulp of |ref| apart: 2^-7 (|x scale| + |shift|) + 2^-7 |ref| covers it."""
    return 2.0 ** -7 * ((x * scale).abs() + shift.abs() + ref.abs())


def _scale_shift(x, weight, bias):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + EPS)
    return rstd * weight.float(), bias.float() - mean * rstd * weight.float()


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_matches_plain_on_card(shape, B):
    device = _card()
    side, C, ws = CARD_SHAPES[shape]
    residual, delta, weight, bias = _tensors(C, side, side, ws, torch.bfloat16, B=B,
                                             device=device)
    win = aln.window_grid(ws, side, side)
    before = aln.add_layer_norm.launches
    calls = (((), win, None), ((), (), None), (win, (), delta), (win, win, delta))
    for delta_window, out_window, d in calls:
        total, normed = aln.add_layer_norm(residual, d, weight, bias, EPS, delta_window,
                                           out_window)
        want_sum, want = aln.add_layer_norm_ref(residual, d, weight, bias, EPS, delta_window,
                                                out_window)
        torch.cuda.synchronize()
        assert torch.equal(total, want_sum), "the sum is one rounding on both sides"
        scale, shift = _scale_shift(want_sum, weight, bias)
        x = want_sum.float()
        if out_window:
            scale = ops.window_partition(scale.expand_as(x), ws)[0]
            shift = ops.window_partition(shift.expand_as(x), ws)[0]
            x = ops.window_partition(x, ws)[0]
        err = (normed.float() - want.float()).abs()
        assert bool((err <= kernel_bound(x, scale, shift, want.float())).all()), \
            f"{shape}: max error {err.max().item()}"
        assert float((err == 0).float().mean()) > 0.99  # one ulp apart only now and then
    assert aln.add_layer_norm.launches - before == len(calls)


@pytest.mark.gpu
def test_hiera_l_set_image_launches_96():
    """One bf16 `set_image` of hiera-L at 1024², run eagerly so that every
    wrapper runs (a graph replay runs none): 96 launches, 2 a block."""
    _card()
    import numpy as np

    from sam2_opt_tpu_torch import build_sam2_image_predictor

    predictor = build_sam2_image_predictor("hiera_l", seed=0)
    predictor.set_runtime_backend("cuda", {"dtype": torch.bfloat16})
    predictor.model._use_graphs = False
    image = (np.random.default_rng(0).random((600, 800, 3)) * 255).astype(np.uint8)
    predictor.set_image(image)
    before = aln.add_layer_norm.launches
    predictor.set_image(image)
    torch.cuda.synchronize()
    assert aln.add_layer_norm.launches - before == 96
