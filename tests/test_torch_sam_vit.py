"""Segment Anything's ViT through the port (`models/vit.py`, the
relative-position attention of `kernels/flash_attention.py`, SAM's layout in
`predictors/image.py`), held to the benchmark's plain fp32 reference
(`portbench/reference/sam_vit_ref.py`).

On the CPU (fp32, a small model: embed 64, 4 heads of 16, depth 4 with two
global blocks, windows of 4 over a 10 x 10 grid, so the windows pad):
- the attention's plain version (the operator's CPU side) against the
  logits formed in full, at a windowed and a global shape;
- the encoder against the reference's;
- `set_image` / `predict` against the reference's predictor on a non-square
  image: a click, a box (no padding point with it), and a box with a click
  and the last logits, through the longest-side resize, the pad and the crop;
- the bf16 route without grad: one relative-position attention and two
  `add_layer_norm` calls a block;
- the SAM 2 presets keep their configuration and their parameters.

On the card (`gpu`, no JAX imported here):
`python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_sam_vit.py`:
the kernel against its plain version and against SDPA fed the materialized
bias at ViT-H's global (4096 tokens) and windowed (25 windows of 196)
shapes and at head dim 64 (ViT-B/L), K1 at the same shapes without the
bias, and 32 launches per eager ViT-H `set_image`.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.harness import weights_vit
from portbench.reference import sam_vit_ref as ref
from sam2_opt_tpu_torch import SAM2ImagePredictor, build_sam2
from sam2_opt_tpu_torch.config import model_config, sam_vit_config
from sam2_opt_tpu_torch.kernels import add_layer_norm as aln
from sam2_opt_tpu_torch.kernels import flash_attention as fa
from sam2_opt_tpu_torch.models import vit
from sam2_opt_tpu_torch.models.sam2_base import SAM2Base

torch.set_num_threads(2)

SMALL = {"encoder.embed_dim": 64, "encoder.num_heads": 4, "encoder.depth": 4,
         "encoder.global_attn_indexes": (1, 3), "encoder.window_size": 4, "image_size": 160}


def _small():
    cfg = sam_vit_config("vit_h", **SMALL)
    model = {"encoder": dataclasses.asdict(cfg.encoder),
             **{k: v for k, v in dataclasses.asdict(cfg).items() if k != "encoder"}}
    return cfg, ref.config_from_json(model)


def _state_dict(ref_cfg, seed=0):
    # the benchmark's seeded draw, with the hypernetworks' last layers scaled
    # as its configuration scales them, so masks are decided by a margin
    scale = {f"sam_mask_decoder.output_hypernetworks_mlps.{i}.layers.2.weight": 100.0
             for i in range(4)}
    return weights_vit.make_state_dict(ref_cfg, seed, "cpu", rel_pos_std=0.1, scale=scale)


def _image(h=150, w=225, seed=0):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(6, 2, 16, 4, 4), (1, 3, 8, 8, 8), (2, 2, 8, 3, 6)],
                         ids=["windowed", "global", "non-square"])
def test_plain_relpos_attention_matches_eager_logits(shape):
    """The operator's plain version (q's products with the tables, gathered)
    against the logits formed in full with the reference's upstream
    `add_decomposed_rel_pos` (einsum over the gathered tables), and the
    port's eager chain."""
    B, H, D, Kh, Kw = shape
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, H, Kh * Kw, D, generator=g) for _ in range(3))
    rel_pos_h, rel_pos_w = (0.5 * torch.randn(2 * n - 1, D, generator=g) for n in (Kh, Kw))
    out = fa.flash_attention_relpos(q, k, v, rel_pos_h, rel_pos_w)
    flat = lambda t: t.reshape(B * H, Kh * Kw, D)  # noqa: E731
    attn = (flat(q) * D ** -0.5) @ flat(k).transpose(-1, -2)
    attn = ref.add_decomposed_rel_pos(attn, flat(q), rel_pos_h, rel_pos_w, (Kh, Kw))
    want = (attn.softmax(-1) @ flat(v)).view(B, H, Kh * Kw, D)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    rel_h, rel_w = fa.relpos_terms_from_products(fa.relpos_products(q, rel_pos_h, rel_pos_w),
                                                 Kh, Kw)
    torch.testing.assert_close(vit.eager_attention(q, k, v, rel_h, rel_w, D ** -0.5), want,
                               rtol=1e-5, atol=1e-5)
    # the bias matters: without it, or with the tables of the other axis, it differs
    if Kh == Kw:
        assert (fa.flash_attention_relpos(q, k, v, rel_pos_w, rel_pos_h) - want).abs().max() > 0.1
    assert (fa.flash_attention_ref(q, k, v)[0] - want).abs().max() > 0.1


def test_relpos_attention_rejects_a_grid_of_other_size():
    q = torch.zeros(1, 1, 16, 8)
    with pytest.raises(ValueError, match="do not make a grid"):
        fa.flash_attention_relpos(q, q, q, torch.zeros(7, 8), torch.zeros(5, 8))


def test_encoder_matches_reference():
    cfg, ref_cfg = _small()
    sd = _state_dict(ref_cfg)
    model = build_sam2("vit_h", cfg=cfg, state_dict=sd, device="cpu")
    reference = ref.build(ref_cfg, sd, "cpu")
    x = torch.randn(2, 3, 160, 160, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.module.image_encoder(x)
        want = reference.image_encoder(x)
    assert got.shape == (2, 256, 10, 10)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_predictor_matches_reference():
    cfg, ref_cfg = _small()
    sd = _state_dict(ref_cfg, seed=3)
    predictor = SAM2ImagePredictor(build_sam2("vit_h", cfg=cfg, state_dict=sd, device="cpu"))
    reference = ref.PredictorRef(ref.build(ref_cfg, sd, "cpu"), "cpu")
    image = _image()
    predictor.set_image(image)
    reference.set_image(image)
    assert reference.input_hw == (107, 160)  # 150 x 225, the long side to 160
    box = np.array([30, 20, 140, 110], np.float32)
    calls = [dict(point_coords=np.array([[80, 60]], np.float32), point_labels=np.array([1]),
                  multimask_output=True),
             dict(box=box, multimask_output=False),
             dict(box=box, point_coords=np.array([[60, 70]], np.float32),
                  point_labels=np.array([1]), multimask_output=False)]
    low = None
    for kw in calls:
        if "box" in kw and "point_coords" in kw:
            kw = dict(kw, mask_input=low)
        masks, ious, p_low = predictor.predict(**kw)
        r_masks, r_ious, r_low = reference.predict(**kw)
        low = r_low.numpy()
        assert masks.shape == (r_masks.shape[0], 150, 225)
        np.testing.assert_allclose(p_low, r_low.numpy(), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(ious, r_ious.numpy(), rtol=1e-4, atol=1e-4)
        assert np.mean(masks != (r_masks.numpy() > 0)) < 1e-3
        assert np.abs(p_low).max() > 5.0  # unclamped logits, decided by a margin


def test_box_prompt_has_no_padding_point():
    cfg, _ = _small()
    model = build_sam2("vit_h", cfg=cfg, device="cpu")
    pe = model.module.sam_prompt_encoder
    coords, labels = torch.zeros(1, 2, 2), torch.tensor([[2, 3]])
    assert pe(coords, labels, pad=False)[0].shape[1] == 2
    assert pe(coords, labels)[0].shape[1] == 3
    seen = []
    predictor = SAM2ImagePredictor(model)
    predictor.set_image(_image(64, 48))
    orig = model.predict_masks
    model.predict_masks = lambda *a, **kw: seen.append(kw["pad"]) or orig(*a, **kw)
    predictor.predict(box=np.array([1, 1, 20, 30], np.float32))
    predictor.predict(point_coords=np.array([[5, 5]], np.float32), point_labels=np.array([1]))
    assert seen == [False, True]


def test_predictor_takes_no_mesh():
    """A SAM ViT model runs on one device: a mesh is refused, not half used."""
    cfg, _ = _small()
    model = build_sam2("vit_h", cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="no mesh"):
        SAM2ImagePredictor(model, mesh=object())


def test_bf16_route_calls(monkeypatch):
    """bf16 without grad: each block one relative-position attention (the
    plain version on the CPU) and two add_layer_norm calls; the global
    blocks' bias grid is the whole 10 x 10 grid, the windows' 4 x 4."""
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    cfg, ref_cfg = _small()
    model = build_sam2("vit_h", cfg=cfg, state_dict=_state_dict(ref_cfg), device="cpu")
    enc = model.module.image_encoder.to(torch.bfloat16)
    grids, n_aln = [], []
    relpos, add = vit.flash_attention_relpos, vit.add_layer_norm
    monkeypatch.setattr(vit, "flash_attention_relpos", lambda q, k, v, th, tw: grids.append(
        fa.relpos_grid(th, tw)) or relpos(q, k, v, th, tw))
    monkeypatch.setattr(vit, "add_layer_norm", lambda *a, **kw: n_aln.append(1) or add(*a, **kw))
    x = torch.randn(1, 3, 160, 160).to(torch.bfloat16)
    with torch.no_grad():
        out = enc(x)
    assert grids == [(4, 4), (10, 10), (4, 4), (10, 10)]
    assert len(n_aln) == 8
    with torch.no_grad():
        want = model.module.image_encoder.float()(x.float())
    assert torch.isfinite(out).all()
    assert (out.float() - want).abs().mean() < 0.1 * want.abs().mean()


def test_vit_h_published_sizes():
    cfg = sam_vit_config("vit_h")
    e = cfg.encoder
    assert (e.embed_dim, e.depth, e.num_heads, e.head_dim, e.window_size) == (1280, 32, 16, 80, 14)
    assert e.global_attn_indexes == (7, 15, 23, 31)
    assert (cfg.image_size, cfg.image_embedding_size, e.out_chans) == (1024, 64, 256)
    with torch.device("meta"):
        module = vit.SamViT(cfg)
    n = sum(p.numel() for p in module.image_encoder.parameters())
    assert 636e6 < n < 638e6
    assert "sam_mask_decoder.obj_score_token.weight" not in module.state_dict()


@pytest.mark.parametrize("variant", ["hiera_t", "hiera_s", "hiera_b+", "hiera_l"])
def test_sam2_presets_unchanged(variant):
    """The SAM heads' flags keep every SAM 2 parameter, and the SAM 2
    config has no field of the ViT's."""
    cfg = model_config(variant)
    assert not {f.name for f in dataclasses.fields(cfg)} & {"encoder", "pixel_mean"}
    with torch.device("meta"):
        keys = set(SAM2Base(cfg).state_dict())
    for key in ("obj_score_token.weight", "conv_s0.weight", "conv_s1.weight",
                "pred_obj_score_head.layers.2.weight"):
        assert f"sam_mask_decoder.{key}" in keys


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #

# (B, heads, D, Kh, Kw): ViT-H's global blocks and its 25 padded windows;
# ViT-B/L's head dim
CARD_SHAPES = {"global": (1, 16, 80, 64, 64), "windowed": (25, 16, 80, 14, 14),
               "global d64": (1, 16, 64, 64, 64), "windowed d64": (25, 16, 64, 14, 14)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(shape, device, seed=0):
    """q, k, v as strided views of one qkv projection, as the ViT passes
    them, and tables whose bias terms have a trained model's spread."""
    B, H, D, Kh, Kw = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, Kh * Kw, 3, H, D, generator=g, device=device).to(torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    rel_pos_h, rel_pos_w = (torch.randn(2 * n - 1, D, generator=g, device=device).mul_(0.1)
                            .to(torch.bfloat16) for n in (Kh, Kw))
    return q, k, v, rel_pos_h, rel_pos_w


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_matches_plain_on_card(shape):
    device = _card()
    q, k, v, rel_pos_h, rel_pos_w = _card_inputs(CARD_SHAPES[shape], device)
    before = fa.flash_attention_relpos.launches
    out = fa.flash_attention_relpos(q, k, v, rel_pos_h, rel_pos_w)
    want = fa.flash_attention_relpos_ref(q, k, v, rel_pos_h, rel_pos_w)
    torch.cuda.synchronize()
    assert fa.flash_attention_relpos.launches - before == 1
    err = (out.float() - want.float()).abs()
    assert err.max().item() < 2e-2 and err.mean().item() < 1e-3, (err.max(), err.mean())
    # SDPA fed the materialized bias (rounded to bf16) agrees as closely
    Kh, Kw = CARD_SHAPES[shape][3:]
    rel = fa.relpos_products(q, rel_pos_h, rel_pos_w)
    rel_h, rel_w = fa.relpos_terms_from_products(rel, Kh, Kw)
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]).flatten(-2)
    sdpa = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(torch.bfloat16))
    assert (sdpa.float() - want.float()).abs().mean().item() < 2e-3
    # the tables matter: swapped, they differ
    swapped = fa.flash_attention_relpos(q, k, v, rel_pos_w, rel_pos_h)
    assert (swapped.float() - want.float()).abs().mean().item() > 10 * err.mean().item()
    assert math.isfinite(out.float().sum().item())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["global", "windowed"])
def test_k1_without_bias_on_card(shape):
    """The same shapes without the bias run K1 (`flash_fwd_*`), unchanged."""
    device = _card()
    q, k, v, _, _ = _card_inputs(CARD_SHAPES[shape], device)
    out, _ = fa.flash_attention(q, k, v)
    want, _ = fa.flash_attention_ref(q, k, v)
    torch.testing.assert_close(out.float(), want.float(), rtol=1e-2, atol=1e-3)


@pytest.mark.gpu
def test_vit_h_set_image_launches_32():
    """One eager bf16 ViT-H `set_image`: 32 relative-position attention
    launches and 64 add_layer_norm launches, one and two a block."""
    _card()
    predictor = SAM2ImagePredictor(build_sam2("vit_h", seed=0))
    predictor.set_runtime_backend("cuda", {"dtype": torch.bfloat16})
    predictor.model._use_graphs = False
    image = _image(600, 800)
    predictor.set_image(image)
    before = (fa.flash_attention_relpos.launches, aln.add_layer_norm.launches)
    predictor.set_image(image)
    torch.cuda.synchronize()
    assert fa.flash_attention_relpos.launches - before[0] == 32
    assert aln.add_layer_norm.launches - before[1] == 64


@pytest.mark.gpu
def test_unserved_shape_raises_on_card():
    """A bf16 block without grad whose head dim the kernel does not serve
    raises on the card instead of falling back to the full logits."""
    device = _card()
    attn = vit.Attention(128, 4, 8).to(device, torch.bfloat16)
    x = torch.randn(1, 8, 8, 128, device=device, dtype=torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match="flash_attention_relpos"):
        attn(x)
