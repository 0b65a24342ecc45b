"""The port's reference-yaml ingestion (`sam2_opt_tpu_torch/io/hydra_config.py`)
against the JAX package's (`sam2_opt_tpu/io/hydra_config.py`), on yamls
written here (the reference's config files are not in the repository):

- the reference's sam2.1_hiera_t.yaml, as released, and the yaml
  `config_to_yaml` writes for each variant: field-equal to JAX's configs
  and to `model_config(variant)`;
- a training yaml (`trainer.model`, `${scratch.resolution}`, the
  SAM2Train knobs), a SAM2.0-style yaml without the 2.1 keys, a mutated
  custom topology built through `build_sam2(path)`, `resolve_config`'s
  dotted overrides;
- the unknown-key and unsupported-structure errors
  (`tests/test_hydra_config.py`);
- the one intended difference: a missing `cross_attention.kv_in_dim` is
  d_model in the port (the reference's default), 64 in JAX;
- the SAM2.0 pointer flags, built in both packages from one written yaml:
  a 3-frame video loop at the tiny config within 1e-4 of JAX's.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch
import yaml

from sam2_opt_tpu.config import model_config as jax_model_config
from sam2_opt_tpu.io import hydra_config as jax_hc
from sam2_opt_tpu.models.model import SAM2Model as JaxSAM2Model
from sam2_opt_tpu.predictors.video import SAM2VideoPredictor as JaxVideoPredictor
from sam2_opt_tpu_torch import build_sam2
from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.io import hydra_config as hc
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

torch.set_num_threads(2)

# sam2/sam2/configs/sam2.1/sam2.1_hiera_t.yaml as released
HIERA_T_YAML = """\
# @package _global_

# Model
model:
  _target_: sam2.modeling.sam2_base.SAM2Base
  image_encoder:
    _target_: sam2.modeling.backbones.image_encoder.ImageEncoder
    scalp: 1
    trunk:
      _target_: sam2.modeling.backbones.hieradet.Hiera
      embed_dim: 96
      num_heads: 1
      stages: [1, 2, 7, 2]
      global_att_blocks: [5, 7, 9]
      window_pos_embed_bkg_spatial_size: [7, 7]
    neck:
      _target_: sam2.modeling.backbones.image_encoder.FpnNeck
      position_encoding:
        _target_: sam2.modeling.position_encoding.PositionEmbeddingSine
        num_pos_feats: 256
        normalize: true
        scale: null
        temperature: 10000
      d_model: 256
      backbone_channel_list: [768, 384, 192, 96]
      fpn_top_down_levels: [2, 3]  # output level 0 and 1 directly use the backbone features
      fpn_interp_model: nearest

  memory_attention:
    _target_: sam2.modeling.memory_attention.MemoryAttention
    d_model: 256
    pos_enc_at_input: true
    layer:
      _target_: sam2.modeling.memory_attention.MemoryAttentionLayer
      activation: relu
      dim_feedforward: 2048
      dropout: 0.1
      pos_enc_at_attn: false
      self_attention:
        _target_: sam2.modeling.sam.transformer.RoPEAttention
        rope_theta: 10000.0
        feat_sizes: [64, 64]
        embedding_dim: 256
        num_heads: 1
        downsample_rate: 1
        dropout: 0.1
      d_model: 256
      pos_enc_at_cross_attn_keys: true
      pos_enc_at_cross_attn_queries: false
      cross_attention:
        _target_: sam2.modeling.sam.transformer.RoPEAttention
        rope_theta: 10000.0
        feat_sizes: [64, 64]
        rope_k_repeat: True
        embedding_dim: 256
        num_heads: 1
        downsample_rate: 1
        dropout: 0.1
        kv_in_dim: 64
    num_layers: 4

  memory_encoder:
      _target_: sam2.modeling.memory_encoder.MemoryEncoder
      out_dim: 64
      position_encoding:
        _target_: sam2.modeling.position_encoding.PositionEmbeddingSine
        num_pos_feats: 64
        normalize: true
        scale: null
        temperature: 10000
      mask_downsampler:
        _target_: sam2.modeling.memory_encoder.MaskDownSampler
        kernel_size: 3
        stride: 2
        padding: 1
      fuser:
        _target_: sam2.modeling.memory_encoder.Fuser
        layer:
          _target_: sam2.modeling.memory_encoder.CXBlock
          dim: 256
          kernel_size: 7
          padding: 3
          layer_scale_init_value: 1e-6
          use_dwconv: True  # depth-wise convs
        num_layers: 2

  num_maskmem: 7
  image_size: 1024
  # apply scaled sigmoid on mask logits for memory encoder, and directly feed input mask as output mask
  # SAM decoder
  sigmoid_scale_for_mem_enc: 20.0
  sigmoid_bias_for_mem_enc: -10.0
  use_mask_input_as_output_without_sam: true
  # Memory
  directly_add_no_mem_embed: true
  no_obj_embed_spatial: true
  # use high-resolution feature map in the SAM mask decoder
  use_high_res_features_in_sam: true
  # output 3 masks on the first click on initial conditioning frames
  multimask_output_in_sam: true
  # SAM heads
  iou_prediction_use_sigmoid: True
  # cross-attend to object pointers from other frames (based on SAM output tokens) in the encoder
  use_obj_ptrs_in_encoder: true
  add_tpos_enc_to_obj_ptrs: true
  proj_tpos_enc_in_obj_ptrs: true
  use_signed_tpos_enc_to_obj_ptrs: true
  only_obj_ptrs_in_the_past_for_eval: true
  # object occlusion prediction
  pred_obj_scores: true
  pred_obj_scores_mlp: true
  fixed_no_obj_ptr: true
  # multimask tracking settings
  multimask_output_for_tracking: true
  use_multimask_token_for_obj_ptr: true
  multimask_min_pt_num: 0
  multimask_max_pt_num: 1
  use_mlp_for_obj_ptr_proj: true
  # Compilation flag
  # HieraT does not currently support compilation, should always be set to False
  compile_image_encoder: False
"""

# a SAM2.0 yaml (configs/sam2/sam2_hiera_*.yaml) sets
# `add_tpos_enc_to_obj_ptrs: false` and lacks the other SAM2.1 keys
V20_ABSENT = ("proj_tpos_enc_in_obj_ptrs", "use_signed_tpos_enc_to_obj_ptrs",
              "no_obj_embed_spatial")
V20_FALSE = {k: False for k in ("add_tpos_enc_to_obj_ptrs",) + V20_ABSENT}


def _sam20(text, absent=V20_ABSENT):
    lines = [line for line in text.splitlines() if line.strip().split(":")[0] not in absent]
    return "\n".join(lines).replace("add_tpos_enc_to_obj_ptrs: true",
                                     "add_tpos_enc_to_obj_ptrs: false") + "\n"


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _same_config(port_cfg, jax_cfg):
    """Field-equal across the two packages' dataclasses."""
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def test_released_hiera_t_yaml_matches_jax(tmp_path):
    path = _write(tmp_path, "sam2.1_hiera_t.yaml", HIERA_T_YAML)
    cfg = hc.config_from_yaml(path)
    _same_config(cfg, jax_hc.config_from_yaml(path))
    assert cfg == model_config("hiera_t")
    assert build_sam2(path, device="cpu").cfg == cfg


@pytest.mark.parametrize("variant", ["hiera_t", "hiera_s", "hiera_b+", "hiera_l"])
def test_written_variant_yamls_match_jax(tmp_path, variant):
    text = hc.config_to_yaml(model_config(variant))
    path = _write(tmp_path, f"{variant}.yaml", text)
    cfg = hc.config_from_yaml(path)
    assert cfg == model_config(variant)
    _same_config(cfg, jax_hc.config_from_yaml(path))
    _same_config(cfg, jax_model_config(variant))
    assert hc.resolve_config(path) == cfg
    assert hc.resolve_config(f"configs/sam2.1/sam2.1_{variant}.yaml") == cfg


def test_training_yaml_and_knobs_match_jax(tmp_path):
    model = yaml.safe_load(hc.config_to_yaml(model_config("hiera_b+")))["model"]
    model["_target_"] = "training.model.sam2.SAM2Train"
    model["image_encoder"]["trunk"]["drop_path_rate"] = 0.1
    model["image_size"] = "${scratch.resolution}"
    knobs = dict(prob_to_use_pt_input_for_train=0.5, prob_to_use_box_input_for_train=0.5,
                 num_frames_to_correct_for_train=2, num_correction_pt_per_frame=7,
                 num_init_cond_frames_for_train=2, rand_init_cond_frames_for_train=True,
                 freeze_image_encoder=False)
    model.update(knobs)
    doc = {"scratch": {"resolution": 1024, "num_frames": 8},
           "trainer": {"_target_": "training.trainer.Trainer", "max_epochs": 40, "model": model}}
    path = _write(tmp_path, "mose_finetune.yaml", yaml.safe_dump(doc))
    cfg, got = hc.config_and_train_knobs_from_yaml(path)
    jax_cfg, want = jax_hc.config_and_train_knobs_from_yaml(path)
    _same_config(cfg, jax_cfg)
    expected = model_config("hiera_b+")
    assert cfg == dataclasses.replace(
        expected, trunk=dataclasses.replace(expected.trunk, drop_path_rate=0.1))
    assert got == want == knobs


def test_sam20_yaml_keeps_reference_defaults(tmp_path):
    """A SAM2.0 yaml omits the 2.1 keys: the reference SAM2Base defaults
    apply (False), not this package's 2.1 dataclass defaults."""
    path = _write(tmp_path, "sam2_hiera_t.yaml", _sam20(HIERA_T_YAML))
    cfg = hc.config_from_yaml(path)
    _same_config(cfg, jax_hc.config_from_yaml(path))
    assert cfg == dataclasses.replace(model_config("hiera_t"), **V20_FALSE)


def test_mutated_custom_yaml_builds(tmp_path):
    """A custom topology (shallower trunk, 2-layer memory attention, 512 px)
    builds mechanically, in the port as in JAX, with dotted overrides."""
    text = (HIERA_T_YAML.replace("stages: [1, 2, 7, 2]", "stages: [1, 1, 2, 1]")
            .replace("global_att_blocks: [5, 7, 9]", "global_att_blocks: [3]")
            .replace("num_layers: 4", "num_layers: 2")
            .replace("image_size: 1024", "image_size: 512"))
    path = _write(tmp_path, "custom.yaml", text)
    cfg = hc.config_from_yaml(path)
    _same_config(cfg, jax_hc.config_from_yaml(path))
    assert cfg.trunk.stages == (1, 1, 2, 1) and cfg.trunk.global_att_blocks == (3,)
    assert cfg.memory_attention.num_layers == 2 and cfg.image_size == 512
    assert cfg.memory_attention.rope_feat_sizes == (32, 32)  # follows the feature grid
    model = build_sam2(path, device="cpu")
    assert model.cfg == cfg and len(model.module.image_encoder.trunk.blocks) == 5
    over = hc.resolve_config(path, **{"memory_attention.num_layers": 1, "num_maskmem": 3})
    jax_over = jax_hc.resolve_config(path, **{"memory_attention.num_layers": 1,
                                              "num_maskmem": 3})
    _same_config(over, jax_over)
    assert over.memory_attention.num_layers == 1 and over.num_maskmem == 3


def test_unknown_keys_fail_loudly(tmp_path):
    text = HIERA_T_YAML.replace("num_maskmem: 7", "num_maskmem: 7\n  totally_new_flag: true")
    path = _write(tmp_path, "bad.yaml", text)
    for pkg in (hc, jax_hc):
        with pytest.raises(pkg.YamlConfigError, match="totally_new_flag"):
            pkg.config_from_yaml(path)


@pytest.mark.parametrize("old,new,key", [
    ("downsample_rate: 1", "downsample_rate: 2", "downsample_rate"),
    ("use_dwconv: True", "use_dwconv: False", "use_dwconv"),
    ("temperature: 10000", "temperature: 20000", "temperature"),
], ids=["downsample_rate", "use_dwconv", "temperature"])
def test_unsupported_structural_choice_fails(tmp_path, old, new, key):
    path = _write(tmp_path, "unsup.yaml", HIERA_T_YAML.replace(old, new, 1))
    for pkg in (hc, jax_hc):
        with pytest.raises(pkg.YamlConfigError, match=key):
            pkg.config_from_yaml(path)


def test_missing_kv_in_dim_is_d_model(tmp_path):
    """The one intended difference: the reference's Attention takes
    kv_in_dim = embedding_dim when the yaml gives none; the JAX loader
    takes 64. Every other field agrees."""
    path = _write(tmp_path, "no_kv.yaml", HIERA_T_YAML.replace("        kv_in_dim: 64\n", ""))
    cfg, jax_cfg = hc.config_from_yaml(path), jax_hc.config_from_yaml(path)
    assert cfg.memory_attention.kv_in_dim == cfg.memory_attention.d_model == 256
    assert jax_cfg.memory_attention.kv_in_dim == 64
    _same_config(dataclasses.replace(cfg, memory_attention=dataclasses.replace(
        cfg.memory_attention, kv_in_dim=64)), jax_cfg)
    model = build_sam2(path, device="cpu").module
    assert model.memory_attention.layers[0].cross_attn_image.k_proj.weight.shape == (256, 256)


def test_config_to_yaml_refuses_fields_a_yaml_cannot_carry():
    with pytest.raises(hc.YamlConfigError, match="sam_mask_decoder_depth"):
        hc.config_to_yaml(dataclasses.replace(model_config("hiera_t"), sam_mask_decoder_depth=3))


# the SAM2.0 pointer flags through the yaml path: one 3-frame video loop

T, S = 3, 128


def _video():
    rng = np.random.default_rng(0)
    bg = np.kron(rng.random((16, 16, 3)), np.ones((8, 8, 1)))
    square = np.kron(rng.random((4, 4, 3)) * 0.5 + 0.5, np.ones((8, 8, 1)))
    frames = []
    for t in range(T):
        f = bg.copy()
        f[40:72, 20 + 8 * t:52 + 8 * t] = square
        frames.append(f)
    return (np.stack(frames) * 255).astype(np.uint8)


def _track(predictor):
    state = predictor.init_state(_video())
    outs = [predictor.add_new_points_or_box(
        state, 0, 1, points=np.array([[36.0, 56.0]], np.float32), labels=np.array([1]))[2]]
    outs += [m for _, _, m in predictor.propagate_in_video(state)]
    lows = [out["pred_masks"] for frames in state["output_dict_per_obj"][0].values()
            for out in frames.values()]
    return [np.asarray(x) for x in outs + lows]


def test_sam20_pointer_flags_video_loop_matches_jax(tmp_path, tiny128_params):
    """The SAM2.0 yamls set the object pointers' temporal encoding off
    (`add_tpos_enc_to_obj_ptrs: false`, and neither its projection nor the
    signed distance) and keep `only_obj_ptrs_in_the_past_for_eval`; the
    spatial no-object embedding stays, so the tiny weights load. The port
    and JAX build that config from one yaml and track the same 3 frames
    within 1e-4."""
    text = _sam20(hc.config_to_yaml(model_config("hiera_t", image_size=S)), V20_ABSENT[:2])
    path = _write(tmp_path, "sam2_pointer_flags.yaml", text)
    cfg, jax_cfg = hc.config_from_yaml(path), jax_hc.config_from_yaml(path)
    _same_config(cfg, jax_cfg)
    assert not (cfg.add_tpos_enc_to_obj_ptrs or cfg.proj_tpos_enc_in_obj_ptrs
                or cfg.use_signed_tpos_enc_to_obj_ptrs)
    assert cfg.only_obj_ptrs_in_the_past_for_eval and cfg.no_obj_embed_spatial
    params = copy.deepcopy(jax.tree_util.tree_map(np.asarray, tiny128_params))
    params.pop("obj_ptr_tpos_proj")  # an identity without the projection
    head = params["sam_mask_decoder"]["pred_obj_score_head"]["layers"][2]
    head["bias"] = head["bias"] + 10.0
    want = _track(JaxVideoPredictor(JaxSAM2Model(params, jax_cfg)))
    model = build_sam2(path, device="cpu", state_dict=state_dict_from_params(params))
    got = _track(SAM2VideoPredictor(model))
    assert len(got) == len(want) == 2 * T + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert np.ptp(got[T]) > 0.05  # the last tracked frame carries network logits


def test_package_imports_without_cv2_and_yaml():
    """cv2 and PyYAML are imported only where a video file or a yaml is
    read: every module of the port imports without them."""
    import os
    import subprocess
    import sys

    code = ("import sys, importlib, pkgutil\n"
            "sys.modules['cv2'] = None\n"
            "sys.modules['yaml'] = None\n"
            "import sam2_opt_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "print(len(names))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 40
