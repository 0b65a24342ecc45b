"""Reference Hydra yaml -> SAM2Config (counterpart of
`sam2_opt_tpu/io/hydra_config.py`; the port imports nothing of the JAX
package).

The reference builds every model topology from Hydra yaml trees
(sam2/sam2/build_sam.py:90-97, configs/sam2.1/sam2.1_hiera_{t,s,b+,l}.yaml,
and the training yaml's `trainer.model` section in
configs/sam2.1_training/*.yaml). This module ingests them field by field, so
a custom reference yaml (a modified trunk, say) gives the equivalent
`SAM2Config`: `build_sam2("path/to.yaml")` builds it.

- Absent keys fall back to the REFERENCE constructor defaults
  (sam2_base_official.py:24-98, hieradet.py:169-199, image_encoder.py:45,
  transformer.py's Attention), not to this package's dataclass defaults, so
  a sparse yaml builds the model it builds in the reference. One of them
  differs from the JAX package: a missing `cross_attention.kv_in_dim` is
  the attention's `embedding_dim` (d_model), the reference's default, where
  the JAX loader takes 64.
- Structural choices the port fixes (RoPE downsample_rate 1, the
  depth-wise ConvNeXt fuser, sine position encodings) are checked: a yaml
  that deviates raises with the key's path.
- Every key is consumed, checked or on the ignore list (`_target_`,
  `dropout`, `compile_image_encoder`); any other raises, so nothing is
  dropped silently.
- `dynamic_multimask_via_stability` stays on, as the reference's
  `build_sam2(apply_postprocessing=True)` sets it (build_sam.py:81-88).

`config_to_yaml` writes a config back out in the reference's layout.
PyYAML is imported only when a yaml is read or written.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Tuple

from sam2_opt_tpu_torch.config import (
    FpnNeckConfig,
    HieraConfig,
    MemoryAttentionConfig,
    MemoryEncoderConfig,
    SAM2Config,
    _replace_dotted,
    model_config,
)

# keys that are legal in reference yamls but carry no information for this
# stack (instantiation targets, torch-compile flags, train-time dropout)
_IGNORED_LEAF_KEYS = {"_target_", "dropout", "compile_image_encoder"}

# SAM2Train-specific keys in training-yaml model sections
# (training/model/sam2.py:25-106) — split out for the trainer, not SAM2Config
_TRAIN_MODEL_KEYS = {
    "prob_to_use_pt_input_for_train",
    "prob_to_use_pt_input_for_eval",
    "prob_to_use_box_input_for_train",
    "prob_to_use_box_input_for_eval",
    "prob_to_sample_from_gt_for_train",
    "num_frames_to_correct_for_train",
    "num_frames_to_correct_for_eval",
    "rand_frames_to_correct_for_train",
    "add_all_frames_to_correct_as_cond",
    "num_init_cond_frames_for_train",
    "rand_init_cond_frames_for_train",
    "num_init_cond_frames_for_eval",
    "num_correction_pt_per_frame",
    "use_act_ckpt_iterative_pt_sampling",
    "forward_backbone_per_frame_for_eval",
    "freeze_image_encoder",
}

# reference SAM2Base constructor defaults (sam2_base_official.py:24-98) for
# every top-level flag a yaml may omit; SAM2Config defaults are the 2.1
# release values and would silently "upgrade" a sparse yaml otherwise
_SAM2BASE_DEFAULTS: Dict[str, Any] = dict(
    num_maskmem=7,
    image_size=512,
    backbone_stride=16,
    sigmoid_scale_for_mem_enc=1.0,
    sigmoid_bias_for_mem_enc=0.0,
    binarize_mask_from_pts_for_mem_enc=False,
    use_mask_input_as_output_without_sam=False,
    max_cond_frames_in_attn=-1,
    directly_add_no_mem_embed=False,
    use_high_res_features_in_sam=False,
    multimask_output_in_sam=False,
    multimask_min_pt_num=1,
    multimask_max_pt_num=1,
    multimask_output_for_tracking=False,
    use_multimask_token_for_obj_ptr=False,
    iou_prediction_use_sigmoid=False,
    memory_temporal_stride_for_eval=1,
    non_overlap_masks_for_mem_enc=False,
    use_obj_ptrs_in_encoder=False,
    max_obj_ptrs_in_encoder=16,
    add_tpos_enc_to_obj_ptrs=True,
    proj_tpos_enc_in_obj_ptrs=False,
    use_signed_tpos_enc_to_obj_ptrs=False,
    only_obj_ptrs_in_the_past_for_eval=False,
    pred_obj_scores=False,
    pred_obj_scores_mlp=False,
    fixed_no_obj_ptr=False,
    soft_no_obj_ptr=False,
    use_mlp_for_obj_ptr_proj=False,
    no_obj_embed_spatial=False,
)

# reference Hiera constructor defaults (hieradet.py:169-199)
_HIERA_DEFAULTS: Dict[str, Any] = dict(
    embed_dim=96,
    num_heads=1,
    drop_path_rate=0.0,
    q_pool=3,
    q_stride=(2, 2),
    stages=(2, 3, 16, 3),
    dim_mul=2.0,
    head_mul=2.0,
    window_pos_embed_bkg_spatial_size=(14, 14),
    window_spec=(8, 4, 14, 7),
    global_att_blocks=(12, 16, 20),
)


_REQUIRED = object()  # `_Node.take` without a default: the key must be there


class YamlConfigError(ValueError):
    """A reference yaml asked for something this loader cannot honor."""


def _interpolate(node, root):
    """Resolve OmegaConf-style `${a.b.c}` interpolations against the doc
    root (the training yaml's `${scratch.resolution}` etc.). Resolver-call
    forms like `${times:a,b}` are left untouched — they never appear inside
    model sections."""
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str):
        m = re.fullmatch(r"\$\{([A-Za-z0-9_.]+)\}", node)
        if m:
            cur = root
            for part in m.group(1).split("."):
                if not isinstance(cur, dict) or part not in cur:
                    raise YamlConfigError(
                        f"cannot resolve interpolation {node!r}"
                    )
                cur = cur[part]
            return _interpolate(cur, root)
    return node


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    if not isinstance(doc, dict):
        raise YamlConfigError(f"{path}: expected a mapping at top level")
    return _interpolate(doc, doc)


class _Node:
    """A yaml mapping with consumption tracking: every key must be taken
    (`take`/`expect`), recursed into (`child`), or ignored, else
    `finish()` raises with the unconsumed paths."""

    def __init__(self, data: dict, path: str):
        self.data = dict(data or {})
        self.path = path
        self._children = []
        for k in _IGNORED_LEAF_KEYS:
            self.data.pop(k, None)

    def take(self, key, default=_REQUIRED):
        if key in self.data:
            return self.data.pop(key)
        if default is _REQUIRED:
            raise YamlConfigError(f"{self.path}: missing required key {key!r}")
        return default

    def expect(self, key, allowed, default=None):
        """Consume a fixed-by-this-stack key; raise if the yaml deviates."""
        val = self.data.pop(key, default)
        if val is not None and val not in allowed:
            raise YamlConfigError(
                f"{self.path}.{key}={val!r} is not supported "
                f"(supported: {allowed})"
            )
        return val

    def child(self, key, required=True) -> "_Node":
        sub = self.data.pop(key, None)
        if sub is None:
            if required:
                raise YamlConfigError(
                    f"{self.path}: missing required section {key!r}"
                )
            sub = {}
        node = _Node(sub, f"{self.path}.{key}")
        self._children.append(node)
        return node

    def leftovers(self):
        out = [f"{self.path}.{k}" for k in self.data]
        for c in self._children:
            out.extend(c.leftovers())
        return out

    def finish(self):
        left = self.leftovers()
        if left:
            raise YamlConfigError(
                "unrecognized yaml keys (refusing to drop them silently): "
                + ", ".join(sorted(left))
            )


def _tup(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _sine_pe_feats(node: _Node) -> int:
    """Consume a position_encoding block; only sine PEs with the reference
    normalize/scale/temperature are implemented (ops/posenc.py)."""
    feats = node.take("num_pos_feats")
    node.expect("normalize", (True,), default=True)
    node.expect("scale", (), default=None)  # only null accepted
    node.expect("temperature", (10000,), default=10000)
    return int(feats)


def _trunk_from_node(t: _Node) -> HieraConfig:
    vals = dict(_HIERA_DEFAULTS)
    for key in vals:
        if key in t.data:
            vals[key] = _tup(t.take(key))
    t.expect("return_interm_layers", (True,), default=True)
    t.expect("weights_path", (), default=None)
    return HieraConfig(
        embed_dim=int(vals["embed_dim"]),
        num_heads=int(vals["num_heads"]),
        stages=_tup(vals["stages"]),
        global_att_blocks=_tup(vals["global_att_blocks"]),
        window_pos_embed_bkg_spatial_size=_tup(
            vals["window_pos_embed_bkg_spatial_size"]
        ),
        window_spec=_tup(vals["window_spec"]),
        q_pool=int(vals["q_pool"]),
        q_stride=_tup(vals["q_stride"]),
        dim_mul=float(vals["dim_mul"]),
        head_mul=float(vals["head_mul"]),
        drop_path_rate=float(vals["drop_path_rate"]),
    )


def _neck_from_node(n: _Node, trunk: HieraConfig) -> FpnNeckConfig:
    pos_feats = _sine_pe_feats(n.child("position_encoding"))
    d_model = int(n.take("d_model"))
    channels = _tup(n.take("backbone_channel_list"))
    if channels != trunk.channel_list:
        raise YamlConfigError(
            f"neck.backbone_channel_list {channels} does not match the "
            f"trunk's stage dims {trunk.channel_list}"
        )
    top_down = n.take("fpn_top_down_levels", default=None)
    if top_down is None:  # reference FpnNeck default: all levels
        top_down = tuple(range(len(channels)))
    interp = n.take("fpn_interp_model", default="bilinear")
    fuse = n.take("fuse_type", default="sum")
    n.expect("kernel_size", (1,), default=1)
    n.expect("stride", (1,), default=1)
    n.expect("padding", (0,), default=0)
    return FpnNeckConfig(
        d_model=d_model,
        backbone_channel_list=channels,
        fpn_top_down_levels=_tup(top_down),
        fpn_interp_model=str(interp),
        fuse_type=str(fuse),
        pos_num_feats=pos_feats,
    )


def _memattn_from_node(ma: _Node) -> MemoryAttentionConfig:
    d_model = int(ma.take("d_model"))
    num_layers = int(ma.take("num_layers"))
    pos_at_input = bool(ma.take("pos_enc_at_input", default=True))
    layer = ma.child("layer")
    act = str(layer.take("activation", default="relu"))
    ffn = int(layer.take("dim_feedforward"))
    pos_at_attn = bool(layer.take("pos_enc_at_attn", default=False))
    pos_at_keys = bool(layer.take("pos_enc_at_cross_attn_keys", default=True))
    pos_at_queries = bool(
        layer.take("pos_enc_at_cross_attn_queries", default=False)
    )
    layer.expect("d_model", (d_model,), default=d_model)

    def attn(node: _Node, cross: bool):
        theta = float(node.take("rope_theta", default=10000.0))
        feat_sizes = _tup(node.take("feat_sizes", default=(64, 64)))
        heads = int(node.take("num_heads"))
        node.expect("embedding_dim", (d_model,), default=d_model)
        node.expect("downsample_rate", (1,), default=1)
        kv_in = node.take("kv_in_dim", default=None)
        if cross:
            node.expect("rope_k_repeat", (True,), default=True)
        else:
            node.expect("rope_k_repeat", (False,), default=False)
        return theta, feat_sizes, heads, kv_in

    s_theta, s_feats, s_heads, s_kv = attn(layer.child("self_attention"), False)
    c_theta, c_feats, c_heads, c_kv = attn(layer.child("cross_attention"), True)
    if (s_theta, s_feats, s_heads) != (c_theta, c_feats, c_heads):
        raise YamlConfigError(
            "self_attention and cross_attention RoPE settings differ: the "
            "memory attention shares one RoPE table"
        )
    if s_kv is not None:
        raise YamlConfigError("self_attention.kv_in_dim is not supported")
    return MemoryAttentionConfig(
        d_model=d_model,
        num_layers=num_layers,
        dim_feedforward=ffn,
        num_heads=s_heads,
        rope_theta=s_theta,
        rope_feat_sizes=s_feats,
        kv_in_dim=int(c_kv if c_kv is not None else d_model),
        pos_enc_at_input=pos_at_input,
        pos_enc_at_attn=pos_at_attn,
        pos_enc_at_cross_attn_keys=pos_at_keys,
        pos_enc_at_cross_attn_queries=pos_at_queries,
        activation=act,
    )


def _memenc_from_node(me: _Node) -> MemoryEncoderConfig:
    out_dim = int(me.take("out_dim"))
    pos_feats = _sine_pe_feats(me.child("position_encoding"))
    down = me.child("mask_downsampler")
    kernel = int(down.take("kernel_size", default=4))
    stride = int(down.take("stride", default=4))
    padding = int(down.take("padding", default=0))
    down.expect("total_stride", (16,), default=16)
    fuser = me.child("fuser")
    num_layers = int(fuser.take("num_layers"))
    cx = fuser.child("layer")
    in_dim = int(cx.take("dim", default=256))
    cx_kernel = int(cx.take("kernel_size", default=7))
    cx_padding = int(cx.take("padding", default=3))
    cx.expect("use_dwconv", (True,), default=True)
    lsi = cx.take("layer_scale_init_value", default=1e-6)
    if abs(float(lsi) - 1e-6) > 1e-12:
        raise YamlConfigError(
            f"CXBlock layer_scale_init_value={lsi} != 1e-6: the converter "
            "loads gamma from checkpoints, but random init pins 1e-6"
        )
    return MemoryEncoderConfig(
        out_dim=out_dim,
        in_dim=in_dim,
        mask_downsampler_kernel=kernel,
        mask_downsampler_stride=stride,
        mask_downsampler_padding=padding,
        fuser_num_layers=num_layers,
        cx_kernel_size=cx_kernel,
        cx_padding=cx_padding,
        pos_num_feats=pos_feats,
    )


def config_from_model_node(model: dict, path: str = "model"
                           ) -> Tuple[SAM2Config, Dict[str, Any]]:
    """Map a reference yaml `model:` mapping onto (SAM2Config, train_knobs).

    `train_knobs` holds the SAM2Train-only keys of training-yaml model
    sections (prompt-simulation probabilities etc.), keyed by their
    reference names — empty for inference yamls.
    """
    m = _Node(model, path)
    train_knobs = {
        k: m.take(k) for k in list(m.data) if k in _TRAIN_MODEL_KEYS
    }

    enc = m.child("image_encoder")
    scalp = int(enc.take("scalp", default=0))
    trunk = _trunk_from_node(enc.child("trunk"))
    neck = _neck_from_node(enc.child("neck"), trunk)
    memattn = _memattn_from_node(m.child("memory_attention"))
    memenc = _memenc_from_node(m.child("memory_encoder"))

    flags = dict(_SAM2BASE_DEFAULTS)
    for key in list(flags):
        if key in m.data:
            flags[key] = m.take(key)
    m.expect("sam_mask_decoder_extra_args", (), default=None)
    m.finish()

    cfg = SAM2Config(
        trunk=trunk,
        neck=neck,
        memory_attention=memattn,
        memory_encoder=memenc,
        scalp=scalp,
        mem_dim=memenc.out_dim,
        hidden_dim=memattn.d_model,
        **{k: type(_SAM2BASE_DEFAULTS[k])(v) for k, v in flags.items()},
    )
    # keep the memory-attention RoPE table in sync with the feature grid
    # (the reference recomputes cos/sin tables per seq len at runtime;
    # config.model_config applies the same rule for its variants)
    grid = cfg.image_size // cfg.backbone_stride
    if cfg.memory_attention.rope_feat_sizes != (grid, grid):
        cfg = dataclasses.replace(
            cfg,
            memory_attention=dataclasses.replace(
                cfg.memory_attention, rope_feat_sizes=(grid, grid)
            ),
        )
    return cfg, train_knobs


def config_from_yaml(path: str) -> SAM2Config:
    """SAM2Config from a reference Hydra yaml — inference configs
    (`model:` at top level, e.g. configs/sam2.1/sam2.1_hiera_l.yaml) and
    training configs (`trainer.model:`, e.g.
    configs/sam2.1_training/sam2.1_hiera_b+_MOSE_finetune.yaml)."""
    cfg, _ = config_and_train_knobs_from_yaml(path)
    return cfg


def config_and_train_knobs_from_yaml(path: str
                                     ) -> Tuple[SAM2Config, Dict[str, Any]]:
    doc = load_yaml(path)
    if "model" in doc:
        node, node_path = doc["model"], "model"
    elif "trainer" in doc and isinstance(doc["trainer"], dict) \
            and "model" in doc["trainer"]:
        node, node_path = doc["trainer"]["model"], "trainer.model"
    else:
        raise YamlConfigError(
            f"{path}: no `model:` or `trainer.model:` section found"
        )
    tgt = str(node.get("_target_", ""))
    if tgt and not tgt.rsplit(".", 1)[-1] in ("SAM2Base", "SAM2Train",
                                              "SAM2VideoPredictor",
                                              "SAM2VideoPredictorVOS"):
        raise YamlConfigError(f"unsupported model _target_: {tgt}")
    return config_from_model_node(node, node_path)


def resolve_config(name_or_path: str, **overrides) -> SAM2Config:
    """Variant name, reference config name or yaml path -> SAM2Config.

    "hiera_l"-style names and reference resource names such as
    "configs/sam2.1/sam2.1_hiera_l.yaml" map to their variant; a yaml file
    on disk is ingested field by field. `overrides` are dotted field paths
    ("memory_attention.num_layers")."""
    if name_or_path.endswith((".yaml", ".yml")) and os.path.exists(name_or_path):
        cfg = config_from_yaml(name_or_path)
        for key, value in overrides.items():
            cfg = _replace_dotted(cfg, key, value)
        return cfg
    m = re.search(r"hiera_(t|s|b\+|l)", name_or_path)
    return model_config(f"hiera_{m.group(1)}" if m else name_or_path, **overrides)


def _sine_pe(num_pos_feats: int) -> Dict[str, Any]:
    return {"_target_": "sam2.modeling.position_encoding.PositionEmbeddingSine",
            "num_pos_feats": num_pos_feats, "normalize": True, "scale": None,
            "temperature": 10000}


def _rope_attention(ma: MemoryAttentionConfig, cross: bool) -> Dict[str, Any]:
    out = {"_target_": "sam2.modeling.sam.transformer.RoPEAttention",
           "rope_theta": ma.rope_theta, "feat_sizes": list(ma.rope_feat_sizes),
           "embedding_dim": ma.d_model, "num_heads": ma.num_heads, "downsample_rate": 1,
           "dropout": 0.1}
    if cross:
        out.update(rope_k_repeat=True, kv_in_dim=ma.kv_in_dim)
    return out


def config_to_yaml(cfg: SAM2Config) -> str:
    """`cfg` as a reference inference yaml (the layout of
    configs/sam2.1/sam2.1_hiera_*.yaml, every field the loader reads
    written out), a starting point for a custom topology.
    `config_from_yaml` reads it back to `cfg`; a config that differs in a
    field the reference's yaml does not carry (the SAM heads' sizes, the
    patch embedding) raises."""
    import yaml

    t, n, ma, me = cfg.trunk, cfg.neck, cfg.memory_attention, cfg.memory_encoder
    model = {
        "_target_": "sam2.modeling.sam2_base.SAM2Base",
        "image_encoder": {
            "_target_": "sam2.modeling.backbones.image_encoder.ImageEncoder",
            "scalp": cfg.scalp,
            "trunk": {
                "_target_": "sam2.modeling.backbones.hieradet.Hiera",
                **{k: list(getattr(t, k)) if isinstance(getattr(t, k), tuple) else getattr(t, k)
                   for k in _HIERA_DEFAULTS},
            },
            "neck": {
                "_target_": "sam2.modeling.backbones.image_encoder.FpnNeck",
                "position_encoding": _sine_pe(n.pos_num_feats),
                "d_model": n.d_model,
                "backbone_channel_list": list(n.backbone_channel_list),
                "fpn_top_down_levels": list(n.fpn_top_down_levels),
                "fpn_interp_model": n.fpn_interp_model,
                "fuse_type": n.fuse_type,
            },
        },
        "memory_attention": {
            "_target_": "sam2.modeling.memory_attention.MemoryAttention",
            "d_model": ma.d_model,
            "pos_enc_at_input": ma.pos_enc_at_input,
            "layer": {
                "_target_": "sam2.modeling.memory_attention.MemoryAttentionLayer",
                "activation": ma.activation,
                "dim_feedforward": ma.dim_feedforward,
                "dropout": 0.1,
                "pos_enc_at_attn": ma.pos_enc_at_attn,
                "self_attention": _rope_attention(ma, cross=False),
                "d_model": ma.d_model,
                "pos_enc_at_cross_attn_keys": ma.pos_enc_at_cross_attn_keys,
                "pos_enc_at_cross_attn_queries": ma.pos_enc_at_cross_attn_queries,
                "cross_attention": _rope_attention(ma, cross=True),
            },
            "num_layers": ma.num_layers,
        },
        "memory_encoder": {
            "_target_": "sam2.modeling.memory_encoder.MemoryEncoder",
            "out_dim": me.out_dim,
            "position_encoding": _sine_pe(me.pos_num_feats),
            "mask_downsampler": {
                "_target_": "sam2.modeling.memory_encoder.MaskDownSampler",
                "kernel_size": me.mask_downsampler_kernel,
                "stride": me.mask_downsampler_stride,
                "padding": me.mask_downsampler_padding,
            },
            "fuser": {
                "_target_": "sam2.modeling.memory_encoder.Fuser",
                "layer": {
                    "_target_": "sam2.modeling.memory_encoder.CXBlock",
                    "dim": me.in_dim, "kernel_size": me.cx_kernel_size,
                    "padding": me.cx_padding, "layer_scale_init_value": 1e-6,
                    "use_dwconv": True,
                },
                "num_layers": me.fuser_num_layers,
            },
        },
        **{k: getattr(cfg, k) for k in _SAM2BASE_DEFAULTS},
    }
    back, _ = config_from_model_node(yaml.safe_load(yaml.safe_dump(model)))
    if back != cfg:
        diff = [f.name for f in dataclasses.fields(cfg)
                if getattr(back, f.name) != getattr(cfg, f.name)]
        raise YamlConfigError(f"a reference yaml cannot carry these fields of the config: {diff}")
    return yaml.safe_dump({"model": model}, sort_keys=False)
