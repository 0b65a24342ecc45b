"""Model configuration for the PyTorch SAM2 port.

A copy of `sam2_opt_tpu/config.py` (the port imports nothing of the JAX
package): the reference's Hydra yaml tree (reference:
sam2/sam2/configs/sam2.1/sam2.1_hiera_{t,s,b+,l}.yaml) as plain dataclasses.
`tests/test_torch_weights.py` holds the two copies equal field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    """Hierarchical ViT trunk (reference: sam2/sam2/modeling/backbones/hieradet.py:169)."""

    embed_dim: int = 96
    num_heads: int = 1
    stages: Tuple[int, ...] = (1, 2, 7, 2)
    global_att_blocks: Tuple[int, ...] = (5, 7, 9)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (7, 7)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    q_pool: int = 3
    q_stride: Tuple[int, int] = (2, 2)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    patch_kernel: Tuple[int, int] = (7, 7)
    patch_stride: Tuple[int, int] = (4, 4)
    patch_padding: Tuple[int, int] = (3, 3)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.0
    # Training-memory knob: under autograd each trunk block runs in
    # torch.utils.checkpoint, so the backward recomputes one block at a time.
    remat_blocks: bool = False

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        return tuple(sum(self.stages[: i + 1]) - 1 for i in range(len(self.stages)))

    @property
    def q_pool_blocks(self) -> Tuple[int, ...]:
        return tuple(x + 1 for x in self.stage_ends[:-1])[: self.q_pool]

    def block_plan(self):
        """Static per-block plan: (dim, dim_out, num_heads, window_size, has_q_pool).

        Mirrors the construction loop of the reference Hiera
        (hieradet.py:232-260): the window size lags the stage change by one
        block, global-attention blocks get window_size 0.
        """
        plan = []
        embed_dim = self.embed_dim
        num_heads = self.num_heads
        cur_stage = 1
        for i in range(self.depth):
            dim_out = embed_dim
            window_size = self.window_spec[cur_stage - 1]
            if i in self.global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(embed_dim * self.dim_mul)
                num_heads = int(num_heads * self.head_mul)
                cur_stage += 1
            plan.append(
                dict(
                    dim=embed_dim,
                    dim_out=dim_out,
                    num_heads=num_heads,
                    window_size=window_size,
                    q_pool=i in self.q_pool_blocks,
                )
            )
            embed_dim = dim_out
        return plan

    @property
    def channel_list(self) -> Tuple[int, ...]:
        """Channels at each stage end, highest-dim (lowest-res) first."""
        plan = self.block_plan()
        return tuple(plan[i]["dim_out"] for i in self.stage_ends[::-1])


@dataclasses.dataclass(frozen=True)
class FpnNeckConfig:
    """FPN neck (reference: sam2/sam2/modeling/backbones/image_encoder.py:45)."""

    d_model: int = 256
    backbone_channel_list: Tuple[int, ...] = (768, 384, 192, 96)
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    fpn_interp_model: str = "nearest"
    fuse_type: str = "sum"
    pos_num_feats: int = 256  # PositionEmbeddingSine num_pos_feats


@dataclasses.dataclass(frozen=True)
class MemoryAttentionConfig:
    """4-layer memory attention (reference: sam2/sam2/modeling/memory_attention.py)."""

    d_model: int = 256
    num_layers: int = 4
    dim_feedforward: int = 2048
    num_heads: int = 1
    rope_theta: float = 10000.0
    rope_feat_sizes: Tuple[int, int] = (64, 64)
    kv_in_dim: int = 64
    pos_enc_at_input: bool = True
    pos_enc_at_attn: bool = False
    pos_enc_at_cross_attn_keys: bool = True
    pos_enc_at_cross_attn_queries: bool = False
    activation: str = "relu"


@dataclasses.dataclass(frozen=True)
class MemoryEncoderConfig:
    """Mask-downsampler + ConvNeXt fuser (reference: sam2/sam2/modeling/memory_encoder.py)."""

    out_dim: int = 64
    in_dim: int = 256
    mask_downsampler_kernel: int = 3
    mask_downsampler_stride: int = 2
    mask_downsampler_padding: int = 1
    mask_total_stride: int = 16
    fuser_num_layers: int = 2
    cx_kernel_size: int = 7
    cx_padding: int = 3
    pos_num_feats: int = 64


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    """Full model config (reference: sam2/sam2/modeling/sam2_base_official.py:24-98
    populated from sam2/sam2/configs/sam2.1/*.yaml)."""

    trunk: HieraConfig = dataclasses.field(default_factory=HieraConfig)
    neck: FpnNeckConfig = dataclasses.field(default_factory=FpnNeckConfig)
    memory_attention: MemoryAttentionConfig = dataclasses.field(
        default_factory=MemoryAttentionConfig
    )
    memory_encoder: MemoryEncoderConfig = dataclasses.field(
        default_factory=MemoryEncoderConfig
    )

    scalp: int = 1
    image_size: int = 1024
    backbone_stride: int = 16
    num_maskmem: int = 7
    mem_dim: int = 64
    hidden_dim: int = 256

    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    binarize_mask_from_pts_for_mem_enc: bool = False
    use_mask_input_as_output_without_sam: bool = True
    max_cond_frames_in_attn: int = -1
    directly_add_no_mem_embed: bool = True
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    iou_prediction_use_sigmoid: bool = True
    memory_temporal_stride_for_eval: int = 1
    non_overlap_masks_for_mem_enc: bool = False
    use_obj_ptrs_in_encoder: bool = True
    max_obj_ptrs_in_encoder: int = 16
    add_tpos_enc_to_obj_ptrs: bool = True
    proj_tpos_enc_in_obj_ptrs: bool = True
    use_signed_tpos_enc_to_obj_ptrs: bool = True
    only_obj_ptrs_in_the_past_for_eval: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    soft_no_obj_ptr: bool = False
    use_mlp_for_obj_ptr_proj: bool = True
    no_obj_embed_spatial: bool = True

    # SAM heads (reference sam2_base_official.py:288-336; build_sam.py:81-88
    # enables the dynamic-stability fallback for all released checkpoints)
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98
    num_multimask_outputs: int = 3
    sam_mask_decoder_depth: int = 2
    sam_mask_decoder_mlp_dim: int = 2048
    sam_mask_decoder_num_heads: int = 8
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    mask_in_chans: int = 16

    # Video-predictor overrides (reference build_sam.py:110-131)
    fill_hole_area: int = 0

    @property
    def image_embedding_size(self) -> int:
        return self.image_size // self.backbone_stride

    @property
    def num_feature_levels(self) -> int:
        return 3 if self.use_high_res_features_in_sam else 1

    @property
    def num_obj_ptr_tokens_per_ptr(self) -> int:
        return self.hidden_dim // self.mem_dim

    @property
    def max_obj_ptr_tokens(self) -> int:
        return self.max_obj_ptrs_in_encoder * self.num_obj_ptr_tokens_per_ptr


_HIERA_VARIANTS = {
    "hiera_t": HieraConfig(
        embed_dim=96,
        num_heads=1,
        stages=(1, 2, 7, 2),
        global_att_blocks=(5, 7, 9),
        window_pos_embed_bkg_spatial_size=(7, 7),
        window_spec=(8, 4, 14, 7),
    ),
    "hiera_s": HieraConfig(
        embed_dim=96,
        num_heads=1,
        stages=(1, 2, 11, 2),
        global_att_blocks=(7, 10, 13),
        window_pos_embed_bkg_spatial_size=(7, 7),
        window_spec=(8, 4, 14, 7),
    ),
    "hiera_b+": HieraConfig(
        embed_dim=112,
        num_heads=2,
        stages=(2, 3, 16, 3),
        global_att_blocks=(12, 16, 20),
        window_pos_embed_bkg_spatial_size=(14, 14),
        window_spec=(8, 4, 14, 7),
    ),
    "hiera_l": HieraConfig(
        embed_dim=144,
        num_heads=2,
        stages=(2, 6, 36, 4),
        global_att_blocks=(23, 33, 43),
        window_pos_embed_bkg_spatial_size=(7, 7),
        window_spec=(8, 4, 16, 8),
    ),
}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """SAM's plain ViT image encoder (reference
    segment_anything/modeling/image_encoder.py `ImageEncoderViT`, as
    `build_sam.py` builds it): patch embedding, a learned absolute position
    embedding, blocks with windowed (zero-padded) or global attention with a
    qkv bias and a decomposed relative-position bias, LayerNorms of eps 1e-6,
    and a two-convolution neck."""

    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    patch_size: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class SamViTConfig:
    """Segment Anything (reference segment_anything/build_sam.py
    `_build_sam`): the ViT encoder, then the port's prompt encoder and mask
    decoder with SAM's settings, which are the SAM 2 modules' flags turned
    off (no object-score token, no high-resolution features, no IoU sigmoid,
    no stability fallback), and SAM's prompt layout: no padding point when
    a box is given. A config of its own: `SAM2Config` stays the JAX
    package's copy."""

    encoder: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    image_size: int = 1024
    backbone_stride: int = 16
    hidden_dim: int = 256  # prompt_embed_dim
    mask_in_chans: int = 16
    num_multimask_outputs: int = 3
    sam_mask_decoder_depth: int = 2
    sam_mask_decoder_mlp_dim: int = 2048
    sam_mask_decoder_num_heads: int = 8
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    # SamPredictor's normalization, on the 0-255 scale (sam.py:27-28)
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    # the shared SAM heads' flags at SAM's values
    pred_obj_scores: bool = False
    use_high_res_features_in_sam: bool = False
    iou_prediction_use_sigmoid: bool = False
    dynamic_multimask_via_stability: bool = False
    use_multimask_token_for_obj_ptr: bool = False

    @property
    def image_embedding_size(self) -> int:
        return self.image_size // self.backbone_stride


_VIT_VARIANTS = {  # segment_anything/build_sam.py build_sam_vit_{h,l,b}
    "vit_h": ViTConfig(embed_dim=1280, depth=32, num_heads=16,
                       global_attn_indexes=(7, 15, 23, 31)),
    "vit_l": ViTConfig(embed_dim=1024, depth=24, num_heads=16,
                       global_attn_indexes=(5, 11, 17, 23)),
    "vit_b": ViTConfig(embed_dim=768, depth=12, num_heads=12,
                       global_attn_indexes=(2, 5, 8, 11)),
}


def is_vit_variant(variant: str) -> bool:
    return variant in _VIT_VARIANTS


def sam_vit_config(variant: str = "vit_h", **overrides) -> SamViTConfig:
    """SAM's config for "vit_h", "vit_l" or "vit_b"; "encoder.<field>"
    overrides change the encoder, other keys the top level."""
    if variant not in _VIT_VARIANTS:
        raise ValueError(f"unknown SAM ViT variant {variant!r}")
    enc = {k[len("encoder."):]: overrides.pop(k) for k in list(overrides)
           if k.startswith("encoder.")}
    encoder = dataclasses.replace(_VIT_VARIANTS[variant], **enc)
    return SamViTConfig(encoder=encoder, backbone_stride=encoder.patch_size, **overrides)


def _replace_dotted(obj, key: str, value):
    """dataclasses.replace through a dotted field path."""
    head, _, rest = key.partition(".")
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(
        obj, **{head: _replace_dotted(getattr(obj, head), rest, value)}
    )


def model_config(variant: str = "hiera_l", **overrides) -> SAM2Config:
    """Build a SAM2.1 config for a named Hiera variant.

    Accepted names: "hiera_t"/"tiny", "hiera_s"/"small", "hiera_b+"/"base_plus",
    "hiera_l"/"large".
    """
    alias = {
        "tiny": "hiera_t",
        "t": "hiera_t",
        "small": "hiera_s",
        "s": "hiera_s",
        "base_plus": "hiera_b+",
        "b+": "hiera_b+",
        "large": "hiera_l",
        "l": "hiera_l",
    }
    variant = alias.get(variant, variant)
    if variant not in _HIERA_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    trunk = _HIERA_VARIANTS[variant]
    # dotted overrides ("trunk.stages", "memory_attention.num_layers", ...) —
    # the role hydra CLI overrides play in the reference train.py (its yaml
    # configs are flat hydra trees). trunk.* applies before the neck is
    # derived so backbone_channel_list tracks the overridden trunk.
    trunk_over = {
        k[len("trunk."):]: overrides.pop(k)
        for k in list(overrides) if k.startswith("trunk.")
    }
    if trunk_over:
        trunk = dataclasses.replace(trunk, **trunk_over)
    nested = {k: overrides.pop(k) for k in list(overrides) if "." in k}
    neck = FpnNeckConfig(backbone_channel_list=tuple(trunk.channel_list))
    cfg = SAM2Config(trunk=trunk, neck=neck, **overrides)
    for key, value in nested.items():
        cfg = _replace_dotted(cfg, key, value)
    # keep the memory-attention RoPE table in sync with the feature grid when
    # image_size is overridden (e.g. tiny shapes in multi-chip dry runs) —
    # unless the caller pinned rope_feat_sizes explicitly
    grid = cfg.image_size // cfg.backbone_stride
    if ("memory_attention.rope_feat_sizes" not in nested
            and cfg.memory_attention.rope_feat_sizes != (grid, grid)):
        cfg = dataclasses.replace(
            cfg,
            memory_attention=dataclasses.replace(
                cfg.memory_attention, rope_feat_sizes=(grid, grid)
            ),
        )
    return cfg
