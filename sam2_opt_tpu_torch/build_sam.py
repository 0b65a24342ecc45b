"""Model and predictor builders (reference sam2/sam2/build_sam.py without
hydra); counterpart of `sam2_opt_tpu/build_sam.py`.

Reference config names such as "configs/sam2.1/sam2.1_hiera_l.yaml" map to
their variant; the path of a yaml file on disk is ingested field by field
(`io/hydra_config.py`). Everything runs on CUDA unless `device` says
otherwise.
"""

from __future__ import annotations

import os
import re
from typing import Optional

from sam2_opt_tpu_torch.models.model import SAM2Model, build_sam2 as _build_model


def _variant_from_config_name(name: str) -> str:
    m = re.search(r"hiera_(t|s|b\+|l)", name)
    return f"hiera_{m.group(1)}" if m else name


def build_sam2(config_or_variant: str = "hiera_l", ckpt_path: Optional[str] = None,
               seed: int = 0, device=None, **kwargs) -> SAM2Model:
    """Build the core model (reference build_sam2, build_sam.py:71-97) of a
    variant name, a reference config name or a reference yaml's path:
    weights from `ckpt_path` (a reference `.pt`), a given `state_dict`, or
    random from `seed`."""
    if config_or_variant.endswith((".yaml", ".yml")) and os.path.exists(config_or_variant):
        from sam2_opt_tpu_torch.io.hydra_config import config_from_yaml

        kwargs["cfg"] = config_from_yaml(config_or_variant)
    return _build_model(_variant_from_config_name(config_or_variant),
                        checkpoint_path=ckpt_path, seed=seed, device=device, **kwargs)


def build_sam2_image_predictor(config_or_variant: str = "hiera_l",
                               ckpt_path: Optional[str] = None, seed: int = 0, device=None,
                               **kwargs):
    """SAM2ImagePredictor on `build_sam2(...)`; other kwargs go to the
    predictor (mask_threshold, ...)."""
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor

    return SAM2ImagePredictor(build_sam2(config_or_variant, ckpt_path, seed=seed, device=device),
                              **kwargs)


def build_sam2_video_predictor(config_or_variant: str = "hiera_l",
                               ckpt_path: Optional[str] = None, seed: int = 0, device=None,
                               vos_optimized: bool = False, **kwargs):
    """The video predictor on `build_sam2(...)` (reference
    build_sam2_video_predictor, build_sam.py:100-141): fill_hole_area=8 and
    binarized click-frame masks for the memory encoder by default; other
    kwargs go to the predictor. `vos_optimized` selects the variant on CUDA
    graphs from the start (:113-117); otherwise SAM2_VERSION_TRACK selects
    the track: official (the default), legacy or dam4sam
    (`predictors/variants.py`)."""
    from sam2_opt_tpu_torch.predictors.variants import (
        SAM2VideoPredictorVOS,
        select_video_predictor_cls,
    )

    kwargs.setdefault("fill_hole_area", 8)
    cls = SAM2VideoPredictorVOS if vos_optimized else select_video_predictor_cls()
    return cls(build_sam2(config_or_variant, ckpt_path, seed=seed, device=device), **kwargs)
