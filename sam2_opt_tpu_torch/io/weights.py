"""Weight bridge: the JAX package's parameter tree -> the port's state_dict.

The JAX package stores the reference `sd["model"]` in its own layouts
(`sam2_opt_tpu/io/torch_convert.py:48-59`); this module inverts that:

- conv kernels:            HWIO -> OIHW
- conv-transpose kernels:  HWOI -> IOHW
- linear weights:          [in, out] -> [out, in]
- 4-D positional embeddings (pos_embed, pos_embed_window): NHWC -> NCHW
- embeddings / learned tokens / buffers: unchanged

The tree is a nested dict (int keys for module lists) of array-likes, e.g.
numpy arrays; keys flatten to the reference's dotted names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# 2-D "weight" tensors that are embeddings, stored untransposed
_EMBED_WEIGHT_RES = [re.compile(p) for p in (
    r"point_embeddings\.\d+\.weight$", r"not_a_point_embed\.weight$",
    r"no_mask_embed\.weight$", r"iou_token\.weight$", r"mask_tokens\.weight$",
    r"obj_score_token\.weight$")]
# 4-D parameters that are positional embeddings, not conv kernels
_NCHW_PARAM_RES = [re.compile(r"pos_embed$"), re.compile(r"pos_embed_window$")]


def _is_match(key: str, patterns) -> bool:
    return any(p.search(key) for p in patterns)


def flatten_params(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {dotted reference key: numpy array}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, key + "."))
        else:
            flat[key] = np.asarray(v)
    return flat


def to_torch_layout(key: str, value: np.ndarray) -> np.ndarray:
    """Inverse of the JAX package's `convert_tensor` for one tensor."""
    v = np.asarray(value)
    if _is_match(key, _NCHW_PARAM_RES):
        return np.transpose(v, (0, 3, 1, 2))
    if v.ndim == 4 and key.endswith("weight"):
        return np.transpose(v, (3, 2, 0, 1))
    if v.ndim == 2 and key.endswith("weight") and not _is_match(key, _EMBED_WEIGHT_RES):
        return np.transpose(v)
    return v


def state_dict_from_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's params tree -> a state_dict that loads strictly into
    `SAM2Base`, fp32. Any tree shaped like the params maps the same way:
    JAX gradients and optax's Adam moments (`mu`, `nu`) come out under the
    port's names and layouts, as the training tests compare them."""
    return {k: torch.from_numpy(np.array(to_torch_layout(k, v), np.float32))
            for k, v in flatten_params(params).items()}


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pt` checkpoint's `sd["model"]` (build_sam.py:164-174),
    already in the port's layout, as fp32."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd)
    return {k: v.float() for k, v in sd.items()}
