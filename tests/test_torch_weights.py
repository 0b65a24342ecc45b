"""The port's config, parameter tree and imports against the JAX package.

- `sam2_opt_tpu_torch.config.model_config` equals the JAX package's field by
  field for every variant;
- the weight bridge (io/weights.py) turns the JAX parameter tree into exactly
  the port model's state_dict keys and shapes, for every variant (shapes from
  `jax.eval_shape`, the port model on the `meta` device: nothing large is
  allocated);
- no file of the port, nor chip_smoke.py, imports jax or sam2_opt_tpu.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sam2_opt_tpu.config import model_config as jax_model_config
from sam2_opt_tpu.models.init import init_params as jax_init_params
from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.io import weights
from sam2_opt_tpu_torch.models.sam2_base import SAM2Base

torch.set_num_threads(2)

VARIANTS = ["hiera_t", "hiera_s", "hiera_b+", "hiera_l"]
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_config_matches_jax(variant):
    assert dataclasses.asdict(model_config(variant)) == dataclasses.asdict(
        jax_model_config(variant))


@pytest.mark.parametrize("variant", VARIANTS)
def test_bridge_keys_and_shapes_match_state_dict(variant):
    cfg = jax_model_config(variant)
    spec = jax.eval_shape(lambda key: jax_init_params(cfg, key), jax.random.PRNGKey(0))
    flat = weights.flatten_params(jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), spec))
    bridged = {k: weights.to_torch_layout(k, v).shape for k, v in flat.items()}
    with torch.device("meta"):
        module = SAM2Base(model_config(variant))
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert sorted(bridged) == sorted(expected)
    mismatched = [(k, bridged[k], expected[k]) for k in expected if bridged[k] != expected[k]]
    assert not mismatched, mismatched[:5]


def test_bridge_loads_strictly_with_values(tiny128_cfg, tiny128_params):
    """Values land transposed where they must: a linear, a conv, a
    conv-transpose, a positional embedding, an embedding, the memory
    encoder's depthwise conv and the temporal slot embedding."""
    sd = weights.state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    module = SAM2Base(model_config("hiera_t", image_size=128))
    module.load_state_dict(sd, strict=True)
    p = tiny128_params
    np.testing.assert_array_equal(
        module.image_encoder.trunk.blocks[0].attn.qkv.weight.detach().numpy(),
        np.asarray(p["image_encoder"]["trunk"]["blocks"][0]["attn"]["qkv"]["weight"]).T)
    np.testing.assert_array_equal(
        module.image_encoder.trunk.patch_embed.proj.weight.detach().numpy(),
        np.asarray(p["image_encoder"]["trunk"]["patch_embed"]["proj"]["weight"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        module.sam_mask_decoder.output_upscaling[0].weight.detach().numpy(),
        np.asarray(p["sam_mask_decoder"]["output_upscaling"][0]["weight"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        module.image_encoder.trunk.pos_embed.detach().numpy(),
        np.asarray(p["image_encoder"]["trunk"]["pos_embed"]).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(
        module.sam_mask_decoder.mask_tokens.weight.detach().numpy(),
        np.asarray(p["sam_mask_decoder"]["mask_tokens"]["weight"]))
    # the two memory tensors off the plain rules: the depthwise conv (HWIO
    # [7,7,1,256] -> [256,1,7,7]) and the temporal slot embedding (unchanged)
    np.testing.assert_array_equal(
        module.memory_encoder.fuser.layers[0].dwconv.weight.detach().numpy(),
        np.asarray(p["memory_encoder"]["fuser"]["layers"][0]["dwconv"]["weight"])
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(module.maskmem_tpos_enc.detach().numpy(),
                                  np.asarray(p["maskmem_tpos_enc"]))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "sam2_opt_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "sam2_opt_tpu")]
    assert not bad, bad
