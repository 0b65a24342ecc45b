"""The Hiera trunk's opt-in kernel routes in the PyTorch port against the
JAX package's, on the same weights (the JAX `tiny128_params` through the
weight bridge) and the same 128² input, on the CPU.

Two settings of the JAX package's switches, in fp32 and bf16:
- W1: `SAM2_TPU_WINDOW_KERNEL=1`, `SAM2_TPU_FLASH_WINDOW_MIN=64`,
  `SAM2_TPU_FUSED_MLP=1` (K6 on the split route, K5 in `flash_or_sdpa`, K8);
- W2: `SAM2_TPU_PACKED_WINDOW=256`, `SAM2_TPU_FUSED_MLP=1` (K7, K8).
The JAX side runs with `SAM2_TPU_FLASH=1` (the port routes by device and
counts that gate as on), its K5 in interpret mode as
`tests/test_flash_attention.py:147-151` runs it, and is traced anew for
each setting (JAX reads the switches at trace time). Each wrapper's calls
are counted on both sides and must equal what the block plan gives.
Tolerances: fp32 1e-4 of the output's scale (the frameworks sum in other
orders); bf16 3e-2 of max |out| (bf16 roundings at other places, and the
JAX bf16 trunk's space-to-depth patch embed).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2_opt_tpu_torch.kernels.window_attention as port_wa
from sam2_opt_tpu.kernels import fused_mlp as jax_fm
from sam2_opt_tpu.kernels import window_attention as jax_wa
from sam2_opt_tpu.models import hiera as jax_hiera
from sam2_opt_tpu_torch.config import model_config
from sam2_opt_tpu_torch.io.weights import state_dict_from_params
from sam2_opt_tpu_torch.models import hiera as port_hiera
from sam2_opt_tpu_torch.models import sam2_base as base

torch.set_num_threads(2)

SETTINGS = {
    "W1": {"SAM2_TPU_WINDOW_KERNEL": "1", "SAM2_TPU_FLASH_WINDOW_MIN": "64",
           "SAM2_TPU_FUSED_MLP": "1"},
    "W2": {"SAM2_TPU_PACKED_WINDOW": "256", "SAM2_TPU_FUSED_MLP": "1"},
}
SWITCHES = ("SAM2_TPU_WINDOW_KERNEL", "SAM2_TPU_FLASH_WINDOW_MIN", "SAM2_TPU_FUSED_MLP",
            "SAM2_TPU_PACKED_WINDOW", "SAM2_TPU_SPLIT_WINDOW_MIN")


def expected_calls(plan, env, bf16, size):
    """Calls per trunk pass of K5, K6, K7 and K8, from the block plan and the
    JAX package's routing rules (models/hiera.py:221-231, 274-275,
    ops/common.py:250-256): bf16 windows of S tokens without q-pool go to K7
    if S <= PACKED_WINDOW, else to the split route if SPLIT_WINDOW_MIN <= S
    <= 1024, which runs K6 from FLASH_WINDOW_MIN up; the rest reach
    flash_or_sdpa, where K5 takes equal q and kv lengths up to 1024 under
    WINDOW_KERNEL; K8 takes every bf16 block MLP. `size` is the stage-1 map
    side; q-pool halves it."""
    packed = int(env.get("SAM2_TPU_PACKED_WINDOW", 0))
    flash_min = int(env.get("SAM2_TPU_FLASH_WINDOW_MIN", 0)) or 1 << 30
    split_min = 64
    calls = {"K5": 0, "K6": 0, "K7": 0, "K8": 0}
    for spec in plan:
        ws = spec["window_size"]
        S = ws * ws if ws > 0 else size * size
        if spec["q_pool"]:
            size //= 2
        elif bf16 and S <= packed:
            calls["K7"] += 1
        elif bf16 and split_min <= S <= 1024:
            calls["K6"] += S >= flash_min
        elif env.get("SAM2_TPU_WINDOW_KERNEL") == "1" and S <= 1024:
            calls["K5"] += 1
        calls["K8"] += bf16 and env.get("SAM2_TPU_FUSED_MLP") == "1"
    return calls


def _counting(counts, key, fn, **extra):
    def wrapper(*args, **kwargs):
        counts[key] += 1
        return fn(*args, **kwargs, **extra)
    return wrapper


@pytest.fixture(scope="module")
def trunks(tiny128_params):
    sd = state_dict_from_params(jax.tree_util.tree_map(np.asarray, tiny128_params))
    module = base.SAM2Base(model_config("hiera_t", image_size=128))
    module.load_state_dict(sd, strict=True)
    return tiny128_params["image_encoder"]["trunk"], module.image_encoder.trunk.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("setting", ["W1", "W2"])
def test_trunk_routes_match_jax(trunks, tiny128_cfg, monkeypatch, setting, dtype):
    jax_params, port_trunk = trunks
    bf16 = dtype == "bfloat16"
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SAM2_TPU_FLASH", "1")
    for name, value in SETTINGS[setting].items():
        monkeypatch.setenv(name, value)

    jax_calls = dict.fromkeys(("K5", "K6", "K7", "K8"), 0)
    monkeypatch.setattr(jax_wa, "window_attention",
                        _counting(jax_calls, "K5", jax_wa.window_attention, interpret=True))
    monkeypatch.setattr(jax_wa, "window_flash_3d",
                        _counting(jax_calls, "K6", jax_wa.window_flash_3d))
    monkeypatch.setattr(jax_wa, "packed_window_attention",
                        _counting(jax_calls, "K7", jax_wa.packed_window_attention))
    monkeypatch.setattr(jax_fm, "fused_mlp", _counting(jax_calls, "K8", jax_fm.fused_mlp))
    port_calls = dict.fromkeys(("K5", "K6", "K7", "K8"), 0)
    monkeypatch.setattr(port_wa, "window_attention",
                        _counting(port_calls, "K5", port_wa.window_attention))
    monkeypatch.setattr(port_hiera, "window_flash_3d",
                        _counting(port_calls, "K6", port_hiera.window_flash_3d))
    monkeypatch.setattr(port_hiera, "packed_window_attention",
                        _counting(port_calls, "K7", port_hiera.packed_window_attention))
    monkeypatch.setattr(port_hiera, "fused_mlp", _counting(port_calls, "K8", port_hiera.fused_mlp))

    img = np.random.default_rng(3).standard_normal((1, 128, 128, 3)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    params = jax.tree_util.tree_map(lambda a: a.astype(jdt), jax_params)
    # a fresh function, so JAX traces it under this setting's switches
    ref = jax.jit(lambda p, x: jax_hiera.hiera(p, x, tiny128_cfg.trunk))(params,
                                                                       jnp.asarray(img, jdt))
    trunk = copy.deepcopy(port_trunk).to(tdt) if bf16 else port_trunk
    with torch.no_grad():
        out = trunk(torch.from_numpy(img).permute(0, 3, 1, 2).to(tdt))

    want = expected_calls(tiny128_cfg.trunk.block_plan(), SETTINGS[setting], bf16, 32)
    assert jax_calls == want and port_calls == want, (jax_calls, port_calls, want)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        a = a.float().permute(0, 2, 3, 1).numpy()
        b = np.asarray(b, np.float32)
        scale = np.abs(b).max()
        err = np.abs(a - b).max()
        assert err <= (3e-2 if bf16 else 1e-4) * scale, (err, scale)


def test_switch_parsing_matches_jax(monkeypatch):
    """Defaults, values and unparsable values of the three token switches
    read as the JAX package reads them."""
    cases = {
        "SAM2_TPU_PACKED_WINDOW": ("_packed_window_max_tokens", ["", "256", "0", "x"]),
        "SAM2_TPU_FLASH_WINDOW_MIN": ("_flash_window_min_tokens", ["", "64", "0", "-5", "x"]),
        "SAM2_TPU_SPLIT_WINDOW_MIN": ("_split_window_min_tokens", ["", "16", "x"]),
    }
    for env, (fn, values) in cases.items():
        for value in values:
            if value:
                monkeypatch.setenv(env, value)
            else:
                monkeypatch.delenv(env, raising=False)
            assert getattr(port_hiera, fn)() == getattr(jax_hiera, fn)(), (env, value)
    for value in ("", "1", "true", "0"):
        monkeypatch.setenv("SAM2_TPU_FUSED_MLP", value)
        assert port_hiera._use_fused_mlp() == jax_hiera._use_fused_mlp()
