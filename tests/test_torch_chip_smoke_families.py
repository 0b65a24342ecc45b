"""`chip_smoke.py`'s split of device time by kernel family names every CUDA
kernel of the port.

Every `__global__` kernel in `sam2_opt_tpu_torch/csrc/*.cu` must match a
family of `chip_smoke.FAMILIES` other than "other", and the family of the
TPU kernel it serves: K2's rotation, attention and split merge count as K2's
although its attention body is K1's. Each name is checked bare and as
torch.profiler reports a templated kernel. Reads the sources and the script
only; imports neither JAX nor the JAX package.
"""

import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "sam2_opt_tpu_torch" / "csrc"

# the family each kernel's name prefix belongs to
EXPECTED = [
    ("window_attn_", "K5-K7 window_attention (csrc)"),
    ("fused_mlp_", "K8 fused_mlp (csrc)"),
    ("bwd_", "K3 flash_attention_bwd (csrc)"),
    ("combine_kernel", "K3 flash_attention_bwd (csrc)"),  # K3's sum of its splits
    ("flash_kvproj_", "K4 flash_attention_kv_proj (csrc)"),
    ("flash_rope_", "K2 flash_attention_rope (csrc)"),
    ("flash_fwd_", "K1 flash_attention (csrc)"),
]


def _kernel_names():
    names = set()
    for src in sorted(CSRC.glob("*.cu")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                src.read_text()))
    return sorted(names)


KERNELS = _kernel_names()


@pytest.fixture(scope="module")
def families():
    spec = importlib.util.spec_from_file_location("chip_smoke_families", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FAMILIES


def _family(families, key):
    return next((f for f, pattern in families if re.search(pattern, key, re.IGNORECASE)), "other")


@pytest.mark.parametrize("name", KERNELS)
def test_every_kernel_has_its_family(families, name):
    want = next(f for prefix, f in EXPECTED if name.startswith(prefix))
    for key in (name, f"void (anonymous namespace)::{name}<256>((anonymous namespace)::Params)"):
        assert _family(families, key) == want, key


def test_sources_hold_every_kernel_of_k1_and_k2():
    """The parse finds the kernels K1 and K2 launch, the rotation among them."""
    for name in ("flash_rope_rotate_kernel", "flash_rope_wgmma_kernel", "flash_rope_tf32_kernel",
                 "flash_rope_combine_kernel", "flash_fwd_wgmma_kernel", "flash_fwd_tf32_kernel",
                 "flash_fwd_combine_kernel"):
        assert name in KERNELS
