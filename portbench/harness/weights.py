"""Random weights from the seed, made on the device in a few large draws.

Linear and convolution weights and biases are uniform in +-1/sqrt(fan_in),
with fan_in = kh * kw * in_channels for every convolution, depthwise ones
included (PyTorch's default for both); norms' weights 1 + normal(0, 0.1)
and biases normal(0, 0.1); embeddings and learned tokens normal(0, 0.02);
the random-Fourier matrix normal(0, 1); the memory encoder's layer-scale
gammas normal(0, 0.1) (their initial 1e-6 would hide the fuser's blocks).
No bias, affine or layer scale is 0 or 1 then, so a kernel that drops or
misplaces one changes the answers. The layout is read from the reference
model, built on the meta device, so the port's code plays no part.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.reference import sam2_ref as ref

_TOKENS = ("pos_embed", "pos_embed_window", "maskmem_tpos_enc", "no_mem_embed",
           "no_mem_pos_enc", "no_obj_ptr", "no_obj_embed_spatial")


NORM_STD = 0.1


def _leaves(cfg: ref.Config):
    """(name, shape, kind, spread, offset) of every parameter and buffer:
    kind is "uniform" (offset +- spread) or "normal" (offset, std spread)."""
    with torch.device("meta"):
        model = ref.SAM2(cfg)
    kinds = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.in_features)
            kinds[prefix + "weight"] = kinds[prefix + "bias"] = ("uniform", bound, 0.0)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = mod.kernel_size
            bound = 1.0 / math.sqrt(kh * kw * mod.in_channels)
            kinds[prefix + "weight"] = kinds[prefix + "bias"] = ("uniform", bound, 0.0)
        elif isinstance(mod, (nn.LayerNorm, ref.LayerNorm2d)):
            kinds[prefix + "weight"] = ("normal", NORM_STD, 1.0)
            kinds[prefix + "bias"] = ("normal", NORM_STD, 0.0)
        elif isinstance(mod, ref.Embedding):
            kinds[prefix + "weight"] = ("normal", 0.02, 0.0)
    out = []
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _TOKENS:
            kind = ("normal", 0.02, 0.0)
        elif leaf == "gamma":
            kind = ("normal", NORM_STD, 0.0)
        elif name.endswith("positional_encoding_gaussian_matrix"):
            kind = ("normal", 1.0, 0.0)
        else:
            kind = kinds[name]
        out.append((name, tuple(t.shape), *kind))
    return out


@torch.no_grad()
def make_state_dict(cfg: ref.Config, seed: int, device, add: dict = None,
                    scale: dict = None) -> dict:
    """fp32 state dict on `device` from `seed`: one uniform and one normal
    draw for all leaves, scaled and shifted per leaf. Then `add` adds a
    number or a list to named leaves and `scale` multiplies named leaves
    (the configuration's `assumed` adjustments)."""
    leaves = _leaves(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _, _, _ in leaves]
    n_uniform = sum(n for n, (_, _, k, _, _) in zip(sizes, leaves) if k == "uniform")
    n_normal = sum(n for n, (_, _, k, _, _) in zip(sizes, leaves) if k == "normal")
    uniform = torch.rand(n_uniform, device=device, generator=gen).mul_(2.0).sub_(1.0)
    normal = torch.randn(n_normal, device=device, generator=gen)
    sd, used = {}, {"uniform": 0, "normal": 0}
    for (name, shape, kind, spread, offset), n in zip(leaves, sizes):
        src = uniform if kind == "uniform" else normal
        t = src[used[kind]:used[kind] + n].view(shape).mul_(spread).add_(offset)
        used[kind] += n
        sd[name] = t
    for name, delta in (add or {}).items():
        sd[name].add_(torch.as_tensor(delta, dtype=torch.float32, device=device))
    for name, factor in (scale or {}).items():
        sd[name].mul_(factor)
    return sd
