"""Random Segment Anything weights from the seed, made on the device in two
draws, as `harness/weights.py` makes SAM 2's: linear and convolution
weights and biases uniform in +-1/sqrt(fan_in); norms' weights
1 + normal(0, 0.1) and biases normal(0, 0.1); embeddings, learned tokens
and the absolute position embedding normal(0, 0.02); the random-Fourier
matrix normal(0, 1); the relative-position tables normal(0, `rel_pos_std`),
the configuration's `assumed` spread (upstream initializes them to zero,
which would hide the bias). The layout is read from the reference model,
built on the meta device, so the port's code plays no part.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.harness.weights import NORM_STD
from portbench.reference import sam2_ref
from portbench.reference import sam_vit_ref as ref


def _leaves(cfg: ref.Config, rel_pos_std: float):
    """(name, shape, kind, spread, offset) of every parameter and buffer."""
    with torch.device("meta"):
        model = ref.SamViT(cfg)
    kinds = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, nn.Linear):
            kinds[prefix + "weight"] = kinds[prefix + "bias"] = (
                "uniform", 1.0 / math.sqrt(mod.in_features), 0.0)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = mod.kernel_size
            kinds[prefix + "weight"] = kinds[prefix + "bias"] = (
                "uniform", 1.0 / math.sqrt(kh * kw * mod.in_channels), 0.0)
        elif isinstance(mod, (nn.LayerNorm, sam2_ref.LayerNorm2d)):
            kinds[prefix + "weight"] = ("normal", NORM_STD, 1.0)
            kinds[prefix + "bias"] = ("normal", NORM_STD, 0.0)
        elif isinstance(mod, sam2_ref.Embedding):
            kinds[prefix + "weight"] = ("normal", 0.02, 0.0)
    out = []
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            kind = ("normal", 0.02, 0.0)
        elif leaf in ("rel_pos_h", "rel_pos_w"):
            kind = ("normal", rel_pos_std, 0.0)
        elif name.endswith("positional_encoding_gaussian_matrix"):
            kind = ("normal", 1.0, 0.0)
        else:
            kind = kinds[name]
        out.append((name, tuple(t.shape), *kind))
    return out


@torch.no_grad()
def make_state_dict(cfg: ref.Config, seed: int, device, rel_pos_std: float, add: dict = None,
                    scale: dict = None) -> dict:
    """fp32 state dict on `device` from `seed`: one uniform and one normal
    draw for all leaves, scaled and shifted per leaf; then `add` and `scale`
    (the configuration's `assumed` adjustments) as `weights.make_state_dict`
    applies them."""
    leaves = _leaves(cfg, rel_pos_std)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _, _, _ in leaves]
    totals = {k: sum(n for n, leaf in zip(sizes, leaves) if leaf[2] == k)
              for k in ("uniform", "normal")}
    draws = {"uniform": torch.rand(totals["uniform"], device=device, generator=gen)
             .mul_(2.0).sub_(1.0),
             "normal": torch.randn(totals["normal"], device=device, generator=gen)}
    sd, used = {}, {"uniform": 0, "normal": 0}
    for (name, shape, kind, spread, offset), n in zip(leaves, sizes):
        sd[name] = draws[kind][used[kind]:used[kind] + n].view(shape).mul_(spread).add_(offset)
        used[kind] += n
    for name, delta in (add or {}).items():
        sd[name].add_(torch.as_tensor(delta, dtype=torch.float32, device=device))
    for name, factor in (scale or {}).items():
        sd[name].mul_(factor)
    return sd
