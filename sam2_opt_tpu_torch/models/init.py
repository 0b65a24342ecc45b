"""Random parameter initialization for the full SAM2 module.

Counterpart of `sam2_opt_tpu/models/init.py:86` (`init_params`): the same
shapes and distributions, drawn from a `torch.Generator` (the numbers differ
from JAX's). Linear and conv weights are uniform in +-1/sqrt(fan_in), with
fan_in = kh*kw*in_channels for every conv, depthwise included, as the JAX
init counts it; biases are 0; norms 1/0; embeddings and learned tokens
normal(0, 0.02); the random-Fourier matrix normal(0, 1); ConvNeXt gammas
1e-6.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sam2_opt_tpu_torch.ops import common as ops

_TOKENS = ("pos_embed", "pos_embed_window", "maskmem_tpos_enc", "no_mem_embed",
           "no_mem_pos_enc", "no_obj_ptr", "no_obj_embed_spatial")


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    t.copy_(torch.empty(t.shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen))


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator):
    t.copy_(torch.empty(t.shape, dtype=torch.float32).normal_(0.0, std, generator=gen))


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of `model` in place; returns it.
    Draws on the CPU generator, so a given seed gives the same weights on any
    device."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            _uniform_(mod.weight, 1.0 / math.sqrt(mod.in_features), generator)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = mod.kernel_size
            _uniform_(mod.weight, 1.0 / math.sqrt(kh * kw * mod.in_channels), generator)
        elif isinstance(mod, (nn.LayerNorm, ops.LayerNorm2d)):
            mod.weight.fill_(1.0)
        elif isinstance(mod, nn.Embedding):
            _normal_(mod.weight, 0.02, generator)
        if isinstance(getattr(mod, "bias", None), torch.Tensor):
            mod.bias.zero_()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _TOKENS:
            _normal_(p, 0.02, generator)
        elif leaf == "gamma":
            p.fill_(1e-6)
    for name, b in model.named_buffers():
        if name.endswith("positional_encoding_gaussian_matrix"):
            _normal_(b, 1.0, generator)
    return model
