"""Int8 quantization of the linear layers.

Counterpart of `sam2_opt_tpu/quant/int8.py`, the stand-in for the
reference's TensorRT int8 engines (quant_image_encoder.py:8-75):

- weights: per-output-channel symmetric int8 (absmax). A quantized
  `nn.Linear` becomes a `QuantLinear` holding `w_int8` [out, in], `w_scale`
  [out] (fp32) and its bias; the JAX package stores the same numbers
  transposed ([in, out]) in its params tree.
- activations (optional, needs calibration, `quant/calibrate.py`):
  per-tensor symmetric int8 with a calibrated `act_scale`, so the product is
  int8 x int8 with int32 accumulation (`torch._int_mm`, as the JAX package
  runs `lax.dot_general` outside any Pallas kernel); without a scale the
  product runs in the input's dtype against the dequantized weight.

A `QuantLinear` has no `weight` attribute, so the kernel routes that stream a
raw weight (K8's fused MLP, K4's K/V projections) leave quantized layers to
the plain route, as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch
from torch import nn

# linear weights quantized by default: the Hiera trunk (parameter- and
# FLOP-dominant); matches the reference quantizing the image encoder only.
DEFAULT_QUANT_PATTERN = r"image_encoder.*(qkv|proj|mlp\.layers\.\d+|linear\d)\.weight$"

# beyond the reference (its int8 stops at the encoder engines,
# quant_image_encoder.py:8-75): also quantize the tracking hot path —
# memory-attention q/k/v/out projections + FFN, and the SAM mask-decoder
# two-way transformer linears. Enabled via quantize_int8(scope="tracking").
TRACKING_QUANT_PATTERN = (
    r"("
    r"image_encoder.*(qkv|proj|mlp\.layers\.\d+|linear\d)\.weight"
    r"|memory_attention\.layers\.\d+\."
    r"(self_attn|cross_attn_image)\.(q_proj|k_proj|v_proj|out_proj)\.weight"
    r"|memory_attention\.layers\.\d+\.linear[12]\.weight"
    r"|sam_mask_decoder\.transformer\..*"
    r"(q_proj|k_proj|v_proj|out_proj)\.weight"
    r"|sam_mask_decoder\.transformer\..*mlp\.layers\.\d+\.weight"
    r")$"
)

# torch._int_mm on CUDA takes more than 16 rows (and K, N multiples of 8)
INT_MM_MIN_ROWS = 17


def quantize_weight(w: torch.Tensor):
    """[out, in] float -> (int8 [out, in], fp32 per-output-channel scale
    [out]), with the JAX `quantize_weight`'s arithmetic in fp32 (there the
    weight is [in, out] and the absmax runs over axis 0)."""
    w = w.detach().float()
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


class QuantLinear(nn.Module):
    """An int8 linear layer: buffers `w_int8` [out, in], `w_scale` [out]
    (fp32), `bias` (the layer's, in its dtype) and, when calibrated,
    `act_scale` (fp32, per tensor). No `weight`: see the module docstring."""

    def __init__(self, w_int8: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, act_scale: Optional[torch.Tensor] = None):
        super().__init__()
        self.out_features, self.in_features = w_int8.shape
        self.register_buffer("w_int8", w_int8)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias)
        self.register_buffer("act_scale", act_scale)

    def permuted(self, perm: torch.Tensor) -> "QuantLinear":
        """This layer with its output channels permuted: the int8 rows, the
        scales and the bias alike; the per-tensor `act_scale` is
        permutation-invariant (the JAX `_perm_proj`)."""
        return QuantLinear(self.w_int8[perm], self.w_scale[perm],
                           None if self.bias is None else self.bias[perm], self.act_scale)

    def forward(self, x):
        return quantized_linear(self, x)


def int8_matmul(a: torch.Tensor, w_int8: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 times w_int8 [N, K]^T -> int32 [M, N] through
    `torch._int_mm`. Fewer than `INT_MM_MIN_ROWS` rows (the mask decoder's
    tokens) are padded with zero rows, which add nothing, and sliced off.
    Counts its calls in `int8_matmul.launches`, as the kernel wrappers count
    theirs (under CUDA graphs at warm-up and capture, not at replays)."""
    m = a.shape[0]
    if m < INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(INT_MM_MIN_ROWS - m, a.shape[1])])
    int8_matmul.launches += 1
    return torch._int_mm(a, w_int8.t())[:m]


int8_matmul.launches = 0


def quantized_linear(p: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """The JAX `quantized_linear` step for step. With `act_scale` sa:
    x rounded to int8 at sa, an int32 product, times sa * w_scale in fp32,
    cast to x's dtype. Without: x times the weight dequantized in x's dtype.
    The bias is added in the result's dtype."""
    if p.act_scale is not None:
        sa = p.act_scale
        xq = torch.clamp(torch.round(x.float() / sa), -127, 127).to(torch.int8)
        acc = int8_matmul(xq.reshape(-1, x.shape[-1]), p.w_int8)
        # int32 times fp32 computes in fp32: acc.float() * (sa * w_scale)
        y = (acc * (sa * p.w_scale)).to(x.dtype).reshape(*x.shape[:-1], -1)
    else:
        w = p.w_int8.to(x.dtype) * p.w_scale.to(x.dtype)[:, None]
        y = torch.matmul(x, w.t())
    if p.bias is not None:
        y = y + p.bias.to(y.dtype)
    return y


def is_quantized(module) -> bool:
    return isinstance(module, QuantLinear)


def _replace(root: nn.Module, name: str, new: nn.Module):
    parent, _, attr = name.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, attr, new)


@torch.no_grad()
def quantize_module(module: nn.Module, pattern: str = DEFAULT_QUANT_PATTERN,
                    act_scales: Optional[Dict[str, float]] = None) -> List[str]:
    """Replace, in place, every `nn.Linear` whose `name + ".weight"` matches
    `pattern` by a `QuantLinear` (the JAX `quantize_params`; the port's
    module names are the reference state-dict names, as the JAX tree's are).
    `act_scales` maps the same dotted weight names to calibrated per-tensor
    input scales. Returns the quantized layers' names."""
    rx = re.compile(pattern)
    names = []
    for name, sub in list(module.named_modules()):
        if not (isinstance(sub, nn.Linear) and sub.weight.ndim == 2
                and rx.search(name + ".weight")):
            continue
        q, scale = quantize_weight(sub.weight)
        sa = act_scales.get(name + ".weight") if act_scales else None
        _replace(module, name, QuantLinear(
            q, scale, None if sub.bias is None else sub.bias.detach(),
            None if sa is None else torch.tensor(sa, dtype=torch.float32, device=q.device)))
        names.append(name)
    return names


def quantize_like(module: nn.Module, state_dict) -> List[str]:
    """Give `module` the quantized layers a state dict holds (keys ending in
    `.w_int8`, e.g. a JAX int8 tree carried across by
    `io.weights.state_dict_from_params`), empty, so that
    `module.load_state_dict(state_dict)` fills them. Returns their names."""
    names = [k[:-len(".w_int8")] for k in state_dict if k.endswith(".w_int8")]
    for name in names:
        w = state_dict[name + ".w_int8"]
        lin = module.get_submodule(name)
        _replace(module, name, QuantLinear(
            torch.empty_like(w), torch.empty(w.shape[0]),
            None if lin.bias is None else torch.empty_like(lin.bias),
            torch.empty(()) if name + ".act_scale" in state_dict else None))
    return names
