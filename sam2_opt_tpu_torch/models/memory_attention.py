"""Memory attention: 4 layers of RoPE self-attention, partial-RoPE
cross-attention to the memory bank, and an FFN.

Counterpart of `sam2_opt_tpu/models/memory_attention.py` (reference
sam2/sam2/modeling/memory_attention.py and the RoPE attention of
sam/transformer.py:297-424), over the JAX package's fixed-capacity memory:

    kv = [ num_frames * 4096 spatial-memory tokens | pointer tokens ]

with a boolean validity mask. Spatial keys get the axial RoPE table tiled per
frame; pointer keys get identity rows (cos = 1, sin = 0), which is the
reference's `num_k_exclude_rope`.

The q/k projections run with `split_perm` applied to their output channels,
so the rotation works on two contiguous halves: under autograd the
permutation is taken inside the graph on every call (the JAX `_perm_proj`),
so gradients reach the q/k projections; without grad the permuted weights
are cached per parameter storage. The tables are built once per shape,
device and dtype. The JAX package's switches are read at every call.
Under `SAM2_TPU_FLASH` (`ops.use_flash_attention`: on for CUDA tensors by
default) attention takes the kernel routes: on a CUDA tensor with q * kv >=
1024² and q of one frame's tokens, K2 (`flash_attention_rope`), which
rotates K inside the kernel, elsewhere K2's plain version;
`SAM2_TPU_FUSED_KV_PROJ=1` sends single-head cross-attention to K4
(`flash_attention_kv_proj`, or its plain version off the card), which also
projects the memory K/V; `SAM2_TPU_FUSED_ROPE=0` turns off K2 and K4, and
K1 attends on K rotated in torch. With `SAM2_TPU_FLASH` off (the default on
the CPU, as the JAX package's unfused path there), K is rotated in torch
and plain attention runs (`ops.scaled_dot_product_attention`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sam2_opt_tpu_torch.config import MemoryAttentionConfig, SAM2Config
from sam2_opt_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_kv_proj,
    flash_attention_kv_proj_ref,
    flash_attention_ref,
    flash_attention_rope,
    flash_attention_rope_ref,
)
from sam2_opt_tpu_torch.ops import common as ops
from sam2_opt_tpu_torch.ops import posenc
from sam2_opt_tpu_torch.quant.int8 import QuantLinear


@ops.constant_cache(maxsize=16)
def _rope_half_tables(dim: int, end_x: int, end_y: int, theta: float, reps: int, n_extra: int,
                    device, dtype):
    """Split-layout tables [reps*end_x*end_y + n_extra, dim/2] on `device` in
    `dtype`, built once per shape, device and dtype: the axial table tiled
    per frame (rope_k_repeat, transformer.py:380-381) plus identity rows for
    the never-rotated pointer tokens (transformer.py:392-418). reps = 1 and
    n_extra = 0 give the query table (the JAX package's `_rope_half_tables`;
    its `_kv_half_tables` otherwise); the interleaved `_rope_tables` are not
    needed, as the port always rotates in the split layout."""
    # built outside inference mode, so tables first cached by a predictor
    # can be saved for a later training step's backward
    with torch.inference_mode(False):
        c, s = posenc.rope_half_tables(dim, end_x, end_y, theta)
        c = torch.cat([c.repeat(reps, 1), torch.ones(n_extra, c.shape[1])])
        s = torch.cat([s.repeat(reps, 1), torch.zeros(n_extra, s.shape[1])])
        return c.to(device, dtype), s.to(device, dtype)


def _rope_fusion_on() -> bool:
    """`SAM2_TPU_FUSED_ROPE` (default on, read at every call, as the JAX
    gate at memory_attention.py:71): "0" turns off K2 and K4 together."""
    return os.environ.get("SAM2_TPU_FUSED_ROPE", "1") != "0"


def _kv_proj_fusion_on() -> bool:
    """`SAM2_TPU_FUSED_KV_PROJ=1` (default off, read at every call, as the
    JAX gate at memory_attention.py:76-88): single-head cross-attention
    projects the memory K/V inside K4."""
    return os.environ.get("SAM2_TPU_FUSED_KV_PROJ", "0") == "1"


def _use_fused_rope(q, kv_len: int, frame_tokens: int) -> bool:
    """The kernels, not their plain versions, on a route that takes them:
    where K1 would run anyway (q * kv >= 1024², on the card) and q is one
    frame's tokens (`_use_fused_rope`, memory_attention.py:62-73)."""
    q_len = q.shape[-2]
    return q.is_cuda and q_len * kv_len >= 1024 * 1024 and q_len == frame_tokens


class RoPEAttention(ops.Attention):
    """Reference `RoPEAttention` parameters (q/k/v projections, each an
    `nn.Linear` or, after int8 quantization, a `QuantLinear`)."""

    _split_key = None

    def split_qk(self):
        """The q and k projections with `split_perm` on their output
        channels: each (weight, bias) of an `nn.Linear`, or a permuted
        `QuantLinear` (int8 rows, scales and bias permuted alike: the JAX
        `_perm_proj`, memory_attention.py:91-107). Under autograd they are
        indexed inside the graph on every call, so the gradient flows back
        to the projections. Without grad (no_grad or inference mode) they
        are detached copies built once per tensor storage, so `speedup()`'s
        compute copy, a new device or a loaded state dict builds its own on
        first use."""
        projs = (self.q_proj, self.k_proj)
        tensors = tuple(t for p in projs for t in _proj_tensors(p) if t is not None)
        if torch.is_grad_enabled() or torch.compiler.is_compiling():
            # under torch.export the weights are the trace's fakes, which
            # have no storage to key a cache on
            return tuple(_permuted(p, self._perm(tensors[0].device)) for p in projs)
        # the key holds the tensors themselves, so a freed storage cannot
        # come back at the same address and pass for a cached one
        key = tuple((t, t.data_ptr(), t.dtype, t._version) for t in tensors)
        if self._split_key is None or len(key) != len(self._split_key) or any(
                a[0] is not b[0] or a[1:] != b[1:] for a, b in zip(self._split_key, key)):
            perm = self._perm(tensors[0].device)
            with torch.no_grad():
                self._split = tuple(_permuted(p, perm) for p in projs)
            self._split_key = key
        return self._split

    def _perm(self, device):
        head_dim = self.q_proj.out_features // self.num_heads
        return posenc.split_perm(head_dim, self.num_heads).to(device)


def _proj_tensors(proj):
    if isinstance(proj, QuantLinear):
        return proj.w_int8, proj.w_scale, proj.bias, proj.act_scale
    return proj.weight, proj.bias


def _permuted(proj, perm):
    if isinstance(proj, QuantLinear):
        return proj.permuted(perm)
    return proj.weight[perm], proj.bias[perm]


def _project(split, x):
    """x through one of `split_qk`'s projections."""
    if isinstance(split, QuantLinear):
        return split(x)
    return F.linear(x, *split)


def _run_pre_hooks(proj, x):
    """Run `proj`'s forward pre-hooks on its input where the projection runs
    on split or raw weights instead of its forward: int8 calibration
    (`quant/calibrate.py`) records each linear's input there."""
    for hook in proj._forward_pre_hooks.values():
        hook(proj, (x,))


def _rope_attention(attn: RoPEAttention, cfg: MemoryAttentionConfig, q_in, k_in, v_in,
                    kv_mask, reps: int, n_extra: int, cross: bool = False):
    """q from one frame's tokens, k/v from `reps` frames plus `n_extra`
    unrotated tokens; q rotated here. Under `SAM2_TPU_FLASH`, on the card
    where the kernels take the shape (`_use_fused_rope`), K is rotated in
    K2, or for single-head cross-attention under `SAM2_TPU_FUSED_KV_PROJ=1`
    with raw (not int8) k/v weights, projected and rotated in K4; elsewhere
    their plain versions run. `SAM2_TPU_FUSED_ROPE=0` rotates K here
    instead and runs K1 (at D = 256 on the card) where K2 would run, its
    plain version elsewhere (the JAX unfused branch,
    memory_attention.py:206-224). With `SAM2_TPU_FLASH` off, K is rotated
    here and plain attention runs, as JAX's XLA path does."""
    ex, ey = cfg.rope_feat_sizes
    proj_q, proj_k = attn.split_qk()
    _run_pre_hooks(attn.q_proj, q_in)
    _run_pre_hooks(attn.k_proj, k_in)
    q = ops.separate_heads(_project(proj_q, q_in), attn.num_heads)
    head_dim = q.shape[-1]
    cq, sq = _rope_half_tables(head_dim, ex, ey, cfg.rope_theta, 1, 0, q.device, q.dtype)
    ck, sk = _rope_half_tables(head_dim, ex, ey, cfg.rope_theta, reps, n_extra, q.device, q.dtype)
    # q rotated as the kernel rotates K: in fp32, rounded once
    q = posenc.apply_rotary_split(q.float(), cq.float(), sq.float()).to(q.dtype)
    on_card = _use_fused_rope(q, k_in.shape[1], ex * ey)
    flash = ops.use_flash_attention(q)
    rope = flash and _rope_fusion_on()
    # K4 streams raw k/v weights: int8 projections take the branch below,
    # as in the JAX package (memory_attention.py:183-186)
    if (cross and rope and attn.num_heads == 1 and _kv_proj_fusion_on()
            and not isinstance(proj_k, QuantLinear) and not isinstance(attn.v_proj, QuantLinear)):
        _run_pre_hooks(attn.v_proj, v_in)
        attend = flash_attention_kv_proj if on_card else flash_attention_kv_proj_ref
        out, _ = attend(q, k_in, v_in, *proj_k, attn.v_proj.weight, attn.v_proj.bias, ck, sk,
                        kv_mask)
        return attn.out_proj(ops.recombine_heads(out))
    if flash:
        ops.check_fast_exp(q.dtype)  # K2 and K1 below; K4 above does not read it
    k = ops.separate_heads(_project(proj_k, k_in), attn.num_heads)
    v = ops.separate_heads(attn.v_proj(v_in), attn.num_heads)
    if rope:
        attend = flash_attention_rope if on_card else flash_attention_rope_ref
        out, _ = attend(q, k, v, ck, sk, kv_mask)
        return attn.out_proj(ops.recombine_heads(out))
    k = posenc.apply_rotary_split(k.float(), ck.float(), sk.float()).to(k.dtype)
    if flash:
        attend = flash_attention if on_card else flash_attention_ref
        out, _ = attend(q, k, v, kv_mask)
    else:
        mask = None if kv_mask is None else kv_mask[:, None, None, :]
        out = ops.scaled_dot_product_attention(q, k, v, mask=mask)
    return attn.out_proj(ops.recombine_heads(out))


class MemoryAttentionLayer(nn.Module):
    """One layer (reference memory_attention.py:18-109): pre-LN RoPE
    self-attention, pre-LN partial-RoPE cross-attention, FFN."""

    def __init__(self, cfg: MemoryAttentionConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.self_attn = RoPEAttention(d, cfg.num_heads)
        self.cross_attn_image = RoPEAttention(d, cfg.num_heads, kv_in_dim=cfg.kv_in_dim)
        self.linear1 = nn.Linear(d, cfg.dim_feedforward)
        self.linear2 = nn.Linear(cfg.dim_feedforward, d)
        self.norm1, self.norm2, self.norm3 = (ops.LayerNorm(d) for _ in range(3))

    def forward(self, tgt, mem_k, mem_v, query_pos, kv_mask, num_frame_tokens: int):
        """tgt/query_pos [B, HW, d]; mem_k (memory + pos, hoisted by the
        stack) and mem_v [B, S, mem_dim]; kv_mask [B, S] bool or None."""
        cfg = self.cfg
        seq = cfg.rope_feat_sizes[0] * cfg.rope_feat_sizes[1]
        if num_frame_tokens % seq:
            raise ValueError(f"{num_frame_tokens} memory tokens are not whole {seq}-token frames")
        tgt2 = self.norm1(tgt)
        qk = tgt2 + query_pos if cfg.pos_enc_at_attn else tgt2
        tgt = tgt + _rope_attention(self.self_attn, cfg, qk, qk, tgt2, None, 1, 0)
        tgt2 = self.norm2(tgt)
        q = tgt2 + query_pos if cfg.pos_enc_at_cross_attn_queries else tgt2
        tgt = tgt + _rope_attention(self.cross_attn_image, cfg, q, mem_k, mem_v, kv_mask,
                                    num_frame_tokens // seq, mem_k.shape[1] - num_frame_tokens,
                                    cross=True)
        tgt2 = self.norm3(tgt)
        act = F.relu if cfg.activation == "relu" else ops.gelu
        return tgt + self.linear2(act(self.linear1(tgt2)))


class MemoryAttention(nn.Module):
    """The stack (reference memory_attention.py:263-349)."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        mac = cfg.memory_attention
        self.cfg = mac
        self.layers = nn.ModuleList(MemoryAttentionLayer(mac) for _ in range(mac.num_layers))
        self.norm = ops.LayerNorm(mac.d_model)

    def forward(self, curr, memory, curr_pos, memory_pos, kv_mask=None,
                num_frame_tokens: Optional[int] = None):
        """curr/curr_pos [B, HW, d]; memory/memory_pos [B, S, mem_dim];
        kv_mask [B, S] bool or None. `num_frame_tokens` is the boundary
        between rotated spatial tokens and unrotated pointer tokens (default:
        all spatial). Returns [B, HW, d]."""
        if num_frame_tokens is None:
            num_frame_tokens = memory.shape[1]
        cfg = self.cfg
        output = curr
        if cfg.pos_enc_at_input and curr_pos is not None:
            output = output + 0.1 * curr_pos
        # the cross-attention key input is the same for every layer
        mem_k = memory + memory_pos if cfg.pos_enc_at_cross_attn_keys else memory
        for layer in self.layers:
            output = layer(output, mem_k, memory, curr_pos, kv_mask, num_frame_tokens)
        return self.norm(output)
