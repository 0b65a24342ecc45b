"""Plain fp32 SAM2.1 forward: the benchmark's reference model.

A frozen copy of the port's model files (`models/*.py`, `ops/common.py`,
`ops/posenc.py`, `ops/connected_components.py` of the PyTorch package) with
every kernel route, switch, cache, graph seam, int8 and tensor-parallel
branch taken out: attention is softmax(q k^T / sqrt(d)) v in fp32, LayerNorm
and GELU are torch's exact fp32 forms, RoPE rotates q and k in the
reference's interleaved layout. The state dict keys are the port's (and the
upstream checkpoint's), so one state dict loads into both. Imports nothing
of the port.

Callers keep TF32 off (`plain_fp32()`): on an H100 an fp32 matmul or
convolution would otherwise run in TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NO_OBJ_SCORE = -1024.0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def plain_fp32():
    """fp32 products in fp32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# configuration (the upstream yaml tree, sam2.1_hiera_*.yaml), read from the
# benchmark's configuration file


@dataclasses.dataclass(frozen=True)
class Trunk:
    embed_dim: int
    num_heads: int
    stages: Tuple[int, ...]
    global_att_blocks: Tuple[int, ...]
    window_pos_embed_bkg_spatial_size: Tuple[int, int]
    window_spec: Tuple[int, ...]
    q_pool: int = 3
    q_stride: Tuple[int, int] = (2, 2)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    patch_kernel: Tuple[int, int] = (7, 7)
    patch_stride: Tuple[int, int] = (4, 4)
    patch_padding: Tuple[int, int] = (3, 3)
    mlp_ratio: float = 4.0

    def block_plan(self):
        """(dim, dim_out, heads, window, q_pool) per block (hieradet.py:232-260):
        the window size lags the stage change by one block; global blocks
        have window 0."""
        ends = [sum(self.stages[:i + 1]) - 1 for i in range(len(self.stages))]
        q_pool_blocks = [x + 1 for x in ends[:-1]][:self.q_pool]
        plan, dim, heads, stage = [], self.embed_dim, self.num_heads, 1
        for i in range(sum(self.stages)):
            dim_out, ws = dim, self.window_spec[stage - 1]
            if i in self.global_att_blocks:
                ws = 0
            if i - 1 in ends:
                dim_out, heads, stage = int(dim * self.dim_mul), int(heads * self.head_mul), stage + 1
            plan.append(dict(dim=dim, dim_out=dim_out, num_heads=heads, window_size=ws,
                             q_pool=i in q_pool_blocks))
            dim = dim_out
        return plan

    @property
    def stage_ends(self):
        return [sum(self.stages[:i + 1]) - 1 for i in range(len(self.stages))]

    @property
    def channel_list(self):
        plan = self.block_plan()
        return [plan[i]["dim_out"] for i in self.stage_ends[::-1]]


@dataclasses.dataclass(frozen=True)
class Neck:
    d_model: int
    fpn_top_down_levels: Tuple[int, ...]
    fuse_type: str
    pos_num_feats: int


@dataclasses.dataclass(frozen=True)
class MemAttn:
    d_model: int
    num_layers: int
    dim_feedforward: int
    num_heads: int
    rope_theta: float
    rope_feat_sizes: Tuple[int, int]
    kv_in_dim: int
    pos_enc_at_input: bool
    pos_enc_at_attn: bool
    pos_enc_at_cross_attn_keys: bool
    pos_enc_at_cross_attn_queries: bool
    activation: str


@dataclasses.dataclass(frozen=True)
class MemEnc:
    out_dim: int
    in_dim: int
    mask_downsampler_kernel: int
    mask_downsampler_stride: int
    mask_downsampler_padding: int
    mask_total_stride: int
    fuser_num_layers: int
    cx_kernel_size: int
    cx_padding: int
    pos_num_feats: int


@dataclasses.dataclass(frozen=True)
class Config:
    trunk: Trunk
    neck: Neck
    memory_attention: MemAttn
    memory_encoder: MemEnc
    values: dict  # every top-level number and flag of the configuration

    def __getattr__(self, name):
        try:
            return self.__dict__["values"][name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def image_embedding_size(self) -> int:
        return self.image_size // self.backbone_stride


def _group(cls, d: dict):
    """cls from the keys of d it has (training and derived keys are not
    the forward's)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items() if k in names})


def config_from_json(model: dict) -> Config:
    """The reference's configuration from the `model` group of a benchmark
    configuration file."""
    groups = ("trunk", "neck", "memory_attention", "memory_encoder")
    return Config(trunk=_group(Trunk, model["trunk"]), neck=_group(Neck, model["neck"]),
                  memory_attention=_group(MemAttn, model["memory_attention"]),
                  memory_encoder=_group(MemEnc, model["memory_encoder"]),
                  values={k: v for k, v in model.items() if k not in groups})


# ops


_ROUND = None  # set by `rounded`: the inputs of every product rounded


def sdpa(q, k, v):
    """softmax(q k^T / sqrt(d)) v on [..., seq, d]."""
    if _ROUND is not None:
        q, k, v = _ROUND(q), _ROUND(k), _ROUND(v)
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs if _ROUND is None else _ROUND(probs), v)


def round_to(x, dtype):
    """x rounded to `dtype` under one per-tensor scale (amax to the type's
    largest value), returned in x's type."""
    s = x.detach().abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / s).to(dtype).to(x.dtype) * s


@contextlib.contextmanager
def rounded(model: nn.Module, dtype=torch.float8_e4m3fn):
    """The reference in a lower precision, the comparison's control: every
    linear, convolution and attention product takes its inputs and weights
    rounded to `dtype` (per-tensor scales) and accumulates in fp32."""
    global _ROUND
    layers = [m for m in model.modules() if isinstance(m, (nn.Linear, nn.Conv2d,
                                                            nn.ConvTranspose2d))]
    saved = [m.weight.data for m in layers]
    hooks = [m.register_forward_pre_hook(lambda m, args: (round_to(args[0], dtype),) + args[1:])
             for m in layers]
    for m in layers:
        m.weight.data = round_to(m.weight.data, dtype)
    _ROUND = functools.partial(round_to, dtype=dtype)
    try:
        yield
    finally:
        _ROUND = None
        for h in hooks:
            h.remove()
        for m, w in zip(layers, saved):
            m.weight.data = w


def heads(x, n: int):
    B, N, C = x.shape
    return x.reshape(B, N, n, C // n).transpose(1, 2)


def unheads(x):
    B, H, N, C = x.shape
    return x.transpose(1, 2).reshape(B, N, H * C)


class LayerNorm2d(nn.Module):
    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.movedim(1, -1), x.shape[1:2], self.weight, self.bias,
                            self.eps).movedim(-1, 1)


class Embedding(nn.Module):
    """A table of learned tokens (`weight`, as nn.Embedding keys it), made
    without a random fill: the state dict gives its values."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, dim))


class GELU(nn.Module):
    def forward(self, x):
        return F.gelu(x)


class MLP(nn.Module):
    def __init__(self, i: int, h: int, o: int, n: int, act=F.relu, sigmoid_output=False):
        super().__init__()
        dims = [i] + [h] * (n - 1) + [o]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act, self.sigmoid_output = act, sigmoid_output

    def forward(self, x):
        for j, layer in enumerate(self.layers):
            x = layer(x)
            if j < len(self.layers) - 1:
                x = self.act(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1, kv_in_dim=None):
        super().__init__()
        inner = dim // downsample_rate
        kv_in_dim = dim if kv_in_dim is None else kv_in_dim
        self.num_heads = num_heads
        self.q_proj, self.k_proj = nn.Linear(dim, inner), nn.Linear(kv_in_dim, inner)
        self.v_proj, self.out_proj = nn.Linear(kv_in_dim, inner), nn.Linear(inner, dim)

    def forward(self, q, k, v):
        n = self.num_heads
        out = sdpa(heads(self.q_proj(q), n), heads(self.k_proj(k), n), heads(self.v_proj(v), n))
        return self.out_proj(unheads(out))


def sine_pe_2d(h: int, w: int, c: int, device=None):
    """[h, w, c] sine positional embedding (position_encoding.py:79-112)."""
    half, scale, eps = c // 2, 2 * math.pi, 1e-6
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y, x = y / (h + eps) * scale, x / (w + eps) * scale
    dim_t = torch.arange(half, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / half)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = torch.stack([px[:, :, 0::2].sin(), px[:, :, 1::2].cos()], 3).reshape(h, w, -1)
    py = torch.stack([py[:, :, 0::2].sin(), py[:, :, 1::2].cos()], 3).reshape(h, w, -1)
    return torch.cat([py, px], -1)


def fourier(gaussian, coords):
    coords = 2.0 * math.pi * ((2.0 * coords - 1.0) @ gaussian)
    return torch.cat([coords.sin(), coords.cos()], -1)


def sine_pe_1d(pos, dim: int):
    half = dim // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / half)
    p = pos[..., None].float() / dim_t
    return torch.cat([p.sin(), p.cos()], -1)


def axial_rope(dim: int, end_x: int, end_y: int, theta: float, device):
    """cos, sin [end_x * end_y, dim / 2] of the axial RoPE
    (position_encoding.py:166-183): x frequencies, then y frequencies."""
    freqs = 1.0 / (theta ** (np.arange(0, dim // 2, 2, dtype=np.float32) / (dim // 2)))
    freqs = np.concatenate([freqs, freqs])
    t = np.arange(end_x * end_y, dtype=np.float32)
    half = len(freqs) // 2
    ang = np.concatenate([np.outer(t % end_x, freqs[:half]), np.outer(np.floor(t / end_x),
                                                                     freqs[half:])], -1)
    return (torch.from_numpy(np.cos(ang)).to(device), torch.from_numpy(np.sin(ang)).to(device))


def rotate(x, cos, sin):
    """Interleaved-pair rotation (position_encoding.py:192-205); x [..., N,
    d], cos/sin [N, d/2]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).flatten(-2)


def resize(x, size, antialias: bool = False):
    """Bilinear resize of the last two axes (align_corners=False)."""
    *lead, H, W = x.shape
    out = F.interpolate(x.reshape(-1, 1, H, W), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=antialias)
    return out.reshape(*lead, *size)


def window_partition(x, ws: int):
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(x, ws: int, pad_hw, hw):
    (Hp, Wp), (H, W) = pad_hw, hw
    B = x.shape[0] // (Hp * Wp // ws // ws)
    x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W]


def maxpool(x, s):
    return F.max_pool2d(x.permute(0, 3, 1, 2), s, s).permute(0, 2, 3, 1)


# image encoder (hieradet.py, image_encoder.py)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim, dim_out, num_heads, q_stride=None):
        super().__init__()
        self.num_heads, self.q_stride = num_heads, q_stride
        self.qkv, self.proj = nn.Linear(dim, 3 * dim_out), nn.Linear(dim_out, dim_out)

    def forward(self, x):
        B, H, W, _ = x.shape
        q, k, v = self.qkv(x.reshape(B, H * W, -1)).reshape(B, H * W, 3, self.num_heads,
                                                            -1).unbind(2)
        if self.q_stride is not None:
            q = maxpool(q.reshape(B, H, W, -1), self.q_stride)
            H, W = q.shape[1:3]
            q = q.reshape(B, H * W, self.num_heads, -1)
        out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(B, H, W, -1))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim, dim_out, num_heads, window_size, q_pool, q_stride, mlp_ratio):
        super().__init__()
        self.dim, self.dim_out, self.window_size = dim, dim_out, window_size
        self.q_stride = tuple(q_stride) if q_pool else None
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, self.q_stride)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, act=F.gelu)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def forward(self, x):
        shortcut, x = x, self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_stride is not None:
                shortcut = maxpool(shortcut, self.q_stride)
        ws = self.window_size
        H, W = x.shape[1:3]
        pad_hw = (H, W)
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride is not None:
            ws = ws // self.q_stride[0]
            H, W = shortcut.shape[1:3]
            if ws > 0:
                pad_hw = (H + (ws - H % ws) % ws, W + (ws - W % ws) % ws)
        if self.window_size > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


def cubic_matrix(n_in: int, n_out: int, device):
    """[n_out, n_in] weights of a Keys cubic (a = -0.5) resize at half-pixel
    positions with out-of-range taps renormalized: the port's positional
    embedding resize (its JAX reference's `jax.image.resize(method="cubic")`)."""
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs()
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).t().contiguous().to(device)


class Hiera(nn.Module):
    def __init__(self, t: Trunk):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, t.embed_dim, t.patch_kernel, t.patch_stride,
                                          t.patch_padding)
        self.pos_embed = nn.Parameter(torch.zeros(1, t.embed_dim,
                                                  *t.window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, t.embed_dim, t.window_spec[0],
                                                         t.window_spec[0]))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(s["dim"], s["dim_out"], s["num_heads"], s["window_size"],
                            s["q_pool"], t.q_stride, t.mlp_ratio) for s in t.block_plan())
        self.stage_ends = set(t.stage_ends)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        h, w = x.shape[1:3]
        wh = cubic_matrix(self.pos_embed.shape[-2], h, x.device)
        ww = cubic_matrix(self.pos_embed.shape[-1], w, x.device)
        pos = torch.einsum("ih,bchw,jw->bcij", wh, self.pos_embed, ww)
        win = self.pos_embed_window
        pos = pos + win.tile(1, 1, h // win.shape[-2], w // win.shape[-1])
        x = x + pos.permute(0, 2, 3, 1)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outs.append(x.permute(0, 3, 1, 2))
        return outs


class ImageEncoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.trunk = Hiera(cfg.trunk)
        self.neck = nn.Module()
        self.neck.convs = nn.ModuleList(nn.Module() for _ in cfg.trunk.channel_list)
        for m, c in zip(self.neck.convs, cfg.trunk.channel_list):
            m.conv = nn.Conv2d(c, cfg.neck.d_model, 1)
        self.cfg, self.scalp = cfg.neck, cfg.scalp

    def forward(self, x):
        xs = self.trunk(x)
        n = len(xs) - 1
        out, prev = [None] * len(xs), None
        for i in range(n, -1, -1):
            lateral = self.neck.convs[n - i].conv(xs[i])
            if i in self.cfg.fpn_top_down_levels and prev is not None:
                prev = lateral + F.interpolate(prev, scale_factor=2.0, mode="nearest")
                if self.cfg.fuse_type == "avg":
                    prev = prev / 2
            else:
                prev = lateral
            out[i] = prev
        return out[:len(out) - self.scalp] if self.scalp > 0 else out


# memory attention (memory_attention.py, transformer.py RoPEAttention)


class MemoryAttentionLayer(nn.Module):
    def __init__(self, c: MemAttn):
        super().__init__()
        d = c.d_model
        self.c = c
        self.self_attn = Attention(d, c.num_heads)
        self.cross_attn_image = Attention(d, c.num_heads, kv_in_dim=c.kv_in_dim)
        self.linear1, self.linear2 = nn.Linear(d, c.dim_feedforward), nn.Linear(c.dim_feedforward, d)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(d) for _ in range(3))

    def _rope_attn(self, attn, q, k, v, n_rot_k: int):
        """RoPE attention: q rotated by the frame's table, the first n_rot_k
        keys by the same table repeated per memory frame, the rest (object
        pointers) not rotated."""
        c = self.c
        n = attn.num_heads
        q, k, v = heads(attn.q_proj(q), n), heads(attn.k_proj(k), n), heads(attn.v_proj(v), n)
        cos, sin = axial_rope(q.shape[-1], *c.rope_feat_sizes, c.rope_theta, q.device)
        q = rotate(q, cos, sin)
        reps = n_rot_k // cos.shape[0]
        k = torch.cat([rotate(k[:, :, :n_rot_k], cos.repeat(reps, 1), sin.repeat(reps, 1)),
                       k[:, :, n_rot_k:]], 2)
        return attn.out_proj(unheads(sdpa(q, k, v)))

    def forward(self, tgt, memory, query_pos, memory_pos, n_rot_k: int):
        c = self.c
        t2 = self.norm1(tgt)
        qk = t2 + query_pos if c.pos_enc_at_attn else t2
        tgt = tgt + self._rope_attn(self.self_attn, qk, qk, t2, qk.shape[1])
        t2 = self.norm2(tgt)
        q = t2 + query_pos if c.pos_enc_at_cross_attn_queries else t2
        k = memory + memory_pos if c.pos_enc_at_cross_attn_keys else memory
        tgt = tgt + self._rope_attn(self.cross_attn_image, q, k, memory, n_rot_k)
        t2 = self.norm3(tgt)
        act = F.relu if c.activation == "relu" else F.gelu
        return tgt + self.linear2(act(self.linear1(t2)))


class MemoryAttention(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg.memory_attention
        self.c = c
        self.layers = nn.ModuleList(MemoryAttentionLayer(c) for _ in range(c.num_layers))
        self.norm = nn.LayerNorm(c.d_model)

    def forward(self, curr, memory, curr_pos, memory_pos, n_rot_k: int):
        out = curr + 0.1 * curr_pos if self.c.pos_enc_at_input else curr
        for layer in self.layers:
            out = layer(out, memory, curr_pos, memory_pos, n_rot_k)
        return self.norm(out)


# memory encoder (memory_encoder.py)


class CXBlock(nn.Module):
    def __init__(self, dim, k, p):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, k, padding=p, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1, self.pwconv2 = nn.Linear(dim, 4 * dim), nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = self.norm(self.dwconv(x)).movedim(1, -1)
        return x + (self.gamma * self.pwconv2(F.gelu(self.pwconv1(y)))).movedim(-1, 1)


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.memory_encoder
        layers, c_in = [], 1
        for _ in range(int(math.log2(m.mask_total_stride) // math.log2(m.mask_downsampler_stride))):
            c_out = c_in * m.mask_downsampler_stride ** 2
            layers += [nn.Conv2d(c_in, c_out, m.mask_downsampler_kernel, m.mask_downsampler_stride,
                                 m.mask_downsampler_padding), LayerNorm2d(c_out), GELU()]
            c_in = c_out
        layers.append(nn.Conv2d(c_in, m.in_dim, 1))
        self.mask_downsampler = nn.Module()
        self.mask_downsampler.encoder = nn.Sequential(*layers)
        self.pix_feat_proj = nn.Conv2d(m.in_dim, m.in_dim, 1)
        self.fuser = nn.Module()
        self.fuser.layers = nn.ModuleList(CXBlock(m.in_dim, m.cx_kernel_size, m.cx_padding)
                                          for _ in range(m.fuser_num_layers))
        self.out_proj = nn.Conv2d(m.in_dim, m.out_dim, 1)

    def forward(self, pix_feat, masks):
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler.encoder(masks)
        for blk in self.fuser.layers:
            x = blk(x)
        return self.out_proj(x)


# prompt encoder and mask decoder (prompt_encoder.py, mask_decoder.py, transformer.py)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        C, mc = cfg.hidden_dim, cfg.mask_in_chans
        self.cfg = cfg
        self.pe_layer = nn.Module()
        self.pe_layer.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, C // 2))
        self.point_embeddings = nn.ModuleList(Embedding(1, C) for _ in range(4))
        self.not_a_point_embed = Embedding(1, C)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mc // 4, 2, 2), LayerNorm2d(mc // 4), GELU(),
            nn.Conv2d(mc // 4, mc, 2, 2), LayerNorm2d(mc), GELU(), nn.Conv2d(mc, C, 1))
        self.no_mask_embed = Embedding(1, C)

    @property
    def gaussian(self):
        return self.pe_layer.positional_encoding_gaussian_matrix

    def dense_pe(self):
        s = self.cfg.image_embedding_size
        x = (torch.arange(s, dtype=torch.float32, device=self.gaussian.device) + 0.5) / s
        grid = torch.stack(torch.meshgrid(x, x, indexing="xy"), -1)  # [s, s, (x, y)]
        return fourier(self.gaussian, grid).permute(2, 0, 1)[None]

    def forward(self, coords, labels, mask_input=None):
        """coords [B, P, 2] model-frame pixels, labels [B, P]; one padding
        point is appended (prompt_encoder.py:124-166)."""
        B, S = coords.shape[0], self.cfg.image_size
        coords = torch.cat([coords + 0.5, coords.new_zeros(B, 1, 2)], 1)
        labels = torch.cat([labels, -labels.new_ones(B, 1)], 1)[..., None]
        pe = fourier(self.gaussian, coords / S)
        emb = torch.where(labels == -1, self.not_a_point_embed.weight[0].expand_as(pe), pe)
        for i in range(4):
            emb = torch.where(labels == i, emb + self.point_embeddings[i].weight[0], emb)
        if mask_input is not None:
            dense = self.mask_downscaling(mask_input)
        else:
            s = self.cfg.image_embedding_size
            dense = self.no_mask_embed.weight[0][None, :, None, None].expand(B, -1, s, s)
        return emb, dense


class TwoWayBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_dim, skip_first_layer_pe):
        super().__init__()
        self.self_attn = Attention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = Attention(dim, num_heads, downsample_rate=2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLP(dim, mlp_dim, dim, 2)
        self.norm3, self.norm4 = nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.cross_attn_image_to_token = Attention(dim, num_heads, downsample_rate=2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        C = cfg.hidden_dim
        self.cfg = cfg
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            TwoWayBlock(C, cfg.sam_mask_decoder_num_heads, cfg.sam_mask_decoder_mlp_dim, i == 0)
            for i in range(cfg.sam_mask_decoder_depth))
        self.transformer.final_attn_token_to_image = Attention(
            C, cfg.sam_mask_decoder_num_heads, downsample_rate=2)
        self.transformer.norm_final_attn = nn.LayerNorm(C)
        self.iou_token = Embedding(1, C)
        self.mask_tokens = Embedding(self.num_mask_tokens, C)
        self.obj_score_token = Embedding(1, C)
        self.output_upscaling = nn.ModuleList([
            nn.ConvTranspose2d(C, C // 4, 2, 2), LayerNorm2d(C // 4), nn.Identity(),
            nn.ConvTranspose2d(C // 4, C // 8, 2, 2), nn.Identity()])
        self.conv_s0, self.conv_s1 = nn.Conv2d(C, C // 8, 1), nn.Conv2d(C, C // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(C, C, C // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(C, cfg.iou_head_hidden_dim, self.num_mask_tokens,
                                       cfg.iou_head_depth,
                                       sigmoid_output=cfg.iou_prediction_use_sigmoid)
        self.pred_obj_score_head = MLP(C, C, 1, 3)

    def forward(self, image_emb, image_pe, sparse, dense, multimask_output: bool, hrf0, hrf1):
        """(masks, ious, sam output tokens, object score logits)
        (mask_decoder.py:116-316)."""
        cfg, B = self.cfg, sparse.shape[0]
        out_tokens = torch.cat([self.obj_score_token.weight, self.iou_token.weight,
                                self.mask_tokens.weight])
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], 1)
        if image_emb.shape[0] != B:
            image_emb, hrf0, hrf1 = (t.expand(B, *t.shape[1:]) for t in (image_emb, hrf0, hrf1))
        src = image_emb + dense
        _, C, H, W = src.shape
        keys = src.flatten(2).transpose(1, 2)
        key_pe = image_pe.expand(B, -1, -1, -1).flatten(2).transpose(1, 2)
        queries = tokens
        for layer in self.transformer.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = self.transformer.norm_final_attn(
            queries + self.transformer.final_attn_token_to_image(q, k, keys))
        iou_out, mask_out = queries[:, 1], queries[:, 2:2 + self.num_mask_tokens]
        dc1, ln1, _, dc2, _ = self.output_upscaling
        up = F.gelu(ln1(dc1(keys.transpose(1, 2).reshape(B, C, H, W)) + hrf1))
        up = F.gelu(dc2(up) + hrf0)
        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        b, c, h, w = up.shape
        masks = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        ious = self.iou_prediction_head(iou_out)
        obj = self.pred_obj_score_head(queries[:, 0])
        if multimask_output:
            masks_out, ious_out = masks[:, 1:], ious[:, 1:]
        elif cfg.dynamic_multimask_via_stability:
            self.last_stability = stability(masks[:, :1], cfg.dynamic_multimask_stability_delta)
            masks_out, ious_out = _stability_select(masks, ious,
                                                    cfg.dynamic_multimask_stability_delta,
                                                    cfg.dynamic_multimask_stability_thresh)
        else:
            masks_out, ious_out = masks[:, :1], ious[:, :1]
        tok = mask_out[:, 1:] if multimask_output and cfg.use_multimask_token_for_obj_ptr \
            else mask_out[:, :1]
        return masks_out, ious_out, tok, obj


def stability(masks, delta):
    """Share of the area above -delta that is above +delta, per mask."""
    flat = masks.flatten(-2)
    inter, union = (flat > delta).sum(-1).float(), (flat > -delta).sum(-1).float()
    return torch.where(union > 0, inter / union.clamp_min(1), 1.0)


def _stability_select(masks, ious, delta, thresh):
    stable = stability(masks[:, :1], delta) >= thresh
    best = ious[:, 1:].argmax(-1)
    rows = torch.arange(masks.shape[0], device=masks.device)
    best_masks, best_ious = masks[:, 1:][rows, best][:, None], ious[:, 1:][rows, best][:, None]
    return (torch.where(stable[..., None, None], masks[:, :1], best_masks),
            torch.where(stable, ious[:, :1], best_ious))


class SAM2(nn.Module):
    """Every parameter of SAM2.1 under its upstream key."""

    def __init__(self, cfg: Config):
        super().__init__()
        C = cfg.hidden_dim
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg)
        self.memory_attention = MemoryAttention(cfg)
        self.memory_encoder = MemoryEncoder(cfg)
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg)
        self.obj_ptr_proj = MLP(C, C, C, 3)
        self.obj_ptr_tpos_proj = nn.Linear(C, cfg.mem_dim)
        self.mask_downsample = nn.Conv2d(1, 1, 4, 4)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, C))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, C))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, C))
        self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, cfg.mem_dim))

    # sam2_base.py

    def encode(self, images01):
        """[B, 3, S, S] images in [0, 1] -> (hrf0, hrf1, embed)
        (sam2_base.py forward_image)."""
        mean = torch.tensor(IMAGENET_MEAN, device=images01.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=images01.device)[:, None, None]
        fpn = self.image_encoder((images01 - mean) / std)
        return (self.sam_mask_decoder.conv_s0(fpn[0]), self.sam_mask_decoder.conv_s1(fpn[1]),
                fpn[2])

    def sam_heads(self, feat, hrf0, hrf1, coords, labels, mask_prompt=None,
                  multimask_output: bool = False):
        """(low-res masks, high-res masks, ious, obj_ptr, object score
        logits) of the chosen mask (sam2_base.py _forward_sam_heads)."""
        cfg = self.cfg
        sparse, dense = self.sam_prompt_encoder(coords, labels, mask_prompt)
        masks, ious, tokens, obj = self.sam_mask_decoder(
            feat, self.sam_prompt_encoder.dense_pe(), sparse, dense, multimask_output, hrf0, hrf1)
        masks = torch.where(obj[:, :, None, None] > 0, masks, NO_OBJ_SCORE)
        high = resize(masks, (cfg.image_size, cfg.image_size))
        token = tokens[:, 0]
        if multimask_output:
            best = ious.argmax(-1)
            rows = torch.arange(best.shape[0], device=best.device)
            masks, high, token = masks[rows, best][:, None], high[rows, best][:, None], \
                tokens[rows, best]
        ptr = self.obj_ptr_proj(token)
        appearing = (obj > 0).float()
        ptr = appearing * ptr + (1.0 - appearing) * self.no_obj_ptr[0]
        return masks, high, ious, ptr, obj

    def encode_memory(self, embed, high_res_masks, obj, binarize: bool):
        """bf16 memory features (sam2_base.py _encode_new_memory; the
        video predictor stores them in bf16)."""
        cfg = self.cfg
        m = (high_res_masks > 0).float() if binarize else torch.sigmoid(high_res_masks)
        m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
        feats = self.memory_encoder(embed, m)
        absent = (obj <= 0).float()[:, :, None, None]
        feats = feats + absent * self.no_obj_embed_spatial[0][None, :, None, None]
        return feats.to(torch.bfloat16)


# hole filling: the port's documented bounded min-label propagation
# (ops/connected_components.py, num_iters=16)


def _run_offsets(mask, dim):
    n = mask.shape[dim]
    first = (torch.arange(n, device=mask.device) == 0).view(
        [n if d == dim % mask.ndim else 1 for d in range(mask.ndim)])

    def off(m):
        starts = ~torch.roll(m, 1, dims=dim) | first | ~m
        return torch.cumsum(starts, dim=dim, dtype=torch.int64) * (2 ** 31)

    return off(mask), off(mask.flip(dim))


def _scan(labels, mask, dim, offsets):
    fwd, bwd = offsets
    labels = torch.cummin(labels - fwd, dim=dim).values + fwd
    labels = (torch.cummin(labels.flip(dim) - bwd, dim=dim).values + bwd).flip(dim)
    return torch.where(mask, labels, 2 ** 30)


def component_areas(mask, num_iters: int = 16):
    """8-connected component (labels > 0, areas) of [B, H, W] bool masks."""
    B, H, W = mask.shape
    inf = 2 ** 30
    labels = torch.where(mask, torch.arange(H * W, device=mask.device).view(1, H, W), inf)
    rows, cols = _run_offsets(mask, -1), _run_offsets(mask, -2)
    for _ in range(num_iters):
        p = F.pad(labels, (1, 1, 1, 1), value=inf)
        best = labels
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                best = torch.minimum(best, p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
        labels = torch.where(mask, best, inf)
        labels = _scan(labels, mask, -1, rows)
        labels = _scan(labels, mask, -2, cols)
    flat = torch.where(mask, labels, 0).view(B, H * W)
    counts = torch.zeros(B, H * W, dtype=torch.int64, device=mask.device)
    counts.scatter_add_(1, flat, mask.view(B, H * W).long())
    return torch.where(mask, counts.gather(1, flat).view(B, H, W), 0)


def fill_holes(masks, max_area: int):
    """Background components of area <= max_area get the score 0.1
    (sam2 utils/misc.py fill_holes_in_mask_scores)."""
    if max_area <= 0:
        return masks
    flat = masks.reshape(-1, *masks.shape[-2:])
    areas = component_areas(flat <= 0)
    return torch.where((areas > 0) & (areas <= max_area), 0.1, flat).reshape(masks.shape)


def build(cfg: Config, state_dict, device) -> SAM2:
    """The reference model holding `state_dict`, fp32, on `device`."""
    with torch.device("meta"):
        model = SAM2(cfg)
    model.load_state_dict({k: v.float() for k, v in state_dict.items()}, strict=True, assign=True)
    return model.to(device).eval()
