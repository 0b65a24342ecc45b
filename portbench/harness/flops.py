"""Operations and bytes: the yardstick of every roofline and utilization.

Published H100 SXM peaks (NVIDIA data sheet, dense): 989 TFLOP/s in bf16
on the tensor cores, 67 TFLOP/s in fp32 on the CUDA cores, 3.35 TB/s of
HBM. A kernel's least time is the larger of its operations over the peak
rate and its bytes over the memory rate, each input read once and each
output written once (the attention bounds are those of the port's kernel
table, `k1_bound_ms` / `k2_bound_ms`, here at the bf16 peak).

The model counts are multiply-adds times two of every matrix product and
convolution the inputs need, from the configuration and the shapes: the
trunk, the neck, the mask decoder's two feature projections, the prompt
encoder, the mask decoder, memory attention over the memory tokens present
(valid ones, not the padded capacity) and the memory encoder. Elementwise
work, recomputation and padding are not counted.
"""

from __future__ import annotations

import math

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
BF16 = 2


def k1_bound_s(B, H, Sq, Skv, D, itemsize=BF16, valid_keys=None):
    """Least time of flash attention (K1): 4 * Sq * keys * D operations per
    (batch, head) at the bf16 peak; q, k, v and out read or written once,
    plus the fp32 log-sum-exp rows."""
    valid = B * Skv if valid_keys is None else valid_keys
    flops = 4.0 * H * Sq * valid * D
    nbytes = itemsize * B * H * D * (2 * Sq + 2 * Skv) + 4 * B * H * Sq
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def k2_bound_s(B, Sq, Skv, D, itemsize=BF16, valid_keys=None):
    """Least time of RoPE-fused attention (K2, one head): K1's on these
    inputs plus the rotation's 3 operations per K element on the fp32
    cores and its two [Skv, D/2] tables read once, and the [B, Skv] mask."""
    valid = B * Skv if valid_keys is None else valid_keys
    nbytes = itemsize * (B * D * (2 * Sq + 2 * Skv) + Skv * D) + B * Skv + 4 * B * Sq
    t_ops = 4.0 * Sq * valid * D / PEAK_BF16 + 3.0 * B * Skv * D / PEAK_FP32
    return max(t_ops, nbytes / PEAK_BYTES)


def k3_bound_s(B, H, Sq, Skv, D, part: str, itemsize=BF16, valid_keys=None):
    """Least time of the flash backward: K3a ("dkdv": S, dP, dV, dK, four
    products) or K3b ("dq": S, dP, dQ, three), two operations per
    multiply-add at the bf16 peak; q, k, v, dO read once, the fp32 lse and
    delta rows once, the key mask once, each fp32 gradient written once."""
    valid = B * Skv if valid_keys is None else valid_keys
    products = 4 if part == "dkdv" else 3
    flops = 2.0 * products * H * Sq * valid * D
    out_rows = 2 * Skv if part == "dkdv" else Sq
    nbytes = (itemsize * B * H * D * (2 * Sq + 2 * Skv) + 8 * B * H * Sq + B * Skv
              + 4 * B * H * D * out_rows)
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def k1_calls(model: dict):
    """K1's calls in one encoded image: (B, heads, Sq, Skv, head_dim) of
    each global-attention block of the trunk."""
    t = model["trunk"]
    ends = [sum(t["stages"][:i + 1]) - 1 for i in range(len(t["stages"]))]
    res, dim, heads, calls = model["image_size"] // t["patch_stride"][0], t["embed_dim"], \
        t["num_heads"], []
    for i in range(sum(t["stages"])):
        if i - 1 in ends:
            res, dim, heads = res // 2, int(dim * t["dim_mul"]), int(heads * t["head_mul"])
        if i in t["global_att_blocks"]:
            calls.append((1, heads, res * res, res * res, dim // heads))
    return calls


def _mm(m, k, n):
    return 2.0 * m * k * n


def _window_pairs(length: int, ws: int):
    """Sum of squared real lengths of the windows along one axis."""
    full, rest = divmod(length, ws)
    return full * ws * ws + rest * rest


def trunk_flops(model: dict, size: int) -> float:
    """The Hiera trunk at a size x size input, from the configuration's
    `trunk` group: patch and positional embeddings, then per block the qkv, attention
    (windowed over real tokens, or global), projection, MLP and, where the
    width changes, the shortcut projection."""
    t = model["trunk"]
    kh, kw = t["patch_kernel"]
    sh, sw = t["patch_stride"]
    H, W = size // sh, size // sw
    bh, bw = t["window_pos_embed_bkg_spatial_size"]
    # patch embedding; the background positional embedding's cubic resize
    total = _mm(H * W, 3 * kh * kw, t["embed_dim"]) + 2.0 * t["embed_dim"] * H * bw * (bh + W)
    ends = [sum(t["stages"][:i + 1]) - 1 for i in range(len(t["stages"]))]
    q_pool_blocks = [x + 1 for x in ends[:-1]][:t["q_pool"]]
    dim, stage = t["embed_dim"], 1
    for i in range(sum(t["stages"])):
        dim_out, ws = dim, t["window_spec"][stage - 1]
        if i in t["global_att_blocks"]:
            ws = 0
        if i - 1 in ends:
            dim_out, stage = int(dim * t["dim_mul"]), stage + 1
        pool = 4 if i in q_pool_blocks else 1
        n_in, n_out = H * W, H * W // pool
        total += _mm(n_in, dim, 3 * dim_out)
        if dim != dim_out:
            total += _mm(n_in, dim, dim_out)
        if ws > 0:  # sum over windows of q_len * kv_len, real tokens only
            total += 4.0 * _window_pairs(H, ws) * _window_pairs(W, ws) / pool * dim_out
        else:
            total += 4.0 * n_out * n_in * dim_out
        total += _mm(n_out, dim_out, dim_out) + 2 * _mm(n_out, dim_out,
                                                       int(dim_out * t["mlp_ratio"]))
        if pool > 1:
            H, W = H // 2, W // 2
        dim = dim_out
    return total


def encoder_flops(model: dict) -> float:
    """One image through the trunk, the FPN's lateral convolutions and the
    mask decoder's two high-resolution projections."""
    size, C = model["image_size"], model["hidden_dim"]
    t = model["trunk"]
    total = trunk_flops(model, size)
    grid = size // t["patch_stride"][0]
    dim = t["embed_dim"]
    for level in range(len(t["stages"])):
        total += _mm(grid * grid, dim, model["neck"]["d_model"])
        grid, dim = grid // 2, int(dim * t["dim_mul"])
    g0 = size // t["patch_stride"][0]
    return total + _mm(g0 * g0, C, C // 8) + _mm((g0 // 2) ** 2, C, C // 4)


def decoder_flops(model: dict, B: int, n_points: int, mask_prompt: bool) -> float:
    """Prompt encoder and mask decoder for B prompts of n_points points
    (plus the padding point), all mask tokens: the two-way transformer's
    projections and attention, the upscaling, the hypernetwork products."""
    C, g = model["hidden_dim"], model["image_size"] // model["backbone_stride"]
    N, T = g * g, 2 + model["num_multimask_outputs"] + 1 + n_points + 1
    half, mlp = C // 2, model["sam_mask_decoder_mlp_dim"]
    per_layer = (4 * _mm(T, C, C) + 4.0 * T * T * C                      # token self-attention
                 + _mm(T, C, half) + 2 * _mm(N, C, half) + 4.0 * T * N * half
                 + _mm(T, half, C)                                          # token -> image
                 + 2 * _mm(T, C, mlp)                                       # token MLP
                 + _mm(N, C, half) + 2 * _mm(T, C, half) + 4.0 * N * T * half
                 + _mm(N, half, C))                                         # image -> token
    final = _mm(T, C, half) + 2 * _mm(N, C, half) + 4.0 * T * N * half + _mm(T, half, C)
    upscale = _mm(N, C, C // 4 * 4) + _mm(4 * N, C // 4, C // 8 * 4)
    M = model["num_multimask_outputs"] + 1
    heads = M * 3 * _mm(1, C, C) + _mm(M, C // 8, 16 * N) + 3 * _mm(1, C, C) * 2
    total = model["sam_mask_decoder_depth"] * per_layer + final + upscale + heads
    if mask_prompt:
        mc = model["mask_in_chans"]
        total += (_mm(4 * N, 4, mc // 4) + _mm(N, 4 * (mc // 4), mc) + _mm(N, mc, C))
    return B * total


def memory_attention_flops(model: dict, B: int, valid_keys: int) -> float:
    """Memory attention for B objects over `valid_keys` memory tokens each:
    per layer the self-attention (projections and RoPE attention over the
    frame's tokens), the cross-attention (q and out projections, k and v
    projections of the valid memory tokens, attention) and the FFN."""
    m = model["memory_attention"]
    g = model["image_size"] // model["backbone_stride"]
    N, d, kv = g * g, m["d_model"], m["kv_in_dim"]
    per_layer = (4 * _mm(N, d, d) + 4.0 * N * N * d
                 + 2 * _mm(N, d, d) + 2 * _mm(valid_keys, kv, d) + 4.0 * N * valid_keys * d
                 + 2 * _mm(N, d, m["dim_feedforward"]))
    return B * m["num_layers"] * per_layer


def memory_encoder_flops(model: dict, B: int) -> float:
    """Mask downsampler, pixel projection, ConvNeXt fuser, output projection."""
    e = model["memory_encoder"]
    size = model["image_size"]
    total, c_in, hw = 0.0, 1, size
    n_ds = int(round(math.log2(e["mask_total_stride"]) / math.log2(e["mask_downsampler_stride"])))
    k = e["mask_downsampler_kernel"]
    for _ in range(n_ds):
        c_out, hw = c_in * e["mask_downsampler_stride"] ** 2, hw // e["mask_downsampler_stride"]
        total += _mm(hw * hw, k * k * c_in, c_out)
        c_in = c_out
    N, d = hw * hw, e["in_dim"]
    total += _mm(N, c_in, d) + _mm(N, d, d)
    total += e["fuser_num_layers"] * (2.0 * N * d * e["cx_kernel_size"] ** 2
                                      + 2 * _mm(N, d, 4 * d))
    return B * (total + _mm(N, d, e["out_dim"]))


def pointer_flops(model: dict, B: int, n_ptrs: int) -> float:
    """Object-pointer MLP and the pointers' temporal projection."""
    C, mem = model["hidden_dim"], model["mem_dim"]
    return B * (3 * _mm(1, C, C) + _mm(n_ptrs, C, mem))
