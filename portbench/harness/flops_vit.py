"""Operations and bytes of Segment Anything's ViT cells: the yardstick of
`relpos_attn_roofline.*` and `mfu.*` there, at `harness/flops.py`'s peaks.

The model counts are multiply-adds times two of every matrix product and
convolution the inputs need (upstream's math, so the windowed blocks count
the padded tokens: the 64 x 64 grid padded to 70 x 70 runs the qkv
projection, the attention and the output projection on 4,900 tokens; the
residual add crops, so the MLP runs on 4,096): the patch embedding, per
block qkv, the logits and p . v, the two relative-position products (q with
the [K, K, d] tables of each axis), the output projection and the MLP, the
neck's 1x1 and 3x3 convolutions; then the prompt encoder and the mask
decoder. Elementwise work is not counted.

The relative-position attention's least time (`relpos_bound_s`) counts what
the kernel does: the logits and p . v at the bf16 peak against q, k, v and
out read or written once in bf16, and q's products with the two tables
(2 Kh - 1 + 2 Kw - 1 a row, from which the kernel gathers the bias terms)
read once. The products are one cuBLAS call before the kernel, so their
operations are in the model's count and not in the kernel's bound.
"""

from __future__ import annotations

from portbench.harness.flops import BF16, PEAK_BF16, PEAK_BYTES, _mm


def _grid(model: dict):
    e = model["encoder"]
    g = model["image_size"] // e["patch_size"]
    ws = e["window_size"]
    return e, g, g + (-g) % ws, ws


def relpos_calls(model: dict):
    """(B, heads, Sq, Skv, head_dim, Kh, Kw) of each block's attention in one
    encoded image: 25 padded windows of 196 tokens, or the 4,096-token grid."""
    e, g, gp, ws = _grid(model)
    d = e["embed_dim"] // e["num_heads"]
    windowed = ((gp // ws) ** 2, e["num_heads"], ws * ws, ws * ws, d, ws, ws)
    glob = (1, e["num_heads"], g * g, g * g, d, g, g)
    return [glob if i in e["global_attn_indexes"] else windowed for i in range(e["depth"])]


def relpos_bound_s(B, H, Sq, Skv, D, Kh, Kw, itemsize=BF16):
    """Least time of one relative-position attention call: 4 * Sq * Skv * D
    operations per (batch, head) at the bf16 peak; q, k, v and out, and the
    [Sq, 2 Kh - 1 + 2 Kw - 1] products, read or written once."""
    flops = 4.0 * B * H * Sq * Skv * D
    nbytes = itemsize * B * H * (D * (2 * Sq + 2 * Skv) + Sq * (2 * Kh + 2 * Kw - 2))
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def encoder_flops(model: dict) -> float:
    """One image through the ViT and its neck."""
    e, g, _, _ = _grid(model)
    C, p = e["embed_dim"], e["patch_size"]
    total = _mm(g * g, 3 * p * p, C)
    for B, H, Sq, Skv, d, Kh, Kw in relpos_calls(model):
        n = B * Sq  # tokens the block's attention sees, padding included
        total += _mm(n, C, 3 * C) + _mm(n, C, C)
        total += B * H * (4.0 * Sq * Skv * d + _mm(Sq, d, Kh) + _mm(Sq, d, Kw))  # upstream's
        total += 2 * _mm(g * g, C, int(C * e["mlp_ratio"]))
    out = e["out_chans"]
    return total + _mm(g * g, C, out) + _mm(g * g, 9 * out, out)


def decoder_flops(model: dict, n_points: int, box: bool, mask_prompt: bool) -> float:
    """SAM's prompt encoder and mask decoder for one prompt: the iou and
    mask tokens, the points (and a padding point without a box) and the
    box's two corners; the two-way transformer, the upscaling, the
    hypernetworks and the IoU head; with a mask prompt, its downscaling."""
    C, g = model["hidden_dim"], model["image_size"] // model["backbone_stride"]
    N, M = g * g, model["num_multimask_outputs"] + 1
    T = 1 + M + n_points + (0 if box else 1) + (2 if box else 0)
    half, mlp = C // 2, model["sam_mask_decoder_mlp_dim"]
    per_layer = (4 * _mm(T, C, C) + 4.0 * T * T * C
                 + _mm(T, C, half) + 2 * _mm(N, C, half) + 4.0 * T * N * half + _mm(T, half, C)
                 + 2 * _mm(T, C, mlp)
                 + _mm(N, C, half) + 2 * _mm(T, C, half) + 4.0 * N * T * half + _mm(N, half, C))
    final = _mm(T, C, half) + 2 * _mm(N, C, half) + 4.0 * T * N * half + _mm(T, half, C)
    upscale = _mm(N, C, C // 4 * 4) + _mm(4 * N, C // 4, C // 8 * 4)
    heads = M * (2 * _mm(1, C, C) + _mm(1, C, C // 8)) + _mm(M, C // 8, 16 * N)
    iou = _mm(1, C, model["iou_head_hidden_dim"]) * (model["iou_head_depth"] - 1) \
        + _mm(1, model["iou_head_hidden_dim"], M)
    total = model["sam_mask_decoder_depth"] * per_layer + final + upscale + heads + iou
    if mask_prompt:
        mc = model["mask_in_chans"]
        total += _mm(4 * N, 4, mc // 4) + _mm(N, 4 * (mc // 4), mc) + _mm(N, mc, C)
    return total
