"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --kernel-times   # build, then the kernel times of
                                           # phases 7 (K1, K2) and 14 (K5-K8) and
                                           # K1 at D = 256 only

`--kernel-times` times whichever `sam2_opt_tpu_torch` it imports, so a copy
of this script in another checkout's root times that checkout's kernels:
run parent, change, change, parent in one call to compare two commits.

Phases (any failure exits non-zero, and no result line is printed):
1. device: the card's name and power limit;
2. build: every CUDA kernel of `sam2_opt_tpu_torch/csrc/`, compiled with nvcc
   (one nvcc per source, all started together);
3. K1 (flash-attention forward) against its plain PyTorch version on the
   card, in bf16 and fp32: at the hiera-L, b+ and t global-attention shapes,
   at the hiera-L shape as strided views of one qkv projection (as the
   trunk hands them over), and on a ragged masked case;
4. K2 (the RoPE-fused forward) against its plain version, bf16 and fp32: the
   memory-attention self shape with the real [4096, 128] tables, the cross
   shape (28,736 keys: 7 tiled frame tables + 64 identity rows) with 3 of 7
   slots and 9 of 16 pointers masked, two objects with different masks, a
   ragged case with one batch row fully masked; and a negative control, the
   cross case with identity tables, which must fail the check;
5. the image slice: `build_sam2_image_predictor("hiera_l", seed=0)` at full
   width and depth at 1024², `set_image` on a 1500x2000 image and `predict`
   with a point, a box and points plus a box, multimask on and off; fp32 held
   against the same weights on the CPU (plain path), then `speedup()` to bf16
   held to the fp32 masks by mIoU; K1 must launch exactly 3 times per
   `set_image`;
6. the video slice: `build_sam2_video_predictor("hiera_l", seed=0)` on a
   synthetic 8-frame 720x1280 video (a textured square moving over a
   textured background), points on frame 0, `propagate_in_video` over all
   frames in fp32 and, after `speedup()`, in bf16: K1 exactly 3 launches per
   encoded frame, K2 none on the conditioning frame and 8 per tracked frame;
   bf16 held to fp32 by per-frame mask mIoU; fp32 logits of the first 3
   frames held against the same weights on the CPU; a two-object run (points
   on one, `add_new_mask` on the other) over 3 frames, tracked as one batch
   (8 K2 launches per frame, not 16);
7. times: image set_image / predict and the video's per-frame propagation
   (CUDA events, wall per call), peak device memory, torch.profiler splits of
   set_image and of a tracked frame by kernel family with the device's busy
   time and idle share (1 - busy / wall; one stream, so kernels do not
   overlap); K1 and K2 beside their plain versions, the library calls
   (`F.scaled_dot_product_attention`, after the rotation in plain torch for
   K2: yardsticks the port never calls) and their bounds;
8. K3 (the flash-attention backward: K3a dK/dV, K3b dQ) against its plain
   version at the three training shapes (hiera-b+ global blocks as one
   8-frame batch, memory-attention cross and self attention), bf16 and
   fp32, with masked slots and an all-masked batch row, the global-block
   case also as strided views of one [8, 4096, 3, 8, 56] projection; a
   second launch bitwise equal to the first (no atomics); a negative
   control (lse shifted by +1) that must fail; times beside the bound, the
   plain version and the SDPA backward, with each kernel's tile, CTA count
   and split as its library reports them (`bwd_tiling`), in the log only;
9. training, fp32 on the card against the CPU with the same weights:
   hiera-b+ at 1024², 2 frames, one object, mask prompt, through
   `video_train_loss` and backward, on the default route and under
   `SAM2_TPU_FUSED_ROPE=0`: the loss and every gradient agree, and
   memory attention's q/k projections get a nonzero gradient;
10. training through `Trainer.run` (the slice's main path): hiera-b+ at
   1024², one 8-frame video of two objects per batch, remat "encoder", 3
   steps in fp32 and 3 in bf16, with exact K1/K2/K3 launch counts per step;
   finite losses, fp32 masters that moved, bf16 within 10% of fp32 on the
   first step; ms per step, peak memory and the device split and idle share
   of one profiled step, with K3's device time in it; and, where Pillow is
   installed, the CLI on a small PNG folder.

11. K5, K6 and K7 (one per-window attention kernel behind three wrappers)
   against their plain version, bf16 and fp32: at hiera-L's four windowed
   stage shapes as strided views of one [N, S, 3, heads, 72] projection
   (K5 on the [N, heads, S, D] views `flash_or_sdpa` hands over), ragged
   windows of 49 and 196 tokens at D = 56 and 96, K7 with 16 queries over 64
   keys; a negative control (the plain version at twice the scale) that
   must fail;
12. K8 (the fused block MLP) against its plain version, bf16: hiera-L's and
   b+'s four block-MLP shapes and a ragged N = 1000; a negative control
   (the plain version without its GELU) that must fail; gradients
   through K6, K7 and K8 against autograd through their plain versions, and
   K5 under autograd raising;
13. the slice: the hiera-L image predictor of phase 5 with the JAX
   package's trunk switches (W1: SAM2_TPU_WINDOW_KERNEL=1,
   SAM2_TPU_FLASH_WINDOW_MIN=64, SAM2_TPU_FUSED_MLP=1; W2:
   SAM2_TPU_PACKED_WINDOW=256, SAM2_TPU_FUSED_MLP=1), in bf16 (W1, W2) and
   fp32 (W1): exact launch counts per `set_image`, masks held to the
   default bf16 and fp32 routes by mIoU, fp32 logits to the default fp32
   route; in phase 6, 3 bf16 video frames under W1 with per-frame counts;
14. times: `set_image` wall and device split under W1 and W2 beside the
   default route; K5-K8 at their main-path shapes beside their bounds,
   plain versions and library yardsticks (`F.scaled_dot_product_attention`;
   for K8 the unfused bf16 Linear -> GELU -> Linear, three calls).
15. K4 (K2 with the memory K/V projections fused in, the JAX package's
   `SAM2_TPU_FUSED_KV_PROJ=1` route) against its plain version, bf16 and
   fp32, on phase 4's cases with the memory 64 wide; a negative control
   (the plain version without the K bias) that must fail; its seven
   gradients through the seam against autograd of the plain version at the
   cross shape, biases 0.05 and 0.5, beside the same check of the unfused
   route it replaces (two F.linear + K2 forward + K3 backward) as a
   witness; its time beside its bound, its plain version, that unfused
   route and the composite yardstick (two F.linear + rotation + SDPA);
   then K1 at D = 256 (memory attention under `SAM2_TPU_FUSED_ROPE=0`)
   against its plain version on phase 4's cases with a negative control
   (the mask dropped), and its times at the cross and self shapes;
16. the video slice under memory attention's switches: the hiera-L video
   predictor over 3 frames in fp32 and bf16 with exact launches per
   tracked frame (K1, K2, K4): (3, 4, 4) under `SAM2_TPU_FUSED_KV_PROJ=1`,
   (11, 0, 0) under `SAM2_TPU_FUSED_ROPE=0`; fp32 logits held to the
   default route, bf16 masks by mIoU; ms per tracked frame and the device
   split of all three routes;
17. training under the switch: `Trainer.run` at hiera-b+ 1024², two fp32
   and two bf16 steps with exact launches per step (K1 6, K2 28, K4 28, K3a 59, K3b
   59), the fp32 first-step loss held to phase 10's default route; then
   under `SAM2_TPU_FUSED_ROPE=0` (slice 7): two fp32 and two bf16 steps,
   K1 62 per step (56 of them at D = 256, memory attention's: K1's count
   less the trunk's 6), K2 0, K3a and K3b 59, the fp32 first-step loss held to phase 10's and bf16's to
   this route's fp32 within 10%;
18. K9 and K10 (the window bench tool's kernels, the window kernel of phase
   11 behind two more wrappers) against the plain version at the tool's
   four shapes, bf16, with a negative control; then the tool's port
   (`python -m sam2_opt_tpu_torch.tools.bench_window_flash`), whose rows
   give their times beside SDPA and the einsum path.
19. the attention switches the port reads as the JAX package does: under
   `SAM2_TPU_FLASH=0` an fp32 `set_image` + `predict`, 3 tracked frames
   of the hiera-L video predictor and one more under
   `SAM2_TPU_FUSED_KV_PROJ=1` launch no K1, K2 or K4 (the default route
   launches all three), logits within 1e-3 of their scale of the default
   route's; under `SAM2_TPU_KERNEL_FAST_EXP=1` a bf16 route to K1
   (`ops.flash_or_sdpa`) or K2 (memory attention) raises.
Phases run in the order 1-4, 8, 11-12, 5, 7, 13-14, 6-7, 9-10, 15-19; each
phase that sets a switch restores it and logs its wall seconds, which the
summary line before the kernels line gathers under "phase_seconds". Since slice 6, K8 (phases 12-14) is a
warp-specialised wgmma/TMA kernel; phase 14 also gives the bound of the
work it executes (its column split recomputes GEMM1 at hiera-L stages 3-4).
Since slice 7, K3 (phase 8) is one too in bf16, and runs fp32 on the tensor
cores as three TF32 products, so its fp32 bound is counted at 495/3 TFLOP/s.
Since slice 8, K1 in bf16 at D <= 128 (phases 3, 7) is a warp-specialised
wgmma/TMA kernel, timed at hiera-L's and hiera-b+'s global blocks with its
tile, CTAs and exponential floor in the log; the window kernel's fp32 path
(K5-K7, phases 11 and 14) runs one pass of three TF32 products, so its fp32
bound is counted at 495/3 TFLOP/s as well. Since slice 9, K2 (phases 4, 7)
is a rotation kernel run once per call and then K1's body on the rotated K
(bf16: the warp-specialised wgmma/TMA kernel, at D = 256 with 64-key
stages; fp32, also K1's at every D: three-pass TF32 on mma.sync): phase 4
holds the rotation alone bit for bit against the plain rotation, phases 7
and 15 time K2, its rotation and K1 at D = 256 from CUDA graph replays, and
K1's and K2's fp32 bounds count their products at 495/3 TFLOP/s. The build
log keeps ptxas' lines on registers, spills and wgmma serialisation.

The line before the last is a JSON object with one entry per kernel; the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its operations over the peak rate for its input type and
# its bytes over the memory rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# the fp32 rate of the attention kernels (K1-K3, K5): three TF32 products per
# fp32 product (see attention_flops_rate)
K3_FP32_FLOPS = 495e12 / 3
SEED = 0
K1_SHAPES = [  # (B, H, S, D): the global-attention blocks of hiera-L, b+ and t/s at 1024²
    (1, 8, 4096, 72),
    (1, 8, 4096, 56),
    (1, 4, 4096, 96),
]
MAIN_SHAPE = K1_SHAPES[0]
# K1 vs plain: fp32 runs three TF32 products per fp32 product (about 2^-21
# of each, each kv tile's into a zeroed partial) against the plain version's
# fp32 products; in bf16 both take the same bf16 inputs, round P to bf16 and
# accumulate in fp32, so they differ by the order of the sums, P's rounding
# against the running (not the final) row max, and the output's rounding: one
# bf16 ulp is at most 2^-7 = 0.78% of |out|. Sound runs at every shape below
# differ by at most 9.8e-4 (one ulp near 0.2), so bf16 is held at 1% of |out|
# plus 1e-3; at the main shape a typical |out| is 0.02, so a P.V stage off by
# 10% of it fails.
K1_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-3)}  # (rtol, atol)
LSE_TOL = (1e-5, 1e-5)
# fp32 card vs CPU after 48 blocks: the two sum in different orders (K1's
# online softmax, cuBLAS/cuDNN vs MKL), so logits are held relative to their
# scale and IoUs absolutely.
CPU_LOGIT_RTOL = 1e-3
CPU_IOU_ATOL = 1e-3
# bf16 vs fp32 masks: the gate of tests/test_accuracy_gate.py.
BF16_MIOU_MIN = 0.97
BF16_IOU_ATOL = 0.05
# K2 at the memory-attention shapes: D = 256, one head, 7 memory frames of
# 4096 tokens + 16 pointers of 4 tokens.
K2_D, K2_SLOTS, K2_PTRS = 256, 7, 16
K2_SELF = (1, 4096, 4096, K2_D)                        # (B, Sq, Skv, D)
K2_CROSS = (1, 4096, K2_SLOTS * 4096 + 4 * K2_PTRS, K2_D)
# K2 vs plain: K1's reasoning (the rotation itself is bit-exact: both rotate
# in fp32 with one rounding per operation and round once to K's dtype).
# Sound runs: bf16 at most 4.9e-4 at the memory-attention shapes, where the
# mean |out| is 1.0e-2 (cross) and 2.1e-2 (self), 9.8e-4 on the ragged case;
# fp32 at most 4.4e-7. The negative control (no rotation) differs by up to
# 6.1e-2 and leaves 92% (bf16) to 99.9% (fp32) of the elements outside.
K2_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-3)}  # (rtol, atol)
# the video slice
VIDEO_FRAMES = 8
VIDEO_SQUARE = (300, 150)  # (x, y) of the moving square's corner on frame 0
OBJ_BIAS = 10.0            # added to the object-score head's last bias
# bf16 vs fp32 per-frame video masks: the image gate (sound runs: >= 0.9877)
VIDEO_BF16_MIOU_MIN = 0.97
# slice 4: the JAX package's trunk switches, two settings
ROUTES = {
    "W1": {"SAM2_TPU_WINDOW_KERNEL": "1", "SAM2_TPU_FLASH_WINDOW_MIN": "64",
           "SAM2_TPU_FUSED_MLP": "1"},
    "W2": {"SAM2_TPU_PACKED_WINDOW": "256", "SAM2_TPU_FUSED_MLP": "1"},
}
# launches per hiera-L set_image at 1024² (block plan: 42 windowed blocks
# without q-pool, 2 at S = 64, 5 at 16, 32 at 256, 3 at 64; 3 q-pool blocks,
# plain; 3 global blocks, K1; 48 block MLPs); the K6/K7 and K8 routes are
# bf16-only, so in fp32 every windowed block reaches K5
ROUTE_LAUNCHES = {
    ("W1", torch.bfloat16): {"K1": 3, "K5": 5, "K6": 37, "K7": 0, "K8": 48},
    ("W2", torch.bfloat16): {"K1": 3, "K5": 0, "K6": 0, "K7": 42, "K8": 48},
    ("W1", torch.float32): {"K1": 3, "K5": 42, "K6": 0, "K7": 0, "K8": 0},
}
# hiera-L's windowed attention at 1024², (N windows, S tokens, heads, D), and
# its block MLPs (N tokens, C; hidden 4C); hiera-b+'s MLPs
WINDOW_SHAPES = [(1024, 64, 2, 72), (1024, 16, 4, 72), (16, 256, 8, 72), (16, 64, 16, 72)]
MLP_SHAPES_L = [(65536, 144), (16384, 288), (4096, 576), (1024, 1152)]
MLP_SHAPES_BP = [(65536, 112), (16384, 224), (4096, 448), (1024, 896)]
# The window kernel vs plain: fp32 runs true fp32 FMAs on both sides, so
# K1's fp32 tolerance; bf16 within `window_attention_bf16_bound` (both round
# the normalized p and out to bf16 from fp32 values that may differ in their
# last bits, so each may land one ulp, at most 2^-7 relative, apart:
# 2^-7 (p.|v| + |ref|) per element). K8 bf16 within `fused_mlp_bf16_bound`
# (a rounding of h, g or out may land one ulp apart: 2^-7 ((|g| + |h
# gelu'(h)|).|w2| + |ref|) per element).
WINDOW_FP32_TOL = (1e-5, 1e-5)  # (rtol, atol)
# K8's gradient vs autograd of the plain version (bf16): the backward is the
# JAX `_bwd` (fp32 GELU), the plain version's autograd differentiates the
# bf16 GELU, so they differ by bf16 roundings; K6/K7's in fp32 by sum order
ROUTE_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max |g|


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


PHASE_SECONDS = {}


def phase(fn):
    """Logs a phase's wall seconds and keeps them for the summary line."""
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        PHASE_SECONDS[fn.__name__] = round(time.perf_counter() - t0, 1)
        log(f"{fn.__name__}: {PHASE_SECONDS[fn.__name__]} s")
        return out
    return timed


@contextlib.contextmanager
def switches(env):
    """Set environment switches for the block, restore them after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cuda_ms(fn, reps=10, warmup=3, flush=None):
    """Mean device time of fn() in ms, with CUDA events around each call;
    `flush` (a large tensor) is rewritten before each call so every call
    finds the 50 MB L2 cold."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def graph_ms(fn, reps=10, flush=None):
    """Mean device time of fn() in ms, replayed from a CUDA graph so that
    the host's launch overhead (tens of us for a wrapper, more than a small
    kernel takes) is not timed; `flush` is rewritten before each replay, so
    every replay finds the L2 cold. Kernel launch counters move once, at
    capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    del graph
    return total / reps


def attention_flops_rate(dtype):
    """The rate the attention kernels' products run at: bf16 on the tensor
    cores, fp32 as three TF32 products per product on them, at 495/3
    TFLOP/s (`K3_FP32_FLOPS`; K3 since slice 7, K5 since slice 8, K1 and K2
    since slice 9)."""
    return K3_FP32_FLOPS if dtype == torch.float32 else PEAK_FLOPS[dtype]


def k1_bound_ms(B, H, Sq, Skv, D, dtype, valid_keys=None):
    """Least time for K1's work on these inputs: 4*Sq*valid_keys*D operations
    per (b, h) at `attention_flops_rate` (fp32 products as three TF32
    products, as the kernel runs them) and each input read once, each output
    written once."""
    valid = B * Skv if valid_keys is None else valid_keys
    flops = 4.0 * H * Sq * valid * D
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * B * H * D * (2 * Sq + 2 * Skv) + 4 * B * H * Sq
    t_ops, t_bytes = flops / attention_flops_rate(dtype), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k1_cases(dtype):
    """(label, q, k, v, kv_mask) for phase 3, drawn from the seed: contiguous
    q/k/v at the three global-attention shapes; the main shape again as hiera
    hands it to K1, head-major views into one interleaved [B, S, 3, H, D]
    projection (cast before the views are taken, so they keep its strides);
    and the ragged masked case, where batch row 1 sees no key."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(dtype)  # noqa: E731
    for B, H, S, D in K1_SHAPES:
        yield ("contiguous", randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D), None)
    B, H, S, D = MAIN_SHAPE
    q, k, v = (t.transpose(1, 2) for t in randn(B, S, 3, H, D).unbind(2))
    check(q.stride() == (S * 3 * H * D, D, 3 * H * D, 1), "qkv views must stay strided")
    yield ("qkv views", q, k, v, None)
    B, H, Sq, Skv, D = 2, 4, 1000, 1500, 72
    kv_mask = torch.rand(B, Skv, device="cuda", generator=gen) > 0.3
    kv_mask[1] = False
    yield ("ragged masked", randn(B, H, Sq, D), randn(B, H, Skv, D), randn(B, H, Skv, D), kv_mask)


@phase
def phase_k1(flash_attention, flash_attention_ref):
    """K1 against its plain version on the card; returns the largest error."""
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for label, q, k, v, kv_mask in k1_cases(dtype):
            B, H, Sq, D = q.shape
            Skv = k.shape[2]
            out, lse = flash_attention(q, k, v, kv_mask)
            ref, ref_lse = flash_attention_ref(q, k, v, kv_mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            rtol, atol = K1_TOL[dtype]
            ok = bool((err <= atol + rtol * ref.float().abs()).all())
            lse_err = (lse - ref_lse).abs()
            ok_lse = bool((lse_err <= LSE_TOL[1] + LSE_TOL[0] * ref_lse.abs()).all())
            max_err = max(max_err, err.max().item())
            log(f"K1 {dtype} B={B} H={H} Sq={Sq} Skv={Skv} D={D} {label}: "
                f"max|out-ref| {err.max().item():.3e} (rtol {rtol}, atol {atol}), "
                f"max|lse-ref| {lse_err.max().item():.3e}")
            check(ok and ok_lse, "K1 disagrees with its plain version")
            if kv_mask is not None:
                check(not out[1].any() and bool((lse[1] == -1e30).all()),
                      "K1: fully masked rows must output 0 and lse -1e30")
    return max_err


def k2_bound_ms(B, Sq, Skv, D, dtype, valid_keys=None):
    """Least time for K2's work: K1's on these inputs (its products at
    `attention_flops_rate`) plus the rotation's, counted once per call:
    reading the two [Skv, D/2] tables once and its 6 operations per K pair
    (3 per element) on the CUDA cores' fp32 rate, and the [B, Skv] mask
    read once. The rotated K the kernels pass between them is scratch, not
    an input or output of the function, and is not counted."""
    valid = B * Skv if valid_keys is None else valid_keys
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = (itemsize * (B * D * (2 * Sq + 2 * Skv) + Skv * D) + B * Skv + 4 * B * Sq)
    t_ops = (4.0 * Sq * valid * D / attention_flops_rate(dtype)
             + 3.0 * B * Skv * D / PEAK_FLOPS[torch.float32])
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def rotation_bound_ms(B, Skv, D, dtype):
    """Least time for K2's rotation alone: K read once, the rotated K written
    once, the two tables read once (bytes-bound)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (2 * B * Skv * D + Skv * D)
    t_ops, t_bytes = 3.0 * B * Skv * D / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def memory_mask(B, gen):
    """[B, 28,736] validity of the fixed-capacity memory: batch row b masks
    3 of the 7 frame slots and 9 of the 16 pointers (4 tokens each), chosen
    from the seed, so the rows differ."""
    rows = []
    for _ in range(B):
        slots = torch.ones(K2_SLOTS, dtype=torch.bool)
        slots[torch.randperm(K2_SLOTS, generator=gen)[:3]] = False
        ptrs = torch.ones(K2_PTRS, dtype=torch.bool)
        ptrs[torch.randperm(K2_PTRS, generator=gen)[:9]] = False
        rows.append(torch.cat([slots.repeat_interleave(4096), ptrs.repeat_interleave(4)]))
    return torch.stack(rows).cuda()


def k2_cases(dtype):
    """(label, q, k, v, cos, sin, kv_mask) for phase 4, from the seed, with
    the tables memory attention builds (its own cached builders)."""
    from sam2_opt_tpu_torch.models.memory_attention import _rope_half_tables

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cpu_gen = torch.Generator().manual_seed(SEED + 2)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(dtype)  # noqa: E731
    D, S = K2_D, 4096
    c, s = _rope_half_tables(D, 64, 64, 10000.0, 1, 0, torch.device("cuda"), dtype)
    yield ("self", randn(1, 1, S, D), randn(1, 1, S, D), randn(1, 1, S, D), c, s, None)
    c, s = _rope_half_tables(D, 64, 64, 10000.0, K2_SLOTS, 4 * K2_PTRS, torch.device("cuda"), dtype)
    skv = c.shape[0]
    yield ("cross, 3/7 slots + 9/16 pointers masked", randn(1, 1, S, D), randn(1, 1, skv, D),
           randn(1, 1, skv, D), c, s, memory_mask(1, cpu_gen))
    yield ("cross, two objects", randn(2, 1, S, D), randn(2, 1, skv, D), randn(2, 1, skv, D),
           c, s, memory_mask(2, cpu_gen))
    kv_mask = torch.rand(2, 1500, device="cuda", generator=gen) > 0.3
    kv_mask[1] = False
    yield ("ragged, row 1 fully masked", randn(2, 1, 1000, D), randn(2, 1, 1500, D),
           randn(2, 1, 1500, D), c[:1500].contiguous(), s[:1500].contiguous(), kv_mask)


def k2_within(out, ref, dtype):
    rtol, atol = K2_TOL[dtype]
    err = (out.float() - ref.float()).abs()
    return bool((err <= atol + rtol * ref.float().abs()).all()), err


@phase
def phase_k2(flash_attention_rope, flash_attention_rope_ref, rope_rotate):
    """K2 against its plain version on the card; returns the largest error.
    Its rotation alone (`rope_rotate`, since slice 9 a kernel of its own)
    must equal the plain rotation bit for bit on every case. The negative
    control runs the cross case through the kernel with identity tables (no
    rotation): the check must fail."""
    from sam2_opt_tpu_torch.ops.posenc import apply_rotary_split

    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for label, q, k, v, c, s, kv_mask in k2_cases(dtype):
            kr = rope_rotate(k, c, s)
            kr_ref = apply_rotary_split(k.float(), c.float(), s.float()).to(dtype)
            check(torch.equal(kr, kr_ref), f"K2's rotation differs from the plain one ({label})")
            del kr, kr_ref
            out, lse = flash_attention_rope(q, k, v, c, s, kv_mask)
            ref, ref_lse = flash_attention_rope_ref(q, k, v, c, s, kv_mask)
            torch.cuda.synchronize()
            ok, err = k2_within(out, ref, dtype)
            lse_err = (lse - ref_lse).abs()
            ok_lse = bool((lse_err <= LSE_TOL[1] + LSE_TOL[0] * ref_lse.abs()).all())
            max_err = max(max_err, err.max().item())
            log(f"K2 {dtype} B={q.shape[0]} Sq={q.shape[2]} Skv={k.shape[2]} D={q.shape[3]} "
                f"{label}: max|out-ref| {err.max().item():.3e} (rtol {K2_TOL[dtype][0]}, atol "
                f"{K2_TOL[dtype][1]}; mean |ref| {ref.float().abs().mean().item():.3e}), "
                f"max|lse-ref| {lse_err.max().item():.3e}")
            check(ok and ok_lse, "K2 disagrees with its plain version")
            if label.startswith("ragged"):
                check(not out[1].any() and bool((lse[1] == -1e30).all()),
                      "K2: fully masked rows must output 0 and lse -1e30")
            if label.startswith("cross, 3/7"):
                one, zero = torch.ones_like(c), torch.zeros_like(s)
                unrotated, _ = flash_attention_rope(q, k, v, one, zero, kv_mask)
                torch.cuda.synchronize()
                bad, err = k2_within(unrotated, ref, dtype)
                rtol, atol = K2_TOL[dtype]
                frac = (err > atol + rtol * ref.float().abs()).float().mean().item()
                log(f"  negative control (identity tables): max|out-ref| {err.max().item():.3e}, "
                    f"{frac:.1%} of elements outside the tolerance")
                check(not bad, "K2's check cannot see the rotation: identity tables passed")
    return max_err


def synthetic_video(seed, T=VIDEO_FRAMES, H=720, W=1280):
    """uint8 [T, H, W, 3]: a background of 40x40 random colour blocks and a
    240x240 square of 20x20 blocks moving 40 px right and 16 px down per
    frame."""
    rng = np.random.default_rng(seed)
    bg = np.kron(rng.random((H // 40, W // 40, 3)), np.ones((40, 40, 1)))
    square = np.kron(rng.random((12, 12, 3)) * 0.5 + 0.5, np.ones((20, 20, 1)))
    frames = []
    for t in range(T):
        f = bg.copy()
        y, x = VIDEO_SQUARE[1] + 16 * t, VIDEO_SQUARE[0] + 40 * t
        f[y:y + 240, x:x + 240] = square
        frames.append(f)
    return (np.stack(frames) * 255).astype(np.uint8)


def track(predictor, video, n_frames, points, counts=None, normalize_coords=True):
    """init_state, points on frame 0 for object 1, propagate over `n_frames`
    frames. Returns (state, [video-res masks per frame]); with `counts` (the
    two wrappers), also the K1/K2 launches of each yielded frame."""
    state = predictor.init_state(video)
    predictor.add_new_points_or_box(state, 0, 1, points=points, labels=np.array([1], np.int32),
                                    normalize_coords=normalize_coords)
    masks, per_frame = [], []
    before = [c.launches for c in counts] if counts else None
    for frame_idx, obj_ids, video_res in predictor.propagate_in_video(
            state, max_frame_num_to_track=n_frames - 1):
        masks.append(video_res)
        if counts:
            now = [c.launches for c in counts]
            per_frame.append(tuple(a - b for a, b in zip(now, before)))
            before = now
    return state, masks, per_frame


def low_res(state, obj_idx=0):
    """Stored low-res logits [frames, 256, 256] of one object, frame order."""
    out = state["output_dict_per_obj"][obj_idx]
    frames = {**out["non_cond_frame_outputs"], **out["cond_frame_outputs"]}
    return torch.stack([frames[t]["pred_masks"][0, 0].float().cpu() for t in sorted(frames)])


@phase
def phase_video(flash_attention, flash_attention_rope):
    """The video slice on the card; returns (predictor, video, points,
    launches on the main path)."""
    from sam2_opt_tpu_torch import build_sam2_video_predictor
    from sam2_opt_tpu_torch.models.model import build_sam2
    from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

    t0 = time.perf_counter()
    predictor = build_sam2_video_predictor("hiera_l", seed=SEED)
    # random weights score the object as absent on tracked frames (every
    # logit NO_OBJ_SCORE); a present object keeps the network's logits
    with torch.no_grad():
        predictor.model.module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += OBJ_BIAS
    log(f"built hiera_l video predictor on {predictor.device} ({time.perf_counter() - t0:.1f} s),"
        f" fill_hole_area={predictor.fill_hole_area}")
    check(predictor.device.type == "cuda", "the video predictor must run on the card")
    video = synthetic_video(SEED)
    T, H, W, _ = video.shape
    cx, cy = VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120
    points = np.array([[cx, cy]], np.float32)
    kernels = (flash_attention, flash_attention_rope)

    runs, launches = {}, [0, 0]
    for dtype in (torch.float32, torch.bfloat16):
        if dtype == torch.bfloat16:
            predictor.speedup()
            check(predictor.model.compute_dtype == torch.bfloat16, "speedup() must switch to bf16")
        # the main path: counts to 0 just before, read just after
        flash_attention.launches = flash_attention_rope.launches = 0
        state, masks, per_frame = track(predictor, video, T, points, counts=kernels)
        torch.cuda.synchronize()
        k1, k2 = flash_attention.launches, flash_attention_rope.launches
        log(f"{dtype} propagation over {T} frames: K1 {k1} launches, K2 {k2}; per frame "
            f"(K1, K2) after init_state's encode: {per_frame}")
        check(len(masks) == T, "propagate_in_video must yield every frame")
        for m in masks:
            check(m.shape == (1, 1, H, W) and bool(torch.isfinite(m).all()),
                  "video-res masks must be finite [1, 1, H, W]")
        check(per_frame[0] == (0, 0), "the conditioning frame must launch nothing at propagation")
        check(all(f == (3, 8) for f in per_frame[1:]),
              "each tracked frame must launch K1 3 times and K2 8 times")
        check(k1 == 3 * T and k2 == 8 * (T - 1), "K1 must launch 3 times per encoded frame")
        launches = [launches[0] + k1, launches[1] + k2]
        runs[dtype] = [m[0, 0] > 0 for m in masks]
    ious = [miou(a.cpu().numpy(), b.cpu().numpy())
            for a, b in zip(runs[torch.float32], runs[torch.bfloat16]) if bool((a | b).any())]
    areas = [int(m.sum()) for m in runs[torch.float32]]
    log(f"bf16 vs fp32 per-frame mask mIoU on non-empty masks: "
        f"{[round(float(x), 4) for x in ious]} (limit > {VIDEO_BF16_MIOU_MIN}); fp32 mask "
        f"areas {areas} of {H * W} px")
    check(len(ious) >= T - 1, "degenerate: the fp32 masks are empty")
    check(min(ious) > VIDEO_BF16_MIOU_MIN, "bf16 video masks drift from fp32")

    # two objects, tracked together: points on one, a mask on the other
    flash_attention.launches = flash_attention_rope.launches = 0
    state = predictor.init_state(video[:3])
    predictor.add_new_points_or_box(state, 0, 1, points=points, labels=np.array([1], np.int32))
    mask2 = np.zeros((H, W), bool)
    mask2[100:300, 900:1150] = True
    predictor.add_new_mask(state, 0, 2, mask2)
    per_frame, before = [], (flash_attention.launches, flash_attention_rope.launches)
    for frame_idx, obj_ids, video_res in predictor.propagate_in_video(state):
        check(obj_ids == [1, 2] and video_res.shape == (2, 1, H, W)
              and bool(torch.isfinite(video_res).all()), "two-object output shape")
        now = (flash_attention.launches, flash_attention_rope.launches)
        per_frame.append((now[0] - before[0], now[1] - before[1]))
        before = now
    log(f"two objects, 3 frames, bf16: per frame (K1, K2) {per_frame}")
    check(per_frame == [(0, 0), (3, 8), (3, 8)],
          "two objects must be tracked as one batch: 8 K2 launches per frame")

    # the trunk routes on the video path: 3 bf16 frames under W1
    from sam2_opt_tpu_torch.kernels.fused_mlp import fused_mlp
    from sam2_opt_tpu_torch.kernels.window_attention import window_attention, window_flash_3d

    route_kernels = (flash_attention, flash_attention_rope, window_attention, window_flash_3d,
                     fused_mlp)
    with switches(ROUTES["W1"]):
        for c in route_kernels:
            c.launches = 0
        _, w1_masks, per_frame = track(predictor, video, 3, points, counts=route_kernels)
        torch.cuda.synchronize()
        video_route_launches = {"K5": window_attention.launches,
                                "K6": window_flash_3d.launches, "K8": fused_mlp.launches}
    w1_ious = [miou(a[0, 0].cpu().numpy() > 0, b.cpu().numpy())
               for a, b in zip(w1_masks, runs[torch.bfloat16][:3])]
    log(f"W1, 3 frames, bf16: per frame (K1, K2, K5, K6, K8) {per_frame}; mask mIoU vs the "
        f"default bf16 route {[round(float(x), 4) for x in w1_ious]}")
    expect = (3, 8, 5, 37, 48)
    check(per_frame == [(0,) * 5, expect, expect],
          "each tracked frame under W1 must launch K1 3, K2 8, K5 5, K6 37 and K8 48 times")
    check(min(w1_ious) > VIDEO_BF16_MIOU_MIN, "W1 video masks drift from the default route")

    # fp32 on the card vs the same weights on the CPU, first 3 frames; no
    # hole filling on either side, so a logit on the threshold cannot move a
    # whole small component (connected components are exact, tests hold them)
    t0 = time.perf_counter()
    predictor.set_runtime_backend("eager")
    predictor.fill_hole_area = 0
    card_state, _, _ = track(predictor, video, 3, points / [W, H], normalize_coords=False)
    frames = card_state["images"][:3].permute(0, 2, 3, 1).cpu().numpy()
    cpu_sd = {k: v.cpu() for k, v in predictor.model.module.state_dict().items()}
    cpu_pred = SAM2VideoPredictor(build_sam2("hiera_l", state_dict=cpu_sd, device="cpu"),
                                  fill_hole_area=0)
    cpu_state, _, _ = track(cpu_pred, frames, 3, points / [W, H], normalize_coords=False)
    card, cpu = low_res(card_state), low_res(cpu_state)
    scale = max(1.0, float(cpu.abs().max()))
    worst = float((card - cpu).abs().max()) / scale
    log(f"fp32 card vs CPU, 3 frames ({time.perf_counter() - t0:.1f} s): max|dlogit|/scale "
        f"{worst:.3e} (limit {CPU_LOGIT_RTOL}; scale {scale:.3f})")
    check(worst <= CPU_LOGIT_RTOL, "fp32 video logits on the card disagree with the CPU")
    predictor.fill_hole_area = 8
    del cpu_pred, cpu_sd
    return predictor, video, points, launches, video_route_launches


def structured_image(seed):
    """1500x2000 uint8 RGB: 15x20 random blocks of 100x100 pixels."""
    rng = np.random.default_rng(seed)
    return (np.kron(rng.random((15, 20, 3)), np.ones((100, 100, 1))) * 255).astype(np.uint8)


PROMPTS = {
    "point": dict(point_coords=np.array([[1000, 750]], np.float32), point_labels=np.array([1])),
    "box": dict(box=np.array([500, 400, 1500, 1100], np.float32)),
    "points+box": dict(point_coords=np.array([[900, 700], [1300, 1000]], np.float32),
                       point_labels=np.array([1, 0]),
                       box=np.array([400, 300, 1600, 1200], np.float32)),
}


def run_prompts(predictor, orig_hw):
    outs = {}
    for name, prompt in PROMPTS.items():
        for multimask in (True, False):
            masks, ious, low = predictor.predict(**prompt, multimask_output=multimask)
            n = 3 if multimask else 1
            check(masks.shape == (n, *orig_hw) and masks.dtype == bool, f"{name}: mask shape")
            check(ious.shape == (n,) and low.shape == (n, 256, 256), f"{name}: iou/logit shape")
            check(np.isfinite(ious).all() and np.isfinite(low).all(), f"{name}: non-finite")
            outs[(name, multimask)] = (masks, ious, low)
    return outs


def miou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


@phase
def phase_slice(flash_attention):
    from sam2_opt_tpu_torch import build_sam2_image_predictor
    from sam2_opt_tpu_torch.models.model import build_sam2
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor

    t0 = time.perf_counter()
    predictor = build_sam2_image_predictor("hiera_l", seed=SEED)
    n_params = sum(p.numel() for p in predictor.model.module.parameters())
    log(f"built hiera_l predictor on {predictor.device}: {n_params} parameters "
        f"({time.perf_counter() - t0:.1f} s); cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    check(predictor.device.type == "cuda", "the predictor must run on the card")
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "fp32 must not run in TF32")
    image = structured_image(SEED)
    orig_hw = image.shape[:2]

    # the main path: counts to 0 just before, read just after
    flash_attention.launches = 0
    predictor.set_image(image)
    torch.cuda.synchronize()
    check(flash_attention.launches == 3,
          f"fp32 set_image launched K1 {flash_attention.launches} times, expected 3")
    fp32 = run_prompts(predictor, orig_hw)
    check(flash_attention.launches == 3, "predict must not launch K1")

    # fp32 on the card vs the same weights on the CPU, plain path, full depth
    t0 = time.perf_counter()
    cpu_state = {k: v.cpu() for k, v in predictor.model.module.state_dict().items()}
    cpu_pred = SAM2ImagePredictor(build_sam2("hiera_l", state_dict=cpu_state, device="cpu"))
    cpu_pred.set_image(image)
    cpu = run_prompts(cpu_pred, orig_hw)
    worst_logit, worst_iou = 0.0, 0.0
    for key, (_, ious, low) in fp32.items():
        _, cpu_ious, cpu_low = cpu[key]
        scale = max(1.0, float(np.abs(cpu_low).max()))
        worst_logit = max(worst_logit, float(np.abs(low - cpu_low).max()) / scale)
        worst_iou = max(worst_iou, float(np.abs(ious - cpu_ious).max()))
    log(f"fp32 card vs CPU (full depth, {time.perf_counter() - t0:.1f} s): max|dlogit|/scale "
        f"{worst_logit:.3e} (limit {CPU_LOGIT_RTOL}), max|dIoU| {worst_iou:.3e} "
        f"(limit {CPU_IOU_ATOL})")
    check(worst_logit <= CPU_LOGIT_RTOL and worst_iou <= CPU_IOU_ATOL,
          "fp32 on the card disagrees with the CPU")
    del cpu_pred, cpu_state

    predictor.speedup()
    check(predictor.model.compute_dtype == torch.bfloat16, "speedup() must switch to bf16")
    predictor.set_image(image)
    torch.cuda.synchronize()
    check(flash_attention.launches == 6,
          f"bf16 set_image launched K1 {flash_attention.launches - 3} times, expected 3")
    bf16 = run_prompts(predictor, orig_hw)
    launches = flash_attention.launches
    check(launches == 6, "predict must not launch K1")
    worst_miou, worst_diou = 1.0, 0.0
    for key, (masks, ious, _) in bf16.items():
        ref_masks, ref_ious, _ = fp32[key]
        worst_miou = min(worst_miou, min(miou(a, b) for a, b in zip(ref_masks, masks)))
        worst_diou = max(worst_diou, float(np.abs(ious - ref_ious).max()))
    log(f"bf16 vs fp32: min mask mIoU {worst_miou:.4f} (limit > {BF16_MIOU_MIN}), "
        f"max|dIoU| {worst_diou:.3e} (limit < {BF16_IOU_ATOL})")
    check(worst_miou > BF16_MIOU_MIN and worst_diou < BF16_IOU_ATOL, "bf16 masks drift from fp32")
    return predictor, image, launches, {torch.float32: fp32, torch.bfloat16: bf16}


# kernel-name patterns for the split of device time, first match wins. Every
# `__global__` kernel of `sam2_opt_tpu_torch/csrc/` matches one of the first
# six (tests/test_torch_chip_smoke_families.py): each caller's kernels carry
# its prefix, so K2's rotation, attention and split merge count as K2's even
# though its attention body is K1's, and K1's and K4's merges as theirs.
FAMILIES = [
    ("K5-K7 window_attention (csrc)", r"window_attn_"),
    ("K8 fused_mlp (csrc)", r"fused_mlp_kernel"),
    ("K3 flash_attention_bwd (csrc)", r"bwd_dkdv_|bwd_dq_|\bcombine_kernel"),
    ("K4 flash_attention_kv_proj (csrc)", r"flash_kvproj_"),
    ("K2 flash_attention_rope (csrc)", r"flash_rope_"),
    ("K1 flash_attention (csrc)", r"flash_fwd_"),
    ("convolution", r"conv|fprop|dgrad|wgrad|cudnn|implicit_gemm|winograd"),
    ("matmul", r"gemm|xmma|cutlass|cublas|nvjet|sm90_|sm80_"),
    ("softmax", r"softmax"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("resize / pool", r"upsample|interpolat|pool|bilinear|nearest"),
    ("reduction", r"reduce"),
    ("scan (hole filling's cummin)", r"scan|cummin|cumsum"),
    ("elementwise / copy", r"elementwise|vectorized|copy|Memcpy|memcpy|fill|index|cat|gather"),
]


def device_split(fn, reps=3):
    """Device time of fn() per call, summed by kernel family from a
    torch.profiler trace of `reps` calls: (busy ms, {family: {ms, launches}},
    the eight largest kernels)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    fams, kernels = {}, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = next((f for f, pattern in FAMILIES if re.search(pattern, ev.key, re.IGNORECASE)),
                   "other")
        f = fams.setdefault(fam, {"ms": 0.0, "launches": 0})
        f["ms"] += dev_us / 1e3 / reps
        f["launches"] += ev.count / reps
        kernels.append([ev.key[:90], dev_us / 1e3 / reps])
    check(bool(fams), "the profiler saw no device time")
    busy = sum(f["ms"] for f in fams.values())
    return (busy, dict(sorted(fams.items(), key=lambda kv: -kv[1]["ms"])),
            sorted(kernels, key=lambda kv: -kv[1])[:8])


@phase
def phase_times(predictor, image):
    times = {}
    prompt = PROMPTS["point"]
    for dtype, backend in ((torch.float32, "eager"), (torch.bfloat16, "cuda")):
        predictor.set_runtime_backend(backend)
        torch.cuda.reset_peak_memory_stats()
        set_ms = cuda_ms(lambda: predictor.set_image(image), reps=5, warmup=2)
        pred_ms = cuda_ms(lambda: predictor.predict(**prompt), reps=10, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        busy, fams, top = device_split(lambda: predictor.set_image(image))
        log(f"{dtype}: set_image {set_ms:.3f} ms (device busy {busy:.3f} ms, idle share "
            f"{1 - busy / set_ms:.1%}), predict {pred_ms:.3f} ms "
            f"(1500x2000, point, multimask), peak device memory {peak:.2f} GiB")
        log(json.dumps({"set_image_device_split": str(dtype).replace("torch.", ""),
                        "families": fams, "top_kernels_ms": top}))
        times[dtype] = dict(set_image_ms=set_ms, predict_ms=pred_ms, peak_gib=peak,
                            set_image_busy_ms=busy, idle_share=1 - busy / set_ms)

    return times


@phase
def phase_k1_times(flash_attention, flash_attention_ref, tiling=True):
    """K1 at hiera-L's global blocks in both dtypes and in bf16 at
    hiera-b+'s (D = 56, the training shape's head dim), cold L2, beside its
    plain version, SDPA and its bound; device times from CUDA graph replays
    (`graph_ms`: since slice 8, when K1 bf16 became shorter than the
    wrapper's host work, which CUDA events around a call would time). With
    `tiling`, the log line also gives its tile and CTAs as its library
    reports them and its exponential floor."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k1 = {}
    for shape, dtypes in ((MAIN_SHAPE, (torch.bfloat16, torch.float32)),
                          (K1_SHAPES[1], (torch.bfloat16,))):
        B, H, S, D = shape
        base = [torch.randn(B, H, S, D, device="cuda", generator=gen) for _ in range(3)]
        for dtype in dtypes:
            q, k, v = (t.to(dtype) for t in base)
            ms = graph_ms(lambda: flash_attention(q, k, v), flush=flush)
            plain_ms = graph_ms(lambda: flash_attention_ref(q, k, v), reps=5, flush=flush)
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v), flush=flush)
            bound_ms, bound_by = k1_bound_ms(B, H, S, S, D, dtype)
            log(f"K1 {dtype} {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.scaled_dot_product_attention {library_ms:.4f} ms ({ms / library_ms:.2f}x), "
                f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound"
                + (f"; {k1_tiling_line(dtype, B, H, S, S, D)}" if tiling else ""))
            k1[(shape, dtype)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
    return k1


def sm_clock_hz():
    """The card's highest SM clock, as nvidia-smi reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return 1e6 * float(out.strip().splitlines()[0])


def k1_tiling_line(dtype, B, H, Sq, Skv, D):
    """K1's tile and CTAs as its library reports them, and the least time
    of its exponentials alone: one per score, at 16 a clock per SM (the
    SFU's ex2 rate) on every SM at the highest clock."""
    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention_tiling

    t = flash_attention_tiling(dtype, B, H, Sq, Skv, D)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    exp_ms = 1e3 * B * H * Sq * Skv / (16 * n_sm * sm_clock_hz())
    return (f"tile {t['rows']} rows x {t['keys']} keys, {t['stages']} kv stages, "
            f"{t['ctas']} CTAs on {n_sm} SMs, exponential floor {exp_ms:.4f} ms")


def propagation_times(predictor, video, points, label):
    """One object tracked over `video` at the predictor's backend: ms per
    tracked frame (CUDA events, after a warm-up pass that fills every memory
    slot), the whole pass, its device split and idle share, peak memory;
    logged under `label`."""
    T = video.shape[0]
    state = predictor.init_state(video)
    predictor.add_new_points_or_box(state, 0, 1, points=points, labels=np.array([1], np.int32))
    list(predictor.propagate_in_video(state))  # warm-up, every memory slot filled
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    frames = predictor.propagate_in_video(state)
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if next(frames, None) is None:
            break
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tracked = frame_ms[1:]  # frame 0 is the conditioning frame
    wall_ms = cuda_ms(lambda: list(predictor.propagate_in_video(state)), reps=2, warmup=1)
    busy, fams, top = device_split(lambda: list(predictor.propagate_in_video(state)), reps=1)
    per = 1.0 / (T - 1)
    log(f"{label}: propagate_in_video per tracked frame {np.mean(tracked):.3f} ms (frames "
        f"1-{T - 1}: {[round(x, 3) for x in tracked]}), whole pass {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms, idle share {1 - busy / wall_ms:.1%}, peak device memory "
        f"{peak:.2f} GiB")
    log(json.dumps({"tracked_frame_device_split": label.replace("torch.", ""),
                    "per_tracked_frame": {f: {"ms": v["ms"] * per, "launches": v["launches"] * per}
                                          for f, v in fams.items()},
                    "top_kernels_ms_per_pass": top}))
    return dict(frame_ms=float(np.mean(tracked)), frames_ms=tracked, pass_ms=wall_ms,
                busy_ms=busy, idle_share=1 - busy / wall_ms, busy_per_frame_ms=busy * per,
                peak_gib=peak)


def memory_attention_times(kernels, rope_rotate=None, tiling=False, plain=True):
    """K2 (`kernels["K2"]`: flash_attention_rope and its plain version)
    and/or K1 at D = 256 (`kernels["K1 D=256"]`: flash_attention and its
    plain version) at memory attention's cross and self shapes in both
    dtypes, every key valid, cold L2, device times from CUDA graph replays
    (since slice 9; CUDA events around each call before, which also timed
    the wrappers' host work): each beside its plain version (CUDA events;
    skipped when `plain` is false), its library yardstick (K2: the rotation
    in torch, then F.scaled_dot_product_attention; K1: SDPA) and its bound;
    K2's rotation alone beside its bound and its share of K2's time where
    `rope_rotate` is given. With `tiling` the log line also gives the tile,
    kv split and CTAs as the kernel library reports them. Returns {kernel
    key or "rotation": {(shape label, dtype): row}}."""
    from sam2_opt_tpu_torch.models.memory_attention import _rope_half_tables
    from sam2_opt_tpu_torch.ops.posenc import apply_rotary_split

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = {key: {} for key in (*kernels, *(("rotation",) if rope_rotate else ()))}
    for label, (B, Sq, Skv, D) in (("cross", K2_CROSS), ("self", K2_SELF)):
        base = [torch.randn(B, 1, n, D, device="cuda", generator=gen) for n in (Sq, Skv, Skv)]
        reps = 1 if label == "self" else K2_SLOTS
        # the main path's steady state: every slot and pointer valid
        mask = torch.ones(B, Skv, dtype=torch.bool, device="cuda") if label == "cross" else None
        attn_mask = None if mask is None else mask[:, None, None, :]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in base)
            c, s = _rope_half_tables(D, 64, 64, 10000.0, reps, Skv - 4096 * reps,
                                     torch.device("cuda"), dtype)

            def library(key):
                if key == "K2":
                    kr = apply_rotary_split(k.float(), c.float(), s.float()).to(dtype)
                    return F.scaled_dot_product_attention(q, kr, v, attn_mask=attn_mask)
                return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)

            for key, (fn, ref) in kernels.items():
                args = (q, k, v, c, s, mask) if key == "K2" else (q, k, v, mask)
                ms = graph_ms(lambda: fn(*args), flush=flush)
                plain_ms = (cuda_ms(lambda: ref(*args), reps=3, warmup=1, flush=flush)
                            if plain else None)
                library_ms = graph_ms(lambda: library(key), flush=flush)
                bound_ms, bound_by = (k2_bound_ms(B, Sq, Skv, D, dtype) if key == "K2"
                                      else k1_bound_ms(B, 1, Sq, Skv, D, dtype))
                row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
                line = (f"{key} {dtype} {label} {(B, Sq, Skv, D)}: {ms:.4f} ms, "
                        + (f"plain {plain_ms:.4f} ms, " if plain else "")
                        + ("rotation + " if key == "K2" else "")
                        + f"F.scaled_dot_product_attention {library_ms:.4f} ms "
                        f"({ms / library_ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by}), "
                        f"{bound_ms / ms:.1%} of bound")
                if tiling:
                    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention_tiling

                    t = flash_attention_tiling(dtype, B, 1, Sq, Skv, D)
                    row.update(kv_splits=t["n_split"], ctas=t["ctas"])
                    line += (f"; tile {t['rows']} rows x {t['keys']} keys, {t['n_split']} kv "
                             f"splits, {t['ctas']} CTAs on "
                             f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
                log(line)
                rows[key][(label, dtype)] = row
            if rope_rotate is not None:
                rot_ms = graph_ms(lambda: rope_rotate(k, c, s), flush=flush)
                bound_ms, bound_by = rotation_bound_ms(B, Skv, D, dtype)
                share = (f", {rot_ms / rows['K2'][(label, dtype)]['ms']:.1%} of K2's time"
                         if "K2" in kernels else "")
                log(f"K2's rotation alone {dtype} {label} (B={B}, Skv={Skv}, D={D}): "
                    f"{rot_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                    f"{bound_ms / rot_ms:.1%} of bound{share}")
                rows["rotation"][(label, dtype)] = dict(ms=rot_ms, bound_ms=bound_ms,
                                                        bound_by=bound_by)
        del base, q, k, v
    torch.cuda.empty_cache()
    return rows


@phase
def phase_video_times(predictor, video, points, flash_attention_rope,
                      flash_attention_rope_ref, rope_rotate):
    """Per-frame propagation time, peak memory and the device split of the
    tracked frames, fp32 and bf16; K2 and its rotation alone at the self and
    cross shapes (`memory_attention_times`)."""
    times = {}
    for dtype, backend in ((torch.float32, "eager"), (torch.bfloat16, "cuda")):
        predictor.set_runtime_backend(backend)
        times[dtype] = propagation_times(predictor, video, points, str(dtype))

    k2 = memory_attention_times({"K2": (flash_attention_rope, flash_attention_rope_ref)},
                                rope_rotate=rope_rotate, tiling=True)
    return times, k2


# --------------------------------------------------------------------------- #
# slice 3: training
# --------------------------------------------------------------------------- #

# K3 at the training shapes, (B, H, Sq, Skv, D): hiera-b+'s global blocks with
# the 8 frames of a rollout encoded as one batch (B*H = 64), and memory
# attention at two objects: cross (7 slots x 4096 + 8 pointers x 4 tokens)
# and self.
K3_B_SHAPE = (8, 8, 4096, 4096, 56)
K3_CROSS = (2, 1, 4096, K2_SLOTS * 4096 + 4 * 8, 256)
K3_SELF = (2, 1, 4096, 4096, 256)
# fp32: kernel and plain version sum the same products in other orders, the
# kernel each as three TF32 products (about 2^-21 of each product)
K3_FP32_REL = 1e-4
TRAIN_FRAMES, TRAIN_OBJECTS, TRAIN_STEPS = 8, 2, 3
# fp32 on the card vs the CPU, hiera-b+ at 1024², 2 frames (see phase 9)
TRAIN_CPU_LOSS_RTOL = 1e-4
TRAIN_CPU_GRAD_TOL = 1e-3    # of each gradient's own max |g| ...
TRAIN_CPU_GRAD_FLOOR = 1e-7  # ... plus this much of the model's largest gradient
TRAIN_BF16_LOSS_RTOL = 0.1


def k3_bound_ms(B, H, Sq, Skv, D, dtype, part, valid_keys=None):
    """Least time for K3a ("dkdv": S, dP, dV, dK: 4 products) or K3b ("dq":
    S, dP, dQ: 3 products) on these inputs, 2 operations per multiply-add,
    each input (q, k, v, dO in the dtype, lse and delta fp32) read once and
    each fp32 gradient written once. Masked keys need no work. fp32 runs on
    the tensor cores as three TF32 products per product (the split that
    keeps fp32 accuracy, as the library's fp32 backward does), so its rate
    is a third of TF32's 495 TFLOP/s (K3_FP32_FLOPS), not the CUDA cores'
    67: the least time for fp32-accurate work on this card."""
    valid = B * Skv if valid_keys is None else valid_keys
    products = 4 if part == "dkdv" else 3
    flops = 2.0 * products * H * Sq * valid * D
    itemsize = torch.finfo(dtype).bits // 8
    out_rows = 2 * Skv if part == "dkdv" else Sq
    nbytes = (itemsize * B * H * D * (2 * Sq + 2 * Skv) + 8 * B * H * Sq + B * Skv
              + 4 * B * H * D * out_rows)
    t_ops, t_bytes = flops / attention_flops_rate(dtype), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k3_within(got, ref, bounds):
    """(all within, the largest |error| over the three gradients, the
    fraction of elements outside). fp32 (bounds None): K3_FP32_REL of each
    gradient's max |g|; bf16: the per-element rounding bounds of
    `flash_attention_bwd_bf16_bound`."""
    ok, worst, outside, total = True, 0.0, 0, 0
    for i, (a, b) in enumerate(zip(got, ref)):
        err = (a - b).abs()
        lim = K3_FP32_REL * b.abs().max() if bounds is None else bounds[i] + 1e-6 * b.abs().max()
        bad = err > lim
        ok = ok and not bool(bad.any())
        outside += int(bad.sum())
        total += bad.numel()
        worst = max(worst, err.max().item())
    return ok, worst, outside / total


def k3_cases(dtype):
    """(label, q, k, v, do, kv_mask) for phase 8, from the seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cpu_gen = torch.Generator().manual_seed(SEED + 4)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(dtype)  # noqa: E731
    B, H, S, _, D = K3_B_SHAPE
    yield ("b+ global blocks", randn(B, H, S, D), randn(B, H, S, D), randn(B, H, S, D),
           randn(B, H, S, D), None)
    q, k, v = (t.transpose(1, 2) for t in randn(B, S, 3, H, D).unbind(2))
    check(q.stride() == (S * 3 * H * D, D, 3 * H * D, 1), "qkv views must stay strided")
    mask = torch.rand(B, S, device="cuda", generator=gen) > 0.2
    mask[B - 1] = False
    yield ("b+ qkv views, masked keys, frame 7 fully masked", q, k, v, randn(B, H, S, D), mask)
    B, H, Sq, Skv, D = K3_CROSS
    full = memory_mask(1, cpu_gen)  # 16 pointers; keep the last 8
    mask = torch.cat([torch.cat([full[:, :K2_SLOTS * 4096], full[:, -32:]], 1),
                      torch.zeros(1, Skv, dtype=torch.bool, device="cuda")])
    yield ("cross, 3/7 slots + pointers masked, object 1 fully masked", randn(B, H, Sq, D),
           randn(B, H, Skv, D), randn(B, H, Skv, D), randn(B, H, Sq, D), mask)
    B, H, Sq, Skv, D = K3_SELF
    yield ("self", randn(B, H, Sq, D), randn(B, H, Skv, D), randn(B, H, Skv, D),
           randn(B, H, Sq, D), None)


@phase
def phase_k3():
    """K3a and K3b against their plain versions on the card; returns the
    largest error per kernel. On the cross case (where bf16 K3b splits its kv
    axis) a second launch must give bitwise-equal gradients, and the
    negative control, lse + 1, must fail the check."""
    from sam2_opt_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_bf16_bound,
        flash_attention_bwd_delta,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_ref,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_ref,
        flash_attention_ref,
    )

    max_err = {"dkdv": 0.0, "dq": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for label, q, k, v, do, mask in k3_cases(dtype):
            out, lse = flash_attention_ref(q, k, v, mask)
            delta = flash_attention_bwd_delta(out, do)
            del out
            dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, mask)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, mask)
            torch.cuda.synchronize()
            ref = (flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, mask),
                   *flash_attention_bwd_dkdv_ref(q, k, v, do, lse, delta, mask))
            bounds = None if dtype == torch.float32 else flash_attention_bwd_bf16_bound(
                q, k, v, do, lse, delta, mask)
            ok, worst, _ = k3_within((dq, dk, dv), ref, bounds)
            errs = [(a - b).abs().max().item() for a, b in zip((dq, dk, dv), ref)]
            max_err["dq"] = max(max_err["dq"], errs[0])
            max_err["dkdv"] = max(max_err["dkdv"], errs[1], errs[2])
            scales = [b.abs().max().item() for b in ref]
            log(f"K3 {dtype} {tuple(q.shape)} Skv={k.shape[2]} {label}: max|err| dq/dk/dv "
                f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (max|g| {scales[0]:.3e}/"
                f"{scales[1]:.3e}/{scales[2]:.3e}; "
                + ("fp32: limit 1e-4 of max|g|)" if bounds is None else
                   "bf16: per-element rounding bound)"))
            check(ok, "K3 disagrees with its plain version")
            if mask is not None:
                dead = ~mask.any(1)
                check(bool(dead.any()) and not dq[dead].any() and not dk[dead].any()
                      and not dv[dead].any(), "K3: a fully masked row must get zero gradients")
            if label.startswith("cross"):
                # no atomics: a second launch gives bitwise-equal gradients
                dk2, dv2 = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, mask)
                dq2 = flash_attention_bwd_dq(q, k, v, do, lse, delta, mask)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), (dq2, dk2, dv2)))
                log(f"  determinism: a second launch of K3a and K3b is bitwise equal: {same}")
                check(same, "K3 must be deterministic")
                bad_lse = lse + 1.0
                dk2, dv2 = flash_attention_bwd_dkdv(q, k, v, do, bad_lse, delta, mask)
                dq2 = flash_attention_bwd_dq(q, k, v, do, bad_lse, delta, mask)
                torch.cuda.synchronize()
                bad, worst2, frac = k3_within((dq2, dk2, dv2), ref, bounds)
                log(f"  negative control (lse + 1): max|err| {worst2:.3e}, {frac:.1%} of "
                    f"elements outside")
                check(not bad, "K3's check cannot see a wrong lse")
            del q, k, v, do, lse, delta, dq, dk, dv, ref, bounds
            torch.cuda.empty_cache()
    return max_err


def k3_tiling(dtype, B, H, Sq, Skv, D, part):
    """K3a's ("dkdv") or K3b's ("dq") tile, CTAs and split for the log, as
    the kernel's library reports its launch."""
    from sam2_opt_tpu_torch.kernels.flash_attention import bwd_tiling

    t = bwd_tiling(part == "dq", dtype, B, H, Sq, Skv, D)
    axes = ("query rows", "keys") if part == "dq" else ("keys", "query rows")
    return (f"{t['cta_rows']} {axes[0]} per CTA, {t['step_rows']} {axes[1]} per step, "
            f"{t['ctas']} CTAs, split {t['n_split']}")


@phase
def phase_k3_times():
    """K3a and K3b beside their plain versions, the SDPA backward and their
    bounds, at the three training shapes, every key valid (the steady state;
    the early frames' masked slots are skipped work), cold L2."""
    from sam2_opt_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_delta,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_ref,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_ref,
        flash_attention_ref,
    )

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    k3 = {}
    for label, (B, H, Sq, Skv, D) in (("b+ global", K3_B_SHAPE), ("cross", K3_CROSS),
                                      ("self", K3_SELF)):
        base = [torch.randn(B, H, n, D, device="cuda", generator=gen) for n in (Sq, Skv, Skv, Sq)]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (t.to(dtype) for t in base)
            mask = torch.ones(B, Skv, dtype=torch.bool, device="cuda") if label == "cross" else None
            out, lse = flash_attention_ref(q, k, v, mask)
            delta = flash_attention_bwd_delta(out, do)
            row, tiles = {}, {}
            for part, kernel, plain in (("dkdv", flash_attention_bwd_dkdv,
                                         flash_attention_bwd_dkdv_ref),
                                        ("dq", flash_attention_bwd_dq, flash_attention_bwd_dq_ref)):
                ms = cuda_ms(lambda: kernel(q, k, v, do, lse, delta, mask), reps=3, warmup=1,
                             flush=flush)
                plain_ms = cuda_ms(lambda: plain(q, k, v, do, lse, delta, mask), reps=2,
                                   warmup=1, flush=flush)
                bound_ms, bound_by = k3_bound_ms(B, H, Sq, Skv, D, dtype, part)
                row[part] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                tiles[part] = k3_tiling(dtype, B, H, Sq, Skv, D, part)
            # the library yardstick: autograd of SDPA with the same bool mask,
            # backward only (dQ, dK and dV together)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            attn_mask = None if mask is None else mask[:, None, None, :]
            lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask)
            library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do,
                                                             retain_graph=True),
                                 reps=3, warmup=1, flush=flush)
            both = row["dkdv"]["ms"] + row["dq"]["ms"]
            fused_bound = 1e3 * 10.0 * B * H * Sq * Skv * D / attention_flops_rate(dtype)
            parts = "; ".join(
                f"{name} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, "
                f"{r['bound_ms'] / r['ms']:.1%} of it; {tiles[part]})"
                for name, part, r in (("K3a", "dkdv", row["dkdv"]), ("K3b", "dq", row["dq"])))
            log(f"K3 {dtype} {label} {(B * H, Sq, Skv, D)}: {parts}; together {both:.4f} ms = "
                f"{fused_bound / both:.1%} of the 10-product bound {fused_bound:.4f} ms; SDPA "
                f"backward {library_ms:.4f} ms ({both / library_ms:.2f}x)")
            for part in row:
                row[part]["library_ms"] = library_ms
            k3[(label, dtype)] = dict(row, both_ms=both, fused_bound_ms=fused_bound)
            del q, k, v, do, out, lse, delta, qg, kg, vg, lib_out
            torch.cuda.empty_cache()
    return k3


def training_video(T=TRAIN_FRAMES, S=1024, seed=SEED):
    """One collated batch: images uint8 [1, T, S, S, 3], masks bool
    [1, T, 2, S, S], obj_valid [1, 2]: a background of 16 x 16 random colour
    blocks and two textured squares (about S/5 and S/6) moving in opposite
    directions."""
    rng = np.random.default_rng(seed)
    block = S // 16
    frames = np.repeat(np.kron(rng.random((16, 16, 3)), np.ones((block, block, 1)))[None], T, 0)
    masks = np.zeros((1, T, TRAIN_OBJECTS, S, S), bool)
    for j, (size, y, x, dx) in enumerate(((S // 5, S // 5, S // 6, S // 40),
                                          (S // 6, 3 * S // 5, 2 * S // 3, -(S // 50)))):
        tex = np.kron(rng.random((8, 8, 3)) * 0.5 + 0.25 * (1 - j), np.ones((size // 8,) * 2 + (1,)))
        n = tex.shape[0]
        for t in range(T):
            x0 = x + dx * t
            frames[t, y:y + n, x0:x0 + n] = tex
            masks[0, t, j, y:y + n, x0:x0 + n] = True
    return {"images": (frames[None] * 255).astype(np.uint8), "masks": masks,
            "obj_valid": np.ones((1, TRAIN_OBJECTS), bool)}


def b_plus(device, state_dict=None):
    """hiera-b+ at 1024², random weights from the seed (or `state_dict`),
    the object-score head's last bias raised by OBJ_BIAS so the tracked
    objects score present and the mask losses carry gradient."""
    from sam2_opt_tpu_torch.models.model import build_sam2

    m = build_sam2("hiera_b+", seed=SEED, state_dict=state_dict, device=device).module
    if state_dict is None:
        with torch.no_grad():
            m.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += OBJ_BIAS
    return m


@phase
def phase_train_vs_cpu():
    """fp32 loss and gradients on the card against the CPU, same weights: the
    default route and, on the same card model, `SAM2_TPU_FUSED_ROPE=0`
    (memory attention on K1 at D = 256, K3 behind it; the CPU's plain route
    is the same either way). Launch counts show which route ran: K2 on the
    default, none under the switch, where K1 runs more."""
    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_rope
    from sam2_opt_tpu_torch.training.sam2_train import video_train_loss

    t0 = time.perf_counter()
    cfg = model_config("hiera_b+")
    batch = training_video(T=2)
    results, launches = {}, {}
    card = b_plus("cuda")
    cpu = b_plus("cpu", {k: v.cpu() for k, v in card.state_dict().items()})
    for name, m, env in (("card", card, {}), ("card, rope off", card, ROPE_OFF_SWITCH),
                         ("cpu", cpu, {})):
        dev = next(m.parameters()).device
        m.zero_grad(set_to_none=True)
        images = torch.as_tensor(batch["images"][0], device=dev).float() / 255.0
        masks = torch.as_tensor(batch["masks"][0, :, :1], device=dev)
        flash_attention.launches = flash_attention_rope.launches = 0
        with switches(env):
            loss, aux = video_train_loss(m, cfg, images, masks, torch.Generator(device=dev),
                                         use_mask_input=True, num_correction_clicks=0,
                                         use_remat=False)
            loss.backward()
        launches[name] = (flash_attention.launches, flash_attention_rope.launches)
        results[name] = (loss.item(), {n: p.grad.float().cpu() for n, p in m.named_parameters()
                                       if p.grad is not None})
    l_cpu, g_cpu = results["cpu"]
    log(f"training fp32, 2 frames: (K1, K2) launches on the card {launches['card']}, under "
        f"SAM2_TPU_FUSED_ROPE=0 {launches['card, rope off']}")
    check(launches["card"][1] > 0 and launches["card, rope off"][1] == 0
          and launches["card, rope off"][0] > launches["card"][0],
          "SAM2_TPU_FUSED_ROPE=0 must move memory attention from K2 to K1")
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    readings = {}
    for route in ("card", "card, rope off"):
        l_card, g_card = results[route]
        check(sorted(g_card) == sorted(g_cpu), "the card and the CPU differentiate other parameters")
        worst, worst_name, bad = 0.0, "", []
        for n, want in g_cpu.items():
            err = (g_card[n] - want).abs().max().item()
            scale = want.abs().max().item()
            if err > TRAIN_CPU_GRAD_TOL * scale + TRAIN_CPU_GRAD_FLOOR * gmax:
                bad.append((n, err, scale))
            if scale >= 1e-6 * gmax and err / scale > worst:
                worst, worst_name = err / scale, n
        rel = abs(l_card - l_cpu) / abs(l_cpu)
        qk = [g_card[f"memory_attention.layers.{i}.{a}.{p}_proj.weight"].abs().max().item()
              for i in range(4) for a in ("self_attn", "cross_attn_image") for p in ("q", "k")]
        log(f"training fp32 {route} vs CPU, hiera-b+ 1024², 2 frames "
            f"({time.perf_counter() - t0:.1f} s): loss {l_card:.6f} vs {l_cpu:.6f} (rel "
            f"{rel:.2e}, limit {TRAIN_CPU_LOSS_RTOL}); {len(g_cpu)} gradients, worst "
            f"|err|/max|g| {worst:.2e} ({worst_name}; limit {TRAIN_CPU_GRAD_TOL} + "
            f"{TRAIN_CPU_GRAD_FLOOR} of the largest, {gmax:.3e}); outside: {bad[:3]}; "
            f"memory-attention q/k grad max|g| min {min(qk):.3e}")
        check(rel <= TRAIN_CPU_LOSS_RTOL, f"the training loss on the card ({route}) disagrees "
              "with the CPU")
        check(not bad, f"training gradients on the card ({route}) disagree with the CPU")
        check(min(qk) > 0, "memory attention's q/k projections get no gradient")
        readings[route] = dict(loss_card=l_card, loss_rel=rel, worst_grad_rel=worst)
    del card, cpu, results
    torch.cuda.empty_cache()
    return dict(loss_cpu=l_cpu, routes=readings)


def launches_per_step(T=TRAIN_FRAMES):
    """Kernel launches of one trainer step, point prompt on frame 0 and one
    correction click, remat "encoder": K1 runs in the 3 global blocks of the
    8-frame encoder batch, once forward and once in the backward's recompute;
    K2 in 4 layers x (self + cross) of each of the T - 1 tracked frames
    (both objects as one batch); K3a and K3b once per K1 or K2 launch of the
    forward."""
    k1, k2 = 2 * 3, 8 * (T - 1)
    return {"K1": k1, "K2": k2, "K3a": 3 + k2, "K3b": 3 + k2}


def train_config(dtype, root):
    """The trainer settings of phase 10: one 8-frame video of two objects
    per batch, a point prompt and one correction click, remat "encoder"."""
    from sam2_opt_tpu_torch.training.trainer import TrainConfig

    return TrainConfig(num_epochs=1, num_frames=TRAIN_FRAMES, max_num_objects=TRAIN_OBJECTS,
                       prob_to_use_pt_input=1.0, prob_to_use_box_input=0.0, remat="encoder",
                       compute_dtype=dtype, seed=SEED, checkpoint_dir=f"{root}/ckpt",
                       log_dir=f"{root}/logs")


@phase
def phase_trainer(counters):
    """The main path: Trainer.run at hiera-b+ 1024², fp32 then bf16."""
    import tempfile

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.training.trainer import Trainer

    cfg = model_config("hiera_b+")
    batch = training_video()
    expect = launches_per_step()
    runs, launches = {}, {k: 0 for k in counters}
    tmp = tempfile.mkdtemp(prefix="sam2_chip_smoke_train_")
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        trainer = Trainer(cfg, b_plus("cuda"), train_config(dtype, f"{tmp}/{dtype}"))
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts to 0 just before, read just after
        for c in counters.values():
            c.launches = 0
        trainer.run(lambda epoch: iter([batch] * TRAIN_STEPS), steps_per_epoch=TRAIN_STEPS)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(got == {k: TRAIN_STEPS * v for k, v in expect.items()},
              f"{dtype} training launched {got}, expected {TRAIN_STEPS} x {expect}")
        for k in launches:
            launches[k] += got[k]
        losses = trainer.step_losses
        check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), "training losses")
        moved = [n for n, p in trainer.model.named_parameters() if not torch.equal(p, before[n])]
        check(all(p.dtype == torch.float32 for p in trainer.model.parameters()) and moved,
              "the fp32 master weights must stay fp32 and move")
        step_ms = [1e3 * s for s in trainer.step_seconds]
        median_ms = float(np.median(step_ms[1:]))
        # one more step, profiled (its launches are not the main path's)
        step_fn = next(iter(trainer._step_fns.values()))
        images, masks, obj_valid = trainer._place_batch(batch, TRAIN_OBJECTS)

        def one_step():
            trainer.opt_state, metrics = step_fn(trainer.model, trainer.opt_state, images, masks,
                                                 obj_valid, trainer._gen, 1e-6)
            return float(metrics["loss"])

        busy, fams, top = device_split(one_step, reps=1)
        k3_ms = fams.get("K3 flash_attention_bwd (csrc)", {}).get("ms", 0.0)
        log(f"training {dtype}: profiled step K3 (K3a + K3b) device time {k3_ms:.1f} ms of "
            f"{busy:.1f} busy ({k3_ms / busy:.1%})")
        log(f"training {dtype}: Trainer.run, {TRAIN_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s; losses {[round(x, 4) for x in losses]}; ms per "
            f"step {[round(x, 1) for x in step_ms]} (median after the first {median_ms:.1f}); "
            f"peak device memory {peak:.2f} GiB; launches {got}; profiled step device busy "
            f"{busy:.1f} ms, idle share {1 - busy / median_ms:.1%}; {len(moved)} of "
            f"{len(before)} parameters moved")
        log(json.dumps({"training_step_device_split": dtype, "families": fams,
                        "top_kernels_ms": top}))
        runs[dtype] = dict(losses=losses, step_ms=step_ms, median_step_ms=median_ms,
                           peak_gib=peak, busy_ms=busy, idle_share=1 - busy / median_ms,
                           k3_ms=k3_ms, launches=got)
        del trainer, before
        torch.cuda.empty_cache()
    l32, l16 = runs["float32"]["losses"][0], runs["bfloat16"]["losses"][0]
    log(f"bf16 vs fp32 first-step loss: {l16:.4f} vs {l32:.4f} (rel "
        f"{abs(l16 - l32) / abs(l32):.3f}, limit {TRAIN_BF16_LOSS_RTOL})")
    check(abs(l16 - l32) <= TRAIN_BF16_LOSS_RTOL * abs(l32), "bf16 training drifts from fp32")
    return runs, launches


@phase
def phase_train_cli():
    """The CLI on a small PNG folder where Pillow is installed (hiera_t at
    256 px, 2 frames, 1 step: the folder reader and loader on the card)."""
    import importlib.util
    import tempfile

    if importlib.util.find_spec("PIL") is None:
        log("Pillow is not installed here: the CLI's PNG reader is not run")
        return None
    from PIL import Image

    from sam2_opt_tpu_torch.training.train import main as train_main

    root = tempfile.mkdtemp(prefix="sam2_chip_smoke_cli_")
    batch = training_video(T=2, S=256)
    for t in range(2):
        for sub, arr in (("JPEGImages", batch["images"][0, t]),
                         ("Annotations", batch["masks"][0, t, 0].astype(np.uint8))):
            d = f"{root}/{sub}/video0"
            os.makedirs(d, exist_ok=True)
            Image.fromarray(arr).save(f"{d}/{t:05d}.png")
    t0 = time.perf_counter()
    trainer = train_main(["--img_folder", f"{root}/JPEGImages", "--gt_folder",
                          f"{root}/Annotations", "--variant", "hiera_t", "--image-size", "256",
                          "--num-epochs", "1", "--num-frames", "2", "--max-objects", "1",
                          "--checkpoint-dir", f"{root}/ckpt", "--log-dir", f"{root}/logs"])
    check(trainer.device.type == "cuda" and trainer.steps == 1
          and np.isfinite(trainer.step_losses).all(), "the training CLI on the card")
    log(f"training CLI (hiera_t, 256 px, PNG folder): 1 step, loss {trainer.step_losses[0]:.4f}, "
        f"{time.perf_counter() - t0:.1f} s")
    return trainer.step_losses[0]



# --------------------------------------------------------------------------- #
# slice 4: the trunk's opt-in kernel routes (K5-K8)
# --------------------------------------------------------------------------- #


def window_bound_ms(N, H, Sq, Skv, D, dtype):
    """Least time for per-window attention on these inputs: 4*Sq*Skv*D
    operations per (window, head); q, k, v read once, out written once.
    fp32 runs on the tensor cores as three TF32 products per fp32 product
    (since slice 8), so, as for K3, its operations count at a third of
    TF32's 495 TFLOP/s (K3_FP32_FLOPS): no share of bound reads over 100%."""
    flops = 4.0 * N * H * Sq * Skv * D
    nbytes = (torch.finfo(dtype).bits // 8) * N * H * D * (2 * Sq + 2 * Skv)
    t_ops, t_bytes = flops / attention_flops_rate(dtype), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k8_executed_flops(N, C, H, C_out):
    """Operations K8 executes for x [N, C], w1 [H, C], w2 [C_out, H]: it
    pads C to a multiple of 16 and tiles the output columns by 144 (C_out
    <= 144) or 288, running GEMM1 once per column tile. A mirror of the
    tiling in `csrc/fused_mlp.cu`, for the log line only: beside the
    function's 2 N H (C + C_out), 1.5x at hiera-L stage 3, 2.5x at stage 4."""
    nt = 144 if C_out <= 144 else 288
    tiles = -(-C_out // nt)
    return 2.0 * N * H * tiles * (-(-C // 16) * 16 + nt)


def mlp_bound_ms(N, C, H, C_out):
    """Least time for K8 (bf16): 2*N*C*H + 2*N*H*C_out operations; x, the
    weights and biases read once, out written once."""
    flops = 2.0 * N * H * (C + C_out)
    nbytes = 2 * (N * C + N * C_out + H * C + C_out * H + H + C_out)
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.bfloat16], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def window_within(out, ref, q, k, v):
    """(within, |out - ref|) on the [..., S, D] layout."""
    from sam2_opt_tpu_torch.kernels.window_attention import window_attention_bf16_bound

    err = (out.float() - ref.float()).abs()
    if q.dtype == torch.float32:
        lim = WINDOW_FP32_TOL[1] + WINDOW_FP32_TOL[0] * ref.abs()
    else:
        lim = window_attention_bf16_bound(q, k, v, ref)
    return bool((err <= lim).all()), err


def window_cases(dtype):
    """(label, q, k, v) on [N, S, heads, D] for phase 11, from the seed: the
    four hiera-L stage shapes and the ragged windows as views of one
    [N, S, 3, heads, D] projection; K7's 16 queries over 64 keys."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(dtype)  # noqa: E731
    for N, S, H, D in WINDOW_SHAPES + [(16, 49, 16, 56), (16, 196, 8, 56), (16, 49, 8, 96),
                                       (16, 196, 4, 96)]:
        q, k, v = randn(N, S, 3, H, D).unbind(2)
        yield f"{(N, S, H, D)} qkv views", q, k, v
    yield "(256, 16 queries / 64 keys, 4, 72)", randn(256, 16, 4, 72), randn(256, 64, 4, 72), \
        randn(256, 64, 4, 72)


@phase
def phase_windows():
    """K5, K6 and K7 against their plain version on the card; returns the
    largest error per wrapper."""
    from sam2_opt_tpu_torch.kernels.window_attention import (
        packed_window_attention,
        window_attention,
        window_attention_ref,
        window_flash_3d,
    )

    t = lambda x: x.transpose(1, 2)  # noqa: E731  [N, S, h, D] <-> [N, h, S, D]
    max_err = {"K5": 0.0, "K6": 0.0, "K7": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for label, q, k, v in window_cases(dtype):
            ref = window_attention_ref(t(q), t(k), t(v))
            same = q.shape[1] == k.shape[1]
            runs = [("K7", t(packed_window_attention(q, k, v)))]
            if same:
                runs += [("K6", t(window_flash_3d(q, k, v))), ("K5", window_attention(t(q), t(k), t(v)))]
            torch.cuda.synchronize()
            errs = []
            for key, out in runs:
                ok, err = window_within(out, ref, t(q), t(k), t(v))
                max_err[key] = max(max_err[key], err.max().item())
                errs.append(f"{key} {err.max().item():.3e}")
                check(ok, f"{key} disagrees with its plain version ({dtype}, {label})")
            log(f"window {dtype} {label}: max|out-ref| {', '.join(errs)} (mean |ref| "
                f"{ref.float().abs().mean().item():.3e}; "
                + ("fp32: rtol 1e-5 + atol 1e-5)" if dtype == torch.float32 else
                   "bf16: per-element rounding bound)"))
            if label.startswith(str(WINDOW_SHAPES[2])):
                bad_ref = window_attention_ref(2 * t(q), t(k), t(v))
                bad, err = window_within(runs[0][1], bad_ref, 2 * t(q), t(k), t(v))
                log(f"  negative control (plain version at twice the scale): max|out-ref| "
                    f"{err.max().item():.3e}")
                check(not bad, "the window check cannot see the softmax scale")
    return max_err


def mlp_inputs(N, C, gen):
    """bf16 x [N, C], w1 [4C, C], b1, w2 [C, 4C], b2 from the seed, at the
    scale of a trained layer (weights ~ 1/sqrt(fan-in), biases ~ 0.1)."""
    H = 4 * C
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    return [a.to(torch.bfloat16) for a in (randn(N, C), randn(H, C) / math.sqrt(C),
                                           0.1 * randn(H), randn(C, H) / math.sqrt(H),
                                           0.1 * randn(C))]


@phase
def phase_k8():
    """K8 against its plain version on the card, bf16; returns the largest
    error. The negative control leaves out the GELU in the plain version:
    the check must fail."""
    from sam2_opt_tpu_torch.kernels.fused_mlp import fused_mlp, fused_mlp_bf16_bound, fused_mlp_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    max_err = 0.0
    for N, C in MLP_SHAPES_L + MLP_SHAPES_BP + [(1000, 144)]:
        x, w1, b1, w2, b2 = mlp_inputs(N, C, gen)
        out = fused_mlp(x, w1, b1, w2, b2, fast_act=True)
        torch.cuda.synchronize()
        ref = fused_mlp_ref(x, w1, b1, w2, b2, fast_act=True)
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= fused_mlp_bf16_bound(x, w1, b1, w2, ref)).all())
        max_err = max(max_err, err.max().item())
        log(f"K8 bf16 N={N} C={C} H={4 * C}: max|out-ref| {err.max().item():.3e} (mean |ref| "
            f"{ref.float().abs().mean().item():.3e}; per-element rounding bound)")
        check(ok, "K8 disagrees with its plain version")
        if (N, C) == MLP_SHAPES_L[2]:
            h = (torch.matmul(x.float(), w1.float().t()) + b1.float()).to(x.dtype)
            bad_ref = (torch.matmul(h.float(), w2.float().t()) + b2.float()).to(x.dtype)
            bad_err = (out.float() - bad_ref.float()).abs()
            frac = (bad_err > fused_mlp_bf16_bound(x, w1, b1, w2, bad_ref)).float().mean().item()
            log(f"  negative control (no GELU): max|out-ref| {bad_err.max().item():.3e}, "
                f"{frac:.1%} of elements outside")
            check(frac > 0, "K8's check cannot see the activation")
    return max_err


@phase
def phase_route_grads():
    """Autograd through K6, K7 (fp32) and K8 (bf16) against autograd through
    their plain versions, at one small shape; K5 under autograd raises."""
    from sam2_opt_tpu_torch.kernels.fused_mlp import fused_mlp, fused_mlp_ref
    from sam2_opt_tpu_torch.kernels.window_attention import (
        packed_window_attention,
        window_attention,
        window_attention_nshd_ref,
        window_flash_3d,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    q, k, v, g = (torch.randn(16, 64, 2, 72, device="cuda", generator=gen) for _ in range(4))
    cases = [("K6", window_flash_3d, window_attention_nshd_ref, (q, k, v), g, torch.float32),
             ("K7", packed_window_attention, window_attention_nshd_ref, (q, k, v), g,
              torch.float32)]
    mlp = mlp_inputs(256, 144, gen)
    cases.append(("K8", lambda *a: fused_mlp(*a, fast_act=True),
                  lambda *a: fused_mlp_ref(*a, fast_act=True), mlp,
                  torch.randn(256, 144, device="cuda", generator=gen).to(torch.bfloat16),
                  torch.bfloat16))
    for key, fn, plain, args, dout, dtype in cases:
        a = [x.clone().requires_grad_() for x in args]
        b = [x.clone().requires_grad_() for x in args]
        got = torch.autograd.grad(fn(*a), a, dout)
        want = torch.autograd.grad(plain(*b), b, dout)
        worst = max((x.float() - y.float()).abs().max().item() / y.float().abs().max().item()
                    for x, y in zip(got, want))
        log(f"{key} gradients through the kernel vs autograd of the plain version ({dtype}): "
            f"worst |err|/max|g| {worst:.2e} (limit {ROUTE_GRAD_TOL[dtype]})")
        check(worst <= ROUTE_GRAD_TOL[dtype], f"{key}'s gradients disagree with the plain version")
    try:
        window_attention(*(x.transpose(1, 2).requires_grad_() for x in (q, k, v)))
    except RuntimeError as e:
        log(f"K5 under autograd raises: {e}")
    else:
        raise RuntimeError("K5 under autograd must raise")


def worst_masks(outs, ref):
    """(min mask mIoU, max |dlogit|/scale, max |dIoU|) of prompt outputs
    against reference outputs."""
    worst_miou, worst_logit, worst_diou = 1.0, 0.0, 0.0
    for key, (masks, ious, low) in outs.items():
        ref_masks, ref_ious, ref_low = ref[key]
        worst_miou = min(worst_miou, min(miou(a, b) for a, b in zip(ref_masks, masks)))
        scale = max(1.0, float(np.abs(ref_low).max()))
        worst_logit = max(worst_logit, float(np.abs(low - ref_low).max()) / scale)
        worst_diou = max(worst_diou, float(np.abs(ious - ref_ious).max()))
    return worst_miou, worst_logit, worst_diou


@phase
def phase_routes(predictor, image, default, counters):
    """The slice's main path: the hiera-L image predictor's set_image and
    predict under W1 and W2 (bf16) and W1 (fp32); returns the launches of
    each kernel summed over the three set_image calls."""
    orig_hw = image.shape[:2]
    launches = dict.fromkeys(counters, 0)
    for (setting, dtype), expect in ROUTE_LAUNCHES.items():
        predictor.set_runtime_backend("cuda" if dtype == torch.bfloat16 else "eager")
        with switches(ROUTES[setting]):
            # the main path: counts to 0 just before, read just after
            for c in counters.values():
                c.launches = 0
            predictor.set_image(image)
            torch.cuda.synchronize()
            got = {key: c.launches for key, c in counters.items()}
            outs = run_prompts(predictor, orig_hw)
            after = {key: c.launches for key, c in counters.items()}
        check(got == expect, f"{setting} {dtype} set_image launched {got}, expected {expect}")
        check(after == got, "predict must launch no trunk kernel")
        for key in launches:
            launches[key] += got[key]
        if dtype == torch.bfloat16:
            vs_bf16 = worst_masks(outs, default[torch.bfloat16])
            vs_fp32 = worst_masks(outs, default[torch.float32])
            log(f"{setting} bf16: launches {got}; min mask mIoU vs the default bf16 route "
                f"{vs_bf16[0]:.4f}, vs the default fp32 route {vs_fp32[0]:.4f} (limit > "
                f"{BF16_MIOU_MIN}); max|dIoU| vs fp32 {vs_fp32[2]:.3e}")
            check(min(vs_bf16[0], vs_fp32[0]) > BF16_MIOU_MIN,
                  f"{setting} bf16 masks drift from the default routes")
        else:
            vs_fp32 = worst_masks(outs, default[torch.float32])
            log(f"{setting} fp32: launches {got}; max|dlogit|/scale vs the default fp32 route "
                f"{vs_fp32[1]:.3e} (limit {CPU_LOGIT_RTOL}), max|dIoU| {vs_fp32[2]:.3e}")
            check(vs_fp32[1] <= CPU_LOGIT_RTOL, f"{setting} fp32 logits drift from the default")
    return launches


@phase
def phase_route_times(predictor, image):
    """set_image wall, device split and idle share: bf16 under the default
    route, W1 and W2; fp32 under the default route and W1 (K5's 42 launches)."""
    times = {}
    for dtype, backend, settings in ((torch.bfloat16, "cuda", ("default", "W1", "W2")),
                                     (torch.float32, "eager", ("default", "W1"))):
        predictor.set_runtime_backend(backend)
        name = str(dtype).replace("torch.", "")
        for setting in settings:
            with switches(ROUTES.get(setting, {})):
                wall = cuda_ms(lambda: predictor.set_image(image), reps=5, warmup=2)
                busy, fams, top = device_split(lambda: predictor.set_image(image))
            launches = sum(f["launches"] for f in fams.values())
            log(f"{name} set_image, {setting}: {wall:.3f} ms (device busy {busy:.3f} ms, idle "
                f"share {1 - busy / wall:.1%}, {launches:.0f} kernel launches)")
            log(json.dumps({"set_image_device_split": f"{name} {setting}", "families": fams,
                            "top_kernels_ms": top}))
            key = setting if dtype == torch.bfloat16 else f"{name} {setting}"
            times[key] = dict(set_image_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                              launches=launches)
    predictor.set_runtime_backend("cuda")
    return times


@phase
def phase_route_kernel_times():
    """K5, K6, K7 at hiera-L's windowed shapes (bf16; K5 also fp32) and K8
    at its four block-MLP shapes, cold L2, beside bound, plain version and
    library yardstick; device times from CUDA graph replays (`graph_ms`)."""
    from sam2_opt_tpu_torch.kernels.fused_mlp import fused_mlp, fused_mlp_ref
    from sam2_opt_tpu_torch.kernels.window_attention import (
        packed_window_attention,
        window_attention,
        window_attention_nshd_ref,
        window_flash_3d,
    )

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        for N, S, H, D in WINDOW_SHAPES:
            q, k, v = torch.randn(N, S, 3, H, D, device="cuda", generator=gen).to(dtype).unbind(2)
            plain_ms = graph_ms(lambda: window_attention_nshd_ref(q, k, v), reps=5, flush=flush)
            library_ms = graph_ms(lambda: F.scaled_dot_product_attention(t(q), t(k), t(v)),
                                 flush=flush)
            bound_ms, bound_by = window_bound_ms(N, H, S, S, D, dtype)
            wrappers = [("K5", lambda: window_attention(t(q), t(k), t(v)))]
            if dtype == torch.bfloat16:
                wrappers += [("K6", lambda: window_flash_3d(q, k, v)),
                             ("K7", lambda: packed_window_attention(q, k, v))]
            line = []
            for key, fn in wrappers:
                ms = graph_ms(fn, flush=flush)
                rows[(key, dtype, (N, S, H, D))] = dict(ms=ms, plain_ms=plain_ms,
                                                        library_ms=library_ms, bound_ms=bound_ms,
                                                        bound_by=bound_by)
                line.append(f"{key} {ms:.4f} ms ({bound_ms / ms:.1%} of bound)")
            log(f"window {dtype} {(N, S, H, D)}: {', '.join(line)}; plain {plain_ms:.4f} ms, "
                f"F.scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by})")
    for N, C in MLP_SHAPES_L:
        x, w1, b1, w2, b2 = mlp_inputs(N, C, gen)
        ms = graph_ms(lambda: fused_mlp(x, w1, b1, w2, b2, fast_act=True), flush=flush)
        plain_ms = graph_ms(lambda: fused_mlp_ref(x, w1, b1, w2, b2, fast_act=True), reps=5,
                           flush=flush)
        library_ms = graph_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1), approximate="tanh"),
                                              w2, b2), flush=flush)
        bound_ms, bound_by = mlp_bound_ms(N, C, 4 * C, C)
        executed_ms = 1e3 * k8_executed_flops(N, C, 4 * C, C) / PEAK_FLOPS[torch.bfloat16]
        log(f"K8 bf16 N={N} C={C}: {ms:.4f} ms ({bound_ms / ms:.1%} of bound), plain "
            f"{plain_ms:.4f} ms, unfused bf16 Linear -> GELU -> Linear (3 calls) "
            f"{library_ms:.4f} ms (K8 takes {ms / library_ms:.2f}x its time), bound {bound_ms:.4f} ms "
            f"({bound_by}); the work the kernel executes (its column split) bounds it at "
            f"{executed_ms:.4f} ms")
        rows[("K8", torch.bfloat16, (N, C))] = dict(ms=ms, plain_ms=plain_ms,
                                                   library_ms=library_ms, bound_ms=bound_ms,
                                                   bound_by=bound_by)
    return rows


# --------------------------------------------------------------------------- #
# slice 5: K4 under SAM2_TPU_FUSED_KV_PROJ=1; K9 and K10 behind the window
# bench tool's port
# --------------------------------------------------------------------------- #

K4_SWITCH = {"SAM2_TPU_FUSED_KV_PROJ": "1"}
K4_DM = 64  # mem_dim: the memory tokens' width before the projections
# K4 vs plain: K2's tolerances, rederived. Given K, K2's reasoning holds (the
# rotation is bit-exact on both sides; P and out are rounded as K1 rounds
# them). K4 adds the projections: kernel and plain version sum the same 64
# products per element of K and V in other orders, in fp32, and round once
# to q's dtype. In fp32 that moves K and V by ~1e-7 relative, inside 1e-5.
# In bf16 a rounding may land one ulp (at most 2^-7 relative) apart where
# the two fp32 sums straddle a rounding boundary, in ~2^-16 of the elements:
# a V element one ulp off moves out by p * 2^-7 |v| (p <= ~0.01 here), a K
# element moves one key's logit by 2^-7 |q_d k_d| / 16 and the row's lse by
# p times that: far inside atol 1e-3 and the lse's 1e-5.
K4_TOL = K2_TOL
K4_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max |g|
K4_CROSS = (1, 4096, K2_SLOTS * 4096 + 4 * K2_PTRS, K2_D, K4_DM)  # (B, Sq, Skv, D, Dm)
K4_VIDEO_FRAMES = 3
# per tracked frame under the switch: the 4 cross-attentions move from K2 to K4
K4_FRAME_LAUNCHES = (3, 4, 4)  # (K1, K2, K4)
K4_STEP_LAUNCHES = {"K1": 6, "K2": 28, "K4": 28, "K3a": 59, "K3b": 59}
K4_TRAIN_STEPS = 2
# SAM2_TPU_FUSED_ROPE=0 turns off K2 and K4: memory attention rotates K in
# torch and runs K1 at D = 256 on K2's shapes, so per tracked frame (K1, K2,
# K4) the trunk's 3 global blocks plus 4 self- and 4 cross-attentions on K1
ROPE_OFF_SWITCH = {"SAM2_TPU_FUSED_ROPE": "0"}
ROPE_OFF_FRAME_LAUNCHES = (11, 0, 0)


def k4_bound_ms(B, Sq, Skv, D, Dm, dtype, valid_keys=None):
    """Least time for K4's work on these inputs: per object the attention's
    4*Sq*valid*D operations, each valid key projected once (2*2*Dm*D) and
    rotated (3 per K element); q, the memory tokens, weights, biases, tables
    and mask read once, out and lse written once."""
    valid = B * Skv if valid_keys is None else valid_keys
    flops = 4.0 * Sq * valid * D + 4.0 * valid * Dm * D + 3.0 * valid * D
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = (itemsize * (2 * B * Sq * D + 2 * B * Skv * Dm + 2 * D * Dm + Skv * D)
              + 4 * 2 * D + B * Skv + 4 * B * Sq)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k4_executed_gflop(B, Sq, Skv, D, Dm):
    """What the kernel executes: the attention plus, per 128-row query tile,
    the projection of every kv tile it reads."""
    return (4.0 * B * Sq * Skv * D + B * math.ceil(Sq / 128) * 4.0 * Skv * Dm * D) / 1e9


def k4_params(gen, dtype, bias):
    """wk, bk, wv, bv: weights ~ 1/sqrt(fan-in), biases `bias` x N(0, 1)."""
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    return [(randn(K2_D, K4_DM) / 8).to(dtype), (bias * randn(K2_D)).to(dtype),
            (randn(K2_D, K4_DM) / 8).to(dtype), (bias * randn(K2_D)).to(dtype)]


def k4_cases(dtype, bias=0.5):
    """(label, [q, mem_k, mem_v, wk, bk, wv, bv, cos, sin, kv_mask]): phase
    4's cases with the memory Dm wide. The forward checks take biases of
    0.5, large enough that leaving bk out is visible; the gradient check
    takes these and the JAX kernel test's 0.05 (see phase_k4_grads)."""
    from sam2_opt_tpu_torch.models.memory_attention import _rope_half_tables

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cpu_gen = torch.Generator().manual_seed(SEED + 10)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(dtype)  # noqa: E731
    D, S = K2_D, 4096
    c, s = _rope_half_tables(D, 64, 64, 10000.0, K2_SLOTS, 4 * K2_PTRS, torch.device("cuda"), dtype)
    skv = c.shape[0]
    yield ("cross, 3/7 slots + 9/16 pointers masked",
           [randn(1, 1, S, D), randn(1, skv, K4_DM), randn(1, skv, K4_DM), *k4_params(gen, dtype, bias),
            c, s, memory_mask(1, cpu_gen)])
    yield ("cross, two objects",
           [randn(2, 1, S, D), randn(2, skv, K4_DM), randn(2, skv, K4_DM), *k4_params(gen, dtype, bias),
            c, s, memory_mask(2, cpu_gen)])
    kv_mask = torch.rand(2, 1500, device="cuda", generator=gen) > 0.3
    kv_mask[1] = False
    yield ("ragged, row 1 fully masked",
           [randn(2, 1, 1000, D), randn(2, 1500, K4_DM), randn(2, 1500, K4_DM),
            *k4_params(gen, dtype, bias), c[:1500].contiguous(), s[:1500].contiguous(), kv_mask])


@phase
def phase_k4(kv_proj, kv_proj_ref):
    """K4 against its plain version on the card; returns the largest error.
    The negative control holds the kernel to the plain version without bk:
    the check must fail."""
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for label, args in k4_cases(dtype):
            out, lse = kv_proj(*args)
            ref, ref_lse = kv_proj_ref(*args)
            torch.cuda.synchronize()
            ok, err = k2_within(out, ref, dtype)
            lse_err = (lse - ref_lse).abs()
            ok_lse = bool((lse_err <= LSE_TOL[1] + LSE_TOL[0] * ref_lse.abs()).all())
            max_err = max(max_err, err.max().item())
            q, mem_k = args[0], args[1]
            log(f"K4 {dtype} B={q.shape[0]} Sq={q.shape[2]} Skv={mem_k.shape[1]} D={q.shape[3]} "
                f"Dm={mem_k.shape[2]} {label}: max|out-ref| {err.max().item():.3e} (rtol "
                f"{K4_TOL[dtype][0]}, atol {K4_TOL[dtype][1]}; mean |ref| "
                f"{ref.float().abs().mean().item():.3e}), max|lse-ref| {lse_err.max().item():.3e}")
            check(ok and ok_lse, "K4 disagrees with its plain version")
            if label.startswith("ragged"):
                check(not out[1].any() and bool((lse[1] == -1e30).all()),
                      "K4: fully masked rows must output 0 and lse -1e30")
            if label.startswith("cross, 3/7"):
                no_bias = args[:4] + [torch.zeros_like(args[4])] + args[5:]
                bad_ref, _ = kv_proj_ref(*no_bias)
                bad, bad_err = k2_within(out, bad_ref, dtype)
                rtol, atol = K4_TOL[dtype]
                frac = (bad_err > atol + rtol * bad_ref.float().abs()).float().mean().item()
                log(f"  negative control (plain version without bk): max|out-ref| "
                    f"{bad_err.max().item():.3e}, {frac:.1%} of elements outside the tolerance")
                check(not bad, "K4's check cannot see the K bias")
            del out, lse, ref, ref_lse, args
    return max_err


@phase
def phase_k4_grads(kv_proj, kv_proj_ref):
    """The seven gradients through K4 (backward: K3 and the projection
    products) against autograd of the plain version at the cross shape with
    phase 4's mask, at the JAX kernel test's biases (0.05) and at phase 15's
    (0.5). A witness goes through the same check on the same inputs: the
    unfused route K4 replaces (two F.linear, K2 forward, K3 backward). fp32:
    K4 within 1e-4 of max |g|. bf16: within 2e-2, or, for a gradient where
    the witness itself misses 2e-2, within twice the witness's error. The
    flash backward takes delta = rowsum(dO * O) from the bf16 output, and dQ
    and dbk carry that rounding times the component every key shares, which
    a large bias makes large, on either route. Returns {case: {route:
    {gradient: max |err| / max |g|}}}."""
    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention_rope

    def unfused(q, mk, mv, wk, bk, wv, bv, c, s, mask):
        return flash_attention_rope(q, F.linear(mk, wk, bk)[:, None],
                                    F.linear(mv, wv, bv)[:, None], c, s, mask)

    names = ("q", "mem_k", "mem_v", "wk", "bk", "wv", "bv")
    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        for bias in (0.05, 0.5):
            _, args = next(iter(k4_cases(dtype, bias=bias)))
            g = torch.randn(args[0].shape, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(SEED + 11)).to(dtype)
            grads = {}
            for route, fn in (("K4", kv_proj), ("unfused", unfused), ("plain", kv_proj_ref)):
                leaves = [a.clone().requires_grad_() for a in args[:7]]
                out, _ = fn(*leaves, *args[7:])
                grads[route] = torch.autograd.grad(out, leaves, g)
                del out, leaves
            errs = {route: {name: ((got.float() - want.float()).abs().max()
                                   / want.float().abs().max()).item()
                            for name, got, want in zip(names, grads[route], grads["plain"])}
                    for route in ("K4", "unfused")}
            tol = K4_GRAD_TOL[dtype]
            limit = {n: tol if dtype == torch.float32 else max(tol, 2 * errs["unfused"][n])
                     for n in names}
            bad = [n for n in names if errs["K4"][n] > limit[n]]
            case = f"{str(dtype).replace('torch.', '')} bias {bias}"
            log(f"K4 gradients vs autograd of the plain version ({case}, cross shape), max|err| / "
                f"max|g|: K4 {({n: round(e, 6) for n, e in errs['K4'].items()})}; witness "
                f"(2 F.linear + K2 + K3) {({n: round(e, 6) for n, e in errs['unfused'].items()})}; "
                f"limits {({n: round(x, 6) for n, x in limit.items()})}")
            check(not bad, f"K4's gradients disagree with the plain version ({case}): {bad}")
            readings[case] = errs
            del grads, args, g
            torch.cuda.empty_cache()
    return readings


@phase
def phase_k4_times(kv_proj, kv_proj_ref):
    """K4 at the cross shape, every key valid (the steady state), cold L2,
    beside its bound, its plain version, the unfused route it replaces (two
    F.linear + K2) and the composite yardstick (two F.linear + rotation +
    F.scaled_dot_product_attention, which the port never calls)."""
    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention_rope
    from sam2_opt_tpu_torch.ops.posenc import apply_rotary_split

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    B, Sq, Skv, D, Dm = K4_CROSS
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        _, args = next(iter(k4_cases(dtype)))
        q, mk, mv, wk, bk, wv, bv, c, s, _ = args
        mask = torch.ones(B, Skv, dtype=torch.bool, device="cuda")
        attn_mask = mask[:, None, None, :]

        def unfused():
            return flash_attention_rope(q, F.linear(mk, wk, bk)[:, None], F.linear(mv, wv, bv)[:, None],
                                        c, s, mask)

        def library():
            kr = apply_rotary_split(F.linear(mk, wk, bk).float(), c.float(), s.float()).to(dtype)
            return F.scaled_dot_product_attention(q, kr[:, None], F.linear(mv, wv, bv)[:, None],
                                                  attn_mask=attn_mask)

        ms = cuda_ms(lambda: kv_proj(q, mk, mv, wk, bk, wv, bv, c, s, mask), reps=5, flush=flush)
        plain_ms = cuda_ms(lambda: kv_proj_ref(q, mk, mv, wk, bk, wv, bv, c, s, mask), reps=3,
                           warmup=1, flush=flush)
        unfused_ms = cuda_ms(unfused, reps=5, flush=flush)
        library_ms = cuda_ms(library, reps=5, flush=flush)
        bound_ms, bound_by = k4_bound_ms(B, Sq, Skv, D, Dm, dtype)
        executed = k4_executed_gflop(B, Sq, Skv, D, Dm)
        log(f"K4 {dtype} {K4_CROSS}: {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused route "
            f"(2 F.linear + K2) {unfused_ms:.4f} ms, 2 F.linear + rotation + "
            f"F.scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of bound; executes {executed:.1f} GFLOP "
            f"({executed / ms:.1f} TFLOP/s)")
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        del args, q, mk, mv
        torch.cuda.empty_cache()
    return rows


@phase
def phase_k1_wide(flash_attention, flash_attention_ref):
    """K1 at D = 256, memory attention's attention under
    `SAM2_TPU_FUSED_ROPE=0`, against its plain version on phase 4's cases
    (K arrives rotated on that route, so the tables play no part), bf16 and
    fp32, with K2's tolerances (K2 runs this body on the rotated K); the
    negative control holds the cross case to the plain version without its
    mask (it must fail). Then its times at the cross and self shapes
    (`memory_attention_times`). Returns (largest error, {(shape label,
    dtype): times})."""
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for label, q, k, v, _, _, kv_mask in k2_cases(dtype):
            out, lse = flash_attention(q, k, v, kv_mask)
            ref, ref_lse = flash_attention_ref(q, k, v, kv_mask)
            torch.cuda.synchronize()
            ok, err = k2_within(out, ref, dtype)
            lse_err = (lse - ref_lse).abs()
            ok_lse = bool((lse_err <= LSE_TOL[1] + LSE_TOL[0] * ref_lse.abs()).all())
            max_err = max(max_err, err.max().item())
            log(f"K1 D=256 {dtype} B={q.shape[0]} Sq={q.shape[2]} Skv={k.shape[2]} {label}: "
                f"max|out-ref| {err.max().item():.3e} (rtol {K2_TOL[dtype][0]}, atol "
                f"{K2_TOL[dtype][1]}; mean |ref| {ref.float().abs().mean().item():.3e}), "
                f"max|lse-ref| {lse_err.max().item():.3e}")
            check(ok and ok_lse, "K1 at D = 256 disagrees with its plain version")
            if label.startswith("ragged"):
                check(not out[1].any() and bool((lse[1] == -1e30).all()),
                      "K1 at D = 256: fully masked rows must output 0 and lse -1e30")
            if label.startswith("cross, 3/7"):
                unmasked, _ = flash_attention_ref(q, k, v, None)
                bad, bad_err = k2_within(out, unmasked, dtype)
                log(f"  negative control (plain version without the mask): max|out-ref| "
                    f"{bad_err.max().item():.3e}")
                check(not bad, "the K1 D = 256 check cannot see the mask")
            del out, lse, ref, ref_lse

    times = memory_attention_times({"K1 D=256": (flash_attention, flash_attention_ref)})
    return max_err, times["K1 D=256"]


@phase
def phase_route_video(counters):
    """The video slice under memory attention's switches: the hiera-L video
    predictor of phase 6 (rebuilt from the seed), 3 frames of its video in
    fp32 and bf16, the default route, then K4's (`SAM2_TPU_FUSED_KV_PROJ=1`)
    and the unfused one (`SAM2_TPU_FUSED_ROPE=0`: K rotated in torch, K1 at
    D = 256), no hole filling on any (a logit on the threshold could move a
    small component): exact launches per frame, fp32 low-res logits within
    1e-3 of their scale of the default route's, bf16 masks by mIoU; then ms
    per tracked frame and the device split of every route over the 8
    frames. Returns ({route: {kernel: launches of the checked runs}}, times);
    "K1 D=256" counts the K1 launches of the tracked frames past the trunk's
    3 per frame."""
    from sam2_opt_tpu_torch import build_sam2_video_predictor

    predictor = build_sam2_video_predictor("hiera_l", seed=SEED)
    with torch.no_grad():
        predictor.model.module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += OBJ_BIAS
    video = synthetic_video(SEED)
    points = np.array([[VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120]], np.float32)
    kernels = tuple(counters.values())
    routes = {"K4": (K4_SWITCH, K4_FRAME_LAUNCHES),
              "rope off": (ROPE_OFF_SWITCH, ROPE_OFF_FRAME_LAUNCHES)}
    launches = {route: {**dict.fromkeys(counters, 0), "K1 D=256": 0} for route in routes}
    times = {}
    for dtype, backend in ((torch.float32, "eager"), (torch.bfloat16, "cuda")):
        predictor.set_runtime_backend(backend)
        predictor.fill_hole_area = 0
        default_state, default_masks, _ = track(predictor, video, K4_VIDEO_FRAMES, points)
        for route, (env, expect) in routes.items():
            with switches(env):
                # the main path: counts to 0 just before, read just after
                for c in kernels:
                    c.launches = 0
                state, masks, per_frame = track(predictor, video, K4_VIDEO_FRAMES, points,
                                                counts=kernels)
                torch.cuda.synchronize()
                for key, c in counters.items():
                    launches[route][key] += c.launches
            launches[route]["K1 D=256"] += sum(f[0] - 3 for f in per_frame[1:])
            log(f"{route} route, {K4_VIDEO_FRAMES} frames, {dtype}: per frame (K1, K2, K4) "
                f"{per_frame}")
            check(per_frame == [(0, 0, 0)] + [expect] * (K4_VIDEO_FRAMES - 1),
                  f"each tracked frame on the {route} route must launch (K1, K2, K4) {expect}")
            if dtype == torch.float32:
                got, want = low_res(state), low_res(default_state)
                scale = max(1.0, float(want.abs().max()))
                worst = float((got - want).abs().max()) / scale
                log(f"  fp32 {route} route vs the default route: max|dlogit|/scale {worst:.3e} "
                    f"(limit {CPU_LOGIT_RTOL}; scale {scale:.3f})")
                check(worst <= CPU_LOGIT_RTOL,
                      f"fp32 video logits on the {route} route drift from the default route")
            else:
                ious = [miou(a[0, 0].cpu().numpy() > 0, b[0, 0].cpu().numpy() > 0)
                        for a, b in zip(masks, default_masks)]
                log(f"  bf16 {route} route vs the default route: per-frame mask mIoU "
                    f"{[round(float(x), 4) for x in ious]} (limit > {VIDEO_BF16_MIOU_MIN})")
                check(min(ious) > VIDEO_BF16_MIOU_MIN,
                      f"bf16 video masks on the {route} route drift from the default")
        predictor.fill_hole_area = 8
        key = str(dtype).replace("torch.", "")
        times[key] = {"default": propagation_times(predictor, video, points,
                                                   f"{dtype} default route")}
        for route, (env, _) in routes.items():
            with switches(env):
                times[key][route] = propagation_times(predictor, video, points,
                                                      f"{dtype} {route} route")
    del predictor
    torch.cuda.empty_cache()
    return launches, times


@phase
def phase_k4_train(counters, default_fp32_loss):
    """Training under the switch: Trainer.run at hiera-b+ 1024², two fp32
    and two bf16 steps on phase 10's batch and weights (the schedule warms
    up from lr 0, so the first step moves nothing): exact launches per
    step, the fp32 first-step loss within 1e-4 relative of phase 10's
    default route, masters that moved. Returns (K4 launches, {dtype:
    losses, ms per step})."""
    import tempfile

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.training.trainer import Trainer

    cfg = model_config("hiera_b+")
    batch = training_video()
    tmp = tempfile.mkdtemp(prefix="sam2_chip_smoke_train_k4_")
    launches, runs = 0, {}
    with switches(K4_SWITCH):
        for dtype in ("float32", "bfloat16"):
            trainer = Trainer(cfg, b_plus("cuda"), train_config(dtype, f"{tmp}/{dtype}"))
            before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
            torch.cuda.synchronize()
            # the main path: counts to 0 just before, read just after
            for c in counters.values():
                c.launches = 0
            trainer.run(lambda epoch: iter([batch] * K4_TRAIN_STEPS),
                        steps_per_epoch=K4_TRAIN_STEPS)
            torch.cuda.synchronize()
            got = {k: c.launches for k, c in counters.items()}
            loss = trainer.step_losses[0]
            step_ms = [1e3 * s for s in trainer.step_seconds]
            moved = sum(not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
            log(f"training under the switch, {dtype}: {K4_TRAIN_STEPS} steps, losses "
                f"{[round(x, 6) for x in trainer.step_losses]}, ms per step "
                f"{[round(x, 1) for x in step_ms]}; launches {got}; {moved} of {len(before)} "
                f"parameters moved")
            expect = {k: K4_TRAIN_STEPS * v for k, v in K4_STEP_LAUNCHES.items()}
            check(got == expect, f"{dtype} training under the switch launched {got}, expected {expect}")
            check(all(np.isfinite(trainer.step_losses)) and moved > 0,
                  "the K4 training steps must move the masters")
            if dtype == "float32":
                rel = abs(loss - default_fp32_loss) / abs(default_fp32_loss)
                log(f"  fp32 first-step loss vs the default route's {default_fp32_loss:.6f}: rel "
                    f"{rel:.2e} (limit {TRAIN_CPU_LOSS_RTOL})")
                check(rel <= TRAIN_CPU_LOSS_RTOL, "fp32 training loss under K4 drifts from default")
            launches += got["K4"]
            runs[dtype] = dict(losses=trainer.step_losses, step_ms=step_ms, launches=got)
            del trainer, before
            torch.cuda.empty_cache()
    return launches, runs


@phase
def phase_rope_off_train(counters, default_fp32_loss):
    """Training under `SAM2_TPU_FUSED_ROPE=0`: Trainer.run at hiera-b+
    1024², two fp32 and two bf16 steps on phase 10's batch and weights.
    Memory attention rotates K in torch and runs K1 at D = 256 where K2 ran,
    so per step K1 launches the trunk's 6 plus the 8 per tracked frame at
    D = 256 (K1's count less the trunk's, as phase 16 counts them), K2 none,
    K3a and K3b 59 each, the last 56 of them at D = 256 behind K1. The fp32
    first-step loss within 1e-4 relative of phase 10's default route,
    bf16's within 10% of this route's fp32, finite losses, masters that
    moved. Returns (K1 launches at D = 256, {dtype: losses, ms per step,
    launches})."""
    import tempfile

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.training.trainer import Trainer

    cfg = model_config("hiera_b+")
    batch = training_video()
    tmp = tempfile.mkdtemp(prefix="sam2_chip_smoke_train_rope_off_")
    per_step = launches_per_step()
    k2 = per_step.pop("K2")
    expect = {**per_step, "K1": per_step["K1"] + k2, "K2": 0, "K4": 0}
    runs = {}
    with switches(ROPE_OFF_SWITCH):
        for dtype in ("float32", "bfloat16"):
            trainer = Trainer(cfg, b_plus("cuda"), train_config(dtype, f"{tmp}/{dtype}"))
            before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
            torch.cuda.synchronize()
            # the main path: counts to 0 just before, read just after
            for c in counters.values():
                c.launches = 0
            trainer.run(lambda epoch: iter([batch] * K4_TRAIN_STEPS),
                        steps_per_epoch=K4_TRAIN_STEPS)
            torch.cuda.synchronize()
            got = {k: c.launches for k, c in counters.items()}
            wide = got["K1"] - K4_TRAIN_STEPS * per_step["K1"]
            step_ms = [1e3 * x for x in trainer.step_seconds]
            moved = sum(not torch.equal(p, before[n])
                        for n, p in trainer.model.named_parameters())
            log(f"training under SAM2_TPU_FUSED_ROPE=0, {dtype}: {K4_TRAIN_STEPS} steps, losses "
                f"{[round(x, 6) for x in trainer.step_losses]}, ms per step "
                f"{[round(x, 1) for x in step_ms]}; launches {got}, K1 at D = 256 {wide}; "
                f"{moved} of {len(before)} parameters moved")
            want = {k: K4_TRAIN_STEPS * v for k, v in expect.items()}
            check(got == want, f"{dtype} training under SAM2_TPU_FUSED_ROPE=0 launched {got}, "
                  f"expected {want}")
            check(wide == K4_TRAIN_STEPS * k2,
                  f"K1 at D = 256: {wide} launches, expected {K4_TRAIN_STEPS * k2}")
            check(all(np.isfinite(trainer.step_losses)) and moved > 0,
                  "the training steps under SAM2_TPU_FUSED_ROPE=0 must move the masters")
            loss = trainer.step_losses[0]
            ref = default_fp32_loss if dtype == "float32" else runs["float32"]["losses"][0]
            tol = TRAIN_CPU_LOSS_RTOL if dtype == "float32" else TRAIN_BF16_LOSS_RTOL
            rel = abs(loss - ref) / abs(ref)
            log(f"  {dtype} first-step loss vs {'the default route' if dtype == 'float32' else 'fp32'}"
                f" {ref:.6f}: rel {rel:.2e} (limit {tol})")
            check(rel <= tol, f"{dtype} training loss under SAM2_TPU_FUSED_ROPE=0 drifts")
            runs[dtype] = dict(losses=trainer.step_losses, step_ms=step_ms, launches=got,
                               k1_d256=wide)
            del trainer, before
            torch.cuda.empty_cache()
    return sum(r["k1_d256"] for r in runs.values()), runs


@phase
def phase_k9_k10():
    """K9 and K10 against their plain version at the bench tool's four
    shapes, bf16, within `window_attention_bf16_bound`; the negative control
    holds K9 to the plain version at twice the scale (it must fail). Returns
    ({key: largest error}, {(key, shape): plain ms})."""
    from sam2_opt_tpu_torch.kernels.window_attention import (
        window_attention_3d,
        window_attention_heads,
        window_attention_nshd_ref,
    )
    from sam2_opt_tpu_torch.tools.bench_window_flash import SHAPES

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    max_err, plain = {"K9": 0.0, "K10": 0.0}, {}
    for label, N, S, H, D in SHAPES:
        q, k, v = (torch.randn(N, S, H, D, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        ref = window_attention_nshd_ref(q, k, v)
        errs = []
        for key, fn in (("K9", window_attention_heads), ("K10", window_attention_3d)):
            out = fn(q, k, v)
            torch.cuda.synchronize()
            ok, err = window_within(t(out), t(ref), t(q), t(k), t(v))
            max_err[key] = max(max_err[key], err.max().item())
            errs.append(f"{key} {err.max().item():.3e}")
            check(ok, f"{key} disagrees with its plain version at {label} {(N, S, H, D)}")
            if (label, key) == (SHAPES[2][0], "K9"):
                bad, bad_err = window_within(t(out), t(window_attention_nshd_ref(2 * q, k, v)),
                                             2 * t(q), t(k), t(v))
                log(f"  negative control (plain version at twice the scale): max|out-ref| "
                    f"{bad_err.max().item():.3e}")
                check(not bad, "the K9 check cannot see the softmax scale")
        plain[(N, S, H, D)] = graph_ms(lambda: window_attention_nshd_ref(q, k, v), reps=5,
                                       flush=flush)
        log(f"K9/K10 bf16 {label} {(N, S, H, D)}: max|out-ref| {', '.join(errs)} (per-element "
            f"rounding bound); plain {plain[(N, S, H, D)]:.4f} ms")
    return max_err, plain


@phase
def phase_bench_tool(counters):
    """The ported bench tool's entry point on the card (its main path): one
    JSON row per shape, both kernels within the bound; returns (rows,
    launches)."""
    from sam2_opt_tpu_torch.tools import bench_window_flash

    # the main path: counts to 0 just before, read just after
    for c in counters.values():
        c.launches = 0
    rows = bench_window_flash.main(["--reps", "10"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log(f"bench tool: {len(rows)} rows, launches {launches}")
    check(len(rows) == len(bench_window_flash.SHAPES)
          and all(r["kern_h_within_bound"] and r["kern_3d_within_bound"] for r in rows),
          "the bench tool's kernels disagree with the plain version")
    check(all(v > 0 for v in launches.values()), "the bench tool must launch K9 and K10")
    return rows, launches


# --------------------------------------------------------------------------- #
# slice 6: the four attention switches the port reads as the JAX package does
# --------------------------------------------------------------------------- #

SWITCH_FRAMES = 3
FLASH_OFF_SWITCH = {"SAM2_TPU_FLASH": "0"}


@phase
def phase_switches(counters):
    """The switches of `ops.use_flash_attention` and of the fast-exp refusal
    on the card: under `SAM2_TPU_FLASH=0`, an fp32 `set_image` + `predict`,
    3 tracked frames of the hiera-L video predictor (rebuilt from the seed)
    and one more tracked frame under `SAM2_TPU_FUSED_KV_PROJ=1` launch no
    K1, K2 or K4, where the default route launches each, and their low-res
    logits stay within 1e-3 of their scale of the default route's (plain
    attention against the kernels: both fp32, sums in other orders); under
    `SAM2_TPU_KERNEL_FAST_EXP=1` a bf16 route to K1 (`ops.flash_or_sdpa` at
    hiera-L's global shape) or to K2 (memory self-attention at its real
    shape) raises before any launch. Returns the default route's launches
    of the checked runs."""
    from sam2_opt_tpu_torch import SAM2ImagePredictor, build_sam2_video_predictor
    from sam2_opt_tpu_torch.config import MemoryAttentionConfig
    from sam2_opt_tpu_torch.models.memory_attention import RoPEAttention, _rope_attention
    from sam2_opt_tpu_torch.ops import common as ops

    predictor = build_sam2_video_predictor("hiera_l", seed=SEED)
    with torch.no_grad():
        predictor.model.module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += OBJ_BIAS
    predictor.set_runtime_backend("eager")
    predictor.fill_hole_area = 0
    image_predictor = SAM2ImagePredictor(predictor.model)
    image = structured_image(SEED)
    video = synthetic_video(SEED)
    points = np.array([[VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120]], np.float32)
    runs, launches = {}, {}
    for route, env in (("default", {}), ("flash off", FLASH_OFF_SWITCH)):
        with switches(env):
            # the main path: counts to 0 just before, read just after
            for c in counters.values():
                c.launches = 0
            image_predictor.set_image(image)
            _, _, low = image_predictor.predict(**PROMPTS["point"], multimask_output=True)
            state, _, _ = track(predictor, video, SWITCH_FRAMES, points)
            with switches({"SAM2_TPU_FUSED_KV_PROJ": "1"}):
                # frame 0 is the prompted frame; frame 1 runs memory attention
                kv_state, _, _ = track(predictor, video, 2, points)
            torch.cuda.synchronize()
            launches[route] = {key: c.launches for key, c in counters.items()}
        runs[route] = (torch.from_numpy(low), low_res(state), low_res(kv_state))
        log(f"{route} route (fp32 set_image + predict, {SWITCH_FRAMES} tracked frames, "
            f"1 more under SAM2_TPU_FUSED_KV_PROJ=1): launches {launches[route]}")
    check(all(launches["default"][key] > 0 for key in ("K1", "K2", "K4")),
          f"the default route must launch K1, K2 and K4, launched {launches['default']}")
    check(not any(launches["flash off"].values()),
          f"SAM2_TPU_FLASH=0 launched {launches['flash off']}")
    for i, what in enumerate(("image low-res logits", "video low-res logits",
                              "video low-res logits under SAM2_TPU_FUSED_KV_PROJ=1")):
        got, want = runs["flash off"][i], runs["default"][i]
        scale = max(1.0, float(want.abs().max()))
        worst = float((got - want).abs().max()) / scale
        log(f"  SAM2_TPU_FLASH=0 vs the default route, {what}: max|dlogit|/scale {worst:.3e} "
            f"(limit {CPU_LOGIT_RTOL}; scale {scale:.3f})")
        check(worst <= CPU_LOGIT_RTOL, f"SAM2_TPU_FLASH=0 {what} drift from the default route")
    del predictor, image_predictor, state, kv_state, runs
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    B, H, S, D = MAIN_SHAPE
    q, k, v = (randn(B, H, S, D).bfloat16() for _ in range(3))
    cfg = MemoryAttentionConfig()
    attn = RoPEAttention(cfg.d_model, cfg.num_heads).to("cuda", torch.bfloat16)
    x = randn(1, K2_SELF[1], cfg.d_model).bfloat16()
    routes = (("K1", lambda: ops.flash_or_sdpa(q, k, v)),
              ("K2", lambda: _rope_attention(attn, cfg, x, x, x, None, 1, 0)))
    for key, fn in routes:
        with torch.no_grad():
            counters[key].launches = 0
            fn()  # the default route launches the kernel
            torch.cuda.synchronize()
            check(counters[key].launches > 0, f"the bf16 route to {key} must launch it")
            counters[key].launches = 0
            with switches({"SAM2_TPU_KERNEL_FAST_EXP": "1"}):
                try:
                    fn()
                except NotImplementedError as e:
                    log(f"the bf16 route to {key} under SAM2_TPU_KERNEL_FAST_EXP=1 raises: {e}")
                else:
                    raise RuntimeError(f"the bf16 route to {key} must refuse "
                                       "SAM2_TPU_KERNEL_FAST_EXP=1")
            check(counters[key].launches == 0,
                  f"the refused route launched {key} {counters[key].launches} times")
    return launches["default"]


def main(argv):
    if argv not in ([], ["--kernel-times"]):
        print("usage: python3 chip_smoke.py [--kernel-times]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device_name = torch.cuda.get_device_name(0)
    log(f"device: {device_name}, count {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(smi[0])

    from sam2_opt_tpu_torch.kernels import _build
    from sam2_opt_tpu_torch.kernels import flash_attention as flash_module
    from sam2_opt_tpu_torch.kernels.fused_mlp import fused_mlp
    from sam2_opt_tpu_torch.kernels.window_attention import (
        packed_window_attention,
        window_attention,
        window_attention_3d,
        window_attention_heads,
        window_flash_3d,
    )
    from sam2_opt_tpu_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
        flash_attention_kv_proj,
        flash_attention_kv_proj_ref,
        flash_attention_ref,
        flash_attention_rope,
        flash_attention_rope_ref,
    )

    t0 = time.perf_counter()
    logs = _build.build_all()
    PHASE_SECONDS["build"] = round(time.perf_counter() - t0, 1)
    log(f"build: {sorted(logs)} in {PHASE_SECONDS['build']} s")
    for lib, text in logs.items():
        regs = [line.strip() for line in text.splitlines()
                if "registers" in line or "spill" in line or "wgmma" in line]
        log(f"  {lib}: {len(regs) // 2} kernels; " + "; ".join(sorted(set(regs))))

    # K2's rotation alone (since slice 9; absent from an older checkout,
    # which --kernel-times may time)
    rope_rotate = getattr(flash_module, "rope_rotate", None)
    if argv == ["--kernel-times"]:
        # the kernel times alone (K1; K5-K8 at the window and MLP shapes; K2,
        # its rotation and K1 at D = 256 at memory attention's shapes), for
        # a comparison of two checkouts of the package in one call
        label = lambda key: " ".join(str(k).replace("torch.", "") for k in key)  # noqa: E731
        k1 = phase_k1_times(flash_attention, flash_attention_ref, tiling=False)
        rows = phase_route_kernel_times()
        memory = memory_attention_times(
            {"K2": (flash_attention_rope, flash_attention_rope_ref),
             "K1 D=256": (flash_attention, flash_attention_ref)}, rope_rotate=rope_rotate,
            plain=False)
        memory_rows = {(key, *shape): row for key, by in memory.items() for shape, row in by.items()}
        log(json.dumps({"kernel_times": {label(k): v for k, v in {**k1, **rows,
                                                                  **memory_rows}.items()},
                        "card": smi[0]}))
        return 0
    check(rope_rotate is not None, "this checkout has no rope_rotate")

    k1_err = phase_k1(flash_attention, flash_attention_ref)
    k2_err = phase_k2(flash_attention_rope, flash_attention_rope_ref, rope_rotate)
    k3_err = phase_k3()
    k3 = phase_k3_times()
    window_err = phase_windows()
    k8_err = phase_k8()
    phase_route_grads()
    predictor, image, image_launches, default_outs = phase_slice(flash_attention)
    times = phase_times(predictor, image)
    k1 = phase_k1_times(flash_attention, flash_attention_ref)
    route_counters = {"K1": flash_attention, "K5": window_attention, "K6": window_flash_3d,
                      "K7": packed_window_attention, "K8": fused_mlp}
    route_launches = phase_routes(predictor, image, default_outs, route_counters)
    route_times = phase_route_times(predictor, image)
    del predictor
    torch.cuda.empty_cache()
    route_kernels = phase_route_kernel_times()
    video_predictor, video, points, (k1_launches, k2_launches), video_route_launches = phase_video(
        flash_attention, flash_attention_rope)
    video_times, k2 = phase_video_times(video_predictor, video, points, flash_attention_rope,
                                        flash_attention_rope_ref, rope_rotate)
    del video_predictor
    torch.cuda.empty_cache()

    train_cpu = phase_train_vs_cpu()
    counters = {"K1": flash_attention, "K2": flash_attention_rope,
                "K3a": flash_attention_bwd_dkdv, "K3b": flash_attention_bwd_dq}
    train_runs, train_launches = phase_trainer(counters)
    cli_loss = phase_train_cli()

    # slice 5
    k4_err = phase_k4(flash_attention_kv_proj, flash_attention_kv_proj_ref)
    k4_grads = phase_k4_grads(flash_attention_kv_proj, flash_attention_kv_proj_ref)
    k4 = phase_k4_times(flash_attention_kv_proj, flash_attention_kv_proj_ref)
    k1_wide_err, k1_wide = phase_k1_wide(flash_attention, flash_attention_ref)
    route_video_launches, route_video_times = phase_route_video(
        {"K1": flash_attention, "K2": flash_attention_rope, "K4": flash_attention_kv_proj})
    k4_train_launches, k4_train = phase_k4_train(
        {**counters, "K4": flash_attention_kv_proj}, train_runs["float32"]["losses"][0])
    # slice 7: training under SAM2_TPU_FUSED_ROPE=0 (K3 at D = 256 behind K1)
    rope_off_k1, rope_off_train = phase_rope_off_train(
        {**counters, "K4": flash_attention_kv_proj}, train_runs["float32"]["losses"][0])
    window_tool_err, window_tool_plain = phase_k9_k10()
    tool_rows, tool_launches = phase_bench_tool(
        {"K9": window_attention_heads, "K10": window_attention_3d})

    # slice 6
    switch_launches = phase_switches(
        {"K1": flash_attention, "K2": flash_attention_rope, "K4": flash_attention_kv_proj})

    source = "sam2_opt_tpu_torch/csrc/flash_attention.cu"
    entries = [{
        "name": "flash_attention_fwd (K1)",
        "route": "cuda",
        "source": source,
        "replaces": "sam2_opt_tpu/kernels/flash_attention.py:97",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        **k1[(MAIN_SHAPE, torch.bfloat16)],
        "shape": list(MAIN_SHAPE),
        "dtype": "bfloat16",
        "fp32": k1[(MAIN_SHAPE, torch.float32)],
        "b+ global": {"shape": list(K1_SHAPES[1]),
                      "bfloat16": k1[(K1_SHAPES[1], torch.bfloat16)]},
        "image_launches": image_launches,
    }, {
        "name": "flash_attention_rope_fwd (K2)",
        "route": "cuda",
        "source": source,
        "replaces": "sam2_opt_tpu/kernels/flash_attention.py:121",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        **k2["K2"][("cross", torch.bfloat16)],
        "shape": list(K2_CROSS),
        "dtype": "bfloat16",
        "library": "rotation in torch + F.scaled_dot_product_attention",
        "fp32": k2["K2"][("cross", torch.float32)],
        "self": {"shape": list(K2_SELF), "bfloat16": k2["K2"][("self", torch.bfloat16)],
                 "fp32": k2["K2"][("self", torch.float32)]},
        "rotation": {f"{label} {str(dt).replace('torch.', '')}": row
                     for (label, dt), row in k2["rotation"].items()},
    }]
    entries[0]["training_launches"] = train_launches["K1"]
    entries[1]["training_launches"] = train_launches["K2"]
    source = "sam2_opt_tpu_torch/csrc/flash_attention_bwd.cu"
    for key, part, kernel, line in (("K3a", "dkdv", "flash_attention_bwd_dkdv (K3a)", 379),
                                    ("K3b", "dq", "flash_attention_bwd_dq (K3b)", 420)):
        main_row = k3[("cross", torch.bfloat16)][part]
        entries.append({
            "name": kernel,
            "route": "cuda",
            "source": source,
            "replaces": f"sam2_opt_tpu/kernels/flash_attention.py:{line}",
            "launches": train_launches[key],
            "max_abs_err": k3_err[part],
            **main_row,
            "shape": list(K3_CROSS),
            "dtype": "bfloat16",
            "library": "F.scaled_dot_product_attention backward (dQ, dK, dV together)",
            "fp32": k3[("cross", torch.float32)][part],
            "b+ global": {"shape": list(K3_B_SHAPE),
                          "bfloat16": k3[("b+ global", torch.bfloat16)][part],
                          "fp32": k3[("b+ global", torch.float32)][part]},
            "self": {"shape": list(K3_SELF), "bfloat16": k3[("self", torch.bfloat16)][part],
                     "fp32": k3[("self", torch.float32)][part]},
        })
    # K5-K8: one kernel behind K5, K6 and K7; each row at the shape that
    # launches most on its main path, the other shapes beside it
    source = "sam2_opt_tpu_torch/csrc/window_attention.cu"
    shape_label = lambda shape: "x".join(map(str, shape))  # noqa: E731
    for key, kernel_name, line, main_shape, dtype in (
            ("K5", "window_attention (K5)", "sam2_opt_tpu/kernels/window_attention.py:25",
             WINDOW_SHAPES[1], torch.bfloat16),
            ("K6", "window_flash_3d (K6)", "sam2_opt_tpu/kernels/window_attention.py:73",
             WINDOW_SHAPES[2], torch.bfloat16),
            ("K7", "packed_window_attention (K7)", "sam2_opt_tpu/kernels/window_attention.py:159",
             WINDOW_SHAPES[2], torch.bfloat16),
            ("K8", "fused_mlp (K8)", "sam2_opt_tpu/kernels/fused_mlp.py:40", MLP_SHAPES_L[2],
             torch.bfloat16)):
        entries.append({
            "name": kernel_name,
            "route": "cuda",
            "source": "sam2_opt_tpu_torch/csrc/fused_mlp.cu" if key == "K8" else source,
            "replaces": line,
            "launches": route_launches[key],
            "max_abs_err": k8_err if key == "K8" else window_err[key],
            **route_kernels[(key, dtype, main_shape)],
            "shape": list(main_shape),
            "dtype": "bfloat16",
            "library": ("unfused bf16 Linear -> GELU -> Linear, 3 calls" if key == "K8" else
                        "F.scaled_dot_product_attention on [N, heads, S, D]"),
            "shapes": {f"{str(dt).replace('torch.', '')} {shape_label(sh)}": row
                       for (k, dt, sh), row in route_kernels.items() if k == key},
            "video_launches": video_route_launches.get(key, 0),
        })
    # slice 5: K4 at the cross shape; K9 and K10 at the tool's first shape
    # (each shape launches them equally often), the other shapes beside it
    entries.extend([{
        "name": "flash_attention_kvproj_fwd (K4)",
        "route": "cuda",
        "source": "sam2_opt_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sam2_opt_tpu/kernels/flash_attention.py:154",
        "launches": route_video_launches["K4"]["K4"],
        "max_abs_err": k4_err,
        **k4[torch.bfloat16],
        "shape": list(K4_CROSS),
        "dtype": "bfloat16",
        "library": "2 F.linear + rotation + F.scaled_dot_product_attention",
        "fp32": k4[torch.float32],
        "training_launches": k4_train_launches,
    }, {
        "name": "flash_attention_fwd at D = 256 (K1, SAM2_TPU_FUSED_ROPE=0)",
        "route": "cuda",
        "source": "sam2_opt_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sam2_opt_tpu/kernels/flash_attention.py:97",
        "launches": route_video_launches["rope off"]["K1 D=256"],
        "training_launches": rope_off_k1,
        "max_abs_err": k1_wide_err,
        **k1_wide[("cross", torch.bfloat16)],
        "shape": list(K2_CROSS),
        "dtype": "bfloat16",
        "library": "F.scaled_dot_product_attention",
        "fp32": k1_wide[("cross", torch.float32)],
        "self": {"shape": list(K2_SELF), "bfloat16": k1_wide[("self", torch.bfloat16)],
                 "fp32": k1_wide[("self", torch.float32)]},
    }])
    for key, kernel_name, line, field in (("K9", "window_attention_heads (K9)", 55, "kern_h"),
                                   ("K10", "window_attention_3d (K10)", 83, "kern_3d")):
        shapes = {}
        for row in tool_rows:
            shape = (row["N"], row["S"], row["H"], row["D"])
            bound_ms, bound_by = window_bound_ms(row["N"], row["H"], row["S"], row["S"], row["D"],
                                                 torch.bfloat16)
            shapes["x".join(map(str, shape))] = dict(
                ms=row[f"{field}_us"] / 1e3, plain_ms=window_tool_plain[shape],
                library_ms=row["sdpa_us"] / 1e3, einsum_ms=row["einsum_us"] / 1e3,
                bound_ms=bound_ms, bound_by=bound_by,
                **({"kernel_alone_ms": row["kern_3d_kernel_us"] / 1e3} if key == "K10" else {}))
        first_shape = [tool_rows[0][k] for k in ("N", "S", "H", "D")]
        first = shapes["x".join(map(str, first_shape))]
        entries.append({
            "name": kernel_name,
            "route": "cuda",
            "source": "sam2_opt_tpu_torch/csrc/window_attention.cu",
            "replaces": f"tools/bench_window_flash.py:{line}",
            "launches": tool_launches[key],
            "max_abs_err": window_tool_err[key],
            **first,
            "shape": first_shape,
            "dtype": "bfloat16",
            "library": "F.scaled_dot_product_attention on [N, heads, S, D]",
            "shapes": shapes,
        })
    log(json.dumps({"slice": {str(dt).replace("torch.", ""): t for dt, t in times.items()},
                    "routes": route_times,
                    "video": {str(dt).replace("torch.", ""): t for dt, t in video_times.items()},
                    "video_memory_routes": route_video_times, "training_k4_route": k4_train,
                    "training_rope_off_route": rope_off_train,
                    "k4_gradient_errors": k4_grads,
                    "training": train_runs, "training_vs_cpu": train_cpu,
                    "training_cli_loss": cli_loss, "switches_default_launches": switch_launches,
                    "phase_seconds": PHASE_SECONDS, "card": smi[0]}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
