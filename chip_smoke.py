"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --kernel-times   # build, then the kernel times of
                                           # phases 7 (K1, K2), 14 (K5-K8), 15
                                           # (K4) and 27, K1 at D = 256 and
                                           # K9/K10 only

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
   against the same weights on the CPU (plain path), then bf16 (eagerly)
   held to the fp32 masks by mIoU; K1 must launch exactly 3 times per
   `set_image`, and `add_layer_norm` 96 times per bf16 one;
6. the video slice: `build_sam2_video_predictor("hiera_l", seed=0)` on a
   synthetic 8-frame 720x1280 video (a textured square moving over a
   textured background), points on frame 0, `propagate_in_video` over all
   frames in fp32 and in bf16 (eagerly): K1 exactly 3 launches per
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
   default route, bf16 masks by mIoU (its per-route timings went in slice
   15);
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
20. `speedup()` as CUDA graphs (slice 11): the hiera-L image predictor of
   phase 5 (`set_image` and the six prompts) and the 8-frame video of phase
   6 (`propagate_in_video`), once eagerly and once through graphs, in fp32
   (`set_runtime_backend("cuda", {"dtype": torch.float32})`, held to fp32
   eager within 1e-6 of the logits' scale) and in bf16 (`speedup()`, held to
   bf16 eager by per-image and per-frame mask mIoU >= 0.999, the largest
   logit difference printed); a second pass replays every graph and must
   capture none and give the same bits; K1 and K2 counted inside replays
   from a profiler trace (3 K1 per `set_image`, 3 K1 and 8 K2 per tracked
   frame); wall (median of CUDA-event timings), busy time, idle share and
   launches of `set_image` and of a tracked frame, eager and graphs, and
   each graph's pool bytes. Phases 5-19 run bf16 eagerly
   (`set_backend`: the model's private `_use_graphs` hook), as they count each
   wrapper's launches per call, which a replay does not run;
21. the serving path on graphs: the 8-frame video written as a PNG folder;
   the demo server (`DemoServer` on 127.0.0.1, port 0) over the hiera-L
   video predictor after `speedup()`: start a session, a click on frame 0,
   a streamed propagation, a mask for a second object and its removal,
   close, every decoded RLE mask equal to the same calls through
   `InferenceAPI` in-process; two sessions from two threads, one capturing
   the batched two-object step while the other replays, each equal to its
   solo run; the automatic mask generator at its defaults (32 points a
   side, batches of 64) with graphs and eagerly in bf16 (the same records,
   per-mask IoU >= 0.99); `vos_inference` over the PNG folder with a
   frame-0 mask and `sav_benchmark` on its output (finite J&F); endpoint
   latencies, the AMG's and the eval's walls.
22. int8 (slice 12): `speedup("int8")` on the hiera-L predictors of phase 20,
   calibrated on 4 JPEGs written from the image and the video: the image
   in fp32 act-quant, fp32 weight-only and bf16 act-quant through graphs
   against fp32 eager (mIoU >= 0.98, 0.98, 0.95: `tests/test_quant.py`'s
   gates); fp32 int8 graphs bitwise equal to fp32 int8 eager, a second pass
   capturing nothing; the 8-frame video in fp32 act-quant against fp32
   eager: the encoder scope at IoU >= 0.97 per frame; the tracking scope
   through graphs at >= 0.97 on the click frame and >= 0.78 on tracked
   frames (INT8_TRACKED_IOU_MIN's comment), bitwise equal to the same model
   run eagerly, a negative control below 0.78, and with the two-way
   transformer's token self-attention weight-only >= 0.97 per frame; the
   quantized layers per scope (195 and 267 on hiera-L), the int8 products
   captured into the graphs a replay runs (195 per `set_image`, 267 per
   tracked frame in the tracking scope, none captured by frames 2-7) and
   the profiler's record of them in a replay (some, and no more than
   captured), K1 3 per `set_image` and K2 8 per tracked frame in the replays, K4
   0 under `SAM2_TPU_FUSED_KV_PROJ=1` with the tracking scope and K8 0
   under `SAM2_TPU_FUSED_MLP=1` with int8 (48 without); walls, busy, idle
   and device time by kernel family of `set_image` and a tracked frame
   under bf16 graphs and int8 weight-only and act-quant in both scopes; the
   calibration's wall;
23. the predictor variants on the same model in bf16 graphs: DAM4SAM over
   the 8-frame video with `return_all_masks` (3 masks and 3 IoUs a frame),
   `add_to_drm` on frame 2 and a preflight that makes it a conditioning
   frame; the Legacy contract; `build_sam2_video_predictor(...,
   vos_optimized=True)` on graphs from the start;
24. parallel (slice 13): two rank processes share the card over gloo
   (`parallel_rank`; a rank that fails fails the phase): (a) fp32 hiera-b+
   at 1024², T = 4 (two fp32 ranks at T = 8 would not fit), a video of 2
   objects per data row, one step under dp 2 x tp 1 and dp 1 x tp 2 against
   one process on the same global batch (loss 1e-5 relative, every reduced
   gradient 1e-3 of its max |g| plus 1e-7 of the largest); (b) bf16 DP at
   full size, dp 2, T = 8, `Trainer.run` with comms_dtype None and
   "bfloat16", each rank launching per step phase 10's K1 6, K2 56, K3a 59,
   K3b 59, its ms per step and peak (contention of two ranks on one card,
   not scaling), the reduced gradients of the two at the JAX test's bf16
   tolerance; (d) `train.py --dp 2` on a PNG folder (hiera_t, 256 px, 2
   videos, 1 step), rank 0 alone writing the checkpoint, both ranks resuming
   to the trained parameters; (e) hiera-L fp32: the image predictor at dp 2
   on 2 images and at dp 1 x tp 2 (logits 1e-4 of their scale from one
   process), the video predictor at dp 2 with 2 objects over the 8-frame
   video (masks agreeing >= 0.999 per frame), K1 and K2 per rank equal to
   one process's; then, in this process, (c) NCCL at world size 1: the DP
   trainer's bf16 steps on a dp 1 mesh, its gradient all-reduce counted
   over the NCCL group (at least the parameter count a step, each bucket
   unchanged by the sum over one rank).
25. inputs (slice 14), on phase 6's video predictor: (a) the 8-frame video
   written as an mp4 with cv2, tracked from the file with
   `offload_state_to_cpu` and `async_loading_frames` and from the ndarray of
   what cv2 decoded, fp32 (masks bitwise equal) and bf16 (per-frame mask
   IoU >= 0.999), K1 3 per encoded frame and K2 8 per tracked frame on the
   mp4 runs; (b) `AsyncVideoFrameLoader` over a JPEG folder of those
   frames, every frame equal to a synchronous decode, a forward seek beyond
   the lookahead included; (c) hiera-L built from the yaml
   `config_to_yaml` writes, same weights: `config_from_yaml` equal to
   `model_config("hiera_l")`, `set_image` logits bitwise equal; (d)
   `save_params` -> `build_from_any`: weights and logits bitwise equal;
   (e) a 2-video SA-V tree (32 JPEG frames of 720x1280 a video, JSON/RLE
   manifests at 6 fps) through `SAVRawDataset` -> `VOSDataset` ->
   `data_loader` -> `Trainer.run`, 2 bf16 steps of hiera-b+ at 1024², T =
   8, the image encoder frozen: finite losses, phase 10's launches per step,
   `assert_frozen_unchanged` on the encoder; the host seconds of the mp4
   decode and of the async loader, and the walls of (a)-(e). Where cv2 or
   yaml does not import, (a) or (c) logs "not run" and the rest runs.
26. export and the last modules (slice 15), on phase 6's video predictor,
   phase 5's image and phase 25's JPEG frames: (a) `export_all` in bf16
   writes the four seams as `torch.export` programs (and `track_step` once
   more under `SAM2_TPU_FUSED_KV_PROJ=1`); a new process that builds no
   model loads and runs each on real inputs: kernel nodes and launches per
   call (K1 3 in `set_image_e2e`, K2 8 in `track_step`, K2 4 + K4 4 under
   the switch), every output within 2^-8 of its scale of the same seam run
   eagerly here and masks at IoU >= 0.999 (bitwise equality expected and
   reported); the export, save and load walls and the file sizes; (b)
   `native.available()`, the 8 frames decoded natively against Pillow
   (host seconds), a bf16 video run from the folder (K1 3 per encoded
   frame, K2 8 per tracked frame) whose frames equal the decode of the path
   that ran (Pillow where the library does not build); (c)
   `utils.profiling.trace` around a graph-replayed tracked frame names K1's
   and K2's kernels, `fps_benchmark` and `timed` on it; (d)
   `examples.image` and `examples.video` (3 frames) on a checkpoint of the
   same weights write their outputs, their masks at IoU >= 0.999 against
   the same calls in this process.
27. the trunk's fused residual add + LayerNorm (`add_layer_norm`, which
   replaces no TPU kernel) against its plain version (the eager chain) at
   hiera-L's four stage shapes and hiera-b+'s padded stage 3, both calls of
   a block: the sum bitwise, normed within one bf16 ulp, a negative control
   (eps 1) that must fail; their times from CUDA graph replays with a cold
   L2 beside the byte bound, the plain version and `F.layer_norm` (+ the
   add); phase 5 counts its 96 launches per bf16 `set_image`.
Phases run in the order 1-4, 8, 11-12, 27, 5, 7, 13-14, 6-7, 25, 26, 9-10, 15-24; each
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
K1's and K2's fp32 bounds count their products at 495/3 TFLOP/s. Since
slice 10, K4 (phase 15) is a projection kernel run once per call (K and V
projected, K rotated, into scratch) and then K1's body under K4's names:
phase 15 first holds the projection kernel alone bit for bit against its
plain version on inputs whose sums are exact, and times K4, the unfused
route, the composite yardstick and the projection kernel from CUDA graph
replays; K4's fp32 bound counts its attention at 495/3 TFLOP/s. The bf16
window kernel (K5-K7, K9, K10) holds a window's K and V in shared memory
(phases 11, 14, 18). `--kernel-times` also times K4 and K9/K10 (from CUDA
graph replays, `phase_k9_k10_times`). The build log keeps ptxas' lines on
registers, spills and wgmma serialisation.

The line before the last is a JSON object with one entry per kernel, after
the summary line and phase 22's int8 line; the last line is `{"ok": true,
"device": {...}}`.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
import types

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


# The bf16 route of phases 5-19 runs eagerly: they count each kernel
# wrapper's launches per call, and a CUDA graph replay (phase 20, the route
# `speedup()` takes since slice 11) runs no wrapper.
def set_backend(target, backend="cuda", dtype=torch.bfloat16):
    """`target` (a predictor or a SAM2Model) on `backend`; "cuda" runs
    `dtype` eagerly, through the model's private `_use_graphs` hook."""
    target.set_runtime_backend(backend, {"dtype": dtype} if backend == "cuda" else None)
    getattr(target, "model", target)._use_graphs = False


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
    every replay finds the L2 cold (and full of dirty lines, which the timed
    call writes back as it evicts them). Kernel launch counters move once,
    at capture."""
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


def track(predictor, video, n_frames, points, counts=None, normalize_coords=True, **flags):
    """init_state (with `flags`), points on frame 0 for object 1, propagate
    over `n_frames` frames. Returns (state, [video-res masks per frame]);
    with `counts` (the two wrappers), also the K1/K2 launches of each
    yielded frame."""
    state = predictor.init_state(video, **flags)
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
            set_backend(predictor)
            check(predictor.model.compute_dtype == torch.bfloat16, "the cuda backend runs bf16")
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
    from sam2_opt_tpu_torch.kernels.add_layer_norm import add_layer_norm
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

    set_backend(predictor)
    check(predictor.model.compute_dtype == torch.bfloat16, "the cuda backend runs bf16")
    add_layer_norm.launches = 0
    predictor.set_image(image)
    torch.cuda.synchronize()
    check(flash_attention.launches == 6,
          f"bf16 set_image launched K1 {flash_attention.launches - 3} times, expected 3")
    aln_launches = add_layer_norm.launches
    check(aln_launches == ALN_IMAGE_LAUNCHES,
          f"bf16 set_image launched add_layer_norm {aln_launches} times, expected "
          f"{ALN_IMAGE_LAUNCHES}")
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
    return predictor, image, launches, aln_launches, {torch.float32: fp32, torch.bfloat16: bf16}


# kernel-name patterns for the split of device time, first match wins. Every
# `__global__` kernel of `sam2_opt_tpu_torch/csrc/` matches one of the first
# seven (tests/test_torch_chip_smoke_families.py): each caller's kernels carry
# its prefix, so K2's rotation, attention and split merge count as K2's even
# though its attention body is K1's, and K1's and K4's merges as theirs.
# the kernels torch._int_mm runs on the H100, as profiled replays name them:
# CUTLASS's sm80 int8 GEMMs, `cutlass_80_tensorop_i16832gemm_s8_128x64_128x3`
# for the encoder's and memory attention's rows and `..._s8_64x64_128x6` for
# the mask decoder's zero-padded token rows. A profiler trace is no exact
# count of them: late in a whole run of this script a trace of a set_image
# has held 193-194 of its 195 products and 2365 kernel records where a
# trace of phase 22 alone held 195 and 2406, in a replay and eagerly alike,
# and a replay's trace has differed from an eager run's. So phase 22 counts
# the products captured into the graphs (`captured_products`) and holds a
# replay's trace to some of them and no more
INT8_GEMM = r"gemm_s8_|imma"
FAMILIES = [
    ("K5-K7 window_attention (csrc)", r"window_attn_"),
    ("K8 fused_mlp (csrc)", r"fused_mlp_kernel"),
    ("K3 flash_attention_bwd (csrc)", r"bwd_dkdv_|bwd_dq_|\bcombine_kernel"),
    ("K4 flash_attention_kv_proj (csrc)", r"flash_kvproj_"),
    ("K2 flash_attention_rope (csrc)", r"flash_rope_"),
    ("K1 flash_attention (csrc)", r"flash_fwd_"),
    ("relpos flash_attention (csrc)", r"flash_relpos_"),
    ("add_layer_norm (csrc)", r"add_layer_norm_kernel"),
    ("int8 GEMM (torch._int_mm)", INT8_GEMM),
    ("convolution", r"conv|fprop|dgrad|wgrad|cudnn|implicit_gemm|winograd"),
    ("matmul", r"gemm|xmma|cutlass|cublas|nvjet|sm90_|sm80_"),
    ("softmax", r"softmax"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("resize / pool", r"upsample|interpolat|pool|bilinear|nearest"),
    ("reduction", r"reduce"),
    ("scan (hole filling's cummin)", r"scan|cummin|cumsum"),
    ("elementwise / copy", r"elementwise|vectorized|copy|Memcpy|memcpy|fill|index|cat|gather"),
]


def family(name):
    """The family of FAMILIES a kernel's name falls in, else "other"."""
    return next((f for f, pattern in FAMILIES if re.search(pattern, name, re.IGNORECASE)),
                "other")


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
        f = fams.setdefault(family(ev.key), {"ms": 0.0, "launches": 0})
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
        set_backend(predictor, backend)
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
        set_backend(predictor, backend)
        times[dtype] = propagation_times(predictor, video, points, str(dtype))

    k2 = memory_attention_times({"K2": (flash_attention_rope, flash_attention_rope_ref)},
                                rope_rotate=rope_rotate, tiling=True)
    return times, k2


# --------------------------------------------------------------------------- #
# slice 14: the input side
# --------------------------------------------------------------------------- #

# mp4 vs the ndarray of what cv2 decoded, bf16 per-frame mask IoU
INPUTS_BF16_MIOU_MIN = 0.999
SAV_FRAMES = 32  # 24 fps frames a video, annotated at 6 fps: TRAIN_FRAMES (8) annotated


def write_mp4(path, video):
    """uint8 RGB [T, H, W, 3] -> an mp4 (OpenCV's mp4v) at 24 fps."""
    import cv2

    T, H, W, _ = video.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (W, H))
    for frame in video:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def write_sav_tree(root, names, T=SAV_FRAMES, H=720, W=1280, seed=SEED):
    """An SA-V-format tree: JPEGImages_24fps/<video>/<frame:05d>.jpg and
    <video>.json manifests of COCO RLEs every 4th frame ("fps": 6), two
    objects per video: textured squares (H / 3 and 2H / 9 a side) moving
    over 40 x 40 random blocks."""
    from PIL import Image

    from sam2_opt_tpu_torch.training.data import encode_coco_rle

    rng = np.random.default_rng(seed)
    for name in names:
        vdir = f"{root}/JPEGImages_24fps/{name}"
        os.makedirs(vdir)
        bg = np.kron(rng.integers(0, 256, (H // 40, W // 40, 3), dtype=np.uint8),
                     np.ones((40, 40, 1), np.uint8))
        squares = [(np.kron(rng.integers(128, 256, (8, 8, 3), dtype=np.uint8),
                            np.ones((n // 8, n // 8, 1), np.uint8)), y, x, dx)
                   for n, y, x, dx in ((H // 24 * 8, H // 6, 5 * W // 32, W // 100),
                                       (2 * H // 72 * 8, 7 * H // 12, 45 * W // 64, -W // 128))]
        masklet = []
        for t in range(T):
            frame = bg.copy()
            masks = []
            for tex, y, x, dx in squares:
                n = tex.shape[0]
                x0 = x + dx * t
                frame[y:y + n, x0:x0 + n] = tex
                m = np.zeros((H, W), bool)
                m[y:y + n, x0:x0 + n] = True
                masks.append(m)
            Image.fromarray(frame).save(f"{vdir}/{t:05d}.jpg", quality=90)
            if t % 4 == 0:
                masklet.append([encode_coco_rle(m) for m in masks])
        with open(f"{root}/{name}.json", "w") as f:
            json.dump({"masklet": masklet, "fps": 6}, f)


@phase
def phase_inputs(predictor, video, points, counters):
    """Slice 14 on the card: (a) the video predictor on an mp4 with
    offload_state_to_cpu and async_loading_frames, against the ndarray of
    what cv2 decoded, fp32 and bf16, with its launches; (b) the async frame
    loader; (c) hiera-L built from a yaml; (d) a native checkpoint round
    trip; (e) two bf16 Trainer.run steps of hiera-b+ fed by SAVRawDataset,
    the image encoder frozen."""
    import dataclasses
    import importlib.util
    import tempfile

    from PIL import Image

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.io import checkpoints as io_ckpt
    from sam2_opt_tpu_torch.build_sam import build_sam2
    from sam2_opt_tpu_torch.io.video import _read_mp4, _resize_uint8
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
    from sam2_opt_tpu_torch.training import checkpoints as train_ckpt
    from sam2_opt_tpu_torch.training.data import (
        RandomUniformSampler,
        SAVRawDataset,
        VOSDataset,
        data_loader,
    )
    from sam2_opt_tpu_torch.training.trainer import Trainer
    from sam2_opt_tpu_torch.utils.misc import AsyncVideoFrameLoader

    root = tempfile.mkdtemp(prefix="sam2_chip_smoke_inputs_")
    have = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "yaml")}
    out, walls = {"cv2": have["cv2"], "yaml": have["yaml"]}, {}
    T, H, W, _ = video.shape
    flash_attention, flash_attention_rope = counters["K1"], counters["K2"]

    # (a) the video from an mp4, both init_state flags, against the ndarray
    # of the decoded frames (mp4 is lossy: not against the source pixels)
    t0 = time.perf_counter()
    if not have["cv2"]:
        log("inputs (a) not run: cv2 absent")
        decoded = video
    else:
        mp4 = f"{root}/video.mp4"
        write_mp4(mp4, video)
        t1 = time.perf_counter()
        decoded = np.stack(_read_mp4(mp4))
        out["mp4_decode_s"] = time.perf_counter() - t1
        check(decoded.shape == video.shape, "the mp4 decodes to the video's frames")
        out["mp4_mean_abs_vs_source"] = float(np.abs(decoded.astype(np.float32) - video).mean())
        flags = dict(offload_state_to_cpu=True, async_loading_frames=True)
        runs, launches = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            set_backend(predictor, "eager" if dtype == torch.float32 else "cuda", dtype)
            _, from_array, _ = track(predictor, decoded, T, points)
            # the path of this part: counts to 0 just before, read just after
            flash_attention.launches = flash_attention_rope.launches = 0
            state, from_mp4, per_frame = track(predictor, mp4, T, points,
                                               counts=(flash_attention, flash_attention_rope),
                                               **flags)
            torch.cuda.synchronize()
            k1, k2 = flash_attention.launches, flash_attention_rope.launches
            name = str(dtype).replace("torch.", "")
            launches[name] = {"K1": k1, "K2": k2}
            check(state["offload_state_to_cpu"] and state["async_loading_frames"]
                  and (state["video_height"], state["video_width"]) == (H, W),
                  "init_state records both flags and the mp4's size")
            check(k1 == 3 * T and k2 == 8 * (T - 1)
                  and all(f == (3, 8) for f in per_frame[1:]),
                  f"{name} mp4 run: K1 3 per encoded frame and K2 8 per tracked frame, got "
                  f"K1 {k1}, K2 {k2}, per frame {per_frame}")
            check(len(from_mp4) == len(from_array) == T, "every frame yielded")
            if dtype == torch.float32:
                same = all(torch.equal(a, b) for a, b in zip(from_mp4, from_array))
                log(f"inputs (a) fp32: mp4 masks bitwise equal to the ndarray run: {same}")
                check(same, "fp32 masks from the mp4 differ from the decoded ndarray's")
                runs[name] = 1.0
            else:
                ious = [miou(a[0, 0].cpu().numpy() > 0, b[0, 0].cpu().numpy() > 0)
                        for a, b in zip(from_mp4, from_array)]
                log(f"inputs (a) bf16: mp4 vs ndarray per-frame mask IoU "
                    f"{[round(float(x), 6) for x in ious]} (limit >= {INPUTS_BF16_MIOU_MIN})")
                check(min(ious) >= INPUTS_BF16_MIOU_MIN, "bf16 masks from the mp4 drift")
                runs[name] = float(min(ious))
        out.update(mp4_launches=launches, mp4_agreement=runs)
        log(f"inputs (a): {T} frames {H}x{W}, mp4 decode {out['mp4_decode_s']:.3f} s on the "
            f"host, mean |decoded - source| {out['mp4_mean_abs_vs_source']:.2f}; launches "
            f"{launches}")
    walls["a"] = time.perf_counter() - t0

    # (b) the async loader over a JPEG directory of those frames: every
    # frame as a synchronous decode gives it, a forward seek included
    t0 = time.perf_counter()
    jpeg_dir = f"{root}/jpeg"
    os.makedirs(jpeg_dir)
    paths = [f"{jpeg_dir}/{t:05d}.jpg" for t in range(T)]
    for p, frame in zip(paths, decoded):
        Image.fromarray(frame).save(p)
    t1 = time.perf_counter()
    sync = []
    for p in paths:
        with Image.open(p) as img:
            sync.append(_resize_uint8(np.asarray(img.convert("RGB")), 1024))
    sync_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    loader = AsyncVideoFrameLoader(paths, 1024, lookahead=2)
    order = [0, 1, 6, 7, 2, 3, 4, 5]  # 6: a seek beyond the window; 2-5 behind it
    same = [bool(np.array_equal(loader[i], sync[i])) for i in order]
    async_s = time.perf_counter() - t1
    loader.thread.join(timeout=60)
    check(all(same) and len(loader) == T and not loader.thread.is_alive(),
          f"async loader frames differ from a synchronous decode: {dict(zip(order, same))}")
    out.update(sync_decode_s=sync_s, async_loader_s=async_s, jpeg_dir=jpeg_dir)
    log(f"inputs (b): AsyncVideoFrameLoader, {T} JPEG frames at 1024, order {order}: every "
        f"frame equal to a synchronous decode; host {async_s:.3f} s (synchronous "
        f"{sync_s:.3f} s)")
    walls["b"] = time.perf_counter() - t0

    # (c) hiera-L from a yaml, the same weights: config and logits; (d) the
    # native checkpoint round trip: logits
    t0 = time.perf_counter()
    set_backend(predictor, "eager")
    image = structured_image(SEED)
    weights = {k: v.detach() for k, v in predictor.model.module.state_dict().items()}

    def logits(model):
        """set_image, then a click: (logits at the image's size, IoUs,
        low-res logits)."""
        p = SAM2ImagePredictor(model)
        p.set_image(image)
        return p.predict(**PROMPTS["point"], multimask_output=True, return_logits=True)

    def bitwise(a, b):
        return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))

    want = logits(predictor.model)
    if not have["yaml"]:
        log("inputs (c) not run: yaml absent")
    else:
        from sam2_opt_tpu_torch.io.hydra_config import config_from_yaml, config_to_yaml

        yaml_path = f"{root}/sam2.1_hiera_l.yaml"
        with open(yaml_path, "w") as f:
            f.write(config_to_yaml(model_config("hiera_l")))
        check(config_from_yaml(yaml_path) == model_config("hiera_l"),
              "the yaml's config differs from model_config('hiera_l')")
        from_yaml = build_sam2(yaml_path, state_dict=weights)
        same = bitwise(logits(from_yaml), want)
        log(f"inputs (c): hiera-L from {os.path.basename(yaml_path)}, config equal to "
            f"model_config('hiera_l'), set_image logits bitwise equal: {same}")
        check(same, "the yaml-built model's logits differ")
        out["yaml_bitwise"] = same
        del from_yaml
    native = f"{root}/hiera_l.pth"
    t1 = time.perf_counter()
    io_ckpt.save_params(native, weights)
    save_s = time.perf_counter() - t1
    reloaded = io_ckpt.build_from_any("hiera_l", native)
    same_weights = all(torch.equal(v, weights[k].to(v.device))
                       for k, v in reloaded.module.state_dict().items())
    same = same_weights and bitwise(logits(reloaded), want)
    log(f"inputs (d): save_params {os.path.getsize(native) / 2 ** 30:.2f} GiB in {save_s:.2f} s, "
        f"build_from_any: weights and set_image logits bitwise equal: {same}")
    check(same, "the native checkpoint does not give back the model")
    out["checkpoint_bitwise"] = same
    del reloaded, weights
    torch.cuda.empty_cache()
    walls["c+d"] = time.perf_counter() - t0

    # (e) SA-V-fed training: two videos, JPEG frames and JSON/RLE manifests,
    # through SAVRawDataset -> VOSDataset -> data_loader -> Trainer.run
    t0 = time.perf_counter()
    sav = f"{root}/sav"
    write_sav_tree(sav, ["sav_000001", "sav_000002"])
    raw = SAVRawDataset(sav)
    check(len(raw) == 2 and len(raw.get_video(0).frames) == TRAIN_FRAMES,
          "SAVRawDataset lists the annotated frames")
    cfg = model_config("hiera_b+")
    ds = VOSDataset(raw, RandomUniformSampler(num_frames=TRAIN_FRAMES,
                                              max_num_objects=TRAIN_OBJECTS),
                    image_size=cfg.image_size, max_num_objects=TRAIN_OBJECTS, seed=SEED)
    write_s = time.perf_counter() - t0
    tcfg = dataclasses.replace(train_config("bfloat16", f"{root}/train"),
                               freeze_image_encoder=True)
    trainer = Trainer(cfg, b_plus("cuda"), tcfg)
    frozen = ["image_encoder.*"]
    before = {n: p.detach().clone()
              for n, p in train_ckpt.filter_params(trainer.model, include=frozen).items()}
    others = {n: p.detach().clone() for n, p in trainer.model.named_parameters()
              if n not in before}
    steps = len(ds)

    def loader(epoch):
        ds.set_epoch(epoch)
        return data_loader(ds, 1, seed=SEED + epoch)

    expect = launches_per_step()
    # the main path of this part: counts to 0 just before, read just after
    for c in counters.values():
        c.launches = 0
    trainer.run(loader, steps_per_epoch=steps)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    losses = trainer.step_losses
    log(f"inputs (e): SA-V tree of 2 videos x {SAV_FRAMES} frames {H}x{W} written in "
        f"{write_s:.1f} s; Trainer.run bf16 hiera-b+ 1024², T = {TRAIN_FRAMES}, image encoder "
        f"frozen: {len(losses)} steps, losses {[round(x, 4) for x in losses]}, ms per step "
        f"{[round(1e3 * x, 1) for x in trainer.step_seconds]}, launches {got}")
    check(len(losses) == steps == 2 and all(np.isfinite(losses)), "SA-V training losses")
    check(got == {k: steps * v for k, v in expect.items()},
          f"SA-V training launched {got}, expected {steps} x {expect}")
    train_ckpt.assert_frozen_unchanged(before, trainer.model, frozen)
    moved = sum(not torch.equal(p, others[n]) for n, p in trainer.model.named_parameters()
                if n in others)
    check(moved > 0, "no parameter outside the frozen encoder moved")
    log(f"inputs (e): {len(before)} image-encoder parameters unchanged "
        f"(assert_frozen_unchanged), {moved} of {len(others)} others moved")
    out.update(sav_losses=losses, sav_step_ms=[1e3 * x for x in trainer.step_seconds],
               sav_launches=got, frozen_unchanged=len(before), moved=moved)
    del trainer, before, others
    torch.cuda.empty_cache()
    walls["e"] = time.perf_counter() - t0
    out["walls_s"] = walls
    log(f"inputs walls (s): {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    return out



# --------------------------------------------------------------------------- #
# slice 15: export, the native decode, profiling and the examples
# --------------------------------------------------------------------------- #

EXPORT_IOU_MIN = 0.999       # exported vs eager masks, per seam output
EXPORT_LOGIT_RTOL = 2.0 ** -8  # of each output's scale; the same ops in one order: 0 expected
EXPORT_TIMEOUT_S = 300
# exported kernel nodes and launches per call: K1 in the trunk's 3 global
# blocks, K2 in memory attention's 4 self and 4 cross attentions (K4 takes
# the 4 cross ones under SAM2_TPU_FUSED_KV_PROJ=1)
# set_image_e2e: the trunk's add_layer_norm twice a block (ALN_IMAGE_LAUNCHES)
EXPORT_LAUNCHES = {"set_image_e2e": {"add_layer_norm": 96, "flash_attention": 3},
                   "track_step": {"flash_attention_rope": 8},
                   "track_step_k4": {"flash_attention_rope": 4, "flash_attention_kv_proj": 4},
                   "memory_encoder": {}, "predict_masks": {}}
EXAMPLE_FRAMES = 3


def export_seam_inputs(module, cfg, video, points):
    """Real inputs of the four seams at their exported shapes: frame 0 of
    the video through set_image_e2e, the click's track_step_init, whose
    memory and pointer fill slot 0 of frame 1's MemoryInput (the other
    slots masked), frame 1's features, its mask for the memory encoder and
    the click for predict_masks. Returns {seam: args}, on the card."""
    from sam2_opt_tpu_torch.export import export_program as ex
    from sam2_opt_tpu_torch.io.video import load_video_frames
    from sam2_opt_tpu_torch.models import video_core as vc

    S, dtype = cfg.image_size, next(module.parameters()).dtype
    frames, H, W = load_video_frames(video[:2], S, device="cuda")
    images = frames.to(dtype) / 255.0
    with torch.inference_mode():
        f_0 = ex.set_image_e2e(module, cfg, images[:1])
        f_1 = ex.set_image_e2e(module, cfg, images[1:2])
        coords = torch.as_tensor(points * np.array([S / W, S / H], np.float32), device="cuda")
        labels = torch.ones((1, 1), dtype=torch.int32, device="cuda")
        first = vc.track_step_init(module, cfg, f_0, coords[None], labels, None,
                                   multimask_output=True, run_mem_encoder=True)
    zeros = ex.example_inputs(cfg, dtype, "cuda")
    mem = zeros["track_step"][3]
    valid, ptr_valid = mem.valid.clone(), mem.ptr_valid.clone()
    valid[0, 0] = ptr_valid[0, 0] = True
    mem = mem._replace(feats=(first["maskmem_features"], *mem.feats[1:]), valid=valid,
                       ptrs=(first["obj_ptr"], *mem.ptrs[1:]), ptr_valid=ptr_valid,
                       tpos_idx=torch.arange(cfg.num_maskmem, device="cuda")[None],
                       ptr_pos=torch.arange(len(mem.ptrs), dtype=torch.float32,
                                            device="cuda")[None] / len(mem.ptrs))
    high = F.interpolate(first["pred_masks"].float(), (S, S), mode="bilinear")
    return {"set_image_e2e": (images[1:2],), "track_step": (*f_1, mem),
            "track_step_k4": (*f_1, mem),
            "memory_encoder": (f_1[2], high, first["object_score_logits"]),
            "predict_masks": (f_1[2], f_1[0], f_1[1], coords[None], labels)}


def exported_worker(out):
    """The fresh process of phase 26 (a): loads every program under `out`
    (`load_exported`; no model is built here), runs each once on
    `out/inputs.pt`, the kernel counters set to 0 just before each call and
    read just after; writes `out/outputs.pt` and `out/worker.json` (load
    seconds, graph nodes and launches per program)."""
    import traceback

    from sam2_opt_tpu_torch.models import sam2_base

    def refuse(*args, **kwargs):
        raise RuntimeError("the exported programs' process builds no model")

    sam2_base.SAM2Base.__init__ = refuse
    try:
        from sam2_opt_tpu_torch.export import export_program as ex
        from sam2_opt_tpu_torch.kernels import flash_attention as fa
        from sam2_opt_tpu_torch.kernels.add_layer_norm import add_layer_norm

        counters = {"add_layer_norm": add_layer_norm, "flash_attention": fa.flash_attention,
                    "flash_attention_rope": fa.flash_attention_rope,
                    "flash_attention_kv_proj": fa.flash_attention_kv_proj}
        inputs = torch.load(f"{out}/inputs.pt", map_location="cuda", weights_only=False)
        result, outputs = {}, {}
        for name, args in inputs.items():
            t0 = time.perf_counter()
            program = ex.load_exported(f"{out}/{name}.pt2")
            fn = program.module()
            load_s = time.perf_counter() - t0
            for c in counters.values():
                c.launches = 0
            with torch.inference_mode():
                got = fn(*args)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items() if c.launches}
            outputs[name] = tuple(t.cpu() for t in got)
            result[name] = dict(load_s=load_s, nodes=ex.kernel_nodes(program),
                                launches=launches)
            del program, fn
        torch.save(outputs, f"{out}/outputs.pt")
        with open(f"{out}/worker.json", "w") as f:
            json.dump(result, f)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def run_exported_worker(out):
    """exported_worker(out) in a new process; its log, its exit code checked."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.exported_worker(sys.argv[1])",
         out], cwd=here, capture_output=True, text=True, timeout=EXPORT_TIMEOUT_S)
    for line in (proc.stdout + proc.stderr).splitlines():
        log(f"  [exported] {line}")
    check(proc.returncode == 0, f"the exported programs' process exited {proc.returncode}")
    with open(f"{out}/worker.json") as f:
        result = json.load(f)
    return result, torch.load(f"{out}/outputs.pt", weights_only=False), time.perf_counter() - t0


def same_outputs(got, want, what):
    """Largest |got - want| over each output's scale, masks (logit outputs
    with a spatial extent) by IoU of their positive parts; checked against
    EXPORT_LOGIT_RTOL and EXPORT_IOU_MIN."""
    worst, ious = 0.0, []
    for a, b in zip(got, want):
        a, b = a.float().cpu(), b.float().cpu()
        check(a.shape == b.shape, f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
        scale = max(1.0, float(b.abs().max()))
        worst = max(worst, float((a - b).abs().max()) / scale)
        if a.dim() == 4 and a.shape[1] <= 3:
            ious.append(float(miou(a.numpy() > 0, b.numpy() > 0)))
    check(worst <= EXPORT_LOGIT_RTOL and all(x >= EXPORT_IOU_MIN for x in ious),
          f"{what}: exported vs eager max|d|/scale {worst:.3e}, mask IoUs {ious}")
    return worst, ious


@phase
def phase_export(predictor, image, video, points, jpeg_dir, counters):
    """Slice 15 on the card, on phase 6's video predictor (bias raised),
    phase 5's image, phase 6's video and phase 25's JPEG frames: (a) the
    four seams exported in bf16 by `export_all` (and track_step again
    under SAM2_TPU_FUSED_KV_PROJ=1), loaded and run in a new process that
    builds no model, held against the same seams run eagerly here, with
    their kernel nodes and launches; (b) the native JPEG decode and a video
    run from the folder; (c) `utils.profiling` around a graph-replayed
    tracked frame; (d) `examples.image` and `examples.video` against the
    same calls in this process."""
    import tempfile

    from PIL import Image

    from sam2_opt_tpu_torch.examples import image as ex_image
    from sam2_opt_tpu_torch.examples import video as ex_video
    from sam2_opt_tpu_torch.export import export_program as ex
    from sam2_opt_tpu_torch.io import native
    from sam2_opt_tpu_torch.io.video import _frame_paths, _read_frame, _resize_uint8
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
    from sam2_opt_tpu_torch.utils import profiling

    root = tempfile.mkdtemp(prefix="sam2_chip_smoke_export_")
    out, walls = {}, {}
    model, cfg = predictor.model, predictor.model.cfg
    flash_attention, flash_attention_rope = counters["K1"], counters["K2"]

    # (a) export_all in bf16 (the JAX default), save timed apart; track_step
    # once more under K4's switch
    t0 = time.perf_counter()
    save_s, real_save = {}, torch.export.save

    def timed_save(program, path, *args, **kwargs):
        t1 = time.perf_counter()
        real_save(program, path, *args, **kwargs)
        save_s[os.path.basename(path)] = time.perf_counter() - t1

    torch.export.save = timed_save
    try:
        paths = ex.export_all(model, root, dtype=torch.bfloat16)
    finally:
        torch.export.save = real_save
    export_s = time.perf_counter() - t0 - sum(save_s.values())
    check(sorted(paths) == sorted(ex.SEAMS), f"export_all wrote {sorted(paths)}")
    module = ex.compute_module(model, torch.bfloat16)
    inputs = export_seam_inputs(module, cfg, video, points)
    t1 = time.perf_counter()
    with switches(K4_SWITCH):
        real_save(ex.export_seam(module, cfg, "track_step", inputs["track_step_k4"]),
                  f"{root}/track_step_k4.pt2")
    k4_export_s = time.perf_counter() - t1
    sizes = {name: os.path.getsize(f"{root}/{name}.pt2") for name in inputs}
    log(f"export (a): export_all bf16 {export_s:.1f} s tracing, save {json.dumps(save_s)} s; "
        f"track_step under SAM2_TPU_FUSED_KV_PROJ=1 {k4_export_s:.1f} s; sizes (MB) "
        f"{json.dumps({k: round(v / 1e6, 1) for k, v in sizes.items()})}")
    eager = {}
    with torch.inference_mode():
        for name, args in inputs.items():
            fn = getattr(ex, name.replace("_k4", ""))
            with switches(K4_SWITCH if name.endswith("_k4") else {}):
                eager[name] = tuple(t.cpu() for t in ex.Seam(module, cfg, fn)(*args))
    torch.save({k: v for k, v in inputs.items()}, f"{root}/inputs.pt")
    del module
    torch.cuda.empty_cache()
    worker, exported, worker_s = run_exported_worker(root)
    agree = {}
    for name, want in EXPORT_LAUNCHES.items():
        got = worker[name]
        log(f"  {name}: load {got['load_s']:.2f} s, kernel nodes {got['nodes']}, launches "
            f"{got['launches']}")
        check(got["nodes"] == want and got["launches"] == want,
              f"{name}: kernel nodes {got['nodes']} and launches {got['launches']}, want {want}")
        worst, ious = same_outputs(exported[name], eager[name], name)
        bitwise = all(torch.equal(a, b) for a, b in zip(exported[name], eager[name]))
        agree[name] = dict(max_rel=worst, ious=ious, bitwise=bitwise)
        log(f"  {name}: exported vs eager max|d|/scale {worst:.3e}, mask IoUs {ious}, bitwise "
            f"{bitwise}")
    out.update(export_s=export_s, save_s=save_s, k4_export_s=k4_export_s, sizes=sizes,
               worker=worker, worker_s=worker_s, agreement=agree)
    walls["a"] = time.perf_counter() - t0

    # (b) the native decode of phase 25's JPEG frames, against Pillow, and a
    # video run from the folder
    t0 = time.perf_counter()
    paths_jpg = _frame_paths(jpeg_dir)
    t1 = time.perf_counter()
    pillow = np.stack([_resize_uint8(_read_frame(p), cfg.image_size) for p in paths_jpg])
    pillow_s = time.perf_counter() - t1
    out["native_available"] = native.available()
    if out["native_available"]:
        t1 = time.perf_counter()
        decoded = native.decode_jpeg_batch(paths_jpg, cfg.image_size)
        out["native_decode_s"] = time.perf_counter() - t1
        check(decoded is not None, "the native decode failed")
        out["native_vs_pillow_mean_abs"] = float(np.abs(decoded.astype(np.float32)
                                                        - pillow).mean())
        path = "native"
    else:
        decoded, path = pillow, "pillow"
        log(f"decode (b): native library unavailable: {native.build_error()}")
    out.update(decode_path=path, pillow_decode_s=pillow_s)
    set_backend(predictor, "cuda", torch.bfloat16)
    T = len(paths_jpg)
    flash_attention.launches = flash_attention_rope.launches = 0
    state, masks, per_frame = track(predictor, jpeg_dir, T, points,
                                    counts=(flash_attention, flash_attention_rope))
    torch.cuda.synchronize()
    k1, k2 = flash_attention.launches, flash_attention_rope.launches
    check(np.array_equal(state["images"].permute(0, 2, 3, 1).cpu().numpy(), decoded),
          f"the loaded frames are not the {path} decode")
    check(k1 == 3 * T and k2 == 8 * (T - 1) and all(f == (3, 8) for f in per_frame[1:]),
          f"video from the JPEG folder: K1 {k1}, K2 {k2}, per frame {per_frame}")
    out["jpeg_launches"] = {"K1": k1, "K2": k2}
    log(f"decode (b): {T} JPEG frames at {cfg.image_size} on the {path} path: "
        + (f"native {out['native_decode_s']:.3f} s, " if path == "native" else "")
        + f"Pillow + _resize_uint8 {pillow_s:.3f} s (host); the video run from the folder: "
        f"K1 {k1}, K2 {k2}")
    walls["b"] = time.perf_counter() - t0

    # (c) utils.profiling on a graph-replayed tracked frame
    t0 = time.perf_counter()
    predictor.speedup()
    state = predictor.init_state(video)
    predictor.add_new_points_or_box(state, 0, 1, points=points, labels=np.array([1], np.int32))
    list(predictor.propagate_in_video(state))  # captures every graph

    def frame():
        """Frame 1 tracked again and encoded afresh: the predictor keeps the
        last frame's features, which would skip the encoder (K1)."""
        state["cached_features"].clear()
        return list(predictor.propagate_in_video(state, 1, 0))

    frame()
    log_dir = f"{root}/trace"
    with profiling.trace(log_dir):
        frame()
    with open(f"{log_dir}/trace.json") as f:
        names = {ev.get("name", "") for ev in json.load(f).get("traceEvents", [])
                 if ev.get("cat") == "kernel"}
    traced = {k: sorted(n for n in names if re.search(pat, n)) for k, pat in GRAPH_KERNELS.items()}
    check(all(traced.values()), f"the trace names no K1 or K2 kernel: {traced}")
    fps = profiling.fps_benchmark(frame, warmup=2, iters=10)
    timed_frame = profiling.timed("tracked frame")(frame)
    for _ in range(3):
        timed_frame()
    out.update(trace_kernels=traced, fps=fps, timed_ms=[1e3 * x for x in timed_frame.timings])
    log(f"profiling (c): trace.json names {traced}; fps_benchmark {fps:.2f} tracked frames/s; "
        f"timed {[round(1e3 * x, 3) for x in timed_frame.timings]} ms")
    walls["c"] = time.perf_counter() - t0

    # (d) the examples on the same weights (the object-score bias raised),
    # against the same calls here, both through speedup()'s graphs
    t0 = time.perf_counter()
    ckpt = f"{root}/hiera_l.pt"
    torch.save({"model": model.module.state_dict()}, ckpt)
    image_path = f"{root}/image.png"
    Image.fromarray(image).save(image_path)
    got_masks, got_ious = ex_image.main(image_path, ckpt, "hiera_l", f"{root}/image_demo",
                                        device="cuda")
    here = SAM2ImagePredictor(model)
    here.set_image(image)
    masks_here, ious_here, _ = here.predict(point_coords=ex_image.POINTS,
                                            point_labels=np.array([1, 1], np.int32))
    image_ious = [float(miou(a, b)) for a, b in zip(got_masks, masks_here)]
    check(min(image_ious) >= EXPORT_IOU_MIN and os.listdir(f"{root}/image_demo"),
          f"examples.image: mask IoUs {image_ious} against this process")
    results = ex_video.main(jpeg_dir, ckpt, "hiera_l", f"{root}/video_demo.mp4",
                            max_frames=EXAMPLE_FRAMES, device="cuda")
    state = predictor.init_state(ex_video.first_frames(jpeg_dir, EXAMPLE_FRAMES))
    predictor.add_new_points_or_box(state, 0, 1, points=ex_video.POINT,
                                    labels=np.array([1], np.int32))
    here_video = [m.float().cpu().numpy() for _, _, m in predictor.propagate_in_video(state)]
    video_ious = [float(miou(a > 0, b > 0)) for (_, a), b in zip(results, here_video)]
    check(len(results) == EXAMPLE_FRAMES and min(video_ious) >= EXPORT_IOU_MIN
          and os.path.getsize(f"{root}/video_demo.mp4") > 0,
          f"examples.video: {len(results)} frames, mask IoUs {video_ious} against this process")
    out.update(example_image_ious=image_ious, example_video_ious=video_ious,
               example_image_bitwise=bool(np.array_equal(got_masks, masks_here)))
    log(f"examples (d): image mask IoUs {image_ious}, video per-frame IoUs {video_ious} against "
        "this process")
    set_backend(predictor, "cuda", torch.bfloat16)
    walls["d"] = time.perf_counter() - t0
    out["walls_s"] = walls
    log(f"export walls (s): {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    return out


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
        images, masks, obj_valid, rows = trainer._place_batch(batch, TRAIN_OBJECTS)

        def one_step():
            trainer.opt_state, metrics = step_fn(trainer.model, trainer.opt_state, images, masks,
                                                 obj_valid, trainer.row_generators(rows), 1e-6)
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
        backend = "cuda" if dtype == torch.bfloat16 else "eager"
        set_backend(predictor, backend)
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
        set_backend(predictor, backend)
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
    set_backend(predictor)
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
# the trunk's fused residual add + LayerNorm (replaces no TPU kernel)
# --------------------------------------------------------------------------- #

# (batch, tokens a side, C, window, calls) of hiera-L's four stages at
# 1024², a global block (raster on both sides), the entry of the first block
# of stage 2 (q-pool: normed in raster order, for the projection),
# hiera-b+'s stage 3, whose windows of 14 pad 64 to 70, and two images at
# once (`set_image_batch`), padded and raster
ALN_CALLS = ("entry", "after attention")
ALN_SHAPES = {
    "L stage 1": (1, 256, 144, 8, ALN_CALLS), "L stage 2": (1, 128, 288, 4, ALN_CALLS),
    "L stage 3": (1, 64, 576, 16, ALN_CALLS), "L stage 4": (1, 32, 1152, 8, ALN_CALLS),
    "L global": (1, 64, 576, 0, ALN_CALLS), "L q-pool entry": (1, 256, 144, 0, ("entry",)),
    "B+ stage 3": (1, 64, 448, 14, ALN_CALLS),
    "B+ stage 3 x2": (2, 64, 448, 14, ALN_CALLS), "L global x2": (2, 64, 576, 0, ALN_CALLS),
}
ALN_EPS = 1e-6
ALN_IMAGE_LAUNCHES = 96  # per bf16 hiera-L set_image: two per block


def aln_inputs(B, side, C, ws, gen):
    """bf16 residual [B, side, side, C], the attention's output in window
    order (raster for ws 0), weight and bias, at a trained trunk's spread."""
    from sam2_opt_tpu_torch.ops import common as ops

    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    residual = 2.0 * randn(B, side, side, C) + randn(B, side, side, 1)
    delta = randn(B, side, side, C)
    if ws:
        delta = ops.window_partition(delta, ws)[0]
    return [a.to(torch.bfloat16) for a in (residual, delta, 1.0 + 0.3 * randn(C), 0.2 * randn(C))]


def aln_bound_ms(B, side, C, ws, entry):
    """Bytes over the memory rate: the block's entry reads x and writes
    normed in window order (padded rows included); after the attention the
    kernel reads residual and delta (the padded rows of delta are never
    read) and writes sum and normed; weight and bias once."""
    from sam2_opt_tpu_torch.kernels.add_layer_norm import window_grid

    _, Hp, Wp = window_grid(ws, side, side) or (0, side, side)
    rows = B * side * side
    moved = (rows + B * Hp * Wp) if entry else 4 * rows
    return 1e3 * (2 * C * moved + 4 * C) / PEAK_BYTES


@phase
def phase_add_layer_norm():
    """The fused residual add + LayerNorm against its plain version (the
    eager chain) on the card at `ALN_SHAPES`, both calls of a block (entry:
    no delta, normed in window order, raster for a global block or a q-pool
    entry; after the attention: delta gathered from window order, raster
    out), then their times from CUDA graph replays with a cold L2, beside
    the byte bound, the plain version and the library yardstick
    (`F.layer_norm`, after the add for the second call: no window order).
    The sum must be bitwise equal; normed within one bf16 ulp of x * scale,
    shift and itself (the fp32 sums' order); a negative control (eps 1 in
    the plain version) must fail."""
    from sam2_opt_tpu_torch.kernels.add_layer_norm import (
        add_layer_norm,
        add_layer_norm_ref,
        window_grid,
    )
    from sam2_opt_tpu_torch.ops import common as ops

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    rows, max_err = {}, 0.0
    for label, (B, side, C, ws, names) in ALN_SHAPES.items():
        residual, delta, weight, bias = aln_inputs(B, side, C, ws, gen)
        win = window_grid(ws, side, side)
        calls = {"entry": (None, (), win), "after attention": (delta, win, ())}
        row = {}
        for name in names:
            d, d_win, o_win = calls[name]
            run = lambda: add_layer_norm(  # noqa: E731
                residual, d, weight, bias, ALN_EPS, d_win, o_win)  # noqa: B023
            total, normed = run()
            torch.cuda.synchronize()
            want_sum, want = add_layer_norm_ref(residual, d, weight, bias, ALN_EPS, d_win, o_win)
            check(torch.equal(total, want_sum), f"add_layer_norm {label} {name}: sum differs")
            x = want_sum.float()
            mean = x.mean(-1, keepdim=True)
            rstd = torch.rsqrt((x * x).mean(-1, keepdim=True) - mean * mean + ALN_EPS)
            size = (x * rstd * weight.float()).abs() + (bias.float() - mean * rstd
                                                       * weight.float()).abs()
            if o_win:
                size = ops.window_partition(size, ws)[0]
            bound = 2.0 ** -7 * (size + want.float().abs())
            err = (normed.float() - want.float()).abs()
            check(bool((err <= bound).all()), f"add_layer_norm {label} {name}: max error "
                  f"{err.max().item():.3e} outside one ulp")
            max_err = max(max_err, err.max().item())
            same = float((err == 0).float().mean())
            bad = add_layer_norm_ref(residual, d, weight, bias, 1.0, d_win, o_win)[1]
            outside = float(((normed.float() - bad.float()).abs() > bound).float().mean())
            check(outside > 0, f"add_layer_norm {label} {name}: the check cannot see eps")
            ms = graph_ms(run, flush=flush)
            plain_ms = graph_ms(lambda: add_layer_norm_ref(  # noqa: B023
                residual, d, weight, bias, ALN_EPS, d_win, o_win), reps=5, flush=flush)
            if d is None:
                library = lambda: F.layer_norm(residual, (C,), weight, bias, ALN_EPS)  # noqa: E731
            else:
                flat = ops.window_unpartition(delta, ws, win[1:], (side, side)) if ws else delta
                library = lambda: F.layer_norm(residual + flat, (C,), weight, bias,  # noqa: E731
                                               ALN_EPS)  # noqa: B023
            library_ms = graph_ms(library, flush=flush)
            bound_ms = aln_bound_ms(B, side, C, ws, d is None)
            row[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                             bitwise_share=same)
            log(f"add_layer_norm {label} ({B}x{side}x{side}x{C}, ws {ws}) {name}: {ms:.4f} ms "
                f"({bound_ms / ms:.1%} of its byte bound {bound_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, "
                f"F.layer_norm{' + add' if d is not None else ''} {library_ms:.4f} ms; "
                f"max|normed-ref| {err.max().item():.3e}, {same:.4%} bitwise, control "
                f"{outside:.1%} outside")
        rows[label] = dict(**{k: sum(r[k] for r in row.values())
                              for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                           calls=row, shape=[B, side, side, C], window=ws)
    return rows, max_err


# --------------------------------------------------------------------------- #
# SAM ViT-H: the relative-position attention and the model behind speedup()
# --------------------------------------------------------------------------- #

# (B, heads, S, D, Kh, Kw): ViT-H's global blocks and its 25 padded windows
RELPOS_SHAPES = {"global": (1, 16, 4096, 80, 64, 64), "windowed": (25, 16, 196, 80, 14, 14)}
RELPOS_IMAGE_LAUNCHES = 32  # per ViT-H set_image: one a block
VIT_ALN_LAUNCHES = 64       # two a block


def relpos_bound_ms(B, H, S, D, Kh, Kw):
    """`portbench/harness/flops_vit.py::relpos_bound_s` in ms: the logits
    and p . v at the bf16 peak against q, k, v, out and q's products with
    the tables moved once."""
    flops = 4.0 * B * H * S * S * D
    nbytes = 2.0 * B * H * (D * 4 * S + S * (2 * Kh + 2 * Kw - 2))
    return 1e3 * max(flops / PEAK_FLOPS[torch.bfloat16], nbytes / PEAK_BYTES)


def relpos_inputs(shape, gen):
    """q, k, v as views of one qkv projection (the ViT's layout) and tables
    whose bias terms have a trained model's spread, bf16."""
    B, H, S, D, Kh, Kw = shape
    qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=gen).to(torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    rel_pos_h, rel_pos_w = ((0.1 * torch.randn(2 * n - 1, D, device="cuda", generator=gen))
                            .to(torch.bfloat16) for n in (Kh, Kw))
    return q, k, v, rel_pos_h, rel_pos_w


@phase
def phase_relpos():
    """The relative-position attention against its plain version at ViT-H's
    global and windowed shapes (mean |error| under 1e-3; the other axis's
    tables and K1 without the bias as negative controls), then times from
    CUDA graph replays with a cold L2: the kernel (with q's products with
    the tables, its one cuBLAS call before it), the products alone, K1 on the
    same q, k, v without the bias, SDPA fed the materialized bf16 bias (its
    making not timed, and timed with it), and the plain version."""
    from sam2_opt_tpu_torch.kernels import flash_attention as fa

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows = {}
    for label, shape in RELPOS_SHAPES.items():
        B, H, S, D, Kh, Kw = shape
        q, k, v, th, tw = relpos_inputs(shape, gen)
        out = fa.flash_attention_relpos(q, k, v, th, tw)
        want = fa.flash_attention_relpos_ref(q, k, v, th, tw).float()
        err = (out.float() - want).abs()
        check(err.mean().item() < 1e-3 and err.max().item() < 2e-2,
              f"relpos {label}: |error| mean {err.mean().item():.3e} max {err.max().item():.3e}")
        swapped = (fa.flash_attention_relpos(q, k, v, tw, th).float() - want).abs()
        no_bias = (fa.flash_attention(q, k, v)[0].float() - want).abs()
        check(swapped.mean().item() > 10 * err.mean().item()
              and no_bias.mean().item() > 10 * err.mean().item(),
              f"relpos {label}: the check cannot see swapped or dropped tables")

        def materialized():
            rel_h, rel_w = fa.relpos_terms_from_products(fa.relpos_products(q, th, tw), Kh, Kw)
            return (rel_h[..., :, None] + rel_w[..., None, :]).flatten(-2)

        bias = materialized()
        row = dict(
            ms=graph_ms(lambda: fa.flash_attention_relpos(q, k, v, th, tw), flush=flush),
            products_ms=graph_ms(lambda: fa.relpos_products(q, th, tw), flush=flush),
            k1_ms=graph_ms(lambda: fa.flash_attention(q, k, v), flush=flush),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias), flush=flush),
            library_with_bias_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=materialized()), flush=flush),
            plain_ms=graph_ms(lambda: fa.flash_attention_relpos_ref(q, k, v, th, tw),
                              reps=3, flush=flush),
            bound_ms=relpos_bound_ms(*shape), max_abs_err=err.max().item(),
            mean_abs_err=err.mean().item(), shape=list(shape))
        rows[label] = row
        log(f"relpos {label} {shape}: {row['ms']:.4f} ms ({row['bound_ms'] / row['ms']:.1%} of "
            f"its bound {row['bound_ms']:.4f}), the products alone {row['products_ms']:.4f}, K1 "
            f"without bias {row['k1_ms']:.4f}, SDPA + materialized bias "
            f"{row['library_ms']:.4f} ({row['library_with_bias_ms']:.4f} with its making), "
            f"plain {row['plain_ms']:.4f}; |error| max {err.max().item():.3e} mean "
            f"{err.mean().item():.3e}, controls swapped {swapped.mean().item():.3e}, no bias "
            f"{no_bias.mean().item():.3e}")
    return rows


@phase
def phase_sam_vit():
    """SAM ViT-H at its published sizes (`build_sam2("vit_h")`): an eager
    bf16 `set_image` counts 32 relative-position attention launches and 64
    `add_layer_norm`; then `speedup()` runs `set_image` and the three
    prompts of the benchmark's requests as graph replays, whose outputs must
    equal the eager calls' bit for bit. The bias tables drawn at the
    benchmark's spread (upstream's zeros would hide the bias)."""
    from sam2_opt_tpu_torch import SAM2ImagePredictor, build_sam2
    from sam2_opt_tpu_torch.kernels.add_layer_norm import add_layer_norm
    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention_relpos

    model = build_sam2("vit_h", seed=SEED)
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
        for name, p in model.module.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.copy_(0.6 * torch.randn(p.shape, device="cuda", generator=gen))
            elif "output_hypernetworks_mlps" in name and name.endswith("layers.2.weight"):
                p.mul_(100.0)
    predictor = SAM2ImagePredictor(model)
    image = structured_image(SEED)
    h, w = image.shape[:2]
    box = np.array([w * 0.3, h * 0.3, w * 0.6, h * 0.7], np.float32)
    prompts = [dict(point_coords=np.array([[w * 0.45, h * 0.5]], np.float32),
                    point_labels=np.array([1]), multimask_output=True),
               dict(box=box, multimask_output=False),
               dict(point_coords=np.array([[w * 0.4, h * 0.45]], np.float32),
                    point_labels=np.array([1]), box=box, multimask_output=False)]

    def request():
        predictor.set_image(image)
        outs, low = [predictor.get_image_embedding().clone()], None
        for kw in prompts:
            if "box" in kw and "point_coords" in kw:
                kw = dict(kw, mask_input=low)
            masks, ious, low = predictor.predict(**kw)
            outs += [torch.from_numpy(np.ascontiguousarray(x)) for x in (masks, ious, low)]
        return outs

    set_backend(predictor)
    request()
    before = (flash_attention_relpos.launches, add_layer_norm.launches)
    predictor.set_image(image)
    torch.cuda.synchronize()
    launches = (flash_attention_relpos.launches - before[0], add_layer_norm.launches - before[1])
    check(launches == (RELPOS_IMAGE_LAUNCHES, VIT_ALN_LAUNCHES),
          f"ViT-H eager set_image: (relpos, add_layer_norm) launches {launches}")
    eager = request()
    predictor.speedup()
    graphs = model.graphs
    request()
    before = graphs.counters()["seams"]
    replayed = request()
    after = graphs.counters()["seams"]
    replays = {k: after[k]["replays"] - before.get(k, {}).get("replays", 0) for k in after}
    check(replays == {"encode_image_e2e": 1, "predict_masks": 3},
          f"ViT-H under speedup(): replays {replays}")
    same = all(torch.equal(a, b) for a, b in zip(eager, replayed))
    check(same, "ViT-H: graph replays differ from the eager calls")
    ms = {}
    for name, fn in (("set_image", lambda: predictor.set_image(image)), ("request", request)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0) / 5
    log(f"ViT-H: eager set_image launches relpos {launches[0]}, add_layer_norm {launches[1]}; "
        f"graphs {replays}, bitwise equal to eager; wall ms {ms}; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return dict(launches=dict(relpos=launches[0], add_layer_norm=launches[1]), replays=replays,
                bitwise=same, wall_ms=ms)


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
    4*Sq*valid*D operations and each valid key's projections (2*2*Dm*D) at
    `attention_flops_rate` (since slice 10 both run on the tensor cores, in
    fp32 as three TF32 products per product), and its rotation (3 per K
    element) on the CUDA cores' fp32 rate, as `k2_bound_ms` counts it; q,
    the memory tokens, weights, biases, tables and mask read once, out and
    lse written once."""
    valid = B * Skv if valid_keys is None else valid_keys
    t_ops = ((4.0 * Sq * valid * D + 4.0 * valid * Dm * D) / attention_flops_rate(dtype)
             + 3.0 * valid * D / PEAK_FLOPS[torch.float32])
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = (itemsize * (2 * B * Sq * D + 2 * B * Skv * Dm + 2 * D * Dm + Skv * D)
              + 4 * 2 * D + B * Skv + 4 * B * Sq)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k4_project_bound_ms(B, Skv, D, Dm, dtype):
    """Least time for K4's first kernel: the memory tokens, weights, biases
    and tables read once, kr and vp written once; a key's 2*2*Dm*D product
    operations at `attention_flops_rate` and 3*D rotation operations on the
    CUDA cores' fp32 rate, as `k4_bound_ms` counts them (it is bound by
    bytes)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * (2 * B * Skv * Dm + 2 * D * Dm + Skv * D + 2 * B * Skv * D) + 4 * 2 * D
    t_ops = B * Skv * (4.0 * Dm * D / attention_flops_rate(dtype)
                       + 3.0 * D / PEAK_FLOPS[torch.float32])
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def k4_executed_gflop(B, Sq, Skv, D, Dm):
    """What K4 executes: the attention plus the projection of every key once
    per call (since slice 10; before, once per 128-row query tile)."""
    return (4.0 * B * Sq * Skv * D + 4.0 * B * Skv * Dm * D) / 1e9


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


def k4_project_exact_case(B, Skv, Dm, dtype, gen):
    """Inputs on which K4's first kernel must equal its plain version bit
    for bit: the memory in multiples of 2^-3, the weights of 2^-4 and the
    biases of 2^-6, all small, so every product and partial sum is exact in
    fp32 and the sums agree in any order; the real tables. The memory is
    given as strided views of one [B, Skv, 2, Dm] tensor."""
    from sam2_opt_tpu_torch.models.memory_attention import _rope_half_tables

    grid = lambda shape, step: (torch.randint(-4, 5, shape, device="cuda", generator=gen)  # noqa: E731
                                .float() * step).to(dtype)
    mem = grid((B, Skv, 2, Dm), 2.0 ** -3)
    c, s = _rope_half_tables(K2_D, 64, 64, 10000.0, K2_SLOTS, 4 * K2_PTRS, torch.device("cuda"),
                             dtype)
    return (mem[:, :, 0], grid((K2_D, Dm), 2.0 ** -4), grid((K2_D,), 2.0 ** -6).float(),
            mem[:, :, 1], grid((K2_D, Dm), 2.0 ** -4), grid((K2_D,), 2.0 ** -6).float(),
            c[:Skv].contiguous(), s[:Skv].contiguous())


@phase
def phase_k4(kv_proj, kv_proj_ref, kv_proj_rotate, kv_proj_rotate_ref):
    """K4 against its plain version on the card; returns the largest error.
    The negative control holds the kernel to the plain version without bk:
    the check must fail. First K4's projection kernel alone, bit for bit
    against its plain version on exact inputs (`k4_project_exact_case`), at
    the cross shape and a ragged one."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for dtype in (torch.bfloat16, torch.float32):
        for B, Skv in ((1, K4_CROSS[2]), (2, 129)):
            args = k4_project_exact_case(B, Skv, K4_DM, dtype, gen)
            got, want = kv_proj_rotate(*args), kv_proj_rotate_ref(*args)
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(got, want)]
            log(f"K4 projection kernel {dtype} B={B} Skv={Skv} Dm={K4_DM}: kr, vp bit for bit "
                f"equal to the plain version: {same}")
            check(all(same), "K4's projection kernel differs from its plain version")
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
def phase_k4_times(kv_proj, kv_proj_ref, kv_proj_rotate=None):
    """K4 at the cross shape, every key valid (the steady state), cold L2,
    beside its bound, its plain version, the unfused route it replaces (two
    F.linear + K2) and the composite yardstick (two F.linear + rotation +
    F.scaled_dot_product_attention, which the port never calls); device
    times from CUDA graph replays (`graph_ms`, since slice 10). With
    `kv_proj_rotate` (since slice 10; absent from an older checkout), its
    projection kernel alone beside that kernel's bound."""
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

        ms = graph_ms(lambda: kv_proj(q, mk, mv, wk, bk, wv, bv, c, s, mask), flush=flush)
        plain_ms = graph_ms(lambda: kv_proj_ref(q, mk, mv, wk, bk, wv, bv, c, s, mask), reps=3,
                            flush=flush)
        unfused_ms = graph_ms(unfused, flush=flush)
        library_ms = graph_ms(library, flush=flush)
        bound_ms, bound_by = k4_bound_ms(B, Sq, Skv, D, Dm, dtype)
        executed = k4_executed_gflop(B, Sq, Skv, D, Dm)
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        project = ""
        if kv_proj_rotate is not None:
            p_ms = graph_ms(lambda: kv_proj_rotate(mk, wk, bk, mv, wv, bv, c, s), flush=flush)
            p_bound, p_by = k4_project_bound_ms(B, Skv, D, Dm, dtype)
            rows[dtype]["projection"] = dict(ms=p_ms, bound_ms=p_bound, bound_by=p_by)
            project = (f"; its projection kernel alone {p_ms:.4f} ms, bound {p_bound:.4f} ms "
                       f"({p_by}), {p_bound / p_ms:.1%} of bound")
        log(f"K4 {dtype} {K4_CROSS}: {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused route "
            f"(2 F.linear + K2) {unfused_ms:.4f} ms, 2 F.linear + rotation + "
            f"F.scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of bound; executes {executed:.1f} GFLOP "
            f"({executed / ms:.1f} TFLOP/s){project}")
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
    1e-3 of their scale of the default route's, bf16 masks by mIoU. (Its
    per-route timings over the 8 frames went in slice 15, to make room for
    phase 26.) Returns {route: {kernel: launches of the checked runs}};
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
    for dtype, backend in ((torch.float32, "eager"), (torch.bfloat16, "cuda")):
        set_backend(predictor, backend)
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
    del predictor
    torch.cuda.empty_cache()
    return launches


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
def phase_k9_k10_times():
    """K9 and K10 at the bench tool's four shapes (bf16), cold L2, from CUDA
    graph replays: K9, K10's whole wrapper (copies in and out) and its
    kernel alone, beside F.scaled_dot_product_attention on [N, heads, S, d]
    views and the bound. For `--kernel-times` (phase 18 takes its times
    from the bench tool's own rows)."""
    from sam2_opt_tpu_torch.kernels.window_attention import (
        launch_3d,
        window_attention_3d,
        window_attention_heads,
    )
    from sam2_opt_tpu_torch.tools.bench_window_flash import SHAPES

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    rows = {}
    for label, N, S, H, D in SHAPES:
        q, k, v = (torch.randn(N, S, H, D, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        flat = [x.transpose(1, 2).reshape(N * H, S, D) for x in (q, k, v)]
        out = torch.empty_like(flat[0])
        bound_ms, bound_by = window_bound_ms(N, H, S, S, D, torch.bfloat16)
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(t(q), t(k), t(v)), flush=flush)
        for key, fn in (("K9", lambda: window_attention_heads(q, k, v)),
                        ("K10", lambda: window_attention_3d(q, k, v)),
                        ("K10 kernel alone", lambda: launch_3d(*flat, out))):
            ms = graph_ms(fn, flush=flush)
            rows[(key, torch.bfloat16, (N, S, H, D))] = dict(
                ms=ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"K9/K10 bf16 {label} {(N, S, H, D)}: " + ", ".join(
            f"{key} {rows[(key, torch.bfloat16, (N, S, H, D))]['ms']:.4f} ms"
            for key in ("K9", "K10", "K10 kernel alone"))
            + f"; F.scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return rows


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


# --------------------------------------------------------------------------- #
# slice 11: speedup() as CUDA graphs, the demo server, the AMG and the VOS eval
# --------------------------------------------------------------------------- #

# fp32 graphs against fp32 eager: the same kernels on the same inputs
# (bitwise expected), held within 1e-6 of the logits' scale
GRAPH_FP32_RTOL = 1e-6
# bf16 graphs against bf16 eager: per-frame (and per-image) mask mIoU
GRAPH_BF16_MIOU_MIN = 0.999
# the main kernel of a K1 and of a K2 call (each call also launches at most a
# combine kernel, and K2 its rotation), counted in a profiled replay
GRAPH_KERNELS = {"K1": r"flash_fwd_(wgmma|tf32)_kernel", "K2": r"flash_rope_(wgmma|tf32)_kernel"}
AMG_IOU_MIN = 0.99
AMG_OPEN = dict(points_per_side=8, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                box_nms_thresh=1.0)


def replay_kernel_counts(fn):
    """{K1, K2: main kernels launched by fn()} from a torch.profiler trace
    (fn replays graphs), with the trace's busy ms and its launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts, busy, launches = dict.fromkeys(GRAPH_KERNELS, 0), 0.0, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy += dev_us / 1e3
        launches += ev.count
        for key, pattern in GRAPH_KERNELS.items():
            if re.search(pattern, ev.key):
                counts[key] += ev.count
    return counts, busy, launches


def timed_rows(image_predictor, video_predictor, image, state):
    """Wall (median of CUDA-event timings after a warm-up), device busy
    time, idle share and kernel launches of one `set_image` and of one
    tracked frame (frames 1-7 of `state`, whose memory is full) at the
    predictors' current backend; and the main kernels of K1 and K2 in the
    two profiled runs."""
    rows, counts = {}, {}
    walls = []
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        image_predictor.set_image(image)
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
    counts["set_image"], busy, launches = replay_kernel_counts(
        lambda: image_predictor.set_image(image))
    wall = float(np.median(walls[1:]))
    rows["set_image"] = dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                             launches=launches)
    frame_ms = []
    frames = video_predictor.propagate_in_video(state, start_frame_idx=1)
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if next(frames, None) is None:
            break
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
    counts["tracked_frames"], busy, launches = replay_kernel_counts(
        lambda: list(video_predictor.propagate_in_video(state, start_frame_idx=1)))
    wall = float(np.median(frame_ms))
    per = 1.0 / len(frame_ms)
    rows["tracked_frame"] = dict(wall_ms=wall, busy_ms=busy * per,
                                 idle_share=1 - busy * per / wall, launches=launches * per)
    return rows, counts


def image_and_video_run(image_predictor, video_predictor, image, video, points):
    """set_image + the six prompts of phase 5, and an 8-frame propagation:
    (image outputs, per-frame video-res logits, stored low-res logits, the
    video's state)."""
    image_predictor.set_image(image)
    outs = {}
    for name, prompt in PROMPTS.items():
        for multimask in (True, False):
            outs[(name, multimask)] = image_predictor.predict(**prompt, multimask_output=multimask,
                                                              return_logits=True)
    state, masks, _ = track(video_predictor, video, video.shape[0], points)
    return outs, [m.float().cpu() for m in masks], low_res(state), state


@phase
def phase_graphs(flash_attention, flash_attention_rope):
    """`speedup()` as CUDA graphs on the hiera-L predictors of phases 5 and
    6: set_image, predict and the 8-frame propagation once eagerly and once
    through graphs, in fp32 (`set_runtime_backend("cuda", {"dtype":
    torch.float32})`) and in bf16 (`speedup()`, against bf16 eager); fp32
    logits within 1e-6 of their scale, bf16 masks at mIoU >= 0.999; K1 and
    K2 counted inside replays from a profiler trace; walls, busy time, idle
    share and launches of set_image and of a tracked frame, eager and graphs;
    the graphs and their pool bytes."""
    from sam2_opt_tpu_torch import SAM2ImagePredictor, build_sam2_video_predictor

    video_predictor = build_sam2_video_predictor("hiera_l", seed=SEED)
    with torch.no_grad():
        video_predictor.model.module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += \
            OBJ_BIAS
    image_predictor = SAM2ImagePredictor(video_predictor.model)
    model = video_predictor.model
    image, video = structured_image(SEED), synthetic_video(SEED)
    T = video.shape[0]
    points = np.array([[VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120]], np.float32)
    result = {"rows": {}, "checks": {}}
    replay_counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        runs = {}
        for mode in ("eager", "graphs"):
            if dtype == torch.float32 and mode == "eager":
                model.set_runtime_backend("eager")
            elif mode == "eager":
                set_backend(model)
            elif dtype == torch.float32:
                model.set_runtime_backend("cuda", {"dtype": torch.float32})
            else:
                video_predictor.speedup()
            check(model.compute_dtype == dtype, f"{name} {mode}: compute dtype {model.compute_dtype}")
            before = model.graphs.captures
            # counts to 0 just before, read just after: under graphs the
            # wrappers run (and count) only at each signature's warm-up and
            # capture, so the replays' kernels are counted from a trace below
            flash_attention.launches = flash_attention_rope.launches = 0
            runs[mode] = image_and_video_run(image_predictor, video_predictor, image, video,
                                             points)
            torch.cuda.synchronize()
            log(f"{name} {mode}: wrapper launches K1 {flash_attention.launches}, K2 "
                f"{flash_attention_rope.launches}")
            if mode == "graphs":
                check(model.graphs.captures - before == len(model.graphs),
                      "each signature must be captured once")
                # a second pass replays every graph captured by the first
                captures = model.graphs.captures
                again = image_and_video_run(image_predictor, video_predictor, image, video,
                                            points)
                check(model.graphs.captures == captures, "a second pass must only replay")
                check(all(np.array_equal(a[2], b[2]) for a, b in
                          zip(runs[mode][0].values(), again[0].values()))
                      and all(torch.equal(a, b) for a, b in zip(runs[mode][1], again[1])),
                      f"{name}: graph replays are not deterministic")
                keys = [k[0] for k in model.graphs.keys()]
                pools = model.graphs.pool_bytes()
                log(f"{name} graphs: {len(keys)} ({model.graphs.captures} captures); pool bytes "
                    f"per graph {dict(zip(map(str, keys), pools))}, {sum(pools)} in all")
                result["checks"][f"{name} graphs"] = dict(graphs=[str(k) for k in keys],
                                                          pool_bytes=pools)
            rows, counts = timed_rows(image_predictor, video_predictor, image, runs[mode][3])
            result["rows"][f"{name} {mode}"] = rows
            log(f"{name} {mode}: {json.dumps(rows)}; K1/K2 main kernels per set_image "
                f"{counts['set_image']}, over {T - 1} tracked frames {counts['tracked_frames']}")
            if mode == "graphs":
                # K1 and K2 inside the replays, from the profiled replays
                replay_counts[name] = counts
                enc, trk = counts["set_image"], counts["tracked_frames"]
                check(enc["K1"] == 3 and enc["K2"] == 0,
                      f"{name}: a set_image replay must run K1 3 times, ran {enc}")
                check(trk["K1"] == 3 * (T - 1) and trk["K2"] == 8 * (T - 1),
                      f"{name}: a tracked frame's replays must run K1 3 and K2 8 times, ran {trk}")
        (e_img, e_vid, e_low, _), (g_img, g_vid, g_low, _) = runs["eager"], runs["graphs"]
        if dtype == torch.float32:
            worst, bitwise = 0.0, True
            for key in e_img:
                for a, b in zip(e_img[key], g_img[key]):
                    scale = max(float(np.abs(a).max()), 1e-30)
                    worst = max(worst, float(np.abs(a - b).max()) / scale)
                    bitwise &= np.array_equal(a, b)
            for a, b in zip(e_vid + [e_low], g_vid + [g_low]):
                worst = max(worst, float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30))
                bitwise &= torch.equal(a, b)
            log(f"fp32 graphs vs eager: max |diff| / scale {worst:.3e} (limit "
                f"{GRAPH_FP32_RTOL}), bitwise {bitwise}")
            check(worst <= GRAPH_FP32_RTOL, "fp32 graphs disagree with fp32 eager")
            result["checks"]["fp32"] = dict(max_rel_diff=worst, bitwise=bitwise)
        else:
            ious = [miou(a > 0, b > 0) for key in e_img for a, b in zip(e_img[key][0],
                                                                         g_img[key][0])]
            frame_ious = [miou(a.numpy() > 0, b.numpy() > 0) for a, b in zip(e_vid, g_vid)]
            largest = max(float((a - b).abs().max()) for a, b in zip(e_vid, g_vid))
            largest_img = max(float(np.abs(e_img[k][2] - g_img[k][2]).max()) for k in e_img)
            log(f"bf16 graphs vs eager: image mask mIoU min {min(ious):.5f}, per-frame video "
                f"mask mIoU {[round(x, 5) for x in frame_ious]}, largest logit difference "
                f"video {largest:.4f}, image low-res {largest_img:.4f}")
            check(min(ious + frame_ious) >= GRAPH_BF16_MIOU_MIN,
                  "bf16 graphs disagree with bf16 eager")
            result["checks"]["bf16"] = dict(image_miou_min=min(ious), frame_miou=frame_ious,
                                            largest_logit_diff=largest,
                                            largest_image_logit_diff=largest_img)
    result["replay_counts"] = replay_counts
    return video_predictor, result


def write_png_video(root, video):
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for t, frame in enumerate(video):
        Image.fromarray(frame).save(os.path.join(root, f"{t:05d}.png"))


def square_mask(t, H=720, W=1280):
    """The synthetic video's moving square on frame t, as a bool mask."""
    mask = np.zeros((H, W), bool)
    y, x = VIDEO_SQUARE[1] + 16 * t, VIDEO_SQUARE[0] + 40 * t
    mask[y:y + 240, x:x + 240] = True
    return mask


def session_script(api, video_path, timings=None):
    """The serve phase's calls, through `api` (an InferenceAPI or the HTTP
    client below): start, a click on frame 0, a streamed propagation, a
    mask for a second object, its removal, close. Returns the decoded masks
    of every response, in order."""
    from sam2_opt_tpu_torch.utils.amg import mask_to_rle, rle_to_mask

    def call(endpoint, fn):
        t0 = time.perf_counter()
        out = fn()
        if timings is not None:
            timings.setdefault(endpoint, []).append((time.perf_counter() - t0) * 1e3)
        return out

    def decoded(frames):
        return [(f["frameIndex"], r["objectId"], rle_to_mask(r["mask"]))
                for f in frames for r in f["results"]]

    sid = call("start_session", lambda: api.start_session(video_path))
    outs = decoded([call("add_points", lambda: api.add_points(
        sid, 0, 1, [[VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120]], [1]))])
    outs += decoded(call("propagate_in_video", lambda: list(api.propagate_in_video(sid, 0))))
    rle = mask_to_rle(square_mask(2)[None] ^ square_mask(3)[None])[0]
    outs += decoded([call("add_mask", lambda: api.add_mask(sid, 2, 2, rle))])
    outs += decoded(call("remove_object", lambda: api.remove_object(sid, 2)))
    check(call("close_session", lambda: api.close_session(sid)), "close_session failed")
    return outs


def two_object_script(api, video_path):
    """A second session: a click and a mask on frame 0 for two objects,
    propagated together (the batched step's graphs)."""
    from sam2_opt_tpu_torch.utils.amg import mask_to_rle, rle_to_mask

    sid = api.start_session(video_path)
    api.add_points(sid, 0, 1, [[VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120]], [1])
    api.add_mask(sid, 0, 2, mask_to_rle(~square_mask(0)[None])[0])
    outs = [(f["frameIndex"], r["objectId"], rle_to_mask(r["mask"]))
            for f in api.propagate_in_video(sid, 0) for r in f["results"]]
    api.close_session(sid)
    return outs


class HttpSession:
    """The InferenceAPI calls of `session_script` as HTTP requests."""

    def __init__(self, port):
        self.url = f"http://127.0.0.1:{port}"

    def post(self, path, payload):
        import urllib.request

        req = urllib.request.Request(self.url + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            check(resp.status == 200, f"{path}: HTTP {resp.status}")
            body = resp.read().decode()
        if path == "/propagate_in_video":
            return [json.loads(line) for line in body.strip().split("\n")]
        return json.loads(body)

    def start_session(self, video_path):
        return self.post("/start_session", {"video_path": video_path})["sessionId"]

    def add_points(self, sid, frame, obj, points, labels):
        return self.post("/add_points", {"sessionId": sid, "frameIndex": frame, "objectId": obj,
                                         "points": points, "labels": labels})

    def propagate_in_video(self, sid, start):
        return self.post("/propagate_in_video", {"sessionId": sid, "startFrameIndex": start})

    def add_mask(self, sid, frame, obj, rle):
        return self.post("/add_mask", {"sessionId": sid, "frameIndex": frame, "objectId": obj,
                                       "mask": rle})

    def remove_object(self, sid, obj):
        return self.post("/remove_object", {"sessionId": sid, "objectId": obj})["results"]

    def close_session(self, sid):
        return self.post("/close_session", {"sessionId": sid})["success"]


def same_masks(a, b):
    return len(a) == len(b) and all(x[:2] == y[:2] and np.array_equal(x[2], y[2])
                                    for x, y in zip(a, b))


@phase
def phase_serve(video_predictor):
    """The demo server over the hiera-L video predictor after `speedup()`
    (fresh graphs), on a PNG folder of the 8-frame video: the session script
    over HTTP, every decoded mask equal to the same calls through
    InferenceAPI in-process; two sessions from two threads, one capturing
    the batched step's first graphs while the other replays, each equal to
    its solo run; the AMG at its defaults with graphs and eagerly in bf16;
    vos_inference on the PNG folder with a frame-0 mask and sav_benchmark on
    its output."""
    import tempfile
    import threading

    from sam2_opt_tpu_torch import SAM2AutomaticMaskGenerator, SAM2ImagePredictor
    from sam2_opt_tpu_torch.eval.sav_benchmark import benchmark
    from sam2_opt_tpu_torch.eval.vos_inference import davis_palette, save_ann_png, vos_inference
    from sam2_opt_tpu_torch.serve.inference_api import InferenceAPI
    from sam2_opt_tpu_torch.serve.server import DemoServer

    root = tempfile.mkdtemp(prefix="sam2_chip_smoke_serve_")
    video = synthetic_video(SEED)
    T = video.shape[0]
    frames_dir = os.path.join(root, "JPEGImages", "synthetic")
    write_png_video(frames_dir, video)
    video_predictor.speedup()  # fresh graphs
    model = video_predictor.model
    result = {}

    server = DemoServer(InferenceAPI(video_predictor), host="127.0.0.1", port=0)
    server.start_background()
    try:
        timings = {}
        http = session_script(HttpSession(server.port), frames_dir, timings)
    finally:
        server.shutdown()
    result["endpoint_ms"] = {k: v for k, v in timings.items()}
    log(f"serve: endpoint latencies over HTTP (ms; these first calls capture the graphs) "
        f"{json.dumps({k: [round(x, 3) for x in v] for k, v in timings.items()})}")
    replay_timings = {}
    in_process = session_script(InferenceAPI(video_predictor), frames_dir, replay_timings)
    result["endpoint_replay_ms"] = replay_timings
    log(f"serve: the same calls in-process, replays only (ms) "
        f"{json.dumps({k: [round(x, 3) for x in v] for k, v in replay_timings.items()})}")
    check(len(http) == 1 + T + 2 + 1 and same_masks(http, in_process),
          "HTTP masks differ from the same calls through InferenceAPI")
    check(all(m.shape == (720, 1280) for _, _, m in http), "mask size")

    # two sessions at once: B's batched two-object step is captured while A replays
    captures = model.graphs.captures
    outs, errors = {}, []

    def run(key, fn):
        try:
            outs[key] = fn(InferenceAPI(video_predictor), frames_dir)
        except Exception as e:  # reported below; the check fails
            errors.append(f"{key}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=("A", session_script)),
               threading.Thread(target=run, args=("B", two_object_script))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not errors and not any(t.is_alive() for t in threads), f"concurrent sessions: {errors}")
    concurrent_captures = model.graphs.captures - captures
    solo_b = two_object_script(InferenceAPI(video_predictor), frames_dir)
    log(f"two concurrent sessions: {concurrent_captures} graphs captured during the run; "
        f"A equals its solo run {same_masks(outs['A'], http)}, B equals its solo run "
        f"{same_masks(outs['B'], solo_b)}")
    check(concurrent_captures > 0, "the second session must capture new graphs")
    check(same_masks(outs["A"], http) and same_masks(outs["B"], solo_b),
          "a concurrent session differs from its solo run")
    result["concurrent_captures"] = concurrent_captures

    # the automatic mask generator, bf16, graphs against eager: at its
    # defaults, and on an 8-point grid with its score filters and NMS off
    # (random weights leave no record at the defaults, and near-duplicates)
    image = structured_image(SEED)
    image_predictor = SAM2ImagePredictor(model)
    for label, options in (("defaults", {}), ("filters off", AMG_OPEN)):
        records, walls = {}, {}
        for mode in ("graphs", "eager"):
            if mode == "graphs":
                model.speedup()
            else:
                set_backend(model)
            amg = SAM2AutomaticMaskGenerator(image_predictor, **options)
            if not options:
                amg.generate(image)  # warm-up (captures the graphs both settings replay)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            records[mode] = amg.generate(image)
            torch.cuda.synchronize()
            walls[mode] = (time.perf_counter() - t0) * 1e3
        ious = [miou(a["segmentation"], b["segmentation"])
                for a, b in zip(records["graphs"], records["eager"])]
        log(f"AMG {label} {options}, bf16: {len(records['graphs'])} records with graphs, "
            f"{len(records['eager'])} eagerly; walls {walls['graphs']:.3f} ms (graphs) and "
            f"{walls['eager']:.3f} ms (eager); per-mask IoU min {min(ious, default=1.0):.5f}")
        check(len(records["graphs"]) == len(records["eager"]) and
              all(x >= AMG_IOU_MIN for x in ious), f"AMG {label}: graphs and eager differ")
        result[f"amg {label}"] = dict(records=len(records["graphs"]),
                                      iou_min=min(ious, default=1.0), wall_ms=walls)
    check(result["amg filters off"]["records"] > 0, "the AMG with filters off found no mask")

    # VOS inference on the PNG folder with a frame-0 mask, then J&F
    video_predictor.speedup()
    ann_dir = os.path.join(root, "Annotations", "synthetic")
    for t in range(T):
        save_ann_png(os.path.join(ann_dir, f"{t:05d}.png"), square_mask(t).astype(np.uint8),
                     davis_palette())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vos_inference(video_predictor, os.path.join(root, "JPEGImages"),
                  os.path.join(root, "Annotations"), os.path.join(root, "pred"), "synthetic")
    jf, j, f, _ = benchmark([os.path.join(root, "Annotations")], [os.path.join(root, "pred")],
                            num_processes=1, verbose=False)
    result["eval_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"vos_inference + sav_benchmark over {T} PNG frames: J&F {jf[0]:.3f} (J {j[0]:.3f}, "
        f"F {f[0]:.3f}), wall {result['eval_ms']:.3f} ms")
    check(all(np.isfinite(x[0]) for x in (jf, j, f)), "J&F must be finite")
    result["jf"] = dict(jf=jf[0], j=j[0], f=f[0])
    return result


# slice 12: int8 and the predictor variants
INT8_MIOU_MIN = {"fp32 act-quant": 0.98, "fp32 weight-only": 0.98, "bf16 act-quant": 0.95}
# the gate of tests/test_quant.py's tracking-scope video. There the tracked
# frames are scored absent (empty masks on both sides); with the object-score
# bias raised, the encoder scope meets it on every frame and the tracking
# scope on the click frame.
INT8_VIDEO_IOU_MIN = 0.97
# the tracking scope's tracked frames miss it, in the JAX package too
# (hiera_t, tests/test_torch_quant.py): the two-way transformer's token
# self-attention gets one activation scale, set by the click step's prompt
# embedding (absmax ~1), and an unprompted tracked frame's tokens (random
# embeddings, std 0.02, absmax ~0.08) fall to a few int8 steps. On hiera-L
# they read 0.798-0.812, the same every run; with those 8 layers
# weight-only every frame meets INT8_VIDEO_IOU_MIN (phase 22 checks both),
# and a product that reads its zero padding gives 0 (its negative control).
# Errors that IoU on random weights cannot see (memory attention's scales or
# its q/k permutation) are held against the JAX package on the CPU.
INT8_TRACKED_IOU_MIN = 0.78


def int8_calibration_dir(root, image, video):
    """4 JPEG calibration images: the 1500x2000 image and video frames 0, 3
    and 6."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for i, frame in enumerate([image, video[0], video[3], video[6]]):
        Image.fromarray(frame).save(os.path.join(root, f"calib{i}.jpg"))
    return root


def quantized_layers(model):
    """(int8 layers, those with an activation scale) of the compute module."""
    from sam2_opt_tpu_torch.quant.int8 import QuantLinear

    layers = [m for m in model._m.modules() if isinstance(m, QuantLinear)]
    return len(layers), sum(m.act_scale is not None for m in layers)


def image_outputs(predictor, image):
    """set_image + the six prompts of phase 5, logits."""
    predictor.set_image(image)
    return {(name, mm): predictor.predict(**prompt, multimask_output=mm, return_logits=True)
            for name, prompt in PROMPTS.items() for mm in (True, False)}


def image_miou(ref, got):
    return float(np.mean([miou(a > 0, b > 0) for key in ref for a, b in zip(ref[key][0],
                                                                             got[key][0])]))


def trace_kernels(fn):
    """{kernel name: launches} of a torch.profiler trace of one fn(), the
    device idle before it; launches summed by name over `key_averages()`'s
    entries."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0) + ev.count
    return kernels


def int8_by_name(kernels):
    """({kernel name: launches}, their sum) of the int8 GEMMs among
    `trace_kernels`' result."""
    names = {k[:120]: n for k, n in kernels.items() if re.search(INT8_GEMM, k)}
    return names, sum(names.values())


@contextlib.contextmanager
def captured_products():
    """For the block, wraps the int8 product so that its `captured` counts
    the products launched while a CUDA graph is captured: those the graph's
    replays run, which no wrapper sees, as a replay runs no Python. The
    product's own `launches` (it counts through the module's name) goes on
    counting every call."""
    from sam2_opt_tpu_torch.quant import int8 as int8_module

    product = int8_module.int8_matmul

    def counting(a, w_int8):
        if torch.cuda.is_current_stream_capturing():
            counting.captured += 1
        return product(a, w_int8)

    counting.launches, counting.captured = product.launches, 0
    int8_module.int8_matmul = counting
    try:
        yield counting
    finally:
        int8_module.int8_matmul = product
        product.launches = counting.launches


@phase
def phase_int8(counters):
    """`speedup("int8")` on the hiera-L predictors of phase 20 (seed 0, the
    object-score bias raised), calibrated on 4 JPEGs written from the
    1500x2000 image and the synthetic video. The image predictor through
    graphs in three routes against fp32 eager at `tests/test_quant.py`'s
    gates (fp32 act-quant and weight-only mIoU >= 0.98, bf16 act-quant >=
    0.95); fp32 int8 graphs bitwise equal to fp32 int8 run eagerly, a
    second pass capturing nothing; the 8-frame video (fp32, calibrated)
    against fp32 eager: the encoder scope at IoU >= 0.97 per frame, the
    tracking scope through graphs at >= 0.97 on the click frame and >= 0.78
    on tracked frames, bitwise equal to the same model run eagerly under
    `SAM2_TPU_FUSED_KV_PROJ=1` (K4 none), a negative control (the token
    rows' zero padding placed first) below 0.78, and >= 0.97 per frame with
    the two-way transformer's token self-attention weight-only
    (INT8_TRACKED_IOU_MIN's comment); the quantized layers per scope, the
    int8 products captured into the graphs a replay runs (195 per
    `set_image`, 267 per tracked frame; the profiler's record of a replay
    holds some and no more) and K1/K2 inside replays, K8 none under `SAM2_TPU_FUSED_MLP=1` with int8 (eagerly, where
    the wrappers count); the calibration's wall; walls, busy, idle and
    device time by kernel family of `set_image` and a tracked frame under
    bf16 graphs and int8 weight-only and act-quant.
    Returns (video predictor, result)."""
    import shutil
    import tempfile

    from sam2_opt_tpu_torch import SAM2ImagePredictor, build_sam2_video_predictor
    from sam2_opt_tpu_torch.quant.int8 import int8_matmul

    video_predictor = build_sam2_video_predictor("hiera_l", seed=SEED)
    with torch.no_grad():
        video_predictor.model.module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += \
            OBJ_BIAS
    image_predictor = SAM2ImagePredictor(video_predictor.model)
    model = video_predictor.model
    image, video = structured_image(SEED), synthetic_video(SEED)
    T = video.shape[0]
    points = np.array([[VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120]], np.float32)
    root = tempfile.mkdtemp(prefix="sam2_chip_smoke_int8_")
    calib = int8_calibration_dir(os.path.join(root, "calib"), image, video)
    blocks = model.module.image_encoder.trunk.blocks
    encoder_linears = 4 * len(blocks) + sum(hasattr(b, "proj") for b in blocks)
    result = {"expected_encoder_layers": encoder_linears, "gates": {}, "layers": {},
              "speedup_wall_s": {}, "int8_products": {}, "rows": {}}

    def quantize(label, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video_predictor.speedup("int8", **kw)
        torch.cuda.synchronize()
        result["speedup_wall_s"][label] = time.perf_counter() - t0
        result["layers"][label] = quantized_layers(model)
        log(f"int8 {label}: speedup('int8', {kw}) {result['speedup_wall_s'][label]:.2f} s "
            f"(calibration on the fp32 master + quantization), (int8 layers, with an activation "
            f"scale) {result['layers'][label]}")

    # the image routes against fp32 eager
    model.set_runtime_backend("eager")
    ref = image_outputs(image_predictor, image)
    routes = {"fp32 act-quant": dict(calib_dir=calib, dtype=torch.float32),
              "fp32 weight-only": dict(dtype=torch.float32),
              "bf16 act-quant": dict(calib_dir=calib)}
    for label, kw in routes.items():
        quantize(label, **kw)
        check(result["layers"][label] == (encoder_linears, 0 if "weight" in label else
                                          encoder_linears),
              f"{label}: the encoder scope must quantize {encoder_linears} layers")
        check(model._use_graphs and model._m is not model.module, f"{label}: graphs on a copy")
        outs = image_outputs(image_predictor, image)
        gate = image_miou(ref, outs)
        result["gates"][label] = gate
        log(f"int8 {label}: image mask mIoU vs fp32 eager {gate:.5f} (limit "
            f"{INT8_MIOU_MIN[label]})")
        check(gate >= INT8_MIOU_MIN[label], f"int8 {label} masks drift from fp32")
        if label == "fp32 act-quant":
            # graphs against the same int8 model eagerly, and a second pass
            before = model.graphs.captures
            again = image_outputs(image_predictor, image)
            check(model.graphs.captures == before, "a second int8 pass must only replay")
            model._use_graphs = False
            eager = image_outputs(image_predictor, image)
            model._use_graphs = True
            bitwise = all(np.array_equal(a, b) for key in outs
                          for a, b in zip(outs[key], eager[key]))
            same = all(np.array_equal(a, b) for key in outs for a, b in zip(outs[key],
                                                                             again[key]))
            log(f"fp32 int8 graphs vs fp32 int8 eager: bitwise {bitwise}; a second pass "
                f"replays only and repeats the bits: {same}")
            check(bitwise and same, "fp32 int8 graphs differ from fp32 int8 eager")
            result["fp32_graphs_bitwise"] = bitwise
            # the products a replay runs, captured into its graphs anew, and
            # the profiler's record of them in one replay (INT8_GEMM's comment)
            model.graphs.clear()
            with captured_products() as products:
                image_predictor.set_image(image)
            captures = model.graphs.captures
            replay = trace_kernels(lambda: image_predictor.set_image(image))
            names, count = int8_by_name(replay)
            result["int8_products"]["set_image"] = products.captured
            result["int8_products"]["set_image replay, by kernel name"] = count
            others = {k[:120]: n for k, n in replay.items() if family(k) in ("matmul", "other")}
            log(f"int8 products captured into the graphs of one set_image: {products.captured}; "
                f"int8 GEMMs by name in a replay {json.dumps(names)} of "
                f"{sum(replay.values())} kernel records; its other matmul kernels and those of "
                f"no family {json.dumps(others)}")
            check(products.captured == encoder_linears and model.graphs.captures == captures
                  and 0 < count <= products.captured,
                  f"a set_image replay must run {encoder_linears} int8 products, captured into "
                  f"its graphs, and the profiler must see some of them")

    # the video, fp32, calibrated: the encoder scope, then the tracking scope
    # (INT8_TRACKED_IOU_MIN's comment)
    model.set_runtime_backend("eager")
    _, ref_masks, _ = track(video_predictor, video, T, points)
    ref_masks = [m.cpu() for m in ref_masks]

    def tracked(counts=None):
        """The video tracked at the current backend: (state, masks on the
        host, per-frame counts, per-frame IoUs against fp32 eager)."""
        state, masks, per_frame = track(video_predictor, video, T, points, counts=counts)
        masks = [m.cpu() for m in masks]
        ious = [float(miou(a[0, 0].numpy() > 0, b[0, 0].numpy() > 0))
                for a, b in zip(masks, ref_masks)]
        return state, masks, per_frame, ious

    quantize("video fp32 act-quant", calib_dir=calib, dtype=torch.float32)
    _, _, _, ious = tracked()
    result["gates"]["video fp32 act-quant"] = ious
    log(f"int8 video, encoder scope, fp32 act-quant: per-frame IoU vs fp32 eager "
        f"{[round(x, 5) for x in ious]} (limit {INT8_VIDEO_IOU_MIN})")
    check(len(ious) == T and min(ious) >= INT8_VIDEO_IOU_MIN, "int8 video masks drift")

    quantize("tracking fp32 act-quant", calib_dir=calib, dtype=torch.float32,
             quant_scope="tracking")
    layers = result["layers"]["tracking fp32 act-quant"]
    # memory attention: q/k/v/out of both attentions and the FFN's two per
    # layer; the two-way transformer: 14 per layer and its final attention's 4
    tracking_linears = (encoder_linears + 10 * len(model.module.memory_attention.layers)
                        + 14 * len(model.module.sam_mask_decoder.transformer.layers) + 4)
    result["expected_tracking_layers"] = tracking_linears
    layer0 = model._m.memory_attention.layers[0]
    reached = [p.act_scale is not None for p in (layer0.self_attn.q_proj,
                                                 layer0.cross_attn_image.k_proj)]
    check(layers == (tracking_linears, tracking_linears) and all(reached),
          f"the tracking scope must quantize and calibrate {tracking_linears} layers, memory "
          f"attention's q/k projections among them")
    state, masks, _, ious = tracked()
    result["gates"]["tracking fp32 act-quant"] = dict(
        frame_iou=ious, click_limit=INT8_VIDEO_IOU_MIN, tracked_limit=INT8_TRACKED_IOU_MIN)
    log(f"int8 tracking scope, fp32 act-quant, graphs: per-frame IoU vs fp32 eager "
        f"{[round(x, 5) for x in ious]} (limits: the click frame {INT8_VIDEO_IOU_MIN}, "
        f"tracked frames {INT8_TRACKED_IOU_MIN})")
    check(len(ious) == T and ious[0] >= INT8_VIDEO_IOU_MIN
          and min(ious[1:]) >= INT8_TRACKED_IOU_MIN, "int8 tracking-scope masks drift")
    # the products each tracked frame's replay runs: with the graphs cleared,
    # frame 1 captures every seam of a tracked frame anew and frames 2-7
    # replay them; the profiler's record of each replay (INT8_GEMM's comment)
    model.graphs.clear()
    frames = video_predictor.propagate_in_video(state, start_frame_idx=1)
    captured_per_frame, new_graphs, per_frame, records = [], [], [], []
    with captured_products() as products:
        for t in range(1, T):
            products.captured, captures = 0, model.graphs.captures
            if t == 1:
                next(frames)
            else:
                kernels = trace_kernels(lambda: next(frames))
                per_frame.append(int8_by_name(kernels)[1])
                records.append(sum(kernels.values()))
            captured_per_frame.append(products.captured)
            new_graphs.append(model.graphs.captures - captures)
    check(next(frames, None) is None, "the propagation from frame 1 yields T - 1 frames")
    result["int8_products"]["tracked_frame captured"] = captured_per_frame
    result["int8_products"]["tracked_frame replays, by kernel name"] = per_frame
    log(f"int8 products captured into the graphs of each tracked frame {captured_per_frame} "
        f"(graphs captured {new_graphs}); int8 GEMMs by name in the replays of frames 2-{T - 1} "
        f"{per_frame} of {records} kernel records")
    check(captured_per_frame == [tracking_linears] + [0] * (T - 2)
          and new_graphs[1:] == [0] * (T - 2)
          and 0 < min(per_frame) and max(per_frame) <= tracking_linears,
          f"each tracked frame's replay must run {tracking_linears} int8 products, captured "
          f"into its graphs by frame 1, and the profiler must see some of them")

    # the same model eagerly under SAM2_TPU_FUSED_KV_PROJ=1: K4 leaves int8
    # k/v projections to K2, so the switch changes no number and the graphs
    # above must equal this run bit for bit
    K1, K2, K4, K8 = (counters[k] for k in ("K1", "K2", "K4", "K8"))
    model._use_graphs = False
    with switches({"SAM2_TPU_FUSED_KV_PROJ": "1"}):
        for c in (K1, K2, K4, int8_matmul):
            c.launches = 0
        _, eager_masks, per_frame, _ = tracked(counts=(K1, K2, K4, int8_matmul))
    bitwise = all(torch.equal(a, b) for a, b in zip(masks, eager_masks))
    log(f"tracking-scope int8 under SAM2_TPU_FUSED_KV_PROJ=1, eagerly: per frame (K1, K2, K4, "
        f"int8 products) {per_frame}; bitwise equal to the graphs without it: {bitwise}")
    result["tracking_graphs_bitwise"] = bitwise
    check(bitwise, "tracking-scope fp32 int8 graphs differ from the same model eagerly")
    frame = (3, 8, 0, tracking_linears)
    check(per_frame == [(0, 0, 0, 0)] + [frame] * (T - 1),
          f"a tracked frame must run {tracking_linears} int8 products and keep K4 off "
          f"(K2 8, K4 0)")
    result["int8_products"]["tracked_frame"] = per_frame[1][3]
    result["kv_proj_switch_per_frame"] = per_frame

    # negative control, eagerly: the decoder's zero padding placed before its
    # token rows instead of after, so their products read zeros; the
    # tracked-frame limit must refuse it
    from sam2_opt_tpu_torch.quant import int8 as int8_module

    def padded_first(a, w_int8):
        m = a.shape[0]
        if m < int8_module.INT_MM_MIN_ROWS:
            a = torch.cat([a.new_zeros(int8_module.INT_MM_MIN_ROWS - m, a.shape[1]), a])
        return torch._int_mm(a, w_int8.t())[:m]

    int8_module.int8_matmul = padded_first
    try:
        _, _, _, ious = tracked()
    finally:
        int8_module.int8_matmul = int8_matmul
    result["gates"]["negative control: padding first"] = ious
    log(f"negative control (the token rows' padding placed first): per-frame IoU "
        f"{[round(x, 5) for x in ious]}")
    check(min(ious[1:]) < INT8_TRACKED_IOU_MIN, "the tracked-frame limit must refuse a "
          "product that reads the padding")

    # the cause (INT8_TRACKED_IOU_MIN's comment): with the two-way
    # transformer's token self-attention weight-only, eagerly, every frame
    # must meet the gate
    with torch.no_grad():
        for blk in model._m.sam_mask_decoder.transformer.layers:
            for proj in (blk.self_attn.q_proj, blk.self_attn.k_proj, blk.self_attn.v_proj,
                         blk.self_attn.out_proj):
                proj.act_scale = None
    _, _, _, ious = tracked()
    result["gates"]["tracking, token self-attention weight-only"] = ious
    log(f"int8 tracking scope with the two-way transformer's token self-attention "
        f"weight-only: per-frame IoU vs fp32 eager {[round(x, 5) for x in ious]} (limit "
        f"{INT8_VIDEO_IOU_MIN})")
    check(min(ious) >= INT8_VIDEO_IOU_MIN,
          "the tracking scope with the token self-attention weight-only must meet the gate")

    mlp = {}
    with switches({"SAM2_TPU_FUSED_MLP": "1"}):
        for label, kw in (("bf16", None), ("bf16 int8", {})):
            if kw is None:
                set_backend(model)
            else:
                video_predictor.speedup("int8", **kw)
                model._use_graphs = False
            K1.launches = K8.launches = 0
            image_predictor.set_image(image)
            torch.cuda.synchronize()
            mlp[label] = (K1.launches, K8.launches)
    log(f"SAM2_TPU_FUSED_MLP=1, one set_image eagerly: (K1, K8) {mlp}")
    check(mlp == {"bf16": (3, 48), "bf16 int8": (3, 0)},
          "int8 MLPs must keep K8 off (48 launches without int8)")
    result["fused_mlp_switch"] = mlp

    # times through graphs: bf16 against int8 weight-only and act-quant
    for label, kw in (("bf16", None), ("bf16 int8 weight-only", {}),
                      ("bf16 int8 act-quant", dict(calib_dir=calib)),
                      ("bf16 int8 act-quant tracking", dict(calib_dir=calib,
                                                            quant_scope="tracking"))):
        if kw is None:
            video_predictor.speedup()
        else:
            video_predictor.speedup("int8", **kw)
        state, _, _ = track(video_predictor, video, T, points)
        rows, counts = timed_rows(image_predictor, video_predictor, image, state)
        enc, trk = counts["set_image"], counts["tracked_frames"]
        check(enc["K1"] == 3 and trk["K1"] == 3 * (T - 1) and trk["K2"] == 8 * (T - 1),
              f"{label}: replays must run K1 3 per set_image and K2 8 per tracked frame")
        # device time by kernel family: of a set_image, and of a tracked frame
        # (the 7 of a propagation from frame 1, averaged)
        _, rows["set_image"]["families"], _ = device_split(
            lambda: image_predictor.set_image(image))
        _, fams, _ = device_split(
            lambda: list(video_predictor.propagate_in_video(state, start_frame_idx=1)), reps=1)
        rows["tracked_frame"]["families"] = {
            k: {key: v / (T - 1) for key, v in f.items()} for k, f in fams.items()}
        result["rows"][label] = rows
        log(f"{label} graphs: {json.dumps(rows)}; K1/K2 per set_image {enc}, over {T - 1} "
            f"tracked frames {trk}")
    shutil.rmtree(root, ignore_errors=True)
    return video_predictor, result


@phase
def phase_variants(video_predictor):
    """The predictor variants on the hiera-L model of phase 22 in bf16
    graphs: DAM4SAM over the 8-frame video with `return_all_masks` (3
    masks and 3 IoUs a frame), `add_to_drm` on frame 2 and a preflight that
    makes it a conditioning frame; the Legacy contract (a new object after
    tracking starts raises); `build_sam2_video_predictor(vos_optimized=True)`
    on graphs from the start."""
    from sam2_opt_tpu_torch import build_sam2_video_predictor
    from sam2_opt_tpu_torch.predictors.variants import (
        SAM2VideoPredictorDAM4SAM,
        SAM2VideoPredictorLegacy,
        SAM2VideoPredictorVOS,
    )

    model = video_predictor.model
    model.speedup()
    video = synthetic_video(SEED)
    T, H, W, _ = video.shape
    points = np.array([[VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120]], np.float32)
    result = {}
    dam = SAM2VideoPredictorDAM4SAM(model)
    state = dam.init_state(video)
    dam.add_new_points_or_box(state, 0, 1, points=points, labels=np.array([1], np.int32))
    t0 = time.perf_counter()
    outs = list(dam.propagate_in_video(state, return_all_masks=True))
    result["dam4sam_propagation_s"] = time.perf_counter() - t0
    check(len(outs) == T, "DAM4SAM must yield every frame")
    for _, obj_ids, masks, (all_masks, ious) in outs:
        check(obj_ids == [1] and masks.shape == (1, 1, H, W) and len(all_masks) == 3
              and ious.shape == (3,) and all(m.shape == (1, 1, H, W) for m in all_masks)
              and np.isfinite(ious).all() and bool(torch.isfinite(masks).all()),
              "DAM4SAM: 3 masks and 3 IoUs per frame")
    obj_out = state["output_dict_per_obj"][0]
    visible = [o["n_pixels_pos"] for _, o in sorted(obj_out["non_cond_frame_outputs"].items())]
    dam.add_to_drm(state, 2, 1)
    dam.propagate_in_video_preflight(state)
    check(2 in obj_out["cond_frame_outputs"] and 2 not in obj_out["non_cond_frame_outputs"]
          and obj_out["cond_frame_outputs"][2]["maskmem_features"] is not None,
          "add_to_drm: the preflight must make frame 2 a conditioning frame")
    tail = list(dam.propagate_in_video(state, start_frame_idx=3, return_all_masks=True))
    check(len(tail) == T - 3, "DAM4SAM after add_to_drm")
    log(f"DAM4SAM, bf16 graphs: {T} frames with 3 masks + 3 IoUs each "
        f"({result['dam4sam_propagation_s']:.3f} s), n_pixels_pos per tracked frame {visible}; "
        f"frame 2 promoted to the DRM, frames 3-{T - 1} tracked again")
    result["n_pixels_pos"] = visible

    legacy = SAM2VideoPredictorLegacy(model)
    state = legacy.init_state(video[:3])
    legacy.add_new_points_or_box(state, 0, 1, points=points, labels=np.array([1], np.int32))
    list(legacy.propagate_in_video(state))
    try:
        legacy.add_new_points_or_box(state, 1, 2, points=points, labels=np.array([1], np.int32))
        raised = False
    except RuntimeError as e:
        raised = "after tracking starts" in str(e)
    check(raised, "Legacy: a new object after tracking starts must raise")
    log("Legacy: a new object after tracking starts raises")

    vos = build_sam2_video_predictor("hiera_l", seed=SEED, vos_optimized=True)
    check(type(vos) is SAM2VideoPredictorVOS and vos.model._use_graphs
          and vos.model.compute_dtype == torch.bfloat16, "VOS: bf16 graphs from the start")
    _, masks, _ = track(vos, video, 3, points)
    check(len(masks) == 3 and all(bool(torch.isfinite(m).all()) for m in masks)
          and vos.model.graphs.captures > 0, "VOS: tracking through graphs")
    log(f"VOS: 3 frames through {vos.model.graphs.captures} captured graphs")
    result["vos_captures"] = vos.model.graphs.captures
    del vos
    return result


# --------------------------------------------------------------------------- #
# slice 13: data and tensor parallelism; two ranks share the one card over gloo
# --------------------------------------------------------------------------- #

# fp32 at T = 8 peaks at 41.90 GiB in phase 10 (H100 80GB HBM3): two ranks at T = 8
# would not fit
PAR_FP32_FRAMES = 4
PAR_STEPS = 2              # Trainer.run steps per bf16 setting
PAR_LOSS_RTOL = 1e-5
PAR_GRAD_TOL = 1e-3        # of each gradient's own max |g| ...
PAR_GRAD_FLOOR = 1e-7      # ... plus this much of the model's largest gradient
PAR_LOGIT_TOL = 1e-4       # of the logits' scale
PAR_MASK_AGREE = 0.999     # per frame, video masks against one process
PAR_TIMEOUT_S = 480
PAR_RANKS = 2


class CaptureOptimizer:
    """Records the reduced gradients (and the global norm a TP step hands
    over) and leaves the parameters as they are: the step's gradients
    without Adam's sign-like first update between them and the check."""

    def init(self, params):
        return {}

    def update(self, grads, state, params, lr, grad_norm=None):
        self.grads, self.grad_norm = grads, grad_norm
        return {n: torch.zeros_like(g) for n, g in grads.items()}, state


def par_batch(T):
    """A global batch of two videos (phase 10's, and one from the next seed)."""
    a, b = training_video(T=T, seed=SEED), training_video(T=T, seed=SEED + 1)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def par_step(mesh, cfg, batch, rows, dtype, comms=None):
    """One `build_train_step` step on global `rows` of `batch` with phase
    10's settings (point prompt on frame 0, one correction click from the
    per-row generators, remat "encoder") and a CaptureOptimizer: the loss,
    the whole reduced gradients on the host, ms and peak GiB of the step."""
    import dataclasses

    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.parallel import tp as tp_lib
    from sam2_opt_tpu_torch.training.trainer import build_train_step, row_generators

    model = b_plus("cuda")
    sharded = tp_lib.shard_module(model, mesh) if mesh is not None else {}
    tcfg = dataclasses.replace(train_config(dtype, "/nonexistent"), comms_dtype=comms)
    opt = CaptureOptimizer()
    step = build_train_step(cfg, tcfg, opt, mesh, sharded=sharded)
    take = slice(rows[0], rows[-1] + 1)
    images = torch.as_tensor(batch["images"][take], device="cuda").float() / 255.0
    masks = torch.as_tensor(batch["masks"][take], device="cuda")
    valid = torch.as_tensor(batch["obj_valid"][take], device="cuda")
    # the step twice (the optimizer moves nothing): the first pays the
    # shapes' one-time costs, the second is timed
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, metrics = step(model, {}, images, masks, valid,
                          row_generators(SEED, 0, rows, "cuda"), 1e-6)
        loss = float(metrics["loss"])
        ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    grads = mesh_lib.fetch_global(opt.grads, mesh, sharded)
    del model, opt, step, images, masks, valid
    torch.cuda.empty_cache()
    return dict(loss=loss, grads=grads, ms=ms, peak_gib=peak)


def par_grads_within(got, want):
    """The worst |err| / own max |g| over tensors, and those outside
    PAR_GRAD_TOL * own max + PAR_GRAD_FLOOR * the largest."""
    check(sorted(got) == sorted(want), "the layouts differentiate other parameters")
    gmax = max(g.abs().max().item() for g in want.values())
    worst, bad = 0.0, []
    for n, w in want.items():
        err = (got[n] - w).abs().max().item()
        scale = w.abs().max().item()
        if err > PAR_GRAD_TOL * scale + PAR_GRAD_FLOOR * gmax:
            bad.append((n, err, scale))
        if scale >= 1e-6 * gmax:
            worst = max(worst, err / scale)
    return worst, bad


def par_same_on_ranks(value, what):
    """Every rank holds the same `value` (a small picklable)."""
    import torch.distributed as dist

    values = [None] * dist.get_world_size()
    dist.all_gather_object(values, value)
    diff = [i for i, v in enumerate(zip(*values)) if len(set(v)) > 1]
    check(not diff, f"{what} differs between ranks at {len(diff)} of {len(values[0])} entries, "
          f"first {[(i, [v[i] for v in values]) for i in diff[:4]]}")
    return values


def fingerprint(tensors):
    return [float(t.double().sum()) for t in tensors.values()] + [
        float(t.double().abs().sum()) for t in tensors.values()]


def par_fp32_layouts(rank):
    """(a) fp32 DP (dp 2 x tp 1, a video per rank) and TP (dp 1 x tp 2, one
    video) against one process on the same global batch (rank 0 runs it
    while rank 1 waits): hiera-b+ 1024², T = PAR_FP32_FRAMES, 2 objects."""
    import torch.distributed as dist

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib

    cfg = model_config("hiera_b+")
    batch = par_batch(PAR_FP32_FRAMES)
    layouts = {"dp2": (2, 1, 2), "tp2": (1, 2, 1)}  # dp, tp, global videos
    ref = {}
    if rank == 0:
        for name, (_, _, n) in layouts.items():
            ref[name] = par_step(None, cfg, batch, list(range(n)), "float32")
            log(f"one process, fp32, {n} video(s) of T = {PAR_FP32_FRAMES}: loss "
                f"{ref[name]['loss']:.6f}, {ref[name]['ms']:.1f} ms, peak "
                f"{ref[name]['peak_gib']:.2f} GiB")
    dist.barrier()
    out = {}
    for name, (dp, tp, n) in layouts.items():
        mesh = mesh_lib.make_mesh(dp, tp, backend="gloo", device="cuda")
        got = par_step(mesh, cfg, batch, mesh_lib.process_local_batch_rows(mesh, n), "float32")
        par_same_on_ranks(fingerprint(got["grads"]) + [got["loss"]],
                          f"{name}: the reduced gradients")
        row = dict(loss=got["loss"], ms=got["ms"], peak_gib=got["peak_gib"])
        if rank == 0:
            want = ref[name]
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            worst, bad = par_grads_within(got["grads"], want["grads"])
            log(f"(a) fp32 {name} (dp {dp} x tp {tp}) vs one process: loss {got['loss']:.6f} vs "
                f"{want['loss']:.6f} (rel {rel:.2e}, limit {PAR_LOSS_RTOL}); "
                f"{len(want['grads'])} gradients, worst |err| / own max |g| {worst:.2e}, "
                f"outside {bad[:3]}")
            check(rel <= PAR_LOSS_RTOL, f"fp32 {name}: the loss disagrees with one process")
            check(not bad, f"fp32 {name}: gradients disagree with one process")
            row.update(loss_rel=rel, worst_grad_rel=worst, one_process_ms=want["ms"],
                       one_process_peak_gib=want["peak_gib"])
        log(f"(a) fp32 {name}: rank {rank} step {got['ms']:.1f} ms (two ranks on one card: "
            f"contention, not scaling), peak {got['peak_gib']:.2f} GiB")
        out[name] = row
        del got
    return out


def par_bf16_dp(rank, counters):
    """(b) bf16 DP at full size, dp 2, T = 8, a video of 2 objects per rank:
    Trainer.run (the main path) with comms_dtype None and "bfloat16", each
    rank's launches per step equal to phase 10's; then the reduced
    gradients of one step under each, held together at the JAX test's
    bf16 tolerance."""
    import dataclasses
    import tempfile

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.training.trainer import Trainer

    cfg = model_config("hiera_b+")
    batch = par_batch(TRAIN_FRAMES)
    mesh = mesh_lib.make_mesh(2, 1, backend="gloo", device="cuda")
    expect = launches_per_step()
    runs, grads = {}, {}
    for comms in (None, "bfloat16"):
        root = tempfile.mkdtemp(prefix="sam2_chip_smoke_par_")
        tcfg = dataclasses.replace(train_config("bfloat16", root), comms_dtype=comms)
        trainer = Trainer(cfg, b_plus("cuda"), tcfg, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        trainer.run(lambda epoch: iter([batch] * PAR_STEPS), steps_per_epoch=PAR_STEPS)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(got == {k: PAR_STEPS * v for k, v in expect.items()},
              f"rank {rank}, bf16 DP (comms {comms}): launched {got}, expected {PAR_STEPS} x "
              f"{expect}")
        check(np.isfinite(trainer.step_losses).all(), "bf16 DP losses")
        step_ms = [1e3 * x for x in trainer.step_seconds]
        log(f"(b) bf16 dp 2, comms {comms}: rank {rank} Trainer.run {PAR_STEPS} steps, ms per "
            f"step {[round(x, 1) for x in step_ms]} (two ranks on one card: contention, not "
            f"scaling), peak {peak:.2f} GiB, launches {got}, losses "
            f"{[round(x, 4) for x in trainer.step_losses]}")
        runs[str(comms)] = dict(step_ms=step_ms, peak_gib=peak, launches=got,
                                losses=trainer.step_losses)
        del trainer
        torch.cuda.empty_cache()
        one = par_step(mesh, cfg, batch, mesh_lib.process_local_batch_rows(mesh, 2), "bfloat16",
                       comms)
        grads[str(comms)] = one
    plain, comms = grads["None"], grads["bfloat16"]
    rel = abs(comms["loss"] - plain["loss"]) / abs(plain["loss"])
    gmax = max(g.abs().max().item() for g in plain["grads"].values())
    bad = []
    for n, a in plain["grads"].items():
        tol = 0.05 * a.abs() + 0.02 * a.abs().max() + 1e-4 * gmax
        if not bool(((comms["grads"][n] - a).abs() <= tol).all()):
            bad.append(n)
    log(f"(b) bf16 comms vs plain bf16 DP: loss {comms['loss']:.6f} vs {plain['loss']:.6f} (rel "
        f"{rel:.2e}, limit 1e-3); gradients outside 5% + 2% of their max + 1e-4 of the largest: "
        f"{bad[:3]} ({len(bad)})")
    check(rel < 1e-3 and not bad, "bf16 gradient comms disagree with plain bf16 DP")
    return dict(runs=runs, comms_loss_rel=rel)


def par_cli(rank, root):
    """(d) `train.py --dp 2` over the PNG folder (hiera_t at 256 px, 2
    videos, 1 step): rank 0 alone writes the checkpoint, and a fresh trainer
    on each rank resumes from it to the same parameters."""
    import torch.distributed as dist

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.models.model import build_sam2
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.training import checkpoints
    from sam2_opt_tpu_torch.training.train import main as train_main
    from sam2_opt_tpu_torch.training.trainer import TrainConfig, Trainer

    writes = []
    save = checkpoints.CheckpointManager.save
    checkpoints.CheckpointManager.save = lambda self, step, state: (writes.append(step),
                                                                    save(self, step, state))
    try:
        ckpt = f"{root}/ckpt"
        trainer = train_main(["--img_folder", f"{root}/JPEGImages", "--gt_folder",
                              f"{root}/Annotations", "--variant", "hiera_t", "--image-size", "256",
                              "--num-epochs", "1", "--num-frames", "2", "--max-objects", "1",
                              "--batch-size", "2", "--dp", "2", "--backend", "gloo",
                              "--checkpoint-dir", ckpt, "--log-dir", f"{root}/logs"])
        trained = mesh_lib.fetch_global(trainer.model.state_dict(), trainer.mesh, trainer.sharded)
        fresh = Trainer(model_config("hiera_t", image_size=256),
                        build_sam2("hiera_t", seed=1, cfg=model_config("hiera_t", image_size=256))
                        .module, TrainConfig(checkpoint_dir=ckpt, log_dir=f"{root}/logs2"),
                        mesh=trainer.mesh)
        check(fresh.load_checkpoint() and fresh.steps == 1, "the ranks must resume")
        restored = mesh_lib.fetch_global(fresh.model.state_dict(), fresh.mesh, fresh.sharded)
    finally:
        checkpoints.CheckpointManager.save = save
    check(trainer.device.type == "cuda" and trainer.steps == 1
          and np.isfinite(trainer.step_losses).all(), "the training CLI under two ranks")
    check(all(torch.equal(restored[k], v) for k, v in trained.items()),
          "the resumed parameters differ from the trained ones")
    prints = par_same_on_ranks(fingerprint(restored), "the resumed parameters")
    all_writes = [None] * dist.get_world_size()
    dist.all_gather_object(all_writes, writes)
    check(all_writes[0] and not any(all_writes[1:]), f"checkpoint writes per rank {all_writes}")
    log(f"(d) train.py --dp 2: rank {rank} loss {trainer.step_losses[0]:.4f}; checkpoint writes "
        f"per rank {all_writes}; both ranks resumed to the trained parameters "
        f"({len(prints[0]) // 2} tensors)")
    return dict(loss=trainer.step_losses[0], writes=all_writes)


def par_inference(rank, counters):
    """(e) hiera-L fp32 on two ranks against one process (rank 0, then
    broadcast): SAM2ImagePredictor(mesh=dp 2) on 2 images, the video
    predictor (mesh=dp 2) over the 8-frame video with 2 objects, and the
    image predictor at dp 1 x tp 2; K1 and K2 counted per rank."""
    import torch.distributed as dist

    from sam2_opt_tpu_torch.models.model import build_sam2
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor
    from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor

    images = [structured_image(SEED), structured_image(SEED + 1)]
    coords = [np.array([[1000, 750]], np.float32), np.array([[600, 500], [1300, 1000]],
                                                            np.float32)]
    labels = [np.array([1]), np.array([1, 0])]
    video = synthetic_video(SEED)
    points = {1: np.array([[VIDEO_SQUARE[0] + 120, VIDEO_SQUARE[1] + 120]], np.float32),
              2: np.array([[1000, 600]], np.float32)}

    def model():
        m = build_sam2("hiera_l", seed=SEED)
        with torch.no_grad():
            m.module.sam_mask_decoder.pred_obj_score_head.layers[-1].bias += OBJ_BIAS
        return m

    def image_run(predictor):
        for c in counters.values():
            c.launches = 0
        predictor.set_image_batch(images)
        k1 = counters["K1"].launches
        _, ious, low = predictor.predict_batch(coords, labels, multimask_output=True)
        return dict(ious=ious, low=low, k1=k1)

    def video_run(predictor):
        state = predictor.init_state(video)
        for obj, pt in points.items():
            predictor.add_new_points_or_box(state, 0, obj, points=pt, labels=np.array([1]))
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        masks = [(logits > 0).cpu().numpy() for _, _, logits in
                 predictor.propagate_in_video(state)]
        return dict(masks=masks, seconds=time.perf_counter() - t0,
                    k1=counters["K1"].launches, k2=counters["K2"].launches)

    sam = model()
    ref = None
    if rank == 0:
        ref = {"image": image_run(SAM2ImagePredictor(sam)),
               "video": video_run(SAM2VideoPredictor(sam, fill_hole_area=8))}
        ref["video"]["masks"] = [np.packbits(m) for m in ref["video"]["masks"]]
    box = [ref]
    dist.broadcast_object_list(box, src=0)
    ref = box[0]
    ref_masks = [np.unpackbits(m)[:2 * video.shape[1] * video.shape[2]].reshape(
        2, 1, *video.shape[1:3]).astype(bool) for m in ref["video"]["masks"]]

    def image_within(got, what):
        worst = max(float(np.abs(a - b).max() / np.abs(b).max())
                    for a, b in zip(got["low"], ref["image"]["low"]))
        check(len(got["low"]) == 2 and worst <= PAR_LOGIT_TOL,
              f"{what}: logits {worst:.2e} of their scale from one process")
        return worst

    dp2 = mesh_lib.make_mesh(2, 1, backend="gloo", device="cuda")
    img = image_run(SAM2ImagePredictor(sam, mesh=dp2))
    img_err = image_within(img, "image dp 2")
    vid = video_run(SAM2VideoPredictor(sam, fill_hole_area=8, mesh=dp2))
    agree = [float((a == b).mean()) for a, b in zip(vid["masks"], ref_masks)]
    check(len(agree) == VIDEO_FRAMES and min(agree) >= PAR_MASK_AGREE,
          f"video dp 2: mask agreement per frame {agree}")
    # each rank encodes its image, and every tracked frame (frame 0's features
    # are cached from init_state); its object's batch launches K2 8 a frame
    tracked = VIDEO_FRAMES - 1
    check(img["k1"] == ref["image"]["k1"] == 3
          and vid["k1"] == ref["video"]["k1"] == 3 * tracked
          and vid["k2"] == ref["video"]["k2"] == 8 * tracked,
          f"rank {rank}: K1 {img['k1']} per image batch, video K1 {vid['k1']} K2 {vid['k2']}; "
          f"one process {ref['image']['k1']}, {ref['video']['k1']}, {ref['video']['k2']}")
    del sam
    torch.cuda.empty_cache()
    tp2 = mesh_lib.make_mesh(1, 2, backend="gloo", device="cuda")
    img_tp = image_run(SAM2ImagePredictor(model(), mesh=tp2))
    tp_err = image_within(img_tp, "image tp 2")
    check(img_tp["k1"] == 3, f"rank {rank}: tp 2 image K1 {img_tp['k1']}")
    log(f"(e) hiera-L fp32, rank {rank}: image dp 2 logits {img_err:.2e} of scale (limit "
        f"{PAR_LOGIT_TOL}), K1 {img['k1']} for its image; video dp 2 mask agreement per frame "
        f"min {min(agree):.6f} (limit {PAR_MASK_AGREE}), K1 {vid['k1']} K2 {vid['k2']} over "
        f"{VIDEO_FRAMES} frames, propagation {vid['seconds']:.2f} s (one process "
        f"{ref['video']['seconds']:.2f} s; two ranks on one card); image tp 2 {tp_err:.2e}, K1 "
        f"{img_tp['k1']}")
    return dict(image_dp2_err=img_err, image_tp2_err=tp_err, video_agree_min=min(agree),
                launches={"image_dp2": {"K1": img["k1"]}, "video_dp2": {"K1": vid["k1"],
                          "K2": vid["k2"]}, "image_tp2": {"K1": img_tp["k1"]}},
                video_s=vid["seconds"], one_process_video_s=ref["video"]["seconds"])


def parallel_rank(out):
    """One rank of phase_parallel, started by it with torchrun's variables;
    writes `out/rank<r>.json`, exits non-zero on any failure."""
    import traceback

    import torch.distributed as dist

    from sam2_opt_tpu_torch.kernels import flash_attention as fa
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib

    try:
        mesh_lib.init_distributed("gloo", "cuda")
        rank = dist.get_rank()
        counters = {"K1": fa.flash_attention, "K2": fa.flash_attention_rope,
                    "K3a": fa.flash_attention_bwd_dkdv, "K3b": fa.flash_attention_bwd_dq}
        result = {}
        for name, fn in (("a", lambda: par_fp32_layouts(rank)),
                         ("b", lambda: par_bf16_dp(rank, counters)),
                         ("d", lambda: par_cli(rank, out)),
                         ("e", lambda: par_inference(rank, counters))):
            t0 = time.perf_counter()
            result[name] = fn()
            result[f"{name}_seconds"] = round(time.perf_counter() - t0, 1)
            log(f"rank {rank}: ({name}) {result[name + '_seconds']} s")
        with open(f"{out}/rank{rank}.json", "w") as f:
            json.dump(result, f)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    dist.destroy_process_group()


def par_nccl_world1():
    """(c) NCCL at world size 1: the DP trainer on a dp 1 mesh over NCCL, two
    bf16 steps of phase 10's batch. A mesh's axis of one rank still runs its
    all-reduce, so the trainer's bucketed gradient all-reduce passes the
    NCCL group: each step must reduce at least the model's parameter count,
    and a sum over one rank must leave every bucket as it was."""
    import tempfile

    import torch.distributed as dist

    from sam2_opt_tpu_torch.config import model_config
    from sam2_opt_tpu_torch.parallel import mesh as mesh_lib
    from sam2_opt_tpu_torch.training.trainer import Trainer

    mesh = mesh_lib.make_mesh(1, 1, backend="nccl", device="cuda")
    real = dist.all_reduce
    try:
        group = mesh.get_group("data")
        check(dist.get_backend(group) == "nccl", "the NCCL group")
        root = tempfile.mkdtemp(prefix="sam2_chip_smoke_nccl_")
        trainer = Trainer(model_config("hiera_b+"), b_plus("cuda"),
                          train_config("bfloat16", root), mesh=mesh)
        n_params = sum(p.numel() for p in trainer.model.parameters())
        calls = []

        def counted(tensor, *args, group=None, **kwargs):
            before = tensor.clone()
            work = real(tensor, *args, group=group, **kwargs)
            calls.append((dist.get_backend(group), tensor.numel(), torch.equal(before, tensor)))
            return work

        dist.all_reduce = counted
        trainer.run(lambda epoch: iter([training_video()] * 2), steps_per_epoch=2)
        torch.cuda.synchronize()
        dist.all_reduce = real
        elems = sum(n for _, n, _ in calls)
        check(np.isfinite(trainer.step_losses).all(), "the NCCL trainer's losses")
        check(calls and {b for b, _, _ in calls} == {"nccl"} and elems >= 2 * n_params
              and all(same for _, _, same in calls),
              f"the trainer's gradient all-reduce over NCCL: {len(calls)} all-reduces of "
              f"{elems} elements for 2 steps of {n_params} parameters, unchanged "
              f"{sum(same for _, _, same in calls)}")
        result = dict(loss=trainer.step_losses[0], step_ms=[1e3 * x for x in trainer.step_seconds],
                      all_reduces=len(calls), elements=elems, parameters=n_params)
        log(f"(c) NCCL world size 1: two bf16 hiera-b+ steps of Trainer.run, loss "
            f"{result['loss']:.4f}, ms per step {[round(x, 1) for x in result['step_ms']]}; "
            f"the trainer's all-reduces over NCCL: {len(calls)} of {elems} elements in all "
            f"({n_params} parameters a step, and the step's scalars), each bucket unchanged "
            "by the sum over one rank")
        del trainer
        torch.cuda.empty_cache()
        return result
    finally:
        dist.all_reduce = real
        dist.destroy_process_group()


@phase
def phase_parallel():
    """Slice 13: data and tensor parallelism. Two rank processes share the
    card over gloo and run (a), (b), (d) and (e) (`parallel_rank`); any rank
    that fails fails the phase. Then (c), NCCL at world size 1, here."""
    import importlib.util
    import socket
    import tempfile

    out = tempfile.mkdtemp(prefix="sam2_chip_smoke_parallel_")
    check(importlib.util.find_spec("PIL") is not None, "(d) needs Pillow for the PNG folder")
    from PIL import Image

    batch = training_video(T=2, S=256)
    for v in range(2):
        for t in range(2):
            for sub, arr in (("JPEGImages", batch["images"][0, t]),
                             ("Annotations", batch["masks"][0, t, v].astype(np.uint8))):
                os.makedirs(f"{out}/{sub}/video{v}", exist_ok=True)
                Image.fromarray(arr).save(f"{out}/{sub}/video{v}/{t:05d}.png")
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(PAR_RANKS):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(PAR_RANKS), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(PAR_RANKS), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), SAM2_DIST_INIT_TIMEOUT=str(PAR_TIMEOUT_S))
        logf = open(f"{out}/rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.parallel_rank(sys.argv[1])",
             out], cwd=here, env=env, stdout=logf, stderr=subprocess.STDOUT), logf))
    t0, failed = time.perf_counter(), None
    while any(p.poll() is None for p, _ in procs):
        bad = [r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
        late = time.perf_counter() - t0 > PAR_TIMEOUT_S
        if bad or late:
            failed = f"ranks {bad} failed" if bad else f"the ranks ran past {PAR_TIMEOUT_S} s"
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(1.0)
    for p, logf in procs:
        p.wait()
        logf.close()
    codes = [p.returncode for p, _ in procs]
    for rank in range(PAR_RANKS):
        with open(f"{out}/rank{rank}.log") as f:
            for line in f.read().splitlines():
                log(f"  [rank {rank}] {line}")
    check(failed is None and codes == [0] * PAR_RANKS, f"phase parallel: {failed}, exit codes "
          f"{codes}")
    ranks = []
    for rank in range(PAR_RANKS):
        with open(f"{out}/rank{rank}.json") as f:
            ranks.append(json.load(f))
    log(f"phase parallel: the two ranks took {time.perf_counter() - t0:.1f} s")
    nccl = par_nccl_world1()
    return dict(ranks=ranks, nccl=nccl)


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

    # K2's rotation alone (since slice 9) and K4's projection kernel alone
    # (since slice 10), absent from an older checkout, which --kernel-times
    # may time
    rope_rotate = getattr(flash_module, "rope_rotate", None)
    kv_proj_rotate = getattr(flash_module, "kv_proj_rotate", None)
    if argv == ["--kernel-times"]:
        # the kernel times alone (K1; K5-K8 at the window and MLP shapes; K2,
        # its rotation and K1 at D = 256 at memory attention's shapes; K4 at
        # the cross shape; K9 and K10 at the bench tool's shapes), for a
        # comparison of two checkouts of the package in one call
        label = lambda key: " ".join(str(k).replace("torch.", "") for k in key)  # noqa: E731
        k1 = phase_k1_times(flash_attention, flash_attention_ref, tiling=False)
        rows = phase_route_kernel_times()
        memory = memory_attention_times(
            {"K2": (flash_attention_rope, flash_attention_rope_ref),
             "K1 D=256": (flash_attention, flash_attention_ref)}, rope_rotate=rope_rotate,
            plain=False)
        memory_rows = {(key, *shape): row for key, by in memory.items() for shape, row in by.items()}
        k4 = phase_k4_times(flash_attention_kv_proj, flash_attention_kv_proj_ref, kv_proj_rotate)
        k4_rows = {("K4", dt, K4_CROSS): row for dt, row in k4.items()}
        tool = phase_k9_k10_times()
        # the trunk's add_layer_norm, where the checkout has it
        aln = {}
        if importlib.util.find_spec("sam2_opt_tpu_torch.kernels.add_layer_norm") is not None:
            aln = {("add_layer_norm", label): row
                   for label, row in phase_add_layer_norm()[0].items()}
        # SAM ViT-H's relative-position attention, where the checkout has it
        relpos = {}
        if hasattr(flash_module, "flash_attention_relpos"):
            relpos = {("relpos", label): row for label, row in phase_relpos().items()}
        log(json.dumps({"kernel_times": {label(k): v for k, v in {
            **k1, **rows, **memory_rows, **k4_rows, **tool, **aln, **relpos}.items()},
            "card": smi[0]}))
        return 0
    check(rope_rotate is not None, "this checkout has no rope_rotate")
    check(kv_proj_rotate is not None, "this checkout has no kv_proj_rotate")

    k1_err = phase_k1(flash_attention, flash_attention_ref)
    k2_err = phase_k2(flash_attention_rope, flash_attention_rope_ref, rope_rotate)
    k3_err = phase_k3()
    k3 = phase_k3_times()
    window_err = phase_windows()
    k8_err = phase_k8()
    aln_rows, aln_err = phase_add_layer_norm()
    phase_route_grads()
    predictor, image, image_launches, aln_launches, default_outs = phase_slice(flash_attention)
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
    counters = {"K1": flash_attention, "K2": flash_attention_rope,
                "K3a": flash_attention_bwd_dkdv, "K3b": flash_attention_bwd_dq}
    # slice 14: the input side, on the video predictor built above
    inputs = phase_inputs(video_predictor, video, points, counters)
    # slice 15: export, the native decode, profiling and the examples
    export = phase_export(video_predictor, image, video, points, inputs["jpeg_dir"], counters)
    del video_predictor
    torch.cuda.empty_cache()

    train_cpu = phase_train_vs_cpu()
    train_runs, train_launches = phase_trainer(counters)
    cli_loss = phase_train_cli()

    # slice 5
    k4_err = phase_k4(flash_attention_kv_proj, flash_attention_kv_proj_ref, kv_proj_rotate,
                      flash_module.kv_proj_rotate_ref)
    k4_grads = phase_k4_grads(flash_attention_kv_proj, flash_attention_kv_proj_ref)
    k4 = phase_k4_times(flash_attention_kv_proj, flash_attention_kv_proj_ref, kv_proj_rotate)
    k1_wide_err, k1_wide = phase_k1_wide(flash_attention, flash_attention_ref)
    route_video_launches = phase_route_video(
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

    # slice 11: speedup() as CUDA graphs, then the serving path on them
    graph_predictor, graphs = phase_graphs(flash_attention, flash_attention_rope)
    serve = phase_serve(graph_predictor)
    del graph_predictor
    torch.cuda.empty_cache()

    # slice 12: int8 and the predictor variants
    int8_predictor, int8 = phase_int8(
        {"K1": flash_attention, "K2": flash_attention_rope, "K4": flash_attention_kv_proj,
         "K8": fused_mlp})
    variants = phase_variants(int8_predictor)
    del int8_predictor
    torch.cuda.empty_cache()

    # SAM ViT-H: its attention kernel, then the model eagerly and as graphs
    relpos_rows = phase_relpos()
    sam_vit = phase_sam_vit()
    torch.cuda.empty_cache()

    # slice 13: data and tensor parallelism (two ranks on the card), last
    parallel = phase_parallel()

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
    # slice 15: per call of the exported programs, in a process that loaded them
    entries[0]["export_launches"] = {
        "set_image_e2e": export["worker"]["set_image_e2e"]["launches"]["flash_attention"]}
    entries[1]["export_launches"] = {
        "track_step": export["worker"]["track_step"]["launches"]["flash_attention_rope"],
        "track_step under SAM2_TPU_FUSED_KV_PROJ=1":
            export["worker"]["track_step_k4"]["launches"]["flash_attention_rope"]}
    # per rank and training step under bf16 DP (phase parallel (b)), and per
    # rank in its hiera-L inference (e)
    dp_runs = [r["b"]["runs"]["None"]["launches"] for r in parallel["ranks"]]
    for entry, key in zip(entries, ("K1", "K2")):
        entry["dp_inference_launches_per_rank"] = [
            {run: counts[key] for run, counts in r["e"]["launches"].items() if key in counts}
            for r in parallel["ranks"]]
    for entry, key in ((entries[0], "K1"), (entries[1], "K2")):
        entry["graph_replay_launches"] = {
            dt: {part: counts[key] for part, counts in by.items()}
            for dt, by in graphs["replay_counts"].items()}
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
    for entry, key in zip(entries, ("K1", "K2", "K3a", "K3b")):
        entry["dp_training_launches_per_rank_step"] = [run[key] // PAR_STEPS for run in dp_runs]
        # slice 14: the mp4 runs (fp32 and bf16) and the SA-V-fed steps
        entry["inputs_mp4_launches"] = {dt: c[key] for dt, c in
                                        inputs.get("mp4_launches", {}).items() if key in c}
        entry["inputs_sav_training_launches"] = inputs["sav_launches"][key]
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
    entries.append({
        "name": "add_layer_norm (the trunk's residual add + LayerNorm)",
        "route": "cuda",
        "source": "sam2_opt_tpu_torch/csrc/add_layer_norm.cu",
        "replaces": "no TPU kernel (XLA fuses the chain in the JAX package)",
        "launches": aln_launches,
        "max_abs_err": aln_err,
        **{k: v for k, v in aln_rows["L stage 3"].items() if k != "calls"},
        "dtype": "bfloat16",
        "library": "F.layer_norm (after the add for the second call), no window order",
        "shapes": aln_rows,
    })
    entries.append({
        "name": "flash_attention_relpos (SAM ViT's relative-position attention)",
        "route": "cuda",
        "source": "sam2_opt_tpu_torch/csrc/flash_attention.cu",
        "replaces": "no TPU kernel (the JAX package has no ViT)",
        "launches": sam_vit["launches"]["relpos"],
        **{k: v for k, v in relpos_rows["global"].items()},
        "dtype": "bfloat16",
        "library": "F.scaled_dot_product_attention fed the materialized bf16 bias",
        "shapes": relpos_rows,
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
        "unfused_route": "2 F.linear + K2 (unfused_ms)",
        "fp32": k4[torch.float32],
        "training_launches": k4_train_launches,
        "export_launches": {"track_step under SAM2_TPU_FUSED_KV_PROJ=1": export["worker"][
            "track_step_k4"]["launches"]["flash_attention_kv_proj"]},
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
                    "training_k4_route": k4_train,
                    "training_rope_off_route": rope_off_train,
                    "k4_gradient_errors": k4_grads,
                    "training": train_runs, "training_vs_cpu": train_cpu,
                    "training_cli_loss": cli_loss, "switches_default_launches": switch_launches,
                    "graphs": graphs, "serve": serve, "variants": variants,
                    "parallel": parallel, "inputs": inputs, "export": export,
                    "sam_vit": sam_vit,
                    "phase_seconds": PHASE_SECONDS,
                    "card": smi[0]}))
    log(json.dumps({"int8": int8, "card": smi[0]}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
