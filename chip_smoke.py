"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
1. device: the card's name and power limit;
2. build: every CUDA kernel of `sam2_opt_tpu_torch/csrc/`, compiled with nvcc;
3. K1 (flash-attention forward) against its plain PyTorch version on the
   card, in bf16 and fp32: at the hiera-L, b+ and t global-attention shapes,
   at the hiera-L shape as strided views of one qkv projection (as the
   trunk hands them over), and on a ragged masked case;
4. the slice: `build_sam2_image_predictor("hiera_l", seed=0)` at full width
   and depth at 1024², `set_image` on a 1500x2000 image and `predict` with a
   point, a box and points plus a box, multimask on and off; fp32 held
   against the same weights on the CPU (plain path), then `speedup()` to bf16
   held to the fp32 masks by mIoU; K1 must launch exactly 3 times per
   `set_image`;
5. times: set_image / predict (CUDA events, wall per call) and peak device
   memory; a torch.profiler trace of set_image split by kernel family, with
   the device's busy time and its idle share (1 - busy / wall; one stream,
   so kernels do not overlap); K1 beside its plain version, the library
   call (`F.scaled_dot_product_attention`, a yardstick the port never calls)
   and its bound.

The line before the last is a JSON object with one entry per kernel; the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
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
SEED = 0
K1_SHAPES = [  # (B, H, S, D): the global-attention blocks of hiera-L, b+ and t/s at 1024²
    (1, 8, 4096, 72),
    (1, 8, 4096, 56),
    (1, 4, 4096, 96),
]
MAIN_SHAPE = K1_SHAPES[0]
# K1 vs plain: fp32 runs true fp32 FMAs on both sides; in bf16 both take the
# same bf16 inputs, round P to bf16 and accumulate in fp32, so they differ by
# the order of the sums, P's rounding against the running (not the final)
# row max, and the output's rounding: one bf16 ulp is at most 2^-7 = 0.78% of
# |out|. Sound runs at every shape below differ by at most 9.8e-4 (one ulp
# near 0.2), so bf16 is held at 1% of |out| plus 1e-3; at the main shape a
# typical |out| is 0.02, so a P.V stage off by 10% of it fails.
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


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


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


def k1_bound_ms(B, H, Sq, Skv, D, dtype, valid_keys=None):
    """Least time for K1's work on these inputs: 4*Sq*valid_keys*D operations
    per (b, h) and each input read once, each output written once."""
    valid = B * Skv if valid_keys is None else valid_keys
    flops = 4.0 * H * Sq * valid * D
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = itemsize * B * H * D * (2 * Sq + 2 * Skv) + 4 * B * H * Sq
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
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
    return predictor, image, launches


# kernel-name patterns for the split of set_image's device time, first match wins
FAMILIES = [
    ("K1 flash_attention (csrc)", r"flash_fwd_"),
    ("convolution", r"conv|fprop|dgrad|wgrad|cudnn|implicit_gemm|winograd"),
    ("matmul", r"gemm|xmma|cutlass|cublas|nvjet|sm90_|sm80_"),
    ("softmax", r"softmax"),
    ("layer norm", r"layer_norm|LayerNorm"),
    ("resize / pool", r"upsample|interpolat|pool|bilinear|nearest"),
    ("reduction", r"reduce"),
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


def phase_times(predictor, image, flash_attention, flash_attention_ref):
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB > L2
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

    B, H, S, D = MAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    base = [torch.randn(B, H, S, D, device="cuda", generator=gen) for _ in range(3)]
    k1 = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in base)
        ms = cuda_ms(lambda: flash_attention(q, k, v), flush=flush)
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), flush=flush)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), flush=flush)
        bound_ms, bound_by = k1_bound_ms(B, H, S, S, D, dtype)
        log(f"K1 {dtype} {MAIN_SHAPE}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of bound")
        k1[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
    return times, k1


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, count {torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(smi[0])

    from sam2_opt_tpu_torch.kernels import _build
    from sam2_opt_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for lib, text in logs.items():
        regs = [line.strip() for line in text.splitlines() if "registers" in line or "spill" in line]
        log(f"  {lib}: {len(regs) // 2} kernels; " + "; ".join(sorted(set(regs))))

    max_err = phase_k1(flash_attention, flash_attention_ref)
    predictor, image, launches = phase_slice(flash_attention)
    times, k1 = phase_times(predictor, image, flash_attention, flash_attention_ref)

    main_k1 = k1[torch.bfloat16]
    entry = {
        "name": "flash_attention_fwd (K1)",
        "route": "cuda",
        "source": "sam2_opt_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sam2_opt_tpu/kernels/flash_attention.py:97",
        "launches": launches,
        "max_abs_err": max_err,
        **main_k1,
        "shape": list(MAIN_SHAPE),
        "dtype": "bfloat16",
        "fp32": k1[torch.float32],
    }
    log(json.dumps({"slice": {str(dt).replace("torch.", ""): t for dt, t in times.items()},
                    "card": smi[0]}))
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
