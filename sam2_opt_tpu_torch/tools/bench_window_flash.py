"""Window-attention bench on the card: the port of the JAX package's
`tools/bench_window_flash.py`.

    python -m sam2_opt_tpu_torch.tools.bench_window_flash [--device cpu] [--reps N]

At each hiera-L stage's window shape (`SHAPES`, bf16 [N windows, S tokens,
heads, d], the split-qkv projection's natural layout) it runs the tool's two
kernel candidates and prints one JSON row per shape:
- K9, `window_attention_heads` (the tool's `kern_h`): heads a stride of one
  launch;
- K10, `window_attention_3d` (`kern_3d`): contiguous [N * heads, S, d]
  copies, the kernel, the copy back.
Each row has both kernels' largest error against the plain version
(`*_err`, with `*_within_bound`: inside `window_attention_bf16_bound`) and
against the tool's yardstick, the einsum path with bf16 logits (`einsum_attn`,
`*_err_vs_einsum`). On the card it also has device times in microseconds
from CUDA graph replays, L2 flushed before each: the einsum path, K9, K10
(the whole wrapper and the kernel alone), and
`F.scaled_dot_product_attention` on [N, heads, S, d] views. With `--device
cpu` the times are null: a CPU run measures no device.

The JAX tool's `bn` sweep (windows per Pallas block) has no counterpart: it
is a TPU block size, and the CUDA kernel chooses its own tiling.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sam2_opt_tpu_torch.kernels import window_attention as wa

# hiera-L @1024 window-attention shapes: (label, N windows, S tokens, heads, d)
SHAPES = [
    ("s1", 1024, 64, 2, 72),
    ("s2", 1024, 16, 4, 72),
    ("s3", 16, 256, 8, 72),
    ("s4", 16, 64, 16, 72),
]


def einsum_attn(q, k, v):
    """The tool's yardstick (the shipping einsum path): logits, scale and
    softmax in q's dtype (bf16 logits), p.v in q's dtype."""
    s = torch.einsum("nqhd,nkhd->nhqk", q, k)
    s = s * torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", p.to(v.dtype), v)


def graph_us(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of fn() in us over `reps` CUDA graph replays (no
    host launch overhead), `flush` rewritten before each so the L2 is cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return 1e3 * total / reps


def run(device: str = "cuda", reps: int = 20, seed: int = 0) -> List[dict]:
    """One row per shape of `SHAPES` (see the module docstring)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the errors alone")
    rng = np.random.default_rng(seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev) if dev.type == "cuda" else None
    rows = []
    for label, N, S, H, D in SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal((N, S, H, D)).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        ref = wa.window_attention_nshd_ref(q, k, v)
        yard = einsum_attn(q, k, v)
        bound = wa.window_attention_bf16_bound(*(t.transpose(1, 2) for t in (q, k, v)),
                                               ref.transpose(1, 2)).transpose(1, 2)
        row = {"shape": label, "N": N, "S": S, "H": H, "D": D, "device": (
            torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")}
        for name, fn in (("kern_h", wa.window_attention_heads), ("kern_3d", wa.window_attention_3d)):
            out = fn(q, k, v).float()
            err = (out - ref.float()).abs()
            row[f"{name}_err"] = err.max().item()
            row[f"{name}_within_bound"] = bool((err <= bound).all())
            row[f"{name}_err_vs_einsum"] = (out - yard.float()).abs().max().item()
        times = dict.fromkeys(("einsum_us", "kern_h_us", "kern_3d_us", "kern_3d_kernel_us",
                               "sdpa_us"))
        if dev.type == "cuda":
            flat = [t.transpose(1, 2).reshape(N * H, S, D) for t in (q, k, v)]
            out3 = torch.empty_like(flat[0])
            t = lambda x: x.transpose(1, 2)  # noqa: E731
            for key, fn in (("einsum_us", lambda: einsum_attn(q, k, v)),
                            ("kern_h_us", lambda: wa.window_attention_heads(q, k, v)),
                            ("kern_3d_us", lambda: wa.window_attention_3d(q, k, v)),
                            ("kern_3d_kernel_us", lambda: wa.launch_3d(*flat, out3)),
                            ("sdpa_us", lambda: F.scaled_dot_product_attention(t(q), t(k), t(v)))):
                times[key] = graph_us(fn, reps, flush)
        row.update(times)
        rows.append(row)
    return rows


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=20, help="graph replays per time")
    args = ap.parse_args(argv)
    rows = run(args.device, args.reps)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
