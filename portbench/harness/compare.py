"""The comparison that decides `correct`, and the sample it compares.

Each number is the worst over the compared outputs (a frame of an object,
a mask of a prompt); the cell's traffic file gives the limit of each number
it compares, and the rest are printed for the record:
- `logit_rms`: root-mean-square logit difference over the reference's
  root-mean-square logit;
- `logit_rms_of_max`: root-mean-square logit difference over the
  reference's largest |logit|;
- `sign_flip_share`: share of pixels whose logit sign differs;
- `mask_flip_share`, `iou_gap`, `stability_margin` (image cells): share of
  the full-resolution mask's pixels that differ; the largest IoU
  difference; the smallest distance of the reference's single-mask
  stability from its threshold.
"""

from __future__ import annotations

import heapq
from typing import Dict, List

import numpy as np
import torch


def seed_key(seed: int, stream: int, index: int) -> int:
    """A 63-bit integer drawn from (seed, stream, index)."""
    return int(np.random.SeedSequence([int(seed) % (1 << 63), stream, index])
               .generate_state(1, np.uint64)[0] >> 1)


class Sample:
    """Keeps the outputs of finished units that can still be in the sample:
    the longest (first of equals) and the `n - 1` others with the highest
    keys drawn from the seed. `pick()` gives the sample's unit indices;
    `wants()` says, before a unit runs, whether it could still be picked (a
    unit it refuses need not be offered)."""

    def __init__(self, seed: int, n: int):
        self.seed, self.n = seed, max(int(n), 1)
        self.kept: Dict[int, object] = {}
        self.size: Dict[int, int] = {}

    def offer(self, index: int, size: int, outputs):
        self.size[index] = size
        self.kept[index] = outputs
        keep = set(self.pick())
        keep.update(heapq.nlargest(self.n, self.kept, key=lambda i: seed_key(self.seed, 7, i)))
        for i in list(self.kept):
            if i not in keep:
                del self.kept[i]

    def wants(self, index: int, size: int) -> bool:
        if not self.size or size > max(self.size.values()):
            return True
        keys = sorted((seed_key(self.seed, 7, i) for i in self.kept), reverse=True)
        return len(keys) < self.n or seed_key(self.seed, 7, index) > keys[self.n - 1]

    def pick(self) -> List[int]:
        if not self.size:
            return []
        longest = min(self.size, key=lambda i: (-self.size[i], i))
        rest = [i for i in self.kept if i != longest]
        return [longest] + heapq.nlargest(self.n - 1, rest, key=lambda i: seed_key(self.seed, 7, i))


class Readings:
    """The comparison numbers: running maxima over the compared outputs,
    and the outputs that set them (printed for the record)."""

    def __init__(self):
        self.values: Dict[str, float] = {}
        self.worst: Dict[str, str] = {}

    def update(self, name: str, value: float, label: str = ""):
        value = float(value)
        if value > self.values.get(name, float("-inf")):
            self.values[name] = value
            self.worst[name] = label

    def least(self, name: str, value: float, label: str = ""):
        """Running minimum (a margin: the smaller, the nearer a tie)."""
        value = float(value)
        if value < self.values.get(name, float("inf")):
            self.values[name] = value
            self.worst[name] = label

    def logits(self, program: torch.Tensor, reference: torch.Tensor, label: str = ""):
        """One output, [..., H, W] logits of the two sides on one device."""
        p, r = program.double(), reference.double()
        d = p - r
        d2, r2 = d.pow(2).sum().item(), r.pow(2).sum().item()
        n = r.numel()
        rms = (d2 / max(r2, 1e-300)) ** 0.5
        tag = (f"{label} rms {rms:.4g} program [{p.min().item():.4g}, {p.max().item():.4g}] "
               f"reference [{r.min().item():.4g}, {r.max().item():.4g}]")
        self.update("logit_rms", rms, tag)
        self.update("logit_rms_of_max", (d2 / n) ** 0.5 / max(r.abs().max().item(), 1e-12), tag)
        self.update("sign_flip_share", ((p > 0) != (r > 0)).sum().item() / n, tag)
