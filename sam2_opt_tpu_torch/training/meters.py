"""Training meters (re-design of sam2/training/utils/train_utils.py:47-260);
counterpart of `sam2_opt_tpu/training/meters.py`."""

from __future__ import annotations

import time
from typing import Optional

import torch


class Phase:
    TRAIN = "train"
    VAL = "val"


class AverageMeter:
    """Running average (reference train_utils.py:158)."""

    def __init__(self, name: str, device: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class DurationMeter:
    """Wall-clock duration accumulator (reference train_utils.py:232)."""

    def __init__(self, name: str, device: str = "", fmt: str = ":f"):
        self.name = name
        self.val = 0.0
        self._start: Optional[float] = None

    def reset(self):
        self.val = 0.0

    def start(self):
        self._start = time.time()

    def stop(self):
        if self._start is not None:
            self.val += time.time() - self._start
            self._start = None

    def update(self, seconds: float):
        self.val = seconds

    def add(self, seconds: float):
        self.val += seconds

    def __str__(self):
        return f"{self.name}: {human_readable_time(self.val)}"


class MemMeter:
    """Device-memory meter (reference train_utils.py:185): the CUDA
    allocator's current and peak bytes, in GiB; stays at 0 without a card."""

    def __init__(self, name: str, device: str = "", fmt: str = ":f"):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.peak = 0.0

    def update(self, reset_peak_usage: bool = False, n: int = 1):
        if not torch.cuda.is_available():
            return
        self.val = torch.cuda.memory_allocated() / 2 ** 30
        self.peak = max(self.peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        if reset_peak_usage:
            torch.cuda.reset_peak_memory_stats()

    def __str__(self):
        return f"{self.name}: {self.val:.2f} GiB (peak {self.peak:.2f})"


class ProgressMeter:
    """reference train_utils.py:246."""

    def __init__(self, num_batches: int, meters, real_meters=None, prefix: str = ""):
        self.num_batches = num_batches
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        fmt = "{:" + str(len(str(self.num_batches))) + "d}"
        entries = [self.prefix + fmt.format(batch) + f"/{self.num_batches}"]
        entries += [str(m) for m in self.meters]
        print("  ".join(entries), flush=True)


def human_readable_time(seconds: float) -> str:
    seconds = int(seconds)
    days = seconds // 86400
    hours = (seconds // 3600) % 24
    minutes = (seconds // 60) % 60
    return f"{days:02}d {hours:02}h {minutes:02}m {seconds % 60:02}s"
