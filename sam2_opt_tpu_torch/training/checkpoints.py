"""Checkpoint save / load / resume of the full training state.

Counterpart of `sam2_opt_tpu/training/checkpoints.py` (reference
sam2/training/trainer.py:344-445): one `torch.save` file per step, written
to a temporary name and renamed into place (atomic), with resume discovery
and garbage collection of old steps.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch


class CheckpointManager:
    """Atomic full-train-state checkpoints `checkpoint_<step>.pt` in
    `save_dir`, keeping the newest `keep`."""

    def __init__(self, save_dir: str, keep: int = 3):
        self.save_dir = os.path.abspath(save_dir)
        self.keep = keep
        os.makedirs(self.save_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.save_dir, f"checkpoint_{step}.pt")

    def save(self, step: int, state: Dict):
        """Write to a temporary file, then rename (atomic). Saving step S
        also deletes checkpoints of later steps: after restoring an older
        step and training on, they are stale futures of the rolled-back run,
        and would both survive the step-ordered GC and mislead resume."""
        final = self._path(step)
        tmp = f"{final}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, final)
        for s in self.all_steps():
            if s > step:
                os.remove(self._path(s))
        for s in self.all_steps()[: -self.keep]:
            os.remove(self._path(s))

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.save_dir):
            m = re.fullmatch(r"checkpoint_(\d+)\.pt", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None):
        """The saved state of `step` (the latest when None), or None when
        there is no checkpoint (resume auto-discovery)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location, weights_only=True)
