"""Checkpoint save / load / resume of the full training state, and the
parameter-pattern helpers.

Counterpart of `sam2_opt_tpu/training/checkpoints.py` (reference
sam2/training/trainer.py:344-445, utils/checkpoint_utils.py:30-99): one
`torch.save` file per step, written to a temporary name and renamed into
place (atomic), with resume discovery and garbage collection of old steps;
unix-pattern selection of parameters by their dotted names (the
reference's, so `named_parameters()` and `state_dict()` keys match the
reference's patterns as they are) and the check that frozen ones did not
move.
"""

from __future__ import annotations

import fnmatch
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch


def _named_tensors(params) -> Dict[str, torch.Tensor]:
    """{dotted name: tensor} of a module (its parameters) or a mapping
    such as a state_dict."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def _matches(name: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(name, p) for p in patterns)


def names_matching(params, patterns: Sequence[str]) -> List[str]:
    """The dotted names matching any unix pattern (reference
    checkpoint_utils.py:30-66 unix_pattern_to_parameter_names)."""
    return [n for n in _named_tensors(params) if _matches(n, patterns)]


def filter_params(params, include: Optional[Sequence[str]] = None,
                  exclude: Optional[Sequence[str]] = None) -> Dict[str, torch.Tensor]:
    """{name: tensor} after include / exclude pattern filtering (reference
    checkpoint_utils.py:68-88); no `include` keeps every name."""
    return {n: v for n, v in _named_tensors(params).items()
            if (not include or _matches(n, include)) and not (exclude and _matches(n, exclude))}


def assert_frozen_unchanged(before: Mapping[str, object], params, patterns: Sequence[str]):
    """Raise if a parameter matching `patterns` differs from its copy in
    `before` ({name: tensor or array}, e.g. `filter_params` cloned before
    training; reference assert_skipped_parameters_are_frozen,
    checkpoint_utils.py:99)."""
    def host(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    changed = [n for n, v in filter_params(params, include=patterns).items()
               if n in before and not np.array_equal(host(v), host(before[n]))]
    if changed:
        raise AssertionError(f"parameters expected frozen but changed: {changed[:5]}")


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
