"""Model checkpoints in the port's own format, and their CLI (counterpart of
`sam2_opt_tpu/io/checkpoints.py`, whose format is an orbax directory).

The native format is one `torch.save` file of the model's state_dict under
the reference's dotted names, in the port's layouts and dtypes (an int8
model's quantized layers stay int8), written to a temporary name and
renamed into place. A reference checkpoint (`sam2.1_hiera_*.pt`, its
state_dict under "model") converts to it once:

    python -m sam2_opt_tpu_torch.io.checkpoints convert sam2.1_hiera_large.pt large.pth
    python -m sam2_opt_tpu_torch.io.checkpoints inspect large.pth
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import torch

# a native file's state_dict as saved (a reference `.pt`: its "model" entry,
# as fp32), on the CPU
from sam2_opt_tpu_torch.io.weights import load_checkpoint as load_params


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write `state_dict` (on the CPU) to `path` atomically: a temporary
    file in the same directory, then a rename."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def convert_pt_to_native(pt_path: str, out_path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pt` checkpoint -> a native file (fp32); returns the
    state_dict."""
    state_dict = load_params(pt_path)
    save_params(out_path, state_dict)
    return state_dict


def build_from_any(variant_or_yaml: str, checkpoint: Optional[str] = None, seed: int = 0,
                   device=None):
    """A SAM2Model of a variant name, reference config name or yaml path,
    with the weights of `checkpoint` (a reference `.pt` or a native file;
    `load_params` reads both), random from `seed`
    without one: `build_sam.build_sam2` under the JAX package's name."""
    from sam2_opt_tpu_torch.build_sam import build_sam2

    return build_sam2(variant_or_yaml, checkpoint, seed=seed, device=device)


def _count(state_dict) -> int:
    return sum(v.numel() for v in state_dict.values())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("convert", "inspect") or len(argv) < {"convert": 3,
                                                                          "inspect": 2}[argv[0]]:
        print(__doc__)
        return 1
    if argv[0] == "convert":
        state_dict = convert_pt_to_native(argv[1], argv[2])
        print(f"converted {argv[1]} -> {argv[2]} ({_count(state_dict) / 1e6:.1f}M params)")
    else:
        state_dict = load_params(argv[1])
        for name, value in list(state_dict.items())[:20]:
            print(f"{name}: {tuple(value.shape)} {value.dtype}")
        print(f"... {len(state_dict)} tensors, {_count(state_dict) / 1e6:.1f}M params")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
