"""Connected components and hole filling, plain torch.

Counterpart of `sam2_opt_tpu/ops/connected_components.py`, which replaces
the reference's CUDA union-find (sam2/csrc/connected_components.cu) with
bounded min-label propagation:

    each sweep = 8-neighbour min -> segmented row cummin -> segmented column cummin

`num_iters` sweeps give correct labels for any component whose shortest
internal path has at most `num_iters` direction changes; hole filling only
needs tiny components (area <= 8 in the video predictor). This is the same
algorithm, not an exact union-find, so labels and areas equal the JAX
package's exactly. Each segmented cummin is one `torch.cummin` over int64
labels offset per run, so the running min restarts at every run start.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_INF = 2 ** 30
_RUN_OFFSET = 2 ** 31  # > any label, so an earlier run never wins the min


def _run_offsets(mask, dim: int):
    """Offsets for the segmented cummins along `dim`, forward and backward
    (the backward one on the flipped axis): a run starts wherever the
    previous pixel is outside the mask or the pixel itself is, and run r's
    labels are shifted down by r * 2^31, below every earlier run's, so one
    cummin over the shifted labels never reaches back past a run start. The
    mask does not change between sweeps, so these are computed once."""
    n = mask.shape[dim]
    first = (torch.arange(n, device=mask.device) == 0).view(
        [n if d == dim % mask.ndim else 1 for d in range(mask.ndim)])

    def offsets(m):
        starts = ~torch.roll(m, 1, dims=dim) | first | ~m
        return torch.cumsum(starts, dim=dim, dtype=torch.int64) * _RUN_OFFSET

    return offsets(mask), offsets(mask.flip(dim))


def _row_col_pass(labels, mask, dim: int, offsets):
    """Propagate min labels along one axis within contiguous mask runs, both
    ways (the backward scan is the forward one on the flipped axis)."""
    fwd, bwd = offsets
    labels = torch.cummin(labels - fwd, dim=dim).values + fwd
    labels = (torch.cummin(labels.flip(dim) - bwd, dim=dim).values + bwd).flip(dim)
    return torch.where(mask, labels, _INF)


def _neighbor_min(labels, mask):
    """One 8-connectivity min step (seeds diagonal propagation)."""
    H, W = labels.shape[-2:]
    padded = F.pad(labels, (1, 1, 1, 1), value=_INF)
    best = labels
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                best = torch.minimum(best, padded[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return torch.where(mask, best, _INF)


def connected_components(mask, num_iters: int = 16):
    """8-connectivity labels and areas for a batch of binary masks.

    mask [B, H, W] bool. Returns (labels [B,H,W] int32, 0 = background and
    1..N component ids; areas [B,H,W] int32, the area of each pixel's
    component), the CUDA kernel's output contract (connected_components.cu:213).
    """
    B, H, W = mask.shape
    ids = torch.arange(H * W, dtype=torch.int64, device=mask.device).view(1, H, W)
    labels = torch.where(mask, ids, _INF)
    rows, cols = _run_offsets(mask, -1), _run_offsets(mask, -2)
    for _ in range(num_iters):
        labels = _neighbor_min(labels, mask)
        labels = _row_col_pass(labels, mask, -1, rows)
        labels = _row_col_pass(labels, mask, -2, cols)
    flat = torch.where(mask, labels, 0).view(B, H * W)
    counts = torch.zeros(B, H * W, dtype=torch.int32, device=mask.device)
    counts.scatter_add_(1, flat, mask.view(B, H * W).int())
    areas = torch.where(mask, counts.gather(1, flat).view(B, H, W), 0)
    return torch.where(mask, labels + 1, 0).int(), areas


def fill_holes_and_sprinkles(masks, mask_threshold: float, max_hole_area: float,
                             max_sprinkle_area: float, num_iters: int = 16):
    """Reference postprocess semantics (utils/transforms.py:86-106): holes are
    small background components (raised to threshold + 10), sprinkles small
    foreground components (lowered to threshold - 10). Both component maps
    come from the original logits. masks [..., H, W]."""
    shape = masks.shape
    orig = masks.reshape(-1, shape[-2], shape[-1])
    out = orig
    if max_hole_area > 0:
        labels, areas = connected_components(orig <= mask_threshold, num_iters)
        out = torch.where((labels > 0) & (areas <= max_hole_area), mask_threshold + 10.0, out)
    if max_sprinkle_area > 0:
        labels, areas = connected_components(orig > mask_threshold, num_iters)
        out = torch.where((labels > 0) & (areas <= max_sprinkle_area), mask_threshold - 10.0,
                          out)
    return out.reshape(shape)


def fill_holes_in_mask_scores(mask, max_area: int, num_iters: int = 16):
    """Reference utils/misc.py:312-337: holes (background components of area
    <= max_area) get the small positive score 0.1. mask [..., H, W] logits."""
    if max_area <= 0:
        return mask
    shape = mask.shape
    flat = mask.reshape(-1, shape[-2], shape[-1])
    labels, areas = connected_components(flat <= 0, num_iters)
    return torch.where((labels > 0) & (areas <= max_area), 0.1, flat).reshape(shape)
