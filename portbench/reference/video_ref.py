"""Plain fp32 video tracking: one session as the video predictor runs it.

The upstream predictor's semantics (sam2_video_predictor.py with
fill_hole_area=8 and click-frame masks binarized for the memory encoder,
build_sam.py:110-131), for the session the benchmark drives: every object
clicked once on frame 0, then propagated forward to the last frame. Each
object is tracked alone (batch 1), as upstream does; the memory bank keeps
the clicked frame and the last num_maskmem - 1 tracked frames, and up to
max_obj_ptrs_in_encoder object pointers, concatenated without padding.
Returns the video-resolution mask logits of every frame, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import sam2_ref as ref


def model_frames(video: np.ndarray, size: int) -> np.ndarray:
    """uint8 [T, S, S, 3]: every frame resized by OpenCV (area when
    shrinking, bilinear when enlarging), as the SAM2 video loaders read an
    array of frames."""
    import cv2

    interp = cv2.INTER_AREA if video.shape[1] > size else cv2.INTER_LINEAR
    return np.stack([cv2.resize(f, (size, size), interpolation=interp) for f in video])


class _Frame:
    def __init__(self, model, image_u8, device):
        x = torch.from_numpy(image_u8).to(device).permute(2, 0, 1)[None].float() / 255.0
        self.hrf0, self.hrf1, self.embed = model.encode(x)


def _memory(model: ref.SAM2, cfg, bank, t: int, n_frames: int):
    """(memory tokens, their positions, spatial token count) of frame t for
    one object (sam2_base.py _prepare_memory_conditioned_features)."""
    feats, pos = [], []
    # the clicked frame, then the last num_maskmem - 1 tracked frames
    slots = [(0, bank[0])] + [(k, bank.get(t - (cfg.num_maskmem - k)) if
                               t - (cfg.num_maskmem - k) >= 1 else None)
                              for k in range(1, cfg.num_maskmem)]
    g = cfg.image_embedding_size
    pe = ref.sine_pe_2d(g, g, cfg.mem_dim, bank[0]["mem"].device).reshape(g * g, cfg.mem_dim)
    for t_pos, out in slots:
        if out is None:
            continue
        feats.append(out["mem"].float().flatten(2).transpose(1, 2))
        pos.append(pe[None] + model.maskmem_tpos_enc[cfg.num_maskmem - t_pos - 1][0])
    n_spatial = sum(f.shape[1] for f in feats)
    max_ptrs = min(n_frames, cfg.max_obj_ptrs_in_encoder)
    ptr_list = [(t - 0, bank[0]["ptr"])]
    for d in range(1, max_ptrs):
        if t - d >= 1 and (t - d) in bank:
            ptr_list.append((d, bank[t - d]["ptr"]))
    tdiff = torch.tensor([p[0] for p in ptr_list], dtype=torch.float32,
                         device=feats[0].device) / max(max_ptrs - 1, 1)
    ptrs = torch.stack([p[1][0] for p in ptr_list])  # [P, C]
    ptr_pe = model.obj_ptr_tpos_proj(ref.sine_pe_1d(tdiff, cfg.hidden_dim))  # [P, mem_dim]
    split = cfg.hidden_dim // cfg.mem_dim
    ptr_tokens = ptrs.reshape(-1, split, cfg.mem_dim).reshape(1, -1, cfg.mem_dim)
    ptr_pos = ptr_pe.repeat_interleave(split, 0)[None]
    memory = torch.cat(feats + [ptr_tokens], 1)
    memory_pos = torch.cat(pos + [ptr_pos], 1)
    return memory, memory_pos, n_spatial


@torch.no_grad()
def track(model: ref.SAM2, video: np.ndarray, clicks, fill_hole_area: int, device):
    """Video-res logits [T, N, H, W] (fp32, on `device`) of a session:
    `clicks` holds one (x, y) video-pixel click per object, all on frame 0."""
    cfg = model.cfg
    T, H, W, _ = video.shape
    S = cfg.image_size
    frames = model_frames(video, S)
    g = cfg.image_embedding_size
    curr_pos = ref.sine_pe_2d(g, g, cfg.hidden_dim, device).reshape(1, g * g, cfg.hidden_dim)
    out = torch.empty(T, len(clicks), H, W, device=device)
    banks = [dict() for _ in clicks]
    f0 = _Frame(model, frames[0], device)
    feat0 = f0.embed + model.no_mem_embed[0, 0][:, None, None]
    for i, (x, y) in enumerate(clicks):
        coords = torch.tensor([[[x / W * S, y / H * S]]], dtype=torch.float32, device=device)
        labels = torch.ones(1, 1, dtype=torch.int64, device=device)
        low, _, _, ptr, obj = model.sam_heads(feat0, f0.hrf0, f0.hrf1, coords, labels,
                                              multimask_output=True)
        low = ref.fill_holes(low, fill_hole_area)
        high = ref.resize(low, (S, S))
        banks[i][0] = {"mem": model.encode_memory(f0.embed, high, obj, binarize=True), "ptr": ptr}
        out[0, i] = ref.resize(low, (H, W))[0, 0]
    pad_coords = torch.zeros(1, 1, 2, device=device)
    pad_labels = -torch.ones(1, 1, dtype=torch.int64, device=device)
    for t in range(1, T):
        f = _Frame(model, frames[t], device)
        curr = f.embed.flatten(2).transpose(1, 2)
        for i, bank in enumerate(banks):
            memory, memory_pos, n_spatial = _memory(model, cfg, bank, t, T)
            feat = model.memory_attention(curr, memory, curr_pos, memory_pos, n_spatial)
            feat = feat.transpose(1, 2).reshape(f.embed.shape)
            low, high, _, ptr, obj = model.sam_heads(feat, f.hrf0, f.hrf1, pad_coords,
                                                     pad_labels, multimask_output=True)
            bank[t] = {"mem": model.encode_memory(f.embed, high, obj, binarize=False),
                       "ptr": ptr}
            if t - cfg.max_obj_ptrs_in_encoder >= 1:
                bank.pop(t - cfg.max_obj_ptrs_in_encoder)
            out[t, i] = ref.resize(ref.fill_holes(low, fill_hole_area), (H, W))[0, 0]
    return out
