"""Video predictor variant tracks; counterpart of
`sam2_opt_tpu/predictors/variants.py`.

The reference ships three tracker tracks selected by the SAM2_VERSION_TRACK
env var (sam2/sam2/sam2_video_predictor.py:4-18, modeling/sam2_base.py:6-17):

  "official" (default): per-object independent tracking, post-12/2024 API
  "dam4sam": distractor-aware memory
  plus the pre-12/2024 "legacy" class kept for backward compatibility.

Here:
- SAM2VideoPredictor (official) is the full track;
- SAM2VideoPredictorVOS subclasses it: in the reference this variant
  torch.compile's the submodules (sam2_video_predictor_official.py:1082-1329);
  `speedup()` already runs every seam as a CUDA graph, so the subclass turns
  it on at construction;
- SAM2VideoPredictorDAM4SAM is the distractor-aware memory track (reference
  sam2_video_predictor_dam4sam.py + modeling/sam2_base_dam4sam.py): the
  memory bank split into a DRM part (distractor-resolving memory:
  conditioning frames, and frames promoted by `add_to_drm`) and a RAM part
  (recent-appearance memory: the latest frames where the target is visible,
  walking back past occlusions), plus the multimask and IoU extras for the
  caller's distractor analysis;
- SAM2VideoPredictorLegacy enforces the pre-12/2024 API contract (no new
  objects after tracking starts, a warning for a box after the start) on the
  modern engine (superseded per RELEASE_NOTES.md:10-13).
"""

from __future__ import annotations

import os

import numpy as np

from sam2_opt_tpu_torch.models import video_core as vc
from sam2_opt_tpu_torch.predictors.video import SAM2VideoPredictor, _select_closest_cond_frames


class SAM2VideoPredictorVOS(SAM2VideoPredictor):
    """VOS-optimized variant: everything on CUDA graphs from the start (the
    reference torch.compile's the memory encoder and attention, the prompt
    encoder and the mask decoder, sam2_video_predictor_official.py:1089-1117;
    `speedup()` is that here)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.speedup()


class SAM2VideoPredictorLegacy(SAM2VideoPredictor):
    """Pre-12/2024 API contract (reference sam2_video_predictor_legacy.py),
    superseded by the official track (RELEASE_NOTES.md:10-13), on top of the
    modern engine:

    - new objects cannot be added after tracking starts
      (`tracking_has_started`, reference legacy :107,138-162); the official
      track allows it, legacy raises with the reference's message;
    - adding a box after tracking starts warns (reference legacy :216-224);
    - `reset_state` clears the tracking-started flag (reference :848-877).

    The per-object storage of the modern engine is kept (the legacy shared
    batched output_dict is not part of the public API).
    """

    def init_state(self, *args, **kwargs):
        state = super().init_state(*args, **kwargs)
        state["tracking_has_started"] = False
        return state

    def _obj_id_to_idx(self, inference_state, obj_id):
        obj_idx = inference_state["obj_id_to_idx"].get(obj_id)
        if obj_idx is None and inference_state.get("tracking_has_started"):
            raise RuntimeError(
                f"Cannot add new object id {obj_id} after tracking starts. "
                f"All existing object ids: {inference_state['obj_ids']}. "
                "Please call 'reset_state' to restart from scratch."
            )
        return super()._obj_id_to_idx(inference_state, obj_id)

    def add_new_points_or_box(self, inference_state, frame_idx, obj_id, points=None,
                              labels=None, clear_old_points=True, normalize_coords=True,
                              box=None):
        if box is not None and inference_state.get("tracking_has_started"):
            import warnings

            warnings.warn(
                "You are adding a box after tracking starts. SAM 2 may not "
                "always be able to incorporate a box prompt for *refinement*. "
                "If you intend to use box prompt as an *initial* input before "
                "tracking, please call 'reset_state' on the inference state "
                "to restart from scratch.",
                category=UserWarning,
                stacklevel=2,
            )
        return super().add_new_points_or_box(
            inference_state, frame_idx, obj_id, points=points, labels=labels,
            clear_old_points=clear_old_points, normalize_coords=normalize_coords, box=box)

    def propagate_in_video_preflight(self, inference_state):
        # the reference locks new objects at preflight (legacy :593-596),
        # which propagate_in_video also calls: both entry points lock
        inference_state["tracking_has_started"] = True
        return super().propagate_in_video_preflight(inference_state)

    def propagate_in_video(self, inference_state, *args, **kwargs):
        inference_state["tracking_has_started"] = True
        if not any(
            obj_out["cond_frame_outputs"] or obj_out["non_cond_frame_outputs"]
            for obj_out in inference_state["output_dict_per_obj"].values()
        ) and not any(
            inference_state["point_inputs_per_obj"].get(i)
            or inference_state["mask_inputs_per_obj"].get(i)
            for i in inference_state["obj_id_to_idx"].values()
        ):
            raise RuntimeError("No points are provided; please add points first")
        return super().propagate_in_video(inference_state, *args, **kwargs)

    def reset_state(self, inference_state):
        super().reset_state(inference_state)
        inference_state["tracking_has_started"] = False


class SAM2VideoPredictorDAM4SAM(SAM2VideoPredictor):
    """DAM4SAM distractor-aware track (reference
    sam2_video_predictor_dam4sam.py + modeling/sam2_base_dam4sam.py).

    Its differences from the official track are on the host; the tracking
    step is the same fixed-capacity masked graph:

    - per-frame outputs record `n_pixels_pos` (target visibility) and the
      multimask `all_pred_masks` / `ious` extras (reference
      sam2_base_dam4sam.py:447-501, predictor :1175);
    - memory selection (reference sam2_base_dam4sam.py:617-710): the DRM
      part is the selected conditioning frames (t_pos 0), the RAM part the
      most recent visible frames, walking back past frames where the target
      disappeared (n_pixels_pos < 1), the stride walk anchored at the RAM
      frame selected before; object pointers only from visible frames, with
      unsigned temporal distances;
    - `add_to_drm(state, frame_idx, obj_id)` promotes an already-tracked
      frame into the DRM (conditioning) part (reference :434-466), when the
      caller's distractor analysis decides to;
    - `propagate_in_video(..., return_all_masks=True)` yields a 4-tuple
      with `(all_masks, all_ious)` extras (reference :837-941).
    """

    keep_multimasks = True

    def _compact_output(self, out, pred_masks):
        compact = super()._compact_output(out, pred_masks)
        compact["ious"] = out.get("ious")
        if "all_pred_masks" in out:
            compact["all_pred_masks"] = out["all_pred_masks"]
        # the visibility count on the host (reference :1175)
        compact["n_pixels_pos"] = int((pred_masks[0, 0] > 0).sum())
        return compact

    @staticmethod
    def _visible(out) -> bool:
        return out is not None and out.get("n_pixels_pos", 1) >= 1

    def _gather_memory(self, inference_state, output_dict, frame_idx, reverse):
        """DRM/RAM memory selection (reference sam2_base_dam4sam.py:617-710),
        the JAX package's arithmetic. Returns a vc.MemoryInput. DRM frames
        take enumeration slot 0; RAM frames are sorted by frame index and
        enumerated after them, so the temporal embedding index is
        `total - t_pos - 1` with `total` the padded slot count.

        Two reference quirks are kept on purpose (the JAX package holds
        them against the reference in tests/test_dam4sam_parity.py):
        - the RAM walk only looks backward in time whatever `reverse` says
          (reference :640-676; only the pointer windows honour it, :720-732);
        - a RAM entry at frame 0 shares sort key 0 with the DRM entries, and
          walked-off (None) entries still take enumeration slots (reference
          :684-694)."""
        cfg = self.cfg
        num_frames = inference_state["num_frames"]
        cond_outputs = output_dict["cond_frame_outputs"]
        non_cond = output_dict["non_cond_frame_outputs"]
        selected_cond, unselected_cond = _select_closest_cond_frames(
            frame_idx, cond_outputs, cfg.max_cond_frames_in_attn)
        # DRM part: (sort key 0, out)
        t_pos_and_prevs = [(0, out) for out in selected_cond.values()]

        def walk_back(idx, step):
            """The first visible non-DRM frame stepping back from idx by step."""
            while True:
                idx -= step
                if idx <= 0:
                    return idx, None
                out = non_cond.get(idx)
                if self._visible(out) and idx not in selected_cond:
                    return idx, out

        # RAM part: the most recent frames with the target visible
        r = cfg.memory_temporal_stride_for_eval
        n_ram = cfg.num_maskmem - 1 - (len(t_pos_and_prevs) - 1)
        prev_frame_idx = None
        for i in range(max(n_ram, 0)):
            if i == 0:
                prev_frame_idx = frame_idx - 1
                out = (cond_outputs.get(prev_frame_idx) if prev_frame_idx in cond_outputs
                       else non_cond.get(prev_frame_idx))
                if not self._visible(out) or prev_frame_idx in selected_cond:
                    prev_frame_idx, out = walk_back(prev_frame_idx, 1)
            elif prev_frame_idx >= 0:
                prev_frame_idx = ((prev_frame_idx - 1) // r) * r
                out = non_cond.get(prev_frame_idx)
                if not self._visible(out) or prev_frame_idx in selected_cond:
                    prev_frame_idx, out = walk_back(prev_frame_idx, r)
            else:
                out = None
            t_pos_and_prevs.append((prev_frame_idx, out))
        # sort: DRM (key 0) first, RAM by frame index; then enumerate: DRM
        # entries keep t_pos 0, RAM entries take their position
        t_pos_and_prevs = sorted(t_pos_and_prevs, key=lambda x: x[0])
        t_pos_and_prevs = [(0, prev) if t_pos == 0 else (idx, prev)
                           for idx, (t_pos, prev) in enumerate(t_pos_and_prevs)]
        total = len(t_pos_and_prevs)
        feats_list, tpos_list = [], []
        for t_pos, prev in t_pos_and_prevs:
            if prev is not None:
                feats_list.append(prev["maskmem_features"])
                tpos_list.append(total - t_pos - 1)

        cap = max(cfg.num_maskmem, len(feats_list))
        tpos_idx = np.zeros((cap,), np.int32)
        valid = np.zeros((cap,), bool)
        tpos_idx[:len(tpos_list)] = [min(t, cfg.num_maskmem - 1) for t in tpos_list]
        valid[:len(feats_list)] = True
        zero_slot = self._zero_mem_slot()
        mem_feats = tuple(feats_list[i] if i < len(feats_list) else zero_slot
                          for i in range(cap))

        # object pointers: unsigned distances, visible frames only
        # (reference sam2_base_dam4sam.py:712-741)
        ptrs_list, pos_list = [], []
        if cfg.use_obj_ptrs_in_encoder:
            max_obj_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
            ptr_cond = ({t: out for t, out in selected_cond.items()
                         if (t >= frame_idx if reverse else t <= frame_idx)}
                        if cfg.only_obj_ptrs_in_the_past_for_eval else selected_cond)
            for t, out in ptr_cond.items():
                pos_list.append(abs(frame_idx - t))
                ptrs_list.append(out["obj_ptr"])
            for t_diff in range(1, max_obj_ptrs):
                t = frame_idx + t_diff if reverse else frame_idx - t_diff
                if t < 0 or t >= num_frames:
                    break
                out = non_cond.get(t, unselected_cond.get(t))
                if self._visible(out):
                    pos_list.append(t_diff)
                    ptrs_list.append(out["obj_ptr"])
            t_diff_max = max(max_obj_ptrs - 1, 1)
        else:
            t_diff_max = 1
        # no total pointer cap in the reference (DRM pointers plus up to
        # max_obj_ptrs - 1 RAM pointers, :713-745): grow the capacity in
        # steps of 8 instead of truncating
        ptr_cap = cfg.max_obj_ptrs_in_encoder
        if len(ptrs_list) > ptr_cap:
            ptr_cap = -(-len(ptrs_list) // 8) * 8
        ptr_pos = np.zeros((ptr_cap,), np.float32)
        ptr_valid = np.zeros((ptr_cap,), bool)
        ptr_pos[:len(pos_list)] = [pp / t_diff_max for pp in pos_list]
        ptr_valid[:len(ptrs_list)] = True
        zero_ptr = self._zero_ptr_slot()
        ptrs = tuple(ptrs_list[i] if i < len(ptrs_list) else zero_ptr for i in range(ptr_cap))
        return vc.MemoryInput(feats=mem_feats, tpos_idx=tpos_idx[None], valid=valid[None],
                              ptrs=ptrs, ptr_pos=ptr_pos[None], ptr_valid=ptr_valid[None])

    def reset_state(self, inference_state):
        super().reset_state(inference_state)
        # the reference clears the DRM-promotion bookkeeping on reset
        # (sam2_video_predictor_dam4sam.py:1057,1071)
        inference_state.get("adds_in_drm_per_obj", {}).clear()

    def add_to_drm(self, inference_state, frame_idx, obj_id):
        """Promote an already-tracked frame into the DRM (conditioning) part
        of the memory (reference :434-466): its stored output becomes a
        conditioning frame at the next preflight, which encodes its memory
        again from the binarized mask, as the reference's
        `_consolidate_temp_output_across_obj(run_mem_encoder=True)` does
        (sam2_video_predictor_dam4sam.py:704-723)."""
        obj_idx = self._obj_id_to_idx(inference_state, obj_id)
        inference_state["mask_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        inference_state.setdefault("adds_in_drm_per_obj", {}).setdefault(
            obj_idx, []).append(frame_idx)
        obj_out = inference_state["output_dict_per_obj"][obj_idx]
        out = obj_out["non_cond_frame_outputs"].get(frame_idx)
        if out is None:
            out = obj_out["cond_frame_outputs"].get(frame_idx)
        if out is None:
            raise RuntimeError(f"frame {frame_idx} has no tracked output for object "
                               f"{obj_id}; run propagate_in_video past it first")
        out = dict(out)
        out["maskmem_features"] = None
        inference_state["temp_output_dict_per_obj"][obj_idx]["cond_frame_outputs"][
            frame_idx] = out
        return self._video_res_frame(inference_state, frame_idx, "cond_frame_outputs")

    def propagate_in_video(self, inference_state, start_frame_idx=None,
                           max_frame_num_to_track=None, reverse=False, return_all_masks=False):
        """Generator; with return_all_masks=True yields (frame_idx, obj_ids,
        video_res_masks, (all_masks, all_ious)) (reference :837-941)."""
        gen = super().propagate_in_video(inference_state, start_frame_idx,
                                         max_frame_num_to_track, reverse)
        for frame_idx, obj_ids, video_res_masks in gen:
            if not return_all_masks:
                yield frame_idx, obj_ids, video_res_masks
                continue
            yield (frame_idx, obj_ids, video_res_masks,
                   self._collect_all_masks(inference_state, frame_idx))

    def _collect_all_masks(self, inference_state, frame_idx):
        """Video-res multimask slots and IoUs of the first object's output
        on this frame (DAM4SAM tracks one object in practice)."""
        obj_out = inference_state["output_dict_per_obj"][0]
        out = obj_out["non_cond_frame_outputs"].get(
            frame_idx, obj_out["cond_frame_outputs"].get(frame_idx))
        if out is None or out.get("all_pred_masks") is None:
            return [], np.zeros((0,), np.float32)
        all_mm = out["all_pred_masks"]  # [1, M, S/4, S/4]
        all_masks = [self._get_orig_video_res_output(inference_state, all_mm[:, m:m + 1])[1]
                     for m in range(all_mm.shape[1])]
        ious = (out["ious"][0].cpu().numpy() if out.get("ious") is not None
                else np.zeros((all_mm.shape[1],), np.float32))
        return all_masks, ious


def select_video_predictor_cls():
    """The track named by SAM2_VERSION_TRACK (reference
    sam2_video_predictor.py:4-8)."""
    track = os.environ.get("SAM2_VERSION_TRACK", "official").lower()
    if track in ("official", ""):
        return SAM2VideoPredictor
    if track == "dam4sam":
        return SAM2VideoPredictorDAM4SAM
    if track == "legacy":
        return SAM2VideoPredictorLegacy
    raise ValueError(f"unknown SAM2_VERSION_TRACK={track!r}")
