"""SAM2VideoPredictor — the reference API
(sam2/sam2/sam2_video_predictor_official.py:20-1080) on PyTorch; counterpart
of `sam2_opt_tpu/predictors/video.py`.

The inference state mirrors the reference's `inference_state` dicts (per
object, conditioning and non-conditioning frame outputs); its tensors live
on the model's device: low-res masks in fp32, memory features in bf16. Per
tracked frame the predictor encodes the frame (`SAM2Model.encode_image`),
gathers a fixed-capacity memory on the host and runs one tracking step of
`models/video_core.py` on `model._m`; objects tracked together run as one
batch, so each memory-attention call is one K2 launch with B = objects.
Outputs are torch tensors on the model's device, as in the reference.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from sam2_opt_tpu_torch.config import SAM2Config
from sam2_opt_tpu_torch.io.video import load_video_frames
from sam2_opt_tpu_torch.models import sam2_base as base
from sam2_opt_tpu_torch.models import video_core as vc
from sam2_opt_tpu_torch.models.model import SAM2Model
from sam2_opt_tpu_torch.ops.connected_components import fill_holes_in_mask_scores
from sam2_opt_tpu_torch.utils.misc import concat_points

NO_OBJ_SCORE = base.NO_OBJ_SCORE


def _select_closest_cond_frames(frame_idx, cond_frame_outputs, max_cond_frame_num):
    """reference sam2_utils.select_closest_cond_frames (sam2_utils.py:19-61)."""
    if max_cond_frame_num == -1 or len(cond_frame_outputs) <= max_cond_frame_num:
        return cond_frame_outputs, {}
    assert max_cond_frame_num >= 2
    selected = {}
    idx_before = max((t for t in cond_frame_outputs if t < frame_idx), default=None)
    if idx_before is not None:
        selected[idx_before] = cond_frame_outputs[idx_before]
    idx_after = min((t for t in cond_frame_outputs if t >= frame_idx), default=None)
    if idx_after is not None:
        selected[idx_after] = cond_frame_outputs[idx_after]
    num_remain = max_cond_frame_num - len(selected)
    inds_remain = sorted((t for t in cond_frame_outputs if t not in selected),
                         key=lambda x: abs(x - frame_idx))[:num_remain]
    selected.update((t, cond_frame_outputs[t]) for t in inds_remain)
    unselected = {t: v for t, v in cond_frame_outputs.items() if t not in selected}
    return selected, unselected


class SAM2VideoPredictor:
    def __init__(self, sam_model: SAM2Model, fill_hole_area: int = 8,
                 non_overlap_masks: bool = False, clear_non_cond_mem_around_input: bool = False,
                 add_all_frames_to_correct_as_cond: bool = False):
        self.model = sam_model
        self.fill_hole_area = fill_hole_area
        self.non_overlap_masks = non_overlap_masks
        self.clear_non_cond_mem_around_input = clear_non_cond_mem_around_input
        self.add_all_frames_to_correct_as_cond = add_all_frames_to_correct_as_cond
        # video predictors binarize click-frame masks for the memory encoder
        # (reference build_sam.py:110-131 override)
        self.cfg: SAM2Config = dataclasses.replace(sam_model.cfg,
                                                   binarize_mask_from_pts_for_mem_enc=True)
        self._zero_mem = self._zero_ptr = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def image_size(self) -> int:
        return self.cfg.image_size

    @property
    def num_maskmem(self) -> int:
        return self.cfg.num_maskmem

    @property
    def memory_temporal_stride_for_eval(self) -> int:
        return self.cfg.memory_temporal_stride_for_eval

    def speedup(self, backend: str = "cuda"):
        """One-line acceleration: bf16 compute. "int8" raises
        NotImplementedError."""
        self.model.speedup(backend)

    def set_runtime_backend(self, backend: str = "eager"):
        self.model.set_runtime_backend(backend)

    def release(self):
        self.model.set_runtime_backend("eager")

    # state

    @torch.inference_mode()
    def init_state(self, video_path, offload_video_to_cpu: bool = False,
                   offload_state_to_cpu: bool = False, async_loading_frames: bool = False):
        """Initialize an inference state (reference :147-205)."""
        if offload_state_to_cpu or async_loading_frames:
            raise NotImplementedError("offload_state_to_cpu and async_loading_frames are not "
                                      "ported; see ROADMAP.md")
        frames, video_height, video_width = load_video_frames(
            video_path, self.image_size, offload_video_to_cpu, device=self.device)
        inference_state = {
            "images": frames,
            "num_frames": len(frames),
            "offload_video_to_cpu": offload_video_to_cpu,
            "offload_state_to_cpu": offload_state_to_cpu,
            "video_height": video_height,
            "video_width": video_width,
            "device": self.device,
            "point_inputs_per_obj": {},
            "mask_inputs_per_obj": {},
            "cached_features": {},
            "constants": {},
            "obj_id_to_idx": OrderedDict(),
            "obj_idx_to_id": OrderedDict(),
            "obj_ids": [],
            "output_dict_per_obj": {},
            "temp_output_dict_per_obj": {},
            "frames_tracked_per_obj": {},
        }
        # warm up the backbone and cache frame 0's features (:204)
        self._get_image_feature(inference_state, frame_idx=0)
        return inference_state

    # object bookkeeping (reference :224-264)

    def _obj_id_to_idx(self, inference_state, obj_id):
        obj_idx = inference_state["obj_id_to_idx"].get(obj_id, None)
        if obj_idx is not None:
            return obj_idx
        obj_idx = len(inference_state["obj_id_to_idx"])
        inference_state["obj_id_to_idx"][obj_id] = obj_idx
        inference_state["obj_idx_to_id"][obj_idx] = obj_id
        inference_state["obj_ids"] = list(inference_state["obj_id_to_idx"])
        inference_state["point_inputs_per_obj"][obj_idx] = {}
        inference_state["mask_inputs_per_obj"][obj_idx] = {}
        for key in ("output_dict_per_obj", "temp_output_dict_per_obj"):
            inference_state[key][obj_idx] = {"cond_frame_outputs": {},
                                             "non_cond_frame_outputs": {}}
        inference_state["frames_tracked_per_obj"][obj_idx] = {}
        return obj_idx

    def _obj_idx_to_id(self, inference_state, obj_idx):
        return inference_state["obj_idx_to_id"][obj_idx]

    def _get_obj_num(self, inference_state):
        return len(inference_state["obj_idx_to_id"])

    def _get_image_feature(self, inference_state, frame_idx):
        """Encode one frame, with a one-frame cache (reference :810-841).
        Returns (hrf0, hrf1, embed) NCHW, batch 1."""
        cached = inference_state["cached_features"].get(frame_idx)
        if cached is not None:
            return cached
        img = inference_state["images"][frame_idx].to(self.device)
        feats = self.model.encode_image(img[None].float() / 255.0)
        inference_state["cached_features"] = {frame_idx: feats}
        return feats

    # prompts

    @torch.inference_mode()
    def add_new_points_or_box(self, inference_state, frame_idx, obj_id, points=None, labels=None,
                              clear_old_points=True, normalize_coords=True, box=None):
        """Add click or box prompts on a frame (reference :266-399)."""
        obj_idx = self._obj_id_to_idx(inference_state, obj_id)
        point_inputs_per_frame = inference_state["point_inputs_per_obj"][obj_idx]
        mask_inputs_per_frame = inference_state["mask_inputs_per_obj"][obj_idx]
        if (points is not None) != (labels is not None):
            raise ValueError("points and labels must be provided together")
        if points is None and box is None:
            raise ValueError("at least one of points or box must be provided as input")

        points = np.zeros((0, 2), np.float32) if points is None else np.asarray(points, np.float32)
        labels = np.zeros((0,), np.int32) if labels is None else np.asarray(labels, np.int32)
        if points.ndim == 2:
            points = points[None]
        if labels.ndim == 1:
            labels = labels[None]
        if box is not None:
            if not clear_old_points:
                raise ValueError("cannot add box without clearing old points (use "
                                 "clear_old_points=True)")
            points = np.concatenate([np.asarray(box, np.float32).reshape(1, 2, 2), points], 1)
            labels = np.concatenate([np.asarray([[2, 3]], np.int32), labels], 1)
        if normalize_coords:
            video_wh = np.asarray([inference_state["video_width"],
                                   inference_state["video_height"]], np.float32)
            points = points / video_wh
        points = points * self.image_size
        prev = None if clear_old_points else point_inputs_per_frame.get(frame_idx)
        point_inputs = concat_points(prev, points, labels)
        point_inputs_per_frame[frame_idx] = point_inputs
        mask_inputs_per_frame.pop(frame_idx, None)

        is_init_cond_frame, reverse, storage_key = self._frame_role(inference_state, obj_idx,
                                                                    frame_idx)
        obj_output_dict = inference_state["output_dict_per_obj"][obj_idx]
        obj_temp_output_dict = inference_state["temp_output_dict_per_obj"][obj_idx]
        # feed back the previous low-res logits with new clicks (:353-368)
        prev_out = obj_temp_output_dict[storage_key].get(frame_idx)
        if prev_out is None:
            prev_out = obj_output_dict["cond_frame_outputs"].get(frame_idx)
        if prev_out is None:
            prev_out = obj_output_dict["non_cond_frame_outputs"].get(frame_idx)
        prev_sam_mask_logits = None
        if prev_out is not None and prev_out.get("pred_masks") is not None:
            prev_sam_mask_logits = prev_out["pred_masks"].clamp(-32.0, 32.0)

        current_out = self._run_single_frame_inference(
            inference_state, obj_output_dict, frame_idx, is_init_cond_frame,
            point_inputs=point_inputs, mask_inputs=None, reverse=reverse, run_mem_encoder=False,
            prev_sam_mask_logits=prev_sam_mask_logits)
        obj_temp_output_dict[storage_key][frame_idx] = current_out
        return self._video_res_frame(inference_state, frame_idx, storage_key)

    add_new_points = add_new_points_or_box

    @torch.inference_mode()
    def add_new_mask(self, inference_state, frame_idx, obj_id, mask):
        """Add a binary mask prompt [H, W] (reference :405-487)."""
        obj_idx = self._obj_id_to_idx(inference_state, obj_id)
        mask = torch.as_tensor(np.asarray(mask))
        if mask.ndim != 2:
            raise ValueError(f"mask must be [H, W], got {tuple(mask.shape)}")
        mask_inputs = mask.to(self.device, torch.float32)[None, None]
        size = (self.image_size, self.image_size)
        if tuple(mask.shape) != size:
            mask_inputs = base.resize_hw(mask_inputs, size, "bilinear", antialias=True)
            mask_inputs = (mask_inputs >= 0.5).float()
        inference_state["mask_inputs_per_obj"][obj_idx][frame_idx] = mask_inputs
        inference_state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        is_init_cond_frame, reverse, storage_key = self._frame_role(inference_state, obj_idx,
                                                                    frame_idx)
        current_out = self._run_single_frame_inference(
            inference_state, inference_state["output_dict_per_obj"][obj_idx], frame_idx,
            is_init_cond_frame, point_inputs=None, mask_inputs=mask_inputs, reverse=reverse,
            run_mem_encoder=False)
        inference_state["temp_output_dict_per_obj"][obj_idx][storage_key][frame_idx] = current_out
        return self._video_res_frame(inference_state, frame_idx, storage_key)

    def _frame_role(self, inference_state, obj_idx, frame_idx):
        """(is_init_cond_frame, reverse, storage key) of a prompt on a frame."""
        tracked = inference_state["frames_tracked_per_obj"][obj_idx]
        is_init_cond_frame = frame_idx not in tracked
        reverse = False if is_init_cond_frame else tracked[frame_idx]["reverse"]
        is_cond = is_init_cond_frame or self.add_all_frames_to_correct_as_cond
        return is_init_cond_frame, reverse, ("cond_frame_outputs" if is_cond
                                             else "non_cond_frame_outputs")

    def _video_res_frame(self, inference_state, frame_idx, storage_key):
        """(frame_idx, obj_ids, video-res masks) after a prompt."""
        consolidated = self._consolidate_temp_output_across_obj(
            inference_state, frame_idx, is_cond=storage_key == "cond_frame_outputs",
            consolidate_at_video_res=True)
        _, video_res_masks = self._get_orig_video_res_output(
            inference_state, consolidated["pred_masks_video_res"])
        return frame_idx, inference_state["obj_ids"], video_res_masks

    # outputs

    def _get_orig_video_res_output(self, inference_state, any_res_masks):
        """Resize to the original video resolution, with the optional
        non-overlap constraint (reference :489-509)."""
        video_hw = (inference_state["video_height"], inference_state["video_width"])
        video_res_masks = any_res_masks
        if tuple(any_res_masks.shape[-2:]) != video_hw:
            video_res_masks = base.resize_hw(any_res_masks, video_hw, "bilinear")
        if self.non_overlap_masks:
            video_res_masks = base.apply_non_overlapping_constraints(video_res_masks)
        return any_res_masks, video_res_masks

    def _consolidate_temp_output_across_obj(self, inference_state, frame_idx, is_cond,
                                            consolidate_at_video_res=False):
        """reference :511-583."""
        storage_key = "cond_frame_outputs" if is_cond else "non_cond_frame_outputs"
        if consolidate_at_video_res:
            hw = (inference_state["video_height"], inference_state["video_width"])
            key = "pred_masks_video_res"
        else:
            hw = (self.image_size // 4, self.image_size // 4)
            key = "pred_masks"
        masks = []
        for obj_idx in range(self._get_obj_num(inference_state)):
            obj_out = inference_state["output_dict_per_obj"][obj_idx]
            out = inference_state["temp_output_dict_per_obj"][obj_idx][storage_key].get(frame_idx)
            if out is None:
                out = obj_out["cond_frame_outputs"].get(frame_idx)
            if out is None:
                out = obj_out["non_cond_frame_outputs"].get(frame_idx)
            if out is None:
                masks.append(torch.full((1, 1, *hw), NO_OBJ_SCORE, device=self.device))
                continue
            obj_mask = out["pred_masks"]
            if tuple(obj_mask.shape[-2:]) != hw:
                obj_mask = base.resize_hw(obj_mask, hw, "bilinear")
            masks.append(obj_mask)
        return {key: torch.cat(masks, 0)}

    # propagation

    @torch.inference_mode()
    def propagate_in_video_preflight(self, inference_state):
        """Consolidate temporary outputs and run the memory encoder on the
        prompted frames (reference :585-649)."""
        batch_size = self._get_obj_num(inference_state)
        if batch_size == 0:
            raise RuntimeError("No input points or masks are provided for any object; "
                               "please add inputs first.")
        for obj_idx in range(batch_size):
            obj_output_dict = inference_state["output_dict_per_obj"][obj_idx]
            obj_temp_output_dict = inference_state["temp_output_dict_per_obj"][obj_idx]
            for storage_key in ("non_cond_frame_outputs", "cond_frame_outputs"):
                for frame_idx, out in obj_temp_output_dict[storage_key].items():
                    if out.get("maskmem_features") is None:
                        high_res_masks = base.resize_hw(
                            out["pred_masks"], (self.image_size, self.image_size), "bilinear")
                        out["maskmem_features"] = self._run_memory_encoder(
                            inference_state, frame_idx, high_res_masks,
                            out["object_score_logits"], is_mask_from_pts=True)
                    obj_output_dict[storage_key][frame_idx] = out
                    if self.clear_non_cond_mem_around_input:
                        self._clear_obj_non_cond_mem_around_input(inference_state, frame_idx,
                                                                  obj_idx)
                obj_temp_output_dict[storage_key].clear()
            if len(obj_output_dict["cond_frame_outputs"]) == 0:
                obj_id = self._obj_idx_to_id(inference_state, obj_idx)
                raise RuntimeError(f"No input points or masks are provided for object id "
                                   f"{obj_id}; please add inputs first.")
            for frame_idx in obj_output_dict["cond_frame_outputs"]:
                obj_output_dict["non_cond_frame_outputs"].pop(frame_idx, None)

    @torch.inference_mode()
    def propagate_in_video(self, inference_state, start_frame_idx=None,
                           max_frame_num_to_track=None, reverse=False):
        """Per-frame propagation generator (reference :651-736): yields
        (frame_idx, obj_ids, video-res mask logits [N_obj, 1, H, W])."""
        self.propagate_in_video_preflight(inference_state)
        obj_ids = inference_state["obj_ids"]
        num_frames = inference_state["num_frames"]
        batch_size = self._get_obj_num(inference_state)
        if start_frame_idx is None:
            start_frame_idx = min(t for d in inference_state["output_dict_per_obj"].values()
                                  for t in d["cond_frame_outputs"])
        if max_frame_num_to_track is None:
            max_frame_num_to_track = num_frames
        if reverse:
            end_frame_idx = max(start_frame_idx - max_frame_num_to_track, 0)
            processing_order = (range(start_frame_idx, end_frame_idx - 1, -1)
                                if start_frame_idx > 0 else [])
        else:
            end_frame_idx = min(start_frame_idx + max_frame_num_to_track, num_frames - 1)
            processing_order = range(start_frame_idx, end_frame_idx + 1)

        for frame_idx in processing_order:
            pred_masks_per_obj = [None] * batch_size
            to_track = []
            for obj_idx in range(batch_size):
                obj_output_dict = inference_state["output_dict_per_obj"][obj_idx]
                if frame_idx in obj_output_dict["cond_frame_outputs"]:
                    pred_masks_per_obj[obj_idx] = (
                        obj_output_dict["cond_frame_outputs"][frame_idx]["pred_masks"])
                    if self.clear_non_cond_mem_around_input:
                        self._clear_obj_non_cond_mem_around_input(inference_state, frame_idx,
                                                                  obj_idx)
                else:
                    to_track.append(obj_idx)
            # objects that need this frame are tracked as one batch
            outs = None
            if len(to_track) > 1:
                outs = self._run_batched_frame_inference(inference_state, to_track, frame_idx,
                                                         reverse)
            if outs is None:
                outs = [self._run_single_frame_inference(
                    inference_state, inference_state["output_dict_per_obj"][obj_idx], frame_idx,
                    False, point_inputs=None, mask_inputs=None, reverse=reverse,
                    run_mem_encoder=True) for obj_idx in to_track]
            for obj_idx, current_out in zip(to_track, outs):
                inference_state["output_dict_per_obj"][obj_idx]["non_cond_frame_outputs"][
                    frame_idx] = current_out
                pred_masks_per_obj[obj_idx] = current_out["pred_masks"]
            for obj_idx in range(batch_size):
                inference_state["frames_tracked_per_obj"][obj_idx][frame_idx] = {
                    "reverse": reverse}
            _, video_res_masks = self._get_orig_video_res_output(
                inference_state, torch.cat(pred_masks_per_obj, 0))
            yield frame_idx, obj_ids, video_res_masks

    # single-frame inference

    def _use_multimask(self, is_init_cond_frame, point_inputs):
        """reference sam2_base_official.py:1181-1189."""
        cfg = self.cfg
        num_pts = 0 if point_inputs is None else point_inputs["point_labels"].shape[1]
        return (cfg.multimask_output_in_sam
                and (is_init_cond_frame or cfg.multimask_output_for_tracking)
                and cfg.multimask_min_pt_num <= num_pts <= cfg.multimask_max_pt_num)

    def _gather_memory(self, inference_state, output_dict, frame_idx, reverse):
        """Host-side memory selection (reference :822-948): at most
        num_maskmem spatial memories and max_obj_ptrs pointers, padded to a
        fixed capacity. Returns a vc.MemoryInput."""
        cfg = self.cfg
        num_frames = inference_state["num_frames"]
        tpos_sign_mul = -1 if reverse else 1
        selected_cond, unselected_cond = _select_closest_cond_frames(
            frame_idx, output_dict["cond_frame_outputs"], cfg.max_cond_frames_in_attn)
        t_pos_and_prevs = [(0, out) for out in selected_cond.values()]
        stride = cfg.memory_temporal_stride_for_eval
        for t_pos in range(1, cfg.num_maskmem):
            t_rel = cfg.num_maskmem - t_pos
            if t_rel == 1:
                prev_frame_idx = frame_idx - t_rel if not reverse else frame_idx + t_rel
            elif not reverse:
                prev_frame_idx = ((frame_idx - 2) // stride) * stride - (t_rel - 2) * stride
            else:
                prev_frame_idx = -(-(frame_idx + 2) // stride) * stride + (t_rel - 2) * stride
            out = output_dict["non_cond_frame_outputs"].get(prev_frame_idx)
            if out is None:
                out = unselected_cond.get(prev_frame_idx)
            t_pos_and_prevs.append((t_pos, out))

        feats_list, tpos_list = [], []
        for t_pos, prev in t_pos_and_prevs:
            if prev is not None:
                feats_list.append(prev["maskmem_features"])  # [1, mem_dim, g, g] bf16
                tpos_list.append(cfg.num_maskmem - t_pos - 1)
        # fixed capacity num_maskmem; more conditioning frames grow it
        cap = max(cfg.num_maskmem, len(feats_list))
        tpos_idx = np.zeros((cap,), np.int32)
        valid = np.zeros((cap,), bool)
        tpos_idx[:len(tpos_list)] = tpos_list
        valid[:len(feats_list)] = True
        zero_slot = self._zero_mem_slot()
        mem_feats = tuple(feats_list[i] if i < len(feats_list) else zero_slot
                          for i in range(cap))

        # object pointers (reference :886-948)
        ptrs_list, pos_list = [], []
        if cfg.use_obj_ptrs_in_encoder:
            max_obj_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
            ptr_cond = ({t: out for t, out in selected_cond.items()
                         if (t >= frame_idx if reverse else t <= frame_idx)}
                        if cfg.only_obj_ptrs_in_the_past_for_eval else selected_cond)
            for t, out in ptr_cond.items():
                pos_list.append((frame_idx - t) * tpos_sign_mul
                                if cfg.use_signed_tpos_enc_to_obj_ptrs else abs(frame_idx - t))
                ptrs_list.append(out["obj_ptr"])
            for t_diff in range(1, max_obj_ptrs):
                t = frame_idx + t_diff if reverse else frame_idx - t_diff
                if t < 0 or t >= num_frames:
                    break
                out = output_dict["non_cond_frame_outputs"].get(t, unselected_cond.get(t))
                if out is not None:
                    pos_list.append(t_diff)
                    ptrs_list.append(out["obj_ptr"])
            t_diff_max = max(max_obj_ptrs - 1, 1)
        else:
            t_diff_max = 1
        # the reference has no total pointer cap (cond-frame pointers plus up
        # to max_obj_ptrs - 1 others): grow the capacity in steps of 8
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

    @staticmethod
    def _stack_memory(mems):
        """Per-object MemoryInputs (B = 1 each) -> one batched input."""
        return vc.MemoryInput(
            feats=tuple(torch.cat(f, 0) for f in zip(*(m.feats for m in mems))),
            tpos_idx=np.concatenate([m.tpos_idx for m in mems]),
            valid=np.concatenate([m.valid for m in mems]),
            ptrs=tuple(torch.cat(p, 0) for p in zip(*(m.ptrs for m in mems))),
            ptr_pos=np.concatenate([m.ptr_pos for m in mems]),
            ptr_valid=np.concatenate([m.ptr_valid for m in mems]))

    def _zero_mem_slot(self):
        if self._zero_mem is None:
            g = self.cfg.image_embedding_size
            self._zero_mem = torch.zeros(1, self.cfg.mem_dim, g, g, dtype=torch.bfloat16,
                                         device=self.device)
        return self._zero_mem

    def _zero_ptr_slot(self):
        if self._zero_ptr is None:
            self._zero_ptr = torch.zeros(1, self.cfg.hidden_dim, device=self.device)
        return self._zero_ptr

    def _fill_holes(self, pred_masks):
        """Hole filling after the tracking step (reference misc.py:312-337)."""
        return fill_holes_in_mask_scores(pred_masks, self.fill_hole_area)

    def _run_single_frame_inference(self, inference_state, output_dict, frame_idx,
                                    is_init_cond_frame, point_inputs, mask_inputs, reverse,
                                    run_mem_encoder, prev_sam_mask_logits=None):
        """reference :843-909: one tracking step and its stored output."""
        feats = self._get_image_feature(inference_state, frame_idx)
        assert point_inputs is None or mask_inputs is None
        multimask = self._use_multimask(is_init_cond_frame, point_inputs)
        coords = labels = None
        if point_inputs is not None:
            coords = torch.as_tensor(point_inputs["point_coords"], dtype=torch.float32,
                                     device=self.device)
            labels = torch.as_tensor(point_inputs["point_labels"], dtype=torch.int32,
                                     device=self.device)
        cfg, m = self.cfg, self.model._m
        # a mask prompt bypasses memory conditioning, on initial and tracked
        # frames alike (reference sam2_base_official.py:1051-1058)
        mask_direct = mask_inputs is not None and cfg.use_mask_input_as_output_without_sam
        if is_init_cond_frame or cfg.num_maskmem == 0 or mask_direct:
            out = vc.track_step_init(m, cfg, feats, coords, labels, mask_inputs,
                                     prev_sam_mask_logits, multimask_output=multimask,
                                     run_mem_encoder=run_mem_encoder)
        else:
            mem = self._gather_memory(inference_state, output_dict, frame_idx, reverse)
            out = vc.track_step_conditioned(m, cfg, feats, mem, coords, labels,
                                            prev_sam_mask_logits, multimask_output=multimask,
                                            run_mem_encoder=run_mem_encoder,
                                            mask_inputs=mask_inputs)
        return self._compact_output(out, self._fill_holes(out["pred_masks"]))

    @staticmethod
    def _compact_output(out, pred_masks):
        return {"maskmem_features": out.get("maskmem_features"), "pred_masks": pred_masks,
                "obj_ptr": out["obj_ptr"], "object_score_logits": out["object_score_logits"]}

    def _run_batched_frame_inference(self, inference_state, obj_idxs, frame_idx, reverse):
        """Track several objects in one step: the frame's features shared,
        the memories batched. Returns per-object outputs, or None when the
        memories' capacities differ."""
        if self.cfg.num_maskmem == 0:
            return None
        mems = [self._gather_memory(inference_state, inference_state["output_dict_per_obj"][i],
                                    frame_idx, reverse) for i in obj_idxs]
        if len({(len(m.feats), len(m.ptrs)) for m in mems}) != 1:
            return None
        B = len(obj_idxs)
        feats = tuple(f.expand(B, *f.shape[1:])
                      for f in self._get_image_feature(inference_state, frame_idx))
        out = vc.track_step_conditioned(self.model._m, self.cfg, feats, self._stack_memory(mems),
                                        multimask_output=self._use_multimask(False, None),
                                        run_mem_encoder=True)
        pred_masks = self._fill_holes(out["pred_masks"])
        return [self._compact_output({k: v[i:i + 1] for k, v in out.items()},
                                     pred_masks[i:i + 1]) for i in range(B)]

    def _run_memory_encoder(self, inference_state, frame_idx, high_res_masks,
                            object_score_logits, is_mask_from_pts):
        """reference :911-945."""
        embed = self._get_image_feature(inference_state, frame_idx)[2]
        return vc.encode_memory_only(self.model._m, self.cfg, embed, high_res_masks,
                                     object_score_logits, is_mask_from_pts)

    # state edits (reference :738-1079)

    @torch.inference_mode()
    def clear_all_prompts_in_frame(self, inference_state, frame_idx, obj_id, need_output=True):
        obj_idx = self._obj_id_to_idx(inference_state, obj_id)
        inference_state["point_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        inference_state["mask_inputs_per_obj"][obj_idx].pop(frame_idx, None)
        temp = inference_state["temp_output_dict_per_obj"]
        temp[obj_idx]["cond_frame_outputs"].pop(frame_idx, None)
        temp[obj_idx]["non_cond_frame_outputs"].pop(frame_idx, None)
        obj_output_dict = inference_state["output_dict_per_obj"][obj_idx]
        out = obj_output_dict["cond_frame_outputs"].pop(frame_idx, None)
        if out is not None:
            obj_output_dict["non_cond_frame_outputs"][frame_idx] = out
            inference_state["frames_tracked_per_obj"][obj_idx].pop(frame_idx, None)
        if not need_output:
            return
        is_cond = any(frame_idx in t["cond_frame_outputs"] for t in temp.values())
        return self._video_res_frame(inference_state, frame_idx,
                                     "cond_frame_outputs" if is_cond else "non_cond_frame_outputs")

    @torch.inference_mode()
    def reset_state(self, inference_state):
        self._reset_tracking_results(inference_state)
        for key in ("obj_id_to_idx", "obj_idx_to_id", "obj_ids", "point_inputs_per_obj",
                    "mask_inputs_per_obj", "output_dict_per_obj", "temp_output_dict_per_obj",
                    "frames_tracked_per_obj"):
            inference_state[key].clear()

    def _reset_tracking_results(self, inference_state):
        for key in ("point_inputs_per_obj", "mask_inputs_per_obj", "frames_tracked_per_obj"):
            for v in inference_state[key].values():
                v.clear()
        for key in ("output_dict_per_obj", "temp_output_dict_per_obj"):
            for v in inference_state[key].values():
                v["cond_frame_outputs"].clear()
                v["non_cond_frame_outputs"].clear()

    @torch.inference_mode()
    def remove_object(self, inference_state, obj_id, strict=False, need_output=True):
        """reference :972-1060."""
        old_obj_idx_to_rm = inference_state["obj_id_to_idx"].get(obj_id, None)
        updated_frames = []
        if old_obj_idx_to_rm is None:
            if not strict:
                return inference_state["obj_ids"], updated_frames
            raise RuntimeError(f"Cannot remove object id {obj_id} as it doesn't exist.")
        if len(inference_state["obj_id_to_idx"]) == 1:
            self.reset_state(inference_state)
            return inference_state["obj_ids"], updated_frames

        obj_input_frames_inds = set(inference_state["point_inputs_per_obj"][old_obj_idx_to_rm])
        obj_input_frames_inds.update(inference_state["mask_inputs_per_obj"][old_obj_idx_to_rm])
        for frame_idx in obj_input_frames_inds:
            self.clear_all_prompts_in_frame(inference_state, frame_idx, obj_id,
                                            need_output=False)

        old_obj_ids = inference_state["obj_ids"]
        old_obj_inds = list(range(len(old_obj_ids)))
        remain_old_obj_inds = [i for i in old_obj_inds if i != old_obj_idx_to_rm]
        new_obj_ids = [old_obj_ids[i] for i in remain_old_obj_inds]
        new_obj_inds = list(range(len(new_obj_ids)))
        old_idx_to_new_idx = dict(zip(remain_old_obj_inds, new_obj_inds))
        inference_state["obj_id_to_idx"] = OrderedDict(zip(new_obj_ids, new_obj_inds))
        inference_state["obj_idx_to_id"] = OrderedDict(zip(new_obj_inds, new_obj_ids))
        inference_state["obj_ids"] = new_obj_ids

        for key in ("point_inputs_per_obj", "mask_inputs_per_obj", "output_dict_per_obj",
                    "temp_output_dict_per_obj", "frames_tracked_per_obj"):
            container = inference_state[key]
            new_kvs = [(old_idx_to_new_idx[k], container.pop(k)) for k in old_obj_inds
                       if k in old_idx_to_new_idx]
            container.pop(old_obj_idx_to_rm, None)
            container.update(new_kvs)

        if need_output:
            temp = inference_state["temp_output_dict_per_obj"]
            for frame_idx in obj_input_frames_inds:
                is_cond = any(frame_idx in t["cond_frame_outputs"] for t in temp.values())
                _, _, video_res_masks = self._video_res_frame(
                    inference_state, frame_idx,
                    "cond_frame_outputs" if is_cond else "non_cond_frame_outputs")
                updated_frames.append((frame_idx, video_res_masks))
        return inference_state["obj_ids"], updated_frames

    def _clear_obj_non_cond_mem_around_input(self, inference_state, frame_idx, obj_idx):
        """reference :1062-1079."""
        r = self.memory_temporal_stride_for_eval
        non_cond = inference_state["output_dict_per_obj"][obj_idx]["non_cond_frame_outputs"]
        for t in range(frame_idx - r * self.num_maskmem, frame_idx + r * self.num_maskmem + 1):
            non_cond.pop(t, None)
