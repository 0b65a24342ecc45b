"""VOS batch-inference CLI (DAVIS / MOSE / SA-V layouts).

Counterpart of `sam2_opt_tpu/eval/vos_inference.py`, over the port's video
predictor (after `speedup()`, its steps run as CUDA graph replays):
`python -m sam2_opt_tpu_torch.eval.vos_inference --base_video_dir ...
--input_mask_dir ... --output_mask_dir ...`.

Re-design of sam2/tools/vos_inference.py:1-507: per-video `init_state` ->
seed GT masks (first annotated frame, or every annotated frame with
--use_all_masks) -> `propagate_in_video` -> per-frame palette PNG outputs,
with joint multi-object tracking or per-object separate tracking
(--per_obj_png_file for the SA-V layout).
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np


# 255-entry DAVIS palette (first entries; rest generated procedurally)
_DAVIS_PALETTE_HEAD = [
    0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0, 0, 0, 128, 128, 0, 128,
    0, 128, 128, 128, 128, 128, 64, 0, 0, 191, 0, 0, 64, 128, 0, 191, 128, 0,
]


def davis_palette() -> List[int]:
    pal = list(_DAVIS_PALETTE_HEAD)
    rng = np.random.default_rng(0)
    while len(pal) < 768:
        pal.extend(int(x) for x in rng.integers(0, 256, 3))
    return pal[:768]


def load_ann_png(path: str):
    """Load a palette PNG annotation -> (mask array, palette)."""
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img).astype(np.uint8), img.getpalette()


def save_ann_png(path: str, mask: np.ndarray, palette=None):
    if mask.dtype != np.uint8 or mask.ndim != 2:
        raise ValueError(f"an annotation is uint8 [H, W], got {mask.dtype} {mask.shape}")
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = Image.fromarray(mask)
    img.putpalette(palette or davis_palette())
    img.save(path)


def get_per_obj_mask(mask: np.ndarray) -> Dict[int, np.ndarray]:
    """Split a multi-object id mask into per-object binary masks
    (reference vos_inference.py)."""
    object_ids = np.unique(mask)
    object_ids = object_ids[object_ids > 0].tolist()
    return {oid: (mask == oid) for oid in object_ids}


def put_per_obj_mask(per_obj_mask: Dict[int, np.ndarray], height, width):
    """Combine per-object binary masks into one id mask. Written in
    DESCENDING id order with unconditional overwrite, so on overlap the
    LOWEST id wins — matching the reference put_per_obj_mask
    (tools/vos_inference.py:42-53) so outputs compare bit-for-bit."""
    mask = np.zeros((height, width), np.uint8)
    for oid in sorted(per_obj_mask)[::-1]:
        obj_mask = per_obj_mask[oid].reshape(height, width)
        mask[obj_mask] = oid
    return mask


def _input_frames(video_dir: str) -> List[str]:
    names = [
        os.path.splitext(p)[0]
        for p in os.listdir(video_dir)
        if os.path.splitext(p)[-1].lower() in (".jpg", ".jpeg", ".png")
    ]
    try:
        names.sort(key=int)
    except ValueError:
        names.sort()
    return names


def vos_inference(
    predictor,
    base_video_dir: str,
    input_mask_dir: str,
    output_mask_dir: str,
    video_name: str,
    score_thresh: float = 0.0,
    use_all_masks: bool = False,
    per_obj_png_file: bool = False,
):
    """Run inference on one video (reference vos_inference:118-246)."""
    video_dir = os.path.join(base_video_dir, video_name)
    frame_names = _input_frames(video_dir)
    inference_state = predictor.init_state(video_path=video_dir)
    height = inference_state["video_height"]
    width = inference_state["video_width"]

    # collect input masks
    input_palette = None
    inputs_per_frame: Dict[int, Dict[int, np.ndarray]] = {}
    mask_video_dir = os.path.join(input_mask_dir, video_name)
    if per_obj_png_file:
        for obj_dir in sorted(os.listdir(mask_video_dir)):
            obj_id = int(obj_dir)
            obj_path = os.path.join(mask_video_dir, obj_dir)
            for fn in sorted(os.listdir(obj_path)):
                t = frame_names.index(os.path.splitext(fn)[0])
                mask, input_palette = load_ann_png(os.path.join(obj_path, fn))
                inputs_per_frame.setdefault(t, {})[obj_id] = mask > 0
    else:
        for fn in sorted(os.listdir(mask_video_dir)):
            t = frame_names.index(os.path.splitext(fn)[0])
            mask, input_palette = load_ann_png(os.path.join(mask_video_dir, fn))
            inputs_per_frame[t] = get_per_obj_mask(mask)

    if not use_all_masks:
        # the reference seeds from FRAME 0 only (:146-147) and directs
        # datasets with later-appearing objects to the separate-per-object
        # path — mirror that instead of silently picking a different frame
        if 0 not in inputs_per_frame:
            raise RuntimeError(
                f"{video_name}: no input mask on the first frame; use "
                f"use_all_masks=True or vos_separate_inference_per_object "
                f"(--track_object_appearing_later_in_video) for datasets "
                f"whose objects appear mid-video."
            )
        inputs_per_frame = {0: inputs_per_frame[0]}

    for t, per_obj in sorted(inputs_per_frame.items()):
        for obj_id, obj_mask in per_obj.items():
            predictor.add_new_mask(inference_state, t, obj_id, obj_mask)

    outputs_per_frame: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)
    for frame_idx, obj_ids, masks in predictor.propagate_in_video(inference_state):
        masks_np = (masks > score_thresh).cpu().numpy()  # [N, 1, H, W]
        for i, obj_id in enumerate(obj_ids):
            outputs_per_frame[frame_idx][obj_id] = masks_np[i, 0]

    _write_outputs(outputs_per_frame, output_mask_dir, video_name, frame_names,
                   height, width, per_obj_png_file, input_palette)
    predictor.reset_state(inference_state)
    return outputs_per_frame


def _write_outputs(outputs_per_frame, output_mask_dir, video_name, frame_names,
                   height, width, per_obj_png_file, input_palette):
    """Palette-PNG writer shared by the joint and per-object paths."""
    for frame_idx, per_obj in outputs_per_frame.items():
        name = frame_names[frame_idx]
        if per_obj_png_file:
            for obj_id, m in per_obj.items():
                out = m.reshape(height, width).astype(np.uint8)
                save_ann_png(
                    os.path.join(output_mask_dir, video_name, f"{obj_id:03d}",
                                 f"{name}.png"),
                    out, input_palette,
                )
        else:
            combined = put_per_obj_mask(per_obj, height, width)
            save_ann_png(
                os.path.join(output_mask_dir, video_name, f"{name}.png"),
                combined, input_palette,
            )


def vos_separate_inference_per_object(
    predictor,
    base_video_dir: str,
    input_mask_dir: str,
    output_mask_dir: str,
    video_name: str,
    score_thresh: float = 0.0,
    use_all_masks: bool = False,
    per_obj_png_file: bool = False,
):
    """Per-object separate tracking (reference :249-363): each object is
    seeded at ITS OWN first annotated frame (or all its annotated frames
    with use_all_masks) and tracked in its own pass — for datasets like
    LVOS / YouTube-VOS where objects appear mid-video. Per-frame scores are
    consolidated with the non-overlapping constraint (joint PNG layout
    only), missing frames scored NO_OBJ (-1024)."""
    video_dir = os.path.join(base_video_dir, video_name)
    frame_names = _input_frames(video_dir)
    inference_state = predictor.init_state(video_path=video_dir)
    height = inference_state["video_height"]
    width = inference_state["video_width"]

    # collect every object's annotated frames
    input_palette = None
    inputs_per_object: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)
    mask_video_dir = os.path.join(input_mask_dir, video_name)
    if per_obj_png_file:
        for obj_dir in sorted(os.listdir(mask_video_dir)):
            obj_id = int(obj_dir)
            obj_path = os.path.join(mask_video_dir, obj_dir)
            for fn in sorted(os.listdir(obj_path)):
                t = frame_names.index(os.path.splitext(fn)[0])
                mask, input_palette = load_ann_png(os.path.join(obj_path, fn))
                if (mask > 0).any():
                    inputs_per_object[obj_id][t] = mask > 0
    else:
        for fn in sorted(os.listdir(mask_video_dir)):
            t = frame_names.index(os.path.splitext(fn)[0])
            mask, input_palette = load_ann_png(os.path.join(mask_video_dir, fn))
            for oid, m in get_per_obj_mask(mask).items():
                if m.any():
                    inputs_per_object[oid][t] = m
    if not use_all_masks:
        inputs_per_object = {
            oid: {min(d): d[min(d)]} for oid, d in inputs_per_object.items()
        }

    # one tracking pass per object, starting at its first annotated frame
    object_ids = sorted(inputs_per_object)
    scores_per_object: Dict[int, Dict[int, np.ndarray]] = {}
    for oid in object_ids:
        predictor.reset_state(inference_state)
        inds = sorted(inputs_per_object[oid])
        for t in inds:
            predictor.add_new_mask(
                inference_state, t, oid, inputs_per_object[oid][t]
            )
        scores_per_object[oid] = {}
        for frame_idx, _, masks in predictor.propagate_in_video(
            inference_state, start_frame_idx=min(inds)
        ):
            scores_per_object[oid][frame_idx] = masks[0].float().cpu().numpy()

    # consolidate per frame (reference :330-351)
    outputs_per_frame: Dict[int, Dict[int, np.ndarray]] = {}
    for frame_idx in range(len(frame_names)):
        scores = np.full((len(object_ids), 1, height, width), -1024.0,
                         np.float32)
        for i, oid in enumerate(object_ids):
            if frame_idx in scores_per_object[oid]:
                scores[i] = scores_per_object[oid][frame_idx]
        if not per_obj_png_file and len(object_ids) > 1:
            # numpy mirror of base.apply_non_overlapping_constraints —
            # a per-frame device call here would pay one H2D+D2H round
            # trip per frame of video-resolution scores for a plain argmax
            keep = np.argmax(scores, axis=0, keepdims=True) == np.arange(
                len(object_ids)
            )[:, None, None, None]
            scores = np.where(keep, scores, np.minimum(scores, -10.0))
        outputs_per_frame[frame_idx] = {
            oid: scores[i, 0] > score_thresh
            for i, oid in enumerate(object_ids)
        }

    _write_outputs(outputs_per_frame, output_mask_dir, video_name, frame_names,
                   height, width, per_obj_png_file, input_palette)
    predictor.reset_state(inference_state)
    return outputs_per_frame


def main():
    parser = argparse.ArgumentParser(
        description="SAM2 VOS batch inference on PyTorch (reference tools/vos_inference.py)"
    )
    parser.add_argument("--sam2_cfg", default="hiera_l")
    parser.add_argument("--sam2_checkpoint", default=None)
    parser.add_argument("--base_video_dir", required=True)
    parser.add_argument("--input_mask_dir", required=True)
    parser.add_argument("--output_mask_dir", required=True)
    parser.add_argument("--video_list_file", default=None)
    parser.add_argument("--score_thresh", type=float, default=0.0)
    parser.add_argument("--use_all_masks", action="store_true")
    parser.add_argument("--per_obj_png_file", action="store_true")
    parser.add_argument(
        "--track_object_appearing_later_in_video", action="store_true",
        help="per-object separate tracking, seeding each object at its own "
             "first annotated frame (LVOS / YouTube-VOS)",
    )
    parser.add_argument("--backend", default="cuda", choices=("cuda", "eager"),
                        help="'cuda' (bf16, CUDA graphs; default) or 'eager' (fp32)")
    args = parser.parse_args()

    from sam2_opt_tpu_torch.build_sam import build_sam2_video_predictor

    predictor = build_sam2_video_predictor(args.sam2_cfg, args.sam2_checkpoint)
    if args.backend != "eager":
        predictor.speedup()

    if args.video_list_file:
        with open(args.video_list_file) as f:
            videos = [line.strip() for line in f if line.strip()]
    else:
        videos = sorted(os.listdir(args.base_video_dir))
    print(f"running VOS prediction on {len(videos)} videos")
    infer_fn = (
        vos_separate_inference_per_object
        if args.track_object_appearing_later_in_video
        else vos_inference
    )
    for i, video_name in enumerate(videos):
        print(f"[{i+1}/{len(videos)}] {video_name}")
        infer_fn(
            predictor,
            args.base_video_dir,
            args.input_mask_dir,
            args.output_mask_dir,
            video_name,
            score_thresh=args.score_thresh,
            use_all_masks=args.use_all_masks,
            per_obj_png_file=args.per_obj_png_file,
        )
    print(f"completed; outputs in {args.output_mask_dir}")


if __name__ == "__main__":
    main()
