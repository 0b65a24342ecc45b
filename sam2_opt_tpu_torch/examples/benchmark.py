"""SA-V benchmark driver (counterpart of `examples/benchmark.py`; reference
benchmark.py:1-244).

Iterates SA-V-test videos, seeds tracking with the first-frame GT mask per
object, propagates, and saves per-frame per-object PNG masks for J&F
evaluation with `sam2_opt_tpu_torch.examples.benchmark_compare`.

Layout expected:
  <sav_root>/JPEGImages_24fps/<video>/<frame>.jpg
  <sav_root>/Annotations_6fps/<video>/<obj_id>/<frame>.png

    python -m sam2_opt_tpu_torch.examples.benchmark --sav_root SAV
        [--output_dir outputs/sav_pred] [--variant hiera_l]
        [--checkpoint ckpt.pt] [--backend eager] [--max_videos N]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from sam2_opt_tpu_torch import build_sam2_video_predictor
from sam2_opt_tpu_torch.eval.vos_inference import save_ann_png


def get_first_frame_gt_mask(ann_dir, obj_id):
    """First annotated frame + mask for an object (reference benchmark.py:101)."""
    from PIL import Image

    obj_dir = os.path.join(ann_dir, obj_id)
    first = sorted(os.listdir(obj_dir))[0]
    mask = np.array(Image.open(os.path.join(obj_dir, first))) > 0
    return int(os.path.splitext(first)[0]), mask


def run_segmentation_with_gt_mask(predictor, video_dir, ann_dir, out_dir, video_name):
    """Track all objects of one video from their first-frame GT masks and dump
    per-frame PNGs (reference run_segmentation_with_gt_mask, benchmark.py:57)."""
    state = predictor.init_state(video_dir)
    for obj_id in sorted(os.listdir(ann_dir)):
        t, mask = get_first_frame_gt_mask(ann_dir, obj_id)
        predictor.add_new_mask(state, t, obj_id, mask)
    for frame_idx, out_obj_ids, masks in predictor.propagate_in_video(state):
        masks_np = (masks > 0).cpu().numpy()
        for i, obj_id in enumerate(out_obj_ids):
            save_ann_png(os.path.join(out_dir, video_name, str(obj_id), f"{frame_idx:05d}.png"),
                         masks_np[i, 0].astype(np.uint8))
    predictor.reset_state(state)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--sav_root", required=True)
    parser.add_argument("--output_dir", default="outputs/sav_pred")
    parser.add_argument("--variant", default="hiera_l")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--backend", default="cuda",
                        help="'cuda' (speedup(): bf16 CUDA graphs) or 'eager' (fp32)")
    parser.add_argument("--max_videos", type=int, default=None)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    predictor = build_sam2_video_predictor(args.variant, args.checkpoint, device=args.device)
    if args.backend != "eager":
        predictor.speedup(args.backend)
    img_root = os.path.join(args.sav_root, "JPEGImages_24fps")
    ann_root = os.path.join(args.sav_root, "Annotations_6fps")
    videos = sorted(os.listdir(img_root))[:args.max_videos]
    t0 = time.time()
    for i, video in enumerate(videos):
        print(f"[{i + 1}/{len(videos)}] {video}")
        run_segmentation_with_gt_mask(predictor, os.path.join(img_root, video),
                                      os.path.join(ann_root, video), args.output_dir, video)
    print(f"done in {time.time() - t0:.0f}s -> {args.output_dir}")


if __name__ == "__main__":
    main()
