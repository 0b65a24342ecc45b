"""Video demo (counterpart of `examples/video.py`; reference video.py:1-74):
init_state -> add_new_points_or_box -> propagate_in_video -> an mp4 of the
frames with the blended masks.

    python -m sam2_opt_tpu_torch.examples.video VIDEO [--checkpoint ckpt.pt]
        [--variant hiera_l] [--output_path outputs/video_demo.mp4]
        [--max_frames N] [--device cpu]

VIDEO is a JPEG or PNG folder of frames named by number, or an mp4.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from sam2_opt_tpu_torch import build_sam2_video_predictor
from sam2_opt_tpu_torch.examples.draw import gen_video_writer, save_masks

POINT = np.array([[210, 350]], np.float32)


def first_frames(video_dir: str, max_frames: int) -> np.ndarray:
    """The first `max_frames` frames of a folder named <frame_index>.<ext>,
    as an RGB ndarray [T, H, W, 3]."""
    from PIL import Image

    names = sorted(os.listdir(video_dir), key=lambda p: int(os.path.splitext(p)[0]))
    return np.stack([np.array(Image.open(os.path.join(video_dir, n)).convert("RGB"))
                     for n in names[:max_frames]])


def main(video_path, checkpoint=None, variant="hiera_l", output_path="outputs/video_demo.mp4",
         max_frames=None, device=None):
    """Returns [(frame_idx, mask logits [objects, 1, H, W] as an ndarray)].
    On the card the predictor runs `speedup()` (bf16 CUDA graphs), elsewhere
    fp32 eagerly."""
    import cv2

    predictor = build_sam2_video_predictor(variant, checkpoint, device=device)
    if predictor.device.type == "cuda":
        predictor.speedup()
    if max_frames is not None:
        video_path = first_frames(video_path, int(max_frames))
    state = predictor.init_state(video_path)
    predictor.add_new_points_or_box(state, frame_idx=0, obj_id=1, points=POINT,
                                    labels=np.array([1], np.int32))
    results = [(frame_idx, masks.float().cpu().numpy())
               for frame_idx, _, masks in predictor.propagate_in_video(state)]

    h, w = state["video_height"], state["video_width"]
    write, release = gen_video_writer(output_path, 24.0, w, h)
    frames = state["images"].permute(0, 2, 3, 1).cpu().numpy()
    try:
        for frame_idx, masks in results:
            frame = cv2.resize(frames[frame_idx], (w, h))
            save_masks(frame, [masks[i, 0] for i in range(masks.shape[0])], write)
    finally:
        release()
    print(f"saved {len(results)} frames to {output_path}")
    return results


def cli():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("video_path")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--variant", default="hiera_l")
    parser.add_argument("--output_path", default="outputs/video_demo.mp4")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args()
    main(args.video_path, args.checkpoint, args.variant, args.output_path, args.max_frames,
         args.device)


if __name__ == "__main__":
    cli()
