"""Concurrent multi-session video demo (counterpart of
`examples/video_multi_thread.py`; reference video_multi_thread.py:1-88):
two Python threads share ONE predictor, each tracking its own session of
the video. The reference gave each thread its own CUDA stream; here the
predictor's sessions are independent and its seams (CUDA graphs after
`speedup()`, shared by both) serialize their replays under one lock.

    python -m sam2_opt_tpu_torch.examples.video_multi_thread VIDEO
        [--checkpoint ckpt.pt] [--variant hiera_l] [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from sam2_opt_tpu_torch import build_sam2_video_predictor


def run_sync(predictor, video_path, point, name, results):
    state = predictor.init_state(video_path)
    predictor.add_new_points_or_box(state, frame_idx=0, obj_id=1,
                                    points=np.array([point], np.float32),
                                    labels=np.array([1], np.int32))
    t0 = time.time()
    n = sum(1 for _ in predictor.propagate_in_video(state))
    results[name] = (n, time.time() - t0)
    print(f"[{name}] propagated {n} frames in {results[name][1]:.1f}s")


def main(video_path, checkpoint=None, variant="hiera_l", device=None):
    """Returns {session: (frames, seconds)}."""
    predictor = build_sam2_video_predictor(variant, checkpoint, device=device)
    if predictor.device.type == "cuda":
        predictor.speedup()
    results = {}
    threads = [threading.Thread(target=run_sync, args=(predictor, video_path, point, name,
                                                       results))
               for point, name in (([210, 350], "session-a"), ([300, 200], "session-b"))]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(results) != len(threads):
        raise RuntimeError(f"sessions {sorted(results)} of 2 finished")
    print(f"2 concurrent sessions done in {time.time() - t0:.1f}s: {results}")
    return results


def cli():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("video_path")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--variant", default="hiera_l")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args()
    main(args.video_path, args.checkpoint, args.variant, args.device)


if __name__ == "__main__":
    cli()
