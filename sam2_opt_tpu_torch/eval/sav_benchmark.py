"""SA-V / DAVIS benchmark: folder scanning + multiprocess J&F.

Counterpart of `sam2_opt_tpu/eval/sav_benchmark.py`, with the worker pool
started with `spawn` (the calling process may hold a CUDA context, which a
forked worker must not inherit).

The J&F metric math (eval/metrics.py) derives from hkchengrex/vos-benchmark
(MIT) and davis2017-evaluation (BSD-3) via the reference's sav_dataset
utilities — see LICENSES/LICENSE_VOS_BENCHMARK and LICENSES/LICENSE_DAVIS —
and must stay numerically identical to be a meaningful benchmark. The
driving harness here (layout detection, scanning, aggregation) keeps the
reference's evaluation CONVENTIONS (skip first/last annotated frame,
per-object SA-V trees, mean-of-objects J&F) with its own organization.

Directory layouts supported (same as the reference sav_benchmark.py):

  DAVIS-style : <root>/<video>/<frame>.png        (multi-object palette pngs)
  SA-V-style  : <root>/<video>/<obj_id>/<frame>.png   (binary pngs per object)

Public API: `benchmark(gt_roots, mask_roots, ...)` — consumed by
examples/benchmark_compare.py and eval/sav_evaluator.py.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
import multiprocessing
from os import path
from typing import Dict, List, Optional, Tuple

import numpy as np

from sam2_opt_tpu_torch.eval.metrics import Evaluator


@dataclass(frozen=True)
class _Track:
    """One (video, object) mask sequence to score."""

    video: str
    obj_id: Optional[str]      # None for DAVIS palette layout
    frames: Tuple[str, ...]
    gt_dir: str
    pred_dir: str
    binary: bool               # SA-V per-object pngs are binary


def _discover_tracks(gt_root: str, pred_root: str, video: str) -> List[_Track]:
    """Detect the layout of one video folder and list its tracks."""
    gt_dir = path.join(gt_root, video)
    pred_dir = path.join(pred_root, video)
    entries = sorted(os.listdir(gt_dir))
    if all(e.endswith(".png") for e in entries):
        return [_Track(video, None, tuple(entries), gt_dir, pred_dir, False)]
    tracks = []
    for obj_id in entries:
        obj_gt = path.join(gt_dir, obj_id)
        tracks.append(_Track(
            video, obj_id, tuple(sorted(os.listdir(obj_gt))),
            obj_gt, path.join(pred_dir, obj_id), True,
        ))
    return tracks


def _read_png(file: str) -> np.ndarray:
    from PIL import Image

    with Image.open(file) as img:
        return np.array(img)


def _load_pair(track: _Track, frame: str) -> Tuple[np.ndarray, np.ndarray]:
    gt_file = path.join(track.gt_dir, frame)
    pred_file = path.join(track.pred_dir, frame)
    assert os.path.exists(pred_file), f"{pred_file} not found"
    gt = _read_png(gt_file)
    pred = _read_png(pred_file)
    assert gt.shape[-2:] == pred.shape[-2:], (
        f"shape mismatch: {gt_file}, {pred_file}"
    )
    if track.binary:
        assert len(np.unique(gt)) <= 2, (
            f"found more than 1 object in {gt_file} (SA-V format assumes one "
            "object mask per png)"
        )
        assert len(np.unique(pred)) <= 2, (
            f"found more than 1 object in {pred_file}"
        )
        gt = gt > 0
        pred = pred > 0
    return gt, pred


class _ScoreVideo:
    """Picklable per-video worker for the multiprocessing pool."""

    def __init__(self, gt_root: str, pred_root: str,
                 skip_first_and_last: bool):
        self.gt_root = gt_root
        self.pred_root = pred_root
        self.skip_first_and_last = skip_first_and_last

    def __call__(self, video: str):
        iou_by_obj: Dict = {}
        f_by_obj: Dict = {}
        for track in _discover_tracks(self.gt_root, self.pred_root, video):
            frames = track.frames
            if self.skip_first_and_last:
                # SA-V convention: the first and last annotated frames are
                # excluded from scoring
                frames = frames[1:-1]
            scorer = Evaluator(name=video, obj_id=track.obj_id)
            for frame in frames:
                gt, pred = _load_pair(track, frame)
                scorer.feed_frame(mask=pred, gt=gt)
            iou, boundary_f = scorer.conclude()
            if track.obj_id is None:
                # palette layout: the scorer already keys by object id
                iou_by_obj.update(iou)
                f_by_obj.update(boundary_f)
            elif iou:
                (iou_val,) = iou.values()
                (f_val,) = boundary_f.values()
                iou_by_obj[track.obj_id] = iou_val
                f_by_obj[track.obj_id] = f_val
            else:
                # a track with no non-empty GT in the scored frames (e.g.
                # visible only in the skipped first/last annotated frame, or
                # <= 2 annotated frames): nothing to score — skip the object
                # rather than aborting the whole benchmark run
                import warnings

                warnings.warn(
                    f"{video}/{track.obj_id}: no non-empty GT frames to "
                    "score; skipping object"
                )
        return video, iou_by_obj, f_by_obj


def _resolve_gt_root(gt_root: str, mask_root: str) -> str:
    """Accept a dataset root that nests videos under Annotations/."""
    gt_videos = os.listdir(gt_root)
    mask_videos = os.listdir(mask_root)
    if len(gt_videos) != len(mask_videos) and "Annotations" in gt_videos:
        anns = path.join(gt_root, "Annotations")
        if os.path.isdir(anns) and not os.listdir(anns)[0].endswith(".png"):
            return anns
    return gt_root


def _video_list(gt_root: str, mask_root: str, strict: bool) -> List[str]:
    gt_videos = {
        v for v in os.listdir(gt_root) if path.isdir(path.join(gt_root, v))
    }
    mask_videos = {
        v for v in os.listdir(mask_root) if path.isdir(path.join(mask_root, v))
    }
    if strict:
        extras = gt_videos ^ mask_videos
        if extras:
            raise RuntimeError(f"gt/pred video mismatch: {sorted(extras)}")
        return sorted(gt_videos)
    return sorted(gt_videos & mask_videos)


def benchmark(
    gt_roots,
    mask_roots,
    strict=True,
    num_processes=None,
    *,
    verbose=True,
    skip_first_and_last=True,
):
    """Score prediction folders against GT folders. Returns
    (global_jf, global_j, global_f, per-dataset per-video results) — one
    entry per (gt_root, mask_root) pair, matching the reference CLI."""
    assert len(gt_roots) == len(mask_roots)
    if verbose:
        action = "SKIPPING" if skip_first_and_last else "NOT SKIPPING"
        print(f"We are *{action}* the evaluation of the first and last frame.")

    all_global_jf, all_global_j, all_global_f = [], [], []
    all_results = []
    start = time.time()
    for gt_root, mask_root in zip(gt_roots, mask_roots):
        gt_root = _resolve_gt_root(gt_root, mask_root)
        videos = _video_list(gt_root, mask_root, strict)
        if verbose:
            print(f"In dataset {gt_root}, evaluating {len(videos)} videos")

        score = _ScoreVideo(gt_root, mask_root, skip_first_and_last)
        if num_processes and num_processes > 1:
            with multiprocessing.get_context("spawn").Pool(num_processes) as pool:
                results = pool.map(score, videos)
        else:
            results = [score(v) for v in videos]

        object_j, object_f = [], []
        per_video = {}
        for video, iou_by_obj, f_by_obj in results:
            js = list(iou_by_obj.values())
            fs = list(f_by_obj.values())
            object_j.extend(js)
            object_f.extend(fs)
            per_video[video] = {
                "J": float(np.mean(js)) if js else 0.0,
                "F": float(np.mean(fs)) if fs else 0.0,
            }
        gj = float(np.mean(object_j)) if object_j else 0.0
        gf = float(np.mean(object_f)) if object_f else 0.0
        gjf = (gj + gf) / 2
        all_global_j.append(gj)
        all_global_f.append(gf)
        all_global_jf.append(gjf)
        all_results.append(per_video)
        if verbose:
            print(f"{gt_root}: J&F {gjf:.1f}  J {gj:.1f}  F {gf:.1f}")
    if verbose:
        print(f"Total time: {time.time()-start:.1f}s")
    return all_global_jf, all_global_j, all_global_f, all_results
