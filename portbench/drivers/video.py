"""Video sessions through `SAM2VideoPredictor`, one client in a closed loop.

Each session: a distinct video from the seed (its length from the traffic
file's list, in an order drawn from the seed), `init_state`, one positive click on frame 0 per
object, `propagate_in_video` to the last frame with every frame's masks
(the logits above 0, as a user takes them) copied to the host,
`reset_state`. A frame's time runs from asking the generator for it to
holding its video-resolution masks on the host.

A session that can still be in the comparison's sample (the longest and
others drawn from the seed) also keeps a copy of its video-resolution
logits on the card. After the window the reference tracks the sampled
sessions from the same videos and clicks, and their logits are compared
frame by frame and object by object.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.harness import compare, flops, program, synth
from portbench.reference import sam2_ref, video_ref

STREAM_WINDOW, STREAM_WARM = 10, 11


def session_frames(seed: int, index: int, traffic: dict) -> int:
    """Session lengths cycle through the traffic file's list, each cycle in
    an order drawn from the seed: every seed sends the same mix."""
    lengths = traffic["frames"]
    cycle, pos = divmod(index, len(lengths))
    order = synth.unit_rng(seed, STREAM_WINDOW + 100, cycle).permutation(len(lengths))
    return int(lengths[order[pos]])


def make_session(seed, stream, index, frames, traffic, device):
    video, clicks, _ = synth.video(seed, stream, index, frames, traffic["height"],
                                   traffic["width"], traffic["objects"], traffic["shapes"],
                                   device)
    return video, clicks


def session_work(model: dict, frames: int, objects: int) -> dict:
    """What a session asks of the model: operations, and the K1 and K2
    calls with their shapes and the memory tokens present at each frame."""
    g = model["image_size"] // model["backbone_stride"]
    N = g * g
    k1 = flops.k1_calls(model)
    cap_keys = model["num_maskmem"] * N + model["max_obj_ptrs_in_encoder"] * (
        model["hidden_dim"] // model["mem_dim"])
    d = model["memory_attention"]["d_model"]
    max_ptrs = min(frames, model["max_obj_ptrs_in_encoder"])
    total = flops.encoder_flops(model) + objects * (
        flops.decoder_flops(model, 1, 1, False) + flops.pointer_flops(model, 1, 0)
        + flops.memory_encoder_flops(model, 1))
    calls_k1, calls_k2 = list(k1), []
    for f in range(1, frames):
        n_mem = 1 + min(f - 1, model["num_maskmem"] - 1)
        n_ptr = 1 + min(f - 1, max_ptrs - 1)
        valid = n_mem * N + n_ptr * (model["hidden_dim"] // model["mem_dim"])
        total += (flops.encoder_flops(model)
                  + flops.memory_attention_flops(model, objects, valid)
                  + flops.decoder_flops(model, objects, 1, False)
                  + flops.memory_encoder_flops(model, objects)
                  + flops.pointer_flops(model, objects, n_ptr))
        calls_k1 += k1
        for _ in range(model["memory_attention"]["num_layers"]):
            calls_k2.append((objects, N, N, d, objects * N))
            calls_k2.append((objects, N, cap_keys, d, objects * valid))
    return {"flops": total, "k1": calls_k1, "k2": calls_k2, "frames": frames}


def _session(predictor, window, video, clicks, traced: bool, keep: bool):
    """One session in the window; returns the video-res logits per frame,
    kept on the card, if `keep`, else None."""
    T = video.shape[0]
    outs = [] if keep else None
    with window.unit("session", traced=traced):
        with window.span("init_state"):
            state = predictor.init_state(video)
            for k, (x, y) in enumerate(clicks):
                predictor.add_new_points_or_box(state, 0, k + 1,
                                                points=np.array([[x, y]], np.float32),
                                                labels=np.array([1], np.int32))
        frames = predictor.propagate_in_video(state)
        for _ in range(T):
            with window.span("frame"):
                _, _, logits = next(frames)
                (logits[:, 0] > 0).cpu().numpy()
                if keep:
                    outs.append(logits[:, 0].clone())
        frames.close()
        predictor.reset_state(state)
    return outs


def run(ctx):
    """The cell: set-up, warm-up, window, then the comparison."""
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    from sam2_opt_tpu_torch.predictors.variants import select_video_predictor_cls

    ctx.mark("port imported")
    model = program.build_model(ctx, program.state_dict(ctx))
    predictor = select_video_predictor_cls()(model, fill_hole_area=traffic["fill_hole_area"])
    program.speedup(ctx, predictor)

    # warm-up: one short session of the cell's shapes captures every graph
    warm, clicks = make_session(ctx.seed, STREAM_WARM, 0, traffic["warm_frames"], traffic,
                                device)
    _session(predictor, ctx.scratch_window(), warm, clicks, False, True)
    captures = model.graphs.captures
    ctx.mark("warm-up")

    window = ctx.start_window()
    sample = compare.Sample(ctx.seed, traffic["check_sessions"])
    specs, i = {}, 0
    while window.open():
        T = session_frames(ctx.seed, i, traffic)
        video, clicks = make_session(ctx.seed, STREAM_WINDOW, i, T, traffic, device)
        traced = ctx.trace and i < traffic["traced_sessions"]
        with ctx.profiler(traced):
            outs = _session(predictor, window, video, clicks, traced, sample.wants(i, T))
        window.units[-1].work = session_work(cfg["model"], T, len(clicks))
        specs[i] = T
        if outs is not None:
            sample.offer(i, T, outs)
        i += 1
    ctx.end_window()
    if model.graphs.captures != captures:
        ctx.note(f"{model.graphs.captures - captures} CUDA graph captures inside the window")

    done = [u for u in window.units if u.done]
    frame_s = [s.seconds for s in window.finished_spans("frame")]
    ctx.metric("video_frames_per_s", sum(u.work["frames"] for u in done)
               / window.busy_seconds())
    ctx.metric("video_frame_p95_ms", 1e3 * float(np.percentile(frame_s, 95)))
    ctx.attempted = len(done)

    ctx.read_memory_peak()
    kept = {k: sample.kept[k] for k in sample.pick()}
    del predictor, model, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sam2_ref.plain_fp32()
    # the same weights, drawn again from the seed
    reference = sam2_ref.build(program.reference_config(cfg), program.state_dict(ctx), device)
    readings = compare.Readings()
    for k, outs in kept.items():
        video, clicks = make_session(ctx.seed, STREAM_WINDOW, k, specs[k], traffic, device)
        if ctx.control == "fp8":  # the reference in fp8 in the port's place
            with sam2_ref.rounded(reference):
                low = video_ref.track(reference, video, clicks, traffic["fill_hole_area"], device)
            outs = list(low)
            del low
        ref_logits = video_ref.track(reference, video, clicks, traffic["fill_hole_area"], device)
        for t, frame in enumerate(outs):
            for obj in range(frame.shape[0]):
                readings.logits(frame[obj], ref_logits[t, obj],
                                f"session {k} frame {t} object {obj}")
        del ref_logits
    ctx.compared(readings, checked=sum(specs[k] for k in kept))
