"""Image requests through `SAM2ImagePredictor`, one client in a closed loop.

Each request: a distinct image from the seed, `set_image`, then three
`predict` calls as an annotation tool makes them, each returning its masks
at the image's resolution, IoUs and low-res logits on the host: a positive
point on the target shape (multimask), the shape's box, and the box with a
second point and the previous call's low-res logits as `mask_input`. A
request's time runs from `set_image` to the third call's masks on the host.

After the window the reference answers the sample of finished requests
(drawn from the seed) from the same images and prompts; every mask's
low-res logits, its full-resolution mask and its predicted IoU are
compared.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.harness import compare, flops, program, synth
from portbench.reference import image_ref, sam2_ref

STREAM_WINDOW, STREAM_WARM = 20, 21


def make_request(seed, stream, index, traffic, device):
    """(image, prompts): the three calls' keyword arguments, mask_input
    left to the caller."""
    frames, _, shapes = synth.video(seed, stream, index, 1, traffic["height"], traffic["width"],
                                    1, traffic["shapes"], device)
    sh, sw, _, y0, x0 = shapes[0][:5]
    cx, cy = x0 + sw / 2.0, y0 + sh / 2.0
    box = np.array([x0, y0, x0 + sw, y0 + sh], np.float32)
    point = np.array([[cx, cy]], np.float32)
    second = np.array([[x0 + sw * 0.3, y0 + sh * 0.6]], np.float32)
    one = np.array([1], np.int32)
    return frames[0], [dict(point_coords=point, point_labels=one, multimask_output=True),
                       dict(box=box, multimask_output=False),
                       dict(point_coords=second, point_labels=one, box=box,
                            multimask_output=False)]


def request_work(model: dict) -> dict:
    return {"flops": flops.encoder_flops(model) + flops.decoder_flops(model, 1, 1, False)
            + flops.decoder_flops(model, 1, 2, False) + flops.decoder_flops(model, 1, 3, True),
            "k1": flops.k1_calls(model), "k2": []}


def _request(predictor, window, image, calls, traced: bool):
    outs = []
    with window.unit("request", traced=traced):
        with window.span("set_image"):
            predictor.set_image(image)
        low = None
        for kw in calls:
            if "box" in kw and "point_coords" in kw:
                kw = dict(kw, mask_input=low)
            with window.span("predict"):
                masks, ious, low = predictor.predict(**kw)
            outs.append((masks, ious, low))
    return outs


def _reference_request(reference, image, calls):
    """The reference's answers in the port's form: boolean masks, IoUs and
    low-res logits on the host."""
    reference.set_image(image)
    outs, low = [], None
    for kw in calls:
        if "box" in kw and "point_coords" in kw:
            kw = dict(kw, mask_input=low)
        masks, ious, low_t = reference.predict(**kw)
        low = low_t.cpu().numpy()
        outs.append(((masks > 0).cpu().numpy(), ious.cpu().numpy(), low))
    return outs


def run(ctx):
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor

    ctx.mark("port imported")
    model = program.build_model(ctx, program.state_dict(ctx))
    predictor = SAM2ImagePredictor(model)
    program.speedup(ctx, predictor)

    for j in range(traffic["warm_requests"]):
        image, calls = make_request(ctx.seed, STREAM_WARM, j, traffic, device)
        _request(predictor, ctx.scratch_window(), image, calls, False)
    captures = model.graphs.captures
    ctx.mark("warm-up")

    window = ctx.start_window()
    sample = compare.Sample(ctx.seed, traffic["check_requests"])
    work, i = request_work(cfg["model"]), 0
    while window.open():
        image, calls = make_request(ctx.seed, STREAM_WINDOW, i, traffic, device)
        traced = ctx.trace and traffic["traced_skip"] <= i < (traffic["traced_skip"]
                                                             + traffic["traced_requests"])
        with ctx.profiler(traced):
            outs = _request(predictor, window, image, calls, traced)
        window.units[-1].work = work
        sample.offer(i, 1, outs)
        i += 1
    ctx.end_window()
    if model.graphs.captures != captures:
        ctx.note(f"{model.graphs.captures - captures} CUDA graph captures inside the window")

    done = [u for u in window.units if u.done]
    ctx.metric("image_p95_ms", 1e3 * float(np.percentile([u.t1 - u.t0 for u in done], 95)))
    ctx.attempted = len(done)

    ctx.read_memory_peak()
    kept = {k: sample.kept[k] for k in sample.pick()}
    del predictor, model, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sam2_ref.plain_fp32()
    # the same weights, drawn again from the seed
    reference = image_ref.ImageRef(
        sam2_ref.build(program.reference_config(cfg), program.state_dict(ctx), device), device)
    readings = compare.Readings()
    for k, outs in kept.items():
        image, calls = make_request(ctx.seed, STREAM_WINDOW, k, traffic, device)
        if ctx.control == "fp8":  # the reference in fp8 in the port's place
            with sam2_ref.rounded(reference.model):
                outs = _reference_request(reference, image, calls)
        reference.set_image(image)
        low = None
        for c, (kw, (masks, ious, p_low)) in enumerate(zip(calls, outs)):
            if "box" in kw and "point_coords" in kw:
                kw = dict(kw, mask_input=low.cpu().numpy())
            r_masks, r_ious, low = reference.predict(**kw)
            if reference.margin is not None:
                readings.least("stability_margin", reference.margin, f"request {k} call {c}")
            for m in range(masks.shape[0]):
                label = (f"request {k} call {c} mask {m} iou program {ious[m]:.4f} reference "
                         f"{r_ious[m].item():.4f}")
                readings.logits(torch.from_numpy(p_low[m]).to(device), low[m], label)
                readings.update("mask_flip_share", (torch.from_numpy(masks[m]).to(device)
                                                    != (r_masks[m] > 0)).double().mean(), label)
            readings.update("iou_gap", (torch.from_numpy(ious).to(device) - r_ious).abs().max(),
                            f"request {k} call {c}")
    ctx.compared(readings, checked=len(kept))
