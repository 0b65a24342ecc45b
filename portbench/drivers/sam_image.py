"""Image requests through `SAM2ImagePredictor` on a Segment Anything ViT
model, one client in a closed loop: the image driver's traffic
(`drivers/image.py`: the same images and prompts from the seed, a request
from `set_image` to the third call's masks on the host) on a SAM ViT
configuration.

Set-up builds the port's model for the configuration's variant, refuses it
if its configuration differs from the file, and, under `--trace 1`, turns
the port's tracer on first, so that the encoder's stage events are read.
After the window the plain reference (`reference/sam_vit_ref.py`) answers
the sample of finished requests from the same images, prompts and weights;
every mask's low-res logits, its full-resolution mask and its IoU are
compared.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.drivers.image import STREAM_WARM, STREAM_WINDOW, _reference_request, \
    _request, make_request
from portbench.harness import compare, flops_vit, program, weights_vit
from portbench.reference import sam2_ref
from portbench.reference import sam_vit_ref as ref


def request_work(model: dict) -> dict:
    """The three calls' prompts: a click (padding point), a box, a box
    with a click and a mask."""
    prompts = ((1, False, False), (0, True, False), (1, True, True))
    return {"flops": flops_vit.encoder_flops(model)
            + sum(flops_vit.decoder_flops(model, *p) for p in prompts),
            "relpos": flops_vit.relpos_calls(model)}


def state_dict(ctx) -> dict:
    assumed = ctx.config.get("assumed", {})
    return weights_vit.make_state_dict(ref.config_from_json(ctx.config["model"]), ctx.seed,
                                       ctx.device, assumed["rel_pos_std"],
                                       assumed.get("state_dict_add"),
                                       assumed.get("state_dict_scale"))


def build_model(ctx, sd: dict):
    """The port's model for the configuration's variant holding `sd`;
    refuses a configuration that differs from the file."""
    from sam2_opt_tpu_torch.build_sam import build_sam2
    from sam2_opt_tpu_torch.config import sam_vit_config

    config, device = ctx.config, ctx.device
    ctx.mark("weights")
    if device.type == "cuda":
        from sam2_opt_tpu_torch.kernels import _build

        _build.build_all()
        ctx.mark("kernels built")
    cfg = sam_vit_config(config["variant"], **config.get("overrides", {}))
    with torch.device(device):
        model = build_sam2(config["variant"], state_dict=sd, device=device, cfg=cfg)
    bad = program._mismatches(model.cfg, config["model"])
    if bad:
        raise ValueError("the port's configuration differs from the benchmark's file: "
                         + "; ".join(bad))
    ctx.mark("model built")
    return model


def run(ctx):
    traffic, device = ctx.traffic, ctx.device
    if ctx.trace:
        from sam2_opt_tpu_torch.utils import profiling

        profiling.enable()
    from sam2_opt_tpu_torch.predictors.image import SAM2ImagePredictor

    ctx.mark("port imported")
    model = build_model(ctx, state_dict(ctx))
    predictor = SAM2ImagePredictor(model)
    program.speedup(ctx, predictor)

    for j in range(traffic["warm_requests"]):
        image, calls = make_request(ctx.seed, STREAM_WARM, j, traffic, device)
        _request(predictor, ctx.scratch_window(), image, calls, False)
    captures = model.graphs.captures
    ctx.mark("warm-up")

    window = ctx.start_window()
    sample = compare.Sample(ctx.seed, traffic["check_requests"])
    work, i = request_work(ctx.config["model"]), 0
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
    reference = ref.PredictorRef(
        ref.build(ref.config_from_json(ctx.config["model"]), state_dict(ctx), device), device)
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
            for m in range(masks.shape[0]):
                label = (f"request {k} call {c} mask {m} iou program {ious[m]:.4f} reference "
                         f"{r_ious[m].item():.4f}")
                readings.logits(torch.from_numpy(p_low[m]).to(device), low[m], label)
                readings.update("mask_flip_share", (torch.from_numpy(masks[m]).to(device)
                                                    != (r_masks[m] > 0)).double().mean(), label)
            readings.update("iou_gap", (torch.from_numpy(ious).to(device) - r_ious).abs().max(),
                            f"request {k} call {c}")
    ctx.compared(readings, checked=len(kept))
