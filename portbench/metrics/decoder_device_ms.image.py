"""Median over the untraced `predict` calls of the decoder seam's device
time from its stage events: `prompt_encoder` and `mask_decoder`, from the
seam's start to the mask decoder's end, inside its CUDA graph replay."""

from portbench.harness import program_trace as pt

STAGES = ("prompt_encoder", "mask_decoder")


def read(run):
    return pt.median_stage_ms(run, pt.harness_spans(run, "predict"), "predict_masks", STAGES)
