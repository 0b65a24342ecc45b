"""Median over the untraced `predict` calls of the port's host spans that
turn the decoder's output into the caller's: `predict.postprocess` (the
masks to the image's size, clamped, thresholded) and `predict.download`
(masks, IoUs and logits to the host). Notes on stderr each span's median,
with the prompts', the decoder seam's and its graph's copy-in and launch."""

from portbench.harness import program_trace as pt

SPANS = ("predict.postprocess", "predict.download")


def read(run):
    intervals = pt.harness_spans(run, "predict")
    value = pt.median_span_ms(run, intervals, set(SPANS))
    if value is not None:
        pt.note_span_medians(run, intervals, ("predict.prompts", "seam:predict_masks",
                                              "graph.copy_in:predict_masks",
                                              "graph.replay:predict_masks") + SPANS,
                             "predict spans")
    return value
