"""Median over the untraced requests of the port's host spans that turn the
image into the encoder's input: `image.prepare` (the array, stacked, as
uint8), `image.upload` (its pageable copy to the card) and `image.resize`
(to 1024² in the compute dtype). Notes on stderr each span's median,
with the encoder seam's and its graph launch's."""

from portbench.harness import program_trace as pt

SPANS = ("image.prepare", "image.upload", "image.resize")


def read(run):
    intervals = pt.untraced_units(run)
    value = pt.median_span_ms(run, intervals, set(SPANS))
    if value is not None:
        pt.note_span_medians(run, intervals, SPANS + ("seam:encode_image_e2e",
                                                      "graph.replay:encode_image_e2e"),
                             "set_image spans")
    return value
