"""Device time per training step of the rasterizer, forward and
backward: the records launched under the program's step.rasterize span
and the raster.* spans inside it (preprocess, binning, pair features,
the composite forward), under raster.composite_bwd and raster.unsort,
and by the backward operations of what they launched
(bwd:step.rasterize, bwd:raster.*), from one more chunk traced with the
host (counts/spans.py)."""
from counts import spans


def read(run):
    return spans.span_ms_per_unit(
        spans.read(run), ("step.rasterize", "raster.", "bwd:step.rasterize",
                          "bwd:raster."))
