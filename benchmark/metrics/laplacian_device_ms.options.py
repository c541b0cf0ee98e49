"""Device time per training step of the fused region laplacian terms
(here the cotangent laplacian's gather and region sums), forward and
backward: the records launched under the program's losses.laplacian
span and by the backward operations of what it launched
(bwd:losses.laplacian, the transposed gather), from one more chunk
traced with the host (counts/spans.py). None where the program has no
such span."""
from counts import spans


def read(run):
    return spans.span_ms_per_unit(spans.read(run),
                                  ("losses.laplacian",
                                   "bwd:losses.laplacian"))
