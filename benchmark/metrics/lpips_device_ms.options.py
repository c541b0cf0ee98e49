"""Device time per training step of the LPIPS term, forward and
backward: the records launched under the program's losses.lpips span
(the VGG16 features of both sides' patches, the distance) and by the
backward operations of what it launched (bwd:losses.lpips), from one
more chunk traced with the host (counts/spans.py). None where the
program has no such span."""
from counts import spans


def read(run):
    return spans.span_ms_per_unit(spans.read(run),
                                  ("losses.lpips", "bwd:losses.lpips"))
