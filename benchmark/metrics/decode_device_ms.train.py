"""Device time per training step of the decode, forward and backward:
the records launched under the program's step.decode span
(avatar_forward: triplane, decoders, LBS), by the backward operations
of what it launched (bwd:step.decode) and under triplane.bwd, from one
more chunk traced with the host (counts/spans.py)."""
from counts import spans


def read(run):
    return spans.span_ms_per_unit(
        spans.read(run), ("step.decode", "bwd:step.decode", "triplane.bwd"))
