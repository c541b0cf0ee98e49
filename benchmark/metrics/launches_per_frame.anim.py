"""Kernel launches (CUDA runtime and driver launch calls) per animation
frame in one more pass traced with the host (counts/spans.py)."""
from counts import spans


def read(run):
    return spans.per_unit(spans.read(run), "launches")
