"""Kernel launches (CUDA runtime and driver launch calls) per training
step in one more chunk traced with the host (counts/spans.py)."""
from counts import spans


def read(run):
    return spans.per_unit(spans.read(run), "launches")
