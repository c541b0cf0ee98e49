"""Calls that make the host wait for the card (stream, device and event
synchronisations, synchronous copies) per training step in one more
chunk traced with the host, its readback included (counts/spans.py)."""
from counts import spans


def read(run):
    return spans.per_unit(spans.read(run), "syncs")
