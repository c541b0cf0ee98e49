"""Calls that make the host wait for the card (stream, device and event
synchronisations, synchronous copies) per animation frame in one more
pass traced with the host, the readbacks included (counts/spans.py)."""
from counts import spans


def read(run):
    return spans.per_unit(spans.read(run), "syncs")
