"""The share of one more animation pass's idle device time that overlaps
the program's raster.bin span: the card idle while the host bins. The
pass is traced with the card's records, the CUDA calls and the ranges
alone, so that the profiler adds no cost per host operation to the idle
time (counts/spans.py)."""
from counts import spans


def read(run):
    return spans.idle_pct(spans.read(run), "raster.bin")
