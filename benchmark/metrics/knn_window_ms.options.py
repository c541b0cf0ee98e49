"""Device time per training step of the windowed KNN statistic: the
records launched under the program's losses.knn_window span (the Morton
codes, the sort, the candidate blocks' distances and top-k; no
backward), from one more chunk traced with the host (counts/spans.py).
None where the program has no such span."""
from counts import spans


def read(run):
    return spans.span_ms_per_unit(spans.read(run), ("losses.knn_window",))
