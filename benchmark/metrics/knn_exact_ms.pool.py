"""Device time per case-step of the exact KNN statistic: the records
launched under the program's losses.knn_exact span (the Morton codes,
the sort and the top-k walk of csrc/knn_topk.cu, and the mean edge
length; no backward), from one more chunk traced with the host
(counts/spans.py). None where the program has no such span."""
from counts import spans


def read(run):
    return spans.span_ms_per_unit(spans.read(run), ("losses.knn_exact",))
