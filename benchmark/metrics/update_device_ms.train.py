"""Device time per training step of the records launched under the
program's step.update span (the finite guard, Adam, the kept state,
the density statistics), from one more chunk traced with the host
(counts/spans.py)."""
from counts import spans


def read(run):
    return spans.span_ms_per_unit(spans.read(run), ("step.update",))
