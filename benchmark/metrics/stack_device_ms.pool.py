"""Device time per case-step of the case pool's restacking: the copies
launched under the program's pool.stack span, which stacks every
case's parameters, buffers, Adam moments and metrics on the case axis
again after each lockstep step, from one more chunk traced with the
host (counts/spans.py). None where the program has no such span."""
from counts import spans


def read(run):
    return spans.span_ms_per_unit(spans.read(run), ("pool.stack",))
