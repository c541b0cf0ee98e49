"""The first composite backward of the traced window: its bound (the
operations and bytes its inputs need, counts/composite.py) over its
kernel's device time."""
from counts import composite, launches, peaks


def read(run):
    c = launches.bwd_counts(run)
    t = launches.first_launch_s(run, launches.BWD_KERNEL)
    if c is None or not t:
        return None
    bound, _by = peaks.bound_s(*composite.bwd(
        c["walked"], c["composited"], c["n_tiles"], c["tile"],
        c["grad_cap"]))
    return 100.0 * bound / t
