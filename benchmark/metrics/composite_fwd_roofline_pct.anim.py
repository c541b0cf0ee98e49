"""The first composite forward of the traced window: its bound (the
operations and bytes its inputs need, counts/composite.py) over its
kernel's device time."""
from counts import composite, launches, peaks


def read(run):
    c = launches.fwd_counts(run)
    t = launches.first_launch_s(run, launches.FWD_KERNEL)
    if c is None or not t:
        return None
    bound, _by = peaks.bound_s(*composite.fwd(c["walked"], c["n_tiles"],
                                              c["tile"]))
    return 100.0 * bound / t
