"""Share of the traced window of whole animation chunks in which no
kernel, copy or memset ran on the card: 1 - busy / window."""


def read(run):
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
