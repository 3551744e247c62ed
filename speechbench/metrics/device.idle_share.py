"""The share of the profiled window, in %, in which nothing ran on the
device: one minus the union of kernel, copy and fill intervals over the
window's length."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
