"""The share of the traced window in which no kernel, copy or fill ran on
the device (%), from the profiler's device trace."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
