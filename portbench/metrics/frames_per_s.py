"""Camera frames whose head maps the program produced in the window, over
the window's seconds on the host clock: all the work over all the time,
the traffic generator's included."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
