"""Seconds from the start of the process to the first timed step:
imports, the device's context, the kernel library's build or load, the
detector, the frozen masks, the fleet tables on them and the warm-up
steps."""


def read(run):
    return run.setup_s
