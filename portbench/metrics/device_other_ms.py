"""Device time a step outside the program's CUDA kernels (ms): the 1x1
head's elementwise operations, frame stacking, padding, copies and fills
that the traced steps ran, from the profiler's device trace."""
from portbench import yardstick


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0:
        return None
    other = sum(s for name, s in tr.step_by_name.items()
                if not yardstick.is_port_kernel(name))
    return other / tr.steps * 1e3
