"""Fleet observability: tracing, typed metrics, SLO panels -- the port's
copy of ``repro.obs`` without its harnesses (``loadgen``, ``sentinel``).

All of it is off by default and adds no kernel launch and no device
synchronize: spans stamp host timestamps around points the paths already
pass through.

* ``obs.trace`` -- monotonic-clock spans (``with
  obs.trace.span("gate", step=t): ...``), thread- and contextvar-safe like
  ``ops.count_kernels``; ``begin``/``end`` handles put in-flight device
  work on a track of its own.  Export with ``obs.export.chrome_trace(path)``
  and open in chrome://tracing or Perfetto.
* ``obs.metrics`` -- typed counters, gauges and histograms with labels.
  ``kernel_dispatches`` mirrors ``ops.KERNEL_COUNTS``; the canonical
  ``KERNEL_NAMES`` frozenset makes a misspelt counter name raise.
* ``obs.slo`` -- ``StepReport``/``FleetSLOReport`` panels (p50/p99 delay,
  deadline hit rate, bytes shed, accuracy floor, changed-tile fraction).

Switch it on with ``obs.configure(enabled=True)`` (or scoped: ``with
obs.enabled(): ...``); ``configure(reset=True)`` clears the recorded spans
and metric values.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs import export, metrics, slo, state, trace  # noqa: F401


def configure(enabled=None, reset: bool = False) -> bool:
    """Set the global observability switch and/or reset recorded data.

    ``configure(enabled=True)`` turns span recording and metric updates
    on (default off — tier-1 tests and production paths pay one boolean
    check per call site).  ``configure(reset=True)`` clears the span
    buffer and zeroes every registered metric (registrations survive).
    Returns the resulting enabled state."""
    if enabled is not None:
        state.enabled = bool(enabled)
    if reset:
        trace.clear()
        metrics.REGISTRY.reset()
    return state.enabled


def is_enabled() -> bool:
    return state.enabled


@contextlib.contextmanager
def enabled(flag: bool = True):
    """Scoped enable/disable: ``with obs.enabled(): run_step()``."""
    prev = state.enabled
    state.enabled = bool(flag)
    try:
        yield
    finally:
        state.enabled = prev
