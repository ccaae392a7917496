"""The traced run's device trace, reduced to what the per-layer metrics
read.

A run with ``--trace 1`` profiles a short steady stretch of its window
with ``torch.profiler`` (host operations and CUDA activity).  The
benchmark marks its own spans with ``record_function``: the traced
window, each step's hand-over to the program (``fleet_reuse_step``) and
the traffic generator (``traffic``).  ``reduce_trace`` turns the
profile into plain numbers: device time by operation name, the device's
busy time, each step's device time, and the idle gaps of the device with
the innermost host operation or span running at each gap's middle.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW_SPAN = "portbench.window"
STEP_SPAN = "fleet_reuse_step"
TRAFFIC_SPAN = "traffic"


@dataclass
class DeviceTrace:
    """A traced window, reduced."""
    window_s: float                       # the traced window's length
    busy_s: float                         # union of device activity in it
    steps: int                            # program steps in it
    by_name: Dict[str, float]             # device seconds by operation
    step_by_name: Dict[str, float]        # ... inside the program's steps
    step_calls: Dict[str, int]            # device records by name in them
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _union_s(intervals: np.ndarray) -> float:
    """Total length of the union of (start, end) rows."""
    if len(intervals) == 0:
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0])]
    total, cur_s, cur_e = 0.0, iv[0, 0], iv[0, 1]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + cur_e - cur_s


def _gaps(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The (start, end) stretches of [lo, hi] no interval covers."""
    out, t = [], lo
    for s, e in intervals[np.argsort(intervals[:, 0])]:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return np.array([g for g in out if g[1] > g[0]], np.float64) \
        .reshape(-1, 2)


def reduce_events(host: List[Tuple[str, float, float]],
                  device: List[Tuple[str, float, float]],
                  top: int = 10) -> Optional[DeviceTrace]:
    """Reduce (name, start_us, end_us) host and device events.  None when
    the window span is missing or no device operation ran in it."""
    windows = [(s, e) for n, s, e in host if n == WINDOW_SPAN]
    if not windows:
        return None
    lo, hi = windows[0]
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in device
           if e > lo and s < hi]
    if not dev:
        return None
    iv = np.array([(s, e) for _, s, e in dev], np.float64)
    steps = [(s, e) for n, s, e in host
             if n == STEP_SPAN and s >= lo and e <= hi]
    by_name: Dict[str, float] = collections.Counter()
    step_by_name: Dict[str, float] = collections.Counter()
    step_calls: Dict[str, int] = collections.Counter()
    for n, s, e in dev:
        by_name[n] += (e - s) * 1e-6
        if any(a <= s < b for a, b in steps):
            step_by_name[n] += (e - s) * 1e-6
            step_calls[n] += 1
    # each idle gap goes to the innermost host event at its middle
    inner = [(n, s, e) for n, s, e in host
             if n != WINDOW_SPAN and e > lo and s < hi]
    starts = np.array([s for _, s, _ in inner], np.float64)
    ends = np.array([e for _, _, e in inner], np.float64)
    gap_by_what: Dict[str, float] = collections.Counter()
    for a, b in _gaps(iv, lo, hi):
        mid = 0.5 * (a + b)
        hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
        what = inner[hit[np.argmax(starts[hit])]][0] if hit.size \
            else "(no host operation)"
        gap_by_what[what] += (b - a) * 1e-6
    return DeviceTrace(
        window_s=(hi - lo) * 1e-6, busy_s=_union_s(iv) * 1e-6,
        steps=len(steps), by_name=dict(by_name),
        step_by_name=dict(step_by_name), step_calls=dict(step_calls),
        idle_gaps=sorted(gap_by_what.items(), key=lambda kv: -kv[1])[:top])


def profile_events(prof):
    """(host, device) (name, start_us, end_us) events of a finished
    ``torch.profiler.profile``.  The profiler mirrors each host span on
    the device's timeline as an annotation; those are not device work and
    are left out."""
    from torch.autograd import DeviceType
    host, device = [], []
    spans = (WINDOW_SPAN, STEP_SPAN, TRAFFIC_SPAN)
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != DeviceType.CUDA:
            host.append(row)
        elif not getattr(e, "is_user_annotation", False) \
                and e.name not in spans:
            device.append(row)
    return host, device


def breakdown(tr: DeviceTrace, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps by what the host was doing."""
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[short(n), s] for n, s in ops],
            "idle_gaps": [[short(n), s] for n, s in tr.idle_gaps[:top]]}


def short(name: str, width: int = 120) -> str:
    """An operation's name without its return type, namespace, template
    and argument lists, at most ``width`` characters."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    for ch in "(<":
        i = n.find(ch)
        if i > 0:
            n = n[:i]
    return n.strip()[:width]
