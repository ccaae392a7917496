"""Chrome/Perfetto ``trace_event`` export of the recorded spans.

``chrome_trace(path)`` writes the standard JSON object format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):
one ``"X"`` complete event per finished span (pid/tid/ts/dur in
microseconds, args passed through), plus ``"M"`` metadata naming the
process and every thread/track.  Load the file in ``chrome://tracing``
or https://ui.perfetto.dev — host threads and the async ``device``
track render as separate rows, so the pipeline's host-plan/device
overlap is directly visible.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.obs import trace


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    item = getattr(v, "item", None)       # numpy scalars
    if item is not None:
        try:
            return item()
        except Exception:
            pass
    return str(v)


def trace_events() -> List[Dict]:
    """The ``traceEvents`` list: metadata first, then every span as an
    ``"X"`` complete event with ts rebased to the earliest span."""
    evs = trace.events()
    pid = os.getpid()
    out: List[Dict] = [{"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name",
                        "args": {"name": "repro-fleet"}}]
    for tid, name in sorted(trace.thread_names().items()):
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": name}})
    t_base = min((e[2] for e in evs), default=0)
    for name, tid, t0, dur, args in evs:
        out.append({"ph": "X", "cat": "repro", "pid": pid, "tid": tid,
                    "ts": (t0 - t_base) / 1e3, "dur": dur / 1e3,
                    "name": name,
                    "args": {k: _jsonable(v) for k, v in args.items()}})
    return out


def chrome_trace(path: Optional[str] = None) -> Dict:
    """Build (and optionally write) the Chrome-trace JSON document."""
    doc = {"traceEvents": trace_events(), "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
