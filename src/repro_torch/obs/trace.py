"""Lightweight span tracing for the gate→launch→transport→serve path.

``span(name, **args)`` is a context manager stamping monotonic
(``time.perf_counter_ns``) begin/duration pairs into a process-wide
event list; ``begin(name, track=...)`` returns a handle for work whose
completion is observed later than its start — the async pipeline opens a
``device_compute`` span at dispatch and ends it at the ``collect()``
fence, so host-plan and device spans visibly overlap on separate
timeline tracks without adding a single sync point.

Thread-safety mirrors ``ops.count_kernels``: events carry the emitting
thread's tid (host threads get small stable ids; named tracks get their
own reserved tid range), appends take one lock, and a disabled tracer
returns a shared null object — zero allocation beyond the kwargs dict,
zero device dispatches ever.  Export with ``obs.export.chrome_trace``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

from repro_torch.obs import state

_LOCK = threading.Lock()
# finished spans: (name, tid, t0_ns, dur_ns, args)
_EVENTS: List[Tuple[str, int, int, int, dict]] = []
_HOST_TIDS: Dict[int, Tuple[int, str]] = {}   # thread ident -> (tid, name)
_TRACK_TIDS: Dict[str, int] = {}              # track name -> tid
TRACK_TID_BASE = 1000                         # host tids stay below this


class _NullSpan:
    """Shared do-nothing span/handle returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        pass

    def end(self, **args):
        pass


NULL_SPAN = _NullSpan()


def _host_tid() -> int:
    ident = threading.get_ident()
    ent = _HOST_TIDS.get(ident)
    if ent is None:
        with _LOCK:
            ent = _HOST_TIDS.setdefault(
                ident, (len(_HOST_TIDS) + 1,
                        threading.current_thread().name))
    return ent[0]


def _track_tid(track: str) -> int:
    tid = _TRACK_TIDS.get(track)
    if tid is None:
        with _LOCK:
            tid = _TRACK_TIDS.setdefault(
                track, TRACK_TID_BASE + len(_TRACK_TIDS))
    return tid


class Span:
    """``with span("gate", step=t):`` — closed on the emitting thread."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args
        self._t0 = 0

    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        ev = (self.name, _host_tid(), self._t0, dur, self.args)
        with _LOCK:
            _EVENTS.append(ev)
        return False


class AsyncSpan:
    """begin()/end() span on a named track — for in-flight device work
    whose completion is only observed at an existing fence."""

    __slots__ = ("name", "args", "track", "_t0", "_done")

    def __init__(self, name: str, track: str, args: dict):
        self.name = name
        self.track = track
        self.args = args
        self._done = False
        self._t0 = time.perf_counter_ns()

    def end(self, **args) -> None:
        if self._done:
            return
        self._done = True
        dur = time.perf_counter_ns() - self._t0
        self.args.update(args)
        ev = (self.name, _track_tid(self.track), self._t0, dur, self.args)
        with _LOCK:
            _EVENTS.append(ev)


def span(name: str, **args):
    """Open a host-thread span; no-op shared object when disabled."""
    if not state.enabled:
        return NULL_SPAN
    return Span(name, args)


def begin(name: str, track: str = "device", **args):
    """Start an async span on ``track`` NOW; close it with
    ``handle.end()`` wherever the completion is already observed."""
    if not state.enabled:
        return NULL_SPAN
    return AsyncSpan(name, track, args)


def events() -> List[Tuple[str, int, int, int, dict]]:
    with _LOCK:
        return list(_EVENTS)


def span_count() -> int:
    return len(_EVENTS)


def clear() -> None:
    with _LOCK:
        _EVENTS.clear()


def thread_names() -> Dict[int, str]:
    """{tid: display name} for every host thread and named track seen."""
    with _LOCK:
        out = {tid: name for tid, name in _HOST_TIDS.values()}
        out.update({tid: trk for trk, tid in _TRACK_TIDS.items()})
    return out
