"""Typed metrics registry: counters / gauges / histograms with labels.

Generalizes ``kernels.ops.KERNEL_COUNTS`` (which stays — the
``kernel_dispatches`` counter family here receives the SAME bumps, so
snapshots bit-match the legacy counter) and gives the quantities the
subsystems already compute but drop on the floor a place to land:
changed-tile fractions, activation-cache hits/invalidations, bytes shed
by the rate controller, batcher backlog depth, deadline hit counts,
per-shard load, drift-breach windows.

Every instrument is a no-op while ``obs.state.enabled`` is False, so the
registry costs one attribute check per call site on the hot path.

IMPORT DISCIPLINE: ``kernels.ops`` imports :data:`KERNEL_NAMES` from
here to validate dispatch counter names, so this module (and everything
``repro_torch.obs`` imports at module scope) must never import back into
the rest of ``repro_torch`` — inputs from other subsystems arrive
duck-typed.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.obs import state

# The ONE canonical set of kernel-dispatch counter names.  Every
# ``ops.record_dispatch`` call site, and every dispatch-count assertion
# in tests and runs, must draw from this set — a typo'd name raises in
# ``record_dispatch`` (and fails the registry test) instead of silently
# counting zero forever.
KERNEL_NAMES = frozenset({
    "sbnet_gather", "sbnet_scatter", "sbnet_scatter_fleet",
    "sbnet_scatter_changed",
    "roi_conv", "roi_conv_packed", "roi_conv_fleet",
    "roi_conv_entry", "roi_conv_stack",
    "tile_delta", "tile_delta_gate", "tile_delta_halo",
    "roi_attention",
})

_LOCK = threading.Lock()


class _Metric:
    """Base: one named family; values keyed by the declared label tuple."""

    kind = "abstract"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._values: Dict[Tuple, object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} declared labels "
                f"{sorted(self.labelnames)}, got {sorted(labels)}")
        return tuple(labels[ln] for ln in self.labelnames)

    def items(self) -> List[Tuple[Tuple, object]]:
        with _LOCK:
            return list(self._values.items())

    def clear(self) -> None:
        with _LOCK:
            self._values.clear()


class Counter(_Metric):
    """Monotonic accumulator (ints or float quantities like bytes)."""

    kind = "counter"

    def inc(self, n=1, **labels) -> None:
        if not state.enabled:
            return
        key = self._key(labels)
        with _LOCK:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels):
        return self._values.get(self._key(labels), 0)

    def total(self):
        with _LOCK:
            return sum(self._values.values())


class Gauge(_Metric):
    """Last-write-wins point-in-time value."""

    kind = "gauge"

    def set(self, v, **labels) -> None:
        if not state.enabled:
            return
        key = self._key(labels)
        with _LOCK:
            self._values[key] = float(v)

    def value(self, **labels):
        return self._values.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Full-sample distribution (count/sum/p50/p99 in snapshots)."""

    kind = "histogram"

    def observe(self, v, **labels) -> None:
        if not state.enabled:
            return
        key = self._key(labels)
        with _LOCK:
            self._values.setdefault(key, []).append(float(v))

    def count(self, **labels) -> int:
        return len(self._values.get(self._key(labels), ()))

    def percentile(self, q: float, **labels) -> float:
        vs = self._values.get(self._key(labels), ())
        return float(np.percentile(np.asarray(vs), q)) if len(vs) else 0.0


class Registry:
    """Get-or-create instrument store; re-registering a name with a
    different type or label set raises instead of shadowing."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str,
                  labelnames: Sequence[str]) -> _Metric:
        with _LOCK:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.labelnames}, cannot re-register as "
                        f"{cls.kind}{tuple(labelnames)}")
                return m
            m = cls(name, help, labelnames)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=()) -> Histogram:
        return self._register(Histogram, name, help, labels)

    def get(self, name: str) -> _Metric:
        return self._metrics[name]

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every instrument's values (registrations survive)."""
        for m in list(self._metrics.values()):
            m.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """Serializable view: {name: {type, labels, values: [...]}} —
        histograms collapse to count/sum/min/max/p50/p99."""
        snap: Dict[str, Dict] = {}
        for name in self.names():
            m = self._metrics[name]
            vals = []
            for key, v in m.items():
                if m.kind == "histogram":
                    arr = np.asarray(v, float)
                    v = {"count": int(arr.size), "sum": float(arr.sum()),
                         "min": float(arr.min()) if arr.size else 0.0,
                         "max": float(arr.max()) if arr.size else 0.0,
                         "p50": float(np.percentile(arr, 50))
                         if arr.size else 0.0,
                         "p99": float(np.percentile(arr, 99))
                         if arr.size else 0.0}
                vals.append({"labels": dict(zip(m.labelnames, key)),
                             "value": v})
            snap[name] = {"type": m.kind, "labels": list(m.labelnames),
                          "values": vals}
        return snap


REGISTRY = Registry()


def counter(name, help="", labels=()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name, help="", labels=()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name, help="", labels=()) -> Histogram:
    return REGISTRY.histogram(name, help, labels)


# ---------------------------------------------------------------------------
# the core instrument families (declared once, bumped from the runtimes)
# ---------------------------------------------------------------------------

# ops.record_dispatch mirrors every bump here — bit-compatible with the
# legacy ops.KERNEL_COUNTS over the same window (see kernel_counts()).
KERNEL_DISPATCHES = REGISTRY.counter(
    "kernel_dispatches", "CUDA kernel launches by wrapper name",
    ("kernel",))

STEP_WALL = REGISTRY.histogram(
    "step_wall_s", "Wall time of one fleet step by runtime path",
    ("path",))

TILES = REGISTRY.counter(
    "fleet_tiles", "Per-step tile accounting: total / raw_changed / "
    "changed_dilated (post neighbor-dilation compute set) / computed / "
    "launched (padded)", ("kind",))

CHANGED_FRACTION = REGISTRY.gauge(
    "changed_tile_fraction", "raw gate-changed tiles / active tiles, "
    "latest step")

CACHE_EVENTS = REGISTRY.counter(
    "activation_cache_events", "PackedActivationCache traffic: step / "
    "cold_step / hit (tiles composited from cache) / invalidation",
    ("event",))

TRANSPORT_BYTES = REGISTRY.counter(
    "transport_bytes", "Wire accounting: base (un-shed) / shipped / "
    "shed_halo / shed_body", ("part",))

DEADLINE_EVENTS = REGISTRY.counter(
    "deadline_events", "Release accounting: release / deadline_hit / "
    "straggler_frame / frame", ("event",))

BACKLOG_DEPTH = REGISTRY.histogram(
    "backlog_depth", "Queued segments at each batcher release")

SERVE_EVENTS = REGISTRY.counter(
    "serve_events", "ServingEngine flushes: request / complete_flush / "
    "deadline_flush / straggler_request", ("event",))

SHARD_TILES = REGISTRY.gauge(
    "shard_computed_tiles", "Compute-set size per shard, latest step",
    ("shard",))

SHARD_IMBALANCE = REGISTRY.gauge(
    "shard_load_imbalance", "max/mean per-shard computed tiles, "
    "latest step")

DRIFT_EVENTS = REGISTRY.counter(
    "drift_events", "Drift monitor: breach_window / resolve / "
    "shrink_adopted / shrink_rejected", ("event",))

DRIFT_RESOLVE_WALL = REGISTRY.histogram(
    "drift_resolve_s", "Wall time of warm set-cover re-solves")

FAULT_EVENTS = REGISTRY.counter(
    "fault_events", "Fault lifecycle: injected / detected / failover / "
    "restored / shard_lost / shard_restored", ("event",))

HEARTBEAT_EVENTS = REGISTRY.counter(
    "heartbeat_events", "Transport heartbeat: dead / retry / restored",
    ("event",))

CANVAS_BYTES = REGISTRY.gauge(
    "canvas_bytes_written", "Bytes scattered into the persistent head-map "
    "canvas, latest step (0 on an all-static step)")

CANVAS_BYTES_TOTAL = REGISTRY.counter(
    "canvas_bytes_total", "Cumulative bytes scattered into the persistent "
    "head-map canvas across steps")

UNCOVERED_FRACTION = REGISTRY.gauge(
    "uncovered_fraction", "Degraded-mode coverage hole: fraction of "
    "ground-truth appearances no surviving camera's mask covers, "
    "latest step (0.0 when failover fully reassigned coverage)")


def kernel_counts() -> Dict[str, int]:
    """{kernel: launches} from the ``kernel_dispatches`` family — the
    bit-match surface against ``ops.KERNEL_COUNTS`` deltas over the same
    window (reset this registry at the window start)."""
    return {key[0]: v for key, v in KERNEL_DISPATCHES.items()}


# ---------------------------------------------------------------------------
# duck-typed recording helpers shared by the fleet runtimes
# ---------------------------------------------------------------------------

def observe_fleet_step(stats, wall_s: float, path: str) -> None:
    """Record one delta-gated fleet step's tile/cache accounting.

    ``stats`` is duck-typed over ``serving.detector.ReuseStats`` and
    ``fleet.sharded.ShardedReuseStats`` (total_tiles / raw_changed /
    changed_out / computed / launched, plus either ``cold`` or
    ``cold_shards`` and optionally ``per_shard_computed``)."""
    if not state.enabled:
        return
    STEP_WALL.observe(wall_s, path=path)
    total = int(stats.total_tiles)
    TILES.inc(total, kind="total")
    TILES.inc(int(stats.raw_changed), kind="raw_changed")
    TILES.inc(int(stats.changed_out), kind="changed_dilated")
    TILES.inc(int(stats.computed), kind="computed")
    TILES.inc(int(stats.launched), kind="launched")
    CHANGED_FRACTION.set(stats.raw_changed / total if total else 0.0)
    cold = bool(getattr(stats, "cold", False)) \
        or bool(getattr(stats, "cold_shards", 0))
    CACHE_EVENTS.inc(1, event="step")
    if cold:
        CACHE_EVENTS.inc(1, event="cold_step")
    else:
        CACHE_EVENTS.inc(total - int(stats.computed), event="hit")
    canvas_bytes = getattr(stats, "canvas_bytes", None)
    if canvas_bytes is not None:
        CANVAS_BYTES.set(float(canvas_bytes))
        CANVAS_BYTES_TOTAL.inc(float(canvas_bytes))
    per_shard = getattr(stats, "per_shard_computed", None)
    if per_shard:
        mean = sum(per_shard) / len(per_shard)
        for s, v in enumerate(per_shard):
            SHARD_TILES.set(v, shard=str(s))
        SHARD_IMBALANCE.set(max(per_shard) / mean if mean else 1.0)


def observe_transport(ts) -> None:
    """Record one ``simulate_transport`` window (duck-typed
    ``TransportStats``): wire bytes, shed composition, deadline hits,
    straggler frames."""
    if not state.enabled:
        return
    TRANSPORT_BYTES.inc(float(ts.bytes_base), part="base")
    TRANSPORT_BYTES.inc(float(ts.bytes_total), part="shipped")
    TRANSPORT_BYTES.inc(float(ts.shed_halo_bytes), part="shed_halo")
    TRANSPORT_BYTES.inc(float(ts.shed_body_bytes), part="shed_body")
    DEADLINE_EVENTS.inc(int(ts.deadline_hits), event="deadline_hit")
    DEADLINE_EVENTS.inc(int(ts.straggler_frames), event="straggler_frame")
    DEADLINE_EVENTS.inc(int(ts.latency_s.size), event="frame")
