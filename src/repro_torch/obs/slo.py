"""SLO panels: per-step and fleet-level service-objective reports.

``StepReport`` snapshots one delta-gated fleet step (wall, tile
accounting, dispatch structure); ``FleetSLOReport`` aggregates a run —
p50/p99 response delay and per-part p99s (reusing ``TransportStats``'
part accounting), deadline hit rate, bytes shed by composition,
accuracy floor, changed-tile fraction, activation-cache traffic — into
one serializable panel.

Inputs arrive duck-typed (``TransportStats``, ``ReuseStats`` /
``ShardedReuseStats``, ``PackedActivationCache``) — this module never
imports the subsystems it summarizes, so everything in ``repro_torch`` may
import it freely.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class StepReport:
    """One fleet step's accounting."""
    step: int
    wall_s: float
    total_tiles: int
    changed_tiles: int          # raw gate-changed
    computed_tiles: int         # post-dilation compute set
    launched_tiles: int         # padded launch rows (honest GEMM work)
    cold: bool
    dispatches: Dict[str, int] = field(default_factory=dict)
    # bytes scattered into the persistent head canvas (0 on all-static
    # steps — the zero-copy contract the sentinel watches)
    canvas_bytes: int = 0

    @property
    def changed_fraction(self) -> float:
        return self.changed_tiles / max(self.total_tiles, 1)

    @property
    def compute_fraction(self) -> float:
        return self.computed_tiles / max(self.total_tiles, 1)

    @classmethod
    def from_reuse(cls, step: int, wall_s: float, counts,
                   stats) -> "StepReport":
        """Build from ``fleet_reuse_step`` / ``sharded_fleet_step``
        outputs (stats duck-typed over ReuseStats/ShardedReuseStats)."""
        cold = bool(getattr(stats, "cold", False)) \
            or bool(getattr(stats, "cold_shards", 0))
        return cls(step=step, wall_s=float(wall_s),
                   total_tiles=int(stats.total_tiles),
                   changed_tiles=int(stats.raw_changed),
                   computed_tiles=int(stats.computed),
                   launched_tiles=int(stats.launched),
                   cold=cold, dispatches=dict(counts),
                   canvas_bytes=int(getattr(stats, "canvas_bytes", 0)))

    def to_dict(self) -> Dict:
        return {"step": self.step, "wall_s": self.wall_s,
                "total_tiles": self.total_tiles,
                "changed_tiles": self.changed_tiles,
                "computed_tiles": self.computed_tiles,
                "launched_tiles": self.launched_tiles,
                "changed_fraction": self.changed_fraction,
                "compute_fraction": self.compute_fraction,
                "cold": self.cold, "dispatches": self.dispatches,
                "canvas_bytes": self.canvas_bytes}


@dataclass
class FleetSLOReport:
    """Run-level SLO panel."""
    steps: List[StepReport] = field(default_factory=list)
    # response delay (from the transport simulation)
    p50_delay_s: float = 0.0
    p99_delay_s: float = 0.0
    mean_delay_s: float = 0.0
    part_p99_s: Dict[str, float] = field(default_factory=dict)
    # deadline / straggler accounting
    deadline_hits: int = 0
    deadline_hit_rate: float = 0.0
    straggler_frac: float = 0.0
    # network bytes
    bytes_total: float = 0.0
    bytes_base: float = 0.0
    shed_bytes: float = 0.0
    shed_halo_bytes: float = 0.0
    shed_body_bytes: float = 0.0
    quality_min: float = 1.0
    # accuracy
    accuracy_floor: float = 1.0
    accuracy_mean: float = 1.0
    # compute
    changed_tile_fraction: float = 0.0
    compute_tile_fraction: float = 0.0
    step_wall_p50_s: float = 0.0
    step_wall_p99_s: float = 0.0
    # persistent-canvas traffic: mean bytes scattered per step, and the
    # bytes-written-vs-changed-fraction ratio (bytes per changed tile —
    # flat when writes scale with change, inflated when static tiles
    # are being rewritten)
    canvas_bytes_per_step: float = 0.0
    canvas_bytes_per_changed_tile: float = 0.0
    cache: Dict[str, float] = field(default_factory=dict)
    # degraded-mode coverage (fault failover): fraction of ground-truth
    # appearances NO surviving camera's mask covers — 0.0 in healthy
    # operation, explicitly nonzero when failover could not reassign a
    # dead camera's coverage (never silently zero: the chaos harness
    # feeds the per-step series in)
    uncovered_frac_mean: float = 0.0
    uncovered_frac_p99: float = 0.0

    @classmethod
    def build(cls, steps: Sequence[StepReport] = (),
              transport=None, accuracy_floor: float = 1.0,
              accuracy_mean: float = 1.0, cache=None,
              n_windows: int = 0,
              uncovered_frac: Sequence[float] = ()) -> "FleetSLOReport":
        """Aggregate a run.  ``transport`` is a duck-typed
        ``TransportStats`` (or None); ``cache`` a duck-typed
        ``PackedActivationCache``/``ShardedActivationCache``;
        ``n_windows`` the number of deadline-scoped release windows
        (segments), for the hit-rate denominator."""
        rep = cls(steps=list(steps), accuracy_floor=float(accuracy_floor),
                  accuracy_mean=float(accuracy_mean))
        if transport is not None:
            rep.p50_delay_s = float(transport.p50_s)
            rep.p99_delay_s = float(transport.p99_s)
            rep.mean_delay_s = float(transport.mean_s)
            rep.part_p99_s = {k: float(transport.part_p99(k))
                              for k in transport.parts}
            rep.deadline_hits = int(transport.deadline_hits)
            rep.deadline_hit_rate = (transport.deadline_hits / n_windows
                                     if n_windows else 0.0)
            rep.straggler_frac = float(transport.straggler_frac)
            rep.bytes_total = float(transport.bytes_total)
            rep.bytes_base = float(transport.bytes_base)
            rep.shed_bytes = float(transport.shed_bytes)
            rep.shed_halo_bytes = float(transport.shed_halo_bytes)
            rep.shed_body_bytes = float(transport.shed_body_bytes)
            rep.quality_min = float(transport.quality_min)
        if rep.steps:
            total = sum(s.total_tiles for s in rep.steps)
            rep.changed_tile_fraction = \
                sum(s.changed_tiles for s in rep.steps) / max(total, 1)
            rep.compute_tile_fraction = \
                sum(s.computed_tiles for s in rep.steps) / max(total, 1)
            walls = np.asarray([s.wall_s for s in rep.steps])
            rep.step_wall_p50_s = float(np.percentile(walls, 50))
            rep.step_wall_p99_s = float(np.percentile(walls, 99))
            cbytes = sum(s.canvas_bytes for s in rep.steps)
            rep.canvas_bytes_per_step = cbytes / len(rep.steps)
            changed = sum(s.changed_tiles for s in rep.steps)
            rep.canvas_bytes_per_changed_tile = cbytes / max(changed, 1)
        if len(uncovered_frac):
            uf = np.asarray(uncovered_frac, np.float64)
            rep.uncovered_frac_mean = float(uf.mean())
            rep.uncovered_frac_p99 = float(np.percentile(uf, 99))
        if cache is not None:
            rep.cache = {
                "steps": int(cache.steps),
                "cold_steps": int(cache.cold_steps),
                "invalidations": int(cache.invalidations),
                "launched_tiles": int(cache.launched_tiles),
                "total_tiles": int(cache.total_tiles),
                "compute_fraction": float(cache.compute_fraction),
            }
        return rep

    def to_dict(self) -> Dict:
        d = {k: getattr(self, k) for k in (
            "p50_delay_s", "p99_delay_s", "mean_delay_s", "part_p99_s",
            "deadline_hits", "deadline_hit_rate", "straggler_frac",
            "bytes_total", "bytes_base", "shed_bytes", "shed_halo_bytes",
            "shed_body_bytes", "quality_min", "accuracy_floor",
            "accuracy_mean", "changed_tile_fraction",
            "compute_tile_fraction", "step_wall_p50_s", "step_wall_p99_s",
            "canvas_bytes_per_step", "canvas_bytes_per_changed_tile",
            "cache", "uncovered_frac_mean", "uncovered_frac_p99")}
        d["n_steps"] = len(self.steps)
        d["steps"] = [s.to_dict() for s in self.steps]
        return d
