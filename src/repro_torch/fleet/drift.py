"""Online mask-drift adaptation (paper §5.5, made continuous) -- the port's
copy of ``repro.fleet.drift``.

The offline RoI mask encodes where traffic *was* during profiling.  When
traffic shifts — a closed lane, a rerouted approach, rush-hour turning
patterns — appearances start landing outside the mask and accuracy decays
silently.  The paper re-runs the whole offline phase; this adapter instead:

* monitors per-appearance coverage and **per-tile coverage residuals**
  (tiles that uncovered appearances wanted but the mask lacks) over a
  sliding window of the online stream, and
* when windowed coverage drops below target, triggers an **incremental,
  warm-started re-solve**: the window's appearance regions become set-cover
  constraints and ``setcover.solve_warm`` seeds the greedy core with the
  deployed mask, so the solve only pays for the residual core — no full
  offline re-run, no mask churn on covered regions.

The adapter is deliberately engine-agnostic: feed it the per-frame
detections the server already produces (``observe``), read back the updated
mask/grids when it fires.  ``run_adaptive_online`` is the reference driver
used by the tests and the card smoke (``chip_smoke.py``).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import setcover
from repro_torch.core.association import AssociationTable, Region
from repro_torch.core.pipeline import (OfflineConfig, OfflineResult,
                                       bbox_mask_area, run_offline)
from repro_torch.core.scene import Scene
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace


@dataclass
class DriftConfig:
    window_frames: int = 200       # sliding observation window
    coverage_target: float = 0.95  # re-solve when window coverage dips below
    min_samples: int = 40          # appearances needed before triggering
    cooldown_frames: int = 200     # min frames between re-solves
    # sustained-breach confirmation: coverage must stay below target this
    # many consecutive frames before the re-solve fires.  A transient dip
    # (one occluded platoon) recovers on its own; a real traffic shift
    # keeps breaching while the window fills with the NEW routes — firing
    # only after confirmation means the warm re-solve sees vehicles at
    # every phase of the shifted corridors, so ONE re-solve restores
    # coverage instead of chasing the shift with many partial patches.
    confirm_frames: int = 150
    # detector tolerance, matching OnlineConfig.coverage_thresh: an
    # appearance counts as covered when >= this fraction of its bbox pixel
    # area survives the RoI crop
    coverage_thresh: float = 0.75
    # --- scheduled shrink re-solves (ROADMAP: "drift adapter only grows
    # masks").  Growth re-solves are additive by design; at *detected
    # low-traffic windows* the adapter instead re-profiles a recent slice
    # of the stream with the FULL offline pipeline (run_offline on
    # [t - shrink_profile_frames, t)) and adopts the cold mask — but only
    # when it is smaller AND does not regress coverage on the buffered
    # observation window.  A bad adoption self-heals: the breach monitor
    # keeps running on the shrunk mask and fires a warm grow re-solve.
    shrink_enabled: bool = False
    shrink_check_every: int = 50       # frames between low-traffic checks
    shrink_low_rate: float = 0.5       # appearances/frame; below = lull
    shrink_profile_frames: int = 250   # re-profile window length
    shrink_cooldown_frames: int = 400
    shrink_min_constraints: int = 20   # evidence floor for the re-solve


@dataclass
class DriftEvent:
    t: int                         # frame that triggered the re-solve
    coverage_before: float         # windowed coverage at trigger time
    tiles_added: int               # mask growth from the warm re-solve
    constraints: int               # window constraints handed to the solver
    wall_s: float                  # re-solve wall time


@dataclass
class ShrinkEvent:
    t: int                         # frame the shrink re-solve ran
    mask_before: int               # deployed mask size going in
    mask_after: int                # ... and coming out (== before if
    #                                the candidate was rejected)
    coverage_before: float         # buffered-window coverage, old mask
    coverage_after: float          # ... under the adopted mask
    constraints: int               # offline re-profile constraint count
    adopted: bool
    wall_s: float


class DriftAdapter:
    """Per-group online mask maintainer.

    Holds the group's deployed mask (global tile ids over the group's
    ``TileUniverse``) plus the derived per-camera grids, and mutates both
    when a re-solve fires.  Online (grow) re-solves never retract deployed
    tiles — stopping the accuracy bleed when traffic moves is additive by
    design.  Retraction happens on a separate, slower path: at detected
    low-traffic windows ``maybe_shrink`` re-runs the FULL offline pipeline
    on a recent slice of the stream and adopts the cold (smaller) mask iff
    it does not regress coverage on the buffered observations."""

    def __init__(self, scene: Scene, offline: OfflineResult,
                 cfg: Optional[DriftConfig] = None):
        self.cfg = cfg or DriftConfig()
        self.cameras = scene.cameras
        self.universe = offline.universe
        self.mask = set(offline.mask)
        self.cam_grids = {c.cam_id: offline.cam_grids[c.cam_id].copy()
                          for c in scene.cameras}
        # sliding windows: (t, covered) per appearance; (t, obj, regions)
        # buffered for re-solve constraints
        self._window: Deque[Tuple[int, bool]] = collections.deque()
        self._regions: Deque[Tuple[int, int, Dict[int, frozenset]]] = \
            collections.deque()
        self.residual_counts: collections.Counter = collections.Counter()
        self.events: List[DriftEvent] = []
        self.shrink_events: List[ShrinkEvent] = []
        self._last_resolve_t = -10 ** 9
        self._last_shrink_t = -10 ** 9
        self._breach_start: Optional[int] = None
        # mask-update listeners: called with the adapter after every
        # deployed-mask mutation (grow re-solve or adopted shrink).  The
        # serving layer's temporal-reuse caches register their
        # ``invalidate`` here so a re-solve can never serve stale packed
        # activations (the caches' content keys would miss anyway — the
        # listener makes the invalidation explicit and countable).
        self._mask_listeners: List = []
        self._notifying = False

    def add_mask_listener(self, fn) -> None:
        """Register ``fn(adapter)`` to run after every mask mutation
        (``PackedActivationCache.invalidate`` ignores the argument:
        ``adapter.add_mask_listener(lambda _: cache.invalidate())``, or
        pass any callable accepting one positional argument)."""
        self._mask_listeners.append(fn)

    def _notify_mask_update(self) -> None:
        # Reentrancy guard: a listener (shard invalidation -> table
        # rebuild) may feed back into ``observe``/``failover`` paths that
        # mutate the mask again within the same step.  The inner mutation
        # already left ``self.mask``/``cam_grids`` final, so fanning out
        # a second time from inside the first fan-out would only
        # double-invalidate the shard cache — suppress the nested call;
        # the outer fan-out delivers the final state.
        if self._notifying:
            return
        self._notifying = True
        try:
            for fn in self._mask_listeners:
                fn(self)
        finally:
            self._notifying = False

    # -- monitoring --------------------------------------------------------
    @property
    def resolves(self) -> int:
        return len(self.events)

    def coverage(self) -> float:
        if not self._window:
            return 1.0
        return sum(1 for _, c in self._window if c) / len(self._window)

    def _covered(self, d) -> bool:
        cam = self.cameras[d.cam]
        cov = bbox_mask_area(cam, self.cam_grids[d.cam], d.bbox)
        return cov >= self.cfg.coverage_thresh * max(d.bbox.area, 1.0)

    def observe(self, t: int, detections) -> bool:
        """Feed one frame of server-side detections; returns True when the
        frame triggered a re-solve.  An *appearance* is one (t, object);
        it is covered when any camera's crop keeps enough of its box —
        the same unique-vehicle criterion the online accuracy uses."""
        by_obj: Dict[int, List] = {}
        for d in detections:
            by_obj.setdefault(d.obj, []).append(d)
        for obj, ds in by_obj.items():
            regions: Dict[int, frozenset] = {}
            covered = False
            for d in ds:
                tiles = self.cameras[d.cam].bbox_tiles(d.bbox)
                if tiles:
                    regions[d.cam] = tiles
                covered = covered or self._covered(d)
            if not regions:
                continue
            if not covered:
                for c, tiles in regions.items():
                    for gt in self.universe.globalize(c, tiles):
                        if gt not in self.mask:
                            self.residual_counts[gt] += 1
            self._window.append((t, covered))
            self._regions.append((t, obj, regions))
        horizon = t - self.cfg.window_frames
        while self._window and self._window[0][0] <= horizon:
            self._window.popleft()
        while self._regions and self._regions[0][0] <= horizon:
            self._regions.popleft()

        breached = (len(self._window) >= self.cfg.min_samples
                    and self.coverage() < self.cfg.coverage_target)
        if not breached:
            self._breach_start = None
            return False
        if self._breach_start is None:
            self._breach_start = t
            obs_metrics.DRIFT_EVENTS.inc(1, event="breach_window")
        if (t - self._breach_start >= self.cfg.confirm_frames
                and t - self._last_resolve_t >= self.cfg.cooldown_frames):
            self._resolve(t)
            return True
        return False

    # -- adaptation --------------------------------------------------------
    def _resolve(self, t: int) -> None:
        wall0 = time.time()
        cov_before = self.coverage()
        with obs_trace.span("drift_resolve", t=t,
                            coverage_before=cov_before):
            constraints: List[List[Region]] = []
            keys: List[Tuple[int, int]] = []
            for tt, obj, regions in self._regions:
                constraints.append(
                    [Region(c, self.universe.globalize(c, tiles))
                     for c, tiles in sorted(regions.items())])
                keys.append((tt, obj))
            table = AssociationTable(self.universe, constraints, keys)
            res = setcover.solve_warm(table, self.mask)
            added = len(res.mask) - len(self.mask)
            self.mask = set(res.mask)
            for c in self.cameras:
                self.cam_grids[c.cam_id] = self.universe.cam_mask_grid(
                    c.cam_id, self.mask)
        wall = time.time() - wall0
        obs_metrics.DRIFT_EVENTS.inc(1, event="resolve")
        obs_metrics.DRIFT_RESOLVE_WALL.observe(wall)
        self.events.append(DriftEvent(t, cov_before, added,
                                      len(constraints), wall))
        self._last_resolve_t = t
        self._breach_start = None
        # the window measured the OLD mask; start the next measurement clean
        self._window.clear()
        self.residual_counts.clear()
        self._notify_mask_update()

    # -- scheduled shrink (full offline re-solve at low-traffic windows) ---
    @property
    def shrinks(self) -> int:
        return sum(1 for e in self.shrink_events if e.adopted)

    def _buffer_coverage(self, mask) -> float:
        """Fraction of buffered appearances every one of whose candidate
        regions fits the mask strictly — a conservative (tile-containment)
        criterion, so "no regress" under it implies no regress under the
        looser detector tolerance."""
        if not self._regions:
            return 1.0
        ok = 0
        for _, _, regions in self._regions:
            if any(self.universe.globalize(c, tiles) <= mask
                   for c, tiles in regions.items()):
                ok += 1
        return ok / len(self._regions)

    def traffic_rate(self) -> float:
        """Windowed appearances per frame — the low-traffic detector."""
        return len(self._window) / max(self.cfg.window_frames, 1)

    def occupancy_by_camera(self) -> Dict[int, int]:
        """Buffered appearance-region count per camera over the current
        observation window — how much traffic each camera has recently
        *seen*.  This is the liveness monitor's second evidence channel:
        a camera whose delta gate goes quiet while its windowed occupancy
        says traffic should be flowing is FROZEN, not static."""
        occ: Dict[int, int] = {c.cam_id: 0 for c in self.cameras}
        for _, _, regions in self._regions:
            for cam in regions:
                occ[cam] = occ.get(cam, 0) + 1
        return occ

    def maybe_shrink(self, t: int, scene: Scene) -> bool:
        """At a detected low-traffic window, re-profile the recent stream
        with the FULL offline pipeline and adopt the cold mask iff it is
        smaller and does not regress buffered coverage.  Returns True when
        a shrink was adopted."""
        cfg = self.cfg
        if (not cfg.shrink_enabled
                or t - self._last_shrink_t < cfg.shrink_cooldown_frames
                or t < cfg.shrink_profile_frames
                or self.traffic_rate() >= cfg.shrink_low_rate):
            return False
        wall0 = time.time()
        self._last_shrink_t = t
        with obs_trace.span("drift_shrink", t=t):
            res = run_offline(
                scene,
                OfflineConfig(profile_frames=cfg.shrink_profile_frames,
                              solver="greedy"),
                t0_frame=t - cfg.shrink_profile_frames)
        candidate = frozenset(res.mask)
        n_constraints = len(res.table.constraints)
        cov_before = self._buffer_coverage(self.mask)
        cov_after = self._buffer_coverage(candidate)
        adopted = (n_constraints >= cfg.shrink_min_constraints
                   and len(candidate) < len(self.mask)
                   and cov_after >= cov_before - 1e-12)
        ev = ShrinkEvent(t, len(self.mask),
                         len(candidate) if adopted else len(self.mask),
                         cov_before, cov_after if adopted else cov_before,
                         n_constraints, adopted, time.time() - wall0)
        self.shrink_events.append(ev)
        obs_metrics.DRIFT_EVENTS.inc(
            1, event="shrink_adopted" if adopted else "shrink_rejected")
        if not adopted:
            return False
        self.mask = set(candidate)
        for c in self.cameras:
            self.cam_grids[c.cam_id] = self.universe.cam_mask_grid(
                c.cam_id, self.mask)
        # measurements under the old mask are stale
        self._window.clear()
        self.residual_counts.clear()
        self._breach_start = None
        self._notify_mask_update()
        return True


# ---------------------------------------------------------------------------
# reference driver
# ---------------------------------------------------------------------------

@dataclass
class AdaptiveRunResult:
    adapter: DriftAdapter
    frame_t: np.ndarray            # (F,) absolute frame index
    appearances: np.ndarray        # (F,) unique objects present
    covered: np.ndarray            # (F,) of those, covered under the
    #                                    mask deployed AT THAT FRAME

    def coverage_between(self, t0: int, t1: int) -> float:
        sel = (self.frame_t >= t0) & (self.frame_t < t1)
        tot = int(self.appearances[sel].sum())
        return float(self.covered[sel].sum()) / max(tot, 1)

    @property
    def resolves(self) -> int:
        return self.adapter.resolves


def run_adaptive_online(scene: Scene, offline: OfflineResult,
                        t0: int, t1: int,
                        cfg: Optional[DriftConfig] = None,
                        listeners: Sequence = ()
                        ) -> AdaptiveRunResult:
    """Stream frames [t0, t1) of one group through a DriftAdapter,
    recording per-frame coverage under the mask deployed at that moment —
    the trajectory the acceptance criterion ("recovers >= target coverage
    within one re-solve of a traffic shift") is read off of.
    ``listeners`` are registered on the adapter before the first frame
    (``DriftAdapter.add_mask_listener``), e.g. ``[lambda _:
    cache.invalidate()]``; the JAX package's driver takes none."""
    adapter = DriftAdapter(scene, offline, cfg)
    for fn in listeners:
        adapter.add_mask_listener(fn)
    frame_t, apps, covs = [], [], []
    for t in range(t0, t1):
        dets = scene.detections[t]
        by_obj: Dict[int, List] = {}
        for d in dets:
            by_obj.setdefault(d.obj, []).append(d)
        n_cov = sum(1 for ds in by_obj.values()
                    if any(adapter._covered(d) for d in ds))
        frame_t.append(t)
        apps.append(len(by_obj))
        covs.append(n_cov)
        adapter.observe(t, dets)
        if (adapter.cfg.shrink_enabled
                and t % adapter.cfg.shrink_check_every == 0):
            adapter.maybe_shrink(t, scene)
    return AdaptiveRunResult(adapter, np.asarray(frame_t),
                             np.asarray(apps), np.asarray(covs))


def wire_shard_invalidation(adapters: Dict[int, DriftAdapter], cache,
                            runtime=None) -> None:
    """Fan drift re-solves out to the sharded serving cache: each group's
    ``DriftAdapter`` gets a mask listener that cold-marks only the shard
    owning that group (``ShardedActivationCache.invalidate_group``); the
    other shards keep serving warm through the re-solve.  With ``runtime``
    (a ``fleet.sharded.ShardedSuperlaunch``) the listener also rebuilds
    the tables from the adapter's re-solved grids (``rebuild_group``
    keeps the other shards' cache rows even when the shared row bucket
    grows).

    adapters: {gid: DriftAdapter} for the groups the runtime serves (a
    subset is fine: unwired groups never invalidate)."""
    for gid, ad in adapters.items():
        def _on_update(a, gid=gid):
            cache.invalidate_group(gid)
            if runtime is not None:
                runtime.rebuild_group(
                    gid, [a.cam_grids[c.cam_id] for c in a.cameras],
                    cache=cache)
        ad.add_mask_listener(_on_update)
