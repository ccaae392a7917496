"""Fault injection, liveness detection, and coverage failover for the
fleet -- the port's copy of ``repro.fleet.faults``, less the sharded
runtime's shard loss (``shard_failover``, ``drive_chaos_sharded``), which
comes with the port's sharded runtime.

CrossRoI's premise is to REMOVE cross-camera redundancy: the set-cover
mask assigns each ground region to the cheapest camera that sees it, so
the redundancy that would have masked a camera failure is gone by
design.  When a camera dies, its exclusively-assigned tiles go dark and
the >99% coverage guarantee silently breaks — nothing in the head maps
says so.  This module is the missing failure path, in three layers:

* **Injection** (``FaultSchedule`` / ``FaultInjector``) — a seeded,
  scriptable fault layer that mirrors the ``obs`` discipline: default
  OFF, and when off ``drive_chaos`` is **bit-identical** to
  ``obs.loadgen.drive_fleet`` over ``fleet_reuse_step`` with ZERO added
  dispatches.  Faults: camera blackout (transport dies, pixels freeze),
  frozen frame (transport lives, pixels freeze), noise corruption, and
  uplink outage (zero-bandwidth segments — ``net.links.
  outage_effective`` keeps the FIFO finite).  Frames may be numpy
  arrays or tensors on any device; noise is drawn on the host from the
  same seeded generator either way and added on the frame's device.
* **Detection** (``LivenessMonitor`` here, ``net.batcher.
  HeartbeatMonitor`` at the transport level) — per-camera liveness from
  the delta-gate stats the runtime ALREADY computes (no extra
  dispatches): a camera whose gate goes quiet is only declared dead
  when its own history says it should be moving — historical change
  rate and/or the drift adapter's windowed occupancy
  (``DriftAdapter.occupancy_by_camera``) — so a *frozen* camera is
  distinguished from a *genuinely static* one.
* **Failover** (``failover_resolve``) — on confirmed death, ONE warm
  set-cover re-solve (``setcover.solve_warm``) whose seed and
  constraints EXCLUDE the dead camera: coverage is reassigned to
  surviving overlapping cameras, fanned out through the existing
  ``DriftAdapter.add_mask_listener`` path (a listener invalidates the
  activation cache).  Holes no surviving camera can cover are reported
  explicitly — ``uncovered_fraction`` through ``obs.metrics`` — never
  silently zero.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import setcover
from repro_torch.core.association import AssociationTable, Region
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace

FAULT_KINDS = ("blackout", "freeze", "noise", "uplink", "shard")


# ---------------------------------------------------------------------------
# fault scripting
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault over the half-open step interval [t0, t1).

    ``kind``:
    * ``"blackout"`` — camera (gid, cam) stops arriving: pixels freeze
      at the last pre-fault frame AND its transport heartbeat stops.
    * ``"freeze"``   — camera keeps arriving but its content is stuck at
      the last pre-fault frame (encoder wedge / stuck sensor).
    * ``"noise"``    — seeded additive noise of amplitude ``amp`` on the
      camera's frames (corruption; the gate sees it as change).
    * ``"uplink"``   — the camera's uplink bandwidth is 0 over the
      interval (transport-level; map through ``uplink_episodes``).
    * ``"shard"``    — device shard ``shard`` is lost at t0: its cached
      activations are gone (restore = cold recompute next step); the
      sharded runtime's kind, which no driver of this module acts on.
    """
    kind: str
    t0: int
    t1: int
    gid: int = 0
    cam: int = 0
    shard: int = 0
    amp: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.t1 <= self.t0:
            raise ValueError(f"fault interval must be non-empty, got "
                             f"[{self.t0}, {self.t1})")

    def active(self, step: int) -> bool:
        return self.t0 <= step < self.t1


@dataclass(frozen=True)
class FaultSchedule:
    """A seeded script of fault events.  ``enabled=False`` (or an empty
    event tuple) is the production configuration: the injector returns
    its inputs UNTOUCHED — same objects, so the fault-free chaos drive
    is bit-identical to the plain drive."""
    events: Tuple[FaultEvent, ...] = ()
    enabled: bool = True

    @property
    def off(self) -> bool:
        return not self.enabled or not self.events

    def active(self, step: int) -> List[FaultEvent]:
        if self.off:
            return []
        return [e for e in self.events if e.active(step)]

    def frame_events(self, step: int) -> List[FaultEvent]:
        return [e for e in self.active(step)
                if e.kind in ("blackout", "freeze", "noise")]

    def shard_starts(self, step: int) -> List[FaultEvent]:
        """Shard-loss events whose outage BEGINS at ``step`` (loss is an
        instantaneous state wipe; the interval models the outage
        window for MTTR accounting)."""
        if self.off:
            return []
        return [e for e in self.events
                if e.kind == "shard" and e.t0 == step]

    @classmethod
    def random(cls, seed: int, n_events: int, steps: int,
               n_groups: int, cams_per_group: int, n_shards: int = 1,
               kinds: Sequence[str] = ("blackout", "freeze", "noise"),
               min_len: int = 2) -> "FaultSchedule":
        """A reproducible random schedule — the chaos-harness axis."""
        rng = np.random.default_rng(seed)
        evs = []
        for _ in range(n_events):
            kind = str(rng.choice(list(kinds)))
            t0 = int(rng.integers(1, max(steps - min_len, 2)))
            t1 = int(min(t0 + rng.integers(min_len, steps), steps))
            evs.append(FaultEvent(
                kind, t0, max(t1, t0 + 1),
                gid=int(rng.integers(n_groups)),
                cam=int(rng.integers(cams_per_group)),
                shard=int(rng.integers(n_shards)),
                amp=float(rng.uniform(0.5, 2.0))))
        return cls(tuple(evs))


class FaultInjector:
    """Applies a ``FaultSchedule`` to per-step fleet frames.

    Disabled (``schedule is None`` or ``schedule.off``) the injector is
    inert: ``apply`` returns the caller's dict UNTOUCHED (the very same
    object, not a copy), so the fault-free path cannot diverge by
    construction.  When a frame fault is active, only the targeted
    cameras' entries are replaced — untouched cameras keep their
    original arrays (object identity), which keeps the delta gate's
    bit-static detection exact for them.
    """

    def __init__(self, schedule: Optional[FaultSchedule], seed: int = 0):
        self.schedule = schedule
        self.seed = seed
        self._retained: Dict[Tuple[int, int], np.ndarray] = {}
        self.injected_steps = 0

    @property
    def off(self) -> bool:
        return self.schedule is None or self.schedule.off

    def blacked_out(self, step: int) -> Set[Tuple[int, int]]:
        """(gid, cam) pairs whose transport is down at ``step`` — the
        heartbeat driver skips their beats."""
        if self.off:
            return set()
        return {(e.gid, e.cam) for e in self.schedule.active(step)
                if e.kind == "blackout"}

    def apply(self, step: int, frames: Dict[int, List]) -> Dict[int, List]:
        if self.off:
            return frames
        events = self.schedule.frame_events(step)
        faulted = {(e.gid, e.cam) for e in events}
        # retain the last CLEAN frame per camera (what a wedged encoder
        # keeps re-emitting) before any replacement happens this step
        for gid, fs in frames.items():
            for cam, f in enumerate(fs):
                if (gid, cam) not in faulted:
                    self._retained[(gid, cam)] = f
        if not events:
            return frames
        self.injected_steps += 1
        out = {gid: list(fs) for gid, fs in frames.items()}
        for e in events:
            cur = out[e.gid][e.cam]
            if e.kind in ("blackout", "freeze"):
                # stuck at the last pre-fault content; first-step faults
                # freeze the initial frame itself
                out[e.gid][e.cam] = self._retained.get(
                    (e.gid, e.cam), cur)
            elif e.kind == "noise":
                rng = np.random.default_rng(
                    (self.seed, e.gid, e.cam, step))
                noise = e.amp * rng.normal(
                    size=tuple(cur.shape)).astype(np.float32)
                if isinstance(cur, torch.Tensor):
                    # the host's f32 noise, one f32 add on the frame's
                    # device: the bits of the numpy sum below
                    out[e.gid][e.cam] = cur.to(torch.float32) + \
                        torch.from_numpy(noise).to(cur.device)
                else:
                    noisy = np.asarray(cur) + noise
                    out[e.gid][e.cam] = noisy.astype(np.float32)
            obs_metrics.FAULT_EVENTS.inc(1, event="injected")
        return out


def uplink_episodes(schedule: Optional[FaultSchedule], segment_s: float,
                    flat_cam: Dict[Tuple[int, int], int]) -> Tuple:
    """Map the schedule's uplink + blackout events to zero-bandwidth
    ``net.links.CongestionEpisode``s (factor 0.0) over the matching wall
    interval — ``outage_effective`` keeps the FIFO finite through them.
    ``flat_cam`` maps (gid, cam) to the transport window's positional
    camera index."""
    from repro_torch.net.links import CongestionEpisode

    if schedule is None or schedule.off:
        return ()
    eps = []
    for e in schedule.events:
        if e.kind not in ("uplink", "blackout"):
            continue
        pos = flat_cam.get((e.gid, e.cam))
        if pos is None:
            continue
        eps.append(CongestionEpisode(e.t0 * segment_s, e.t1 * segment_s,
                                     0.0, cams=(pos,)))
    return tuple(eps)


def flat_cam_index(grids: Dict[int, List]) -> Dict[Tuple[int, int], int]:
    """(gid, cam) -> fleet-flat camera index, matching the
    ``superlaunch_forward_reuse`` flattening contract (gids in dict
    order, cameras in list order) — the key space of the gate-stats
    camera column (``cache.idx_np[:, 0]``)."""
    flat = {}
    pos = 0
    for gid, gs in grids.items():
        for cam in range(len(gs)):
            flat[(gid, cam)] = pos
            pos += 1
    return flat


# ---------------------------------------------------------------------------
# detection: per-camera liveness from the existing gate stats
# ---------------------------------------------------------------------------

def per_camera_changed(gate_stats, threshold, cam_of_row,
                       n_cameras: int) -> np.ndarray:
    """(n_cameras,) int64 count of gate-changed tiles per fleet-flat
    camera this step — pure host math over the ``tile_delta_gate`` stats
    rows the step already produced (``ReuseStats.gate_stats``); ZERO
    extra dispatches.  ``None`` stats (a cold step) count as all-changed
    (the cold step recomputes everything)."""
    from repro_torch.serving.detector import gate_changed_rows

    cam_of_row = np.asarray(cam_of_row)
    if gate_stats is None:
        return np.bincount(cam_of_row, minlength=n_cameras)
    changed = gate_changed_rows(gate_stats, threshold, cam_of_row)
    return np.bincount(cam_of_row[changed], minlength=n_cameras)


@dataclass
class LivenessConfig:
    freeze_window: int = 4        # quiet steps before a camera is suspect
    # expected-activity floor: confirm death only when the camera's
    # historical change rate (EMA of changed tiles/step, snapshotted at
    # the moment it went quiet) clears this — a camera that was ALWAYS
    # quiet is genuinely static, not frozen
    min_expected_rate: float = 0.5
    ema_alpha: float = 0.3
    # second evidence channel: windowed drift-adapter occupancy (recent
    # appearance-regions seen by the camera).  Either channel suffices —
    # a static-background camera with traffic flowing through it has
    # occupancy evidence even if its own gate history is thin.
    min_occupancy: int = 3


class LivenessMonitor:
    """Frozen-vs-static discrimination from per-camera gate activity.

    Feed ``update`` each step with the per-camera changed-tile counts
    (``per_camera_changed`` over the step's gate stats) and, optionally,
    the drift adapter's ``occupancy_by_camera()``.  A camera is
    *suspect* after ``freeze_window`` consecutive zero-change steps and
    *confirmed dead* only if the evidence says it should have been
    changing: pre-quiet EMA change rate >= ``min_expected_rate`` OR
    windowed occupancy >= ``min_occupancy``.  Cameras that are
    genuinely static (zero historical rate, no occupancy) are never
    confirmed, no matter how long they stay quiet."""

    def __init__(self, n_cameras: int,
                 cfg: Optional[LivenessConfig] = None):
        self.cfg = cfg or LivenessConfig()
        self.n_cameras = n_cameras
        self.streak = np.zeros(n_cameras, np.int64)
        self.ema_rate = np.zeros(n_cameras, np.float64)
        self._quiet_rate = np.zeros(n_cameras, np.float64)
        self.confirmed: Set[int] = set()
        self.confirmed_at: Dict[int, int] = {}
        self.suspect_at: Dict[int, int] = {}
        self.steps = 0

    def update(self, step: int, changed_per_cam: np.ndarray,
               occupancy: Optional[Dict[int, int]] = None,
               flat_of_cam: Optional[Dict[int, int]] = None
               ) -> List[int]:
        """Returns fleet-flat camera indices newly CONFIRMED dead this
        step.  ``occupancy``/``flat_of_cam`` translate the drift
        adapter's cam_id-keyed occupancy into flat indices."""
        cfg = self.cfg
        changed = np.asarray(changed_per_cam, np.float64)
        quiet = changed == 0
        # snapshot the pre-quiet rate the moment a streak starts
        starting = quiet & (self.streak == 0)
        self._quiet_rate = np.where(starting, self.ema_rate,
                                    self._quiet_rate)
        self.streak = np.where(quiet, self.streak + 1, 0)
        self.ema_rate = (1 - cfg.ema_alpha) * self.ema_rate \
            + cfg.ema_alpha * changed
        occ_flat = np.zeros(self.n_cameras, np.float64)
        if occupancy:
            for cam_id, n in occupancy.items():
                f = flat_of_cam[cam_id] if flat_of_cam else cam_id
                if 0 <= f < self.n_cameras:
                    occ_flat[f] = n
        newly: List[int] = []
        for c in np.nonzero(self.streak >= cfg.freeze_window)[0]:
            c = int(c)
            if c in self.confirmed:
                continue
            if c not in self.suspect_at:
                self.suspect_at[c] = step - cfg.freeze_window + 1
            expected = (self._quiet_rate[c] >= cfg.min_expected_rate
                        or occ_flat[c] >= cfg.min_occupancy)
            if expected:
                self.confirmed.add(c)
                self.confirmed_at[c] = step
                obs_metrics.FAULT_EVENTS.inc(1, event="detected")
                newly.append(c)
        # recovery: a camera that changes again is alive
        for c in np.nonzero(~quiet)[0]:
            c = int(c)
            self.suspect_at.pop(c, None)
            if c in self.confirmed:
                self.confirmed.discard(c)
                self.confirmed_at.pop(c, None)
                obs_metrics.FAULT_EVENTS.inc(1, event="restored")
        self.steps += 1
        return newly

    def detect_latency_steps(self, cam: int, fault_t0: int) -> int:
        """Steps from fault onset to confirmation (-1 if never)."""
        if cam not in self.confirmed_at:
            return -1
        return self.confirmed_at[cam] - fault_t0


# ---------------------------------------------------------------------------
# failover: warm re-solve excluding the dead camera
# ---------------------------------------------------------------------------

@dataclass
class FailoverEvent:
    t: int                          # step the failover fired
    dead_cams: Tuple[int, ...]      # cam_ids excluded from the solve
    tiles_dropped: int              # dead-camera tiles removed from mask
    tiles_added: int                # surviving-camera tiles the re-solve
    #                                 assigned to take over coverage
    constraints: int                # window constraints handed to solver
    uncoverable: int                # of those, constraints NO surviving
    #                                 camera can cover (the hole)
    uncovered_fraction: float       # uncoverable / constraints
    wall_s: float


def _tile_owner(universe, tiles) -> np.ndarray:
    """Owning camera of each global tile id (prefix-offset decode)."""
    g = np.asarray(sorted(tiles), np.int64)
    if g.size == 0:
        return np.zeros(0, np.int64)
    return np.searchsorted(universe.offsets, g, side="right") - 1


def failover_resolve(adapter, dead_cams: Sequence[int], t: int
                     ) -> FailoverEvent:
    """ONE warm set-cover re-solve that routes a dead camera's coverage
    to surviving overlapping cameras.

    Unlike the drift path, the deployed mask canNOT be the seed
    unmodified — ``solve_warm`` never retracts its seed, and the whole
    point is to retract the dead camera's tiles.  So: (1) the seed is
    the deployed mask MINUS tiles owned by ``dead_cams``; (2) the
    window's buffered constraints are filtered to surviving-camera
    regions only, so greedy completion cannot choose a dead tile; (3)
    constraints with NO surviving region are counted as *uncoverable*
    and reported (``uncovered_fraction`` gauge + the returned event) —
    degraded mode is explicit, never silent.  The mask mutation fans out
    through ``adapter._notify_mask_update()`` — the same listener chain
    drift re-solves use, so a wired cache is invalidated exactly once."""
    wall0 = time.time()
    dead = set(int(c) for c in dead_cams)
    cov_before = adapter.coverage()
    with obs_trace.span("failover_resolve", t=t, dead=len(dead)):
        mask_tiles = np.asarray(sorted(adapter.mask), np.int64)
        owners = _tile_owner(adapter.universe, mask_tiles)
        dead_rows = np.isin(owners, list(dead)) if dead else \
            np.zeros(owners.shape, bool)
        seed = set(int(g) for g in mask_tiles[~dead_rows])
        dropped = int(np.count_nonzero(dead_rows))

        constraints: List[List[Region]] = []
        keys: List[Tuple[int, int]] = []
        uncoverable = 0
        total = 0
        for tt, obj, regions in adapter._regions:
            total += 1
            surv = [Region(c, adapter.universe.globalize(c, tiles))
                    for c, tiles in sorted(regions.items())
                    if c not in dead]
            if not surv:
                if any(c in dead for c in regions):
                    uncoverable += 1
                continue
            constraints.append(surv)
            keys.append((tt, obj))
        table = AssociationTable(adapter.universe, constraints, keys)
        res = setcover.solve_warm(table, seed)
        added = len(res.mask) - len(seed)
        adapter.mask = set(res.mask)
        for c in adapter.cameras:
            adapter.cam_grids[c.cam_id] = adapter.universe.cam_mask_grid(
                c.cam_id, adapter.mask)
    wall = time.time() - wall0
    frac = uncoverable / max(total, 1)
    obs_metrics.FAULT_EVENTS.inc(1, event="failover")
    obs_metrics.UNCOVERED_FRACTION.set(frac)
    obs_metrics.DRIFT_RESOLVE_WALL.observe(wall)
    ev = FailoverEvent(t, tuple(sorted(dead)), dropped, added,
                       len(constraints), uncoverable, frac, wall)
    # bookkeeping mirrors a drift re-solve: the window measured the old
    # mask; cooldown restarts; listeners see the final state once
    adapter._last_resolve_t = t
    adapter._breach_start = None
    adapter._window.clear()
    adapter.residual_counts.clear()
    adapter._notify_mask_update()
    return ev


def degraded_coverage(adapter, detections, dead_cams: Sequence[int]
                     ) -> Tuple[int, int, int]:
    """(covered, coverable, total) ground-truth appearance coverage
    under the CURRENT mask counting only SURVIVING cameras — the
    per-step ``uncovered_fraction`` evidence the chaos harness reports.

    ``coverable`` counts objects at least one surviving camera SEES:
    failover is judged on covered/coverable (reassignable coverage it
    must restore), while total - coverable is the GENUINE hole — objects
    whose only observer died, which no re-solve can fix and which must
    be reported, never silently folded into a denominator.  Uses the
    adapter's own ``_covered`` criterion, so pre-fault (no dead cams)
    covered/total agrees with the drift monitor's coverage exactly."""
    dead = set(int(c) for c in dead_cams)
    by_obj: Dict[int, List] = {}
    for d in detections:
        by_obj.setdefault(d.obj, []).append(d)
    covered = coverable = 0
    for ds in by_obj.values():
        surv = [d for d in ds if d.cam not in dead]
        if surv:
            coverable += 1
        if any(adapter._covered(d) for d in surv):
            covered += 1
    return covered, coverable, len(by_obj)


# ---------------------------------------------------------------------------
# chaos drivers (production loops + optional fault/liveness hooks)
# ---------------------------------------------------------------------------

def drive_chaos(det, frames_list: Sequence[Dict[int, List]],
                grids: Dict[int, List[np.ndarray]], cache,
                threshold: float = 0.0, qstep: float = 8.0,
                schedule: Optional[FaultSchedule] = None,
                monitor: Optional[LivenessMonitor] = None,
                heartbeat=None, keep_outputs: bool = False,
                seed: int = 0):
    """``obs.loadgen.drive_fleet`` with the fault layer in front.

    With ``schedule`` None/off and no monitor this IS ``drive_fleet``:
    the injector returns the caller's frames untouched and no extra
    work runs — bit-identical outputs, identical dispatch Counter.  With
    faults on, each step is (1) inject, (2) the production
    ``fleet_reuse_step``, (3) feed the liveness monitor from the step's
    OWN gate stats and the heartbeat from arrival bookkeeping — still
    zero added dispatches.  Kept outputs are copies of the step's head
    maps (``obs.loadgen.kept_maps``), taken after the step's wall.

    Returns (reports, outputs, total dispatch Counter, detections:
    {step: [newly confirmed flat cams]})."""
    from repro_torch.fleet.runtime import fleet_reuse_step
    from repro_torch.obs.loadgen import kept_maps
    from repro_torch.obs.slo import StepReport

    inj = FaultInjector(schedule, seed=seed)
    flat = flat_cam_index(grids)
    n_cams = len(flat)
    reports: List = []
    outputs = []
    detections: Dict[int, List[int]] = {}
    total: collections.Counter = collections.Counter()
    for i, frames in enumerate(frames_list):
        frames = inj.apply(i, frames)
        t0 = time.perf_counter()
        outs, counts, stats = fleet_reuse_step(det, frames, grids, cache,
                                               threshold, qstep)
        reports.append(StepReport.from_reuse(
            i, time.perf_counter() - t0, counts, stats))
        total += counts
        if keep_outputs:
            outputs.append(kept_maps(outs))
        if heartbeat is not None:
            dark = inj.blacked_out(i)
            for (gid, cam), f in flat.items():
                if (gid, cam) not in dark:
                    heartbeat.beat(float(i), f)
            heartbeat.poll(float(i))
        if monitor is not None and stats.gate_stats is not None:
            # cold steps recompute everything and carry no per-camera
            # delta evidence — feeding them as "all changed" would
            # poison a genuinely static camera's expected-rate history
            changed = per_camera_changed(
                stats.gate_stats, threshold, cache.idx_np[:, 0], n_cams)
            newly = monitor.update(i, changed)
            if newly:
                detections[i] = newly
    return reports, outputs, total, detections
