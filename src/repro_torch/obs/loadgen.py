"""Heavy-traffic load generation: the SLO frontier sweep harness -- the
port's copy of ``repro.obs.loadgen``.

The paper's headline numbers (42-65% network reduction, 25-34% delay
reduction at >99% accuracy) are one point; this module measures the
SURFACE.  A sweep grid spans

* **scale** — fleet size as groups x cameras-per-group,
* **congestion severity** — none, scripted ``CongestionEpisode``s at a
  given depth, or replay of a real cellular uplink trace
  (``net.links.UplinkTrace``),
* **traffic profile** — the static fraction of the fleet per step (how
  much of the scene moves, which is what delta-gated compute prices),
* **serve request rate** — Poisson arrivals into
  ``ServingEngine.serve_deadline``,

and each grid point drives the EXISTING runtimes — ``fleet.runtime.
fleet_reuse_step``, ``net.batcher.simulate_transport``,
``serving.engine.serve_deadline`` — exactly as production would, then
folds the measurements into one ``obs.slo.FleetSLOReport`` per point.

The harness itself must be free: driving a runtime through
``drive_fleet`` adds ZERO kernel dispatches and no device synchronize
over an inline loop — all it adds per step is one ``StepReport``
dataclass.  Its step walls are host walls (``time.perf_counter`` around
the step, no synchronize): on a CUDA device a step's wall ends when its
work is enqueued, plus whatever the step itself waits for (a warm step
copies its gate stats to the host).  The head maps a step returns are
views of the cache's canvas, valid until the next step, so kept outputs
are copies (``kept_maps``), taken after the step's wall.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.slo import FleetSLOReport, StepReport


# ---------------------------------------------------------------------------
# sweep grid
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SweepPoint:
    """One grid point of the frontier sweep.

    ``congestion`` is a severity spec: ``"none"``, ``"episode:<factor>"``
    (scripted shared-bottleneck episode over the middle half of the
    window at ``factor`` capacity — smaller = more severe), or
    ``"trace:<name>"`` (replay the bundled real uplink trace).
    ``static_fraction`` is the per-step fraction of fleet cameras that
    hold still (1.0 = frozen scene, delta-gating serves everything from
    cache).  ``faults`` is a seeded fault-schedule spec: ``"none"``
    (production — the drive is bit-identical to the fault-free path),
    ``"random:<n_events>:<seed>"`` (a reproducible random chaos script,
    ``fleet.faults.FaultSchedule.random``), or
    ``"<kind>:<gid>.<cam>@<t0>-<t1>"`` for one scripted camera fault
    (kind in blackout/freeze/noise)."""
    n_groups: int
    cams_per_group: int
    congestion: str = "none"
    static_fraction: float = 0.9
    faults: str = "none"

    @property
    def n_cameras(self) -> int:
        return self.n_groups * self.cams_per_group

    @property
    def severity(self) -> float:
        """Orderable congestion severity: 0 for none, 1 - factor for
        scripted episodes (deeper cut = more severe); traces are not on
        the scripted severity axis and return -1."""
        if self.congestion == "none":
            return 0.0
        if self.congestion.startswith("episode:"):
            return 1.0 - float(self.congestion.split(":", 1)[1])
        return -1.0

    def to_dict(self) -> Dict:
        return {"n_groups": self.n_groups,
                "cams_per_group": self.cams_per_group,
                "n_cameras": self.n_cameras,
                "congestion": self.congestion,
                "static_fraction": self.static_fraction,
                "faults": self.faults}


@dataclass
class LoadgenConfig:
    """Shared knobs of one sweep (everything a ``SweepPoint`` doesn't
    vary)."""
    steps: int = 6                     # fleet steps driven per point
    tile: int = 8
    channels: Tuple[int, ...] = (6, 8)
    grid_shape: Tuple[int, int] = (5, 6)
    density: float = 0.55
    seed: int = 0
    threshold: float = 0.0             # gate threshold (0 = bit-exact)
    qstep: float = 8.0
    # transport window per point
    segment_s: float = 1.0
    frames_per_seg: int = 10
    n_segs: int = 8
    bandwidth_mbps: float = 8.0        # shared budget (constant arm)
    rtt_ms: float = 40.0
    server_hz: float = 120.0
    pixels_per_s: float = 2e8
    deadline_s: float = 2.5
    trace_scale: float = 1.0
    rate_control: bool = True
    # synthetic per-camera packetization coefficients (bytes per
    # activity-weighted frame), those of the JAX package's obs benchmark
    body_bytes: float = 3e4
    halo_bytes: float = 4e3
    header_bytes: float = 200.0
    mask_area_px: float = 2.5e5


def make_grids(cfg: LoadgenConfig, n_groups: int, cams: int
               ) -> Dict[int, List[np.ndarray]]:
    """Deterministic per-scale RoI tile grids (seeded by scale so the
    same scale point always compiles the same shapes)."""
    rng = np.random.default_rng(cfg.seed + 7919 * n_groups + 104729 * cams)
    grids: Dict[int, List[np.ndarray]] = {}
    for gid in range(n_groups):
        gs = [rng.random(cfg.grid_shape) < cfg.density for _ in range(cams)]
        for g in gs:
            g[1, 1] = True                       # never fully empty
        grids[gid] = gs
    return grids


def make_frame_trace(cfg: LoadgenConfig, grids: Dict[int, List[np.ndarray]],
                     static_fraction: float, steps: Optional[int] = None,
                     seed_offset: int = 0) -> List[Dict[int, List]]:
    """A ``steps``-long fleet frame trace where per step
    ``round((1 - static_fraction) * n_cameras)`` cameras (>= 1 unless the
    scene is fully frozen) receive one tile of fresh pixels and every
    other camera is bit-static — the traffic-profile axis the delta gate
    prices."""
    steps = steps if steps is not None else cfg.steps
    tile = cfg.tile
    rng = np.random.default_rng(cfg.seed + 1 + seed_offset)
    n_cams = sum(len(gs) for gs in grids.values())
    moves = 0 if static_fraction >= 1.0 else max(
        int(round((1.0 - static_fraction) * n_cams)), 1)
    frames = {g: [np.asarray(rng.normal(size=(gr.shape[0] * tile,
                                              gr.shape[1] * tile, 3)),
                             np.float32) for gr in gs]
              for g, gs in grids.items()}
    out = [frames]
    for _ in range(steps - 1):
        nxt = {g: [f.copy() for f in fs] for g, fs in frames.items()}
        for _ in range(moves):
            gid = int(rng.integers(len(grids)))
            cam = int(rng.integers(len(grids[gid])))
            gr = grids[gid][cam]
            ys, xs = np.nonzero(gr)
            j = int(rng.integers(len(ys)))
            y0, x0 = ys[j] * tile, xs[j] * tile
            nxt[gid][cam][y0:y0 + tile, x0:x0 + tile] = \
                rng.normal(size=(tile, tile, 3)).astype(np.float32)
        out.append(nxt)
        frames = nxt
    return out


# ---------------------------------------------------------------------------
# runtime drivers (zero added dispatches: one StepReport per step, no more)
# ---------------------------------------------------------------------------

def kept_maps(outs: Dict[int, List]) -> Dict[int, List]:
    """A step's {gid: head maps} as copies that outlive the step: the
    maps a fleet step returns are views of the activation cache's canvas,
    which the next step on that cache overwrites in place."""
    return {gid: [h.clone() for h in hs] for gid, hs in outs.items()}


def drive_fleet(det, frames_list: Sequence[Dict[int, List]],
                grids: Dict[int, List[np.ndarray]], cache,
                threshold: float = 0.0, qstep: float = 8.0,
                keep_outputs: bool = False):
    """Drive ``fleet.runtime.fleet_reuse_step`` over a frame trace.

    Returns (step reports, per-step outputs or [], total dispatch
    Counter).  This IS the production loop — the only instrumentation is
    the per-step host wall clock and ``StepReport`` construction, so the
    dispatch Counter is identical to an inline drive.  With
    ``keep_outputs`` each step's maps are copied (``kept_maps``) after
    its wall is taken."""
    import collections

    from repro_torch.fleet.runtime import fleet_reuse_step

    reports: List[StepReport] = []
    outputs = []
    total: collections.Counter = collections.Counter()
    for i, frames in enumerate(frames_list):
        t0 = time.perf_counter()
        outs, counts, stats = fleet_reuse_step(det, frames, grids, cache,
                                               threshold, qstep)
        reports.append(StepReport.from_reuse(
            i, time.perf_counter() - t0, counts, stats))
        total += counts
        if keep_outputs:
            outputs.append(kept_maps(outs))
    return reports, outputs, total


def drive_sharded(runtime, frames_list: Sequence[Dict[int, List]], cache,
                  threshold: float = 0.0, keep_outputs: bool = False):
    """``drive_fleet``'s contract over a ``fleet.sharded.
    ShardedSuperlaunch`` (each kernel counted once a step; the dispatch
    structure is asserted inside ``sharded_fleet_step`` every step).
    Kept outputs are copies (``kept_maps``), taken after the step's
    wall."""
    import collections

    from repro_torch.fleet.runtime import sharded_fleet_step

    reports: List[StepReport] = []
    outputs = []
    total: collections.Counter = collections.Counter()
    for i, frames in enumerate(frames_list):
        t0 = time.perf_counter()
        outs, counts, stats = sharded_fleet_step(runtime, frames, cache,
                                                 threshold)
        reports.append(StepReport.from_reuse(
            i, time.perf_counter() - t0, counts, stats))
        total += counts
        if keep_outputs:
            outputs.append(kept_maps(outs))
    return reports, outputs, total


def accuracy_vs_exact(det, frames_list: Sequence[Dict[int, List]],
                      grids: Dict[int, List[np.ndarray]],
                      reuse_outputs: Sequence[Dict[int, List]],
                      tol: float = 1e-2) -> Tuple[float, float]:
    """(floor, mean) fraction of head-map entries within ``tol`` of the
    exact (threshold-0 full) super-launch, per step — the query-accuracy
    axis of the frontier.  Runs OUTSIDE the timed drive (it re-runs the
    exact forward, which is extra work by definition)."""
    per_step = []
    for frames, outs in zip(frames_list, reuse_outputs):
        exact = det.superlaunch_forward(frames, grids)
        ok = n = 0
        for gid in exact:
            for a, b in zip(outs[gid], exact[gid]):
                a = a.cpu().numpy()      # the maps live on the device
                b = b.cpu().numpy()
                ok += int(np.count_nonzero(np.abs(a - b) <= tol))
                n += a.size
        per_step.append(ok / max(n, 1))
    if not per_step:
        return 1.0, 1.0
    return float(np.min(per_step)), float(np.mean(per_step))


def faults_for(cfg: LoadgenConfig, point: SweepPoint):
    """Resolve a ``SweepPoint.faults`` spec into a
    ``fleet.faults.FaultSchedule`` (None for ``"none"`` — the injector
    then never touches the frames and the drive stays bit-identical to
    the production loop)."""
    from repro_torch.fleet.faults import FaultEvent, FaultSchedule

    spec = point.faults
    if spec == "none":
        return None
    if spec.startswith("random:"):
        _, n_events, seed = spec.split(":")
        return FaultSchedule.random(
            int(seed) + cfg.seed, int(n_events), cfg.steps,
            point.n_groups, point.cams_per_group)
    kind, rest = spec.split(":", 1)
    target, window = rest.split("@")
    gid, cam = (int(x) for x in target.split("."))
    t0, t1 = (int(x) for x in window.split("-"))
    return FaultSchedule((FaultEvent(kind, t0, t1, gid=gid, cam=cam),))


# ---------------------------------------------------------------------------
# transport leg
# ---------------------------------------------------------------------------

def link_for(cfg: LoadgenConfig, congestion: str):
    """Resolve a ``SweepPoint.congestion`` spec into a ``LinkConfig``."""
    from repro_torch.net.links import (CongestionEpisode, LinkConfig,
                                       load_bundled_trace)

    if congestion == "none":
        return LinkConfig()
    if congestion.startswith("episode:"):
        factor = float(congestion.split(":", 1)[1])
        window_s = cfg.n_segs * cfg.segment_s
        return LinkConfig(congestion=(CongestionEpisode(
            0.25 * window_s, 0.75 * window_s, factor),))
    if congestion.startswith("trace:"):
        name = congestion.split(":", 1)[1]
        return LinkConfig(trace=load_bundled_trace(name),
                          trace_scale=cfg.trace_scale)
    raise ValueError(f"unknown congestion spec {congestion!r}")


def transport_window(cfg: LoadgenConfig, n_cameras: int, congestion: str,
                     static_fraction: float):
    """Price one online window for ``n_cameras`` cameras sharing the
    budget under the point's congestion — synthetic per-camera
    packetization coefficients (no scene fixture needed), rate control
    fed by the point's static fraction.  Congestion grows naturally with
    scale: the budget is shared, the load is per-camera."""
    from repro_torch.net.batcher import NetConfig, simulate_transport
    from repro_torch.net.encoder import CameraCoefficients, RateControlConfig

    C = n_cameras
    coef = CameraCoefficients(
        body=np.full(C, cfg.body_bytes), halo=np.full(C, cfg.halo_bytes),
        headers=np.full(C, cfg.header_bytes),
        has_mask=np.ones(C, bool))
    net = NetConfig(
        link=link_for(cfg, congestion),
        rate_control=RateControlConfig(enabled=cfg.rate_control,
                                       static_fraction=static_fraction),
        deadline_s=cfg.deadline_s)
    return simulate_transport(
        [None] * C, None, None, np.full(C, cfg.mask_area_px), None,
        cfg.segment_s, cfg.frames_per_seg, cfg.n_segs, cfg.bandwidth_mbps,
        cfg.rtt_ms, cfg.server_hz, cfg.pixels_per_s, net=net, coef=coef)


# ---------------------------------------------------------------------------
# one grid point end-to-end
# ---------------------------------------------------------------------------

def run_point(cfg: LoadgenConfig, det, point: SweepPoint,
              grids: Optional[Dict[int, List[np.ndarray]]] = None,
              frames_list: Optional[Sequence[Dict[int, List]]] = None,
              cache=None, measure_accuracy: bool = True) -> Dict:
    """Drive every runtime at one grid point and fold the measurements
    into a ``FleetSLOReport``.  ``grids``/``frames_list``/``cache`` can
    be passed in to share fixtures (and jit caches) across points of the
    same scale."""
    from repro_torch.serving.detector import PackedActivationCache

    if grids is None:
        grids = make_grids(cfg, point.n_groups, point.cams_per_group)
    if frames_list is None:
        frames_list = make_frame_trace(cfg, grids, point.static_fraction)
    if cache is None:
        cache = PackedActivationCache()

    schedule = faults_for(cfg, point)
    fault_info = None
    t0 = time.perf_counter()
    if schedule is None:
        reports, outputs, counts = drive_fleet(
            det, frames_list, grids, cache, cfg.threshold, cfg.qstep,
            keep_outputs=measure_accuracy)
    else:
        from repro_torch.fleet.faults import (LivenessMonitor,
                                              drive_chaos, flat_cam_index)

        monitor = LivenessMonitor(len(flat_cam_index(grids)))
        reports, outputs, counts, detected = drive_chaos(
            det, frames_list, grids, cache, cfg.threshold, cfg.qstep,
            schedule=schedule, monitor=monitor,
            keep_outputs=measure_accuracy, seed=cfg.seed)
        fault_info = {"events": len(schedule.events),
                      "detected": {int(k): list(map(int, v))
                                   for k, v in detected.items()}}
    drive_wall = time.perf_counter() - t0

    if measure_accuracy:
        # against the exact forward on the TRUE (clean) frames — under
        # an active fault window this measures degraded-mode accuracy
        acc_floor, acc_mean = accuracy_vs_exact(det, frames_list, grids,
                                                outputs)
    else:
        acc_floor = acc_mean = 1.0

    ts = transport_window(cfg, point.n_cameras, point.congestion,
                          point.static_fraction)
    report = FleetSLOReport.build(
        steps=reports, transport=ts, accuracy_floor=acc_floor,
        accuracy_mean=acc_mean, cache=cache, n_windows=cfg.n_segs)
    out = {"point": point.to_dict(), "drive_wall_s": drive_wall,
           "dispatches": dict(counts), "slo": report.to_dict()}
    if fault_info is not None:
        out["faults"] = fault_info
    return out


def sweep(cfg: LoadgenConfig, det_factory, points: Sequence[SweepPoint],
          measure_accuracy: bool = True, log=None) -> List[Dict]:
    """Run a full grid.  Points are grouped by scale so each scale
    builds its grids/detector fixtures once (sweeping congestion and
    static fraction re-uses the compiled shapes); a fresh activation
    cache per point keeps points independent."""
    by_scale: Dict[Tuple[int, int], List[SweepPoint]] = {}
    for p in points:
        by_scale.setdefault((p.n_groups, p.cams_per_group), []).append(p)
    results: List[Dict] = []
    for (n_groups, cams), pts in by_scale.items():
        det = det_factory()
        grids = make_grids(cfg, n_groups, cams)
        traces: Dict[float, Sequence] = {}
        for p in pts:
            if p.static_fraction not in traces:
                traces[p.static_fraction] = make_frame_trace(
                    cfg, grids, p.static_fraction)
            if log:
                log(f"loadgen point {p.to_dict()}")
            results.append(run_point(
                cfg, det, p, grids=grids,
                frames_list=traces[p.static_fraction],
                measure_accuracy=measure_accuracy))
    return results


# ---------------------------------------------------------------------------
# serve-rate leg (ServingEngine.serve_deadline under Poisson arrivals)
# ---------------------------------------------------------------------------

def serve_requests(cfg, rate_hz: float, n_requests: int = 24,
                   n_groups: int = 2, prompt_len: int = 32,
                   greedy_steps: int = 2, seed: int = 0) -> List:
    """The request stream ``drive_serve`` sends: Poisson arrivals at
    ``rate_hz``, request ``i`` in camera group ``i % n_groups``.  A text
    model's prompt is ``prompt_len`` random token ids, drawn as the JAX
    package draws them.  A vlm's prompt is a ``prompt_len``-patch stream
    (``cfg.frontend_dim`` wide) with a keep-list that keeps it whole,
    served through the RoI-packed prefill (``ServeConfig.roi_sparsity``):
    the vlm frontend takes patches, and token ids alone raise
    ``KeyError`` there in both packages.  The arrivals are drawn first,
    so they do not depend on the model."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, n_requests))
    reqs = []
    for i in range(n_requests):
        if cfg.family == "vlm":
            prompt = dict(tokens=rng.standard_normal(
                (prompt_len, cfg.frontend_dim), dtype=np.float32),
                keep=np.ones(prompt_len, bool))
        else:
            prompt = dict(tokens=rng.integers(
                0, cfg.vocab_size, prompt_len).astype(np.int32))
        reqs.append(Request(rid=i, **prompt, max_new_tokens=greedy_steps,
                            group=i % n_groups,
                            arrival_s=float(arrivals[i])))
    return reqs


def drive_serve(engine, rate_hz: float, n_requests: int = 24,
                n_groups: int = 2, group_size: int = 3,
                deadline_s: float = 0.5, prompt_len: int = 32,
                greedy_steps: int = 2, seed: int = 0) -> Dict:
    """Drive ``ServingEngine.serve_deadline`` with a Poisson request
    stream at ``rate_hz`` (requests round-robin across ``n_groups``
    camera groups, ``serve_requests``) and report the serve-side SLO
    panel: batching-wait p50/p99, deadline vs complete flush mix,
    straggler requests.  ``serve_wall_s`` is the host's wall of the
    serve; it ends with the tokens on the host."""
    reqs = serve_requests(engine.cfg, rate_hz, n_requests, n_groups,
                          prompt_len, greedy_steps, seed)
    t0 = time.perf_counter()
    results, rep = engine.serve_deadline(
        reqs, group_sizes={g: group_size for g in range(n_groups)},
        deadline_s=deadline_s, greedy_steps=greedy_steps)
    wall = time.perf_counter() - t0
    waits = np.asarray([rep.wait_s(r) for r in reqs])
    flushes = rep.complete_flushes + rep.deadline_flushes
    return {"rate_hz": float(rate_hz), "n_requests": n_requests,
            "served": len(results),
            "wait_p50_s": float(np.percentile(waits, 50)),
            "wait_p99_s": float(np.percentile(waits, 99)),
            "wait_mean_s": float(waits.mean()),
            "complete_flushes": rep.complete_flushes,
            "deadline_flushes": rep.deadline_flushes,
            "deadline_flush_frac": rep.deadline_flushes / max(flushes, 1),
            "straggler_requests": rep.straggler_requests,
            "serve_wall_s": wall}
