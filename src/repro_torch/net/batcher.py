"""Deadline-based group batching + the end-to-end transport simulation.

The server side of the streaming runtime: segments from a group's cameras
arrive over their own uplinks (``links``); the batcher holds a release
slot per segment and fires the group's fleet launch when **all** active
cameras have arrived or the segment deadline expires.  Cameras that miss
the release are *stragglers*: their late segments are FOLDED into the
next release's packed super-launch (extra entries in the same fleet-flat
index space — one reclaimed launch chain per fold) instead of being
served as their own late launch, and the accounting keeps them visible —
straggler fraction, deadline hits and reclaimed launches are first-class
outputs, because that is where cross-camera savings are won or lost
under congestion.

``simulate_transport`` is the whole edge-to-server path as array ops:
packetize (``encoder``) -> uplink FIFO (``links``) -> deadline release ->
server FIFO -> per-frame response latencies with a per-part breakdown
(wait / encode / network / batching / inference).  In the uncongested
limit (zero jitter, no congestion, no shedding, infinite deadline) the
per-frame mean degenerates *identically* to the analytic
``online_system_metrics`` formula; the congested regimes are where the
distributions (p50/p99) say what the scalar never could.

``DeadlineGroupFormer`` is the same release policy at the kernel level:
it collects per-camera frames and emits ONE ``RoIDetector.fleet_forward``
launch chain per release, stragglers riding the next release.  Frames
become tensors on the detector's device as they arrive, and the head maps
a release hands out are its own: a reuse-mode wave's heads are views of
the cache's canvas, which the next wave overwrites in place, so each
wave's heads are copied before the next wave runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.net.encoder import (CameraCoefficients, RateControlConfig,
                                     camera_coefficients,
                                     rate_controlled_departures,
                                     segment_byte_matrices, sent_matrix,
                                     zero_safe_div)
from repro_torch.net.links import (LinkConfig, bandwidth_traces,
                                   fifo_departures, outage_effective)
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace


@dataclass
class NetConfig:
    """Edge-to-server streaming runtime parameters (one group)."""
    link: LinkConfig = field(default_factory=LinkConfig)
    rate_control: RateControlConfig = field(default_factory=RateControlConfig)
    deadline_s: float = float("inf")   # batcher wait after segment close


@dataclass
class TransportStats:
    """Per-frame response-latency distribution + transport accounting."""
    latency_s: np.ndarray              # (F,) per-frame response latency
    parts: Dict[str, np.ndarray]       # per-frame breakdown, sums to latency
    frame_cam: np.ndarray              # (F,) positional camera of each frame
    bytes_total: float                 # shipped bytes (after shedding)
    bytes_base: float                  # un-shed wire load
    frames_sent: np.ndarray            # (C,) int64
    straggler_frames: int
    deadline_hits: int                 # releases cut short by the deadline
    quality_min: float                 # lowest rate-controller quality seen
    # shed composition: halo-ring bytes go first, static body rows after
    shed_halo_bytes: float = 0.0
    shed_body_bytes: float = 0.0

    @property
    def mean_s(self) -> float:
        return float(self.latency_s.mean()) if self.latency_s.size else 0.0

    @property
    def p50_s(self) -> float:
        return float(np.percentile(self.latency_s, 50)) \
            if self.latency_s.size else 0.0

    @property
    def p99_s(self) -> float:
        return float(np.percentile(self.latency_s, 99)) \
            if self.latency_s.size else 0.0

    @property
    def shed_bytes(self) -> float:
        return self.bytes_base - self.bytes_total

    @property
    def straggler_frac(self) -> float:
        n = self.latency_s.size
        return self.straggler_frames / n if n else 0.0

    def parts_mean(self) -> Dict[str, float]:
        return {k: float(v.mean()) if v.size else 0.0
                for k, v in self.parts.items()}

    def part_p99(self, key: str) -> float:
        v = self.parts[key]
        return float(np.percentile(v, 99)) if v.size else 0.0


def empty_transport(n_cameras: int = 0) -> TransportStats:
    """A zero-frame TransportStats: every distribution statistic
    (mean/p50/p99/part_p99/straggler_frac) is 0.0, never NaN or a
    raise — the degenerate windows (no cameras, no segments, every
    frame Reducto-filtered) fold into aggregation unharmed."""
    empty = np.zeros(0)
    return TransportStats(
        latency_s=empty,
        parts={k: empty.copy() for k in ("wait", "encode", "network",
                                         "batching", "inference")},
        frame_cam=np.zeros(0, np.int64), bytes_total=0.0, bytes_base=0.0,
        frames_sent=np.zeros(n_cameras, np.int64), straggler_frames=0,
        deadline_hits=0, quality_min=1.0)


def merge_transport(stats: Sequence[TransportStats]) -> TransportStats:
    """Fleet-level distribution: concatenate every group's frames."""
    if not stats:
        return empty_transport()
    keys = list(stats[0].parts)
    return TransportStats(
        latency_s=np.concatenate([s.latency_s for s in stats]),
        parts={k: np.concatenate([s.parts[k] for s in stats])
               for k in keys},
        frame_cam=np.concatenate([s.frame_cam for s in stats]),
        bytes_total=float(sum(s.bytes_total for s in stats)),
        bytes_base=float(sum(s.bytes_base for s in stats)),
        frames_sent=np.concatenate([s.frames_sent for s in stats]),
        straggler_frames=int(sum(s.straggler_frames for s in stats)),
        deadline_hits=int(sum(s.deadline_hits for s in stats)),
        quality_min=float(min(s.quality_min for s in stats)),
        shed_halo_bytes=float(sum(s.shed_halo_bytes for s in stats)),
        shed_body_bytes=float(sum(s.shed_body_bytes for s in stats)),
    )


def simulate_transport(cameras: Sequence, cam_groups, codec,
                       mask_areas: np.ndarray, keep,
                       segment_s: float, frames_per_seg: int, n_segs: int,
                       bandwidth_mbps: float, rtt_ms: float,
                       server_hz: float, pixels_per_s: float,
                       net: Optional[NetConfig] = None,
                       coef: Optional[CameraCoefficients] = None,
                       sent: Optional[np.ndarray] = None
                       ) -> TransportStats:
    """Instrumented entry: one ``transport`` span per simulated window
    and the wire/deadline accounting mirrored into ``obs.metrics``
    (no-ops while observability is disabled)."""
    with obs_trace.span("transport", cameras=len(cameras),
                        segments=int(n_segs)):
        ts = _simulate_transport(cameras, cam_groups, codec, mask_areas,
                                 keep, segment_s, frames_per_seg, n_segs,
                                 bandwidth_mbps, rtt_ms, server_hz,
                                 pixels_per_s, net, coef, sent)
    obs_metrics.observe_transport(ts)
    return ts


def _simulate_transport(cameras: Sequence, cam_groups, codec,
                        mask_areas: np.ndarray, keep,
                        segment_s: float, frames_per_seg: int, n_segs: int,
                        bandwidth_mbps: float, rtt_ms: float,
                        server_hz: float, pixels_per_s: float,
                        net: Optional[NetConfig] = None,
                        coef: Optional[CameraCoefficients] = None,
                        sent: Optional[np.ndarray] = None
                        ) -> TransportStats:
    """Simulate one group's online window end-to-end.

    All model inputs are duck-typed/plain (``codec`` carries the
    CodecModel fields; ``mask_areas`` is the (C,) per-camera RoI pixel
    area) so this module never imports the pipeline it is priced by.
    ``coef``/``sent`` accept the packetization the caller already built
    (the pipeline computes them for the analytic byte total anyway).
    Frames inside a segment are laid uniformly over the segment span
    (capture ``s*seg + (k+0.5)*seg/F``), which makes the mean in-segment
    wait exactly ``seg/2`` for any (fps, segment_s) pairing."""
    net = net or NetConfig()
    C = len(cameras)
    seg = segment_s
    F = frames_per_seg
    if C == 0 or n_segs == 0 or F == 0:
        # degenerate window: no cameras or no segments means no frames,
        # no reductions (arr.max(axis=0) on a (0, S) array raises) —
        # short-circuit to the canonical zero-frame stats
        return empty_transport(C)
    if coef is None:
        coef = camera_coefficients(cameras, cam_groups, codec)
    if sent is None:
        sent = sent_matrix(cameras, coef, keep, n_segs, F)
    body, halo, headers = segment_byte_matrices(coef, sent)
    base = body + halo + headers
    close = (np.arange(n_segs) + 1.0) * seg                     # (S,)
    enc = mask_areas[:, None] * sent / pixels_per_s             # (C, S)
    arrival_link = close[None, :] + enc

    bw = bandwidth_traces(net.link, bandwidth_mbps, base, seg)
    arrival_eff, start_floor = arrival_link, None
    if (bw <= 0).any():
        # uplink outage segments (congestion factor 0.0, trace fade to
        # zero, or a scripted blackout): rewrite to the outage-effective
        # form so the closed-form FIFO stays finite — backlog carries
        # across the outage and drains at the restored rate.  The
        # fallback prices a drain that never restores inside the window
        # at the nominal equal share.
        fallback_Bps = bandwidth_mbps * 1e6 / 8.0 / C
        arrival_eff, bw, start_floor = outage_effective(
            arrival_link, bw, seg, fallback_Bps)
    rc = net.rate_control
    if rc.enabled:
        # backlog is still measured against the ORIGINAL arrivals so the
        # controller keeps shedding through the outage
        dep, bytes_out, quality, shed_h, shed_b = \
            rate_controlled_departures(arrival_link, body, halo, headers,
                                       bw, rc, start_floor=start_floor)
    else:
        bytes_out, quality = base, np.ones_like(base)
        shed_h = shed_b = np.zeros_like(base)
        dep = fifo_departures(arrival_eff, zero_safe_div(bytes_out, bw))

    rtt_half = rtt_ms / 2e3
    arr_srv = dep + rtt_half                                    # (C, S)

    # ---- deadline release per segment --------------------------------------
    active = sent > 0
    if not active.any():
        # dead fleet slice: every camera shipped nothing (blackout, full
        # Reducto filtering, empty masks) — no releases form, so the
        # window degenerates to the canonical zero-frame stats
        return empty_transport(C)
    arr_m = np.where(active, arr_srv, -np.inf)
    last = arr_m.max(axis=0)                                    # (S,)
    release = np.minimum(last, close + net.deadline_s)
    on_time = active & (arr_srv <= release[None, :] + 1e-12)
    deadline_hits = int(np.count_nonzero(
        np.isfinite(last) & (last > close + net.deadline_s)))

    # ---- server FIFO over release + straggler events -----------------------
    n_rel = (sent * on_time).sum(axis=0)                        # (S,)
    rel_segs = np.nonzero(n_rel > 0)[0]
    strag_c, strag_s = np.nonzero(active & ~on_time)
    ev_time = np.concatenate([release[rel_segs],
                              arr_srv[strag_c, strag_s]])
    ev_n = np.concatenate([n_rel[rel_segs], sent[strag_c, strag_s]])
    n_ev = ev_time.shape[0]
    seg_ev = np.full(n_segs, -1, np.int64)
    seg_ev[rel_segs] = np.arange(rel_segs.size)
    evt_of_pair = np.where(on_time, seg_ev[None, :], -1)
    evt_of_pair = evt_of_pair.copy()
    evt_of_pair[strag_c, strag_s] = rel_segs.size \
        + np.arange(strag_c.size)

    ordv = np.argsort(ev_time, kind="stable")
    service = ev_n / server_hz
    dep_ev = fifo_departures(ev_time[ordv][None, :],
                             service[ordv][None, :])[0]
    start_ev = np.empty(n_ev)
    start_ev[ordv] = dep_ev - service[ordv]

    # ---- per-frame latency assembly (flat, no frame loop) ------------------
    win = n_segs * F
    K = np.zeros((C, win), bool)
    if keep is None:
        K[coef.has_mask] = True
    else:
        for ci, c in enumerate(cameras):
            if not coef.has_mask[ci]:
                continue
            src = np.asarray(keep[c.cam_id], bool)[:win]
            K[ci, :src.shape[0]] = src
    K3 = K.reshape(C, n_segs, F)
    cam_f, seg_f, k_f = np.nonzero(K3)
    nF = cam_f.size
    if nF == 0:
        empty = np.zeros(0)
        return TransportStats(empty, {k: empty.copy() for k in
                                      ("wait", "encode", "network",
                                       "batching", "inference")},
                              np.zeros(0, np.int64), 0.0, 0.0,
                              sent.sum(axis=1), 0, deadline_hits, 1.0)
    pair_f = cam_f * n_segs + seg_f
    cnt_pair = sent.reshape(-1)
    first = np.zeros(C * n_segs + 1, np.int64)
    first[1:] = np.cumsum(cnt_pair)
    rank_f = np.arange(nF) - first[pair_f]

    # within-event frame offsets: pairs ordered by (event, arrival, cam)
    pc, ps = np.nonzero(active)
    pe = evt_of_pair[pc, ps]
    order = np.lexsort((pc, arr_srv[pc, ps], pe))
    cnts_sorted = sent[pc, ps][order]
    gcum = np.concatenate([[0], np.cumsum(cnts_sorted)[:-1]])
    pe_sorted = pe[order]
    is_first = np.ones(order.size, bool)
    is_first[1:] = pe_sorted[1:] != pe_sorted[:-1]
    ev_base = np.zeros(n_ev, np.int64)
    ev_base[pe_sorted[is_first]] = gcum[is_first]
    off_sorted = gcum - ev_base[pe_sorted]
    off_cs = np.zeros((C, n_segs), np.int64)
    off_cs[pc[order], ps[order]] = off_sorted

    evt_f = evt_of_pair[cam_f, seg_f]
    j_f = off_cs[cam_f, seg_f] + rank_f
    t_cap = seg_f * seg + (k_f + 0.5) * seg / F
    infer_f = (j_f + 0.5 + C) / server_hz
    completion = start_ev[evt_f] + infer_f

    parts = {
        "wait": close[seg_f] - t_cap,
        "encode": enc[cam_f, seg_f],
        "network": dep[cam_f, seg_f] - arrival_link[cam_f, seg_f]
                   + rtt_half,
        "batching": start_ev[evt_f] - arr_srv[cam_f, seg_f],
        "inference": infer_f,
    }
    latency = completion - t_cap
    straggler_frames = int(sent[strag_c, strag_s].sum())
    return TransportStats(
        latency_s=latency, parts=parts, frame_cam=cam_f,
        bytes_total=float(bytes_out.sum()),
        bytes_base=float(base.sum()),
        frames_sent=sent.sum(axis=1),
        straggler_frames=straggler_frames,
        deadline_hits=deadline_hits,
        quality_min=float(quality.min()) if quality.size else 1.0,
        shed_halo_bytes=float(shed_h.sum()),
        shed_body_bytes=float(shed_b.sum()))


# ---------------------------------------------------------------------------
# kernel-level deadline group former (drives RoIDetector.fleet_forward)
# ---------------------------------------------------------------------------

@dataclass
class Release:
    t: float                           # release timestamp
    cams: List[int]                    # cameras in this launch
    straggler_cams: List[int]          # of those, late joiners
    deadline_hit: bool
    outputs: Dict[int, Any]            # cam -> head map (newest segment)
    # a camera offered its NEXT segment while this batch was still
    # pending: the batch is forced out so no frame is ever dropped
    # (legacy mode only — with straggler folding the older frame rides
    # the same packed launch instead)
    superseded: bool = False
    # cam -> older head maps (oldest first) for straggler segments that
    # were FOLDED into this release's packed launch instead of being
    # served as their own late launch
    folded_outputs: Dict[int, List[Any]] = field(default_factory=dict)

    @property
    def folded_frames(self) -> int:
        return sum(len(v) for v in self.folded_outputs.values())


class DeadlineGroupFormer:
    """Collects per-camera (frame, grid) arrivals for one camera group and
    fires ONE packed fleet launch (``det.fleet_forward``) per release:
    when every expected camera has arrived, or when the oldest pending
    arrival has waited ``deadline_s``.  Cameras that miss a release stay
    pending and ride the next one (straggler accounting per release).

    With ``fold_stragglers`` (the default), a straggler segment whose
    camera has already moved on to its next segment is NOT forced out as
    its own launch: both frames queue and ride the next release's packed
    super-launch together (the fleet-flat index space is per *entry*, not
    per camera, so one camera may contribute several segments to one
    launch).  Every fold reclaims one whole launch chain;
    ``reclaimed_launches`` counts them.  ``fold_stragglers=False`` keeps
    the legacy force-out (``superseded``) behavior."""

    def __init__(self, det, expected_cams: Sequence[int],
                 deadline_s: float, fold_stragglers: bool = True,
                 reuse_cache=None, threshold: float = 0.0,
                 fold_gate: str = "capture"):
        if fold_gate not in ("capture", "current"):
            raise ValueError(f"fold_gate must be 'capture' or 'current', "
                             f"got {fold_gate!r}")
        self.det = det
        self.expected = list(expected_cams)
        self.deadline_s = deadline_s
        self.fold_stragglers = fold_stragglers
        # temporal-reuse mode: with a ``PackedActivationCache``, every
        # release runs as CAPTURE-ORDER WAVES of full-group
        # ``fleet_forward_reuse`` steps (one wave per queued segment
        # depth; absent cameras re-submit their retained last frame,
        # which is bit-static and costs only its share of the gate).
        # ``fold_gate`` picks what a FOLDED late segment is gated
        # against: "capture" replays waves oldest-first, so each segment
        # deltas against the reference as of its own capture segment
        # (one segment of motion); "current" replays newest-first, so
        # late segments delta against the already-advanced current
        # reference — motion is priced twice and the fold launches
        # strictly more tiles (``reuse_launched_tiles`` makes the
        # comparison measurable).
        self.reuse_cache = reuse_cache
        self.threshold = threshold
        self.fold_gate = fold_gate
        self._retained: Dict[int, Tuple[Any, Any]] = {}  # cam -> (f, g)
        self.reuse_launched_tiles = 0
        self.reuse_total_tiles = 0
        self.reuse_waves = 0
        self._pending: Dict[int, List[Tuple[float, Any, Any]]] = {}
        self._late: set = set()        # cams whose batch left without them
        self.releases: List[Release] = []
        self.reclaimed_launches = 0    # solo straggler launches avoided

    @property
    def straggler_count(self) -> int:
        return sum(len(r.straggler_cams) for r in self.releases)

    def offer(self, now: float, cam: int, frame, grid
              ) -> Optional[Release]:
        """Feed one camera arrival; returns the release it triggered (the
        group completing, or — legacy mode — the pending batch being
        forced out because this camera moved on to its next segment), if
        any.  Call ``poll`` to let deadlines fire between arrivals.
        ``frame`` (an array or a tensor) becomes an f32 tensor on the
        detector's device here."""
        frame = torch.as_tensor(frame, dtype=torch.float32,
                                device=self.det.device)
        rel = None
        if self._pending.get(cam):
            if self.fold_stragglers:
                # the straggler segment stays queued and rides THIS
                # camera's next release as extra packed entries — one
                # whole launch chain reclaimed
                self.reclaimed_launches += 1
            else:
                # legacy: the camera's previous segment is still pending,
                # so force the batch out rather than dropping it silently
                rel = self._release(now, deadline_hit=False,
                                    superseded=True)
        self._pending.setdefault(cam, []).append((now, frame, grid))
        if set(self._pending) >= set(self.expected):
            return self._release(now, deadline_hit=False)
        return rel or self.poll(now)

    def poll(self, now: float) -> Optional[Release]:
        """Fire the deadline if the oldest pending arrival has waited
        longer than ``deadline_s``."""
        if not self._pending:
            return None
        oldest = min(t for q in self._pending.values() for t, _, _ in q)
        if now - oldest >= self.deadline_s:
            return self._release(now, deadline_hit=True)
        return None

    def force_release(self, now: float) -> Release:
        """Flush whatever is pending *right now* regardless of the
        deadline (window teardown / chaos-harness step boundary).  Safe
        on a dead fleet slice: with nothing pending the release forms NO
        launch — zero dispatches — and every expected camera is marked
        late so its eventual arrival rides a catch-up release as a
        straggler."""
        return self._release(now, deadline_hit=True)

    def _reuse_ready(self) -> bool:
        return self.reuse_cache is not None and all(
            c in self._retained or self._pending.get(c)
            for c in self.expected)

    def _release_reuse(self) -> Tuple[Dict[int, Any], Dict[int, List[Any]]]:
        """Replay the queued segments as waves of FULL-GROUP delta-gated
        steps.  Wave w holds each camera's w-th queued segment; a camera
        with fewer segments re-submits its last retained frame (bit-
        static — its tiles cost only the shared gate).  Wave order is
        the fold-gating policy: "capture" goes oldest-first (each
        segment gated against the reference as of its capture segment),
        "current" goes newest-first (folded late segments gated against
        the already-advanced reference)."""
        per_cam = {c: list(self._pending[c]) for c in self._pending}
        n_waves = max(len(q) for q in per_cam.values())
        order = range(n_waves) if self.fold_gate == "capture" \
            else range(n_waves - 1, -1, -1)
        filler = dict(self._retained)
        for c, q in per_cam.items():          # never-seen cams bootstrap
            filler.setdefault(c, (q[0][1], q[0][2]))
        heads_by: Dict[Tuple[int, int], Any] = {}
        for w in order:
            frames, grids = [], []
            for c in self.expected:
                q = per_cam.get(c)
                if q and w < len(q):
                    _, f, g = q[w]
                    if self.fold_gate == "capture":
                        filler[c] = (f, g)
                else:
                    f, g = filler[c]
                frames.append(f)
                grids.append(g)
            heads, stats = self.det.fleet_forward_reuse(
                frames, grids, self.reuse_cache, self.threshold)
            self.reuse_launched_tiles += stats.launched
            self.reuse_total_tiles += stats.total_tiles
            self.reuse_waves += 1
            for i, c in enumerate(self.expected):
                q = per_cam.get(c)
                if q and w < len(q):
                    # a view of the cache's canvas: copied before the next
                    # wave (or the next release) overwrites it in place
                    heads_by[(c, w)] = heads[i].clone()
        outputs: Dict[int, Any] = {}
        folded: Dict[int, List[Any]] = {}
        for c, q in per_cam.items():          # fold bookkeeping: capture
            for w in range(len(q)):           # order, newest wins
                if c in outputs:
                    folded.setdefault(c, []).append(outputs[c])
                outputs[c] = heads_by[(c, w)]
            self._retained[c] = (q[-1][1], q[-1][2])
        return outputs, folded

    def _release(self, now: float, deadline_hit: bool,
                 superseded: bool = False) -> Release:
        cams = sorted(self._pending)
        backlog = sum(len(q) for q in self._pending.values())
        obs_metrics.BACKLOG_DEPTH.observe(backlog)
        obs_metrics.DEADLINE_EVENTS.inc(1, event="release")
        if deadline_hit:
            obs_metrics.DEADLINE_EVENTS.inc(1, event="deadline_hit")
        with obs_trace.span("release", cams=len(cams), backlog=backlog,
                            deadline_hit=deadline_hit):
            if not cams:
                # dead fleet slice: every expected camera missed the
                # deadline — short-circuit to an empty release (no
                # fleet_forward call, zero dispatches) instead of
                # forming a zero-camera launch.  The guard must precede
                # ``_reuse_ready`` (with every camera retained it would
                # report ready and ``_release_reuse`` would crash on an
                # empty wave max()).
                outputs, folded = {}, {}
            elif self._reuse_ready():
                outputs, folded = self._release_reuse()
            else:
                entries = [(c, t, f, g) for c in cams
                           for (t, f, g) in self._pending[c]]
                frames = [f for _, _, f, _ in entries]
                grids = [g for _, _, _, g in entries]
                # ONE packed launch chain for every queued segment of
                # every camera — folded straggler segments are just
                # extra entries in the same fleet-flat index space
                outs = self.det.fleet_forward(frames, grids)
                outputs = {}
                folded = {}
                for (c, _, _, _), o in zip(entries, outs):
                    if c in outputs:
                        folded.setdefault(c, []).append(outputs[c])
                    outputs[c] = o         # newest segment wins the slot
                for c in cams:             # retained state feeds a later
                    t, f, g = self._pending[c][-1]  # switch to reuse mode
                    self._retained[c] = (f, g)
        stragglers = [c for c in cams if c in self._late]
        if not cams:
            # every expected camera is now late: their eventual arrivals
            # must be counted as stragglers by the next real release
            self._late = set(self.expected)
        elif set(cams) <= self._late:
            # a pure catch-up launch of the PREVIOUS cycle's stragglers:
            # the punctual cameras' batch already left without them, so
            # this release must not mark them late for the next cycle
            self._late = self._late - set(cams)
        else:
            self._late = {c for c in self.expected if c not in cams}
        self._pending.clear()
        rel = Release(now, cams, stragglers, deadline_hit, outputs,
                      superseded, folded)
        self.releases.append(rel)
        return rel


# ---------------------------------------------------------------------------
# transport heartbeat: per-camera liveness at the link level
# ---------------------------------------------------------------------------

@dataclass
class HeartbeatConfig:
    """Transport-level liveness parameters.  A camera *beats* on every
    segment arrival; missing ``timeout_beats`` consecutive expected
    beats marks it dead.  While dead, reconnect attempts follow
    exponential backoff (``base * factor**k`` capped at ``max_s``) —
    the retry *accounting* is what the chaos harness measures; an
    actual arrival restores the camera instantly regardless of where
    the backoff clock stands."""
    interval_s: float = 1.0            # expected beat cadence
    timeout_beats: float = 3.0         # missed intervals before "dead"
    backoff_base_s: float = 0.5        # first retry delay after death
    backoff_factor: float = 2.0
    backoff_max_s: float = 8.0

    @property
    def timeout_s(self) -> float:
        return self.interval_s * self.timeout_beats


class HeartbeatMonitor:
    """Per-camera transport heartbeat with timeout detection and
    exponential-backoff retry accounting.

    Drives the *transport* half of fault detection (uplink outages and
    camera blackouts kill the beat; frozen cameras keep beating — those
    are the liveness monitor's job in ``fleet/faults.py``).  The event
    log carries ``(t, cam, kind)`` with kind in {"dead", "retry",
    "restored"}; ``detect_latency(cam)`` reports beats-to-detection for
    the chaos panel."""

    def __init__(self, cams: Sequence[int],
                 cfg: Optional[HeartbeatConfig] = None, t0: float = 0.0):
        self.cfg = cfg or HeartbeatConfig()
        self.last_beat: Dict[int, float] = {c: t0 for c in cams}
        self.dead: set = set()
        self.retries: Dict[int, int] = {c: 0 for c in cams}
        self._next_retry: Dict[int, float] = {}
        self._died_at: Dict[int, float] = {}
        self.events: List[Tuple[float, int, str]] = []

    def beat(self, t: float, cam: int) -> bool:
        """Record an arrival; returns True when it RESTORES a camera
        previously declared dead."""
        self.last_beat[cam] = t
        if cam in self.dead:
            self.dead.discard(cam)
            self._next_retry.pop(cam, None)
            self.retries[cam] = 0
            self.events.append((t, cam, "restored"))
            obs_metrics.HEARTBEAT_EVENTS.inc(1, event="restored")
            return True
        return False

    def poll(self, t: float) -> List[int]:
        """Advance the clock: returns cameras newly declared dead at
        ``t``; charges backoff retries for already-dead cameras."""
        newly = []
        for cam, last in self.last_beat.items():
            if cam in self.dead:
                nxt = self._next_retry[cam]
                while t >= nxt:
                    self.retries[cam] += 1
                    self.events.append((nxt, cam, "retry"))
                    obs_metrics.HEARTBEAT_EVENTS.inc(1, event="retry")
                    delay = min(self.cfg.backoff_base_s
                                * self.cfg.backoff_factor
                                ** self.retries[cam],
                                self.cfg.backoff_max_s)
                    nxt = nxt + delay
                self._next_retry[cam] = nxt
            elif t - last >= self.cfg.timeout_s:
                self.dead.add(cam)
                self._died_at[cam] = t
                self.retries[cam] = 0
                self._next_retry[cam] = t + self.cfg.backoff_base_s
                self.events.append((t, cam, "dead"))
                obs_metrics.HEARTBEAT_EVENTS.inc(1, event="dead")
                newly.append(cam)
        return newly

    def detect_latency(self, cam: int) -> float:
        """Seconds from the last good beat to the death declaration
        (NaN if the camera was never declared dead)."""
        if cam not in self._died_at:
            return float("nan")
        return self._died_at[cam] - self.last_beat[cam]
