"""CrossRoI offline + online phases (paper §4.1) and evaluation metrics.

Offline: synchronized profiling clips -> noisy ReID -> tandem filters ->
association table -> set-cover RoI masks -> tile grouping.  Online: per
segment, cameras crop to their mask, the codec model prices the encoded
groups, the server model prices inference; metrics follow §5.1.2 exactly:
accuracy, network overhead (Mbps), system throughput (server Hz + camera
fps), end-to-end response latency.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.association import (AssociationTable, TileUniverse,
                                          build_association_table)
from repro_torch.core.compression import CodecModel, EncoderModel
from repro_torch.core.filters import (FilterConfig, FilterStats,
                                      apply_filters)
from repro_torch.core.grouping import TileGroup, group_tiles
from repro_torch.core.reid import (ReIDNoiseConfig, ReIDRecord,
                                   run_noisy_reid)
from repro_torch.core.scene import Scene
from repro_torch.core import setcover
# the edge-to-server streaming runtime (numpy-only at import time); the
# analytic byte model delegates to its packetizer so the analytic and
# simulated transport paths cannot drift apart
from repro_torch.net.batcher import (NetConfig, TransportStats,
                                     simulate_transport)
from repro_torch.net.encoder import (camera_coefficients,
                                     segment_byte_matrices, sent_matrix)


# ---------------------------------------------------------------------------
# server inference model (RoI-YOLO / SBNet)
# ---------------------------------------------------------------------------

# one gather + one scatter move ~2x the active-tile bytes: the structural
# I/O tax of RoI inference, in dense-time units.  Canonical home; the
# detector's cost model imports it, and tests/test_packed_path.py pins the
# detector and ServerModel speedup curves to each other.
IO_ROUND_TRIP_OVERHEAD = 0.30


@dataclass
class ServerModel:
    """Calibrated to the paper: dense YOLOv3 at 540p ~= 52 Hz on their GPU;
    SBNet RoI inference time ~= (gather/scatter overhead + RoI fraction) of
    dense time, giving 1.18x at ~55% density and 1.5-2.5x at 10-20% (§4.4).

    The paper's SBNet pays the gather/scatter round-trip (moving ~2x the
    active bytes) once *per conv layer*; our packed-resident kernel chain
    (kernels/roi_conv.roi_conv_packed) pays it once *per stack* — gather is
    fused into the first conv, layers stay packed via neighbor-table halos,
    and a single scatter materializes the output.  The structural overhead
    is therefore the round-trip constant amortized over ``num_layers``
    (num_layers=1 recovers the paper's per-layer SBNet regime)."""
    dense_hz: float = 52.07
    io_round_trip: float = IO_ROUND_TRIP_OVERHEAD
    num_layers: int = 3            # conv stack depth the round-trip amortizes over
    switch_density: float = 0.70   # above this, fall back to dense YOLO

    @property
    def sbnet_overhead(self) -> float:
        """Per-layer gather/scatter overhead under packed execution."""
        return self.io_round_trip / max(self.num_layers, 1)

    def speedup(self, roi_density: float) -> float:
        if roi_density >= self.switch_density:
            return 1.0
        return 1.0 / (self.sbnet_overhead + roi_density)

    def throughput_hz(self, roi_density: float, roi_inference: bool) -> float:
        if not roi_inference:
            return self.dense_hz
        return self.dense_hz * self.speedup(roi_density)


# ---------------------------------------------------------------------------
# offline phase
# ---------------------------------------------------------------------------

@dataclass
class OfflineConfig:
    profile_frames: int = 600            # 60 s at 10 fps (paper)
    filters: FilterConfig = field(default_factory=FilterConfig)
    reid_noise: ReIDNoiseConfig = field(default_factory=ReIDNoiseConfig)
    solver: str = "exact"                # greedy | exact | milp
    merge_tiles: bool = True             # No-Merging ablation switch


@dataclass
class OfflineResult:
    universe: TileUniverse
    mask: FrozenSet[int]                      # union mask M (global tile ids)
    cam_grids: Dict[int, np.ndarray]          # per-cam bool (ty, tx)
    cam_groups: Dict[int, List[TileGroup]]    # per-cam merged rectangles
    solve: setcover.SolveResult
    filter_stats: FilterStats
    reid_records: List[ReIDRecord]
    table: AssociationTable
    wall_s: float = 0.0

    def mask_fraction(self, cam: int) -> float:
        g = self.cam_grids[cam]
        return float(g.mean())

    def mask_area_px(self, cam: int) -> float:
        c = self.universe.cameras[cam]
        total = 0.0
        for g in self.cam_groups[cam]:
            x0, y0 = g.x0 * c.tile, g.y0 * c.tile
            total += (min(g.w * c.tile, c.width - x0)
                      * min(g.h * c.tile, c.height - y0))
        return total

    @property
    def fleet_density(self) -> float:
        """RoI pixels / total pixels across the fleet."""
        tot = sum(c.width * c.height for c in self.universe.cameras)
        return sum(self.mask_area_px(c.cam_id)
                   for c in self.universe.cameras) / tot


def run_offline(scene: Scene, cfg: Optional[OfflineConfig] = None,
                t0_frame: int = 0) -> OfflineResult:
    """``t0_frame`` shifts the profiling window to
    [t0_frame, t0_frame + profile_frames) — the drift adapter uses it to
    re-profile on a recent window of the stream (shrink re-solves)."""
    cfg = cfg or OfflineConfig()
    t0 = time.time()
    universe = TileUniverse.build(scene.cameras)

    records = run_noisy_reid(scene, cfg.reid_noise, t0_frame,
                             t0_frame + cfg.profile_frames)
    cleaned, fstats = apply_filters(records, len(scene.cameras), cfg.filters)
    table = build_association_table(cleaned, universe)
    sres = setcover.solve(table, cfg.solver)

    cam_grids = {c.cam_id: universe.cam_mask_grid(c.cam_id, sres.mask)
                 for c in scene.cameras}
    cam_groups = {}
    for c in scene.cameras:
        grid = cam_grids[c.cam_id]
        if cfg.merge_tiles:
            cam_groups[c.cam_id] = group_tiles(grid)
        else:  # No-Merging: every tile its own group
            ys, xs = np.nonzero(grid)
            cam_groups[c.cam_id] = [TileGroup(int(y), int(x), 1, 1)
                                    for y, x in zip(ys, xs)]
    return OfflineResult(universe, sres.mask, cam_grids, cam_groups, sres,
                         fstats, cleaned, table, wall_s=time.time() - t0)


def full_frame_offline(scene: Scene) -> OfflineResult:
    """Baseline ablation: mask = everything (no CrossRoI)."""
    universe = TileUniverse.build(scene.cameras)
    mask = frozenset(range(universe.num_tiles))
    cam_grids = {c.cam_id: np.ones((c.tiles_y, c.tiles_x), bool)
                 for c in scene.cameras}
    cam_groups = {c.cam_id: [TileGroup(0, 0, c.tiles_y, c.tiles_x)]
                  for c in scene.cameras}
    sres = setcover.SolveResult(mask, 0.0, "baseline")
    return OfflineResult(universe, mask, cam_grids, cam_groups, sres,
                         FilterStats(), [], AssociationTable(universe, [], []))


# ---------------------------------------------------------------------------
# online phase
# ---------------------------------------------------------------------------

@dataclass
class OnlineConfig:
    segment_s: float = 1.0
    bandwidth_mbps: float = 30.0
    rtt_ms: float = 10.0
    roi_inference: bool = True            # No-RoIInf ablation switch
    frame_keep: Optional[Dict[int, np.ndarray]] = None  # Reducto keep masks
    # transport pricing: "analytic" is the steady-state scalar formula;
    # "simulated" runs the repro_torch.net edge-to-server runtime (per-camera
    # uplinks, rate control, deadline batching) and yields per-frame
    # latency distributions.  ``net`` configures the simulated path.
    transport: str = "analytic"
    net: Optional[NetConfig] = None
    # Detector tolerance: YOLO still finds an object when a thin boundary
    # strip is cropped; a detection counts if >= this fraction of the bbox
    # pixel area survives the RoI crop.  1.0 recovers the strict
    # every-tile-covered criterion the optimizer guarantees for >= 1
    # appearance of every profiled object.
    coverage_thresh: float = 0.75


@dataclass
class OnlineMetrics:
    accuracy: float
    missed: int
    total_appearances: int
    missed_per_t: np.ndarray
    network_mbps: float
    server_hz: float
    camera_fps: float
    latency_s: float
    latency_parts: Dict[str, float]
    frames_reduced: int = 0
    # per-frame latency distribution (simulated transport only)
    transport: Optional[TransportStats] = None

    @property
    def latency_p50_s(self) -> float:
        return self.transport.p50_s if self.transport else self.latency_s

    @property
    def latency_p99_s(self) -> float:
        return self.transport.p99_s if self.transport else self.latency_s


def _covered(tiles: FrozenSet[int], mask: FrozenSet[int]) -> bool:
    return tiles <= mask


def integral_image(grid: np.ndarray) -> np.ndarray:
    """(H, W) counts -> (H+1, W+1) 2-D prefix sums: rect sums in 4 lookups
    (I[y1+1, x1+1] - I[y0, x1+1] - I[y1+1, x0] + I[y0, x0])."""
    I = np.zeros((grid.shape[0] + 1, grid.shape[1] + 1), np.int64)
    I[1:, 1:] = grid.astype(np.int64).cumsum(0).cumsum(1)
    return I


def _bbox_tile_overlaps(cam, lefts, tops, rights, bottoms):
    """Per-axis bbox/tile-row overlap lengths for a batch of boxes.

    Returns (iy (n, tiles_y), ix (n, tiles_x)): clipped intersection length
    of each bbox with each tile row/column — the separable factors of the
    bbox ∩ tile-rect areas (area[n, ty, tx] = iy[n, ty] * ix[n, tx])."""
    T = cam.tile
    txs = np.arange(cam.tiles_x) * T
    tys = np.arange(cam.tiles_y) * T
    ix = np.clip(np.minimum(rights[:, None], txs[None, :] + T)
                 - np.maximum(lefts[:, None], txs[None, :]), 0.0, None)
    iy = np.clip(np.minimum(bottoms[:, None], tys[None, :] + T)
                 - np.maximum(tops[:, None], tys[None, :]), 0.0, None)
    return iy, ix


def bbox_mask_area(cam, grid: np.ndarray, b) -> float:
    """Pixel area of bbox ∩ RoI mask (sum over intersected tile rects).
    Scalar fast path: touches only the tiles the bbox intersects (callers
    loop per detection; the full-grid form lives in _detects_batch)."""
    T = cam.tile
    x0 = max(int(b.left) // T, 0)
    x1 = min(int(np.ceil(b.right / T)), cam.tiles_x)
    y0 = max(int(b.top) // T, 0)
    y1 = min(int(np.ceil(b.bottom / T)), cam.tiles_y)
    if x1 <= x0 or y1 <= y0:
        return 0.0
    txs = np.arange(x0, x1) * T
    tys = np.arange(y0, y1) * T
    ix = np.clip(np.minimum(b.right, txs + T) - np.maximum(b.left, txs),
                 0.0, None)
    iy = np.clip(np.minimum(b.bottom, tys + T) - np.maximum(b.top, tys),
                 0.0, None)
    return float(iy @ grid[y0:y1, x0:x1].astype(np.float64) @ ix)


def bbox_arrays(bboxes) -> Tuple[np.ndarray, ...]:
    """(left, top, right, bottom, area) float64 arrays for a bbox batch."""
    n = len(bboxes)
    l = np.fromiter((b.left for b in bboxes), np.float64, n)
    t = np.fromiter((b.top for b in bboxes), np.float64, n)
    r = np.fromiter((b.right for b in bboxes), np.float64, n)
    btm = np.fromiter((b.bottom for b in bboxes), np.float64, n)
    area = np.fromiter((b.area for b in bboxes), np.float64, n)
    return l, t, r, btm, area


def coverage_flags_batched(cameras: Sequence, grids: Sequence[np.ndarray],
                           det_cam: np.ndarray, l: np.ndarray, t: np.ndarray,
                           r: np.ndarray, btm: np.ndarray, area: np.ndarray,
                           thresh: float, chunk: int = 8192) -> np.ndarray:
    """Detector coverage flags for a flat detection batch spanning ANY set
    of cameras — one scene's five or a whole fleet's K groups — with no
    per-camera Python loop.  ``det_cam`` indexes positionally into
    ``cameras``/``grids``.  Per-camera grids are laid out on a padded
    (C, TY, TX) canvas; the padding is all-False and every bbox is clipped
    to its own frame, so results are exactly the per-camera evaluation.

    thresh >= 1.0 is the strict every-tile-covered criterion (stacked
    integral images, 4 gathers per bbox); below it, a detection counts if
    >= thresh of its pixel area survives the RoI crop (separable
    bbox/tile-rect overlap, contracted in camera-indexed chunks)."""
    n = det_cam.shape[0]
    if n == 0:
        return np.zeros(0, bool)
    T = cameras[0].tile
    assert all(c.tile == T for c in cameras), "fleet cameras share tile size"
    tiles_x = np.asarray([c.tiles_x for c in cameras], np.int64)
    tiles_y = np.asarray([c.tiles_y for c in cameras], np.int64)
    TY, TX = int(tiles_y.max()), int(tiles_x.max())
    if thresh >= 1.0:
        I = np.zeros((len(cameras), TY + 1, TX + 1), np.int64)
        for ci, g in enumerate(grids):
            I[ci, :g.shape[0] + 1, :g.shape[1] + 1] = integral_image(g)
        cx, cy = tiles_x[det_cam], tiles_y[det_cam]
        x0 = np.clip(l.astype(np.int64) // T, 0, cx)
        y0 = np.clip(t.astype(np.int64) // T, 0, cy)
        x1 = np.minimum(np.ceil(r / T).astype(np.int64) - 1, cx - 1)
        y1 = np.minimum(np.ceil(btm / T).astype(np.int64) - 1, cy - 1)
        empty = (x1 < x0) | (y1 < y0)
        # clamp lookup corners so empty rects stay in-bounds (their cnt is
        # discarded — `empty` short-circuits to covered)
        x1c = np.maximum(x1, x0 - 1)
        y1c = np.maximum(y1, y0 - 1)
        cnt = (I[det_cam, y1c + 1, x1c + 1] - I[det_cam, y0, x1c + 1]
               - I[det_cam, y1c + 1, x0] + I[det_cam, y0, x0])
        full = cnt == (y1c - y0 + 1) * (x1c - x0 + 1)
        return empty | full
    G = np.zeros((len(cameras), TY, TX), np.float64)
    for ci, g in enumerate(grids):
        G[ci, :g.shape[0], :g.shape[1]] = g
    txs = np.arange(TX) * T
    tys = np.arange(TY) * T
    cov = np.empty(n, np.float64)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        ix = np.clip(np.minimum(r[s:e, None], txs[None, :] + T)
                     - np.maximum(l[s:e, None], txs[None, :]), 0.0, None)
        iy = np.clip(np.minimum(btm[s:e, None], tys[None, :] + T)
                     - np.maximum(t[s:e, None], tys[None, :]), 0.0, None)
        cov[s:e] = np.einsum("ny,nx,nyx->n", iy, ix, G[det_cam[s:e]])
    return cov >= thresh * np.maximum(area, 1.0)


def _detects_batch(cam, offline: OfflineResult, bboxes, thresh: float
                   ) -> np.ndarray:
    """Vectorized ``_detects`` over all of one camera's detections."""
    grid = offline.cam_grids[cam.cam_id]
    l, t, r, btm, area = bbox_arrays(bboxes)
    det_cam = np.zeros(len(bboxes), np.int64)
    return coverage_flags_batched([cam], [grid], det_cam, l, t, r, btm,
                                  area, thresh)


def segment_network_bytes(cameras: Sequence, cam_groups, codec: CodecModel,
                          keep, n_segs: int, frames_per_seg: int
                          ) -> Tuple[float, np.ndarray]:
    """Vectorized (cameras x segments) streaming model.

    Delegates to the ``repro_torch.net.encoder`` packetizer: per-segment
    sent-frame counts come from one reshape-sum over the keep masks, and
    the codec's group pricing — linear in activity — collapses to
    per-camera (body, halo, header) coefficients times the segment
    activity series.  Headers are charged per shipped segment and ONLY
    for cameras with a nonzero mask: an empty-mask camera streams nothing
    — no container overhead, and its ``frames_sent`` entry is 0 (it used
    to report full frame counts, which leaked phantom frames into the
    fleet latency/transport model).  Returns (total_bytes, frames_sent
    (C,) int64 positional per camera)."""
    coef = camera_coefficients(cameras, cam_groups, codec)
    sent = sent_matrix(cameras, coef, keep, n_segs, frames_per_seg)
    body, halo, headers = segment_byte_matrices(coef, sent)
    return float((body + halo + headers).sum()), sent.sum(axis=1)


def online_system_metrics(cameras: Sequence, offline: OfflineResult,
                          cfg: "OnlineConfig", fps: float, n_frames: int,
                          keep=None):
    """Network / throughput / latency block of the online phase, shared by
    ``run_online`` (one scene) and the fleet runtime (per group) so the
    two stay numerically identical by construction.  Returns
    (network_mbps, server_hz, camera_fps, latency_s, latency_parts,
    total_bytes, frames_sent (C,), transport).

    ``cfg.transport`` selects the pricing: "analytic" keeps the paper's
    steady-state scalar formula; "simulated" runs the ``repro_torch.net``
    edge-to-server runtime (per-camera uplink FIFOs, optional jitter/
    congestion/rate control, deadline group batching) and reports the
    per-frame distribution — ``latency_s`` becomes the per-frame mean,
    which in the uncongested limit equals the analytic value identically,
    and ``transport`` carries p50/p99 and the per-part breakdown."""
    codec = CodecModel.calibrated(cameras, fps)
    encoder = EncoderModel()
    server = ServerModel()
    frames_per_seg = max(int(round(cfg.segment_s * fps)), 1)
    n_segs = max(n_frames // frames_per_seg, 1)
    # packetize once; the simulated transport path reuses coef/sent
    # instead of rebuilding them (same math as segment_network_bytes)
    coef = camera_coefficients(cameras, offline.cam_groups, codec)
    sent = sent_matrix(cameras, coef, keep, n_segs, frames_per_seg)
    body, halo, headers = segment_byte_matrices(coef, sent)
    total_bytes = float((body + halo + headers).sum())
    frames_sent = sent.sum(axis=1)
    duration_s = n_frames / fps
    network_mbps = total_bytes * 8.0 / duration_s / 1e6

    roi_density = offline.fleet_density
    server_hz = server.throughput_hz(roi_density, cfg.roi_inference)
    # camera fps: bounded by encode speed over the cropped area (worst cam)
    worst_area = max(offline.mask_area_px(c.cam_id) for c in cameras)
    camera_fps = min(encoder.throughput_fps(worst_area), 160.0)

    seg = cfg.segment_s
    wait = seg / 2.0                                 # frame->segment close
    enc = max(offline.mask_area_px(c.cam_id) * frames_per_seg
              for c in cameras) / encoder.pixels_per_s
    seg_bytes = total_bytes / n_segs
    tx = seg_bytes * 8.0 / (cfg.bandwidth_mbps * 1e6) + cfg.rtt_ms / 2e3
    # the server runs the segment's fleet-frames through the detector in
    # arrival order: the average frame sits behind half the segment, plus
    # one in-flight frame per camera stream.
    avg_sent_per_seg = float(frames_sent.sum()) / n_segs
    infer = (avg_sent_per_seg / 2.0 + len(cameras)) / server_hz
    latency = wait + enc + tx + infer
    parts = {"wait": wait, "encode": enc, "network": tx, "inference": infer}
    transport = None
    if cfg.transport == "simulated":
        mask_areas = np.asarray([offline.mask_area_px(c.cam_id)
                                 for c in cameras])
        transport = simulate_transport(
            cameras, offline.cam_groups, codec, mask_areas, keep,
            cfg.segment_s, frames_per_seg, n_segs, cfg.bandwidth_mbps,
            cfg.rtt_ms, server_hz, encoder.pixels_per_s, cfg.net,
            coef=coef, sent=sent)
        latency = transport.mean_s
        parts = transport.parts_mean()
        total_bytes = transport.bytes_total
        network_mbps = total_bytes * 8.0 / duration_s / 1e6
    elif cfg.transport != "analytic":
        raise ValueError(f"unknown transport {cfg.transport!r}")
    return (network_mbps, server_hz, camera_fps, latency, parts,
            total_bytes, frames_sent, transport)


def _detects(scene: Scene, offline: OfflineResult, d, thresh: float) -> bool:
    """Whether the server's detector finds detection ``d`` after RoI crop."""
    cam = scene.cameras[d.cam]
    if thresh >= 1.0:
        tiles = offline.universe.globalize(d.cam, cam.bbox_tiles(d.bbox))
        return _covered(tiles, offline.mask)
    cov = bbox_mask_area(cam, offline.cam_grids[d.cam], d.bbox)
    return cov >= thresh * max(d.bbox.area, 1.0)


def run_online(scene: Scene, offline: OfflineResult,
               cfg: Optional[OnlineConfig] = None,
               t0: Optional[int] = None, t1: Optional[int] = None
               ) -> OnlineMetrics:
    cfg = cfg or OnlineConfig()
    t0 = t0 if t0 is not None else 600          # eval = last 120 s (paper)
    t1 = t1 if t1 is not None else len(scene.detections)
    n_frames = t1 - t0
    fps = scene.cfg.fps
    universe = offline.universe

    # ---- accuracy: unique-vehicle detection per timestamp ----------------
    # Vectorized: (1) per-camera batched coverage flags for every detection
    # in the window (the former O(frames * dets * tiles) Python hot spot),
    # then (2) array set-logic over (frame, camera, object) occupancy
    # grids, with the Reducto frame-filter's last-streamed-result reuse
    # expressed as a per-camera forward fill over kept frames.
    missed_per_t = np.zeros(n_frames, np.int64)
    total = 0
    keep = cfg.frame_keep
    dets_flat = [(ti - t0, d) for ti in range(t0, t1)
                 for d in scene.detections[ti]]
    if dets_flat:
        nd = len(dets_flat)
        det_t = np.fromiter((t for t, _ in dets_flat), np.int64, nd)
        det_cam = np.fromiter((d.cam for _, d in dets_flat), np.int64, nd)
        obj_ids, det_obj = np.unique(
            np.fromiter((d.obj for _, d in dets_flat), np.int64, nd),
            return_inverse=True)
        l, tt, rr, bb, area = bbox_arrays([d.bbox for _, d in dets_flat])
        flags = coverage_flags_batched(
            scene.cameras, [offline.cam_grids[c.cam_id]
                            for c in scene.cameras],
            det_cam, l, tt, rr, bb, area, cfg.coverage_thresh)

        C, O = len(scene.cameras), len(obj_ids)
        present = np.zeros((n_frames, O), bool)
        present[det_t, det_obj] = True
        exists = np.zeros((n_frames, C, O), bool)     # a det at (t, cam, obj)
        exists[det_t, det_cam, det_obj] = True
        cur = np.zeros((n_frames, C, O), bool)        # ... that is detected
        cur[det_t[flags], det_cam[flags], det_obj[flags]] = True

        if keep is None:
            detected = cur.any(axis=1)
        else:
            # a filtered frame reuses the detector output of the camera's
            # most recent *streamed* frame (strictly before t)
            used = np.empty_like(cur)
            for ci, c in enumerate(scene.cameras):
                km = np.asarray(keep[c.cam_id][:n_frames], bool)
                kt = np.nonzero(km)[0]
                if kt.size == 0:                      # camera never streams
                    used[:, ci, :] = False
                    continue
                j = np.searchsorted(kt, np.arange(n_frames),
                                    side="left") - 1
                last = cur[kt[np.maximum(j, 0)], ci, :]
                last[j < 0] = False                   # nothing streamed yet
                used[:, ci, :] = np.where(km[:, None], cur[:, ci, :], last)
            detected = (exists & used).any(axis=1)

        missed_per_t = (present & ~detected).sum(axis=1).astype(np.int64)
        total = int(present.sum())
    missed = int(missed_per_t.sum())
    accuracy = 1.0 - missed / max(total, 1)

    # ---- network / throughput / latency -----------------------------------
    # per-frame activity: fraction of streamed content that changed; approx
    # by object bbox area within the mask relative to mask area; segment
    # compression efficiency improves with longer segments (more temporal
    # references): activity ~ 1/sqrt(seg frames / 10)
    (network_mbps, server_hz, camera_fps, latency, parts, _, _,
     transport) = online_system_metrics(scene.cameras, offline, cfg, fps,
                                        n_frames, keep)

    frames_reduced = 0
    if keep is not None:
        frames_reduced = int(sum((~keep[c.cam_id]).sum()
                                 for c in scene.cameras))
    return OnlineMetrics(accuracy, missed, total, missed_per_t, network_mbps,
                         server_hz, camera_fps, latency, parts,
                         frames_reduced, transport)
