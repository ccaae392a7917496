"""The fleet runtime: K camera groups, one engine, no per-camera loops.

* ``run_fleet_offline`` -- the offline phase per group.  Groups are
  independent by construction (``fleet.topology``), so this is the
  single-intersection pipeline (``core.pipeline.run_offline``) run K times;
  each group's result equals its run in isolation.
* ``run_fleet_online`` -- the online phase for the whole fleet as one
  vectorized evaluation: every detection of every camera of every group is
  flattened, and the coverage flags come from one
  ``coverage_flags_batched`` call over the fleet's stacked mask grids.
  Per-group metrics equal ``run_online`` on that group alone.  Reducto keep
  masks ride along per group (``frame_keep[gid][cam_id]``), and
  ``cfg.transport="simulated"`` prices every group through the ``net``
  streaming runtime and merges the per-frame latencies fleet-wide.
* ``fleet_inference_step`` -- the kernel-level cold super-launch: one fused
  gather + conv entry kernel, one layer-stack kernel for every later
  layer, one scatter -- at most 3 dispatches per fleet step, whatever the
  number of groups and layers.  ``fleet_reuse_step`` is the delta-gated
  variant: one ``tile_delta_gate`` dispatch prices every active tile
  against the cache, the same chain runs on the changed tiles only, and
  one changed-only scatter updates the persistent head-map canvas.
  ``sharded_fleet_step`` runs one step of the sharded runtime
  (``fleet.sharded``): the same launches, each once per step whatever the
  shard count.  All three assert their dispatch structure on every step
  and record their spans and metrics in ``obs`` (off by default).

The offline and online phases are host numpy, the same code as the JAX
package's; the two steps run on the detector's device.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.pipeline import (OfflineConfig, OfflineResult,
                                       OnlineConfig, OnlineMetrics,
                                       bbox_arrays, coverage_flags_batched,
                                       online_system_metrics, run_offline)
from repro_torch.fleet.topology import FleetScene
from repro_torch.kernels import ops as kops
from repro_torch.net.batcher import TransportStats, merge_transport
from repro_torch.obs import metrics as obs_metrics, trace as obs_trace


# ---------------------------------------------------------------------------
# offline phase
# ---------------------------------------------------------------------------

@dataclass
class FleetOfflineResult:
    per_group: List[OfflineResult]
    wall_s: float = 0.0

    @property
    def fleet_density(self) -> float:
        return float(np.mean([o.fleet_density for o in self.per_group]))


def run_fleet_offline(fleet: FleetScene,
                      cfg: Optional[OfflineConfig] = None
                      ) -> FleetOfflineResult:
    t0 = time.time()
    per_group = [run_offline(g.scene, cfg) for g in fleet.groups]
    return FleetOfflineResult(per_group, wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# online phase (vectorized across the whole fleet)
# ---------------------------------------------------------------------------

@dataclass
class FleetOnlineMetrics:
    per_group: List[OnlineMetrics]
    accuracy_mean: float
    accuracy_min: float
    network_mbps_total: float
    fleet_server_hz: float        # one engine multiplexing all groups
    camera_fps_min: float
    latency_max_s: float
    wall_s: float = 0.0
    frames_reduced: int = 0       # Reducto-filtered frames, fleet-wide
    # fleet-wide per-frame latency distribution (simulated transport):
    # every group's frames merged into one p50/p99-able population
    transport: Optional[TransportStats] = None


def run_fleet_online(fleet: FleetScene,
                     offlines: Sequence[OfflineResult],
                     cfg: Optional[OnlineConfig] = None,
                     t0: Optional[int] = None, t1: Optional[int] = None,
                     frame_keep: Optional[Dict[int, Dict]] = None
                     ) -> FleetOnlineMetrics:
    """``frame_keep`` maps gid -> {cam_id -> (n_frames,) bool keep mask}
    (groups may be omitted = unfiltered).  ``cfg.frame_keep`` is the
    single-scene field and stays per-camera; pass the fleet-keyed dict
    here instead."""
    cfg = cfg or OnlineConfig()
    if cfg.frame_keep is not None:
        raise ValueError("use the frame_keep argument (keyed by gid) for "
                         "fleet runs; OnlineConfig.frame_keep is "
                         "single-scene")
    frame_keep = frame_keep or {}
    wall0 = time.time()
    t0 = t0 if t0 is not None else 600
    t1 = t1 if t1 is not None else min(len(g.scene.detections)
                                       for g in fleet.groups)
    n_frames = t1 - t0
    fps = fleet.groups[0].scene.cfg.fps

    cameras = fleet.all_cameras()
    grids = [offlines[g.gid].cam_grids[c.cam_id]
             for g in fleet.groups for c in g.scene.cameras]

    # ---- flatten every group's detections into one flat batch ------------
    det_t_parts, det_cam_parts, det_obj_parts, bbox_parts = [], [], [], []
    group_obj_slice = []                 # [o_start, o_end) per group
    obj_base = 0
    cam_base = 0
    for g in fleet.groups:
        rows = [(ti - t0, d) for ti in range(t0, t1)
                for d in g.scene.detections[ti]]
        ng = len(rows)
        gt = np.fromiter((t for t, _ in rows), np.int64, ng)
        gc = np.fromiter((d.cam for _, d in rows), np.int64, ng) + cam_base
        _, ginv = np.unique(
            np.fromiter((d.obj for _, d in rows), np.int64, ng),
            return_inverse=True)
        n_obj = int(ginv.max()) + 1 if ng else 0
        det_t_parts.append(gt)
        det_cam_parts.append(gc)
        det_obj_parts.append(ginv.astype(np.int64) + obj_base)
        bbox_parts.extend(d.bbox for _, d in rows)
        group_obj_slice.append((obj_base, obj_base + n_obj))
        obj_base += n_obj
        cam_base += g.num_cameras

    nd = sum(p.shape[0] for p in det_t_parts)
    C, O = len(cameras), obj_base
    missed_per_group = [np.zeros(n_frames, np.int64) for _ in fleet.groups]
    totals = [0 for _ in fleet.groups]
    if nd:
        det_t = np.concatenate(det_t_parts)
        det_cam = np.concatenate(det_cam_parts)
        det_obj = np.concatenate(det_obj_parts)
        l, tt, rr, bb, area = bbox_arrays(bbox_parts)

        # ONE coverage evaluation for every camera in every group
        flags = coverage_flags_batched(cameras, grids, det_cam, l, tt, rr,
                                       bb, area, cfg.coverage_thresh)

        present = np.zeros((n_frames, O), bool)
        present[det_t, det_obj] = True
        cur = np.zeros((n_frames, C, O), bool)
        cur[det_t[flags], det_cam[flags], det_obj[flags]] = True
        if not frame_keep:
            detected = cur.any(axis=1)
        else:
            # Reducto forward-fill (same semantics as run_online): a
            # filtered frame reuses the detector output of the camera's
            # most recent *streamed* frame, per flat fleet camera
            exists = np.zeros((n_frames, C, O), bool)
            exists[det_t, det_cam, det_obj] = True
            used = np.empty_like(cur)
            ci = 0
            for g in fleet.groups:
                gkeep = frame_keep.get(g.gid)
                for c in g.scene.cameras:
                    if gkeep is None or c.cam_id not in gkeep:
                        used[:, ci, :] = cur[:, ci, :]
                        ci += 1
                        continue
                    km = np.zeros(n_frames, bool)
                    src = np.asarray(gkeep[c.cam_id], bool)[:n_frames]
                    km[:src.shape[0]] = src
                    kt = np.nonzero(km)[0]
                    if kt.size == 0:              # camera never streams
                        used[:, ci, :] = False
                        ci += 1
                        continue
                    j = np.searchsorted(kt, np.arange(n_frames),
                                        side="left") - 1
                    last = cur[kt[np.maximum(j, 0)], ci, :]
                    last[j < 0] = False           # nothing streamed yet
                    used[:, ci, :] = np.where(km[:, None], cur[:, ci, :],
                                              last)
                    ci += 1
            detected = (exists & used).any(axis=1)
        missed_grid = present & ~detected
        for gi, (o0, o1) in enumerate(group_obj_slice):
            missed_per_group[gi] = missed_grid[:, o0:o1].sum(axis=1) \
                .astype(np.int64)
            totals[gi] = int(present[:, o0:o1].sum())

    # ---- per-group system metrics (the exact run_online block, shared) ----
    per_group: List[OnlineMetrics] = []
    frames_reduced = 0
    for g, off in zip(fleet.groups, offlines):
        gkeep = frame_keep.get(g.gid)
        if gkeep is not None:
            # partial per-camera dicts are legal (missing camera =
            # unfiltered, matching the accuracy pass above); the byte/
            # transport model wants a complete dict
            gkeep = {c.cam_id: gkeep.get(c.cam_id,
                                         np.ones(n_frames, bool))
                     for c in g.scene.cameras}
        (network_mbps, server_hz, camera_fps, latency, parts, _, _,
         transport) = online_system_metrics(g.scene.cameras, off, cfg,
                                            fps, n_frames, gkeep)
        missed = int(missed_per_group[g.gid].sum())
        total = totals[g.gid]
        reduced = 0
        if gkeep is not None:
            reduced = int(sum((~np.asarray(gkeep[c.cam_id], bool)).sum()
                              for c in g.scene.cameras
                              if c.cam_id in gkeep))
        frames_reduced += reduced
        per_group.append(OnlineMetrics(
            1.0 - missed / max(total, 1), missed, total,
            missed_per_group[g.gid], network_mbps, server_hz, camera_fps,
            latency, parts, reduced, transport))

    accs = [m.accuracy for m in per_group]
    transports = [m.transport for m in per_group if m.transport]
    return FleetOnlineMetrics(
        per_group=per_group,
        accuracy_mean=float(np.mean(accs)),
        accuracy_min=float(np.min(accs)),
        network_mbps_total=float(sum(m.network_mbps for m in per_group)),
        # one server multiplexing the groups round-robin: rates compose
        # harmonically (time per fleet sweep = sum of per-group times)
        fleet_server_hz=1.0 / sum(1.0 / m.server_hz for m in per_group),
        camera_fps_min=float(min(m.camera_fps for m in per_group)),
        latency_max_s=float(max(m.latency_s for m in per_group)),
        wall_s=time.time() - wall0,
        frames_reduced=frames_reduced,
        transport=merge_transport(transports) if transports else None)


# ---------------------------------------------------------------------------
# kernel-level fleet step
# ---------------------------------------------------------------------------

def _n_tiles(grids: Dict[int, List[np.ndarray]]) -> int:
    return sum(int(np.count_nonzero(np.asarray(g, bool)))
               for gs in grids.values() for g in gs)


def fleet_inference_step(det, frames: Dict[int, List],
                         grids: Dict[int, List[np.ndarray]]):
    """One fleet step: ALL groups' cameras as ONE super-launch chain.

    frames[gid] / grids[gid]: per-camera (H, W, 3) frames and RoI tile
    grids of group ``gid``.  Returns ({gid: per-camera head maps},
    dispatch Counter).  Asserts the super-launch structure: one entry, one
    layer stack (none for a 1-layer net), one scatter; an all-empty fleet
    launches nothing."""
    with kops.count_kernels() as c, obs_trace.span("fleet_step"):
        outs = det.superlaunch_forward(frames, grids)
    total: collections.Counter = collections.Counter(c)
    expected = {} if _n_tiles(grids) == 0 else {
        "roi_conv_entry": 1,
        "roi_conv_stack": 1 if det.num_conv_layers > 1 else 0,
        "sbnet_scatter_fleet": 1}
    observed = {k: total[k] for k in expected}
    assert observed == expected and not set(total) - set(expected), \
        f"super-launch dispatch structure broken: {dict(total)}"
    assert sum(total.values()) <= 3, \
        f"fleet step must stay within 3 dispatches: {dict(total)}"
    return outs, total


def fleet_reuse_step(det, frames: Dict[int, List],
                     grids: Dict[int, List[np.ndarray]], cache,
                     threshold=0.0, qstep: float = 8.0):
    """One delta-gated fleet step, compute proportional to CHANGED tiles,
    through ``RoIDetector.superlaunch_forward_reuse``.  Returns ({gid:
    head maps}, dispatch Counter, ReuseStats); the head maps are views of
    ``cache.canvas``, valid until the next step on ``cache``.  Asserts the
    delta-gated structure on every step:

    * a cold step is the plain super-launch: entry, stack, full scatter;
    * a changed step is one gate, entry, stack and one changed-only
      scatter;
    * an all-static step is the gate ALONE;
    * an all-empty fleet launches nothing."""
    t0 = time.perf_counter()
    with kops.count_kernels() as c, \
            obs_trace.span("fleet_reuse_step", step=cache.steps) as sp:
        outs, stats = det.superlaunch_forward_reuse(frames, grids, cache,
                                                    threshold, qstep)
        sp.set(computed=stats.computed, cold=stats.cold)
    obs_metrics.observe_fleet_step(stats, time.perf_counter() - t0,
                                   path="fleet_reuse")
    total: collections.Counter = collections.Counter(c)
    stack = 1 if det.num_conv_layers > 1 else 0
    if _n_tiles(grids) == 0:
        expected = {}
    elif stats.cold:
        expected = {"roi_conv_entry": 1, "roi_conv_stack": stack,
                    "sbnet_scatter_fleet": 1}
    elif stats.computed == 0:
        expected = {"tile_delta_gate": 1}
    else:
        expected = {"tile_delta_gate": 1, "roi_conv_entry": 1,
                    "roi_conv_stack": stack, "sbnet_scatter_changed": 1}
    expected = {k: v for k, v in expected.items() if v}
    observed = {k: total[k] for k in expected}
    assert observed == expected and not set(total) - set(expected), \
        f"delta-gated dispatch structure broken: {dict(total)}"
    conv = sum(v for k, v in total.items() if k != "tile_delta_gate")
    assert conv <= 3, \
        f"reuse step must keep the <=3-dispatch conv ceiling: {dict(total)}"
    return outs, total, stats


def sharded_fleet_step(runtime, frames: Dict[int, List], cache,
                       threshold=0.0):
    """One delta-gated step of a ``fleet.sharded.ShardedSuperlaunch``,
    with ``fleet_reuse_step``'s every-step dispatch assertion: each kernel
    is counted once per step whatever the shard count, so the per-shard
    ceiling and the fleet-wide count coincide -- the gate and the
    <=3-dispatch conv chain on changed steps, the gate alone on
    all-static steps (the persistent canvas is served as it stands),
    nothing on an all-empty fleet.  The sharded path gates on cold steps
    too: cold and warm shards share one set of launches.  Returns ({gid:
    head maps}, dispatch Counter, ShardedReuseStats)."""
    t0 = time.perf_counter()
    with kops.count_kernels() as c, \
            obs_trace.span("sharded_fleet_step", step=cache.steps) as sp:
        outs, stats = runtime.step_reuse(frames, cache, threshold)
        sp.set(computed=stats.computed, cold_shards=stats.cold_shards)
    obs_metrics.observe_fleet_step(stats, time.perf_counter() - t0,
                                   path="sharded")
    total: collections.Counter = collections.Counter(c)
    if stats.total_tiles == 0:
        expected = {}
    elif stats.k_max == 0:
        expected = {"tile_delta_gate": 1}
    else:
        expected = {"tile_delta_gate": 1, "roi_conv_entry": 1,
                    "roi_conv_stack":
                        1 if runtime.det.num_conv_layers > 1 else 0,
                    "sbnet_scatter_changed": 1}
    expected = {k: v for k, v in expected.items() if v}
    observed = {k: total[k] for k in expected}
    assert observed == expected and not set(total) - set(expected), \
        f"sharded dispatch structure broken: {dict(total)}"
    conv = sum(v for k, v in total.items() if k != "tile_delta_gate")
    assert conv <= 3, \
        f"sharded step must keep the <=3-dispatch conv ceiling: {dict(total)}"
    return outs, total, stats
