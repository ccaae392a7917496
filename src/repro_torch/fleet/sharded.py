"""City-scale sharded serving: the fleet super-launch over a fleet mesh.

``cross_group_leakage == 0`` makes camera groups an embarrassingly
parallel axis: no tile's halo, neighbour table or scatter target crosses
a group, so groups shard over the 1-D fleet mesh
(``launch.mesh.make_fleet_mesh``) with no collectives on the hot path.
``ShardedSuperlaunch`` is the delta-gated fleet step
(``RoIDetector.superlaunch_forward_reuse``) over stacked per-shard state:

* **Tables and a shard plan.**  ``ops.superlaunch_tables`` builds each
  shard's flat tables from its groups; ``ops.shard_plan`` assigns groups
  to shards by active-tile count.  Shards are padded to one
  power-of-two row count with sacrificial rows that point at camera slot
  ``F_max`` of the shard (``idx = (F_max, 0, 0)``, ``nbr = -1``), a zero
  plane appended to every shard's frames, so ragged and empty shards run
  the same launches and padding work never lands on a real output.
* **One launch per kernel per step.**  Shards on one device are stacked
  in one block (``distributed.shardings``): shard ``j`` of a block owns
  camera planes ``[j (F_max + 1), (j + 1) (F_max + 1))`` and rows ``[j
  k, (j + 1) k)`` of a k-row table, its cameras and non-``-1``
  neighbours offset to match, so the gate, the entry, the stack and the
  changed-only scatter each launch once per device over every shard's
  rows and are counted once per step (``ops.record_dispatch``), as one
  SPMD program is.  An all-static step is the gate alone.  Cold shards
  are gated too, so a cold sharded step counts the gate beside the conv
  chain, where the single-device cold step skips it.
* **Bits.**  Every per-tile quantity (gate stats, entry and stack,
  ``_head_rows``, the scatter) reads only its own tile's inputs, so each
  group's maps equal the single-device ``superlaunch_forward_reuse``
  bitwise on the same trace.
* **Per-shard cache.**  The packed final-layer activations, the
  persistent head-map canvas and the gate's reference canvas live in a
  ``ShardedActivationCache``; a drift re-solve cold-marks only the owning
  shard (``drift.wire_shard_invalidation``), whose canvas plane the next
  step wipes before its rows are scattered again, while the other shards
  stay warm.

``AsyncShardedPipeline`` overlaps the host and the device: step t's gate
is enqueued before step t-1's conv, and its stats come back through a
pinned buffer and an event recorded right after the gate, so pulling
them waits for the gate alone and the host plans step t while the card
runs step t-1's conv.  ``collect`` is the only place that waits for a
conv.

Frames may be numpy arrays or tensors; the maps come back as tensors on
the shards' devices, views of the cache's canvas valid until the next
step (the pipeline copies the maps of a step not yet collected before a
later step writes the canvas).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.shardings import fleet_state_sharding
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import roi_conv as _roi_conv
from repro_torch.kernels import sbnet as _sbnet
from repro_torch.kernels import tile_delta as _tile_delta
from repro_torch.kernels.tile_delta import COEF_BITS, RUN_BITS, STATS_WIDTH
from repro_torch.launch.mesh import FLEET_AXIS
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.detector import (ShardedActivationCache,
                                          _head_rows, gate_changed_rows,
                                          ref_advance_rows, tile_class_rows)

QSTEP = 8.0                        # the gate's quantizer step


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1): the row bucket of a shard."""
    p = 1
    while p < n:
        p *= 2
    return p


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the device: staged in
    pinned memory from torch's host allocator, which keeps each buffer
    until its copy has run, then copied asynchronously on ``dev``'s
    current stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    with torch.cuda.device(dev):
        return t.pin_memory().to(dev, non_blocking=True)


def _record(dev: torch.device):
    """An event recorded on ``dev``'s current stream (None off CUDA)."""
    if dev.type != "cuda":
        return None
    with torch.cuda.device(dev):
        ev = torch.cuda.Event()
        ev.record()
    return ev


@dataclass
class ShardedReuseStats:
    """Per-step accounting of one sharded fleet step (fleet-wide sums;
    ``launched`` counts every convolved row on every shard, padding
    included: all shards convolve ``k_max`` rows whenever any shard needs
    one)."""
    total_tiles: int
    raw_changed: int
    changed_out: int
    computed: int                 # real compact-set tiles, summed
    launched: int                 # S * k_max when the conv launched
    k_max: int                    # per-shard convolved rows this step
    cold_shards: int              # shards that ran a forced recompute
    # bytes scattered into the persistent head canvas (real changed-out
    # tiles only; 0 on an all-static step)
    canvas_bytes: int = 0
    per_shard_computed: List[int] = field(default_factory=list)
    # per-shard gate stats rows over real rows (None for cold shards,
    # whose references were stale), flat-camera order within the shard
    gate_stats: Optional[List[Optional[np.ndarray]]] = None

    @property
    def cold(self) -> bool:
        return self.cold_shards > 0


@dataclass
class _HostPlan:
    """One step's host planning product (the work the pipeline overlaps
    with the previous step's device compute)."""
    k_max: int                    # 0 = all-static: a gate-only step
    cidx: Optional[np.ndarray]    # (S, k_max, 3) compact tables
    cnbr: Optional[np.ndarray]    # (S, k_max, 8)
    upd: Optional[np.ndarray]     # (S, k_max) cache row targets (n_max=drop)
    sidx: Optional[np.ndarray]    # (S, k_max, 3) canvas scatter targets:
    #                               changed rows their (cam, ty, tx),
    #                               margin and padding rows the
    #                               sacrificial plane (F_max, 0, 0)
    adv: np.ndarray               # (S, n_max) reference-advance mask
    cold_mask: np.ndarray         # (S,) shards whose canvas plane is
    #                               wiped before this step's scatter
    stats: ShardedReuseStats


class _StatsPull:
    """A gate's stats rows on their way to the host: one asynchronous
    copy per device into a pinned (n_total, STATS_WIDTH) buffer, each
    followed by an event, so ``wait`` waits for the gates alone."""

    def __init__(self, n_rows: int, pinned: bool):
        self.rows = torch.empty((n_rows, STATS_WIDTH), dtype=torch.int32,
                                pin_memory=pinned)
        self.events = []

    def add(self, start: int, out: torch.Tensor) -> None:
        if out.device.type == "cuda":
            with torch.cuda.device(out.device):
                self.rows[start:start + out.shape[0]].copy_(
                    out, non_blocking=True)
            self.events.append(_record(out.device))
        else:
            self.rows[start:start + out.shape[0]] = out

    def wait(self) -> np.ndarray:
        for ev in self.events:
            ev.synchronize()
        return self.rows.numpy()


class ShardedSuperlaunch:
    """The sharded fleet runtime for a fixed group -> shard plan.

    ``grids`` is keyed by gid like ``RoIDetector.superlaunch_forward_
    reuse``'s; the plan (``ops.shard_plan`` unless given) stays until a
    mask re-solve calls ``rebuild_group``.  ``mesh`` is a
    ``launch.mesh.FleetMesh``: shards on one device share its launches."""

    def __init__(self, det, grids: Dict[int, List[np.ndarray]], mesh,
                 plan: Optional[kops.ShardPlan] = None):
        self.det = det
        self.mesh = mesh
        self.gids = list(grids)
        self.grids = {g: list(gs) for g, gs in grids.items()}
        n_shards = mesh.shape[FLEET_AXIS]
        self.plan = plan or kops.shard_plan(
            [self.grids[g] for g in self.gids], n_shards)
        if self.plan.n_shards != n_shards:
            raise ValueError(
                f"plan has {self.plan.n_shards} shards, mesh {n_shards}")
        self.sharding = fleet_state_sharding(mesh)
        # the detector's parameters on each block's device
        self._params = [([w.to(dev) for w in det.weights],
                         det.head.to(dev))
                        for dev, _ in self.sharding.blocks]
        t = det.cfg.tile
        # canvas: global maxima, so head shapes agree across shards
        self.canvas_h = max(g.shape[0] * t for gs in self.grids.values()
                            for g in gs)
        self.canvas_w = max(g.shape[1] * t for gs in self.grids.values()
                            for g in gs)
        self._build_tables()

    # -- table construction ------------------------------------------------
    def _build_tables(self) -> None:
        S = self.plan.n_shards
        self._shard_gids = [[self.gids[i] for i in self.plan.shard_groups(s)]
                            for s in range(S)]
        self._idx_np, self._nbr_np, self._n_s, self._F_s = [], [], [], []
        self._group_slot: Dict[int, Tuple[int, int]] = {}
        for s in range(S):
            gs = [self.grids[g] for g in self._shard_gids[s]]
            idx, nbr, _, cam_starts = kops.superlaunch_tables(gs)
            self._idx_np.append(np.asarray(idx))
            self._nbr_np.append(np.asarray(nbr))
            self._n_s.append(int(idx.shape[0]))
            self._F_s.append(int(sum(len(g) for g in gs)))
            for j, gid in enumerate(self._shard_gids[s]):
                self._group_slot[gid] = (s, int(cam_starts[j]))
        self.F_max = max(self._F_s + [1])
        self.n_max = _pow2(max(self._n_s + [1]))
        self.n_total = int(sum(self._n_s))
        self._cls_np = [tile_class_rows(nbr) for nbr in self._nbr_np]
        # the gate's rows: every shard's real rows, block by block, their
        # cameras offset to the shard's planes; a shard's stats are rows
        # [_row0[s], _row0[s] + n_s) of the pulled buffer
        self._row0 = [0] * S
        self._gate_idx = []
        start = 0
        for b, (dev, shards) in enumerate(self.sharding.blocks):
            rows = []
            for j, s in enumerate(shards):
                self._row0[s] = start
                start += self._n_s[s]
                rows.append(self._idx_np[s] + np.array(
                    [j * (self.F_max + 1), 0, 0], np.int32))
            rows = np.concatenate(rows).astype(np.int32)
            self._gate_idx.append(torch.as_tensor(rows, device=dev))

    def make_cache(self) -> ShardedActivationCache:
        return ShardedActivationCache(self.plan, gids=self.gids)

    def groups_on_shard(self, shard: int) -> List[int]:
        """Group ids placed on ``shard``: the blast radius of losing it.
        The fault layer cold-marks each (``cache.invalidate_group``); the
        next step recomputes them, which is the restore."""
        return list(self._shard_gids[shard])

    def rebuild_group(self, gid: int, new_grids: Sequence[np.ndarray],
                      cache: Optional[ShardedActivationCache] = None
                      ) -> None:
        """Adopt a re-solved mask for one group: rebuild the tables (the
        owning shard is already cold through ``invalidate_group``); the
        other shards' cache rows and references survive.  When the new
        mask overflows the shared row bucket, ``n_max`` grows and the
        packed activations are re-padded with the warm rows kept; when the
        camera count per shard changes, everything is dropped.  The owning
        shard's canvas plane is zeroed, so tiles the re-solve removed keep
        no stale head bytes even when the shard is rebuilt empty and never
        reaches the conv."""
        t = self.det.cfg.tile
        for g in new_grids:
            if g.shape[0] * t > self.canvas_h or \
                    g.shape[1] * t > self.canvas_w:
                raise ValueError("re-solved grid exceeds the built canvas")
        self.grids[gid] = list(new_grids)
        old_n_max, old_f_max = self.n_max, self.F_max
        self._build_tables()
        if cache is None or cache.packed is None:
            return
        if self.F_max != old_f_max:
            cache.packed = None
            cache.ref_canvas = None
            cache.canvas = None
            cache.epoch_np = None
            cache.valid[:] = False
            return
        if self.n_max != old_n_max:
            pad = self.n_max - old_n_max
            if pad > 0:
                cache.packed = [torch.nn.functional.pad(
                    p, (0, 0, 0, 0, 0, 0, 0, pad)) for p in cache.packed]
                if cache.epoch_np is not None:
                    cache.epoch_np = np.pad(cache.epoch_np,
                                            ((0, 0), (0, pad)))
            else:
                cache.packed = [p[:, :self.n_max].contiguous()
                                for p in cache.packed]
                if cache.epoch_np is not None:
                    cache.epoch_np = cache.epoch_np[:, :self.n_max]
        if cache.canvas is not None:
            b, j = self.sharding.locate(cache.owner_shard(gid))
            cache.canvas[b][j].zero_()

    # -- step building blocks ---------------------------------------------
    def _ingest(self, frames: Dict[int, List]):
        """Each block's frames on its device: (x (S_b (F_max + 1), H, W,
        3), xp the same zero-padded by one pixel), plane F_max of each
        shard the sacrificial zero camera.  Frames are stacked on the
        device, host arrays through pinned memory."""
        out = []
        for dev, shards in self.sharding.blocks:
            out.append(torch.zeros((len(shards) * (self.F_max + 1),
                                    self.canvas_h, self.canvas_w, 3),
                                   dtype=torch.float32, device=dev))
        for gid in self.gids:
            s, c0 = self._group_slot[gid]
            b, j = self.sharding.locate(s)
            x = out[b]
            for i, f in enumerate(frames[gid]):
                if f.shape[0] > self.canvas_h or f.shape[1] > self.canvas_w:
                    raise ValueError(
                        f"frame {tuple(f.shape[:2])} exceeds the grid-"
                        f"derived canvas ({self.canvas_h}, {self.canvas_w})")
                if isinstance(f, torch.Tensor):
                    f = f.to(x.device, torch.float32)
                else:
                    f = _upload(np.asarray(f, np.float32), x.device)
                x[j * (self.F_max + 1) + c0 + i,
                  :f.shape[0], :f.shape[1]] = f
        return [(x, torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)))
                for x in out]

    def _planes(self, a: torch.Tensor) -> torch.Tensor:
        """(S_b, F_max + 1, ...) -> (S_b (F_max + 1), ...) view."""
        return a.view((-1,) + tuple(a.shape[2:]))

    def _gate(self, xs, cache: ShardedActivationCache) -> _StatsPull:
        """One gate launch per block over its shards' real rows against
        the reference canvas; the stats start for the host at once."""
        t = self.det.cfg.tile
        pull = _StatsPull(self.n_total, any(
            dev.type == "cuda" for dev, _ in self.sharding.blocks))
        for b, (dev, shards) in enumerate(self.sharding.blocks):
            idx = self._gate_idx[b]
            if idx.shape[0] == 0:
                continue
            out = _tile_delta.tile_delta_gate_canvas(
                xs[b][1], self._planes(cache.ref_canvas[b]), idx, t, t,
                QSTEP, COEF_BITS, RUN_BITS)
            pull.add(self._row0[shards[0]], out)
        return pull

    def _init_cache_arrays(self, cache: ShardedActivationCache) -> None:
        if cache.packed is not None:
            return
        t = self.det.cfg.tile
        c_last = self.det.cfg.channels[-1]
        a = self.det.head.shape[-1]
        f32 = torch.float32
        blocks = self.sharding.blocks
        cache.packed = [torch.zeros((len(sh), self.n_max, t, t, c_last),
                                    dtype=f32, device=dev)
                        for dev, sh in blocks]
        cache.ref_canvas = [torch.zeros(
            (len(sh), self.F_max + 1, self.canvas_h + 2, self.canvas_w + 2,
             3), dtype=f32, device=dev) for dev, sh in blocks]
        cache.canvas = [torch.zeros(
            (len(sh), self.F_max + 1, self.canvas_h, self.canvas_w, a),
            dtype=f32, device=dev) for dev, sh in blocks]
        cache.epoch_np = np.zeros((self.plan.n_shards, self.n_max), np.int64)
        cache.valid[:] = False

    def _host_plan(self, stats_np: np.ndarray,
                   cache: ShardedActivationCache,
                   threshold=0.0) -> _HostPlan:
        """Gate thresholding, ``reuse_sets`` dilation and table compaction
        for every shard, host numpy on the static tables (what the
        pipeline overlaps with device compute).  ``threshold``: a scalar,
        or {gid: per-camera (F_g,) or per-camera-per-tile-class (F_g,
        N_TILE_CLASSES) array} (``gate_threshold_schedule``'s)."""
        S = self.plan.n_shards
        n_layers = self.det.num_conv_layers
        per_changed, per_compute = [], []
        raw_total = changed_total = computed_total = 0
        cold_shards = 0
        gate_stats: List[Optional[np.ndarray]] = []
        thr_by_shard = self._shard_thresholds(threshold)
        for s in range(S):
            n_s = self._n_s[s]
            if n_s == 0:
                per_changed.append(np.zeros(0, bool))
                per_compute.append(np.zeros(0, bool))
                gate_stats.append(None)
                continue
            rows = stats_np[self._row0[s]:self._row0[s] + n_s]
            if cache.valid[s]:
                raw = np.asarray(gate_changed_rows(
                    rows, thr_by_shard[s], self._idx_np[s][:, 0],
                    self._cls_np[s]), bool)
                gate_stats.append(rows)
            else:
                # a cold shard's references are stale: recompute every row
                raw = np.ones(n_s, bool)
                gate_stats.append(None)
                cold_shards += 1
            changed, compute = kops.reuse_sets(raw, self._nbr_np[s],
                                               n_layers)
            per_changed.append(changed)
            per_compute.append(compute)
            raw_total += int(raw.sum())
            changed_total += int(changed.sum())
            computed_total += int(compute.sum())
        k_max = _pow2(max([int(c.sum()) for c in per_compute] + [0])) \
            if computed_total else 0
        adv = np.zeros((S, self.n_max), bool)
        for s in range(S):
            n_s = self._n_s[s]
            if n_s == 0:
                continue
            if not cache.valid[s]:
                adv[s, :n_s] = True
                continue
            a = ref_advance_rows(thr_by_shard[s], self._idx_np[s][:, 0],
                                 per_changed[s], self._cls_np[s])
            adv[s, :n_s] = True if a is None else a
        cold_mask = ~np.asarray(cache.valid, bool)
        t = self.det.cfg.tile
        tile_bytes = t * t * int(self.det.head.shape[-1]) * 4
        stats = ShardedReuseStats(
            total_tiles=self.n_total, raw_changed=raw_total,
            changed_out=changed_total, computed=computed_total,
            launched=S * k_max if k_max else 0, k_max=k_max,
            cold_shards=cold_shards,
            canvas_bytes=changed_total * tile_bytes,
            per_shard_computed=[int(c.sum()) for c in per_compute],
            gate_stats=gate_stats)
        if k_max == 0:
            return _HostPlan(0, None, None, None, None, adv, cold_mask,
                             stats)
        cidx = np.zeros((S, k_max, 3), np.int32)
        cidx[:, :, 0] = self.F_max                 # sacrificial padding
        cnbr = np.full((S, k_max, 8), -1, np.int32)
        upd = np.full((S, k_max), self.n_max, np.int32)   # n_max = drop
        sidx = np.zeros((S, k_max, 3), np.int32)
        sidx[:, :, 0] = self.F_max                 # sacrificial plane
        for s in range(S):
            compute = per_compute[s]
            k = int(compute.sum())
            if k == 0:
                continue
            ci, cn = kops.compact_tables(self._idx_np[s], self._nbr_np[s],
                                         compute)
            cidx[s, :k] = ci
            cnbr[s, :k] = cn
            slots = np.nonzero(compute)[0]
            ch = per_changed[s][slots]
            upd[s, :k] = np.where(ch, slots, self.n_max).astype(np.int32)
            # only changed-output rows write their tile; margin rows keep
            # the canvas's (still exact) bytes by writing the sacrificial
            # plane instead
            sidx[s, :k] = np.where(ch[:, None], ci,
                                   np.array([[self.F_max, 0, 0]], np.int32))
        return _HostPlan(k_max, cidx, cnbr, upd, sidx, adv, cold_mask,
                         stats)

    def _shard_thresholds(self, threshold) -> List:
        """The scalar or {gid: per-camera or per-camera-per-tile-class}
        threshold as one scalar, (F_s,) or (F_s, n_classes) value per
        shard, indexed by the shard's flat camera."""
        if not isinstance(threshold, dict):
            return [threshold] * self.plan.n_shards
        vals = {g: np.asarray(v, np.float64) for g, v in threshold.items()}
        n_cls = max([v.shape[1] for v in vals.values() if v.ndim == 2],
                    default=0)
        out = []
        for s in range(self.plan.n_shards):
            shape = (max(self._F_s[s], 1),) + ((n_cls,) if n_cls else ())
            thr = np.zeros(shape, np.float64)
            for gid in self._shard_gids[s]:
                if gid in vals:
                    _, c0 = self._group_slot[gid]
                    v = vals[gid]
                    if n_cls and v.ndim == 1:
                        v = np.repeat(v[:, None], n_cls, axis=1)
                    thr[c0:c0 + v.shape[0]] = v
            out.append(thr)
        return out

    def _put_tables(self, plan: _HostPlan):
        """Stage one step's tables on each block's device, in one copy: the
        compact rows (cameras offset to their shard's planes, non--1
        neighbours to their shard's rows), the canvas targets, and the
        packed rows that graduate to the cache with their targets.  Each
        step stages through a fresh pinned buffer (``_upload``: held
        until its copy has run) into fresh device tables (handed out again
        only in stream order, after the conv that reads them), so no
        staging buffer is rewritten while its copy or its conv is in
        flight."""
        k, F1 = plan.k_max, self.F_max + 1
        slot = []
        for dev, shards in self.sharding.blocks:
            sh = list(shards)
            j = np.arange(len(sh), dtype=np.int32)
            cam = (j * F1)[:, None, None]
            cidx = plan.cidx[sh].copy()
            cidx[:, :, :1] += cam
            sidx = plan.sidx[sh].copy()
            sidx[:, :, :1] += cam
            cnbr = plan.cnbr[sh].copy()
            cnbr += np.where(cnbr >= 0, (j * k)[:, None, None], 0) \
                .astype(np.int32)
            upd = plan.upd[sh]
            keep = upd < self.n_max
            src = np.nonzero(keep.reshape(-1))[0]
            dst = (upd + (j * self.n_max)[:, None])[keep]
            flat = np.concatenate([cidx.reshape(-1), cnbr.reshape(-1),
                                   sidx.reshape(-1),
                                   src.astype(np.int32),
                                   dst.astype(np.int32)])
            d = _upload(flat.astype(np.int32), dev)
            n, m = len(sh) * k, src.shape[0]
            cuts = np.cumsum([0, 3 * n, 8 * n, 3 * n, m, m])
            cidx_d, cnbr_d, sidx_d, src_d, dst_d = (
                d[cuts[i]:cuts[i + 1]] for i in range(5))
            slot.append((cidx_d.view(n, 3), cnbr_d.view(n, 8),
                         sidx_d.view(n, 3), src_d.long(), dst_d.long()))
        return slot

    def _run_conv(self, xs, plan: _HostPlan, slot, packed, canvas,
                  wipe: bool) -> None:
        """The conv chain on each block: one entry, one stack and one
        changed-only scatter launch over every shard's compact rows; the
        rows that graduate update ``packed``, the head rows land in
        ``canvas`` (cold shards' planes wiped first when ``wipe``)."""
        t = self.det.cfg.tile
        for b, (dev, shards) in enumerate(self.sharding.blocks):
            ws, head = self._params[b]
            cidx, cnbr, sidx, src, dst = slot[b]
            p = _roi_conv.roi_conv_entry(xs[b][0], ws[0], cidx, t, t)
            if len(ws) > 1:
                p = _roi_conv.roi_conv_stack(p, ws[1:], cnbr)
            if src.shape[0]:
                pk = packed[b]
                pk.view((-1,) + tuple(pk.shape[2:])).index_copy_(
                    0, dst, p.index_select(0, src))
            if wipe:
                for j, s in enumerate(shards):
                    if plan.cold_mask[s]:
                        canvas[b][j].zero_()
            _sbnet.sbnet_scatter_fleet(_head_rows(p, head), sidx,
                                       self._planes(canvas[b]))

    def _advance_refs(self, cache: ShardedActivationCache, xs,
                      plan: _HostPlan) -> None:
        """Advance the reference canvas and the epoch table per the
        plan's (S, n_max) advance mask: the advanced rows' (t+2, t+2)
        window regions take the current padded frames.  A block whose
        every real row advances takes the padded frames whole (a fresh
        tensor every step), which every row's window reads alike."""
        if not plan.adv.any():
            return
        t = self.det.cfg.tile
        F1 = self.F_max + 1
        for b, (dev, shards) in enumerate(self.sharding.blocks):
            sh = list(shards)
            adv = plan.adv[sh]
            if not adv.any():
                continue
            xp = xs[b][1]
            if all(adv[j, :self._n_s[s]].all() for j, s in enumerate(sh)):
                cache.ref_canvas[b] = xp.view(
                    (len(sh), F1) + tuple(xp.shape[1:]))
                continue
            rows = np.concatenate([
                self._idx_np[s][adv[j, :self._n_s[s]]]
                + np.array([j * F1, 0, 0], np.int32)
                for j, s in enumerate(sh)])
            where = kref.tile_index(_upload(rows.astype(np.int32), dev),
                                    t, t, t + 2, t + 2)
            self._planes(cache.ref_canvas[b])[where] = xp[where]
        cache.epoch_np[plan.adv] = cache.steps

    # -- synchronous steps -------------------------------------------------
    def step_reuse(self, frames: Dict[int, List],
                   cache: ShardedActivationCache, threshold=0.0):
        """One sharded delta-gated fleet step.

        Launches (each counted once per step, one launch per device): the
        gate plus the conv chain (entry, stack, changed-only scatter) on a
        changed step; the gate alone on an all-static step, whose maps
        are the persistent canvas as it stands; nothing on an all-empty
        fleet.  Cold shards are gated too (the single-device cold step
        skips the gate); the maps are the same bits.  Returns ({gid:
        per-camera head maps}, ShardedReuseStats); the maps are views of
        the cache's canvas, valid until the next step on it."""
        if cache.plan is not self.plan:
            raise ValueError("cache was built for a different shard plan")
        cache.steps += 1
        cache.total_tiles += self.n_total
        if self.n_total == 0:
            return self._zero_heads(frames), ShardedReuseStats(
                0, 0, 0, 0, 0, 0, 0)
        self._init_cache_arrays(cache)
        xs = self._ingest(frames)
        kops.record_dispatch("tile_delta_gate")
        pull = self._gate(xs, cache)
        plan = self._host_plan(pull.wait(), cache, threshold)
        self._dispatch_conv(xs, plan, cache)
        self._advance_refs(cache, xs, plan)
        if plan.stats.cold_shards:
            cache.cold_steps += 1
        cache.valid[:] = True
        cache.launched_tiles += plan.stats.launched
        cache.canvas_bytes_last = plan.stats.canvas_bytes
        cache.canvas_bytes_total += plan.stats.canvas_bytes
        return self._split_heads(cache.canvas, frames), plan.stats

    def step_full(self, frames: Dict[int, List]):
        """The sharded super-launch without reuse (the cold path and A/B
        baseline): entry, stack and scatter once each, bitwise equal per
        group to ``superlaunch_forward``.  Returns {gid: head maps} on
        fresh canvases."""
        if self.n_total == 0:
            return self._zero_heads(frames)
        xs = self._ingest(frames)
        plan = self._full_plan()
        kops.record_dispatch("roi_conv_entry")
        if self.det.num_conv_layers > 1:
            kops.record_dispatch("roi_conv_stack")
        kops.record_dispatch("sbnet_scatter_fleet")
        slot = self._put_tables(plan)
        t, c_last = self.det.cfg.tile, self.det.cfg.channels[-1]
        a = self.det.head.shape[-1]
        packed = [torch.zeros((len(sh), self.n_max, t, t, c_last),
                              dtype=torch.float32, device=dev)
                  for dev, sh in self.sharding.blocks]
        canvas = [torch.zeros((len(sh), self.F_max + 1, self.canvas_h,
                               self.canvas_w, a), dtype=torch.float32,
                              device=dev)
                  for dev, sh in self.sharding.blocks]
        self._run_conv(xs, plan, slot, packed, canvas, wipe=False)
        return self._split_heads(canvas, frames)

    def _full_plan(self) -> _HostPlan:
        """An everything-changed plan: the compact tables are the full
        tables."""
        S = self.plan.n_shards
        k_max = _pow2(max(self._n_s + [1]))
        cidx = np.zeros((S, k_max, 3), np.int32)
        cidx[:, :, 0] = self.F_max
        cnbr = np.full((S, k_max, 8), -1, np.int32)
        upd = np.full((S, k_max), self.n_max, np.int32)
        sidx = np.zeros((S, k_max, 3), np.int32)
        sidx[:, :, 0] = self.F_max
        for s in range(S):
            n_s = self._n_s[s]
            cidx[s, :n_s] = self._idx_np[s]
            cnbr[s, :n_s] = self._nbr_np[s]
            upd[s, :n_s] = np.arange(n_s)
            sidx[s, :n_s] = self._idx_np[s]
        t = self.det.cfg.tile
        tile_bytes = t * t * int(self.det.head.shape[-1]) * 4
        stats = ShardedReuseStats(self.n_total, self.n_total, self.n_total,
                                  self.n_total, S * k_max, k_max, S,
                                  canvas_bytes=self.n_total * tile_bytes)
        return _HostPlan(k_max, cidx, cnbr, upd, sidx,
                         np.zeros((S, self.n_max), bool),
                         np.ones(S, bool), stats)

    def _dispatch_conv(self, xs, plan: _HostPlan,
                       cache: ShardedActivationCache) -> None:
        """Launch the conv chain for one planned step into the cache,
        each kernel counted once.  ``k_max == 0`` (all-static) launches
        nothing and writes no canvas byte."""
        if plan.k_max == 0:
            return
        kops.record_dispatch("roi_conv_entry")
        if self.det.num_conv_layers > 1:
            kops.record_dispatch("roi_conv_stack")
        kops.record_dispatch("sbnet_scatter_changed")
        slot = self._put_tables(plan)
        self._run_conv(xs, plan, slot, cache.packed, cache.canvas,
                       wipe=True)

    # -- output plumbing ---------------------------------------------------
    def _split_heads(self, canvas, frames: Dict[int, List]
                     ) -> Dict[int, List[torch.Tensor]]:
        out: Dict[int, List[torch.Tensor]] = {}
        for gid in self.gids:
            s, c0 = self._group_slot[gid]
            b, j = self.sharding.locate(s)
            out[gid] = [canvas[b][j, c0 + i, :f.shape[0], :f.shape[1]]
                        for i, f in enumerate(frames[gid])]
        return out

    def _zero_heads(self, frames: Dict[int, List]
                    ) -> Dict[int, List[torch.Tensor]]:
        a = self.det.head.shape[-1]
        out = {}
        for gid in self.gids:
            s, _ = self._group_slot[gid]
            dev = self.sharding.blocks[self.sharding.locate(s)[0]][0]
            out[gid] = [torch.zeros(tuple(f.shape[:2]) + (a,),
                                    dtype=torch.float32, device=dev)
                        for f in frames[gid]]
        return out


class AsyncShardedPipeline:
    """A depth-1 host/device pipeline over a ShardedSuperlaunch.

    ``submit(frames)`` enqueues step t's gate first, then step t-1's conv
    chain behind it, and only then waits for step t's gate stats (an
    event recorded after their asynchronous copy, not a stream
    synchronize), so the host plans step t while the card runs step
    t-1's conv.  ``collect()`` is the only place that waits for a conv
    (the consumer edge).  ``overlap_fraction`` is the share of host
    planning time spent with a device step in flight.

    The canvas is updated in place, so before a step's conv writes it the
    maps of every step still waiting for ``collect`` are copied."""

    def __init__(self, runtime: ShardedSuperlaunch,
                 cache: ShardedActivationCache, threshold=0.0):
        self.rt = runtime
        self.cache = cache
        self.threshold = threshold
        self._staged = None           # (step, xs, plan, frames, t_submit)
        self._ready: deque = deque()  # [step, maps, stats, t_submit,
        #                                device span, done event, copied]
        self._step = 0
        self.host_s = 0.0             # total host planning time
        self.overlapped_host_s = 0.0  # ... under an in-flight device step
        self.blocked_s = 0.0          # consumer-edge wait time
        self.latencies: List[float] = []

    def submit(self, frames: Dict[int, List]) -> int:
        rt, cache = self.rt, self.cache
        step = self._step
        self._step += 1
        t0 = time.perf_counter()
        cache.steps += 1
        cache.total_tiles += rt.n_total
        if rt.n_total == 0:
            self._ready.append([step, rt._zero_heads(frames),
                                ShardedReuseStats(0, 0, 0, 0, 0, 0, 0), t0,
                                obs_trace.NULL_SPAN, None, True])
            return step
        rt._init_cache_arrays(cache)
        xs = rt._ingest(frames)
        # 1. this step's gate goes first on the device queue...
        with obs_trace.span("gate", step=step):
            kops.record_dispatch("tile_delta_gate")
            pull = rt._gate(xs, cache)
        # 2. ...then the staged previous step's conv chain, so the stats
        # wait below covers the gate alone while that conv runs
        h0 = time.perf_counter()
        with obs_trace.span("host_plan", step=step) as hsp:
            self._flush_staged()
            in_flight = bool(self._ready)
            stats_np = pull.wait()
            # 3. host planning for this step, under step t-1's conv
            plan = rt._host_plan(stats_np, cache, self.threshold)
            rt._advance_refs(cache, xs, plan)
            hsp.set(overlapped=in_flight, k_max=plan.k_max,
                    computed=plan.stats.computed)
        if plan.stats.cold_shards:
            cache.cold_steps += 1
        cache.valid[:] = True
        cache.launched_tiles += plan.stats.launched
        cache.canvas_bytes_last = plan.stats.canvas_bytes
        cache.canvas_bytes_total += plan.stats.canvas_bytes
        host = time.perf_counter() - h0
        self.host_s += host
        if in_flight:
            self.overlapped_host_s += host
        self._staged = (step, xs, plan, frames, t0)
        return step

    def _flush_staged(self) -> None:
        if self._staged is None:
            return
        step, xs, plan, frames, t0 = self._staged
        self._staged = None
        if plan.k_max:
            # the conv writes the canvas in place: keep copies of the maps
            # not yet collected (enqueued first, so they copy the old
            # bytes)
            for entry in self._ready:
                if not entry[6]:
                    entry[1] = {g: [m.clone() for m in ms]
                                for g, ms in entry[1].items()}
                    entry[6] = True
        # the device-compute span opens at dispatch and closes at the
        # collect() fence: in-flight time on its own track, no added wait
        dspan = obs_trace.begin("device_compute", track="device",
                                step=step, k_max=plan.k_max)
        self.rt._dispatch_conv(xs, plan, self.cache)
        done = [_record(dev) for dev, _ in self.rt.sharding.blocks]
        self._ready.append([step, self.rt._split_heads(self.cache.canvas,
                                                       frames),
                            plan.stats, t0, dspan, done, False])

    def collect(self):
        """Wait for the oldest step (the consumer edge) and return (step,
        {gid: head maps}, stats).  Maps still views of the canvas stay
        valid until the next conv is enqueued (the next ``submit``, or a
        ``collect`` that finds no step flushed)."""
        if not self._ready:
            self._flush_staged()
        if not self._ready:
            raise RuntimeError("collect() with no submitted step pending")
        step, out, stats, t0, dspan, done, _ = self._ready.popleft()
        b0 = time.perf_counter()
        with obs_trace.span("collect", step=step):
            for ev in done or ():
                if ev is not None:
                    ev.synchronize()          # the only wait for a conv
            dspan.end()
        now = time.perf_counter()
        self.blocked_s += now - b0
        self.latencies.append(now - t0)
        return step, out, stats

    def drain(self) -> List:
        """Collect every outstanding step (the staged one is flushed
        first, so every earlier step's maps are copies)."""
        self._flush_staged()
        out = []
        while self._ready or self._staged is not None:
            out.append(self.collect())
        return out

    @property
    def overlap_fraction(self) -> float:
        """Fraction of host planning time spent while a device step was
        in flight (0 on a fully serial schedule)."""
        return self.overlapped_host_s / self.host_s if self.host_s else 0.0

    @property
    def p99_latency_s(self) -> float:
        return float(np.percentile(self.latencies, 99)) \
            if self.latencies else 0.0


__all__ = ["ShardedReuseStats", "ShardedSuperlaunch", "AsyncShardedPipeline"]
