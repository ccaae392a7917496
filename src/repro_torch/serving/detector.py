"""RoI-YOLO-lite on active tiles, with delta-gated temporal reuse.

The online-phase server model of CrossRoI: a small 3x3 conv detector that
runs on the RoI tiles of every camera of the fleet at once.  Layer 0 is the
fused gather + conv + ReLU entry kernel (``roi_conv_entry`` reads haloed
windows straight off the stacked frames), every later layer runs inside
one ``roi_conv_stack`` launch, the 1x1 head is applied to the packed tiles,
and one scatter writes the head tiles into the (C, H, W, A) canvas: three
dispatches for the whole fleet, independent of camera, group and layer
count.  ``roi_forward`` runs the same chain on one camera, and
``forward`` switches between it and the dense path by mask density.

``roi_forward_layers`` and ``fleet_forward_layers`` are the per-layer
chains (one ``roi_conv`` / ``roi_conv_fleet`` entry without ReLU, then one
``roi_conv_packed`` launch per later layer, ``torch.relu`` between
layers): the A/B baselines of the fused paths, bitwise equal to them.

``fleet_forward_reuse`` adds the temporal axis: one ``tile_delta_gate``
dispatch prices each active tile's haloed entry window against its
reference (a canvas, or packed per-tile windows), the changed set is
dilated per layer (``ops.reuse_sets``) and compacted into the launch
tables, unchanged tiles keep their bytes in a persistent head-map canvas,
and one changed-only scatter writes the refreshed tiles -- compute
proportional to scene motion, bit-identical to a full recompute at
threshold 0.

Tensors live on ``self.device`` (the CUDA card unless the caller asks for
the CPU); the host plans the changed sets with numpy between the gate and
the conv chain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.pipeline import IO_ROUND_TRIP_OVERHEAD
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


@dataclass
class DetectorConfig:
    channels: Tuple[int, ...] = (8, 16, 16)   # conv stack (YOLO-lite)
    tile: int = 16                            # feature-map tile
    num_anchors: int = 2
    switch_density: float = 0.70


@dataclass
class ReuseStats:
    """Per-step accounting of the delta-gated (temporal reuse) path."""
    total_tiles: int               # active tiles across the fleet
    raw_changed: int               # tiles whose haloed input window changed
    changed_out: int               # ... dilated once per later layer (the
    #                                tiles whose final output may differ)
    computed: int                  # compact-set tiles (changed_out + the
    #                                zero-halo margin); 0 = gate-only step
    launched: int                  # tiles the launch convolved: ``computed``
    #                                padded to its power-of-two bucket
    cold: bool                     # cache miss: full recompute, no gate
    # the step's gate stats rows ((n, STATS_WIDTH) int32 in fleet packing
    # order, None on a cold step), for the edge rate controller
    gate_stats: Optional[np.ndarray] = None
    # bytes scattered into the persistent head-map canvas this step:
    # written tiles * th * tw * A * itemsize (padding rewrites not counted)
    canvas_bytes: int = 0


TILE_CLASS_BODY = 0      # interior tile: full 8-neighbour ring active
TILE_CLASS_HALO = 1      # boundary tile: >= 1 neighbour missing (zero halo)
N_TILE_CLASSES = 2


def tile_class_rows(nbr_np) -> np.ndarray:
    """Static per-tile class from the fleet neighbour table: TILE_CLASS_HALO
    for tiles with any missing (inactive or off-frame) neighbour, else
    TILE_CLASS_BODY."""
    nbr = np.asarray(nbr_np)
    if nbr.size == 0:
        return np.zeros((nbr.shape[0],), np.int64)
    return np.where((nbr < 0).any(axis=1), TILE_CLASS_HALO,
                    TILE_CLASS_BODY).astype(np.int64)


def _per_row_threshold(thr: np.ndarray, cam_of_row,
                       class_of_row) -> np.ndarray:
    """(C,) per-camera or (C, n_classes) per-camera-per-tile-class
    threshold table -> (n,) per-row thresholds."""
    if thr.ndim == 1:
        return thr[np.asarray(cam_of_row)]
    if class_of_row is None:
        raise ValueError(
            "per-tile-class thresholds (2-D) need class_of_row "
            "(see tile_class_rows)")
    return thr[np.asarray(cam_of_row), np.asarray(class_of_row)]


def gate_changed_rows(stats, threshold, cam_of_row,
                      class_of_row=None) -> np.ndarray:
    """(n, STATS_WIDTH) gate stats rows -> (n,) bool raw-changed mask.

    ``threshold`` is a scalar, a per-camera (C,) array indexed by
    ``cam_of_row`` or a per-camera, per-tile-class (C, n_classes) array
    also indexed by ``class_of_row``.  A threshold <= 0 gates a row on the
    exact change count (bit-identical reuse); a positive one on the
    quantized window byte estimate."""
    s = np.asarray(stats)
    thr = np.asarray(threshold, np.float64)
    if thr.ndim == 0:
        if float(thr) <= 0:
            return s[:, kops.GATE_WIN_EXACT] > 0
        return s[:, kops.GATE_WIN_BYTES] > float(thr)
    per_row = _per_row_threshold(thr, cam_of_row, class_of_row)
    return np.where(per_row <= 0, s[:, kops.GATE_WIN_EXACT] > 0,
                    s[:, kops.GATE_WIN_BYTES] > per_row)


def ref_advance_rows(threshold, cam_of_row, changed,
                     class_of_row=None) -> Optional[np.ndarray]:
    """Which reference rows advance to the current content this step:
    ``None`` = every row (scalar threshold <= 0: previous-frame
    semantics), else a (n,) bool mask -- exact-gated rows always advance,
    lossy-gated rows only when refreshed, so sub-threshold drift
    accumulates against each tile's own reference."""
    thr = np.asarray(threshold, np.float64)
    if thr.ndim == 0:
        return None if float(thr) <= 0 else np.asarray(changed, bool)
    per_row = _per_row_threshold(thr, cam_of_row, class_of_row)
    return (per_row <= 0) | np.asarray(changed, bool)


class PackedActivationCache:
    """Per-fleet persistent state of the delta-gated path.

    Holds the persistent HEAD-MAP CANVAS (``canvas``, (C, H, W, A),
    updated in place: warm steps scatter only their refreshed tiles, an
    all-static step writes nothing), the gate's references and an (n,)
    refresh-epoch vector.  Keyed on the fleet's grid digests and canvas
    shape: any mask change misses the key and forces a full recompute into
    a fresh canvas.  The references hold each tile's haloed window content
    as of its last refresh, in one of two layouts:

    * ``ref_mode="canvas"`` (default): ``ref_canvas``, a padded (C, H+2,
      W+2, 3) reference canvas the gate addresses like the frames;
    * ``ref_mode="packed"``: ``ref_win``, packed (n, t+2, t+2, 3) per-tile
      windows, advanced row for row from the gate's windows output.  A
      tile's reference never aliases a neighbour's through the window
      overlap; the two modes agree bitwise whenever motion stays inside
      tile interiors, and at every threshold <= 0.

    The final layer's packed activations are not kept: the head maps come
    from ``canvas``; the sharded runtime's cache
    (``ShardedActivationCache``) keeps them."""

    def __init__(self, ref_mode: str = "canvas"):
        if ref_mode not in ("canvas", "packed"):
            raise ValueError(f"unknown ref_mode {ref_mode!r}")
        self.ref_mode = ref_mode
        self.key: Optional[tuple] = None
        self.canvas: Optional[torch.Tensor] = None   # (C, H, W, A) heads
        self.ref_canvas: Optional[torch.Tensor] = None  # (C, H+2, W+2, 3)
        self.ref_win: Optional[torch.Tensor] = None  # (n, t+2, t+2, 3)
        self.epoch_np: Optional[np.ndarray] = None   # (n,) last refresh
        self.idx_np: Optional[np.ndarray] = None     # (n, 3) static tables
        self.nbr_np: Optional[np.ndarray] = None     # (n, 8)
        self.cls_np: Optional[np.ndarray] = None     # (n,) tile_class_rows
        self.invalidations = 0
        self.steps = 0
        self.cold_steps = 0
        self.launched_tiles = 0
        self.total_tiles = 0
        self.canvas_bytes_last = 0
        self.canvas_bytes_total = 0

    def invalidate(self) -> None:
        """Drop all cached state; the next reuse step recomputes fully."""
        self.key = None
        self.canvas = None
        self.ref_canvas = None
        self.ref_win = None
        self.epoch_np = None
        self.idx_np = None
        self.nbr_np = None
        self.cls_np = None
        self.invalidations += 1

    @property
    def compute_fraction(self) -> float:
        """Lifetime convolved-tile fraction vs full recompute (padding rows
        included -- they are real launched work)."""
        return self.launched_tiles / max(self.total_tiles, 1)


class ShardedActivationCache:
    """The ``PackedActivationCache`` sharded along the group axis: the
    state of ``fleet.sharded.ShardedSuperlaunch``.

    Each tensor is stacked per shard with one padded shape for all
    shards, and held as a list of blocks, one per device of the mesh
    (``distributed.shardings``; a one-device mesh has the one block
    ``(S, ...)``): the final layer's packed activations ``packed`` (S,
    n_max, th, tw, C_last), the persistent head-map canvas ``canvas`` (S,
    F_max + 1, H, W, A) and the gate's reference canvas ``ref_canvas``
    (S, F_max + 1, H + 2, W + 2, 3), camera slot F_max of each shard a
    sacrificial plane that padding rows point at; ``epoch_np`` (S, n_max)
    is the host's refresh-epoch table.  Validity is per shard: a drift
    re-solve on one group cold-marks only the shard that owns it
    (``invalidate_group``), and the next step recomputes that shard's
    rows in the same launches that serve the warm shards."""

    def __init__(self, plan: "kops.ShardPlan", gids=None):
        self.plan = plan
        self.gids = list(gids) if gids is not None else None
        self.valid = np.zeros(plan.n_shards, bool)
        self.packed: Optional[List[torch.Tensor]] = None
        self.canvas: Optional[List[torch.Tensor]] = None
        self.ref_canvas: Optional[List[torch.Tensor]] = None
        self.epoch_np: Optional[np.ndarray] = None
        self.canvas_bytes_last = 0
        self.canvas_bytes_total = 0
        self.invalidations = 0
        self.shard_invalidations = np.zeros(plan.n_shards, np.int64)
        self.steps = 0
        self.cold_steps = 0          # steps with at least one cold shard
        self.launched_tiles = 0
        self.total_tiles = 0

    def owner_shard(self, group) -> int:
        """The shard owning ``group`` (a gid when the cache was built with
        ``gids``, else a plan position)."""
        pos = self.gids.index(group) if self.gids is not None else int(group)
        return int(self.plan.assignment[pos])

    def invalidate_group(self, group) -> None:
        """Cold-mark only the shard owning ``group``; every other shard's
        rows stay valid."""
        s = self.owner_shard(group)
        self.valid[s] = False
        self.shard_invalidations[s] += 1
        self.invalidations += 1

    def invalidate(self, _adapter=None) -> None:
        """Drop everything (the ``PackedActivationCache`` hook); takes and
        ignores a ``DriftAdapter``, so it can be a mask listener."""
        self.valid[:] = False
        self.packed = None
        self.canvas = None
        self.ref_canvas = None
        self.epoch_np = None
        self.invalidations += 1

    @property
    def compute_fraction(self) -> float:
        """Lifetime convolved-tile fraction vs full recompute (padding rows
        included -- they are real launched work)."""
        return self.launched_tiles / max(self.total_tiles, 1)


def _head_rows(packed: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The 1x1 head on packed tiles before the scatter: (n, th, tw, C) x
    (C, A) -> (n, th, tw, A).  Each output is a per-pixel dot product
    taken in a fixed channel order with elementwise operations, so a
    row's bits never depend on how many rows share the call (a library
    product may pick another reduction order for another row count) --
    which keeps a warm step's refreshed head tiles bit-identical to a full
    recompute."""
    out = packed[..., 0:1] * head[0]
    for c in range(1, packed.shape[-1]):
        out += packed[..., c:c + 1] * head[c]
    return out


def _advance_refs(cache: PackedActivationCache, xp: torch.Tensor,
                  adv: Optional[np.ndarray], windows: Optional[torch.Tensor],
                  t: int) -> None:
    """Advance the gate references per ``ref_advance_rows``'s verdict and
    stamp the refresh epochs.  ``adv is None`` = every row: the packed
    references become the gate's windows output and the reference canvas
    the current padded frame, each a free alias (both are fresh tensors
    every step).  A partial advance copies the advanced rows in place:
    packed mode their windows, canvas mode their full (t+2, t+2) window
    regions from ``xp`` -- the same result as the JAX package's masked
    select over a (C, H+2, W+2) host mask, without building the mask.
    Windows of neighbouring advanced rows overlap and carry the same
    content."""
    if adv is None:
        if cache.ref_mode == "packed":
            cache.ref_win = windows
        else:
            cache.ref_canvas = xp
        cache.epoch_np[:] = cache.steps
    elif adv.any():
        if cache.ref_mode == "packed":
            rows = torch.as_tensor(np.nonzero(adv)[0], device=xp.device)
            cache.ref_win[rows] = windows[rows]
        else:
            rows = torch.as_tensor(cache.idx_np[adv], device=xp.device)
            where = kref.tile_index(rows, t, t, t + 2, t + 2)
            cache.ref_canvas[where] = xp[where]
        cache.epoch_np[adv] = cache.steps


def _pow2(k: int) -> int:
    """The power-of-two bucket a ragged set of k rows is padded to."""
    p = 1
    while p < k:
        p *= 2
    return p


class RoIDetector:
    """Conv stack + 1x1 head, built for (H, W, 3) frames, on ``device``
    (the CUDA card unless the caller passes one; raises without CUDA).

    Weights are HWIO (3, 3, Cin, Cout) float32 and the head (C_last, A),
    the JAX package's layouts.  The seeded initialisation draws from a
    ``torch.Generator`` with the JAX detector's shapes and scales but not
    its numbers; ``from_numpy`` takes the JAX detector's parameters."""

    def __init__(self, cfg: DetectorConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        chans = (3,) + tuple(cfg.channels)
        weights = [torch.randn((3, 3, ci, co), generator=gen) / np.sqrt(9 * ci)
                   for ci, co in zip(chans[:-1], chans[1:])]
        # head: objectness + 4 bbox regressors per anchor
        head = torch.randn((chans[-1], cfg.num_anchors * 5),
                           generator=gen) / np.sqrt(chans[-1])
        self._set_params(weights, head)
        # per-mask static tables: digest -> (idx, idx3, nbr) on the device
        self._mask_cache: Dict[bytes, tuple] = {}
        # per-fleet static tables: digest tuple -> (idx, nbr) numpy + device
        self._fleet_cache: Dict[tuple, tuple] = {}
        # per-grid digest memo: id(grid) -> (grid ref, popcount, digest)
        self._grid_digests: Dict[int, Tuple[np.ndarray, int, bytes]] = {}
        self._digest_cap = 64
        self.grid_hash_computes = 0
        self.fleet_cache_hits = 0

    @classmethod
    def from_numpy(cls, cfg: DetectorConfig, weights, head,
                   device=None) -> "RoIDetector":
        """A detector with the given parameters (numpy-convertible HWIO
        weights and (C_last, A) head, e.g. the JAX detector's)."""
        det = cls(cfg, device=device)
        new_w = [torch.tensor(np.asarray(w, np.float32)) for w in weights]
        new_h = torch.tensor(np.asarray(head, np.float32))
        for old, new in zip(det.weights + [det.head], new_w + [new_h]):
            if tuple(old.shape) != tuple(new.shape):
                raise ValueError(f"parameter of shape {tuple(new.shape)} "
                                 f"where {tuple(old.shape)} is expected")
        if len(new_w) != len(det.weights):
            raise ValueError(f"{len(new_w)} conv weights for "
                             f"{len(det.weights)} layers")
        det._set_params(new_w, new_h)
        return det

    def _set_params(self, weights, head) -> None:
        self.weights: List[torch.Tensor] = [
            w.to(self.device, torch.float32).contiguous() for w in weights]
        self.head = head.to(self.device, torch.float32).contiguous()

    # -- dense path ----------------------------------------------------------
    def dense_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-frame SAME conv stack + head on an (H, W, 3) frame."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        for w in self.weights:
            xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
            x = torch.relu(kref.conv3x3_taps(xp[None], w)[0])
        return _head_rows(x[None], self.head)[0]

    # -- static-table caches ---------------------------------------------------
    def _grid_digest(self, grid) -> bytes:
        """Content digest of one RoI grid, serialized at most once per
        array object; a popcount guard catches in-place mutation."""
        pop = int(np.count_nonzero(grid))
        hit = self._grid_digests.get(id(grid))
        if hit is not None and hit[0] is grid and hit[1] == pop:
            return hit[2]
        g = np.asarray(grid, bool)
        self.grid_hash_computes += 1
        digest = np.packbits(g).tobytes() + bytes(str(g.shape), "ascii")
        while len(self._grid_digests) >= self._digest_cap:
            self._grid_digests.pop(next(iter(self._grid_digests)))
        self._grid_digests[id(grid)] = (grid, pop, digest)
        return digest

    def _table(self, a: np.ndarray) -> torch.Tensor:
        """A host int table as a contiguous int32 tensor on the device."""
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=self.device)

    def _mask_tables(self, grid):
        """(idx (n, 2), idx3 (n, 3) rows of camera 0, nbr (n, 8)) on the
        device for one camera's grid, cached on the grid's content in a
        FIFO of 8 (masks change rarely: offline re-solves)."""
        key = self._grid_digest(grid)
        hit = self._mask_cache.get(key)
        if hit is None:
            idx_np = kops.mask_to_indices(grid)
            idx3 = np.concatenate([np.zeros((idx_np.shape[0], 1), np.int32),
                                   idx_np], axis=1)
            hit = (self._table(idx_np), self._table(idx3),
                   self._table(kops.neighbor_table(idx_np, grid.shape)))
            while len(self._mask_cache) >= 8:
                self._mask_cache.pop(next(iter(self._mask_cache)))
            self._mask_cache[key] = hit
        return hit

    def _fleet_tables(self, grids):
        """(idx_np (n, 3), nbr_np (n, 8), idx, nbr) for a fleet of grids,
        cached on the grids' content."""
        self._digest_cap = max(self._digest_cap, 2 * len(grids))
        key = tuple(self._grid_digest(g) for g in grids)
        hit = self._fleet_cache.get(key)
        if hit is None:
            idx_np, _ = kops.fleet_indices(grids)
            nbr_np = kops.fleet_neighbor_table(grids)
            hit = (idx_np, nbr_np, self._table(idx_np), self._table(nbr_np))
            while len(self._fleet_cache) >= 8:
                self._fleet_cache.pop(next(iter(self._fleet_cache)))
            self._fleet_cache[key] = hit
        else:
            self.fleet_cache_hits += 1
        return hit

    # -- RoI path -------------------------------------------------------------
    def _stack_chain(self, x: torch.Tensor, idx: torch.Tensor,
                     nbr: torch.Tensor) -> torch.Tensor:
        """The fused launch chain over stacked frames: the entry kernel,
        then the layer-stack kernel (absent for a 1-layer net)."""
        t = self.cfg.tile
        packed = kops.roi_conv_entry(x, self.weights[0], idx, t, t)
        if len(self.weights) > 1:
            packed = kops.roi_conv_stack(packed, self.weights[1:], nbr)
        return packed

    def _layer_chain(self, entry: torch.Tensor,
                     nbr: torch.Tensor) -> torch.Tensor:
        """The per-layer chain after the first layer's packed conv output
        ``entry``: ReLU, then one ``roi_conv_packed`` launch + ReLU per
        later layer."""
        packed = torch.relu(entry)
        for w in self.weights[1:]:
            packed = torch.relu(kops.roi_conv_packed(packed, w, nbr))
        return packed

    def _stack_frames(self, frames, grids):
        """Frames of any sizes -> (C, canvas_h, canvas_w, 3) zero-padded
        stack on the device, the canvas covering every frame and grid."""
        t = self.cfg.tile
        canvas_h = max(max(f.shape[0] for f in frames),
                       max(g.shape[0] * t for g in grids))
        canvas_w = max(max(f.shape[1] for f in frames),
                       max(g.shape[1] * t for g in grids))
        x = torch.zeros((len(frames), canvas_h, canvas_w, 3),
                        dtype=torch.float32, device=self.device)
        for c, f in enumerate(frames):
            x[c, :f.shape[0], :f.shape[1]] = torch.as_tensor(
                f, dtype=torch.float32, device=self.device)
        return x, canvas_h, canvas_w

    def _zero_heads(self, frames) -> List[torch.Tensor]:
        return [torch.zeros(tuple(f.shape[:2]) + (self.head.shape[-1],),
                            dtype=torch.float32, device=self.device)
                for f in frames]

    def _camera_heads(self, packed: torch.Tensor, idx: torch.Tensor,
                      x: torch.Tensor, frame) -> torch.Tensor:
        """The head on one camera's packed tiles, scattered (one
        ``sbnet_scatter``) onto zeros of the padded frame ``x``'s extent
        and cropped to the ``frame``'s (H, W, A)."""
        base = torch.zeros(tuple(x.shape[:2]) + (self.head.shape[-1],),
                           dtype=torch.float32, device=self.device)
        kops.sbnet_scatter(_head_rows(packed, self.head), idx, base)
        return base[:frame.shape[0], :frame.shape[1]]

    def _fleet_heads(self, packed: torch.Tensor, idx: torch.Tensor,
                     frames, canvas_h: int,
                     canvas_w: int) -> List[torch.Tensor]:
        """The head on the fleet's packed tiles, scattered (one
        ``sbnet_scatter_fleet``) onto a zero (C, canvas_h, canvas_w, A)
        canvas; returns each camera's (H, W, A) view."""
        canvas = torch.zeros((len(frames), canvas_h, canvas_w,
                              self.head.shape[-1]), dtype=torch.float32,
                             device=self.device)
        kops.sbnet_scatter_fleet(_head_rows(packed, self.head), idx, canvas)
        return [canvas[c, :f.shape[0], :f.shape[1]]
                for c, f in enumerate(frames)]

    def roi_forward(self, x, grid: np.ndarray) -> torch.Tensor:
        """x: (H, W, 3) frame; grid: bool tile mask at ``cfg.tile``
        granularity.  Returns the full-frame (H, W, A) head map, zero
        outside the RoI, in 3 dispatches whatever the layer count: the
        entry, the layer stack (none for a 1-layer net) and one scatter of
        the head tiles.  The frame is zero-padded to cover its grid first,
        as on the fleet canvas, so a partial last tile row is computed as
        ``fleet_forward`` computes it.  An empty mask launches nothing."""
        idx, idx3, nbr = self._mask_tables(grid)
        if idx.shape[0] == 0:
            return self._zero_heads([x])[0]
        xs, _, _ = self._stack_frames([x], [grid])
        return self._camera_heads(self._stack_chain(xs, idx3, nbr), idx,
                                  xs[0], x)

    def roi_forward_layers(self, x, grid: np.ndarray) -> torch.Tensor:
        """``roi_forward`` through the per-layer chain: one ``roi_conv``
        (the gather fused into the first conv), one ``roi_conv_packed`` per
        later layer, ReLU between, one scatter -- the bitwise A/B baseline
        of the fused stack."""
        t = self.cfg.tile
        idx, _, nbr = self._mask_tables(grid)
        xs, _, _ = self._stack_frames([x], [grid])
        packed = self._layer_chain(
            kops.roi_conv(xs[0], self.weights[0], idx, t, t), nbr)
        return self._camera_heads(packed, idx, xs[0], x)

    def forward(self, x, grid: Optional[np.ndarray]) -> torch.Tensor:
        """The dense path without a mask or at a mask density of at least
        ``cfg.switch_density``, else ``roi_forward``."""
        if grid is None or grid.mean() >= self.cfg.switch_density:
            return self.dense_forward(x)
        return self.roi_forward(x, grid)

    def fleet_forward(self, frames: List[torch.Tensor],
                      grids: List[np.ndarray]) -> List[torch.Tensor]:
        """Any number of cameras in <= 3 dispatches: the frames are
        stacked on a common zero canvas and all active tiles run as ONE
        entry launch, ONE layer-stack launch and ONE scatter of the head
        tiles.  Returns the per-camera full-frame (H, W, A) head maps, zero
        outside the RoI."""
        _, _, idx, nbr = self._fleet_tables(grids)
        if idx.shape[0] == 0:             # whole set empty: no launches
            return self._zero_heads(frames)
        x, canvas_h, canvas_w = self._stack_frames(frames, grids)
        return self._fleet_heads(self._stack_chain(x, idx, nbr), idx, frames,
                                 canvas_h, canvas_w)

    def fleet_forward_layers(self, frames: List[torch.Tensor],
                             grids: List[np.ndarray]) -> List[torch.Tensor]:
        """``fleet_forward`` through the per-layer chain: one
        ``roi_conv_fleet``, one ``roi_conv_packed`` per later layer, ReLU
        between, one scatter (1 + (N-1) + 1 dispatches) -- the bitwise A/B
        baseline of the fused path."""
        t = self.cfg.tile
        _, _, idx, nbr = self._fleet_tables(grids)
        x, canvas_h, canvas_w = self._stack_frames(frames, grids)
        packed = self._layer_chain(
            kops.roi_conv_fleet(x, self.weights[0], idx, t, t), nbr)
        return self._fleet_heads(packed, idx, frames, canvas_h, canvas_w)

    def superlaunch_forward(self, frames: Dict[int, List[torch.Tensor]],
                            grids: Dict[int, List[np.ndarray]]
                            ) -> Dict[int, List[torch.Tensor]]:
        """Every camera of every group in one fleet-flat launch chain:
        group boundaries are camera boundaries in the flat (flat_cam, ty,
        tx) index space.  Returns {gid: per-camera head maps}."""
        gids = list(frames)
        flat_frames = [f for g in gids for f in frames[g]]
        flat_grids = [gr for g in gids for gr in grids[g]]
        heads = self.fleet_forward(flat_frames, flat_grids)
        out, pos = {}, 0
        for g in gids:
            out[g] = heads[pos:pos + len(frames[g])]
            pos += len(frames[g])
        return out

    # -- temporal reuse (delta-gated) path ------------------------------------
    def fleet_forward_reuse(self, frames: List[torch.Tensor],
                            grids: List[np.ndarray],
                            cache: PackedActivationCache,
                            threshold=0.0, qstep: float = 8.0
                            ) -> Tuple[List[torch.Tensor], ReuseStats]:
        """``fleet_forward`` with compute proportional to CHANGED tiles.

        One ``tile_delta_gate`` dispatch prices every active tile's haloed
        entry window against its reference (``cache.ref_mode``: the
        reference canvas or packed per-tile windows); a tile is changed when
        its window byte estimate exceeds ``threshold`` (at <= 0 the exact
        change count gates, making reuse bit-identical to a full
        recompute).  ``threshold`` may also be a per-camera (C,) or a
        (C, N_TILE_CLASSES) table (see ``gate_changed_rows``).  The
        changed set is dilated and compacted (``ops.reuse_sets``,
        ``ops.compact_tables``), padded to a power-of-two bucket, run
        through the entry + stack chain, and one changed-only scatter
        writes the refreshed head tiles into the persistent canvas in
        place.  An all-static frame dispatches the gate alone.  A cache
        miss recomputes fully into a fresh canvas.

        The returned head maps are VIEWS of ``cache.canvas``: they stay
        valid until the next step on the same cache, which overwrites
        them in place.  Clone what must outlive the step."""
        t = self.cfg.tile
        idx_np, nbr_np, idx, nbr = self._fleet_tables(grids)
        n = int(idx_np.shape[0])
        if n == 0:                        # whole fleet empty: no launches
            return self._zero_heads(frames), ReuseStats(0, 0, 0, 0, 0,
                                                        cold=False)
        x, canvas_h, canvas_w = self._stack_frames(frames, grids)
        # a fresh tensor every step: the threshold-0 reference advance
        # aliases it
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        key = (tuple(self._grid_digest(g) for g in grids),
               len(frames), canvas_h, canvas_w)
        n_layers = self.num_conv_layers
        cache.steps += 1
        cache.total_tiles += n
        A = self.head.shape[-1]
        tile_bytes = t * t * A * self.head.element_size()
        cold = (cache.key != key or cache.canvas is None
                or (cache.ref_win is None if cache.ref_mode == "packed"
                    else cache.ref_canvas is None))
        if cold:
            cache.key = key
            packed = self._stack_chain(x, idx, nbr)
            if cache.ref_mode == "packed":
                cache.ref_win = kops.gather_windows(xp, idx, t, t)
            else:
                cache.ref_canvas = xp      # free alias, full advance
            cache.idx_np = idx_np
            cache.nbr_np = nbr_np
            cache.cls_np = tile_class_rows(nbr_np)
            cache.epoch_np = np.zeros(n, np.int64)
            cache.canvas = torch.zeros((len(frames), canvas_h, canvas_w, A),
                                       dtype=torch.float32,
                                       device=self.device)
            kops.sbnet_scatter_fleet(_head_rows(packed, self.head),
                                     idx, cache.canvas)
            cache.cold_steps += 1
            cache.launched_tiles += n
            stats = ReuseStats(n, n, n, n, n, cold=True,
                               canvas_bytes=n * tile_bytes)
        else:
            if cache.ref_mode == "packed":
                gate, windows = kops.tile_delta_gate(xp, cache.ref_win, idx,
                                                     t, t, qstep=qstep)
            else:
                gate = kops.tile_delta_gate_canvas(xp, cache.ref_canvas, idx,
                                                   t, t, qstep=qstep)
                windows = None
            s = gate.cpu().numpy()        # the step's one host round trip
            raw = gate_changed_rows(s, threshold, cache.idx_np[:, 0],
                                    cache.cls_np)
            changed, compute = kops.reuse_sets(raw, cache.nbr_np, n_layers)
            n_changed = int(changed.sum())
            if n_changed:
                cidx, cnbr = kops.compact_tables(cache.idx_np, cache.nbr_np,
                                                 compute)
                k = cidx.shape[0]
                # pad the compact set to its power-of-two bucket with inert
                # repeats (idx) and -1 neighbours; the padding rows are
                # real work, accounted as ``launched``
                k_pad = _pow2(k)
                if k_pad > k:
                    cidx = np.concatenate(
                        [cidx, np.broadcast_to(cidx[-1:], (k_pad - k, 3))])
                    cnbr = np.concatenate(
                        [cnbr, np.full((k_pad - k, 8), -1, np.int32)])
                fresh = self._stack_chain(x, self._table(cidx),
                                          self._table(cnbr))
                # only the changed-OUTPUT rows' head tiles hit the canvas;
                # margin rows absorbed the zero-halo error and keep their
                # tiles.  The scatter is padded to a power of two by
                # repeating the last tile
                slots = np.nonzero(compute)[0]
                upd = changed[slots]
                fresh_rows = fresh[torch.as_tensor(np.nonzero(upd)[0],
                                                   device=self.device)]
                scidx = cache.idx_np[slots[upd]]
                ph = _head_rows(fresh_rows, self.head)
                m = scidx.shape[0]
                m_pad = _pow2(m)
                if m_pad > m:
                    scidx = np.concatenate(
                        [scidx, np.broadcast_to(scidx[-1:], (m_pad - m, 3))])
                    ph = torch.cat([ph, ph[-1:].expand(
                        (m_pad - m,) + tuple(ph.shape[1:]))])
                kops.sbnet_scatter_changed(ph, self._table(scidx),
                                           cache.canvas)
                cache.launched_tiles += k_pad
                stats = ReuseStats(n, int(raw.sum()), n_changed, k, k_pad,
                                   cold=False, gate_stats=s,
                                   canvas_bytes=m * tile_bytes)
            else:
                # ALL-STATIC: the gate is the whole step
                stats = ReuseStats(n, int(raw.sum()), 0, 0, 0, cold=False,
                                   gate_stats=s, canvas_bytes=0)
            adv = ref_advance_rows(threshold, cache.idx_np[:, 0], changed,
                                   cache.cls_np)
            _advance_refs(cache, xp, adv, windows, t)
        cache.canvas_bytes_last = stats.canvas_bytes
        cache.canvas_bytes_total += stats.canvas_bytes
        return ([cache.canvas[c, :f.shape[0], :f.shape[1]]
                 for c, f in enumerate(frames)], stats)

    def superlaunch_forward_reuse(self, frames: Dict[int, List[torch.Tensor]],
                                  grids: Dict[int, List[np.ndarray]],
                                  cache: PackedActivationCache,
                                  threshold=0.0, qstep: float = 8.0):
        """Delta-gated cross-group super-launch (see
        ``superlaunch_forward`` for the flattening).  Returns ({gid: head
        maps}, ReuseStats); the maps are views of ``cache.canvas``."""
        gids = list(frames)
        flat_frames = [f for g in gids for f in frames[g]]
        flat_grids = [gr for g in gids for gr in grids[g]]
        heads, stats = self.fleet_forward_reuse(flat_frames, flat_grids,
                                                cache, threshold, qstep)
        out, pos = {}, 0
        for g in gids:
            out[g] = heads[pos:pos + len(frames[g])]
            pos += len(frames[g])
        return out, stats

    # -- cost model -------------------------------------------------------------
    @property
    def num_conv_layers(self) -> int:
        return len(self.cfg.channels)

    def flops(self, H: int, W: int, density: float = 1.0) -> float:
        chans = (3,) + tuple(self.cfg.channels)
        per_px = sum(2 * 9 * ci * co for ci, co in zip(chans[:-1], chans[1:]))
        per_px += 2 * chans[-1] * self.cfg.num_anchors * 5
        return H * W * density * per_px

    def io_overhead_per_layer(
            self, round_trip: float = IO_ROUND_TRIP_OVERHEAD) -> float:
        """Gather/scatter byte tax amortized over the conv stack: one round
        trip for N layers."""
        return round_trip / max(self.num_conv_layers, 1)

    def speedup_estimate(self, density: float,
                         round_trip: float = IO_ROUND_TRIP_OVERHEAD) -> float:
        """Structural speedup: FLOP ratio with the amortized gather/scatter
        byte tax."""
        if density >= self.cfg.switch_density:
            return 1.0
        return 1.0 / (self.io_overhead_per_layer(round_trip) + density)
