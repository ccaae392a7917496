"""Counting wrappers around the port's kernels, and the host tables.

Host side (numpy, static per mask): mask -> index-list conversion, the
(n, 8) neighbour table of the packed conv chain, the fleet-flat super-launch
tables, the delta gate's changed-set dilation and compaction, and the
attention's visit bound.  Token packing for the RoI-packed prefill
(``pack_tokens``/``unpack_tokens``) is plain tensor indexing.

Every public kernel wrapper counts its dispatch under a name from
``KERNEL_NAMES`` before it launches, so tests and runs can assert the
dispatch structure of the hot path (see ``fleet.runtime``).  An empty tile
set is not a dispatch: it returns with no launch and no count.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import roi_attention as _roi_attention
from repro_torch.kernels import roi_conv as _roi_conv
from repro_torch.kernels import sbnet as _sbnet
from repro_torch.kernels import tile_delta as _tile_delta
from repro_torch.kernels.roi_attention import PAD_POS
from repro_torch.kernels.roi_conv import NEIGHBOR_OFFSETS
from repro_torch.kernels.tile_delta import (COEF_BITS, GATE_BODY_BYTES,
                                            GATE_BODY_NNZ, GATE_BODY_RUNS,
                                            GATE_BODY_SABS, GATE_WIN_BYTES,
                                            GATE_WIN_EXACT, RUN_BITS,
                                            STATS_WIDTH)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import KERNEL_NAMES

# kernel-dispatch counter: wrapper name -> number of dispatches issued from
# Python, process-lifetime.  ``count_kernels()`` regions live on a
# contextvar stack, so a dispatch issued from another thread or async task
# never leaks into a region it is not lexically inside.
KERNEL_COUNTS: collections.Counter = collections.Counter()

_COUNT_LOCK = threading.Lock()
_COUNT_STACK: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_kernel_count_stack", default=())


def record_dispatch(name: str, n: int = 1) -> None:
    """Count ``n`` dispatches under ``name``: bumps ``KERNEL_COUNTS`` and
    every ``count_kernels()`` region open in THIS context.  ``name`` must
    come from ``obs.metrics.KERNEL_NAMES`` -- a misspelt name raises
    instead of counting zero forever.  With observability on, the same
    bump lands on the ``kernel_dispatches`` counter family (label
    ``kernel=name``)."""
    if name not in KERNEL_NAMES:
        raise ValueError(
            f"unknown kernel counter {name!r}: dispatch names must come "
            f"from obs.metrics.KERNEL_NAMES")
    with _COUNT_LOCK:
        KERNEL_COUNTS[name] += n
        for region in _COUNT_STACK.get():
            region[name] += n
    obs_metrics.KERNEL_DISPATCHES.inc(n, kernel=name)


@contextlib.contextmanager
def count_kernels():
    """Isolated dispatch-count region: ``with count_kernels() as c: ...``.

    ``c`` accumulates exactly the dispatches issued inside the region in
    this thread or async context; an enclosing region still sees every
    inner dispatch, so regions nest.  ``KERNEL_COUNTS`` keeps counting
    independently."""
    region: collections.Counter = collections.Counter()
    token = _COUNT_STACK.set(_COUNT_STACK.get() + (region,))
    try:
        yield region
    finally:
        _COUNT_STACK.reset(token)


# ---------------------------------------------------------------------------
# host tables (numpy, static per mask)
# ---------------------------------------------------------------------------

def mask_to_indices(grid: np.ndarray) -> np.ndarray:
    """Bool (ty, tx) RoI grid -> (n, 2) int32 active-tile coords."""
    ys, xs = np.nonzero(grid)
    return np.stack([ys, xs], axis=1).astype(np.int32)


def neighbor_table(idx: np.ndarray, grid_shape) -> np.ndarray:
    """(n, 2) active-tile coords -> (n, 8) int32 packed-slot neighbour
    table: column j is the slot of the neighbour at NEIGHBOR_OFFSETS[j], or
    -1 when that neighbour is inactive or off the frame (zero halo)."""
    idx = np.asarray(idx)
    ty_max, tx_max = grid_shape
    slot = {(int(y), int(x)): i for i, (y, x) in enumerate(idx)}
    nbr = np.full((idx.shape[0], 8), -1, np.int32)
    for i, (y, x) in enumerate(idx):
        for j, (dy, dx) in enumerate(NEIGHBOR_OFFSETS):
            ny, nx = int(y) + dy, int(x) + dx
            if 0 <= ny < ty_max and 0 <= nx < tx_max:
                nbr[i, j] = slot.get((ny, nx), -1)
    return nbr


def fleet_indices(grids) -> "tuple[np.ndarray, np.ndarray]":
    """Per-camera bool grids -> (idx (n, 3) int32 rows of (cam, ty, tx),
    offsets (C+1,) int64): camera c's tiles occupy packed slots
    [offsets[c], offsets[c+1]) in row-major order."""
    rows = []
    offsets = np.zeros(len(grids) + 1, np.int64)
    for c, grid in enumerate(grids):
        ys, xs = np.nonzero(np.asarray(grid, bool))
        offsets[c + 1] = offsets[c] + ys.size
        rows.append(np.stack([np.full(ys.size, c), ys, xs], axis=1))
    idx = (np.concatenate(rows, axis=0) if rows
           else np.zeros((0, 3))).astype(np.int32)
    return idx, offsets


def fleet_neighbor_table(grids) -> np.ndarray:
    """(n, 8) neighbour table of the concatenated fleet packing: each
    camera's table is built on its own grid and shifted by its packed
    offset, so a halo never references another camera's slots."""
    tables = []
    off = 0
    for grid in grids:
        grid = np.asarray(grid, bool)
        idx = mask_to_indices(grid)
        nbr = neighbor_table(idx, grid.shape)
        nbr[nbr >= 0] += off
        off += idx.shape[0]
        tables.append(nbr)
    if not tables:
        return np.zeros((0, 8), np.int32)
    return np.concatenate(tables, axis=0).astype(np.int32)


def superlaunch_tables(grids_per_group):
    """Fleet-flat tables over all groups' cameras: returns (idx (n, 3),
    nbr (n, 8), tile_offsets (F+1,), cam_starts (K+1,)); group g's cameras
    are flat cams [cam_starts[g], cam_starts[g+1])."""
    flat = [g for gs in grids_per_group for g in gs]
    idx, tile_offsets = fleet_indices(flat)
    nbr = fleet_neighbor_table(flat)
    cam_starts = np.cumsum([0] + [len(gs) for gs in grids_per_group]) \
        .astype(np.int64)
    return idx, nbr, tile_offsets, cam_starts


class ShardPlan:
    """Which camera groups each shard of the sharded runtime serves,
    balanced by active-tile count (longest processing time first: sort
    the groups by tiles, biggest first, and place each on the
    least-loaded shard; max load <= mean load + the largest group).
    Groups keep their offered order within a shard, so a shard's flat
    tables are ``superlaunch_tables`` of an order-preserving
    subsequence."""

    def __init__(self, assignment: np.ndarray, tile_counts: np.ndarray,
                 n_shards: int):
        self.assignment = np.asarray(assignment, np.int64)   # (K,)
        self.tile_counts = np.asarray(tile_counts, np.int64)  # (K,)
        self.n_shards = int(n_shards)

    @property
    def n_groups(self) -> int:
        return int(self.assignment.shape[0])

    def shard_groups(self, s: int) -> "list[int]":
        """Group positions assigned to shard ``s``, in offered order."""
        return [int(i) for i in np.nonzero(self.assignment == s)[0]]

    @property
    def shard_tiles(self) -> np.ndarray:
        """(S,) active tiles per shard."""
        out = np.zeros(self.n_shards, np.int64)
        np.add.at(out, self.assignment, self.tile_counts)
        return out

    @property
    def imbalance(self) -> float:
        """max / mean shard tile load (1.0 = balanced)."""
        loads = self.shard_tiles
        mean = float(loads.mean()) if loads.size else 0.0
        return float(loads.max()) / mean if mean > 0 else 1.0


def shard_plan(grids_per_group, n_shards: int) -> ShardPlan:
    """The group -> shard assignment for ``n_shards`` shards of the
    per-group camera grids (``superlaunch_tables``'s argument).
    Deterministic: ties go to the earlier group and the lower shard."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    tiles = np.array([sum(int(np.count_nonzero(np.asarray(g, bool)))
                          for g in gs) for gs in grids_per_group],
                     np.int64)
    order = np.argsort(-tiles, kind="stable")
    loads = np.zeros(n_shards, np.int64)
    assignment = np.zeros(tiles.shape[0], np.int64)
    for gi in order:
        s = int(np.argmin(loads))
        assignment[gi] = s
        loads[s] += tiles[gi]
    return ShardPlan(assignment, tiles, n_shards)


def dilate_changed(changed: np.ndarray, nbr: np.ndarray) -> np.ndarray:
    """One dilation of a per-tile bool set through the (n, 8) neighbour
    table (which never crosses cameras)."""
    changed = np.asarray(changed, bool)
    if changed.size == 0:
        return changed
    nbr = np.asarray(nbr)
    safe = np.clip(nbr, 0, changed.size - 1)
    return changed | (changed[safe] & (nbr >= 0)).any(axis=1)


def reuse_sets(raw_changed: np.ndarray, nbr: np.ndarray,
               n_layers: int) -> "tuple[np.ndarray, np.ndarray]":
    """The gate's receptive-field bookkeeping: ``raw_changed`` (tiles
    whose haloed entry window changed) dilated once per later layer gives
    ``changed_out`` (tiles whose final output may differ); dilated as many
    times again gives ``compute``, the compact launch's set, whose margin
    absorbs the zero halo of the compacted neighbour table."""
    changed = np.asarray(raw_changed, bool)
    for _ in range(max(n_layers - 1, 0)):
        changed = dilate_changed(changed, nbr)
    compute = changed
    for _ in range(max(n_layers - 1, 0)):
        compute = dilate_changed(compute, nbr)
    return changed, compute


def compact_tables(idx: np.ndarray, nbr: np.ndarray, keep: np.ndarray
                   ) -> "tuple[np.ndarray, np.ndarray]":
    """(idx[keep], the (k, 8) neighbour table renumbered to compact slots;
    dropped or inactive neighbours become -1)."""
    idx = np.asarray(idx)
    nbr = np.asarray(nbr)
    keep = np.asarray(keep, bool)
    n = idx.shape[0]
    pos = np.full(n, -1, np.int64)
    pos[keep] = np.arange(int(keep.sum()))
    cnbr = np.where(nbr >= 0, pos[np.clip(nbr, 0, max(n - 1, 0))],
                    -1).astype(np.int32)
    return idx[keep].astype(np.int32), cnbr[keep]


# ---------------------------------------------------------------------------
# counting kernel wrappers
# ---------------------------------------------------------------------------

def roi_conv_entry(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   th: int, tw: int) -> torch.Tensor:
    """Fleet-flat gather + 3x3 conv + ReLU: (C, H, W, Cin) stacked frames +
    (n, 3) (flat_cam, ty, tx) rows -> ReLU'd packed (n, th, tw, Cout), the
    input of ``roi_conv_stack``."""
    if idx.shape[0] == 0:
        return x.new_zeros((0, th, tw, w.shape[-1]))
    record_dispatch("roi_conv_entry")
    return _roi_conv.roi_conv_entry(x, w, idx, th, tw)


def roi_conv_fleet(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   th: int, tw: int) -> torch.Tensor:
    """``roi_conv_entry`` without the ReLU: the per-layer fleet chain's
    first layer, (C, H, W, Cin) stacked frames + (n, 3) rows -> packed (n,
    th, tw, Cout)."""
    if idx.shape[0] == 0:
        return x.new_zeros((0, th, tw, w.shape[-1]))
    record_dispatch("roi_conv_fleet")
    return _roi_conv.roi_conv_fleet(x, w, idx, th, tw)


def roi_conv(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, th: int,
             tw: int) -> torch.Tensor:
    """One camera's gather + 3x3 conv, no ReLU: an (H, W, Cin) frame
    covering its grid + (n, 2) (ty, tx) rows -> packed (n, th, tw, Cout),
    the single-camera per-layer chain's first layer."""
    if idx.shape[0] == 0:
        return x.new_zeros((0, th, tw, w.shape[-1]))
    record_dispatch("roi_conv")
    return _roi_conv.roi_conv(x, w, idx, th, tw)


def roi_conv_batched(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                     th: int, tw: int) -> torch.Tensor:
    """(B, H, W, Cin) frames sharing one active set -> (B, n, th, tw,
    Cout), in ONE launch, counted as one ``roi_conv``."""
    if idx.shape[0] == 0 or x.shape[0] == 0:
        return x.new_zeros((x.shape[0], idx.shape[0], th, tw, w.shape[-1]))
    record_dispatch("roi_conv")
    return _roi_conv.roi_conv(x, w, idx, th, tw)


def roi_conv_packed(packed: torch.Tensor, w: torch.Tensor,
                    nbr: torch.Tensor) -> torch.Tensor:
    """One packed-resident conv layer, no ReLU: (n, th, tw, Cin) -> (n,
    th, tw, Cout) with halos from the (n, 8) neighbour table."""
    if packed.shape[0] == 0:
        return packed.new_zeros(packed.shape[:3] + (w.shape[-1],))
    record_dispatch("roi_conv_packed")
    return _roi_conv.roi_conv_packed(packed, w, nbr)


def roi_conv_stack(packed: torch.Tensor, ws: Sequence[torch.Tensor],
                   nbr: torch.Tensor) -> torch.Tensor:
    """The whole packed conv chain after the entry (conv + ReLU per
    layer) in ONE dispatch."""
    if packed.shape[0] == 0:
        return packed.new_zeros(packed.shape[:3] + (ws[-1].shape[-1],))
    record_dispatch("roi_conv_stack")
    return _roi_conv.roi_conv_stack(packed, ws, nbr)


def sbnet_scatter_fleet(packed: torch.Tensor, idx: torch.Tensor,
                        base: torch.Tensor) -> torch.Tensor:
    """Cross-camera scatter: packed tiles -> (C, H, W, A) ``base``, in
    place, in ONE launch; returns ``base``."""
    if packed.shape[0] == 0:
        return base
    record_dispatch("sbnet_scatter_fleet")
    return _sbnet.sbnet_scatter_fleet(packed, idx, base)


def sbnet_gather(x: torch.Tensor, idx: torch.Tensor, th: int,
                 tw: int) -> torch.Tensor:
    """(H, W, C) + (n, 2) tile coords -> packed (n, th, tw, C)."""
    if idx.shape[0] == 0:
        return x.new_zeros((0, th, tw, x.shape[-1]))
    record_dispatch("sbnet_gather")
    return _sbnet.sbnet_gather(x, idx, th, tw)


def sbnet_scatter(packed: torch.Tensor, idx: torch.Tensor,
                  base: torch.Tensor) -> torch.Tensor:
    """One camera's scatter: packed tiles -> (H, W, A) ``base`` at (n, 2)
    tile coords, in place; returns ``base``."""
    if packed.shape[0] == 0:
        return base
    record_dispatch("sbnet_scatter")
    return _sbnet.sbnet_scatter(packed, idx, base)


def sbnet_scatter_changed(packed: torch.Tensor, idx: torch.Tensor,
                          base: torch.Tensor) -> torch.Tensor:
    """Changed-only scatter into the PERSISTENT head-map canvas ``base``
    (updated in place): ``packed``/``idx`` carry only this step's
    refreshed tiles; unchanged tiles keep the bytes the step that last
    computed them wrote."""
    if packed.shape[0] == 0:
        return base
    record_dispatch("sbnet_scatter_changed")
    return _sbnet.sbnet_scatter_fleet(packed, idx, base)


def tile_delta_gate_canvas(cur_p: torch.Tensor, ref_c: torch.Tensor,
                           idx: torch.Tensor, th: int, tw: int,
                           qstep: float = 8.0, coef_bits: int = COEF_BITS,
                           run_bits: int = RUN_BITS) -> torch.Tensor:
    """The reuse gate against a canvas-resident reference: (C, H+2, W+2,
    Cin) padded frames and reference canvas + (n, 3) rows -> (n,
    STATS_WIDTH) int32 stats rows.  Counted as ``tile_delta_gate``."""
    if idx.shape[0] == 0:
        return torch.zeros((0, STATS_WIDTH), dtype=torch.int32,
                           device=cur_p.device)
    record_dispatch("tile_delta_gate")
    return _tile_delta.tile_delta_gate_canvas(cur_p, ref_c, idx, th, tw,
                                              qstep, coef_bits, run_bits)


def tile_delta_gate(cur_p: torch.Tensor, ref_win: torch.Tensor,
                    idx: torch.Tensor, th: int, tw: int, qstep: float = 8.0,
                    coef_bits: int = COEF_BITS, run_bits: int = RUN_BITS):
    """The reuse gate against PACKED per-tile reference windows: (C, H+2,
    W+2, Cin) padded frames + (n, th+2, tw+2, Cin) reference windows + (n,
    3) rows -> (stats (n, STATS_WIDTH) int32, the current windows (n,
    th+2, tw+2, Cin)).  The same stats rows as ``tile_delta_gate_canvas``
    when the references hold the same content, and the same counter."""
    if idx.shape[0] == 0:
        return (torch.zeros((0, STATS_WIDTH), dtype=torch.int32,
                            device=cur_p.device), ref_win[:0].clone())
    record_dispatch("tile_delta_gate")
    return _tile_delta.tile_delta_gate(cur_p, ref_win, idx, th, tw, qstep,
                                       coef_bits, run_bits)


def gather_windows(xp: torch.Tensor, idx: torch.Tensor, th: int,
                   tw: int) -> torch.Tensor:
    """The packed (n, th+2, tw+2, Cin) haloed windows of the rows ``idx``
    on a zero-padded (C, H+2, W+2, Cin) canvas: the seed of the packed
    gate references.  Plain indexing, not a counted dispatch; warm steps
    advance the references from the gate's own windows output."""
    return _ref.gather_windows(xp, idx, th, tw)


def tile_delta(cur: torch.Tensor, prev: torch.Tensor, idx: torch.Tensor,
               th: int, tw: int, qstep: float = 8.0,
               coef_bits: int = COEF_BITS,
               run_bits: int = RUN_BITS) -> torch.Tensor:
    """The edge rate controller's per-tile delta stats: (H, W, C) frame
    pair + (n, 2) (ty, tx) rows -> (n, STATS_WIDTH) int32 rows ``[bytes,
    nnz, runs, sum|q|, 0...]``."""
    if idx.shape[0] == 0:
        return torch.zeros((0, STATS_WIDTH), dtype=torch.int32,
                           device=cur.device)
    record_dispatch("tile_delta")
    return _tile_delta.tile_delta(cur, prev, idx, th, tw, qstep, coef_bits,
                                  run_bits)


def tile_delta_halo(cur: torch.Tensor, prev: torch.Tensor,
                    idx: torch.Tensor, th: int, tw: int, qstep: float = 8.0,
                    coef_bits: int = COEF_BITS,
                    run_bits: int = RUN_BITS) -> torch.Tensor:
    """``tile_delta`` over each tile's edge ring (top and bottom rows, left
    and right columns, corners twice): the halo-first shedding feed."""
    if idx.shape[0] == 0:
        return torch.zeros((0, STATS_WIDTH), dtype=torch.int32,
                           device=cur.device)
    record_dispatch("tile_delta_halo")
    return _tile_delta.tile_delta_halo(cur, prev, idx, th, tw, qstep,
                                       coef_bits, run_bits)


def pack_tokens(x: torch.Tensor, keep: torch.Tensor, block: int = 128):
    """Pack the kept rows of (S, ...) ``x`` into a dense prefix padded to
    ``block``.  keep: (S,) bool.  Returns (packed (round_up(S, block),
    ...), positions (same length,) int32, n_kept int): the kept rows in
    their original order, then the dropped rows, then zero rows; positions
    hold the kept rows' original indices and ``PAD_POS`` everywhere else.
    The positions are monotone over real rows, the invariant the
    attention's causal block skip uses."""
    S = x.shape[0]
    Sp = -(-S // block) * block
    keep = keep.to(torch.bool)
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    n_kept = int(keep.sum())
    packed = x.new_zeros((Sp,) + tuple(x.shape[1:]))
    packed[:S] = x[order]
    positions = torch.full((Sp,), PAD_POS, dtype=torch.int32,
                           device=x.device)
    positions[:n_kept] = order[:n_kept].to(torch.int32)
    return packed, positions, n_kept


def unpack_tokens(packed: torch.Tensor, positions: torch.Tensor, S: int,
                  fill: float = 0.0) -> torch.Tensor:
    """Inverse of ``pack_tokens``: the real rows back to their original
    places of an (S, ...) tensor of ``fill``; padding rows are dropped."""
    out = packed.new_full((S,) + tuple(packed.shape[1:]), fill)
    real = positions < S
    out[positions[real].long()] = packed[real]
    return out


def roi_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, block_q: int = 128,
                  block_k: int = 128, causal_skip: bool = True,
                  return_stats: bool = False):
    """Packed-prefill attention over (S, H, D) with original-position
    causality; S must already be block-padded (``pack_tokens`` does
    this).  ``causal_skip`` bounds the k-block walk at the causal frontier
    (exact: real rows unchanged); ``return_stats`` also returns the (H, S
    // block_q) visited-k-block counts."""
    record_dispatch("roi_attention")
    out, visited = _roi_attention.roi_attention(q, k, v, positions, block_q,
                                                block_k, causal_skip)
    return (out, visited) if return_stats else out


def attention_visit_bound(positions: np.ndarray, block_q: int = 128,
                          block_k: int = 128) -> np.ndarray:
    """Host mirror of the attention's causal bound: visited k-blocks per
    q-block, (S // block_q,) int64, for FLOP accounting without a
    launch."""
    positions = np.asarray(positions)
    S = positions.shape[0]
    kmin = positions.reshape(S // block_k, block_k).min(axis=1)
    out = np.zeros(S // block_q, np.int64)
    for qi in range(S // block_q):
        pq = positions[qi * block_q:(qi + 1) * block_q]
        real = pq[pq != PAD_POS]
        if real.size == 0:
            continue
        hits = np.nonzero(kmin <= real.max())[0]
        out[qi] = 0 if hits.size == 0 else int(hits[-1]) + 1
    return out


__all__ = ["KERNEL_NAMES", "KERNEL_COUNTS", "record_dispatch",
           "count_kernels", "NEIGHBOR_OFFSETS", "COEF_BITS", "RUN_BITS",
           "STATS_WIDTH", "GATE_BODY_BYTES", "GATE_BODY_NNZ",
           "GATE_BODY_RUNS", "GATE_BODY_SABS", "GATE_WIN_EXACT",
           "GATE_WIN_BYTES", "mask_to_indices", "neighbor_table",
           "fleet_indices", "fleet_neighbor_table", "superlaunch_tables",
           "ShardPlan", "shard_plan", "dilate_changed", "reuse_sets", "compact_tables",
           "roi_conv_entry", "roi_conv_fleet", "roi_conv",
           "roi_conv_batched", "roi_conv_packed", "roi_conv_stack",
           "sbnet_gather", "sbnet_scatter", "sbnet_scatter_fleet",
           "sbnet_scatter_changed", "tile_delta_gate_canvas",
           "tile_delta_gate", "gather_windows", "tile_delta",
           "tile_delta_halo", "PAD_POS", "pack_tokens", "unpack_tokens",
           "roi_attention", "attention_visit_bound"]
