"""Per-segment RoI packetization + backlog-driven rate control: the port's
own copy of the JAX package's ``repro/net/encoder.py``.

Packetization decomposes the codec model's per-camera segment cost
(``area * rho * act * (1 + k/sqrt(area)) + header``)
into the three components the transport layer treats differently:

* **body**  — ``area * rho * act`` bytes: the RoI content itself,
* **halo**  — the ``k / sqrt(area)`` boundary-amplification surcharge:
  bytes that exist only because tile rectangles are encoded independently,
* **header** — per-rectangle container overhead, charged only on segments
  that ship at least one frame, and only for cameras with a nonzero mask.

Everything is evaluated as (cameras, segments) matrices in one pass; the
matrices sum to the segment's whole wire load.

The **rate controller** is the edge's response to uplink backlog: when a
camera's FIFO queue wait exceeds the trigger, it sheds quality on the
*sheddable* byte mass — the halo surcharge plus the body bytes sitting in
temporally-static tiles.  Which tiles are static comes from the
``tile_delta`` CUDA kernel (``kernels/csrc/tile_delta.cu``): per-tile
quantized-delta zero-run byte estimates, computed on the card
(``tile_static_fraction``), or read off the fleet step's own gate stats
with no launch at all (``static_fraction_from_stats``).  Control is causal
— segment ``s`` reacts to the backlog left by segment ``s-1`` — so the
evolution is a single scan over segments, vectorized across all cameras.

The packetization and the rate controller are numpy, as in the JAX
package; only the fractions touch tensors: on a CUDA frame's own device,
else on the card, and on the CPU only when the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# packetization: (cameras, segments) byte matrices
# ---------------------------------------------------------------------------

@dataclass
class CameraCoefficients:
    """Per-camera per-(activity*frame) byte coefficients of the codec
    model, split into transport classes.  ``has_mask`` marks cameras with
    at least one positive-area rectangle — empty-mask cameras ship
    nothing: no body, no halo, no headers, no frames."""
    body: np.ndarray          # (C,) area * rho summed over rectangles
    halo: np.ndarray          # (C,) boundary surcharge (k/sqrt(area) term)
    headers: np.ndarray       # (C,) container bytes per shipped segment
    has_mask: np.ndarray      # (C,) bool

    @property
    def per_frame(self) -> np.ndarray:
        return self.body + self.halo


def camera_coefficients(cameras: Sequence, cam_groups, codec
                        ) -> CameraCoefficients:
    """``codec`` duck-types CodecModel (boundary_k, rho, header_bytes)."""
    C = len(cameras)
    body = np.zeros(C)
    halo = np.zeros(C)
    headers = np.zeros(C)
    has = np.zeros(C, bool)
    for ci, c in enumerate(cameras):
        cid = c.cam_id
        areas = []
        for g in cam_groups[cid]:
            x0, y0 = g.x0 * c.tile, g.y0 * c.tile
            areas.append(min(g.w * c.tile, c.width - x0)
                         * min(g.h * c.tile, c.height - y0))
        areas = np.asarray(areas, np.float64)
        pos = areas > 0
        if not pos.any():
            continue
        k, rho = codec.boundary_k[cid], codec.rho[cid]
        body[ci] = float(np.sum(areas[pos] * rho))
        halo[ci] = float(np.sum(areas[pos] * rho * k / np.sqrt(areas[pos])))
        headers[ci] = codec.header_bytes * int(np.count_nonzero(pos))
        has[ci] = True
    return CameraCoefficients(body, halo, headers, has)


def sent_matrix(cameras: Sequence, coef: CameraCoefficients, keep,
                n_segs: int, frames_per_seg: int) -> np.ndarray:
    """(C, S) int64 frames shipped per camera per segment: the Reducto
    keep masks folded per segment, zeroed for empty-mask cameras (a
    camera with no RoI rectangles streams nothing at all)."""
    C = len(cameras)
    win = n_segs * frames_per_seg
    sent = np.full((C, n_segs), frames_per_seg, np.int64)
    if keep is not None:
        for ci, c in enumerate(cameras):
            km = np.zeros(win, bool)
            src = np.asarray(keep[c.cam_id], bool)[:win]
            km[:src.shape[0]] = src
            sent[ci] = km.reshape(n_segs, frames_per_seg).sum(axis=1)
    sent[~coef.has_mask] = 0
    return sent


def zero_safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num/den with 0 bytes taking 0 time regardless of the bandwidth
    (zero for empty-mask cameras / fully filtered segments, infinite in
    the uncongested limit) — the one shared transmit-time rule for the
    whole transport layer."""
    with np.errstate(divide="ignore", invalid="ignore"):
        out = num / den
    return np.where(num > 0, out, 0.0)


def activity(sent: np.ndarray) -> np.ndarray:
    """Per-segment compression activity: longer shipped runs compress
    better (same law as the analytic model)."""
    return 1.0 / np.sqrt(np.maximum(sent, 1) / 10.0) * 0.9 + 0.1


def segment_byte_matrices(coef: CameraCoefficients, sent: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(body, halo, headers) (C, S) byte matrices; their sum is the wire
    load of the un-shed stream."""
    act_sent = activity(sent) * sent
    shipped = sent > 0
    body = coef.body[:, None] * act_sent
    halo = coef.halo[:, None] * act_sent
    headers = coef.headers[:, None] * shipped
    return body, halo, headers


# ---------------------------------------------------------------------------
# rate control: shed halo/static-tile quality under backlog
# ---------------------------------------------------------------------------

@dataclass
class RateControlConfig:
    enabled: bool = False
    backlog_trigger_s: float = 0.25   # queue wait that starts shedding
    gain: float = 2.0                 # quality drop per second over trigger
    min_quality: float = 0.35         # floor on the shed multiplier
    # fraction of each camera's body bytes sitting in temporally-static
    # tiles (sheddable without touching moving content); scalar or (C,).
    # Calibrate with ``tile_static_fraction`` (the tile_delta kernel).
    static_fraction: float | np.ndarray = 0.0
    # fraction of each camera's HALO bytes whose boundary rings are
    # temporally static; scalar or (C,).  Calibrate with
    # ``tile_halo_static_fraction`` (the tile_delta_halo kernel).  Halo
    # mass is shed FIRST — boundary-duplication bytes go before any body
    # row does (1.0 = the legacy all-halo-sheddable behavior).
    halo_static_fraction: float | np.ndarray = 1.0


def rate_controlled_departures(arrivals: np.ndarray, body: np.ndarray,
                               halo: np.ndarray, headers: np.ndarray,
                               bw: np.ndarray, rc: RateControlConfig,
                               start_floor: np.ndarray = None
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray,
                                          np.ndarray]:
    """Causal quality control + FIFO queue in one scan over segments.

    Per segment the controller sees the backlog the previous segment left
    on each camera's link (``dep[s-1] - arrival[s]``), drops quality
    linearly past the trigger, and sheds ``(1 - quality)`` of the
    sheddable mass ``halo_static_fraction * halo + static_fraction *
    body`` — halo-ring bytes first, static body rows only once a
    segment's sheddable halo is exhausted.  Returns (departures (C, S),
    bytes_out (C, S), quality (C, S), shed_halo (C, S), shed_body
    (C, S)).

    ``start_floor`` (optional, (C, S)) is the outage-effective service
    floor from ``links.outage_effective``: a segment cannot *start*
    transmitting before it (the link is down until then).  Backlog is
    still measured against the original ``arrivals``, so the controller
    keeps shedding through the outage — the desired degraded behavior.
    ``None`` (the default) is bit-identical to the pre-outage code."""
    C, S = body.shape
    static = np.broadcast_to(np.asarray(rc.static_fraction, np.float64),
                             (C,))
    halo_static = np.broadcast_to(
        np.asarray(rc.halo_static_fraction, np.float64), (C,))
    shed_h_max = halo_static[:, None] * halo
    sheddable = shed_h_max + static[:, None] * body
    base = body + halo + headers
    dep = np.zeros((C, S))
    bytes_out = np.zeros((C, S))
    quality = np.ones((C, S))
    shed_halo = np.zeros((C, S))
    shed_body = np.zeros((C, S))
    prev_dep = np.full(C, -np.inf)
    for s in range(S):
        backlog = np.maximum(prev_dep - arrivals[:, s], 0.0)
        q = np.clip(1.0 - rc.gain
                    * np.maximum(backlog - rc.backlog_trigger_s, 0.0),
                    rc.min_quality, 1.0)
        shed = (1.0 - q) * sheddable[:, s]
        sh = np.minimum(shed, shed_h_max[:, s])   # halo rows go first
        b = base[:, s] - shed
        tx = zero_safe_div(b, bw[:, s])
        start = np.maximum(arrivals[:, s], prev_dep)
        if start_floor is not None:
            start = np.maximum(start, start_floor[:, s])
        prev_dep = start + tx
        dep[:, s] = prev_dep
        bytes_out[:, s] = b
        quality[:, s] = q
        shed_halo[:, s] = sh
        shed_body[:, s] = shed - sh
    return dep, bytes_out, quality, shed_halo, shed_body


# ---------------------------------------------------------------------------
# on-device static-tile estimation (the tile_delta kernel's consumer)
# ---------------------------------------------------------------------------

def static_fraction_from_stats(stats, n_channels: int, tile: int,
                               static_ratio: float = 0.10,
                              device=None) -> float:
    """Body-byte static fraction from PRECOMPUTED delta stats rows —
    the zero-dispatch half of the shared-pricing contract.  ``stats`` is
    any (n, STATS_WIDTH) row block whose col 0 is the body byte estimate:
    ``tile_delta`` output, or the fleet step's ``tile_delta_gate`` output
    (``ReuseStats.gate_stats``, whose body cols are bit-identical), or a
    per-camera slice of either.  No kernel launch happens here, so the
    reuse gate and the rate controller share ONE delta dispatch per
    step."""
    stats = _host(stats)
    if stats.shape[0] == 0:
        return 0.0
    dense_bytes = tile * tile * n_channels * kops.COEF_BITS / 8.0
    return float(np.mean(stats[:, 0] <= static_ratio * dense_bytes))


def gate_threshold_schedule(quality, tile: int, n_channels: int,
                            base_threshold: float = 0.0,
                            gain: float = 0.05,
                            halo_gain: Optional[float] = None) -> np.ndarray:
    """Per-camera ``tile_delta_gate`` thresholds from the rate
    controller's quality trace — the server-side half of shedding: a
    camera the uplink is ALREADY degrading (quality < 1) gets a raised
    reuse-gate byte threshold, so near-static tiles on congested cameras
    stop re-convolving before pristine cameras give up any freshness.

    quality: (C,) or (C, S) from ``rate_controlled_departures`` (a
    (C, S) trace is reduced with min over segments — the worst observed
    congestion governs).  Returns (C,) thresholds in BYTES against the
    gate's quantized window estimate (``GATE_WIN_BYTES``):
    ``base + gain * (1 - quality) * dense_tile_bytes``.  An unshedded
    camera (quality 1.0) keeps ``base_threshold`` — at the default 0.0
    that is the EXACT gate, so the schedule can only relax cameras the
    controller already sheds; the reuse bench asserts the resulting
    head-map accuracy floor.

    halo_gain: opt-in per-tile-class schedule — when given, returns
    (C, N_TILE_CLASSES) with column 0 (BODY: interior tiles, all eight
    neighbors inside the RoI) using ``gain`` and column 1 (HALO:
    boundary tiles) using ``halo_gain``.  Halo tiles sit where the
    cross-camera RoI masks meet; a ``halo_gain`` BELOW ``gain`` keeps
    boundary content fresher than interiors under the same shedding
    (the usual choice — detection targets cross tile borders), a higher
    one sheds borders first.  The gate consumes either shape unchanged
    (``gate_changed_rows`` / ``ref_advance_rows`` broadcast 2-D
    thresholds per tile class)."""
    q = np.asarray(quality, np.float64)
    if q.ndim == 2:
        q = q.min(axis=1)
    dense_bytes = tile * tile * n_channels * kops.COEF_BITS / 8.0
    shed = (1.0 - q) * dense_bytes
    if halo_gain is None:
        return base_threshold + gain * shed
    return base_threshold + np.stack([gain * shed, halo_gain * shed],
                                     axis=1)


def _host(stats) -> np.ndarray:
    """Stats rows as a host numpy array (a tensor on any device, or an
    array)."""
    if isinstance(stats, torch.Tensor):
        return stats.cpu().numpy()
    return np.asarray(stats)


def _frames_device(cur, device=None) -> torch.device:
    """The device the fractions run on: ``device`` when given, else a CUDA
    frame's own device, else the card (``resolve_device``): numpy or CPU
    frames run on the CPU only when the caller asks for it."""
    if device is None and isinstance(cur, torch.Tensor) and cur.is_cuda:
        return cur.device
    return resolve_device(device)


def pad_to_grid(cur, prev, grid_shape, tile: int, device=None):
    """The frame pair as float32 tensors on ``_frames_device(cur, device)``,
    zero-padded at the bottom and right to cover the grid's extent (grid
    shape x tile), as the fleet step places a frame on its canvas: a
    partial tile at the frame's edge is priced with its missing pixels at
    zero."""
    dev = _frames_device(cur, device)
    cur = torch.as_tensor(cur, dtype=torch.float32, device=dev)
    prev = torch.as_tensor(prev, dtype=torch.float32, device=dev)
    h = max(cur.shape[0], grid_shape[0] * tile)
    w = max(cur.shape[1], grid_shape[1] * tile)
    pad = (0, 0, 0, w - cur.shape[1], 0, h - cur.shape[0])
    return (torch.nn.functional.pad(cur, pad).contiguous(),
            torch.nn.functional.pad(prev, pad).contiguous())


def _tile_rows(grid: np.ndarray, device) -> torch.Tensor:
    """Bool (ty, tx) grid -> (n, 2) int32 active-tile rows on ``device``."""
    return torch.as_tensor(kops.mask_to_indices(grid), device=device)


def tile_static_fraction(cur, prev, grid: np.ndarray, tile: int,
                         qstep: float = 8.0, static_ratio: float = 0.10,
                         stats=None, device=None) -> float:
    """Fraction of a camera's RoI tiles whose quantized temporal delta
    prices below ``static_ratio`` of the dense tile cost — the
    ``static_fraction`` feed for the rate controller.  One ``tile_delta``
    kernel launch per call (observable in
    ``ops.KERNEL_COUNTS``) — UNLESS ``stats`` carries precomputed rows
    (e.g. the fleet reuse gate's shared ``tile_delta_gate`` output), in
    which case no kernel is dispatched at all.

    ``cur``/``prev``: (H, W, C) frames, numpy or tensors, priced on
    ``device`` (default: a CUDA frame's own device, else the card; pass
    ``device="cpu"`` for the plain version).  A grid whose
    extent passes the frame's edge (1080-px frames on a 68-row grid of
    16-px tiles) is priced on the frames zero-padded to that extent
    (``pad_to_grid``), so every tile is whole and its row equals the
    fleet gate's body columns for the same camera."""
    C = cur.shape[-1]
    if stats is not None:
        return static_fraction_from_stats(stats, C, tile,
                                          static_ratio=static_ratio)
    grid = np.asarray(grid, bool)
    cur, prev = pad_to_grid(cur, prev, grid.shape, tile, device)
    idx = _tile_rows(grid, cur.device)
    if idx.shape[0] == 0:
        return 0.0
    stats = _host(kops.tile_delta(cur, prev, idx, tile, tile, qstep=qstep))
    dense_bytes = tile * tile * C * kops.COEF_BITS / 8.0
    return float(np.mean(stats[:, 0] <= static_ratio * dense_bytes))


def tile_halo_static_fraction(cur, prev, grid: np.ndarray, tile: int,
                              qstep: float = 8.0,
                              static_ratio: float = 0.10,
                              device=None) -> float:
    """Fraction of a camera's RoI tiles whose HALO RING (the duplicated
    boundary pixels behind the codec's ``k/sqrt(area)`` surcharge) prices
    below ``static_ratio`` of the dense ring cost — the
    ``halo_static_fraction`` feed for the rate controller, letting it
    shed static halo rows before it touches whole tiles.  One
    ``tile_delta_halo`` kernel launch per call; frames are placed on
    ``device`` and padded as in ``tile_static_fraction``."""
    grid = np.asarray(grid, bool)
    cur, prev = pad_to_grid(cur, prev, grid.shape, tile, device)
    idx = _tile_rows(grid, cur.device)
    if idx.shape[0] == 0:
        return 0.0
    stats = _host(kops.tile_delta_halo(cur, prev, idx, tile, tile,
                                       qstep=qstep))
    C = cur.shape[-1]
    ring_px = 2 * tile + 2 * tile          # 2 rows + 2 cols (corners 2x)
    dense_bytes = ring_px * C * kops.COEF_BITS / 8.0
    return float(np.mean(stats[:, 0] <= static_ratio * dense_bytes))
