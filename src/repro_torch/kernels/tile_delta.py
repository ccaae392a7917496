"""Per-tile delta pricing: the reuse gate (CUDA kernels in
``csrc/tile_delta_gate.cu``) and the edge rate controller's tile and halo
pricing (``csrc/tile_delta.cu``).

The temporal reuse gate must know whether a tile's entry-layer input
changed: the (th+2, tw+2) haloed window the entry conv reads, not only the
(th, tw) body -- a pixel flip in an inactive neighbour changes an active
tile's conv output through the 1-pixel halo.  One launch prices both views
per tile: the body stats (cols 0..3) for the edge rate controller and the
window stats (cols 4..5) for the gate.  The gate's reference is a canvas
(``tile_delta_gate_canvas``) or packed per-tile windows
(``tile_delta_gate``).  ``tile_delta`` and ``tile_delta_halo`` price one
camera's frame pair, body or edge ring, for the rate controller.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# entropy-coder token prices (bits): a nonzero coefficient token and a
# zero-run token -- calibration constants of the byte estimate
COEF_BITS = 6
RUN_BITS = 10

STATS_WIDTH = 8          # stats row width; cols 6..7 are zero

# stats-row columns: cols 0..3 the BODY stats, cols 4..5 the HALOED-WINDOW
# stats the reuse gate thresholds
GATE_BODY_BYTES = 0
GATE_BODY_NNZ = 1
GATE_BODY_RUNS = 2
GATE_BODY_SABS = 3
GATE_WIN_EXACT = 4       # exact count of (th+2, tw+2, C) positions that
#                          differ -- the threshold-0 gate signal
GATE_WIN_BYTES = 5       # quantized zero-run byte estimate of the window

# the extents (Cin, th, tw) of the compiled-in instances of the gate kernel
# and of B10's and B11's kernels
GATE_DETECTOR = (3, 16, 16)


def gate_route(Cin: int, th: int, tw: int, Wp: int, *addresses: int) -> str:
    """The instance of ``csrc/tile_delta_gate.cu``'s kernel that runs on
    padded frames ``Wp`` pixels wide whose tensors start at bytes
    ``addresses`` (the frames and the reference; in packed mode the windows
    output as well): ``"detector"`` (compiled-in extents, 8-byte loads) for
    the detector's (Cin, th, tw) when a padded frame row is an even number
    of floats and every tensor starts on an 8-byte boundary, else
    ``"generic"`` (runtime extents, 4-byte loads).  Both give the same
    bits.  The launchers apply the same rule; the library's
    ``tile_delta_gate_route`` reports their choice."""
    if ((Cin, th, tw) == GATE_DETECTOR and (Wp * Cin) % 2 == 0
            and all(a % 8 == 0 for a in addresses)):
        return "detector"
    return "generic"


def delta_route(C: int, th: int, tw: int, W: int, *addresses: int) -> str:
    """The instance of ``csrc/tile_delta.cu``'s kernels (B10, B11) that
    runs on (H, W, C) frames starting at bytes ``addresses``: the gate's
    rule (``gate_route``) with the frame row in place of the padded one --
    ``"detector"`` for the detector's (C, th, tw) when a frame row is an
    even number of floats and both frames start on an 8-byte boundary, else
    ``"generic"``.  Both give the same bits.  The launchers apply the same
    rule; the library's ``tile_delta_route`` reports their choice."""
    return gate_route(C, th, tw, W, *addresses)


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """Launch ``fn`` on ``dev``'s current stream; raise on a CUDA error and
    count the launch."""
    with torch.cuda.device(dev):
        err = fn(*args, _build.stream_handle(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1


def tile_delta_gate_canvas(cur_p: torch.Tensor, ref_c: torch.Tensor,
                           idx: torch.Tensor, th: int, tw: int,
                           qstep: float = 8.0, coef_bits: int = COEF_BITS,
                           run_bits: int = RUN_BITS) -> torch.Tensor:
    """cur_p, ref_c: (C, H+2, W+2, Cin) float32 zero-padded current frames
    and reference canvas; idx: (n, 3) int32 (cam, ty, tx).  Returns (n,
    STATS_WIDTH) int32 stats rows (see ``ref.tile_delta_gate_canvas``).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if cur_p.device.type == "cpu":
        return ref.tile_delta_gate_canvas(cur_p, ref_c, idx, th, tw, qstep,
                                          coef_bits, run_bits)
    name = "tile_delta_gate_canvas"
    dev = _build.cuda_device(name, cur_p, ref_c, idx)
    _build.expect(name, "cur_p", cur_p, torch.float32, (None,) * 4)
    _build.expect(name, "ref_c", ref_c, torch.float32, tuple(cur_p.shape))
    _build.expect(name, "idx", idx, torch.int32, (None, 3))
    C, Hp, Wp, Cin = cur_p.shape
    n = idx.shape[0]
    out = torch.empty((n, STATS_WIDTH), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    _launch(name, dev, _build.library().tile_delta_gate_canvas_launch,
            cur_p.data_ptr(), ref_c.data_ptr(), idx.data_ptr(),
            out.data_ptr(), n, C, Hp, Wp, Cin, th, tw, float(qstep),
            int(coef_bits), int(run_bits))
    return out


def tile_delta_gate(cur_p: torch.Tensor, ref_win: torch.Tensor,
                    idx: torch.Tensor, th: int, tw: int, qstep: float = 8.0,
                    coef_bits: int = COEF_BITS, run_bits: int = RUN_BITS):
    """cur_p: (C, H+2, W+2, Cin) float32 zero-padded current frames;
    ref_win: (n, th+2, tw+2, Cin) float32 packed per-tile reference
    windows; idx: (n, 3) int32 (cam, ty, tx).  Returns (stats (n,
    STATS_WIDTH) int32, windows (n, th+2, tw+2, Cin) float32 -- the current
    windows), see ``ref.tile_delta_gate``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if cur_p.device.type == "cpu":
        return ref.tile_delta_gate(cur_p, ref_win, idx, th, tw, qstep,
                                   coef_bits, run_bits)
    name = "tile_delta_gate"
    dev = _build.cuda_device(name, cur_p, ref_win, idx)
    _build.expect(name, "cur_p", cur_p, torch.float32, (None,) * 4)
    C, Hp, Wp, Cin = cur_p.shape
    _build.expect(name, "idx", idx, torch.int32, (None, 3))
    n = idx.shape[0]
    _build.expect(name, "ref_win", ref_win, torch.float32,
                  (n, th + 2, tw + 2, Cin))
    out = torch.empty((n, STATS_WIDTH), dtype=torch.int32, device=dev)
    win = torch.empty_like(ref_win)
    if n == 0:
        return out, win
    _launch(name, dev, _build.library().tile_delta_gate_launch,
            cur_p.data_ptr(), ref_win.data_ptr(), idx.data_ptr(),
            out.data_ptr(), win.data_ptr(), n, C, Hp, Wp, Cin, th, tw,
            float(qstep), int(coef_bits), int(run_bits))
    return out, win


def _frame_pair_stats(name: str, fn, cur, prev, idx, th, tw, qstep,
                      coef_bits, run_bits) -> torch.Tensor:
    """The launcher shared by ``tile_delta`` and ``tile_delta_halo``:
    (H, W, C) float32 frames + (n, 2) int32 (ty, tx) rows -> (n,
    STATS_WIDTH) int32.  A tile of any extent fits: the kernels keep no
    tile in shared memory."""
    dev = _build.cuda_device(name, cur, prev, idx)
    _build.expect(name, "cur", cur, torch.float32, (None,) * 3)
    _build.expect(name, "prev", prev, torch.float32, tuple(cur.shape))
    _build.expect(name, "idx", idx, torch.int32, (None, 2))
    if th < 1 or tw < 1:
        raise ValueError(f"{name}: a {th}x{tw} tile has no pixels")
    H, W, C = cur.shape
    n = idx.shape[0]
    out = torch.empty((n, STATS_WIDTH), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    _launch(name, dev, fn(_build.library()), cur.data_ptr(),
            prev.data_ptr(), idx.data_ptr(), out.data_ptr(), n, H, W, C, th,
            tw, float(qstep), int(coef_bits), int(run_bits))
    return out


def tile_delta(cur: torch.Tensor, prev: torch.Tensor, idx: torch.Tensor,
               th: int, tw: int, qstep: float = 8.0,
               coef_bits: int = COEF_BITS,
               run_bits: int = RUN_BITS) -> torch.Tensor:
    """cur, prev: (H, W, C) float32 frames holding every tile of ``idx``
    whole; idx: (n, 2) int32 (ty, tx).  Returns (n, STATS_WIDTH) int32 body
    stats rows (see ``ref.tile_delta``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if cur.device.type == "cpu":
        return ref.tile_delta(cur, prev, idx, th, tw, qstep, coef_bits,
                              run_bits)
    return _frame_pair_stats("tile_delta", lambda lib: lib.tile_delta_launch,
                             cur, prev, idx, th, tw, qstep, coef_bits,
                             run_bits)


def tile_delta_halo(cur: torch.Tensor, prev: torch.Tensor,
                    idx: torch.Tensor, th: int, tw: int, qstep: float = 8.0,
                    coef_bits: int = COEF_BITS,
                    run_bits: int = RUN_BITS) -> torch.Tensor:
    """As ``tile_delta`` over each tile's edge ring (see
    ``ref.tile_delta_halo``).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if cur.device.type == "cpu":
        return ref.tile_delta_halo(cur, prev, idx, th, tw, qstep, coef_bits,
                                   run_bits)
    return _frame_pair_stats("tile_delta_halo",
                             lambda lib: lib.tile_delta_halo_launch, cur,
                             prev, idx, th, tw, qstep, coef_bits, run_bits)
