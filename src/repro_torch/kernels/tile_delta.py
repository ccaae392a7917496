"""The reuse gate's delta pricing (CUDA kernel ``csrc/tile_delta_gate.cu``).

The temporal reuse gate must know whether a tile's entry-layer input
changed: the (th+2, tw+2) haloed window the entry conv reads, not only the
(th, tw) body -- a pixel flip in an inactive neighbour changes an active
tile's conv output through the 1-pixel halo.  One launch prices both views
per tile: the body stats (cols 0..3) for the edge rate controller and the
window stats (cols 4..5) for the gate.
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
    if 4 * (th + 2) * (tw + 2) * Cin > 48 * 1024:
        raise ValueError(f"{name}: a {th}x{tw}x{Cin} tile window does not "
                         f"fit the kernel's 48 KB of shared memory")
    n = idx.shape[0]
    out = torch.empty((n, STATS_WIDTH), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.tile_delta_gate_canvas_launch(
            cur_p.data_ptr(), ref_c.data_ptr(), idx.data_ptr(),
            out.data_ptr(), n, C, Hp, Wp, Cin, th, tw, float(qstep),
            int(coef_bits), int(run_bits), _build.stream_handle(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
