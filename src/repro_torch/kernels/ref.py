"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, in float32.  The tile
kernels' versions use elementwise tensor operations only: no cuDNN
convolution and no cuBLAS product, so ``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` cannot change a bit of them
on the card.  The attention's version takes its two products with
``torch.matmul`` in float32 (an elementwise (S, S, D) product would not
fit at the serving shapes); on the card its callers set
``allow_tf32 = False``.  The kernel wrappers use these for CPU tensors;
``chip_smoke.py`` holds every kernel against them on the card.

The 3x3 convolutions accumulate their taps in the kernels' fixed order
(``dy``, then ``dx``, then input channel ``ci``), one multiply and one add
per step.  Each output element is therefore a function of its own inputs
alone, whatever the number of tiles in the call -- the property the
threshold-0 reuse identity (a compact launch equals a full launch on the
tiles they share) rests on.
"""
from __future__ import annotations

from typing import Sequence

import torch


def tile_index(idx: torch.Tensor, th: int, tw: int, h: int, w: int):
    """(n, 3) (cam, ty, tx) rows -> broadcastable (cam, row, col) index
    tensors of shape (n, 1, 1), (n, h, 1), (n, 1, w) addressing the h x w
    block at (ty*th, tx*tw) of each row's camera plane."""
    idx = idx.long()
    rows = idx[:, 1:2] * th + torch.arange(h, device=idx.device)
    cols = idx[:, 2:3] * tw + torch.arange(w, device=idx.device)
    return idx[:, 0, None, None], rows[:, :, None], cols[:, None, :]


def gather_windows(xp: torch.Tensor, idx: torch.Tensor, th: int,
                   tw: int) -> torch.Tensor:
    """(C, H+2, W+2, Cin) padded planes + (n, 3) (cam, ty, tx) rows ->
    the (n, th+2, tw+2, Cin) haloed windows starting at (ty*th, tx*tw)."""
    return xp[tile_index(idx, th, tw, th + 2, tw + 2)]


def _quantize(cur: torch.Tensor, prev: torch.Tensor,
              qstep: float) -> torch.Tensor:
    """``round_half_even((cur - prev) / qstep)`` in float32, as int32.
    The cast saturates as XLA's and the card's do: NaN gives 0, a value at
    or past +-2^31 the int32 extreme on its side."""
    # a 0-dim tensor on the same device, not a Python scalar: CUDA turns
    # division by a host scalar into a multiply by its reciprocal, which
    # is not correctly rounded
    step = torch.tensor(qstep, dtype=torch.float32, device=cur.device)
    q = torch.round((cur - prev) / step).double()
    # float64 holds 2^31 - 1 exactly; the plain cast gives INT_MIN on x86
    return torch.nan_to_num(q, nan=0.0).clamp(-2 ** 31, 2 ** 31 - 1) \
        .to(torch.int32)


def _scan_stats(q: torch.Tensor):
    """(n, rows, lanes) int32 quantized deltas -> per-tile (nnz, runs,
    sum|q|) int64; a zero run never joins across scan rows."""
    z = q == 0
    nnz = (~z).sum(dim=(1, 2))
    left = torch.zeros_like(z)
    left[:, :, 1:] = z[:, :, :-1]
    runs = (z & ~left).sum(dim=(1, 2))
    return nnz, runs, q.abs().sum(dim=(1, 2), dtype=torch.int64)


def _stats_rows(nnz, runs, sabs, coef_bits: int,
                run_bits: int) -> torch.Tensor:
    """Per-tile (nnz, runs, sum|q|) -> (n, 8) int64 rows ``[bytes, nnz,
    runs, sum|q|, 0, 0, 0, 0]`` with ``bytes = ceil((nnz * coef_bits +
    runs * run_bits) / 8)``."""
    out = torch.zeros((nnz.shape[0], 8), dtype=torch.int64,
                      device=nnz.device)
    out[:, 0] = (nnz * coef_bits + runs * run_bits + 7) // 8
    out[:, 1] = nnz
    out[:, 2] = runs
    out[:, 3] = sabs
    return out


def _cam0(idx: torch.Tensor) -> torch.Tensor:
    """(n, 2) (ty, tx) rows -> (n, 3) rows of camera 0."""
    return torch.nn.functional.pad(idx, (1, 0))


def sbnet_gather(x: torch.Tensor, idx: torch.Tensor, th: int,
                 tw: int) -> torch.Tensor:
    """(H, W, C) frame + (n, 2) (ty, tx) rows -> the (n, th, tw, C) tiles
    at (ty*th, tx*tw)."""
    return x[None][tile_index(_cam0(idx), th, tw, th, tw)]


def tile_delta(cur: torch.Tensor, prev: torch.Tensor, idx: torch.Tensor,
               th: int, tw: int, qstep: float = 8.0, coef_bits: int = 6,
               run_bits: int = 10) -> torch.Tensor:
    """The edge rate controller's per-tile delta pricing.  cur, prev: (H,
    W, C) frames; idx: (n, 2) int32 (ty, tx).  Returns (n, 8) int32 rows
    ``[bytes, nnz, runs, sum|q|, 0, 0, 0, 0]``, q as in
    ``tile_delta_gate_canvas``; the scan rows are the th pixel rows of
    tw*C lanes."""
    n = idx.shape[0]
    q = _quantize(sbnet_gather(cur, idx, th, tw),
                  sbnet_gather(prev, idx, th, tw), qstep)
    return _stats_rows(*_scan_stats(q.reshape(n, th, -1)), coef_bits,
                       run_bits).to(torch.int32)


def tile_delta_halo(cur: torch.Tensor, prev: torch.Tensor,
                    idx: torch.Tensor, th: int, tw: int, qstep: float = 8.0,
                    coef_bits: int = 6, run_bits: int = 10) -> torch.Tensor:
    """``tile_delta`` over each tile's edge ring instead of its body: 4
    strips (top row, bottom row, left column, right column), each one
    scan row -- a column strip is its (th, C) slice flattened y-major,
    channel-minor -- so a zero run never joins across strips and the
    corners count twice.  Same (n, 8) row layout as ``tile_delta``."""
    n = idx.shape[0]
    q = _quantize(sbnet_gather(cur, idx, th, tw),
                  sbnet_gather(prev, idx, th, tw), qstep)
    nnz = runs = sabs = 0
    for strip in (q[:, 0], q[:, th - 1], q[:, :, 0], q[:, :, tw - 1]):
        a, b, c = _scan_stats(strip.reshape(n, 1, -1))
        nnz, runs, sabs = nnz + a, runs + b, sabs + c
    return _stats_rows(nnz, runs, sabs, coef_bits, run_bits) \
        .to(torch.int32)


def _gate_rows(cw: torch.Tensor, pw: torch.Tensor, th: int, tw: int,
               qstep: float, coef_bits: int, run_bits: int) -> torch.Tensor:
    """(n, th+2, tw+2, Cin) current and reference windows -> the gate's
    (n, 8) int32 stats rows (see ``tile_delta_gate_canvas``)."""
    n = cw.shape[0]
    q = _quantize(cw, pw, qstep)
    out = _stats_rows(*_scan_stats(q[:, 1:1 + th, 1:1 + tw]
                                   .reshape(n, th, -1)), coef_bits, run_bits)
    w_nnz, w_runs, _ = _scan_stats(q.reshape(n, th + 2, -1))
    out[:, 4] = (cw != pw).sum(dim=(1, 2, 3))
    out[:, 5] = (w_nnz * coef_bits + w_runs * run_bits + 7) // 8
    return out.to(torch.int32)


def tile_delta_gate_canvas(cur_p: torch.Tensor, ref_c: torch.Tensor,
                           idx: torch.Tensor, th: int, tw: int,
                           qstep: float = 8.0, coef_bits: int = 6,
                           run_bits: int = 10) -> torch.Tensor:
    """The reuse gate against a reference canvas.  cur_p, ref_c: (C, H+2,
    W+2, Cin) zero-padded planes; idx: (n, 3) int32 (cam, ty, tx).
    Returns (n, 8) int32 rows ``[body bytes, body nnz, body runs, body
    sum|q|, window exact-change count, window bytes, 0, 0]`` with
    ``q = round_half_even((cur - prev) / qstep)`` in float32.  Body scan
    rows are the th inner pixel rows (tw*Cin lanes), window scan rows the
    th+2 window rows ((tw+2)*Cin lanes)."""
    return _gate_rows(gather_windows(cur_p, idx, th, tw),
                      gather_windows(ref_c, idx, th, tw), th, tw, qstep,
                      coef_bits, run_bits)


def tile_delta_gate(cur_p: torch.Tensor, ref_win: torch.Tensor,
                    idx: torch.Tensor, th: int, tw: int, qstep: float = 8.0,
                    coef_bits: int = 6, run_bits: int = 10):
    """The reuse gate against PACKED per-tile reference windows: ref_win
    (n, th+2, tw+2, Cin) in place of a canvas, otherwise as
    ``tile_delta_gate_canvas``.  Returns (stats (n, 8) int32, the current
    windows (n, th+2, tw+2, Cin)) -- the rows a reference advance copies."""
    cw = gather_windows(cur_p, idx, th, tw)
    return _gate_rows(cw, ref_win, th, tw, qstep, coef_bits, run_bits), cw


def conv3x3_taps(win: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, h+2, w+2, Cin) haloed windows + (3, 3, Cin, Cout) HWIO weights
    -> (n, h, w, Cout) VALID 3x3 conv, taps accumulated in the fixed
    order dy, dx, ci (one rounded multiply, one rounded add each)."""
    n, hp, wp, cin = win.shape
    h, wd = hp - 2, wp - 2
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=torch.float32,
                      device=win.device)
    for dy in range(3):
        for dx in range(3):
            patch = win[:, dy:dy + h, dx:dx + wd, :]
            for ci in range(cin):
                acc += patch[..., ci:ci + 1] * w[dy, dx, ci]
    return acc


def roi_conv_fleet(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   th: int, tw: int) -> torch.Tensor:
    """Gather + 3x3 SAME conv on active tiles, no ReLU: x (C, H, W, Cin)
    stacked frames, w (3, 3, Cin, Cout), idx (n, 3) -> (n, th, tw, Cout).
    Pixels outside a camera's plane read as zero."""
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return conv3x3_taps(gather_windows(xp, idx, th, tw), w)


def roi_conv_entry(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   th: int, tw: int) -> torch.Tensor:
    """``roi_conv_fleet`` + ReLU: the fused backbone's entry layer."""
    return torch.relu(roi_conv_fleet(x, w, idx, th, tw))


def roi_conv(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, th: int,
             tw: int) -> torch.Tensor:
    """One camera's gather + 3x3 SAME conv, no ReLU: x (H, W, Cin) + (n, 2)
    (ty, tx) rows -> (n, th, tw, Cout); or B frames sharing the rows, x
    (B, H, W, Cin) -> (B, n, th, tw, Cout)."""
    if x.ndim == 3:
        return roi_conv(x[None], w, idx, th, tw)[0]
    B, n = x.shape[0], idx.shape[0]
    cams = torch.arange(B, dtype=idx.dtype, device=idx.device)
    rows = torch.cat([cams.repeat_interleave(n)[:, None], idx.repeat(B, 1)],
                     dim=1)
    out = roi_conv_fleet(x, w, rows, th, tw)
    return out.reshape((B, n) + tuple(out.shape[1:]))


def assemble_halo(packed: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """(n, th, tw, C) packed tiles + (n, 8) neighbour slots -> (n, th+2,
    tw+2, C) windows whose 1-pixel ring comes from the neighbours' edges,
    zero where the slot is -1.  Columns follow NEIGHBOR_OFFSETS: NW, N,
    NE, W, E, SW, S, SE."""
    n, th, tw, c = packed.shape
    ext = torch.cat([packed, packed.new_zeros((1, th, tw, c))])
    slot = torch.where(nbr >= 0, nbr, n).long()          # n = the zero tile
    win = packed.new_zeros((n, th + 2, tw + 2, c))
    win[:, 1:1 + th, 1:1 + tw] = packed
    win[:, 0, 0] = ext[slot[:, 0], th - 1, tw - 1]
    win[:, 0, 1:1 + tw] = ext[slot[:, 1], th - 1]
    win[:, 0, tw + 1] = ext[slot[:, 2], th - 1, 0]
    win[:, 1:1 + th, 0] = ext[slot[:, 3], :, tw - 1]
    win[:, 1:1 + th, tw + 1] = ext[slot[:, 4], :, 0]
    win[:, th + 1, 0] = ext[slot[:, 5], 0, tw - 1]
    win[:, th + 1, 1:1 + tw] = ext[slot[:, 6], 0]
    win[:, th + 1, tw + 1] = ext[slot[:, 7], 0, 0]
    return win


def roi_conv_packed(packed: torch.Tensor, w: torch.Tensor,
                    nbr: torch.Tensor) -> torch.Tensor:
    """One packed layer, no ReLU: each tile's halo from its neighbours
    (zero at -1 slots), 3x3 conv -- equal to scattering onto zeros, a
    SAME conv and a gather."""
    return conv3x3_taps(assemble_halo(packed, nbr), w)


def roi_conv_stack(packed: torch.Tensor, ws: Sequence[torch.Tensor],
                   nbr: torch.Tensor) -> torch.Tensor:
    """Every later layer over the packed tensor: ``roi_conv_packed`` +
    ReLU per layer."""
    for w in ws:
        packed = torch.relu(roi_conv_packed(packed, w, nbr))
    return packed


def sbnet_scatter_fleet(packed: torch.Tensor, idx: torch.Tensor,
                        base: torch.Tensor) -> torch.Tensor:
    """Write (n, th, tw, A) tiles into ``base`` (C, H, W, A) at (cam,
    ty*th, tx*tw), in place; returns ``base``.  Repeated rows carry the
    same tile and rewrite the same bytes."""
    _, th, tw, _ = packed.shape
    base[tile_index(idx, th, tw, th, tw)] = packed
    return base


def sbnet_scatter(packed: torch.Tensor, idx: torch.Tensor,
                  base: torch.Tensor) -> torch.Tensor:
    """One camera's scatter: (n, th, tw, C) tiles into ``base`` (H, W, C)
    at (ty*th, tx*tw) for (n, 2) (ty, tx) rows, in place; returns
    ``base``."""
    sbnet_scatter_fleet(packed, _cam0(idx), base[None])
    return base


def roi_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, block_q: int = 128,
                  block_k: int = 128, causal_skip: bool = True,
                  scale: float | None = None):
    """RoI-packed attention: q, k, v (S, H, D) packed tokens, positions (S,)
    int32 original positions (``PAD_POS`` on padding rows).  Query i
    attends key j iff positions[i] >= positions[j], as the JAX package's
    ``ref.roi_attention`` computes it: float32 logits scaled by ``scale``
    (default 1/sqrt(D); ``pad_head_dim`` gives the unpadded D's for
    zero-padded inputs), masked to -1e30, a softmax over each whole row,
    in q's dtype.  Like the kernel, a q-block attends only the k-blocks below its
    visit bound ``hi`` (every k-block without ``causal_skip``), and a
    q-block with ``hi == 0`` -- no real row -- gives zeros; real rows are
    unchanged by either rule.  Returns (out, visited (H, S // block_q)
    int32 the ``hi`` of each q-block).  One head's (S, S) logits at a
    time."""
    from repro_torch.kernels.roi_attention import visit_bounds
    S, H, D = q.shape
    dev = q.device
    nq = S // block_q
    hi = visit_bounds(positions, block_q, block_k, causal_skip)
    hi_row = hi.repeat_interleave(block_q)
    kblock = torch.arange(S, device=dev) // block_k
    visible = (positions[:, None] >= positions[None, :]) \
        & (kblock[None, :] < hi_row[:, None])
    if scale is None:
        scale = 1.0 / D ** 0.5
    out = torch.empty((S, H, D), dtype=torch.float32, device=dev)
    for h in range(H):
        logits = (q[:, h].float() @ k[:, h].float().T) * scale
        logits.masked_fill_(~visible, -1e30)
        p = (logits - logits.amax(dim=1, keepdim=True)).exp_()
        del logits
        denom = p.sum(dim=1, keepdim=True).clamp_min_(1e-30)
        out[:, h] = p.div_(denom) @ v[:, h].float()
        del p
    out[hi_row == 0] = 0.0
    visited = hi.to(torch.int32)[None].expand(H, nq).contiguous()
    return out.to(q.dtype), visited
