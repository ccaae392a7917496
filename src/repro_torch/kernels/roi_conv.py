"""RoI-sparse 3x3 convolution: the fused backbone and the per-layer chain.

``csrc/roi_conv_entry.cu`` holds the gather + 3x3 SAME conv family, read
straight off the frames on the active tiles only: ``roi_conv_entry`` (the
fused backbone's entry, with ReLU), ``roi_conv_fleet`` (the per-layer
chain's entry, without) and ``roi_conv`` (one camera's (ty, tx) rows, or
a batch of frames sharing them), each by the detector's compiled-in
instance or the generic one (``entry_route``).  The layers over the
packed tiles, each tile's halo coming from its neighbours through the
(n, 8) neighbour table, run on one layer body
(``csrc/roi_conv_layer.cuh``): ``roi_conv_stack`` runs every later layer,
each with its ReLU, in one launch (by the ring route of
``csrc/roi_conv_stack.cu``, or past its depth layer by layer,
``csrc/roi_conv_layers.cu``: ``stack_route``), and ``roi_conv_packed`` is
one later layer without the ReLU (the ring route at one layer).  All
accumulate their taps in the same fixed order, so the fused stack and the
per-layer chain give the same bits.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build, ref

# neighbour-table column order: (dy, dx) offsets of the 8 surrounding tiles
NEIGHBOR_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                    (0, 1), (1, -1), (1, 0), (1, 1))

_SMEM_LIMIT = 227 * 1024          # shared memory one H100 CTA may hold
RING_MAX_LAYERS = 8               # the ring route's depth (kMaxLayers)


# the extents (Cin, Cout, th, tw) of the entry kernel's compiled-in instance
ENTRY_DETECTOR = (3, 8, 16, 16)


def entry_route(Cin: int, Cout: int, th: int, tw: int, W: int,
                address: int) -> str:
    """The instance of ``csrc/roi_conv_entry.cu``'s kernel that runs on
    frames of width ``W`` whose data start at byte ``address``:
    ``"detector"`` (compiled-in extents, 16-byte window copies) for the
    detector's (Cin, Cout, th, tw) when a frame row is whole 16-byte
    vectors (W * Cin a multiple of 4) and the frames start on a 16-byte
    boundary, else ``"generic"`` (runtime extents, 4-byte copies).  Both
    give the same bits.  The launchers apply the same rule; the library's
    ``roi_conv_entry_route`` reports their choice."""
    if ((Cin, Cout, th, tw) == ENTRY_DETECTOR and (W * Cin) % 4 == 0
            and address % 16 == 0):
        return "detector"
    return "generic"


def _gather_conv(name: str, launch, x: torch.Tensor, w: torch.Tensor,
                 idx: torch.Tensor, th: int, tw: int,
                 cols: int) -> torch.Tensor:
    """Launch one instance of ``csrc/roi_conv_entry.cu``'s kernel, chosen
    by ``launch(lib)``, on x (C, H, W, Cin) frames.  With ``cols`` = 3
    each (cam, ty, tx) row names its frame and the output is (n, th, tw,
    Cout); with ``cols`` = 2 the C frames share the (ty, tx) rows and the
    output is (C * n, th, tw, Cout), frame-major."""
    dev = _build.cuda_device(name, x, w, idx)
    _build.expect(name, "x", x, torch.float32, (None,) * 4)
    C, H, W, Cin = x.shape
    _build.expect(name, "w", w, torch.float32, (3, 3, Cin, None))
    _build.expect(name, "idx", idx, torch.int32, (None, cols))
    Cout = w.shape[-1]
    n = idx.shape[0]
    # the generic instance's weights (Cout padded to whole groups of 8)
    # and two windows; the detector's instance needs a fixed 8.9 KB
    if 4 * (9 * Cin * -(-Cout // 8) * 8
            + 2 * -(-(th + 2) * (tw + 2) * Cin // 4) * 4) > _SMEM_LIMIT:
        raise ValueError(f"{name}: weights and windows exceed shared memory")
    rows = n if cols == 3 else C * n
    out = torch.empty((rows, th, tw, Cout), dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        err = launch(lib)(
            x.data_ptr(), w.data_ptr(), idx.data_ptr(), out.data_ptr(), n, C,
            H, W, Cin, Cout, th, tw, _build.stream_handle(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def roi_conv_entry(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   th: int, tw: int) -> torch.Tensor:
    """x: (C, H, W, Cin) float32 stacked frames; w: (3, 3, Cin, Cout);
    idx: (n, 3) int32 (cam, ty, tx).  Returns the ReLU'd packed SAME-conv
    outputs (n, th, tw, Cout).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return ref.roi_conv_entry(x, w, idx, th, tw)
    return _gather_conv("roi_conv_entry", lambda lib:
                        lib.roi_conv_entry_launch, x, w, idx, th, tw, 3)


def roi_conv_fleet(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                   th: int, tw: int) -> torch.Tensor:
    """``roi_conv_entry`` without the ReLU: the per-layer chain's entry
    over the stacked frames.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return ref.roi_conv_fleet(x, w, idx, th, tw)
    return _gather_conv("roi_conv_fleet", lambda lib:
                        lib.roi_conv_fleet_launch, x, w, idx, th, tw, 3)


def roi_conv(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, th: int,
             tw: int) -> torch.Tensor:
    """One camera's gather + 3x3 SAME conv, no ReLU: x (H, W, Cin) float32
    + idx (n, 2) int32 (ty, tx) -> (n, th, tw, Cout); or B frames sharing
    the rows, x (B, H, W, Cin) -> (B, n, th, tw, Cout), in one launch.
    Every tile must lie inside the frame (pad the frame to its grid's
    extent).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return ref.roi_conv(x, w, idx, th, tw)
    frames = x if x.ndim == 4 else x[None]
    out = _gather_conv("roi_conv", lambda lib: lib.roi_conv_launch, frames,
                       w, idx, th, tw, 2)
    if x.ndim == 4:
        return out.reshape((x.shape[0], idx.shape[0]) + tuple(out.shape[1:]))
    return out


def stack_route(L: int, th: int, tw: int) -> str:
    """How the stack kernel runs ``L`` layers on th x tw tiles: ``"ring"``
    (each tile recomputes an L-pixel ring of its neighbours, exact while
    the ring reaches only the 8 immediate ones: L <= min(th, tw, 8)), else
    ``"layers"`` (layer by layer, a grid-wide barrier between layers).
    Either way one launch."""
    if L < 1:
        raise ValueError(f"roi_conv_stack: {L} layers; it takes at least 1")
    return "ring" if L <= min(th, tw, RING_MAX_LAYERS) else "layers"


def _chain(name: str, packed: torch.Tensor, ws: Sequence[torch.Tensor],
           nbr: torch.Tensor):
    """Check a packed layer chain's tensors for the kernel; returns (the
    device, the L + 1 channel widths as a host int array)."""
    dev = _build.cuda_device(name, packed, nbr, *ws)
    _build.expect(name, "packed", packed, torch.float32, (None,) * 4)
    n, th, tw, c0 = packed.shape
    _build.expect(name, "nbr", nbr, torch.int32, (n, 8))
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: packed must start on a 16-byte boundary "
                         f"(the detector's instances read 16-byte vectors)")
    chans = [c0]
    for i, w in enumerate(ws):
        _build.expect(name, f"ws[{i}]", w, torch.float32,
                      (3, 3, chans[-1], None))
        chans.append(w.shape[-1])
    return dev, (ctypes.c_int * len(chans))(*chans)


def _check_smem(name: str, smem: int) -> None:
    if not 0 < smem <= _SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} bytes of shared memory per "
                         f"CTA, more than {_SMEM_LIMIT}")


def _ring(name: str, packed: torch.Tensor, ws: Sequence[torch.Tensor],
          nbr: torch.Tensor, relu_last: bool) -> torch.Tensor:
    """One launch of the stack kernel's ring route, counted as ``name``."""
    dev, chans = _chain(name, packed, ws, nbr)
    n, th, tw, _ = packed.shape
    L = len(ws)
    lib = _build.library()
    _check_smem(name, lib.roi_conv_stack_smem_bytes(chans, L, th, tw))
    out = torch.empty((n, th, tw, chans[L]), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    wcat = ws[0] if L == 1 else torch.cat([w.reshape(-1) for w in ws])
    with torch.cuda.device(dev):
        err = lib.roi_conv_stack_launch(
            packed.data_ptr(), wcat.data_ptr(), chans, nbr.data_ptr(),
            out.data_ptr(), n, th, tw, L, int(relu_last),
            _build.stream_handle(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out


def roi_conv_packed(packed: torch.Tensor, w: torch.Tensor,
                    nbr: torch.Tensor) -> torch.Tensor:
    """packed: (n, th, tw, Cin) float32, starting on a 16-byte boundary;
    w: (3, 3, Cin, Cout); nbr: (n, 8) int32 neighbour slots (-1 = zero
    halo).  Returns one packed SAME-conv layer (n, th, tw, Cout), no ReLU:
    the stack kernel's ring route at one layer with its ReLU off.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if packed.device.type == "cpu":
        return ref.roi_conv_packed(packed, w, nbr)
    return _ring("roi_conv_packed", packed, [w], nbr, relu_last=False)


def roi_conv_stack(packed: torch.Tensor, ws: Sequence[torch.Tensor],
                   nbr: torch.Tensor) -> torch.Tensor:
    """packed: (n, th, tw, C0) float32 entry output, starting on a 16-byte
    boundary; ws: the later layers' (3, 3, C_l, C_{l+1}) weights; nbr: (n,
    8) int32 neighbour slots (-1 = zero halo).  Returns the last layer's
    (n, th, tw, C_L), each layer conv + ReLU, in one launch at any depth
    (the route from ``stack_route``).  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if packed.device.type == "cpu":
        return ref.roi_conv_stack(packed, ws, nbr)
    _build.expect("roi_conv_stack", "packed", packed, torch.float32,
                  (None,) * 4)
    if stack_route(len(ws), *packed.shape[1:3]) == "ring":
        return _ring("roi_conv_stack", packed, ws, nbr, relu_last=True)
    return roi_conv_stack_layers(packed, ws, nbr)


def roi_conv_stack_layers(packed: torch.Tensor, ws: Sequence[torch.Tensor],
                          nbr: torch.Tensor) -> torch.Tensor:
    """``roi_conv_stack`` by the layer-by-layer route, at any depth: one
    cooperative launch, counted as one ``roi_conv_stack``, whose grid
    finishes every tile of a layer before the next layer starts (two
    ping-pong activation buffers on the card).  ``roi_conv_stack`` takes it
    past the ring route's depth; the card tests call it directly where both
    routes apply.  Raises if the card refuses the cooperative launch.  CPU
    tensors take the plain version."""
    if packed.device.type == "cpu":
        return ref.roi_conv_stack(packed, ws, nbr)
    name = "roi_conv_stack"
    dev, chans = _chain(name, packed, ws, nbr)
    n, th, tw, _ = packed.shape
    L = len(ws)
    lib = _build.library()
    _check_smem(name, lib.roi_conv_layers_smem_bytes(chans, L, th, tw))
    out = torch.empty((n, th, tw, chans[L]), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    wcat = torch.cat([w.reshape(-1) for w in ws])
    d_chans = torch.tensor(list(chans), dtype=torch.int32, device=dev)
    inner = n * th * tw * max(chans[1:L], default=0)
    acts = [torch.empty(inner, dtype=torch.float32, device=dev)
            for _ in range(min(L - 1, 2))]
    ptrs = [a.data_ptr() for a in acts] + [None] * (2 - len(acts))
    with torch.cuda.device(dev):
        err = lib.roi_conv_layers_launch(
            packed.data_ptr(), wcat.data_ptr(), chans, d_chans.data_ptr(),
            nbr.data_ptr(), *ptrs, out.data_ptr(), n, th, tw, L,
            _build.stream_handle(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
