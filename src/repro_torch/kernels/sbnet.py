"""SBNet tile copies between packed tiles and frames (CUDA kernels in
``csrc/sbnet.cu``): the fleet scatter, which serves the cold step's full
scatter and the warm step's changed-only scatter, and one camera's scatter
and gather.  The scatters update ``base`` in place."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _launch(name: str, launch, src: torch.Tensor, idx: torch.Tensor,
            dst: torch.Tensor, n: int, th: int, tw: int, *dims) -> None:
    lib = _build.library()
    dev = src.device
    with torch.cuda.device(dev):
        err = launch(lib)(src.data_ptr(), idx.data_ptr(), dst.data_ptr(), n,
                          th, tw, *dims, _build.stream_handle(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1


def sbnet_scatter_fleet(packed: torch.Tensor, idx: torch.Tensor,
                        base: torch.Tensor) -> torch.Tensor:
    """packed: (n, th, tw, A) float32; idx: (n, 3) int32 (cam, ty, tx);
    base: (C, H, W, A) float32.  Writes tile i at (cam, ty*th, tx*tw) of
    ``base`` IN PLACE and returns ``base``; every other byte keeps its
    value.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if base.device.type == "cpu":
        return ref.sbnet_scatter_fleet(packed, idx, base)
    name = "sbnet_scatter_fleet"
    _build.cuda_device(name, packed, idx, base)
    _build.expect(name, "base", base, torch.float32, (None,) * 4)
    C, H, W, A = base.shape
    _build.expect(name, "packed", packed, torch.float32, (None, None, None, A))
    n, th, tw, _ = packed.shape
    _build.expect(name, "idx", idx, torch.int32, (n, 3))
    if n:
        _launch(name, lambda lib: lib.sbnet_scatter_fleet_launch, packed, idx,
                base, n, th, tw, A, C, H, W)
    return base


def sbnet_scatter(packed: torch.Tensor, idx: torch.Tensor,
                  base: torch.Tensor) -> torch.Tensor:
    """One camera's scatter: packed (n, th, tw, A) float32 tiles into
    ``base`` (H, W, A) at (ty*th, tx*tw) for idx (n, 2) int32 (ty, tx)
    rows, IN PLACE; returns ``base``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if base.device.type == "cpu":
        return ref.sbnet_scatter(packed, idx, base)
    name = "sbnet_scatter"
    _build.cuda_device(name, packed, idx, base)
    _build.expect(name, "base", base, torch.float32, (None,) * 3)
    H, W, A = base.shape
    _build.expect(name, "packed", packed, torch.float32, (None, None, None, A))
    n, th, tw, _ = packed.shape
    _build.expect(name, "idx", idx, torch.int32, (n, 2))
    if n:
        _launch(name, lambda lib: lib.sbnet_scatter_launch, packed, idx, base,
                n, th, tw, A, H, W)
    return base


def sbnet_gather(x: torch.Tensor, idx: torch.Tensor, th: int,
                 tw: int) -> torch.Tensor:
    """x: (H, W, C) float32; idx: (n, 2) int32 (ty, tx).  Returns the
    packed (n, th, tw, C) tiles at (ty*th, tx*tw).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return ref.sbnet_gather(x, idx, th, tw)
    name = "sbnet_gather"
    dev = _build.cuda_device(name, x, idx)
    _build.expect(name, "x", x, torch.float32, (None,) * 3)
    H, W, C = x.shape
    _build.expect(name, "idx", idx, torch.int32, (None, 2))
    n = idx.shape[0]
    out = torch.empty((n, th, tw, C), dtype=torch.float32, device=dev)
    if n:
        _launch(name, lambda lib: lib.sbnet_gather_launch, x, idx, out, n, th,
                tw, C, H, W)
    return out
