"""SBNet scatter of packed tiles into the stacked canvas (CUDA kernel
``csrc/sbnet_scatter.cu``).  One kernel serves the cold step's full
scatter and the warm step's changed-only scatter; both update ``base`` in
place."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def sbnet_scatter_fleet(packed: torch.Tensor, idx: torch.Tensor,
                        base: torch.Tensor) -> torch.Tensor:
    """packed: (n, th, tw, A) float32; idx: (n, 3) int32 (cam, ty, tx);
    base: (C, H, W, A) float32.  Writes tile i at (cam, ty*th, tx*tw) of
    ``base`` IN PLACE and returns ``base``; every other byte keeps its
    value.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if base.device.type == "cpu":
        return ref.sbnet_scatter_fleet(packed, idx, base)
    name = "sbnet_scatter"
    dev = _build.cuda_device(name, packed, idx, base)
    _build.expect(name, "base", base, torch.float32, (None,) * 4)
    C, H, W, A = base.shape
    _build.expect(name, "packed", packed, torch.float32, (None, None, None, A))
    n, th, tw, _ = packed.shape
    _build.expect(name, "idx", idx, torch.int32, (n, 3))
    if n == 0:
        return base
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sbnet_scatter_launch(
            packed.data_ptr(), idx.data_ptr(), base.data_ptr(), n, th, tw, A,
            C, H, W, _build.stream_handle(dev))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return base
