"""The plain reference of the fleet detector, and its lower-precision
control.

What one camera's head maps are, written straight from the detector's
definition and independent of the program: the conv stack runs densely
over the camera's plane (its frame, zero-padded to whole tiles) with SAME
zero padding, and after every layer the activations are kept only on the
RoI's active tiles -- the packed chain's zero halo at inactive and
off-frame neighbours -- then the 1x1 head, zero outside the RoI, cropped
to the frame.  Weights are HWIO (3, 3, Cin, Cout) and the head (C, A).

``precision="float32"`` computes in float32 with TF32 off; ``"tf32"`` is
the control: every operand of every convolution and of the head rounded
to TF32 (10 mantissa bits, to nearest even) first, products summed in
float32, as the tensor cores would.  Imports nothing of the program.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & -0x2000
    return b.view(torch.float32)


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and products in full float32."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def head_maps(frame: torch.Tensor, grid: np.ndarray, weights, head,
              tile: int, precision: str = "float32") -> torch.Tensor:
    """One camera's (H, W, A) head maps for an (H, W, 3) frame and its
    bool tile grid."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    rnd = round_tf32 if precision == "tf32" else (lambda t: t)
    dev = frame.device
    H, W = frame.shape[:2]
    g = torch.as_tensor(np.asarray(grid, bool), device=dev)
    ph, pw = max(H, g.shape[0] * tile), max(W, g.shape[1] * tile)
    keep = torch.zeros((ph, pw), dtype=torch.float32, device=dev)
    keep[:g.shape[0] * tile, :g.shape[1] * tile] = \
        g.repeat_interleave(tile, 0).repeat_interleave(tile, 1).float()
    x = torch.zeros((1, 3, ph, pw), dtype=torch.float32, device=dev)
    x[0, :, :H, :W] = frame.permute(2, 0, 1)
    with torch.no_grad(), no_tf32():
        for w in weights:
            oihw = w.permute(3, 2, 0, 1).contiguous()
            x = torch.relu(torch.nn.functional.conv2d(
                rnd(x), rnd(oihw), padding=1)) * keep
        out = torch.einsum("chw,ca->hwa", rnd(x[0]), rnd(head))
    return (out * keep[..., None])[:H, :W]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between two maps over the largest |want| (1 where
    the maps are all zero)."""
    scale = float(want.abs().max()) or 1.0
    return float((got.to(want.device) - want).abs().max()) / scale
