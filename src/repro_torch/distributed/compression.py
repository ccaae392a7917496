"""Gradient compression for the reduction over the data axes, the port's
copy of ``repro.distributed.compression``.

int8 with a per-row absmax scale: gradients are quantized to int8, summed
over the ranks of a process group in int32 (exact for up to 2^24 ranks of
127), their scales summed in float32, and the mean dequantized.  The
payload is a quarter of float32's.

The arithmetic is jnp's: the absmax over the last axis (the whole tensor
for fewer than two dims), ``max(scale, 1e-12) / 127``, ``x / scale``
rounded half to even (``torch.round``, as ``jnp.round``), clipped to
[-127, 127] and cast to int8; both divisions are true divisions, on the
card too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 shaped as ``x``, the float32 scale: (..., 1) per row for
    ``x.ndim >= 2``, else a scalar).  ``absmax``: the rows' absmax when
    the caller has it (rows split over ranks), else ``x``'s own."""
    if absmax is not None:
        scale = absmax
    elif x.ndim >= 2:
        scale = x.abs().amax(dim=-1, keepdim=True)
    else:
        scale = x.abs().max()
    # a true division: on the card, a tensor over a Python scalar is a
    # product with its rounded reciprocal
    scale = torch.clamp_min(scale, 1e-12) / scale.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def _allreduce_one(g: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    q, scale = quantize_int8(g)
    # the int32 sum is exact; the scales are meaned in float32
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    dist.all_reduce(scale, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32,
                     device=g.device)
    # the mean of the ranks' dequantized gradients ~ mean scale x mean q
    return ((qsum.to(torch.float32) / n) * (scale / n)).to(g.dtype)


def int8_allreduce_mean(grads: Dict[str, torch.Tensor], group=None
                        ) -> Dict[str, torch.Tensor]:
    """Each gradient's mean over the ranks of ``group`` (the default
    group when None) with an int8 payload; the gradients enter
    unreduced, one per rank, and come back in their dtype."""
    return {k: _allreduce_one(g, group) for k, g in grads.items()}


__all__ = ["quantize_int8", "dequantize_int8", "int8_allreduce_mean"]
