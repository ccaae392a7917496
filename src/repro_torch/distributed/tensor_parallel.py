"""Tensor parallelism's collectives over the model group, as
``torch.autograd.Function``s, where the JAX package's partitioner
inserts its own.

An activation is either replicated over the model group (every rank
holds the same values, and in the backward pass the same, whole
gradient) or split on its last dim (each rank holds its slice, and the
gradient of its slice).  The four collectives move between the two:

  copy_to      identity forward, all-reduce backward: a replicated
               tensor entering work that differs by rank (a column-split
               projection, a slice of heads or channels); each rank's
               gradient is partial and the sum is the whole;
  reduce_from  all-reduce forward, identity backward: the partial sums
               of a row-split projection into a replicated tensor;
  gather_last  all-gather forward along the last dim, this rank's slice
               backward: a split tensor made replicated;
  scatter_last this rank's slice forward, all-gather backward: a
               replicated tensor split on its last dim.

``reduce_over`` (forward only) reduces flash decoding's running max
and sums in serving over the axes of a sequence split.  Each takes the
model code's ``DistContext``; on one rank (no mesh, or a model axis of
1) each is the identity in both directions and
returns its input.  ``split_dim`` reads from a leaf's local width
whether the leaf is split over the model group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def tp_size(ctx) -> int:
    """The model group's size under ``ctx`` (1 without one)."""
    return 1 if ctx is None else ctx.tp


def split_dim(local: int, full: int, ctx) -> bool:
    """Whether a dim of ``full`` entries that a rank holds ``local`` of is
    split over the model group; any other width raises."""
    if local == full:
        return False
    if local * tp_size(ctx) == full:
        return True
    raise ValueError(f"a dim of {full} held as {local} on a model group of "
                     f"{tp_size(ctx)}")


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather_last(x: torch.Tensor, group, n: int) -> torch.Tensor:
    src = x.movedim(-1, 0).contiguous()
    out = torch.empty((src.shape[0] * n,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, -1)


def _slice_last(x: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    w = x.shape[-1] // n
    return x[..., rank * w:(rank + 1) * w].contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.n, ctx.rank = n, rank
        return _all_gather_last(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.n, ctx.rank), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.group, ctx.n = group, n
        return _slice_last(x, n, rank)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group, ctx.n), None, None, None


def copy_to(x: torch.Tensor, ctx) -> torch.Tensor:
    if tp_size(ctx) == 1:
        return x
    return _Copy.apply(x, ctx.model_group())


def reduce_from(x: torch.Tensor, ctx) -> torch.Tensor:
    if tp_size(ctx) == 1:
        return x
    return _Reduce.apply(x, ctx.model_group())


def reduce_over(x: torch.Tensor, ctx, axes, op: str = "sum"
                ) -> torch.Tensor:
    """The elementwise sum (or ``op="max"``) of ``x`` over the ranks of
    the mesh ``axes``, forward only (flash decoding's combine over a
    sequence split); ``x`` itself over one rank."""
    if ctx is None or ctx.mesh is None or ctx.mesh.size(axes) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=ctx.mesh.group(axes))
    return out


def gather_last(x: torch.Tensor, ctx) -> torch.Tensor:
    if tp_size(ctx) == 1:
        return x
    return _Gather.apply(x, ctx.model_group(), ctx.tp, ctx.model_rank)


def scatter_last(x: torch.Tensor, ctx) -> torch.Tensor:
    if tp_size(ctx) == 1:
        return x
    return _Scatter.apply(x, ctx.model_group(), ctx.tp, ctx.model_rank)


__all__ = ["tp_size", "split_dim", "copy_to", "reduce_from", "reduce_over",
           "gather_last", "scatter_last"]
