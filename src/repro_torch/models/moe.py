"""Mixture-of-Experts layer, the port's copy of ``repro.models.moe``.

The router and its top-k run in float32.  Each sequence gives every
expert ``capacity`` slots, filled in token order (a cumsum over S); a
token's choice past its expert's capacity falls into a drop bin and adds
nothing.  The kept tokens are gathered into an (E, cap) slot buffer
through a zero sentinel row, the grouped SwiGLU/GeGLU products run over
the slots, and each token sums its experts' rows, weighted by its
renormalised router values, in ``x.dtype``.  The dropped share is
returned as a metric, beside the Switch-style load-balance loss.

On a mesh each rank routes its own rows; the load-balance loss is the
global batch's, as under the JAX package's mesh: its per-expert shares
and mean probabilities are averaged over the batch axes (through an
all-reduce that autograd differentiates), and so is the dropped share.

Over a model axis whose ranks hold the experts split (E/tp each), the
layer takes the JAX package's expert-parallel ``shard_map`` route
written out: the router runs replicated, each rank dispatches its rows
to its own experts at ``e_offset = rank * E/tp`` (the rest fall into the
drop bin), and the partial outputs are summed over the model group.
The dropped share is then, as the JAX route's, the mean over every rank
of each rank's share of choices dropped from its own experts: 1/tp of
the one-device share.  The port takes this route whatever ``auto_moe``
says: it has no partitioner to defer to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import (copy_to, reduce_from,
                                                     split_dim)
from repro_torch.models.dist import DistContext
from repro_torch.models.layers import activation, glu_mlp


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Slots per expert and sequence: ceil-ish ``capacity_factor * k * S /
    E``, rounded up to a multiple of 8 (at least 8) past 8 tokens."""
    c = int(cfg.capacity_factor * cfg.experts_per_token * seq_len
            / max(cfg.num_experts, 1)) + 1
    return max(8, -(-c // 8) * 8) if seq_len > 8 else max(1, c)


def _batch_mean(t: torch.Tensor, dist, grad: bool = False):
    """``t`` averaged over the batch axes of ``dist``'s mesh (itself on
    one device); ``grad``: through autograd's all-reduce."""
    if dist is None or dist.mesh is None or dist.dp == 1:
        return t
    if grad:
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(t, group=dist.batch_group()) / dist.dp
    import torch.distributed as tdist
    t = t.detach().clone()
    tdist.all_reduce(t, group=dist.batch_group())
    return t / dist.dp


def router_topk(x: torch.Tensor, router_w: torch.Tensor, k: int,
                dist=None):
    """x: (B, S, D) -> (top_vals (B, S, k) float32 renormalised, top_idx
    (B, S, k), aux load-balance loss, a float32 scalar); with a mesh
    ``dist``, the loss of the global batch."""
    logits = torch.einsum("bsd,de->bse", x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, k, dim=-1)
    top_vals = top_vals / torch.clamp_min(
        top_vals.sum(dim=-1, keepdim=True), 1e-9)
    # Switch-style aux loss: E * sum_e f_e * P_e
    E = router_w.shape[-1]
    ass = F.one_hot(top_idx, E).float().sum(dim=2)              # (B,S,E)
    f = _batch_mean(ass.mean(dim=(0, 1)), dist) / k
    p = _batch_mean(probs.mean(dim=(0, 1)), dist, grad=True)
    aux = E * (f * p).sum()
    return top_vals, top_idx, aux


def _dispatch_compute_combine(x, top_vals, top_idx, wg, wu, wd, *,
                              cap: int, act: str, e_offset: int = 0):
    """Dispatch -> grouped GLU -> gather-combine over the E_local =
    ``wg.shape[0]`` experts from ``e_offset`` (all E on one rank), every
    other choice in the overflow bin.

    x: (B, S, D); top_vals, top_idx: (B, S, K); wg, wu: (E_local, D, F);
    wd: (E_local, F, D).  Returns (the partial out (B, S, D), the share of
    all choices that chose a local expert and were dropped, a float32
    scalar).  Each (token, choice)'s slot is the count of tokens before
    it in its sequence that chose the same expert; every kept (expert,
    slot) is one token's, gathered through a zero sentinel row."""
    B, S, D = x.shape
    K = top_idx.shape[-1]
    El = wg.shape[0]
    dev = x.device
    local = (top_idx >= e_offset) & (top_idx < e_offset + El)
    li = torch.where(local, top_idx - e_offset, El)      # El: overflow bin
    assign = F.one_hot(li, El + 1).sum(dim=2)                   # (B,S,El+1)
    pos_before = torch.cumsum(assign, dim=1) - assign
    slot = torch.gather(pos_before, 2, li)                       # (B,S,K)
    ok = local & (slot < cap)
    flat = torch.where(ok, li * cap + slot, El * cap)
    buf_tok = torch.full((B, El * cap + 1), S, dtype=torch.long, device=dev)
    tok = torch.arange(S, device=dev)[None, :, None].expand(B, S, K)
    buf_tok.scatter_(1, flat.reshape(B, S * K), tok.reshape(B, S * K))
    buf_tok = buf_tok[:, :El * cap].reshape(B, El, cap)
    b = torch.arange(B, device=dev)
    xpad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    xe = xpad[b[:, None, None], buf_tok]                         # (B,El,C,D)
    h = activation(torch.einsum("becd,edf->becf", xe, wg), act)
    u = torch.einsum("becd,edf->becf", xe, wu)
    y = torch.einsum("becf,efd->becd", h * u, wd)
    ypad = torch.cat([y.reshape(B, El * cap, D), y.new_zeros((B, 1, D))],
                     dim=1)
    yk = ypad[b[:, None, None], flat]                            # (B,S,K,D)
    w = torch.where(ok, top_vals, torch.zeros_like(top_vals)).to(yk.dtype)
    out = torch.einsum("bsk,bskd->bsd", w, yk)
    dropped = (local & ~ok).float().mean()
    return out, dropped


def moe_layer(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, cfg: ModelConfig,
              dist=None,
              shared: Optional[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]] = None):
    """Full MoE layer.  Returns (y, aux_loss, dropped_frac).

    wg, wu: (E, D, F); wd: (E, F, D) -- this rank's E/tp experts where
    the model group holds them split (the expert-parallel route).
    ``shared``: optional (wg, wu, wd) of the always-on shared-expert MLP
    (column- and row-split as ``glu_mlp`` takes them).  ``dist``: None or
    a ``DistContext``; on a mesh the aux loss and the dropped share are
    the global batch's."""
    if dist is not None and not isinstance(dist, DistContext):
        raise TypeError(f"dist is a DistContext or None, not {dist!r}")
    top_vals, top_idx, aux = router_topk(x, router_w, cfg.experts_per_token,
                                         dist)
    cap = capacity(cfg, x.shape[1])
    if split_dim(wg.shape[0], cfg.num_experts, dist):
        import torch.distributed as tdist
        y, dropped = _dispatch_compute_combine(
            copy_to(x, dist), copy_to(top_vals.to(x.dtype), dist), top_idx,
            wg, wu, wd, cap=cap, act=cfg.act,
            e_offset=dist.model_rank * wg.shape[0])
        y = reduce_from(y, dist)
        dropped = dropped.detach().clone()
        tdist.all_reduce(dropped, group=dist.all_group())
        dropped = dropped / (dist.dp * dist.tp)
    else:
        y, dropped = _dispatch_compute_combine(
            x, top_vals.to(x.dtype), top_idx, wg, wu, wd, cap=cap,
            act=cfg.act)
        dropped = _batch_mean(dropped, dist)
    if shared is not None:
        sg, su, sd = shared
        y = y + glu_mlp(x, sg, su, sd, act=cfg.act, dist=dist,
                        width=cfg.shared_d_ff)
    return y, aux, dropped
