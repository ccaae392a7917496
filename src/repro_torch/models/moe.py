"""Mixture-of-Experts layer, the port's copy of ``repro.models.moe`` on one
device.

The router and its top-k run in float32.  Each sequence gives every
expert ``capacity`` slots, filled in token order (a cumsum over S); a
token's choice past its expert's capacity falls into a drop bin and adds
nothing.  The kept tokens are gathered into an (E, cap) slot buffer
through a zero sentinel row, the grouped SwiGLU/GeGLU products run over
the slots, and each token sums its experts' rows, weighted by its
renormalised router values, in ``x.dtype``.  The dropped share is
returned as a metric, beside the Switch-style load-balance loss.

The JAX package also runs the dispatch under a model-parallel
``shard_map`` with E/tp experts a rank; that route comes with A6d in
ROADMAP.md, and a ``DistContext`` over a model axis above 1 raises
(``models.dist``), so ``moe_layer`` runs every expert locally.  On the
data-axis route each rank routes its own rows; the load-balance loss is
the global batch's, as under the JAX package's mesh: its per-expert
shares and mean probabilities are averaged over the batch axes (through
an all-reduce that autograd differentiates), and so is the dropped
share.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
                              cap: int, act: str):
    """Dispatch -> grouped GLU -> gather-combine over all E experts.

    x: (B, S, D); top_vals, top_idx: (B, S, K); wg, wu: (E, D, F); wd:
    (E, F, D).  Returns (out (B, S, D), dropped share, a float32 scalar).
    """
    B, S, D = x.shape
    K = top_idx.shape[-1]
    E = wg.shape[0]
    dev = x.device
    # each (token, choice)'s slot: the tokens before it in its sequence
    # that chose the same expert
    assign = F.one_hot(top_idx, E).sum(dim=2)                   # (B,S,E)
    pos_before = torch.cumsum(assign, dim=1) - assign
    slot = torch.gather(pos_before, 2, top_idx)                  # (B,S,K)
    ok = slot < cap
    flat = torch.where(ok, top_idx * cap + slot, E * cap)        # drop bin
    # slot -> token; every kept (expert, slot) is one token's, the drop
    # bin's row E * cap takes the rest and is cut off
    buf_tok = torch.full((B, E * cap + 1), S, dtype=torch.long, device=dev)
    tok = torch.arange(S, device=dev)[None, :, None].expand(B, S, K)
    buf_tok.scatter_(1, flat.reshape(B, S * K), tok.reshape(B, S * K))
    buf_tok = buf_tok[:, :E * cap].reshape(B, E, cap)
    b = torch.arange(B, device=dev)
    xpad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)         # sentinel
    xe = xpad[b[:, None, None], buf_tok]                         # (B,E,C,D)
    h = activation(torch.einsum("becd,edf->becf", xe, wg), act)
    u = torch.einsum("becd,edf->becf", xe, wu)
    y = torch.einsum("becf,efd->becd", h * u, wd)
    ypad = torch.cat([y.reshape(B, E * cap, D), y.new_zeros((B, 1, D))],
                     dim=1)
    yk = ypad[b[:, None, None], flat]                            # (B,S,K,D)
    w = torch.where(ok, top_vals, torch.zeros_like(top_vals)).to(yk.dtype)
    out = torch.einsum("bsk,bskd->bsd", w, yk)
    dropped = (~ok).float().mean()
    return out, dropped


def moe_layer(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor, cfg: ModelConfig,
              dist=None,
              shared: Optional[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]] = None):
    """Full MoE layer, every expert local.  Returns (y, aux_loss,
    dropped_frac).

    wg, wu: (E, D, F); wd: (E, F, D).  ``shared``: optional (wg, wu, wd)
    of the always-on shared-expert MLP.  ``dist``: None or a
    ``DistContext``; on a data-axis mesh the aux loss and the dropped
    share are the global batch's.  The expert-parallel route over a model
    axis comes with A6d."""
    if dist is not None and not isinstance(dist, DistContext):
        raise NotImplementedError(
            "expert parallelism over a model-parallel mesh comes with A6d "
            "in ROADMAP.md")
    top_vals, top_idx, aux = router_topk(x, router_w, cfg.experts_per_token,
                                         dist)
    y, dropped = _dispatch_compute_combine(
        x, top_vals.to(x.dtype), top_idx, wg, wu, wd,
        cap=capacity(cfg, x.shape[1]), act=cfg.act)
    dropped = _batch_mean(dropped, dist)
    if shared is not None:
        sg, su, sd = shared
        y = y + glu_mlp(x, sg, su, sd, act=cfg.act)
    return y, aux, dropped
