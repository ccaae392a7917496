"""RWKV6 ("Finch"), the port's copy of ``repro.models.rwkv``: attention-free
token mixing with a data-dependent decay.

Recurrence per head (head dim P, state (P_key, P_value)):
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with per-channel decay w_t = exp(-exp(w0 + lora_w(x_t))) in (0, 1).

Chunked form (``wkv_chunked``): within a chunk of ``CHUNK`` tokens the
pairwise decay exp(clw_{t-1} - clw_s) is a (B, Q, Q, H, P) tensor
contracted with r and k; per-step log decay is clamped at
``LOG_DECAY_CLAMP`` so Q * |clamp| stays inside float32's exp range.  The
JAX package scans the chunks; here every chunk's own terms run at once
and only the state carry between chunks is a loop (one multiply-add a
chunk), in the scan's order.

Dtypes follow jnp's promotion, written out where torch would refuse or
differ: the mix coefficients ``maa_x`` and ``maa_wkvrg`` are float32
leaves, so in a bfloat16 model the five mixed streams, and r, k, v and g
made from them, are float32 products.

Over a model group (training) the roles are the JAX package's sharding
rules: ``wr``/``wk``/``wv``/``wg`` and ``cmix_k``/``cmix_r`` split on
their last dim, ``wo`` and ``cmix_v`` on their first, the mix and decay
LoRAs' inner dims split between ``maa_w1``/``maa_w2`` and
``decay_w1``/``decay_w2``.  A rank runs its H/tp heads of the WKV scan
and the head norm, taking its slice of the replicated per-channel
leaves; ``maa_w1``'s contiguous split does not line up with ``maa_w2``'s
per-stream split, so the LoRA's hidden rows are gathered whole first,
and ``cmix_r``'s split output is gathered to meet ``cmix_v``'s
all-reduced one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import (copy_to, gather_last,
                                                     reduce_from, split_dim,
                                                     tp_size)
from repro_torch.models.cache_layout import rwkv_heads
from repro_torch.models.layers import activation, mm, rmsnorm

LOG_DECAY_CLAMP = -5.0   # per step; chunk 16 -> max |exponent| 80 < 88 (f32)
CHUNK = 16
LORA_MIX = 32
LORA_DECAY = 64


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (B, H, P, P) f32
    shift_t: torch.Tensor  # (B, D) last input of the token-mix sublayer
    shift_c: torch.Tensor  # (B, D) last input of the channel-mix sublayer


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x: (B, S, D) -> the previous token's row, seeded by ``last`` or
    zeros."""
    B, _, D = x.shape
    first = torch.zeros((B, 1, D), dtype=x.dtype, device=x.device) \
        if last is None else last[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(x, sx, p, dist=None):
    """The data-dependent lerp: the five mixed streams (w, k, v, r, g)."""
    xx = x + sx * p["maa_x"]
    w1, w2 = p["maa_w1"], p["maa_w2"]
    if split_dim(w1.shape[-1], 5 * LORA_MIX, dist):
        delta = gather_last(torch.tanh(mm(copy_to(xx, dist), w1)), dist)
    else:
        delta = torch.tanh(mm(xx, w1))                 # (B, S, 5 * LORA)
    B, S, _ = delta.shape
    delta = delta.reshape(B, S, 5, LORA_MIX)
    lora_split = split_dim(w2.shape[1], LORA_MIX, dist)
    if lora_split:                  # this rank's rows of each stream's LoRA
        n = w2.shape[1]
        delta = copy_to(delta, dist)[..., dist.model_rank * n:
                                     (dist.model_rank + 1) * n]
    dt = torch.promote_types(delta.dtype, w2.dtype)
    deltas = torch.einsum("bsfl,fld->bsfd", delta.to(dt), w2.to(dt))
    if lora_split:
        deltas = reduce_from(deltas, dist)
    base = p["maa_wkvrg"]                                  # (5, D)
    mixed = x[:, :, None, :] + sx[:, :, None, :] * (base[None, None]
                                                     + deltas)
    return [mixed[:, :, i, :] for i in range(5)]


def wkv_chunked(r, k, v, lw, u, init_state=None):
    """r, k, v: (B, S, H, P); lw: (B, S, H, P) log decay (<= 0); u: (H, P).
    Returns (out (B, S, H, P) f32, final state (B, H, P, P)).  The chunk
    is ``CHUNK``, halved until it divides S (an odd S runs one token a
    chunk)."""
    B, S, H, P = r.shape
    Q = max(1, min(CHUNK, S))
    while S % Q:
        Q //= 2
    nc = S // Q
    r, k, v = (t.float().reshape(B, nc, Q, H, P) for t in (r, k, v))
    lw = lw.reshape(B, nc, Q, H, P)
    dev = r.device
    state = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev) \
        if init_state is None else init_state
    strict = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev),
                        diagonal=-1)

    # inclusive; summed in float64 and rounded once, as the CPU's float32
    # cumsum does (CUDA's sums in float32, and exp turns its rounding in
    # sums of up to |80| into relative errors)
    clw = torch.cumsum(lw.double(), dim=2).float()
    # pairwise decay from s (exclusive) to t-1 (inclusive): clw_{t-1}-clw_s
    clw_tm1 = torch.cat([torch.zeros_like(clw[:, :, :1]), clw[:, :, :-1]],
                        dim=2)
    diff = clw_tm1[:, :, :, None] - clw[:, :, None, :]    # (B,c,t,s,H,P)
    E = torch.exp(torch.where(strict[None, None, :, :, None, None], diff,
                              -torch.inf))
    A = torch.einsum("bcthp,bcshp,bctshp->bctsh", r, k, E)
    del diff, E
    A = A + torch.einsum("bcthp,bcthp->bcth", r, k * u[None, None, None])[
        :, :, :, None, :] * torch.eye(Q, dtype=torch.float32,
                                      device=dev)[None, None, :, :, None]
    out = torch.einsum("bctsh,bcshp->bcthp", A, v)
    # the state update's terms: S_new = diag(exp(clw_Q)) S + sum_s k_s
    # exp(clw_Q - clw_s) v_s^T
    w_tail = torch.exp(clw[:, :, -1:] - clw)              # (B,c,Q,H,P)
    adds = torch.einsum("bcshp,bcshz->bchpz", k * w_tail, v)
    decay = torch.exp(clw[:, :, -1])                      # (B,c,H,P)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * decay[:, c][..., None] + adds[:, c]
    # inter-chunk: each chunk's starting state, decayed to t-1
    out = out + torch.einsum("bcthp,bchpz->bcthz", r * torch.exp(clw_tm1),
                             torch.stack(starts, dim=1))
    return out.reshape(B, S, H, P), state


def wkv_step(state, r, k, v, lw, u):
    """One token.  r, k, v, lw: (B, 1, H, P); state: (B, H, P, P)."""
    r1, k1, v1 = (t[:, 0].float() for t in (r, k, v))
    w1 = torch.exp(lw[:, 0])
    kv = torch.einsum("bhp,bhz->bhpz", k1, v1)
    out = torch.einsum("bhp,bhpz->bhz", r1, state + u[None][..., None] * kv)
    state_new = state * w1[..., None] + kv
    return out[:, None], state_new


def _col(t: torch.Tensor, w: torch.Tensor, split: bool, dist):
    """``mm(t, w)``; a replicated ``t`` meets a column-split ``w`` through
    ``copy_to``."""
    return mm(copy_to(t, dist) if split else t, w)


def rwkv6_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                state: Optional[RWKVState] = None,
                single_step: bool = False,
                dist=None) -> Tuple[torch.Tensor, RWKVState]:
    """One RWKV6 layer (time mix, then channel mix), pre-norm residual.
    Returns (x, the new state); ``state`` seeds the shifts and the wkv
    state (zeros without it).  Over a model group (``dist``, training
    only) the rank runs its heads as the module's docstring says."""
    B, S, D = x.shape
    H, P = cfg.ssm_num_heads, cfg.ssm_head_dim
    heads = split_dim(p["wr"].shape[-1], D, dist)
    Hl = rwkv_heads(cfg, tp_size(dist), heads)
    c0, c1 = (dist.model_rank * Hl * P, (dist.model_rank + 1) * Hl * P) \
        if heads else (0, D)

    def own(t):
        """This rank's channels of a replicated (..., D) tensor."""
        return copy_to(t, dist)[..., c0:c1] if heads else t

    # ---- time mix ----------------------------------------------------------
    xn = rmsnorm(x, p["ln1_w"], cfg.norm_eps)
    last_t = state.shift_t if state is not None else None
    sx = _shift(xn, last_t) - xn
    mw, mk, mv, mr, mg = _ddlerp(xn, sx, p, dist)

    dw1, dw2 = p["decay_w1"], p["decay_w2"]
    if split_dim(dw1.shape[-1], LORA_DECAY, dist):
        lw = p["decay_base"].float() + reduce_from(torch.tanh(
            copy_to(mw.float(), dist) @ dw1.float()) @ dw2.float(), dist)
    else:
        lw = p["decay_base"].float() + torch.tanh(
            mw.float() @ dw1.float()) @ dw2.float()
    # decay = exp(-exp(lw)); log decay = -exp(lw), clamped for the chunks
    log_decay = torch.clamp(-torch.exp(lw), LOG_DECAY_CLAMP, 0.0)
    log_decay = own(log_decay).reshape(B, S, Hl, P)

    r = _col(mr, p["wr"], heads, dist).reshape(B, S, Hl, P)
    k = _col(mk, p["wk"], heads, dist).reshape(B, S, Hl, P)
    v = _col(mv, p["wv"], heads, dist).reshape(B, S, Hl, P)
    g = activation(_col(mg, p["wg"], heads, dist), "silu")
    u = copy_to(p["u"], dist)[c0 // P:c1 // P] if heads else p["u"]

    prev = state.wkv if state is not None else None
    if single_step:
        assert prev is not None
        out, new_wkv = wkv_step(prev, r, k, v, log_decay, u)
    else:
        out, new_wkv = wkv_chunked(r, k, v, log_decay, u, init_state=prev)
    # per-head group norm, the population variance as jnp.var's
    mu = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, correction=0)
    out = ((out - mu) * torch.rsqrt(var + 64e-5)).reshape(B, S, Hl * P)
    out = out * own(p["gn_w"].float())
    y = (out.to(x.dtype) * g.to(x.dtype)) @ p["wo"]
    x = x + (reduce_from(y, dist) if heads else y).to(x.dtype)
    new_shift_t = xn[:, -1, :].float()

    # ---- channel mix --------------------------------------------------------
    xn2 = rmsnorm(x, p["ln2_w"], cfg.norm_eps)
    last_c = state.shift_c if state is not None else None
    sx2 = _shift(xn2, last_c) - xn2
    xk = (xn2 + sx2 * p["cmix_mu_k"]).to(x.dtype)
    xr = (xn2 + sx2 * p["cmix_mu_r"]).to(x.dtype)
    k_split = split_dim(p["cmix_k"].shape[-1], cfg.d_ff, dist)
    kc = torch.square(torch.relu(_col(xk, p["cmix_k"], k_split, dist)))
    vc = kc @ p["cmix_v"]
    if k_split:
        vc = reduce_from(vc, dist)
    rc = _col(xr, p["cmix_r"], split_dim(p["cmix_r"].shape[-1], D, dist),
              dist)
    if rc.shape[-1] != D:
        rc = gather_last(rc, dist)
    out_c = torch.sigmoid(rc) * vc
    x = x + out_c.to(x.dtype)
    new_shift_c = xn2[:, -1, :].float()

    return x, RWKVState(new_wkv, new_shift_t, new_shift_c)
