"""Transformer building blocks, the port's copy of ``repro.models.layers``
(full, sliding-window and non-causal attention with the training path's
causal block skip, the norms, the MLPs, the rotary and sinusoid
positions, the cross-entropy).

Parameters are plain dicts of tensors; layer stacks carry a leading ``L``
dim.  Prefill attention is blockwise online softmax with float32
accumulators, never an (S, S) tensor: the KV chunks run in order, and all
query rows of a chunk run as one batched tensor.  Each row's running max,
denominator and accumulator see the chunks in the same order as the JAX
package's nested scan, so the numbers follow from the chunk size alone.
With a window, attention is banded: each query block sees only the
``window + q_block`` keys before its end, so a sliding-window layer
spends O(S * window), not O(S^2).

Callers repeat K/V to the full head count (``repeat_kv``) before
attention; the KV cache keeps only the KV heads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed.tensor_parallel import (copy_to, reduce_from,
                                                     split_dim)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms, rotary embeddings, GQA
# ---------------------------------------------------------------------------

def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype, as jnp multiplies mixed dtypes (a
    float32 activation and bfloat16 weights give a float32 product, where
    torch refuses)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (population variance), cast back to x's
    dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.square(x32 - mu).mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(sin, cos) tables from integer positions; shape (..., head_dim/2).
    The frequencies 1 / theta^(2i / head_dim) are rounded to float32 once,
    from float64: the values XLA folds into the JAX engine's compiled
    tables, one float32 step off eager float32 ``pow`` in places -- a step
    that turns the angle at ``PAD_POS`` (2^31) by whole radians."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64,
                                          device=positions.device),
                             exps.double())).float()
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B, S, D/2) or (S, D/2)."""
    if sin.ndim == 2:
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KH, D) -> (B, S, KH*groups, D)."""
    if groups == 1:
        return k
    B, S, KH, D = k.shape
    return k[:, :, :, None, :].expand(B, S, KH, groups, D).reshape(
        B, S, KH * groups, D)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _softcap(s: torch.Tensor, softcap: float) -> torch.Tensor:
    return softcap * torch.tanh(s / softcap) if softcap > 0.0 else s


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    q_block: int = 512,
    kv_chunk: int = 1024,
    q_offset=0,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    causal_skip: bool = False,
) -> torch.Tensor:
    """Memory-bounded attention.  q: (B, Sq, H, D); k, v: (B, Skv, H, D)
    (full heads); positions (B, S) int, default ``arange`` (+ ``q_offset``
    for q).  A key is visible when its position is >= 0 and, with
    ``causal``, <= the query's.  ``q_block`` (halved until it divides Sq,
    as in the JAX package) only groups query rows, whose results do not
    depend on it, so all query blocks run together; ``kv_chunk`` (halved
    until it divides Skv) fixes each row's online-softmax steps.

    ``window > 0`` (self-attention, Sq == Skv) is banded attention
    (``_banded_attention``): a key is visible when also > the query's
    position - window.

    ``causal_skip`` (with ``causal``, Sq == Skv and no window) is the JAX
    package's causal block skip: query block ``i`` (``q_block`` halved
    until it divides Sq) takes only its first ceil((i + 1) q_block /
    kv_chunk) chunks, as on default positions nothing later is visible to
    it.  So chunk ``c`` updates only the rows from block floor(c kv_chunk
    / q_block) on; a skipped step would leave a row's running max,
    denominator and accumulator as they are, so each row's result is the
    exhaustive walk's."""
    if window > 0:
        return _banded_attention(q, k, v, window, softcap, q_block,
                                 q_offset, q_positions, kv_positions)
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    q_positions, kv_positions = _default_positions(
        q_positions, kv_positions, q_offset, B, Sq, Skv, dev)

    kv_chunk = max(min(kv_chunk, Skv), 1)
    while Skv % kv_chunk:
        kv_chunk //= 2
    skip = causal_skip and causal and Sq == Skv
    if skip:
        q_block = max(min(q_block, Sq), 1)
        while Sq % q_block:
            q_block //= 2

    qh = (q.float() * scale).permute(0, 2, 1, 3).contiguous()  # (B,H,Sq,D)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, kv_chunk):
        # the first row whose query block takes this chunk
        r0 = c0 // q_block * q_block if skip else 0
        kc = k[:, c0:c0 + kv_chunk].float().permute(0, 2, 3, 1)  # (B,H,D,K)
        vc = v[:, c0:c0 + kv_chunk].float().permute(0, 2, 1, 3)  # (B,H,K,D)
        kpos = kv_positions[:, c0:c0 + kv_chunk]
        mask = (kpos >= 0)[:, None, :]
        if causal:
            mask = mask & (q_positions[:, r0:, None] >= kpos[:, None, :])
        s = _softcap(torch.matmul(qh[:, :, r0:], kc), softcap)
        s = torch.where(mask[:, None], s, NEG_INF)
        m_r = m[..., r0:]
        m_new = torch.maximum(m_r, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        del s
        alpha = torch.exp(m_r - m_new)
        l_new = l[..., r0:] * alpha + p.sum(dim=-1)
        acc_new = acc[:, :, r0:] * alpha[..., None] + torch.matmul(p, vc)
        del p
        if r0:
            m_new = torch.cat([m[..., :r0], m_new], dim=-1)
            l_new = torch.cat([l[..., :r0], l_new], dim=-1)
            acc_new = torch.cat([acc[:, :, :r0], acc_new], dim=2)
        m, l, acc = m_new, l_new, acc_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _default_positions(q_positions, kv_positions, q_offset, B, Sq, Skv,
                       dev):
    if q_positions is None:
        off = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
        q_positions = (torch.arange(Sq, device=dev)[None, :] + off) \
            .expand(B, Sq).to(torch.int32)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev, dtype=torch.int32) \
            .expand(B, Skv)
    return q_positions, kv_positions


def _banded_attention(q, k, v, window, softcap, q_block, q_offset,
                      q_positions, kv_positions) -> torch.Tensor:
    """The JAX package's banded route: query block ``b`` (``q_block``
    halved until it divides Sq) takes one softmax step over the static
    span of keys ``[b * q_block - window, (b + 1) * q_block)``, left-padded
    with keys at position -1, under the mask ``kpos >= 0 & qpos >= kpos &
    kpos > qpos - window``.  Every row sees its own key, so its result
    depends on its span only through which keys are visible: the rows run
    in chunks of up to 512 whole query blocks, each against the keys of
    its blocks' spans, masked to each row's own span -- so a ``q_block``
    halved to 1 (an odd Sq) costs no more than 512 -- and the padding is
    never built."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if Sq != Skv:
        raise ValueError(f"banded attention is self-attention: Sq {Sq} != "
                         f"Skv {Skv}")
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    q_positions, kv_positions = _default_positions(
        q_positions, kv_positions, q_offset, B, Sq, Skv, dev)
    q_block = max(min(q_block, Sq), 1)
    while Sq % q_block:
        q_block //= 2
    rows = q_block * max(1, 512 // q_block)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    for r0 in range(0, Sq, rows):
        r1 = min(r0 + rows, Sq)
        k0 = max(r0 - window, 0)
        qh = (q[:, r0:r1].float() * scale).permute(0, 2, 1, 3)  # (B,H,R,D)
        kc = k[:, k0:r1].float().permute(0, 2, 3, 1)            # (B,H,D,K)
        vc = v[:, k0:r1].float().permute(0, 2, 1, 3)            # (B,H,K,D)
        qpos = q_positions[:, r0:r1, None]
        kpos = kv_positions[:, None, k0:r1]
        start = torch.arange(r0, r1, device=dev) // q_block * q_block
        key = torch.arange(k0, r1, device=dev)
        span = (key[None, :] >= start[:, None] - window) \
            & (key[None, :] < start[:, None] + q_block)
        mask = span & (kpos >= 0) & (qpos >= kpos) & (kpos > qpos - window)
        s = _softcap(torch.matmul(qh, kc), softcap)
        s = torch.where(mask[:, None], s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.matmul(p, vc) / torch.clamp_min(
            p.sum(dim=-1), 1e-30)[..., None]
        out[:, r0:r1] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _decode_valid(cache_len, Smax: int, device, window: int = 0,
                  offset: int = 0) -> torch.Tensor:
    """(B or 1, Smax) bool: the cache slots below each sequence's length
    and, with a window, above its length - 1 - window; the slots of a
    slice of a cache are ``offset`` + 0..Smax-1."""
    clen = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    kpos = torch.arange(offset, offset + Smax, device=device)[None, :]
    valid = kpos < clen
    if window > 0:
        valid = valid & (kpos > clen - 1 - window)
    return valid


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-step decode attention over a cache (full heads).  q: (B, 1,
    H, D); k_cache, v_cache: (B, Smax, H, D); cache_len: scalar or (B,)
    count of valid slots (the newly written token included); with a
    window, only the last ``window`` of them are."""
    B, _, H, D = q.shape
    scale = 1.0 / (D ** 0.5)
    valid = _decode_valid(cache_len, k_cache.shape[1], q.device, window)
    qf = (q.float() * scale).permute(0, 2, 1, 3)                 # (B,H,1,D)
    s = _softcap(torch.matmul(qf, k_cache.float().permute(0, 2, 3, 1)),
                 softcap)                                         # (B,H,1,S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v_cache.float().permute(0, 2, 1, 3))     # (B,H,1,D)
    return o.permute(0, 2, 1, 3).to(q.dtype)


def decode_attention_grouped(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len, *,
                             window: int = 0,
                             softcap: float = 0.0) -> torch.Tensor:
    """GQA decode without materialising ``repeat_kv``: q regrouped to (B,
    KH, G, D) against the KH-headed cache; the same math as
    ``decode_attention``."""
    B, _, H, D = q.shape
    Smax, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = 1.0 / (D ** 0.5)
    valid = _decode_valid(cache_len, Smax, q.device, window)
    qg = (q.float() * scale).reshape(B, KH, G, D)
    s = _softcap(torch.matmul(qg, k_cache.float().permute(0, 2, 3, 1)),
                 softcap)                                        # (B,KH,G,S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v_cache.float().permute(0, 2, 1, 3))    # (B,KH,G,D)
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_partial(q: torch.Tensor, k_slice: torch.Tensor,
                   v_slice: torch.Tensor, cache_len, *, offset: int = 0,
                   window: int = 0, softcap: float = 0.0,
                   grouped: bool = False):
    """Flash-decoding's partial stats of one slice of a cache: the slots
    ``offset`` + 0..n-1 of the whole cache, masked as ``decode_attention``
    masks them there.  q: (B, 1, H, D), every query head; k_slice,
    v_slice: (B, n, KH, D), KH dividing H; ``grouped`` contracts q
    regrouped to (B, KH, G, D) against the KH heads, else the slice is
    repeated to H heads.  Returns float32 (m (B, H), l (B, H), o (B, H,
    D)): the largest softcapped score of the slice's valid slots
    (``NEG_INF`` where none is valid), the sum of exp(s - m) over them
    and the sum of exp(s - m) v -- both 0 without a valid slot."""
    B, _, H, D = q.shape
    n, KH = k_slice.shape[1], k_slice.shape[2]
    G = H // KH
    scale = 1.0 / (D ** 0.5)
    valid = _decode_valid(cache_len, n, q.device, window, offset)[:, None]
    if grouped:
        qg = (q.float() * scale).reshape(B, KH, G, D)
        s = torch.matmul(qg, k_slice.float().permute(0, 2, 3, 1))
        s = s.reshape(B, H, n)
    else:
        qf = (q.float() * scale).permute(0, 2, 1, 3)            # (B,H,1,D)
        kf = repeat_kv(k_slice, G).float().permute(0, 2, 3, 1)
        s = torch.matmul(qf, kf)[:, :, 0]                       # (B,H,n)
    s = torch.where(valid, _softcap(s, softcap), NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    if grouped:
        o = torch.matmul(p.reshape(B, KH, G, n),
                         v_slice.float().permute(0, 2, 1, 3))   # (B,KH,G,D)
        o = o.reshape(B, H, D)
    else:
        o = torch.matmul(p[:, :, None],
                         repeat_kv(v_slice, G).float().permute(0, 2, 1, 3))
        o = o[:, :, 0]
    return m, p.sum(dim=-1), o


def flash_decode(q: torch.Tensor, k_slice: torch.Tensor,
                 v_slice: torch.Tensor, cache_len, *, offset: int = 0,
                 window: int = 0, softcap: float = 0.0,
                 grouped: bool = False, all_max=None,
                 all_sum=None) -> torch.Tensor:
    """Decode attention over a cache whose sequence is split over ranks
    (the JAX package's flash-decoding layout): this rank's
    ``decode_partial`` of its slice, then the running max reduced over
    the ranks by ``all_max`` to m, and l and o each reduced by
    ``all_sum`` as the sum of x_r exp(m_r - m) (one call over both),
    giving o / l.  A slice without a valid slot weighs exp(NEG_INF - m)
    = 0 exactly.  Without the reductions (one slice) it is
    ``decode_attention`` over the whole cache, up to the rounding of the
    split sums.  Returns (B, 1, H, D) in q's dtype."""
    m, l, o = decode_partial(q, k_slice, v_slice, cache_len, offset=offset,
                             window=window, softcap=softcap, grouped=grouped)
    if all_max is not None:
        w = torch.exp(m - all_max(m))
        lo = all_sum(torch.cat([o * w[..., None], (l * w)[..., None]],
                               dim=-1))
        o, l = lo[..., :-1], lo[..., -1]
    return (o / l[..., None])[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def activation(h: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SiLU (``silu``, ``swiglu``) or tanh-GELU (``gelu_glu``, ``gelu``), op
    by op in ``h``'s dtype as ``jax.nn.silu`` and ``jax.nn.gelu`` expand:
    in bfloat16 each op rounds, as XLA's do, where torch's fused
    ``F.silu``/``F.gelu`` round once (a bfloat16 step apart in ~40% of
    elements)."""
    if act in ("silu", "swiglu"):
        return h * torch.reciprocal(1 + torch.exp(-h))
    # the constants rounded to h's dtype, as jnp casts them, kept on the
    # host: no copy to the card per call
    c1, c2 = (float(torch.tensor(c, dtype=h.dtype))
              for c in (0.044715, math.sqrt(2 / math.pi)))
    return h * (0.5 * (1 + torch.tanh(c2 * (h + c1 * (h * h * h)))))


def glu_mlp(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor, act: str = "silu", dist=None,
            width: int = 0) -> torch.Tensor:
    """SwiGLU / GeGLU: act(x@w1) * (x@w3) @ w2.  Over a model group
    (``dist``) whose ranks hold w1 and w3 split on their last dim and w2
    on its first -- ``width`` the whole hidden width -- each rank's
    product is a partial sum, all-reduced."""
    if dist is not None and split_dim(w1.shape[-1], width, dist):
        return reduce_from(glu_mlp(copy_to(x, dist), w1, w3, w2, act), dist)
    return (activation(x @ w1, act) * (x @ w3)) @ w2


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, dist=None,
             width: int = 0) -> torch.Tensor:
    """The plain tanh-GELU MLP with biases (whisper), in jnp's promoted
    dtype: float32 activations stay float32 against bfloat16 weights.
    Over a model group, w1 and b1 split on their last dim and w2 on its
    first as ``glu_mlp``'s; b2 is added after the all-reduce."""
    if dist is not None and split_dim(w1.shape[-1], width, dist):
        h = activation(mm(copy_to(x, dist), w1) + b1, "gelu")
        return reduce_from(mm(h, w2), dist) + b2
    h = activation(mm(x, w1) + b1, "gelu")
    return mm(h, w2) + b2


# ---------------------------------------------------------------------------
# sinusoid positions (whisper's encoder)
# ---------------------------------------------------------------------------

def sinusoid_positions(length: int, dim: int,
                       device=None) -> torch.Tensor:
    """(length, dim) float32: sin then cos of position x exp(-i log(1e4) /
    (dim/2 - 1)), each step in float32 as jnp takes it (log(1e4) rounded
    to float32 first)."""
    log_timescale = torch.log(torch.tensor(10_000.0, device=device)) \
        / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        dim // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32,
                          device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------------------
# softmax cross-entropy
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits: (..., V); labels: (...) int.  The mean NLL in float32: the
    log-sum-exp (shifted by the row max) minus the gold logit."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()
