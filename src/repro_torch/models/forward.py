"""Forward passes, the port's copy of ``repro.models.forward``: the dense
and vlm trunk (a uniform stack, full or sliding-window, or gemma3's
local/global pattern), the moe trunk, the rwkv6 trunk (``ssm``), zamba2's
Mamba2 hybrid trunk, and whisper's encoder and decoder trunks with the
decoder's cross-attention K/V (``encdec``); and the chunked
cross-entropy of the training loss.

Over a model axis above 1 (``dist``) each rank runs its model shard:
query heads and KV heads of column-split ``wq``/``wk``/``wv`` (K and V
gathered whole where the split cuts KV heads) and the row-split ``wo``,
the MLPs' column and row halves, its vocabulary slice of the embedding,
the cross-entropy and the logits (gathered whole), its experts, and
RWKV6's heads; the collectives are ``distributed.tensor_parallel``'s.
In prefill and decode each rank holds its shard of the KV caches: its
KV heads, or where KH % tp != 0 its slice of the sequence, attended
through flash decoding (``cache_layout``, ``_attn_tp``).

Modes: ``train`` (the whole sequence, no caches; with ``remat`` each
block the JAX package wraps in ``jax.checkpoint`` is recomputed in the
backward pass, and ``causal_skip`` reaches ``blockwise_attention``),
``prefill`` (the whole prompt; fills the KV caches when given them) and
``decode`` (one token per sequence against the caches).  Each layer
stack is a Python loop over the stacked ``(L, ...)`` parameters, in
place of ``lax.scan``, each leaf unbound once per stack (``unstack``).
KV caches are written in place: the KV tensors the caller passes come
back updated, not copied.  Recurrent states are
returned as new tensors, stacked over the layers: a state the caller
passes seeds the recurrence and is not written.

A sliding-window layer whose cache holds exactly ``window`` slots keeps a
ring: position p lives in slot p mod window.  Decode writes in position
order, so each slot's position follows from the current one and no
position cache is kept.  (The serving engine's persistent group cache is
another thing, its "group cache ring": one slot per request.)
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import (copy_to, gather_last,
                                                     max_from, reduce_from,
                                                     split_dim, tp_size)
from repro_torch.models import layers as L
from repro_torch.models.cache_layout import KVSlice, kv_layout
from repro_torch.models.dist import DistContext
from repro_torch.models.moe import moe_layer
from repro_torch.models.rwkv import RWKVState, rwkv6_block
from repro_torch.models.ssm import MambaState, mamba2_block


def _sub(params: Dict, prefix: str) -> Dict:
    """Strip a key prefix: {'blocks_wq': a} -> {'wq': a}."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def layer_params(stack: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters from a stacked ``(L, ...)`` dict."""
    return {k: v[i] for k, v in stack.items()}


def unstack(stack: Dict, n: int) -> List[Dict]:
    """The ``n`` layers' parameters of a stacked ``(n, ...)`` dict, each
    leaf unbound once: the backward pass then stacks the layers'
    gradients of a leaf in one step, where indexing each layer would add
    a leaf-sized gradient per layer."""
    parts = {k: v.unbind(0) for k, v in stack.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def shard_act(x: torch.Tensor, dist: Optional[DistContext], *spec_tail):
    """The activation's sharding constraint: the identity.  Each rank
    already holds its own rows, replicated over the model group."""
    return x


def _maybe_remat(fn, remat: bool):
    """``fn``, recomputed in the backward pass instead of keeping its
    intermediates when ``remat`` (``jax.checkpoint``'s role).  No block
    draws randomness or reads state that changes between the forward
    pass and the recompute."""
    if not remat:
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _vocab_slice(ids: torch.Tensor, n: int, dist):
    """The rank's local index of each id in its slice of ``n`` rows of the
    vocabulary (clamped into it), and whether the id lies in the slice."""
    local = ids.long() - dist.model_rank * n
    inside = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), inside


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor,
           dist=None) -> torch.Tensor:
    """The rows of ``tokens``; over a model group whose ranks hold the
    vocabulary split, each rank looks up the ids in its slice, zeroes the
    rest, and the all-reduce sums the one row each id has."""
    w = params["embed"]
    if not split_dim(w.shape[0], cfg.vocab_size, dist):
        return w[tokens.long()]
    local, inside = _vocab_slice(tokens, w.shape[0], dist)
    e = torch.where(inside[..., None], w[local], w.new_zeros(()))
    return reduce_from(e, dist)


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return x @ w.T


def logits(params, cfg: ModelConfig, x: torch.Tensor,
           dist=None) -> torch.Tensor:
    """The whole logits of ``x`` on every rank: over a model group whose
    ranks hold the vocabulary split, each rank's slice gathered, as the
    JAX package's partitioner returns them."""
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    if not split_dim(w.shape[0], cfg.vocab_size, dist):
        return _unembed(params, cfg, x)
    return gather_last(_unembed(params, cfg, copy_to(x, dist)), dist)


def _vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                       dist) -> torch.Tensor:
    """``L.cross_entropy`` of logits split over the model group on their
    last dim: the row max (a shift, no gradient), the sum of
    exponentials and the label's logit each all-reduced."""
    import torch.distributed as tdist
    logits = logits.float()
    with torch.no_grad():
        m = logits.amax(dim=-1, keepdim=True)
        tdist.all_reduce(m, op=tdist.ReduceOp.MAX, group=dist.model_group())
    se = reduce_from(torch.exp(logits - m).sum(dim=-1), dist)
    lse = m[..., 0] + torch.log(se)
    local, inside = _vocab_slice(labels, logits.shape[-1], dist)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    gold = reduce_from(torch.where(inside, gold, logits.new_zeros(())), dist)
    return (lse - gold).mean()


def chunked_ce(params, cfg: ModelConfig, x: torch.Tensor,
               labels: torch.Tensor, chunk: int = 512,
               dist=None) -> torch.Tensor:
    """The mean cross-entropy of (B, S, D) ``x`` against (B, S) ``labels``
    without a (B, S, V) tensor: ``chunk`` rows at a time (halved until it
    divides S), each chunk's mean times 1/n added to a float32 total in
    chunk order, as the JAX package's scan adds them.  Over a model
    group whose ranks hold the vocabulary split, each chunk's logits are
    the rank's slice (``_vocab_parallel_ce``)."""
    B, S, _ = x.shape
    chunk = max(1, min(chunk, S))
    while S % chunk:
        chunk //= 2
    n = S // chunk
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    split = split_dim(w.shape[0], cfg.vocab_size, dist)
    if split:
        x = copy_to(x, dist)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        logits = _unembed(params, cfg, x[:, c0:c0 + chunk])
        lab = labels[:, c0:c0 + chunk]
        ce = _vocab_parallel_ce(logits, lab, dist) if split \
            else L.cross_entropy(logits, lab)
        tot = tot + ce * (1.0 / n)
    return tot


def _rope(cfg: ModelConfig, S: int, pos0=0, positions=None, theta=None,
          device=None):
    """(sin, cos, sin, cos) tables at ``positions``, else at ``pos0 +
    arange(S)``; ``pos0`` a scalar, or a (B,) tensor of per-sequence
    starts (the batch dimension the JAX engine vmaps over)."""
    theta = theta or cfg.rope_theta
    if positions is None:
        steps = torch.arange(S, device=device)
        if torch.is_tensor(pos0) and pos0.ndim == 1:
            positions = pos0[:, None].to(device) + steps[None, :]
        else:
            positions = steps + int(pos0)
    sin, cos = L.rope_table(positions, cfg.head_dim, theta)
    return (sin, cos, sin, cos)


def project_qkv(x: torch.Tensor, lp: Dict, cfg: ModelConfig, rope_sincos,
                prefix: str = "", kv_src: Optional[torch.Tensor] = None):
    """The attention's q/k/v projections of (B, S, D) ``x`` -- k and v of
    ``kv_src`` (B, S_kv, D) when given (cross-attention) --, with the qk
    norms when the layer has them and RoPE at the given tables: q (B, S,
    H, Dh), k and v (B, S_kv, KH, Dh).  Products in jnp's promoted
    dtype."""
    Dh = cfg.head_dim

    def proj(name, src, heads):
        y = L.mm(src, lp[prefix + "w" + name])
        b = lp.get(prefix + "b" + name)
        if b is not None:
            y = y + b
        return y.reshape(src.shape[0], src.shape[1], heads, Dh)

    src = x if kv_src is None else kv_src
    q = proj("q", x, cfg.num_heads)
    k = proj("k", src, cfg.num_kv_heads)
    v = proj("v", src, cfg.num_kv_heads)
    if prefix + "qnorm" in lp:
        q = L.rmsnorm(q, lp[prefix + "qnorm"], cfg.norm_eps)
        k = L.rmsnorm(k, lp[prefix + "knorm"], cfg.norm_eps)
    if rope_sincos is not None:
        sin_q, cos_q, sin_k, cos_k = rope_sincos
        q = L.apply_rope(q, sin_q, cos_q)
        k = L.apply_rope(k, sin_k, cos_k)
    return q, k, v


def _write_prompt(cache, k, v, sl: KVSlice, window: int) -> None:
    """Prefill's cache write of k, v (B, S, KH, Dh) into a rank's slots
    (``sl``) of a cache: rows [0, S), or in a ring the last min(window,
    S) rows at their row index mod window (padding rows of a packed
    prompt included, as in the JAX package); a slice of the sequence
    takes the rows of its own slots."""
    S, n = k.shape[1], cache[0].shape[1]
    cap = min(S, window) if sl.ring else S
    lo = sl.offset
    hi = max(lo, min(lo + n, cap))
    if sl.ring:         # slot s: the last row r < S with r = s mod window
        slots = torch.arange(lo, hi, device=k.device)
        rows = S - 1 - (S - 1 - slots) % window
    else:
        rows = slice(lo, hi)
    for c, x in zip(cache, (k, v)):
        c[:, :hi - lo] = x[:, rows].to(c.dtype)


def _decode(q, k, v, cache, pos, window: int, cfg: ModelConfig,
            sl: KVSlice, dist=None):
    """Decode against a rank's slots (``sl``) of a cache: each row writes
    its token's k, v (B, 1, KH, Dh) at slot ``pos`` (a ring's pos mod
    window) where the rank holds it, and q (B, 1, H, Dh) attends the
    slots below the row's length -- over a slice of the sequence
    through ``L.flash_decode``, every rank's partial stats combined over
    the model group.  Returns (B, 1, H, Dh)."""
    k_cache, v_cache = cache
    B, n = q.shape[0], k_cache.shape[1]
    pos = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    if sl.ring:
        # each row writes slot pos mod window.  Slot s holds position
        # pos - ((pos - s) mod window), valid once >= 0: that is s <=
        # pos, or every slot once pos >= window - 1 -- the slots below
        # a length of pos + 1, each inside the window already
        at, clen, win = pos % window, pos + 1, 0
    else:
        # one row per sequence; like dynamic_update_slice, a start
        # past the end is clamped to the last row
        at = pos.clamp(0, sl.length - 1)
        clen, win = at + 1, window
    rows = torch.arange(B, device=q.device)
    if sl.split:
        # every row writes its slot on its owner and its own value back
        # elsewhere: no host sync to select the rows
        mine = ((at >= sl.offset) & (at < sl.offset + n))[:, None, None]
        at = (at - sl.offset).clamp(0, n - 1)
        for c, new in ((k_cache, k), (v_cache, v)):
            c[rows, at] = torch.where(mine, new[:, 0].to(c.dtype),
                                      c[rows, at])
        return L.flash_decode(
            q, k_cache, v_cache, clen, offset=sl.offset, window=win,
            softcap=cfg.logit_softcap, grouped=cfg.decode_grouped_attn,
            all_max=functools.partial(max_from, ctx=dist),
            all_sum=functools.partial(reduce_from, ctx=dist))
    k_cache[rows, at] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, at] = v[:, 0].to(v_cache.dtype)
    if cfg.decode_grouped_attn:
        return L.decode_attention_grouped(
            q, k_cache, v_cache, clen, window=win, softcap=cfg.logit_softcap)
    G = q.shape[2] // k_cache.shape[2]
    return L.decode_attention(
        q, L.repeat_kv(k_cache, G), L.repeat_kv(v_cache, G), clen,
        window=win, softcap=cfg.logit_softcap)


def _attn_tp(x, lp: Dict, cfg: ModelConfig, dist, *, window, rope_sincos,
             mode, cache, pos, causal, kv_src, positions, causal_skip,
             prefix):
    """``attn_sublayer`` over a model group.  A rank whose ``wq`` is
    column-split runs its H/tp query heads (``qnorm`` per head) and its
    rows of the row-split ``wo``, all-reduced.  Its K and V: its own KV
    heads where the split of ``wk``/``wv`` keeps them whole, else K and V
    gathered whole (or projected whole, where they are not split) and the
    KV heads its query heads map to taken from them.  Where ``wq`` is not
    split the attention runs whole on every rank.

    The cache follows ``cache_layout.kv_layout``: the rank's own KV
    heads, which prefill and decode write and decode attends as on one
    rank; or, under the sequence split, the rank's slots of every KV
    head, into which prefill writes the gathered K and V and decode the
    token on the slot's owner, and which decode attends with q gathered
    whole (``_decode``), each rank then taking its own query heads' rows
    into ``wo``."""
    B, S, _ = x.shape
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G, tp = H // KH, dist.tp
    src = x if kv_src is None else kv_src
    Skv = src.shape[1]
    q_split = split_dim(lp[prefix + "wq"].shape[-1], cfg.q_dim, dist)
    kv_split = split_dim(lp[prefix + "wk"].shape[-1], cfg.kv_dim, dist)
    if q_split and H % tp:
        raise NotImplementedError(
            f"{H} query heads over a model group of {tp}: the column split "
            f"of wq cuts heads")
    Hl = H // tp if q_split else H
    lay = kv_layout(cfg, dist)
    own_kv = kv_split and not lay.seq     # the split keeps KV heads whole

    def proj(name, inp):
        y = L.mm(inp, lp[prefix + "w" + name])
        b = lp.get(prefix + "b" + name)
        return y if b is None else y + b

    xq = copy_to(x, dist) if q_split else x
    xs = src if not kv_split else (xq if kv_src is None
                                   else copy_to(src, dist))
    q = proj("q", xq).reshape(B, S, Hl, Dh)
    k, v = proj("k", xs), proj("v", xs)
    if kv_split and not own_kv:
        k, v = gather_last(k, dist), gather_last(v, dist)
    KHl = KH // tp if own_kv else KH
    k, v = k.reshape(B, Skv, KHl, Dh), v.reshape(B, Skv, KHl, Dh)
    if prefix + "qnorm" in lp:
        qn, kn = lp[prefix + "qnorm"], lp[prefix + "knorm"]
        q = L.rmsnorm(q, copy_to(qn, dist) if q_split else qn, cfg.norm_eps)
        k = L.rmsnorm(k, copy_to(kn, dist) if own_kv else kn, cfg.norm_eps)
    if rope_sincos is not None:
        sin_q, cos_q, sin_k, cos_k = rope_sincos
        q = L.apply_rope(q, sin_q, cos_q)
        k = L.apply_rope(k, sin_k, cos_k)
    sl = None if cache is None else lay.slice(cache[0].shape[1], window)
    if mode == "decode":
        if own_kv:
            o = _decode(q, k, v, cache, pos, window, cfg, sl)
        else:
            h0 = dist.model_rank * Hl
            qa = gather_last(q.reshape(B, 1, Hl * Dh), dist).reshape(
                B, 1, H, Dh) if q_split else q
            o = _decode(qa, k, v, cache, pos, window, cfg, sl, dist)
            o = o[:, :, h0:h0 + Hl] if q_split else o
    elif mode in ("prefill", "train"):       # train writes no cache
        if mode == "prefill" and cache is not None:
            _write_prompt(cache, k, v, sl, window)
        if own_kv or not q_split:
            k, v = L.repeat_kv(k, G), L.repeat_kv(v, G)
        else:               # the KV head of each of this rank's query heads
            h0 = dist.model_rank * Hl
            idx = torch.arange(h0, h0 + Hl, device=x.device) // G
            k, v = copy_to(k, dist)[:, :, idx], copy_to(v, dist)[:, :, idx]
        o = L.blockwise_attention(
            q, k, v, causal=causal, window=window, softcap=cfg.logit_softcap,
            q_positions=positions, kv_positions=positions,
            causal_skip=causal_skip)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = L.mm(o.reshape(B, S, Hl * Dh), lp[prefix + "wo"])
    if q_split:
        out = reduce_from(out, dist)
    bo = lp.get(prefix + "bo")
    return out if bo is None else out + bo


def attn_sublayer(x, lp: Dict, cfg: ModelConfig, *, window: int = 0,
                  rope_sincos=None, mode: str = "prefill",
                  cache: Optional[Tuple] = None, pos=0, causal: bool = True,
                  kv_src=None, positions=None, causal_skip: bool = False,
                  prefix: str = "", dist=None):
    """Returns (attn_out (B, S, D), cache or None).  ``cache`` is (k_cache,
    v_cache) (B, Smax, KH, Dh), written in place: rows [0, S) in prefill,
    each sequence's row ``pos`` (a scalar or (B,) tensor) in decode -- or,
    with ``window > 0`` and Smax == window, the ring's slots: prefill
    writes the last min(window, S) rows at their row index mod window,
    decode slot pos mod window.  ``train`` is prefill's attention with no
    cache written, ``causal_skip`` passed to ``blockwise_attention``.
    Prefill and train attention is causal unless ``causal`` is False;
    with ``kv_src`` (B, S_kv, D) k and v are its projections
    (cross-attention).  Over a model axis above 1 (``dist``) the rank
    runs ``_attn_tp`` on its shard of the parameters and of the cache
    (``cache_layout.kv_layout``)."""
    if tp_size(dist) > 1:
        return _attn_tp(x, lp, cfg, dist, window=window,
                        rope_sincos=rope_sincos, mode=mode, cache=cache,
                        pos=pos, causal=causal, kv_src=kv_src,
                        positions=positions, causal_skip=causal_skip,
                        prefix=prefix), cache
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    G = H // cfg.num_kv_heads
    q, k, v = project_qkv(x, lp, cfg, rope_sincos, prefix, kv_src)
    sl = None if cache is None else \
        kv_layout(cfg, None).slice(cache[0].shape[1], window)
    if mode == "decode":
        o = _decode(q, k, v, cache, pos, window, cfg, sl)
    elif mode in ("prefill", "train"):       # train writes no cache
        if mode == "prefill" and cache is not None:
            _write_prompt(cache, k, v, sl, window)
        o = L.blockwise_attention(
            q, L.repeat_kv(k, G), L.repeat_kv(v, G), causal=causal,
            window=window, softcap=cfg.logit_softcap, q_positions=positions,
            kv_positions=positions, causal_skip=causal_skip)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    out = L.mm(o.reshape(B, S, H * Dh), lp[prefix + "wo"])
    bo = lp.get(prefix + "bo")
    if bo is not None:
        out = out + bo
    return out, cache


def dense_block(x, lp, cfg: ModelConfig, *, window=0, rope_sincos,
                mode="prefill", cache=None, pos=0, positions=None,
                causal_skip=False, dist=None):
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a, new_cache = attn_sublayer(
        h, lp, cfg, window=window, rope_sincos=rope_sincos, mode=mode,
        cache=cache, pos=pos, positions=positions, causal_skip=causal_skip,
        dist=dist)
    x = x + a
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = x + L.glu_mlp(h, lp["w1"], lp["w3"], lp["w2"], act=cfg.act,
                      dist=dist, width=cfg.d_ff)
    return x, new_cache


def _dense_x(x, lp, cfg: ModelConfig, **kw):
    """``dense_block``'s output alone: the unit remat recomputes."""
    return dense_block(x, lp, cfg, **kw)[0]


def moe_block(x, lp, cfg: ModelConfig, *, rope_sincos, mode="prefill",
              cache=None, pos=0, positions=None, causal_skip=False,
              dist=None):
    """Full attention, then the MoE layer (with the shared experts when
    the layer has them; ``dist`` as ``moe_layer`` takes it).  Returns (x,
    aux, dropped, cache)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a, new_cache = attn_sublayer(
        h, lp, cfg, rope_sincos=rope_sincos, mode=mode, cache=cache,
        pos=pos, positions=positions, causal_skip=causal_skip, dist=dist)
    x = x + a
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    shared = None
    if "shared_wg" in lp:
        shared = (lp["shared_wg"], lp["shared_wu"], lp["shared_wd"])
    y, aux, dropped = moe_layer(h, lp["router"], lp["moe_wg"], lp["moe_wu"],
                                lp["moe_wd"], cfg, dist=dist,
                                shared=shared)
    return x + y, aux, dropped, new_cache


def _moe_x(x, lp, cfg: ModelConfig, **kw):
    """``moe_block``'s (x, aux, dropped): the unit remat recomputes."""
    return moe_block(x, lp, cfg, **kw)[:3]


def _run_stack(x, params, prefix: str, n: int, cfg: ModelConfig, caches,
               *, window: int, rope_sincos, remat=False, **kw):
    """Layers 0..n-1 of the dense stack under ``prefix``, layer i against
    cache i of ``caches`` ((n, B, Smax, KH, Dh) pair) when given, each
    layer recomputed in the backward pass with ``remat``."""
    block = _maybe_remat(_dense_x, remat)
    for i, lp in enumerate(unstack(_sub(params, prefix), n)):
        cache = (caches[0][i], caches[1][i]) if caches is not None else None
        x = block(x, lp, cfg, window=window, rope_sincos=rope_sincos,
                  cache=cache, **kw)
    return x


def dense_trunk(params, cfg: ModelConfig, x, *, mode="prefill", caches=None,
                pos=0, positions=None, remat=False, causal_skip=False,
                dist=None):
    """Runs the dense blocks over (B, S, D) ``x``: the uniform stack
    ``blocks_`` (every layer at ``cfg.window_size``), or with
    ``cfg.global_every > 1`` gemma3's pattern -- ``n_super`` super-blocks
    of ``global_every - 1`` local layers (window ``cfg.window_size``,
    RoPE theta 10,000) and one global layer (full attention at
    ``cfg.rope_theta``), then the trailing local layers.  ``caches``:
    {"blocks": (k, v)}, or {"local", "global"[, "trail"]}, each pair of
    (L, B, Smax, KH, Dh), written in place.  In train mode ``remat``
    recomputes each layer -- gemma3's local and global layers each, its
    trailing layers not, as the JAX package wraps them.  Returns (x,
    caches)."""
    S = x.shape[1]
    # remat and causal_skip act in train mode only, as in the JAX package
    train = mode == "train"
    remat, causal_skip = remat and train, causal_skip and train
    kw = dict(mode=mode, pos=pos, positions=positions,
              causal_skip=causal_skip, dist=dist)
    caches_of = (lambda key: caches[key]) if caches is not None \
        else (lambda key: None)
    if cfg.global_every <= 1:
        rope = _rope(cfg, S, pos0=pos, positions=positions, device=x.device)
        x = _run_stack(x, params, "blocks_", cfg.num_layers, cfg,
                       caches_of("blocks"), window=cfg.window_size,
                       rope_sincos=rope, remat=remat, **kw)
        return x, caches
    n_super = cfg.num_layers // cfg.global_every
    n_lp = cfg.global_every - 1
    n_trail = cfg.num_layers - n_super * cfg.global_every
    rope_l = _rope(cfg, S, pos0=pos, positions=positions, theta=10_000.0,
                   device=x.device)
    rope_g = _rope(cfg, S, pos0=pos, positions=positions,
                   theta=cfg.rope_theta, device=x.device)
    local = unstack(_sub(params, "local_"), n_super * n_lp)
    glob = unstack(_sub(params, "global_"), n_super)
    lc, gc = caches_of("local"), caches_of("global")
    block = _maybe_remat(_dense_x, remat)
    for sb in range(n_super):
        # local layer sb * n_lp + j: the JAX package's (n_super, n_lp)
        # reshape of the local stack, in the same order
        for i in range(sb * n_lp, (sb + 1) * n_lp):
            cache = (lc[0][i], lc[1][i]) if lc is not None else None
            x = block(x, local[i], cfg, window=cfg.window_size,
                      rope_sincos=rope_l, cache=cache, **kw)
        cache = (gc[0][sb], gc[1][sb]) if gc is not None else None
        x = block(x, glob[sb], cfg, window=0, rope_sincos=rope_g,
                  cache=cache, **kw)
    if n_trail:
        x = _run_stack(x, params, "trail_", n_trail, cfg, caches_of("trail"),
                       window=cfg.window_size, rope_sincos=rope_l, **kw)
    return x, caches


def moe_trunk(params, cfg: ModelConfig, x, *, mode="prefill", caches=None,
              pos=0, positions=None, remat=False, causal_skip=False,
              dist=None):
    """The ``cfg.first_dense_layers`` dense layers (``dense_``), then the
    MoE blocks (``blocks_``, each ``moe_layer`` given ``dist``), all at
    full attention.  ``caches``:
    {"blocks": (k, v)[, "dense": (k, v)]}, written in place.  In train
    mode ``remat`` recomputes each block.  Returns (x, caches, aux,
    dropped): the router's load-balance loss and the dropped share, each
    summed over the MoE layers."""
    S = x.shape[1]
    # remat and causal_skip act in train mode only, as in the JAX package
    train = mode == "train"
    remat, causal_skip = remat and train, causal_skip and train
    rope = _rope(cfg, S, pos0=pos, positions=positions, device=x.device)
    kw = dict(mode=mode, pos=pos, positions=positions,
              causal_skip=causal_skip, dist=dist)
    if cfg.first_dense_layers:
        x = _run_stack(x, params, "dense_", cfg.first_dense_layers, cfg,
                       caches["dense"] if caches is not None else None,
                       window=0, rope_sincos=rope, remat=remat, **kw)
    n = cfg.num_layers - cfg.first_dense_layers
    aux_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    drop_tot = torch.zeros((), dtype=torch.float32, device=x.device)
    ck, cv = caches["blocks"] if caches is not None else (None, None)
    block = _maybe_remat(_moe_x, remat)
    for i, lp in enumerate(unstack(_sub(params, "blocks_"), n)):
        cache = (ck[i], cv[i]) if ck is not None else None
        x, aux, dropped = block(x, lp, cfg, rope_sincos=rope, cache=cache,
                                **kw)
        aux_tot = aux_tot + aux
        drop_tot = drop_tot + dropped
    return x, caches, aux_tot, drop_tot


def _rwkv_x(x, lp, cfg: ModelConfig, dist=None):
    """One stateless RWKV6 block's output: the unit remat recomputes."""
    return rwkv6_block(x, lp, cfg, dist=dist)[0]


def rwkv_trunk(params, cfg: ModelConfig, x, *, mode="prefill", states=None,
               remat=False, dist=None):
    """``ln_in``, then the RWKV6 layers over (B, S, D) ``x``.  ``states``:
    (wkv (L, B, H, P, P), shift_t (L, B, D), shift_c (L, B, D)) float32,
    each layer's seed, or None for zeros.  Returns (x, the new states as
    the same tuple, or None without ``states``).  No positions: a packed
    prompt's padding rows run through the recurrence (ROADMAP C-R5).
    Without ``states``, in train mode, ``remat`` recomputes each
    block."""
    layers = unstack(_sub(params, "blocks_"), cfg.num_layers)
    x = L.rmsnorm(x, params["ln_in"], cfg.norm_eps)
    if states is None:
        block = _maybe_remat(_rwkv_x, remat and mode == "train")
        for lp in layers:
            x = block(x, lp, cfg, dist)
        return x, None
    new = []
    for i, lp in enumerate(layers):
        x, ns = rwkv6_block(x, lp, cfg,
                            state=RWKVState(*(s[i] for s in states)),
                            single_step=mode == "decode", dist=dist)
        new.append(ns)
    return x, tuple(torch.stack(parts) for parts in zip(*new))


def _mamba_pdict(lp: Dict) -> Dict:
    """Map a stacked layer's ``m_*`` keys to ``mamba2_block``'s names."""
    return {"in_proj": lp["m_in"], "conv_w": lp["m_conv_w"],
            "conv_b": lp["m_conv_b"], "A_log": lp["m_A_log"],
            "D_skip": lp["m_D"], "dt_bias": lp["m_dt_bias"],
            "norm_w": lp["m_norm"], "out_proj": lp["m_out"]}


def _mamba_residual(x, lp, cfg: ModelConfig, state=None,
                    single_step=False, dist=None):
    """x + one Mamba2 block of its norm: (x, the block's new state)."""
    h = L.rmsnorm(x, lp["m_ln"], cfg.norm_eps)
    y, ns = mamba2_block(h, _mamba_pdict(lp), cfg, state=state,
                         single_step=single_step, dist=dist)
    return x + y, ns


def _mamba_x(x, lp, cfg: ModelConfig, dist=None):
    """One stateless Mamba2 residual's output: the unit remat
    recomputes."""
    return _mamba_residual(x, lp, cfg, dist=dist)[0]


def hybrid_trunk(params, cfg: ModelConfig, x, *, mode="prefill",
                 states=None, caches=None, pos=0, remat=False, dist=None):
    """zamba2: the Mamba2 stack, with shared attention + MLP block ``i %
    num_shared_attn_blocks`` after the i-th run of ``attn_every`` Mamba2
    blocks.  ``states``: (ssm (L, B, H, N, P) f32, conv (L, B, cw - 1,
    cd)), each layer's seed, or None for zeros; ``caches``: the (n_apps,
    B, Smax, KH, Dh) KV pair, one cache per application of a shared
    block, written in place.  The attention takes no positions -- RoPE at
    ``pos`` + the row index, as the JAX package's, so a packed prompt's
    rows sit at their packed index (ROADMAP C-R5).  Without ``states``,
    in train mode, ``remat`` recomputes each Mamba2 block (not the shared
    blocks, as in the JAX package).  Returns (x, the new states or None,
    caches)."""
    S = x.shape[1]
    per = cfg.attn_every
    layers = unstack(_sub(params, "blocks_"), cfg.num_layers)
    shared = unstack(_sub(params, "sa_"), cfg.num_shared_attn_blocks)
    rope = _rope(cfg, S, pos0=pos, device=x.device)
    block = _maybe_remat(_mamba_x, remat and mode == "train")
    new_ssm, new_conv = [], []
    for app in range(cfg.num_layers // per):
        for i in range(app * per, (app + 1) * per):
            if states is None:
                x = block(x, layers[i], cfg, dist)
                continue
            x, ns = _mamba_residual(
                x, layers[i], cfg,
                state=MambaState(states[0][i], states[1][i]),
                single_step=mode == "decode", dist=dist)
            new_ssm.append(ns.ssm)
            new_conv.append(ns.conv)
        sp = shared[app % cfg.num_shared_attn_blocks]
        cache = None if caches is None else (caches[0][app], caches[1][app])
        h = L.rmsnorm(x, sp["ln1"], cfg.norm_eps)
        a, _ = attn_sublayer(h, sp, cfg, rope_sincos=rope, mode=mode,
                             cache=cache, pos=pos, dist=dist)
        x = x + a
        h = L.rmsnorm(x, sp["ln2"], cfg.norm_eps)
        x = x + L.glu_mlp(h, sp["w1"], sp["w3"], sp["w2"], act=cfg.act,
                          dist=dist, width=cfg.d_ff)
    if states is None:
        return x, None, caches
    return x, (torch.stack(new_ssm), torch.stack(new_conv)), caches


# ---------------------------------------------------------------------------
# whisper's encoder-decoder (encdec)
# ---------------------------------------------------------------------------

def _gelu_mlp(x, lp, cfg: ModelConfig, dist=None):
    return L.gelu_mlp(x, lp["mlp_w1"], lp["mlp_b1"], lp["mlp_w2"],
                      lp["mlp_b2"], dist=dist, width=cfg.d_ff)


def _ln(x, lp, name, cfg: ModelConfig):
    return L.layernorm(x, lp[name], lp[name + "_b"], cfg.norm_eps)


def _encoder_block(x, lp, cfg: ModelConfig, dist=None):
    o, _ = attn_sublayer(_ln(x, lp, "ln1", cfg), lp, cfg, causal=False,
                         dist=dist)
    x = x + o
    return x + _gelu_mlp(_ln(x, lp, "ln2", cfg), lp, cfg, dist)


def encoder_trunk(params, cfg: ModelConfig, frames, *, remat=False,
                  dist=None):
    """frames: (B, S, frontend_dim) precomputed conv-frontend embeddings ->
    the memory (B, S, D): the linear adapter, sinusoid positions, pre-LN
    blocks of non-causal attention and a GELU MLP, the final LayerNorm.
    Float32 frames keep the encoder in float32 against bfloat16 weights,
    as jnp promotes them.  ``remat`` recomputes each block in the
    backward pass."""
    x = L.mm(frames, params["frontend_w"]) + params["frontend_b"]
    _, S, D = x.shape
    x = x + L.sinusoid_positions(S, D, device=x.device).to(x.dtype)
    block = _maybe_remat(_encoder_block, remat)
    for lp in unstack(_sub(params, "e_"), cfg.encoder_layers):
        x = block(x, lp, cfg, dist)
    return L.layernorm(x, params["enc_final_norm"],
                       params["enc_final_norm_b"], cfg.norm_eps)


def cross_kv(params, cfg: ModelConfig, memory, dist=None):
    """Every decoder layer's cross-attention K and V of ``memory``: (L, B,
    S_enc, KH, Dh) each, in the memory's promoted dtype (no k bias).
    Over a model group, the KV heads ``cache_layout.kv_layout`` holds:
    the rank's where KH % tp == 0, else all of them (gathered, where the
    ranks hold ``wk``/``wv`` column-split)."""
    xs = _sub(params, "x_")
    B, S, _ = memory.shape
    split = split_dim(xs["wk"].shape[-1], cfg.kv_dim, dist)
    whole = split and kv_layout(cfg, dist).seq

    def heads(y):
        y = gather_last(y, dist) if whole else y
        return y.reshape(B, S, -1, cfg.head_dim)

    ks = [heads(L.mm(memory, xs["wk"][i]))
          for i in range(cfg.decoder_layers)]
    vs = [heads(L.mm(memory, xs["wv"][i]) + xs["bv"][i])
          for i in range(cfg.decoder_layers)]
    return torch.stack(ks), torch.stack(vs)


def _dec_positions(params, T: int, pos, device) -> torch.Tensor:
    """``dec_pos`` rows [start, start + T) with start = ``pos`` clamped to
    [0, max_target_len - T], as ``dynamic_slice`` clamps its start (a
    decode past the table reads its last row); per sequence for a (B,)
    ``pos``.  Returns (1 or B, T, D)."""
    table = params["dec_pos"]
    start = torch.as_tensor(pos, device=device).reshape(-1).clamp(
        0, table.shape[0] - T)
    return table[start[:, None] + torch.arange(T, device=device)]


def _decoder_block(x, lp, xp, memory, cfg: ModelConfig, dist=None):
    """One decoder block without caches: causal self-attention,
    cross-attention projecting k and v of ``memory``, the GELU MLP."""
    o, _ = attn_sublayer(_ln(x, lp, "ln1", cfg), lp, cfg, dist=dist)
    x = x + o
    o, _ = attn_sublayer(_ln(x, lp, "ln2", cfg), xp, cfg, causal=False,
                         kv_src=memory, dist=dist)
    x = x + o
    return x + _gelu_mlp(_ln(x, lp, "ln3", cfg), lp, cfg, dist)


def decoder_trunk(params, cfg: ModelConfig, tokens, memory, *,
                  mode: str = "prefill", caches=None, pos=0, remat=False,
                  dist=None):
    """tokens (B, T) -> (x (B, T, D) before the final norm, caches).
    Learned positions from ``pos``, then pre-LN blocks of causal
    self-attention, cross-attention and a GELU MLP.  Without ``caches``
    the cross-attention projects k and v of ``memory`` (B, S_enc, D) in
    every layer, and ``remat`` recomputes each block in the backward pass
    (the training route); with ``caches`` {"self": (k, v) (L, B, Tmax,
    KH, Dh), written in place, "cross": (k, v) (L, B, S_enc, KH, Dh) from
    ``cross_kv``} it reads the cross K/V (``memory`` unused) and runs
    ``mode`` "prefill" or "decode" (one token at ``pos``, a scalar or
    (B,))."""
    x = _embed(params, cfg, tokens, dist)
    B, T, _ = x.shape
    x = x + _dec_positions(params, T, pos, x.device)
    layers = list(zip(unstack(_sub(params, "d_"), cfg.decoder_layers),
                      unstack(_sub(params, "x_"), cfg.decoder_layers)))
    if caches is None:
        block = _maybe_remat(_decoder_block, remat)
        for lp, xp in layers:
            x = block(x, lp, xp, memory, cfg, dist)
        return x, None
    sk, sv = caches["self"]
    for i, (lp, xp) in enumerate(layers):
        o, _ = attn_sublayer(_ln(x, lp, "ln1", cfg), lp, cfg, mode=mode,
                             cache=(sk[i], sv[i]), pos=pos, dist=dist)
        x = x + o
        x = x + _cross_cached(_ln(x, lp, "ln2", cfg), xp, cfg,
                              caches["cross"][0][i], caches["cross"][1][i],
                              mode, dist)
        x = x + _gelu_mlp(_ln(x, lp, "ln3", cfg), lp, cfg, dist)
    return x, caches


def _cross_cached(h, xp, cfg: ModelConfig, ck, cv, mode: str, dist=None):
    """The decoder's cross-attention of (B, T, D) ``h`` against the
    precomputed K/V (B, S_enc, KH, Dh) of ``cross_kv``.  Over a model
    group whose ranks hold ``wq`` column-split: the rank's query heads
    against its KV heads (or, where the layout holds all KV heads, the
    one each query head maps to), its rows of the row-split ``wo``,
    all-reduced."""
    B, T, _ = h.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    G = H // cfg.num_kv_heads
    q_split = split_dim(xp["wq"].shape[-1], cfg.q_dim, dist)
    Hl = H // dist.tp if q_split else H
    q = (L.mm(h, xp["wq"]) + xp["bq"]).reshape(B, T, Hl, Dh)
    if Hl == H or not kv_layout(cfg, dist).seq:
        xk, xv = L.repeat_kv(ck, G), L.repeat_kv(cv, G)
    else:                   # the KV head of each of this rank's query heads
        h0 = dist.model_rank * Hl
        idx = torch.arange(h0, h0 + Hl, device=h.device) // G
        xk, xv = ck[:, :, idx], cv[:, :, idx]
    if mode == "decode":
        o = L.decode_attention(q, xk, xv, xk.shape[1])
    else:
        o = L.blockwise_attention(q, xk, xv, causal=False)
    out = L.mm(o.reshape(B, T, Hl * Dh), xp["wo"])
    if q_split:
        out = reduce_from(out, dist)
    return out + xp["bo"]
