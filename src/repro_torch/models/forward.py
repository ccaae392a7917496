"""Forward passes of the dense/vlm uniform stack, the port's copy of the
parts of ``repro.models.forward`` the serving engine runs.

Modes: ``prefill`` (the whole prompt; fills the KV caches when given
them) and ``decode`` (one token per sequence against the caches).  The
layer stack is a Python loop over the stacked ``(L, ...)`` parameters, in
place of ``lax.scan``.  Caches are written in place: the KV tensors the
caller passes come back updated, not copied.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _sub(params: Dict, prefix: str) -> Dict:
    """Strip a key prefix: {'blocks_wq': a} -> {'wq': a}."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def layer_params(stack: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters from a stacked ``(L, ...)`` dict."""
    return {k: v[i] for k, v in stack.items()}


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return x @ w.T


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
                prefix: str = ""):
    """The attention's q/k/v projections of (B, S, D) ``x``, with the qk
    norms when the layer has them and RoPE at the given tables: q (B, S,
    H, Dh), k and v (B, S, KH, Dh)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim

    def proj(name, heads):
        y = x @ lp[prefix + "w" + name]
        b = lp.get(prefix + "b" + name)
        if b is not None:
            y = y + b
        return y.reshape(B, S, heads, Dh)

    q = proj("q", cfg.num_heads)
    k = proj("k", cfg.num_kv_heads)
    v = proj("v", cfg.num_kv_heads)
    if prefix + "qnorm" in lp:
        q = L.rmsnorm(q, lp[prefix + "qnorm"], cfg.norm_eps)
        k = L.rmsnorm(k, lp[prefix + "knorm"], cfg.norm_eps)
    if rope_sincos is not None:
        sin_q, cos_q, sin_k, cos_k = rope_sincos
        q = L.apply_rope(q, sin_q, cos_q)
        k = L.apply_rope(k, sin_k, cos_k)
    return q, k, v


def attn_sublayer(x, lp: Dict, cfg: ModelConfig, *, window: int = 0,
                  rope_sincos=None, mode: str = "prefill",
                  cache: Optional[Tuple] = None, pos=0, positions=None,
                  prefix: str = ""):
    """Returns (attn_out (B, S, D), cache or None).  ``cache`` is (k_cache,
    v_cache) (B, Smax, KH, Dh), written in place: rows [0, S) in prefill,
    each sequence's row ``pos`` (a scalar or (B,) tensor) in decode."""
    if window > 0:
        raise NotImplementedError(
            "sliding-window layers come with the danube3/gemma3 slice "
            "(ROADMAP.md)")
    B, S, _ = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    G = H // cfg.num_kv_heads
    q, k, v = project_qkv(x, lp, cfg, rope_sincos, prefix)

    if mode == "decode":
        k_cache, v_cache = cache
        Smax = k_cache.shape[1]
        # one row per sequence; like dynamic_update_slice, a start past
        # the end is clamped to the last row
        at = torch.as_tensor(pos, device=x.device).reshape(-1) \
            .expand(B).clamp(0, Smax - 1)
        rows = torch.arange(B, device=x.device)
        k_cache[rows, at] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, at] = v[:, 0].to(v_cache.dtype)
        if cfg.decode_grouped_attn:
            o = L.decode_attention_grouped(q, k_cache, v_cache, at + 1,
                                           softcap=cfg.logit_softcap)
        else:
            o = L.decode_attention(q, L.repeat_kv(k_cache, G),
                                   L.repeat_kv(v_cache, G), at + 1,
                                   softcap=cfg.logit_softcap)
    elif mode == "prefill":
        if cache is not None:
            cache[0][:, :S] = k.to(cache[0].dtype)
            cache[1][:, :S] = v.to(cache[1].dtype)
        o = L.blockwise_attention(
            q, L.repeat_kv(k, G), L.repeat_kv(v, G),
            softcap=cfg.logit_softcap, q_positions=positions,
            kv_positions=positions)
    else:
        raise NotImplementedError(
            f"mode {mode!r}: the training path comes with the train slice "
            f"(ROADMAP.md)")
    out = o.reshape(B, S, H * Dh) @ lp[prefix + "wo"]
    bo = lp.get(prefix + "bo")
    if bo is not None:
        out = out + bo
    return out, cache


def dense_block(x, lp, cfg: ModelConfig, *, window=0, rope_sincos,
                mode="prefill", cache=None, pos=0, positions=None):
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a, new_cache = attn_sublayer(
        h, lp, cfg, window=window, rope_sincos=rope_sincos, mode=mode,
        cache=cache, pos=pos, positions=positions)
    x = x + a
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    x = x + L.glu_mlp(h, lp["w1"], lp["w3"], lp["w2"], act=cfg.act)
    return x, new_cache


def dense_trunk(params, cfg: ModelConfig, x, *, mode="prefill", caches=None,
                pos=0, positions=None):
    """Runs the uniform stack of dense blocks over (B, S, D) ``x``.
    ``caches``: {"blocks": (k, v)} of (L, B, Smax, KH, Dh), written in
    place.  Returns (x, caches)."""
    if cfg.global_every > 1 or cfg.window_size:
        raise NotImplementedError(
            "the local/global and sliding-window layer patterns come with "
            "the gemma3/danube3 slice (ROADMAP.md)")
    B, S, _ = x.shape
    stack = _sub(params, "blocks_")
    rope_sc = _rope(cfg, S, pos0=pos, positions=positions, device=x.device)
    ck, cv = caches["blocks"] if caches is not None else (None, None)
    for i in range(cfg.num_layers):
        cache = (ck[i], cv[i]) if ck is not None else None
        x, _ = dense_block(x, layer_params(stack, i), cfg,
                           rope_sincos=rope_sc, mode=mode, cache=cache,
                           pos=pos, positions=positions)
    return x, caches
