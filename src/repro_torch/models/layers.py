"""Transformer building blocks, the port's copy of ``repro.models.layers``
for the families it runs (dense and vlm, full attention).

Parameters are plain dicts of tensors; layer stacks carry a leading ``L``
dim.  Prefill attention is blockwise online softmax with float32
accumulators, never an (S, S) tensor: the KV chunks run in order, and all
query rows of a chunk run as one batched tensor.  Each row's running max,
denominator and accumulator see the chunks in the same order as the JAX
package's nested scan, so the numbers follow from the chunk size alone.

Callers repeat K/V to the full head count (``repeat_kv``) before
attention; the KV cache keeps only the KV heads.  The sliding-window
branch and ring-buffer caches (h2o-danube3, gemma3) come with their slice
and raise here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _no_window(window: int) -> None:
    if window > 0:
        raise NotImplementedError(
            "sliding-window attention comes with the danube3/gemma3 slice "
            "(ROADMAP.md)")


# ---------------------------------------------------------------------------
# norms, rotary embeddings, GQA
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(sin, cos) tables from integer positions; shape (..., head_dim/2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
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
    until it divides Skv) fixes each row's online-softmax steps."""
    _no_window(window)
    if causal_skip:
        raise NotImplementedError(
            "the unrolled causal-skip variant is the training path's and "
            "comes with the train slice (ROADMAP.md)")
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    scale = 1.0 / (D ** 0.5)
    if q_positions is None:
        off = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
        q_positions = (torch.arange(Sq, device=dev)[None, :] + off) \
            .expand(B, Sq).to(torch.int32)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev, dtype=torch.int32) \
            .expand(B, Skv)

    kv_chunk = max(min(kv_chunk, Skv), 1)
    while Skv % kv_chunk:
        kv_chunk //= 2

    qh = (q.float() * scale).permute(0, 2, 1, 3).contiguous()  # (B,H,Sq,D)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for c0 in range(0, Skv, kv_chunk):
        kc = k[:, c0:c0 + kv_chunk].float().permute(0, 2, 3, 1)  # (B,H,D,K)
        vc = v[:, c0:c0 + kv_chunk].float().permute(0, 2, 1, 3)  # (B,H,K,D)
        kpos = kv_positions[:, c0:c0 + kv_chunk]
        mask = (kpos >= 0)[:, None, :]
        if causal:
            mask = mask & (q_positions[:, :, None] >= kpos[:, None, :])
        s = _softcap(torch.matmul(qh, kc), softcap)
        s = torch.where(mask[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        del s
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vc)
        m = m_new
        del p
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _decode_valid(cache_len, Smax: int, device) -> torch.Tensor:
    """(B or 1, Smax) bool: the cache slots below each sequence's
    length."""
    clen = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    return torch.arange(Smax, device=device)[None, :] < clen


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-step decode attention over a cache (full heads).  q: (B, 1,
    H, D); k_cache, v_cache: (B, Smax, H, D); cache_len: scalar or (B,)
    count of valid slots (the newly written token included)."""
    _no_window(window)
    B, _, H, D = q.shape
    scale = 1.0 / (D ** 0.5)
    valid = _decode_valid(cache_len, k_cache.shape[1], q.device)
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
    _no_window(window)
    B, _, H, D = q.shape
    Smax, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = 1.0 / (D ** 0.5)
    valid = _decode_valid(cache_len, Smax, q.device)
    qg = (q.float() * scale).reshape(B, KH, G, D)
    s = _softcap(torch.matmul(qg, k_cache.float().permute(0, 2, 3, 1)),
                 softcap)                                        # (B,KH,G,S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, v_cache.float().permute(0, 2, 1, 3))    # (B,KH,G,D)
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def glu_mlp(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU / GeGLU: act(x@w1) * (x@w3) @ w2."""
    h = x @ w1
    g = x @ w3
    if act in ("silu", "swiglu"):
        h = F.silu(h)
    else:  # gelu_glu
        h = F.gelu(h, approximate="tanh")
    return (h * g) @ w2
