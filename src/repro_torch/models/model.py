"""Model API of the families the port runs (dense, vlm and moe):

  init_cache(cfg, batch, max_seq, device)         -> {name: (k, v)}
  prefill(params, cfg, batch, caches, ...)        -> (last_logits, caches)
  decode_step(params, cfg, tokens, caches, pos)   -> (logits, caches)

Batch schemas: dense and moe ``{tokens (B, S)}``; vlm ``{tokens (B, S_txt),
patches (B, S_img, frontend_dim)}``, the projected patches ahead of the
text tokens.  ``decode_step`` takes ``pos`` as a scalar or a (B,) vector
of per-sequence positions: the batch dimension written out where the JAX
engine vmaps per-request scalars.  Caches are written in place.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward as F
from repro_torch.models import layers as L


def _families(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP.md)")


def _trunk(params, cfg: ModelConfig, x, **kw):
    if cfg.family == "moe":
        x, caches, _, _ = F.moe_trunk(params, cfg, x, **kw)
        return x, caches
    return F.dense_trunk(params, cfg, x, **kw)


def _front(params, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.family == "vlm":
        tok = F._embed(params, cfg, batch["tokens"])
        patches, w = batch["patches"], params["frontend_w"]
        # jnp's promotion: a float32 patch stream meets bf16 weights in f32
        dt = torch.promote_types(patches.dtype, w.dtype)
        patch = patches.to(dt) @ w.to(dt) + params["frontend_b"]
        return torch.cat([patch.to(tok.dtype), tok], dim=1)
    return F._embed(params, cfg, batch["tokens"])


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None):
    """Zeroed KV caches for a serving session, each a (k, v) pair of (L, B,
    Smax, KH, Dh) in ``cfg.kv_cache_dtype`` on ``device`` -- the CUDA card
    unless the caller passes one (``resolve_device``):

    * a uniform stack: {"blocks"}, Smax = max_seq, or min(window,
      max_seq) with a window -- a ring once it holds ``window`` slots;
    * gemma3's pattern: {"local", "global"[, "trail"]}, the local and
      trailing layers' rings of min(window, max_seq), the global layers'
      caches of max_seq;
    * moe: {"blocks"[, "dense"]} of max_seq."""
    _families(cfg)
    dt = getattr(torch, cfg.kv_cache_dtype)
    device = resolve_device(device)

    def kv(n, Smax):
        shape = (n, B, Smax, cfg.num_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        caches = {"blocks": kv(cfg.num_layers - nd, max_seq)}
        if nd:
            caches["dense"] = kv(nd, max_seq)
        return caches
    if cfg.global_every > 1:
        n_super = cfg.num_layers // cfg.global_every
        n_trail = cfg.num_layers - n_super * cfg.global_every
        W = min(cfg.window_size, max_seq)
        caches = {"local": kv(n_super * (cfg.global_every - 1), W),
                  "global": kv(n_super, max_seq)}
        if n_trail:
            caches["trail"] = kv(n_trail, W)
        return caches
    Smax = min(cfg.window_size, max_seq) if cfg.window_size else max_seq
    return {"blocks": kv(cfg.num_layers, Smax)}


def prefill(params, cfg: ModelConfig, batch, caches, *, positions=None,
            last_index=None):
    """Process the whole prompt, fill the caches, return the logits of the
    last row -- or of row ``last_index``: an RoI-packed prompt ends at its
    last KEPT row, not its last padded one."""
    _families(cfg)
    x = _front(params, cfg, batch)
    x, caches = _trunk(params, cfg, x, mode="prefill", caches=caches,
                       positions=positions)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_index is None:
        xe = x[:, -1:]
    else:                             # clamped, as dynamic_slice clamps
        i = min(max(int(last_index), 0), x.shape[1] - 1)
        xe = x[:, i:i + 1]
    return F._unembed(params, cfg, xe), caches


def decode_step(params, cfg: ModelConfig, tokens, caches, pos):
    """tokens: (B, 1), each sequence's token at position ``pos`` (scalar
    or (B,))."""
    _families(cfg)
    x = F._embed(params, cfg, tokens)
    x, caches = _trunk(params, cfg, x, mode="decode", caches=caches, pos=pos)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return F._unembed(params, cfg, x), caches
