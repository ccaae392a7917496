"""Model API of every family (dense, vlm, moe, ssm, hybrid and encdec):

  init_cache(cfg, batch, max_seq, device)         -> the cache tree
  prefill(params, cfg, batch, caches, ...)        -> (last_logits, caches)
  decode_step(params, cfg, tokens, caches, pos)   -> (logits, caches)

Batch schemas: dense, moe, ssm and hybrid ``{tokens (B, S)}``; vlm
``{tokens (B, S_txt), patches (B, S_img, frontend_dim)}``, the projected
patches ahead of the text tokens; encdec ``{frames (B, S, frontend_dim),
tokens (B, T)}``, the frames through the encoder, the tokens through the
decoder (prefill starts them at position 0).  ``decode_step`` takes
``pos`` as a scalar or a (B,) vector of per-sequence positions: the batch
dimension written out where the JAX engine vmaps per-request scalars.  Every cache
tensor has its batch on axis 1.  KV caches are written in place; the
recurrent states (ssm, hybrid) come back as new tensors, which the caller
carries to the next call (the caches passed seed the recurrence).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward as F
from repro_torch.models import layers as L
from repro_torch.models.ssm import conv_dim


def _families(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {cfg.family}")


def _trunk(params, cfg: ModelConfig, x, *, mode, caches, pos=0,
           positions=None):
    if cfg.family == "moe":
        x, caches, _, _ = F.moe_trunk(params, cfg, x, mode=mode,
                                      caches=caches, pos=pos,
                                      positions=positions)
        return x, caches
    # the recurrent families take no positions, as the JAX package's
    # (ROADMAP C-R5); the hybrid's prefill starts at position 0
    if cfg.family == "ssm":
        return F.rwkv_trunk(params, cfg, x, mode=mode, states=caches)
    if cfg.family == "hybrid":
        if caches is None:
            return F.hybrid_trunk(params, cfg, x, mode=mode, pos=pos)[0], None
        x, states, attn = F.hybrid_trunk(
            params, cfg, x, mode=mode, states=caches["states"],
            caches=caches["attn"], pos=pos)
        return x, {"states": states, "attn": attn}
    return F.dense_trunk(params, cfg, x, mode=mode, caches=caches, pos=pos,
                         positions=positions)


def _front(params, cfg: ModelConfig, batch) -> torch.Tensor:
    if cfg.family == "vlm":
        tok = F._embed(params, cfg, batch["tokens"])
        patches, w = batch["patches"], params["frontend_w"]
        # jnp's promotion: a float32 patch stream meets bf16 weights in f32
        dt = torch.promote_types(patches.dtype, w.dtype)
        patch = patches.to(dt) @ w.to(dt) + params["frontend_b"]
        return torch.cat([patch.to(tok.dtype), tok], dim=1)
    return F._embed(params, cfg, batch["tokens"])


def _encdec_logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = L.layernorm(x, params["final_norm"], params["final_norm_b"],
                    cfg.norm_eps)
    return F._unembed(params, cfg, x)


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None):
    """Zeroed caches for a serving session on ``device`` -- the CUDA card
    unless the caller passes one (``resolve_device``).  KV caches are (k,
    v) pairs of (L, B, Smax, KH, Dh) in ``cfg.kv_cache_dtype``:

    * a uniform stack: {"blocks"}, Smax = max_seq, or min(window,
      max_seq) with a window -- a ring once it holds ``window`` slots;
    * gemma3's pattern: {"local", "global"[, "trail"]}, the local and
      trailing layers' rings of min(window, max_seq), the global layers'
      caches of max_seq;
    * moe: {"blocks"[, "dense"]} of max_seq;
    * ssm (rwkv6): the states (wkv (L, B, H, P, P), shift_t (L, B, D),
      shift_c (L, B, D)), float32;
    * hybrid (zamba2): {"states": (ssm (L, B, H, N, P) float32, conv
      (L, B, cw - 1, conv_dim) bfloat16 whatever ``cfg.dtype``, as the
      JAX package's), "attn": a KV pair of one cache per application of
      a shared block, max_seq};
    * encdec (whisper): {"self": the decoder's KV pair of
      ``max_target_len`` whatever max_seq, "cross": a bfloat16 pair of
      max_seq (the encoder's length), which prefill replaces with the
      memory's K/V, as the JAX package's}."""
    _families(cfg)
    dt = getattr(torch, cfg.kv_cache_dtype)
    device = resolve_device(device)

    def kv(n, Smax):
        shape = (n, B, Smax, cfg.num_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    def zeros(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    Lc, f32 = cfg.num_layers, torch.float32
    if cfg.family == "encdec":
        shape = (cfg.decoder_layers, B, max_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"self": kv(cfg.decoder_layers, cfg.max_target_len),
                "cross": (zeros(torch.bfloat16, *shape),
                          zeros(torch.bfloat16, *shape))}
    if cfg.family == "ssm":
        H, P, D = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.d_model
        return (zeros(f32, Lc, B, H, P, P), zeros(f32, Lc, B, D),
                zeros(f32, Lc, B, D))
    if cfg.family == "hybrid":
        H, N, P = cfg.ssm_num_heads, cfg.ssm_state_dim, cfg.ssm_head_dim
        states = (zeros(f32, Lc, B, H, N, P),
                  zeros(torch.bfloat16, Lc, B, cfg.ssm_conv_width - 1,
                        conv_dim(cfg)))
        return {"states": states,
                "attn": kv(Lc // cfg.attn_every, max_seq)}

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
    last KEPT row, not its last padded one.  ``positions`` reach the
    attention families only; the recurrent ones run over every row in
    order, padding rows included (ROADMAP C-R5).  encdec ignores both, as
    the JAX package does: the encoder over ``batch["frames"]``, its
    memory's cross K/V into ``caches["cross"]`` (a new pair in a new
    dict; the self caches are written in place), then the decoder over
    ``batch["tokens"]`` from position 0 and the last row's logits."""
    _families(cfg)
    if cfg.family == "encdec":
        memory = F.encoder_trunk(params, cfg, batch["frames"])
        caches = dict(caches, cross=F.cross_kv(params, cfg, memory))
        x, caches = F.decoder_trunk(params, cfg, batch["tokens"], memory,
                                    mode="prefill", caches=caches)
        return _encdec_logits(params, cfg, x[:, -1:]), caches
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
    or (B,)).  encdec reads its position's ``dec_pos`` row, clamped to
    the table's last (``F._dec_positions``)."""
    _families(cfg)
    if cfg.family == "encdec":
        x, caches = F.decoder_trunk(params, cfg, tokens, None, mode="decode",
                                    caches=caches, pos=pos)
        return _encdec_logits(params, cfg, x), caches
    x = F._embed(params, cfg, tokens)
    x, caches = _trunk(params, cfg, x, mode="decode", caches=caches, pos=pos)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return F._unembed(params, cfg, x), caches
