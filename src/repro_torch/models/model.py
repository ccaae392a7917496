"""Model API of every family (dense, vlm, moe, ssm, hybrid and encdec):

  train_loss(params, cfg, batch, ...)             -> (loss, metrics)
  init_cache(cfg, batch, max_seq, device)         -> the cache tree
  prefill(params, cfg, batch, caches, ...)        -> (last_logits, caches)
  decode_step(params, cfg, tokens, caches, pos)   -> (logits, caches)
  input_specs(cfg, shape_cell)                    -> the batch as meta tensors
  make_batch(cfg, cell_or_specs, generator)       -> a random batch

Batch schemas: dense, moe, ssm and hybrid ``{tokens (B, S)}``; vlm
``{tokens (B, S_txt), patches (B, S_img, frontend_dim)}``, the projected
patches ahead of the text tokens (S_img = S // 2 of a shape cell's S, the
multi-camera patch slots); encdec ``{frames (B, S, frontend_dim), tokens
(B, T)}``, the frames through the encoder, the tokens through the decoder
(from position 0; T = min(max_target_len, S)).  A training batch adds
``labels`` shaped as ``tokens``.  ``decode_step`` takes ``pos`` as a
scalar or a (B,) vector of per-sequence positions: the batch dimension
written out where the JAX engine vmaps per-request scalars.  Every cache
tensor has its batch on axis 1.  KV caches are written in place; the
recurrent states (ssm, hybrid) come back as new tensors, which the caller
carries to the next call (the caches passed seed the recurrence).

Every entry point runs under a ``DistContext`` over a model axis above
1 (tensor and expert parallelism, each rank on its model shard of the
parameters, ``Placement.shard`` of ``param_pspecs``' tp mode):
``init_cache`` gives the rank's shard of the caches, ``prefill`` and
``decode_step`` take the rank's batch rows and its cache shard, and
every rank returns the whole logits.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import forward as F
from repro_torch.models import layers as L
from repro_torch.models.cache_layout import batch_rows, kv_layout, rwkv_heads
from repro_torch.models.dist import DistContext
from repro_torch.models.ssm import conv_dim


def _families(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {cfg.family}")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Every model input of a shape cell, as ``meta`` tensors of its shape
    and dtype (the JAX package's ShapeDtypeStructs): int32 tokens and
    labels, bfloat16 patches and frames; labels in a ``train`` cell
    only."""
    B, S = cell.global_batch, cell.seq_len

    def spec(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "vlm":
        s_img = S // 2
        s_txt = S - s_img
        d = {"tokens": spec((B, s_txt)),
             "patches": spec((B, s_img, cfg.frontend_dim), torch.bfloat16)}
        if cell.kind == "train":
            d["labels"] = spec((B, s_txt))
        return d
    if cfg.family == "encdec":
        T = min(cfg.max_target_len, S)
        d = {"frames": spec((B, S, cfg.frontend_dim), torch.bfloat16),
             "tokens": spec((B, T))}
        if cell.kind == "train":
            d["labels"] = spec((B, T))
        return d
    d = {"tokens": spec((B, S))}
    if cell.kind == "train":
        d["labels"] = spec((B, S))
    return d


def make_batch(cfg: ModelConfig, cell_or_specs, generator: torch.Generator,
               device=None) -> Dict[str, torch.Tensor]:
    """A random batch matching ``input_specs`` (a ShapeCell) or the given
    specs, on ``device`` (the card unless the caller passes one), drawn
    from ``generator`` on its own device, in the specs' sorted name
    order: integers uniform in [0, vocab_size), floats standard normal in
    float32 cast to the spec's dtype.  The bits differ from the JAX
    package's ``jax.random`` draws."""
    device = resolve_device(device)
    specs = input_specs(cfg, cell_or_specs) \
        if isinstance(cell_or_specs, ShapeCell) else cell_or_specs
    out = {}
    for name, s in sorted(specs.items()):
        if s.dtype.is_floating_point:
            t = torch.randn(s.shape, dtype=torch.float32,
                            generator=generator, device=generator.device)
        else:
            t = torch.randint(0, cfg.vocab_size, s.shape,
                              generator=generator, device=generator.device)
        out[name] = t.to(device=device, dtype=s.dtype)
    return out


def train_loss(params, cfg: ModelConfig, batch, *,
               dist: Optional[DistContext] = None, remat: bool = True,
               causal_skip: bool = False):
    """The mean next-token cross-entropy of ``batch`` (chunked over the
    sequence, ``forward.chunked_ce``) and its metrics: for moe the
    router's load-balance loss and the dropped share summed over the MoE
    layers (``moe_aux``, ``moe_dropped``), and ``router_aux_coef *
    moe_aux`` added to the loss.  vlm scores the text rows after the
    patches.  ``remat`` recomputes the JAX package's blocks in the
    backward pass; ``causal_skip`` reaches the full-attention layers.
    With a mesh ``dist`` ``batch`` is this rank's rows and the loss their
    mean, replicated over the model group; the MoE aux loss is the global
    batch's.  Over a model axis above 1 ``params`` is this rank's model
    shard (``Placement.gather_batch``).  Differentiate it with
    ``torch.autograd``."""
    _families(cfg)
    metrics: Dict[str, torch.Tensor] = {}
    if cfg.family == "encdec":
        memory = F.encoder_trunk(params, cfg, batch["frames"], remat=remat,
                                 dist=dist)
        x, _ = F.decoder_trunk(params, cfg, batch["tokens"], memory,
                               mode="train", remat=remat, dist=dist)
        x = L.layernorm(x, params["final_norm"], params["final_norm_b"],
                        cfg.norm_eps)
        return F.chunked_ce(params, cfg, x, batch["labels"],
                            dist=dist), metrics

    x = F.shard_act(_front(params, cfg, batch, dist), dist, None, None)
    kw = dict(mode="train", remat=remat, dist=dist)
    if cfg.family == "moe":
        x, _, aux, dropped = F.moe_trunk(params, cfg, x,
                                         causal_skip=causal_skip, **kw)
        metrics["moe_aux"] = aux
        metrics["moe_dropped"] = dropped
    elif cfg.family == "ssm":
        x, _ = F.rwkv_trunk(params, cfg, x, **kw)
    elif cfg.family == "hybrid":
        x = F.hybrid_trunk(params, cfg, x, **kw)[0]
    else:
        x, _ = F.dense_trunk(params, cfg, x, causal_skip=causal_skip, **kw)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, -batch["tokens"].shape[1]:]
    loss = F.chunked_ce(params, cfg, x, batch["labels"], dist=dist)
    if "moe_aux" in metrics:
        loss = loss + cfg.router_aux_coef * metrics["moe_aux"]
    return loss, metrics


def _trunk(params, cfg: ModelConfig, x, *, mode, caches, pos=0,
           positions=None, dist=None):
    if cfg.family == "moe":
        x, caches, _, _ = F.moe_trunk(params, cfg, x, mode=mode,
                                      caches=caches, pos=pos,
                                      positions=positions, dist=dist)
        return x, caches
    # the recurrent families take no positions, as the JAX package's
    # (ROADMAP C-R5); the hybrid's prefill starts at position 0
    if cfg.family == "ssm":
        return F.rwkv_trunk(params, cfg, x, mode=mode, states=caches,
                            dist=dist)
    if cfg.family == "hybrid":
        if caches is None:
            return F.hybrid_trunk(params, cfg, x, mode=mode, pos=pos,
                                  dist=dist)[0], None
        x, states, attn = F.hybrid_trunk(
            params, cfg, x, mode=mode, states=caches["states"],
            caches=caches["attn"], pos=pos, dist=dist)
        return x, {"states": states, "attn": attn}
    return F.dense_trunk(params, cfg, x, mode=mode, caches=caches, pos=pos,
                         positions=positions, dist=dist)


def _front(params, cfg: ModelConfig, batch, dist=None) -> torch.Tensor:
    if cfg.family == "vlm":
        tok = F._embed(params, cfg, batch["tokens"], dist)
        patches, w = batch["patches"], params["frontend_w"]
        # jnp's promotion: a float32 patch stream meets bf16 weights in f32
        dt = torch.promote_types(patches.dtype, w.dtype)
        patch = patches.to(dt) @ w.to(dt) + params["frontend_b"]
        return torch.cat([patch.to(tok.dtype), tok], dim=1)
    return F._embed(params, cfg, batch["tokens"], dist)


def _encdec_logits(params, cfg: ModelConfig, x, dist=None) -> torch.Tensor:
    x = L.layernorm(x, params["final_norm"], params["final_norm_b"],
                    cfg.norm_eps)
    return F.logits(params, cfg, x, dist)


def init_cache(cfg: ModelConfig, B: int, max_seq: int, device=None,
               dist: Optional[DistContext] = None):
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
      memory's K/V, as the JAX package's}.

    Under a ``dist`` the tree is this rank's shard of it, built at its
    size as ``cache_layout`` lays it out: B / dp rows of every tensor
    and, over a model axis above 1, KH / tp KV heads of each KV cache
    where KH % tp == 0, else its slice of the sequence (max_seq rounded
    up to a multiple of tp), whisper's cross K/V by its KV heads or
    whole, rwkv6's wkv state by its heads, its shifts and zamba2's
    states whole."""
    _families(cfg)
    dt = getattr(torch, cfg.kv_cache_dtype)
    device = resolve_device(device)
    B = batch_rows(B, dist)
    lay = kv_layout(cfg, dist)

    def kv(n, seq, window=0):
        shape = (n, B, lay.slots(seq, window), lay.heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    def zeros(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    Lc, f32 = cfg.num_layers, torch.float32
    if cfg.family == "encdec":
        shape = (cfg.decoder_layers, B, max_seq, lay.heads, cfg.head_dim)
        return {"self": kv(cfg.decoder_layers, cfg.max_target_len),
                "cross": (zeros(torch.bfloat16, *shape),
                          zeros(torch.bfloat16, *shape))}
    if cfg.family == "ssm":
        H, P, D = rwkv_heads(cfg, lay.tp), cfg.ssm_head_dim, cfg.d_model
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
        W = cfg.window_size
        caches = {"local": kv(n_super * (cfg.global_every - 1), max_seq, W),
                  "global": kv(n_super, max_seq)}
        if n_trail:
            caches["trail"] = kv(n_trail, max_seq, W)
        return caches
    return {"blocks": kv(cfg.num_layers, max_seq, cfg.window_size)}


def prefill(params, cfg: ModelConfig, batch, caches, *, positions=None,
            last_index=None, dist: Optional[DistContext] = None):
    """Process the whole prompt, fill the caches, return the logits of the
    last row -- or of row ``last_index``: an RoI-packed prompt ends at its
    last KEPT row, not its last padded one.  ``positions`` reach the
    attention families only; the recurrent ones run over every row in
    order, padding rows included (ROADMAP C-R5).  encdec ignores both, as
    the JAX package does: the encoder over ``batch["frames"]``, its
    memory's cross K/V into ``caches["cross"]`` (a new pair in a new
    dict; the self caches are written in place), then the decoder over
    ``batch["tokens"]`` from position 0 and the last row's logits.
    Under a ``dist`` ``batch`` and ``caches`` are this rank's rows and
    shard (``init_cache``); the logits are whole on every rank."""
    _families(cfg)
    if cfg.family == "encdec":
        memory = F.encoder_trunk(params, cfg, batch["frames"], dist=dist)
        caches = dict(caches, cross=F.cross_kv(params, cfg, memory, dist))
        x, caches = F.decoder_trunk(params, cfg, batch["tokens"], memory,
                                    mode="prefill", caches=caches, dist=dist)
        return _encdec_logits(params, cfg, x[:, -1:], dist), caches
    x = _front(params, cfg, batch, dist)
    x, caches = _trunk(params, cfg, x, mode="prefill", caches=caches,
                       positions=positions, dist=dist)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_index is None:
        xe = x[:, -1:]
    else:                             # clamped, as dynamic_slice clamps
        i = min(max(int(last_index), 0), x.shape[1] - 1)
        xe = x[:, i:i + 1]
    return F.logits(params, cfg, xe, dist), caches


def decode_step(params, cfg: ModelConfig, tokens, caches, pos, *,
                dist: Optional[DistContext] = None):
    """tokens: (B, 1), each sequence's token at position ``pos`` (scalar
    or (B,)).  encdec reads its position's ``dec_pos`` row, clamped to
    the table's last (``F._dec_positions``).  Under a ``dist`` as
    ``prefill``."""
    _families(cfg)
    if cfg.family == "encdec":
        x, caches = F.decoder_trunk(params, cfg, tokens, None, mode="decode",
                                    caches=caches, pos=pos, dist=dist)
        return _encdec_logits(params, cfg, x, dist), caches
    x = F._embed(params, cfg, tokens, dist)
    x, caches = _trunk(params, cfg, x, mode="decode", caches=caches, pos=pos,
                       dist=dist)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return F.logits(params, cfg, x, dist), caches
