"""One rank's step of every (arch, shape) cell, for ``launch.dryrun`` and
the roofline tools: the port's counterpart of the JAX package's step
builders, which return a jitted step for XLA to lower.

``build_cell`` returns ``(fn, args, meta)``: ``fn(*args)`` runs one step
of this rank of ``mesh`` -- a ``TrainMesh`` over the initialized process
group on the ``meta`` device -- and ``args`` are the rank's shards as
``meta`` tensors:

  train cells   -> step(state, batch): ``make_train_step`` on the state's
                   shards (``state_pspecs``) and the global batch
                   (``input_specs``), of which the step takes the rank's
                   rows
  prefill cells -> prefill(params, batch, caches)
  decode cells  -> decode(params, tokens, caches, pos): one new token
                   per sequence against a seq_len-deep KV cache

Serving parameters are the rank's shards of ``param_pspecs`` in
``sharding_mode``; the step gathers their batch split (fsdp) into the
model shard the model code runs on, as the partitioner gathers them in
the JAX package.  A serving batch that the batch axes do not divide,
and the long-context decode cell, take the sequence split of the caches
over the batch axes (``kv_seq_shard``): every batch rank holds all rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell, TrainConfig
from repro_torch.distributed.shardings import make_dist, named, param_pspecs
from repro_torch.models import model as M
from repro_torch.models.params import param_specs
from repro_torch.train.loop import (TrainState, make_train_step,
                                    state_pspecs, state_template)


def auto_microbatch(cfg: ModelConfig, cell: ShapeCell, mesh,
                    multi_pod: bool = False,
                    act_budget: float = 2 * 2 ** 30) -> int:
    """Gradient-accumulation factor so the per-device remat boundary
    activations (L x microbatch-tokens x d_model x 2B / dp) fit the budget.
    Returns a power-of-two divisor of the global batch."""
    dp = 1
    for a in (("pod", "data") if multi_pod else ("data",)):
        dp *= mesh.shape.get(a, 1)
    L = cfg.num_layers or (cfg.encoder_layers + cfg.decoder_layers)
    d = cfg.d_model
    per_k = L * cell.global_batch * cell.seq_len * d * 2 / dp
    k = 1
    while per_k / k > act_budget and k < cell.global_batch:
        k *= 2
    return k


def _dp(mesh, multi_pod: bool) -> int:
    return mesh.size(("pod", "data") if multi_pod else ("data",))


def _shards(placements, full):
    """Each tensor of ``full`` (a dict) cut to this rank's shard."""
    return {n: placements[n].shard(v) for n, v in full.items()}


def build_train(cfg: ModelConfig, cell: ShapeCell, mesh,
                tcfg: Optional[TrainConfig] = None,
                multi_pod: bool = False):
    """Returns (step, (state, batch), meta).  ``TrainConfig.microbatch``
    0 takes ``auto_microbatch``, capped at one row a batch rank a
    microbatch (the step splits each microbatch over the batch ranks).
    ``meta["microbatch"]`` is the factor taken."""
    tcfg = tcfg or TrainConfig()
    if tcfg.microbatch == 0:
        k = auto_microbatch(cfg, cell, mesh, multi_pod)
        k = max(1, min(k, cell.global_batch // _dp(mesh, multi_pod)))
        tcfg = dataclasses.replace(tcfg, microbatch=k)
    step = make_train_step(cfg, tcfg, mesh, multi_pod)
    pl = named(mesh, state_pspecs(cfg, tcfg, multi_pod, mesh))
    full = TrainState(**state_template(cfg)["state"])
    opt = full.opt._replace(m=_shards(pl.opt.m, full.opt.m),
                            v=_shards(pl.opt.v, full.opt.v))
    state = TrainState(_shards(pl.params, full.params), opt)
    batch = M.input_specs(cfg, cell)
    return step, (state, batch), {"microbatch": max(tcfg.microbatch, 1)}


def _serving(cfg, mesh, multi_pod, sharding_mode, kv_seq_shard):
    """(dist, the rank's parameter shards, their placements)."""
    dist = make_dist(mesh, kv_seq_shard=kv_seq_shard)
    pl = named(mesh, param_pspecs(cfg, param_specs(cfg), sharding_mode,
                                  multi_pod, mesh=mesh))
    return dist, _shards(pl, param_specs(cfg)), pl


def _model_shard(pl, params):
    """The model shard of each parameter, its batch split gathered."""
    return {n: pl[n].gather_batch(v) for n, v in params.items()}


def build_prefill(cfg: ModelConfig, cell: ShapeCell, mesh,
                  multi_pod: bool = False, sharding_mode: str = "tp"):
    B, S = cell.global_batch, cell.seq_len
    dp = _dp(mesh, multi_pod)
    dist, params, pl = _serving(cfg, mesh, multi_pod, sharding_mode,
                                kv_seq_shard=B % dp != 0)
    rows = B if B % dp else B // dp
    batch = {n: torch.empty((rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta")
             for n, v in M.input_specs(cfg, cell).items()}
    caches = M.init_cache(cfg, B, S, device="meta", dist=dist)

    def prefill_step(p, b, c):
        return M.prefill(_model_shard(pl, p), cfg, b, c, dist=dist)

    return prefill_step, (params, batch, caches), {}


def build_decode(cfg: ModelConfig, cell: ShapeCell, mesh,
                 multi_pod: bool = False, sharding_mode: str = "tp",
                 kv_seq_shard: bool = False):
    B, S = cell.global_batch, cell.seq_len
    dp = _dp(mesh, multi_pod)
    kv_seq_shard = kv_seq_shard or B % dp != 0
    dist, params, pl = _serving(cfg, mesh, multi_pod, sharding_mode,
                                kv_seq_shard)
    rows = B if kv_seq_shard else B // dp
    tokens = torch.empty((rows, 1), dtype=torch.int32, device="meta")
    caches = M.init_cache(cfg, B, S, device="meta", dist=dist)
    # the last slot: the token attends a seq_len-deep cache
    pos = torch.full((rows,), S - 1, dtype=torch.int64, device="meta")

    def serve_step(p, t, c, pos):
        return M.decode_step(_model_shard(pl, p), cfg, t, c, pos, dist=dist)

    return serve_step, (params, tokens, caches, pos), {
        "kv_seq_shard": kv_seq_shard}


def build_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
               multi_pod: bool = False, sharding_mode: str = "tp",
               tcfg: Optional[TrainConfig] = None):
    if cell.kind == "train":
        tcfg = tcfg or TrainConfig(sharding_mode=sharding_mode)
        return build_train(cfg, cell, mesh, tcfg, multi_pod)
    if cell.kind == "prefill":
        return build_prefill(cfg, cell, mesh, multi_pod, sharding_mode)
    if cell.kind == "decode":
        kv_seq = cell.seq_len >= 200_000   # long-context: SP for the cache
        return build_decode(cfg, cell, mesh, multi_pod, sharding_mode,
                            kv_seq_shard=kv_seq)
    raise ValueError(cell.kind)


__all__ = ["auto_microbatch", "build_train", "build_prefill",
           "build_decode", "build_cell"]
