"""Analytic per-device HBM estimator for the dry-run cells, the port's copy
of the JAX package's, on the H100's 80 GiB (``launch.mesh``).

The dry run also reports the counter's peak of live bytes on the rank
(``launch.counter``), which prices the eager program as the port runs
it; this estimator prices what the step must hold, from the same
placements the dry run cuts with.

Accounting (per device):
  params        -- by param tree, divided by each leaf's shard count
  grads + opt   -- train only: fp32 accumulator + m/v in the ZeRO sharding
  activations   -- train: remat boundaries L x (B/k) x S x d x 2B / dp
  kv caches     -- serve: cache tree, divided by shard counts
  workspace     -- one transformer block's transient working set
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed.shardings import (P, cache_pspecs,
                                               param_pspecs)
from repro_torch.launch.mesh import HBM_PER_CHIP
from repro_torch.models import model as M
from repro_torch.models.params import param_specs


def _shards(mesh, spec) -> int:
    n = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            n *= mesh.shape.get(a, 1)
    return n


def _tree_bytes(specs: Dict, pspecs: Dict, mesh,
                dtype_bytes=None) -> float:
    total = 0.0
    for k, v in specs.items():
        nb = dtype_bytes if dtype_bytes else v.dtype.itemsize
        total += float(np.prod(v.shape)) * nb / _shards(mesh, pspecs[k])
    return total


def _leaves(tree, is_leaf=lambda x: False):
    """The leaves of dicts (keys sorted, as JAX orders them), lists and
    tuples."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t, is_leaf)]
    return [tree]


def estimate_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
                  multi_pod: bool = False, sharding_mode: str = "tp",
                  microbatch: int = 1) -> Dict[str, float]:
    specs = param_specs(cfg)
    pspecs = param_pspecs(cfg, specs, sharding_mode, multi_pod, mesh=mesh)
    opt_mode = "fsdp_pod" if multi_pod else "fsdp"
    ospecs = param_pspecs(cfg, specs, opt_mode, multi_pod, mesh=mesh)
    dp = 1
    for a in (("pod", "data") if multi_pod else ("data",)):
        dp *= mesh.shape.get(a, 1)

    out = {"params": _tree_bytes(specs, pspecs, mesh)}
    d = cfg.d_model
    L = cfg.num_layers or (cfg.encoder_layers + cfg.decoder_layers)

    if cell.kind == "train":
        out["grads_fp32"] = _tree_bytes(specs, ospecs, mesh, 4)
        out["opt_m_v"] = 2 * out["grads_fp32"]
        mb_tokens = cell.global_batch * cell.seq_len / max(microbatch, 1)
        out["act_boundaries"] = L * mb_tokens * d * 2 / dp
        # transient: one block's internals for the rematerialized backward
        width = max(cfg.d_ff, cfg.moe_d_ff * cfg.experts_per_token
                    + cfg.shared_d_ff, 1)
        out["workspace"] = mb_tokens * (2 * d + 2 * width) * 2 / dp
    else:
        caches = M.init_cache(cfg, cell.global_batch, cell.seq_len,
                              device="meta")
        kv_seq = cell.kind == "decode" and cell.seq_len >= 200_000
        cspecs = cache_pspecs(caches, mesh, multi_pod, kv_seq_shard=kv_seq)
        total = 0.0
        for leaf, sp in zip(_leaves(caches), _leaves(
                cspecs, is_leaf=lambda x: isinstance(x, P))):
            total += float(np.prod(leaf.shape)) * leaf.dtype.itemsize \
                / _shards(mesh, sp)
        out["kv_cache"] = total
        toks = cell.global_batch * (cell.seq_len if cell.kind == "prefill"
                                    else 1)
        out["workspace"] = max(toks * 4 * d * 2 / dp, 64 * 2 ** 20)

    out["total"] = sum(out.values())
    out["fits"] = out["total"] <= HBM_PER_CHIP
    return out


__all__ = ["estimate_cell"]
