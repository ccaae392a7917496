"""Parameter trees of the dense/vlm uniform stack, under the JAX
package's names (stacked ``(L, ...)`` tensors ``blocks_wq``, ...,
``frontend_w``, ``frontend_b``).

``init_params`` draws random weights on a device from a
``torch.Generator`` (truncated-normal fan-in, ones for norms, zeros for
biases, as ``repro.models.params.init_params``; the bits differ from
``jax.random``'s).  ``params_from_numpy`` carries the JAX package's own
parameters across, for tests that hold the port against it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

Creator = Callable[[str, tuple, torch.dtype, float], object]
_CHUNK = 1 << 28          # float32 elements drawn at a time (1 GiB)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param_tree(cfg: ModelConfig, mk: Creator) -> Dict:
    """``mk(name, shape, dtype, scale)`` per leaf; scale -1 for ones, 0
    for zeros, n > 0 for the fan-in n."""
    if cfg.family not in ("dense", "vlm") or cfg.global_every > 1:
        raise NotImplementedError(
            f"parameters of {cfg.name!r} ({cfg.family}) are not ported yet "
            f"(ROADMAP.md)")
    d, dt, V, L = cfg.d_model, _dt(cfg), cfg.vocab_size, cfg.num_layers
    qd, kvd, ff = cfg.q_dim, cfg.kv_dim, cfg.d_ff
    p: Dict = {"embed": mk("embed", (V, d), dt, 1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = mk("unembed", (V, d), dt, d)
    p["final_norm"] = mk("final_norm", (d,), torch.float32, -1)
    for name, shape, dtype, scale in (
            ("wq", (L, d, qd), dt, d), ("wk", (L, d, kvd), dt, d),
            ("wv", (L, d, kvd), dt, d), ("wo", (L, qd, d), dt, qd),
            ("w1", (L, d, ff), dt, d), ("w3", (L, d, ff), dt, d),
            ("w2", (L, ff, d), dt, ff),
            ("ln1", (L, d), torch.float32, -1),
            ("ln2", (L, d), torch.float32, -1)):
        p["blocks_" + name] = mk("blocks_" + name, shape, dtype, scale)
    if cfg.frontend == "vit_patch":
        p["frontend_w"] = mk("frontend_w", (cfg.frontend_dim, d), dt,
                             cfg.frontend_dim)
        p["frontend_b"] = mk("frontend_b", (d,), dt, 0)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random parameters on ``device`` (the card unless the caller passes
    one), drawn from ``generator`` (on the same device): truncated normal
    in [-2 std, 2 std] with std 1/sqrt(fan-in) (0.02 for fan-in <= 1),
    cast to the leaf's dtype, in float32 chunks of at most 1 GiB."""
    device = resolve_device(device)

    def mk(name, shape, dtype, scale):
        if scale == -1:
            return torch.ones(shape, dtype=dtype, device=device)
        if scale == 0:
            return torch.zeros(shape, dtype=dtype, device=device)
        std = 1.0 / math.sqrt(max(scale, 1.0)) if scale > 1 else 0.02
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = out.view(shape[0], -1)
        step = max(1, _CHUNK // rows.shape[1])
        for i in range(0, rows.shape[0], step):
            tmp = torch.empty(rows[i:i + step].shape, dtype=torch.float32,
                              device=device)
            torch.nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
            rows[i:i + step] = tmp
        return out

    return param_tree(cfg, mk)


def params_from_numpy(tree: Dict, device=None) -> Dict:
    """The JAX package's parameters, as numpy arrays, on ``device`` (the
    card unless given).  bfloat16 leaves (``ml_dtypes.bfloat16``) go
    through float32, which holds every bfloat16 value exactly."""
    device = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[name] = t.to(device)
    return out


def count_params(tree: Dict) -> int:
    return sum(int(v.numel()) for v in tree.values())
