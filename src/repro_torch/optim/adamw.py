"""AdamW with a warmup + cosine schedule and global-norm clipping, the
port's copy of ``repro.optim.adamw`` on one device.

The arithmetic is jnp's, step for step: the step count and the schedule
in float32 tensors, ``b1 ** step`` a float32 power, the clipped gradient
cast back to its own dtype before the update casts it to float32 again,
the global norm summed over the leaves in sorted-name order (the JAX
package's ``jax.tree.leaves`` order).  Norms, biases and other 1-D
leaves take no weight decay.

``adamw_update`` writes the parameters and both moments in place, under
``torch.no_grad()``, a slice of each leaf at a time: at full width the
moments alone are twice the float32 size of the model, and a functional
update would hold old and new moments at once.  It returns the same
tensors.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import params_from_numpy

_SLICE = 1 << 26          # elements of a leaf updated at a time (256 MiB f32)


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: Dict
    v: Dict


def adamw_init(params: Dict, device=None) -> AdamWState:
    """Zero moments (float32, each leaf's shape) and step 0 on ``device``:
    the card unless the caller passes one."""
    device = resolve_device(device)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=device)

    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      {k: zeros(p) for k, p in params.items()},
                      {k: zeros(p) for k, p in params.items()})


def adamw_abstract(params: Dict) -> AdamWState:
    """The state's shapes and dtypes as ``meta`` tensors."""

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    return AdamWState(meta((), torch.int32),
                      {k: meta(p.shape) for k, p in params.items()},
                      {k: meta(p.shape) for k, p in params.items()})


def adamw_state_from_numpy(state, device=None) -> AdamWState:
    """A JAX ``AdamWState`` with numpy leaves, (step, m, v), on ``device``
    (the card unless given)."""
    step, m, v = state
    device = resolve_device(device)
    return AdamWState(torch.tensor(int(step), dtype=torch.int32,
                                   device=device),
                      params_from_numpy(m, device), params_from_numpy(v,
                                                                      device))


def cosine_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup to ``learning_rate`` over ``warmup_steps``, then a
    cosine to a floor of 0.1x at ``total_steps``; float32, at an integer
    ``step`` (a tensor or an int)."""
    step = torch.as_tensor(step)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def _global_norm(grads: Dict) -> torch.Tensor:
    """sqrt of the sum over the leaves, in sorted-name order, of each
    leaf's float32 sum of squares."""
    tot = None
    for name in sorted(grads):
        sq = grads[name].to(torch.float32, copy=True).square_().sum()
        tot = sq if tot is None else tot + sq
    return torch.sqrt(tot)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)


def clip_by_global_norm(grads: Dict, max_norm: float = 1.0
                        ) -> Tuple[Dict, torch.Tensor]:
    """(the gradients scaled so that their global norm is at most
    ``max_norm``, each cast back to its dtype; the norm before)."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


def _decay_mask(params: Dict) -> Dict:
    return {k: float(p.ndim >= 2) for k, p in params.items()}


@torch.no_grad()
def adamw_update(params: Dict, grads: Dict, state: AdamWState,
                 cfg: TrainConfig, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict, AdamWState, Dict]:
    """One AdamW step on the gradients clipped to global norm 1.  Returns
    (params, the state at step + 1, {"grad_norm", "lr"}); the parameters
    and moments are updated in place and returned, so a caller that
    keeps the old values passes copies.  ``gnorm``: the global norm when
    the caller has it (the data-axis route, whose ``grads`` are shards),
    else ``_global_norm(grads)``."""
    if gnorm is None:
        gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, 1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    stepf = step.float()

    def bias_fix(b):                  # 1 - b ** step, a float32 power
        return 1 - torch.pow(torch.tensor(b, dtype=torch.float32,
                                          device=stepf.device), stepf)

    c1, c2 = bias_fix(b1), bias_fix(b2)
    for name, wd_on in _decay_mask(params).items():
        wd = cfg.weight_decay * wd_on
        # in place through flat views (a gradient may come transposed)
        flat = [params[name].view(-1), grads[name].reshape(-1),
                state.m[name].view(-1), state.v[name].view(-1)]
        for a in range(0, flat[0].numel(), _SLICE):
            p, g, m, v = (t[a:a + _SLICE] for t in flat)
            g32 = (g.float() * scale).to(g.dtype).float()
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(g32 * (1 - b2) * g32)
            delta = (m / c1).div_((v / c2).sqrt_().add_(eps))
            p32 = p.float()
            delta.add_(wd * p32)
            p.copy_(p32.sub_(lr * delta))
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}
