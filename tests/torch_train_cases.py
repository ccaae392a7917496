"""Shared cases of the training-step tests: an arch's JAX and port models
at SMOKE with the same weights (the JAX ``init_params`` carried across by
``params_from_numpy``), numpy-seeded batches, and the loss and gradients
of each package's ``train_loss``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import model as JM
from repro.models.params import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models.params import params_from_numpy

F32 = dict(dtype="float32", kv_cache_dtype="float32")


@functools.lru_cache(maxsize=None)
def pair(arch, dtype="float32", **overrides):
    """(JAX config, port config, JAX params, the params as numpy)."""
    kw = dict(dtype=dtype, kv_cache_dtype=dtype, **overrides)
    jcfg = jget_config(arch, smoke=True).replace(**kw)
    cfg = get_config(arch, smoke=True).replace(**kw)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, {k: np.asarray(v) for k, v in jp.items()}


def batch(cfg, seed=0, B=2, S=64):
    """A numpy training batch of the arch's schema: tokens and labels
    (B, S); vlm S // 2 text rows after S // 2 patch rows; encdec S frames
    and min(max_target_len, S) tokens."""
    rng = np.random.default_rng(seed)

    def tok(*shape):
        return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)

    if cfg.family == "vlm":
        s_txt = S - S // 2
        return {"tokens": tok(B, s_txt), "labels": tok(B, s_txt),
                "patches": rng.normal(size=(B, S // 2, cfg.frontend_dim))
                .astype(np.float32)}
    if cfg.family == "encdec":
        T = min(cfg.max_target_len, S)
        return {"frames": rng.normal(size=(B, S, cfg.frontend_dim))
                .astype(np.float32), "tokens": tok(B, T),
                "labels": tok(B, T)}
    return {"tokens": tok(B, S), "labels": tok(B, S)}


def jax_loss_and_grads(jcfg, jp, b, **kw):
    """(loss, metrics, grads) of the JAX ``train_loss``, jitted, with
    ``remat=False`` unless given."""
    kw.setdefault("remat", False)
    f = jax.jit(jax.value_and_grad(
        lambda p, bb: JM.train_loss(p, jcfg, bb, **kw), has_aux=True))
    (loss, metrics), grads = f(jp, {k: jnp.asarray(v) for k, v in b.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v, np.float32) for k, v in grads.items()})


def port_params(npp):
    """The JAX parameters on the CPU, as leaves that take gradients."""
    params = params_from_numpy(npp, device="cpu")
    for v in params.values():
        v.requires_grad_(True)
    return params


def port_loss_and_grads(cfg, params, b, **kw):
    """(loss tensor, metrics, {name: grad}) of the port's ``train_loss``
    on the CPU through ``torch.autograd.grad``; unused leaves get zeros,
    as under ``jax.grad``."""
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    loss, metrics = TM.train_loss(params, cfg, tb, **kw)
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(names, grads))


def assert_grads_close(got, want, rel=1e-4):
    """Every leaf, by its JAX name, within ``rel`` of its largest |g|."""
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k].float().cpu().numpy() - want[k]).max())
        assert err <= rel * scale, (k, err, scale)
