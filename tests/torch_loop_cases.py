"""Shared cases of the training-loop tests (``test_torch_loop.py``,
``test_torch_loop_encdec.py``): the port's ``make_train_step`` against
the JAX package's on the CPU, at SMOKE in float32, the JAX weights
carried across (``params_from_numpy``) and the same numpy batches.

Bars: each of 3 steps' loss within 1e-5 x max(1, |loss|) and grad_norm
within 1e-5 relative of the JAX step's (``jax.jit`` with
``donate_argnums``, as the JAX loop runs it); the first step's
gradients, as ``adamw_update`` receives them, per leaf within 1e-4 of
the leaf's largest |g|, plus one quantization step of the row's scale
under int8.  The JAX side of the gradients is the JAX step's own
arithmetic (``jax.value_and_grad`` of ``train_loss`` per microbatch, a
float32 accumulator adding ``g / k``, ``repro.train.loop._qdq``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.distributed.compression import quantize_int8 as jquantize
from repro.models import model as JM
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train import loop as JL
from repro_torch.configs import TrainConfig
from repro_torch.models.params import params_from_numpy
from repro_torch.optim.adamw import adamw_init
from repro_torch.train.loop import TrainState, make_train_step
from torch_train_cases import batch, pair

STEPS = 3


def _tcfgs(microbatch, compression):
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=12, seed=0,
              microbatch=microbatch, grad_compression=compression)
    return JTrainConfig(**kw), TrainConfig(**kw)


def _jax_grads(jcfg, jtcfg, jp, b):
    """The JAX step's gradients before AdamW, and the rows' int8 scales
    (None without int8)."""
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bb: JM.train_loss(p, jcfg, bb, remat=False)[0]))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    k = jtcfg.microbatch
    if k and k > 1:
        acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
        for j in range(k):
            mb = {n: v.reshape((k, v.shape[0] // k) + v.shape[1:])[j]
                  for n, v in jb.items()}
            _, g = grad_fn(jp, mb)
            acc = jax.tree.map(lambda a, x: a + x.astype(jnp.float32) / k,
                               acc, g)
        grads = acc
    else:
        _, grads = grad_fn(jp, jb)
    scales = None
    if jtcfg.grad_compression == "int8":
        scales = {n: np.asarray(jquantize(g)[1]) for n, g in grads.items()}
        grads = jax.tree.map(JL._qdq, grads)
    return {n: np.asarray(g, np.float32) for n, g in grads.items()}, scales


def check_step(arch, microbatch, compression):
    """The port's first-step gradients and 3 steps against the JAX
    step's, within the bars above."""
    jcfg, cfg, jp, npp = pair(arch)
    jtcfg, tcfg = _tcfgs(microbatch, compression)
    batches = [batch(cfg, seed=10 + s, B=4, S=32) for s in range(STEPS)]

    # the first step's gradients, as adamw_update receives them
    want, scales = _jax_grads(jcfg, jtcfg, jp, batches[0])
    params = params_from_numpy(npp, device="cpu")
    state = TrainState(params, adamw_init(params, "cpu"))
    step = make_train_step(cfg, tcfg)
    _, got = step.gradients(
        state, {k: torch.from_numpy(v) for k, v in batches[0].items()})
    assert sorted(got) == sorted(want)
    for n in want:
        g = got[n]
        assert g.dtype == (torch.float32 if microbatch else params[n].dtype)
        err = np.abs(g.detach().float().numpy() - want[n])
        bar = 1e-4 * max(float(np.abs(want[n]).max()), 1e-30)
        if scales is not None:
            bar = bar + scales[n]
        assert np.all(err <= bar), (n, float(err.max()))

    # three steps of each package's step
    jstep = JL.make_train_step(jcfg, jtcfg)
    jstate = JL.TrainState(jax.tree.map(jnp.array, jp),
                           jadamw_init(jp))
    for s, b in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        jl, jg = float(jm["loss"]), float(jm["grad_norm"])
        assert abs(float(m["loss"]) - jl) <= 1e-5 * max(1.0, abs(jl)), \
            (s, float(m["loss"]), jl)
        assert abs(float(m["grad_norm"]) - jg) <= 1e-5 * jg, \
            (s, float(m["grad_norm"]), jg)
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-7
    assert int(state.opt.step) == int(jstate.opt.step) == STEPS
