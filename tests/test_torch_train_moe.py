"""The port's training step for the moe family (deepseek-moe-16b,
qwen3-moe-235b-a22b) against the JAX package, on the CPU.

At SMOKE in float32 with the JAX weights carried across: the loss within
1e-5 x max(1, |loss|), each gradient leaf within 1e-4 of its largest
|g|, ``moe_aux`` and ``moe_dropped`` within 1e-6 -- after checking that
both packages route every token of every MoE layer to the same experts,
since a near-tie could flip one and move every gradient behind it.  At
the SMOKE capacity factor of 4 nothing drops; at 0.5 tokens do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import unroll as UR
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from torch_train_cases import (assert_grads_close, batch, jax_loss_and_grads,
                               pair, port_loss_and_grads, port_params)

MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _routing(monkeypatch, jcfg, cfg, jp, npp, b):
    """Each package's chosen experts, layer by layer, in one forward pass
    of ``train_loss`` (the JAX one eager with its scans unrolled, so the
    choices are concrete)."""
    seen = {"jax": [], "port": []}

    def record(mod, key):
        inner = mod.router_topk

        def topk(*args):
            out = inner(*args)
            seen[key].append(np.asarray(out[1]))
            return out
        monkeypatch.setattr(mod, "router_topk", topk)

    record(JMoE, "jax")
    record(TMoE, "port")
    with UR.unrolled():          # python loops: concrete values
        JM.train_loss(jp, jcfg, {k: jnp.asarray(v) for k, v in b.items()},
                      remat=False)
    with torch.no_grad():
        TM.train_loss(port_params(npp), cfg,
                      {k: torch.from_numpy(v) for k, v in b.items()})
    monkeypatch.undo()
    return seen["jax"], seen["port"]


@pytest.mark.parametrize("arch,cf", [(a, None) for a in MOE]
                         + [("deepseek-moe-16b", 0.5)])
def test_loss_grads_and_metrics_match_jax(monkeypatch, arch, cf):
    over = {} if cf is None else {"capacity_factor": cf}
    jcfg, cfg, jp, npp = pair(arch, **over)
    b = batch(cfg, seed=11)
    jax_experts, port_experts = _routing(monkeypatch, jcfg, cfg, jp, npp, b)
    n_moe = cfg.num_layers - cfg.first_dense_layers
    assert len(jax_experts) == len(port_experts) == n_moe
    for j, t in zip(jax_experts, port_experts):
        np.testing.assert_array_equal(t, j)
    jl, jm, jg = jax_loss_and_grads(jcfg, jp, b)
    loss, metrics, grads = port_loss_and_grads(cfg, port_params(npp), b,
                                               remat=False)
    assert sorted(metrics) == ["moe_aux", "moe_dropped"] == sorted(jm)
    for k in jm:
        assert abs(float(metrics[k]) - jm[k]) <= 1e-6, k
    assert (jm["moe_dropped"] > 0) == (cf is not None)
    assert abs(float(loss) - jl) <= 1e-5 * max(1.0, abs(jl))
    assert_grads_close(grads, jg)


@pytest.mark.parametrize("arch", MOE)
def test_remat_equals_no_remat_bitwise(arch):
    """The MoE blocks (and the first dense layer) recomputed in the
    backward pass: the loss, the metrics and every gradient bitwise."""
    _, cfg, _, npp = pair(arch, capacity_factor=0.5)
    b = batch(cfg, seed=12)
    params = port_params(npp)
    l0, m0, g0 = port_loss_and_grads(cfg, params, b, remat=False)
    l1, m1, g1 = port_loss_and_grads(cfg, params, b, remat=True)
    assert torch.equal(l0, l1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
