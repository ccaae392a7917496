"""The port's MoE layer and moe decoders (deepseek-moe-16b, qwen3-moe-235b)
against the JAX package, on the CPU.

The router, capacity, dispatch and combine in float32 within 1e-5 (the
routing, ``top_idx``, equal: the inputs hold no ties), with and without
drops and shared experts; the SMOKE models with the JAX package's
parameters carried across by ``params_from_numpy``: prefill and decode
logits within 1e-4 in float32, greedy ``serve`` tokens equal.  In
bfloat16 the layer is held to the engine's bar (2e-2,
tests/test_torch_serving.py) and whole models to the JAX package's (5e-2,
tests/test_arch_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget_config
from repro.models import forward as JF
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models.params import init_params as jinit_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import ServeConfig, get_config
from repro_torch.models import forward as TF
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine

F32 = dict(dtype="float32", kv_cache_dtype="float32")
ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "float32":
        jcfg, cfg = jcfg.replace(**F32), cfg.replace(**F32)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    return jcfg, cfg, jp, tp


def _np(x):
    return np.asarray(x, np.float32)


def _layer_inputs(seed, B, S, D, E, F, shared):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    ws = [(rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)
          for shape in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    sh = [(rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
          for shape in ((D, 2 * F), (D, 2 * F), (2 * F, D))] if shared \
        else None
    return x, ws, sh


@pytest.mark.parametrize("S,k", [(1, 2), (7, 2), (40, 3), (33, 8)])
def test_router_topk_matches_jax(S, k):
    """Renormalised top-k values within 1e-5, the routing equal, the
    load-balance loss within 1e-5."""
    x, (rw, *_), _ = _layer_inputs(S, 3, S, 32, 16, 8, False)
    jv, ji, jaux = JMoE.router_topk(jnp.asarray(x), jnp.asarray(rw), k)
    tv, ti, taux = TMoE.router_topk(torch.from_numpy(x),
                                    torch.from_numpy(rw), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)


def test_capacity_matches_jax():
    for arch in ARCHS:
        for smoke in (False, True):
            jcfg, cfg = jget_config(arch, smoke), get_config(arch, smoke)
            for cf in (None, 0.5, 1.25, cfg.num_experts
                       / cfg.experts_per_token):
                if cf is not None:
                    jcfg, cfg = (c.replace(capacity_factor=cf)
                                 for c in (jcfg, cfg))
                for S in (1, 2, 8, 9, 100, 1024, 4609):
                    assert TMoE.capacity(cfg, S) == JMoE.capacity(jcfg, S)


@pytest.mark.parametrize("cf,shared,act", [
    (4.0, False, "silu"),        # dropless
    (4.0, True, "silu"),         # dropless, shared experts
    (0.5, False, "silu"),        # tokens dropped past capacity
    (0.5, True, "gelu_glu"),     # drops, shared experts, GeGLU
])
def test_moe_layer_matches_jax(cf, shared, act):
    """``moe_layer``'s y within 1e-5, its aux loss and dropped share
    within 1e-5 (the share exactly 0 without drops, > 0 with them)."""
    jcfg = jget_config("deepseek-moe-16b", smoke=True).replace(
        capacity_factor=cf, act=act, **F32)
    cfg = get_config("deepseek-moe-16b", smoke=True).replace(
        capacity_factor=cf, act=act, **F32)
    x, (rw, wg, wu, wd), sh = _layer_inputs(int(cf * 10) + shared, 2, 40,
                                            cfg.d_model, cfg.num_experts,
                                            cfg.moe_d_ff, shared)
    jy, jaux, jdrop = JMoE.moe_layer(
        jnp.asarray(x), *(jnp.asarray(w) for w in (rw, wg, wu, wd)), jcfg,
        None, shared=None if sh is None else tuple(jnp.asarray(w)
                                                   for w in sh))
    ty, taux, tdrop = TMoE.moe_layer(
        torch.from_numpy(x), *(torch.from_numpy(w) for w in (rw, wg, wu, wd)),
        cfg, shared=None if sh is None else tuple(torch.from_numpy(w)
                                                  for w in sh))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)
    np.testing.assert_allclose(float(tdrop), float(jdrop), atol=1e-5)
    assert (float(tdrop) > 0) == (cf < 1)
    if cf >= 1:
        assert float(tdrop) == 0.0


def test_moe_layer_needs_no_mesh():
    """A context on a model axis of 1 (every expert local) gives
    ``dist=None``'s layer bitwise; a ``dist`` that is no ``DistContext``
    raises.  The expert-parallel route over a model axis above 1 is in
    ``test_torch_tp_moe.py``."""
    from types import SimpleNamespace

    from repro_torch.models.dist import DistContext
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True).replace(**F32)
    x, (rw, wg, wu, wd), _ = _layer_inputs(3, 2, 24, cfg.d_model,
                                           cfg.num_experts, cfg.moe_d_ff,
                                           False)
    args = [torch.from_numpy(a) for a in (x, rw, wg, wu, wd)]
    want = TMoE.moe_layer(*args, cfg)
    one = DistContext(mesh=SimpleNamespace(shape={"data": 1, "model": 1}))
    got = TMoE.moe_layer(*args, cfg, dist=one)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(TypeError, match="DistContext"):
        TMoE.moe_layer(*args, cfg, dist=object())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill's last logits and caches ({"blocks"[, "dense"]}), then three
    decode steps, within 1e-4 of the JAX model's (jitted, as its engine
    runs it); moe_trunk's aux and dropped sums within 1e-5."""
    jcfg, cfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(1)
    S = 50
    toks = rng.integers(0, cfg.vocab_size, (2, S + 3)).astype(np.int32)
    jprefill = jax.jit(lambda p, b, c: JM.prefill(p, jcfg, b, c))
    jdecode = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                      JM.init_cache(jcfg, 2, S + 3))
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        TM.init_cache(cfg, 2, S + 3, "cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    assert sorted(tc) == sorted(jc) == (["blocks", "dense"]
                                        if cfg.first_dense_layers
                                        else ["blocks"])
    for key in jc:
        for j in range(2):
            np.testing.assert_allclose(tc[key][j].numpy(), _np(jc[key][j]),
                                       atol=1e-4)
    for i in range(3):
        t = toks[:, S + i:S + i + 1]
        jl, jc = jdecode(jp, jnp.asarray(t), jc, S + i)
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(t), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    # the trunk's summed aux and dropped share, without caches
    x = jnp.asarray(jp["embed"])[jnp.asarray(toks)]
    _, _, jaux, jdrop = JF.moe_trunk(jp, jcfg, x, dist=None)
    _, _, taux, tdrop = TF.moe_trunk(tp, cfg, torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)
    np.testing.assert_allclose(float(tdrop), float(jdrop), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropless_decode_equals_prefill(arch):
    """The port against itself: with capacity_factor E / K nothing drops,
    so decoding the last token after a prefill of the rest gives a full
    prefill's last logits (f32, 1e-4)."""
    _, cfg, _, tp = _pair(arch)
    cfg = cfg.replace(capacity_factor=cfg.num_experts
                      / cfg.experts_per_token)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    caches = TM.init_cache(cfg, 2, 48, "cpu")
    _, caches = TM.prefill(tp, cfg, {"tokens": toks[:, :-1]}, caches)
    dec, _ = TM.decode_step(tp, cfg, toks[:, -1:], caches, 39)
    full, _ = TM.prefill(tp, cfg, {"tokens": toks},
                         TM.init_cache(cfg, 2, 48, "cpu"))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=1e-4)


def test_bf16_moe_layer_within_engine_bar():
    """bfloat16 weights and activations: the routing equal and ``y``
    within 2e-2 of JAX's, the engine's bar (tests/test_torch_serving.py)."""
    jcfg = jget_config("qwen3-moe-235b-a22b", smoke=True)
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    x, ws, _ = _layer_inputs(9, 2, 40, cfg.d_model, cfg.num_experts,
                             cfg.moe_d_ff, False)
    jx, *jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in [x] + ws)
    tx, *tw = (torch.from_numpy(a).to(torch.bfloat16) for a in [x] + ws)
    jy, jaux, jdrop = JMoE.moe_layer(jx, *jw, jcfg, None)
    ty, taux, tdrop = TMoE.moe_layer(tx, *tw, cfg)
    _, ji, _ = JMoE.router_topk(jx, jw[0], cfg.experts_per_token)
    _, ti, _ = TMoE.router_topk(tx, tw[0], cfg.experts_per_token)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), atol=2e-2)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5)
    assert float(tdrop) == float(jdrop)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_reference_bar(arch):
    """bfloat16 prefill logits within atol = rtol = 5e-2 of JAX's, the
    JAX package's bar for bfloat16 whole models (tests/test_arch_smoke.py):
    each side rounds every layer's output, and the two differ by a
    bfloat16 step in a few elements a block (float32 sums in another
    order), a few steps at logits of |2-3|.  Measured at this bar (CPU,
    torch 2.13, jax 0.9.0): deepseek-moe-16b 0.0391 at most, 0.56 of
    the allowance atol + rtol * |want|; qwen3-moe 0.0313, 0.45 of it."""
    jcfg, cfg, jp, tp = _pair(arch, "bfloat16")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 48)).astype(np.int32)
    jl, _ = jax.jit(lambda p, b, c: JM.prefill(p, jcfg, b, c))(
        jp, {"tokens": jnp.asarray(toks)}, JM.init_cache(jcfg, 1, 48))
    tl, _ = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                       TM.init_cache(cfg, 1, 48, "cpu"))
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(), _np(jl), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch):
    """Two dense and two RoI-packed requests in one group: equal greedy
    tokens to the JAX engine's."""
    jcfg, cfg, jp, tp = _pair(arch)
    je = JEngine(jcfg, JServeConfig(max_batch=4, roi_sparsity=True), jp)
    te = ServingEngine(cfg, ServeConfig(max_batch=4, roi_sparsity=True), tp)
    rng = np.random.default_rng(4)
    reqs = []
    for i, n in enumerate([20, 45, 70, 33]):
        keep = rng.random(n) < 0.6 if i % 2 else None
        reqs.append(dict(rid=i, tokens=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), keep=keep,
            max_new_tokens=5))
    jout = je.serve([JRequest(**r) for r in reqs], greedy_steps=5)
    tout = te.serve([Request(**r) for r in reqs], greedy_steps=5)
    assert sorted(tout) == sorted(jout) == [0, 1, 2, 3]
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_mirrors_reference(arch):
    """Names, shapes and dtypes of the random tree equal the JAX
    package's spec, the count equals ``param_count``, and every leaf
    larger than a draw chunk is drawn whole."""
    cfg = get_config(arch, smoke=True)
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    spec = JM.param_specs(jget_config(arch, smoke=True))
    assert sorted(tp) == sorted(spec)
    for name, t in tp.items():
        assert tuple(t.shape) == spec[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(spec[name].dtype), name
    extra = sum(int(np.prod(spec[k].shape)) for k in spec
                if k.endswith(("qnorm", "knorm")))
    assert sum(int(t.numel()) for t in tp.values()) == \
        cfg.param_count() + extra
    std = 1 / np.sqrt(cfg.d_model)
    wg = tp["blocks_moe_wg"].float()
    assert float(wg.abs().max()) <= 2 * std + 1e-3
    assert abs(float(wg.std()) / std - 0.88) < 0.05
