"""The port's serving engine against the JAX engine, on the CPU.

internvl2-26b at its SMOKE size (2 layers, d_model 64), with the JAX
package's ``init_params`` carried across through ``params_from_numpy``,
serves patch streams with RoI keep-lists.  In float32 (params and KV
cache) the logits and the KV rows agree within 1e-4 and the greedy tokens,
ring counters and deadline reports are equal; in bfloat16 the logits
agree within 2e-2, the bar of tests/test_serving.py.  The engine's
prefill runs ``blockwise_attention``, plain jnp on the JAX side, so every
oracle here runs live.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import ARCH_IDS as JARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import init_params as jinit_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import ARCH_IDS, ServeConfig, get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import (count_params, init_params,
                                       param_tree, params_from_numpy)
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "internvl2-26b"
PORTED = ["internvl2-26b", "h2o-danube3-4b", "gemma3-27b",
          "mistral-nemo-12b", "deepseek-67b", "deepseek-moe-16b",
          "qwen3-moe-235b-a22b", "rwkv6-7b", "zamba2-2.7b",
          "whisper-small"]
F32 = dict(dtype="float32", kv_cache_dtype="float32")


def _engines(dtype):
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if dtype == "float32":
        jcfg, cfg = jcfg.replace(**F32), cfg.replace(**F32)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    return (JEngine(jcfg, JServeConfig(max_batch=4, roi_sparsity=True), jp),
            ServingEngine(cfg, ServeConfig(max_batch=4, roi_sparsity=True),
                          tp))


@pytest.fixture(scope="module")
def f32():
    return _engines("float32")


@pytest.fixture(scope="module")
def bf16():
    return _engines("bfloat16")


def _stream(rng, S, dim, frac=0.5):
    return (rng.standard_normal((S, dim)).astype(np.float32),
            rng.random(S) < frac)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("S,frac", [(150, 0.5), (96, 0.3)])
def test_roi_prefill_matches_jax(f32, S, frac):
    """Packed prefill: last kept row's logits and the KV rows below
    n_kept of every layer within 1e-4."""
    je, te = f32
    rng = np.random.default_rng(S)
    x, keep = _stream(rng, S, te.cfg.frontend_dim, frac)
    jr = je.roi_prefill(jnp.asarray(x), jnp.asarray(keep), block=32)
    tr = te.roi_prefill(x, keep, block=32)
    assert tr.n_kept == jr.n_kept == int(keep.sum())
    assert tr.n_total == S and tr.compute_fraction == jr.compute_fraction
    np.testing.assert_allclose(tr.logits.numpy(), _np(jr.logits), atol=1e-4)
    for j in range(2):
        np.testing.assert_allclose(
            tr.caches["blocks"][j][:, :, :tr.n_kept].numpy(),
            _np(jr.caches["blocks"][j])[:, :, :tr.n_kept], atol=1e-4)


def test_keep_all_matches_prefill(f32):
    """keep = all packing is the identity: the packed prefill's logits
    equal a plain prefill of the stream, on both sides."""
    je, te = f32
    S = 80
    x, _ = _stream(np.random.default_rng(5), S, te.cfg.frontend_dim)
    keep = np.ones(S, bool)
    tr = te.roi_prefill(x, keep, block=32)
    batch = {"tokens": np.zeros((1, 0), np.int32), "patches": x[None]}
    t_logits, _ = te.prefill(batch, max_seq=S)
    j_logits, _ = je.prefill({k: jnp.asarray(v) for k, v in batch.items()},
                             max_seq=S)
    assert tr.n_kept == S
    np.testing.assert_allclose(tr.logits.numpy(), t_logits.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(t_logits.numpy(), _np(j_logits), atol=1e-4)


def test_serve_matches_jax(f32):
    """Three requests with different keep-lists in one group, twice: equal
    greedy tokens, one ring build for the same geometry, no stacking."""
    je, te = f32
    rng = np.random.default_rng(3)
    streams = [_stream(rng, 70 + 20 * i, te.cfg.frontend_dim, 0.6)
               for i in range(3)]
    budgets = [4, 2, 4]
    for rnd in range(2):
        jout = je.serve([JRequest(i, tokens=x, keep=k, max_new_tokens=b)
                         for i, ((x, k), b) in enumerate(zip(streams,
                                                             budgets))],
                        greedy_steps=4)
        tout = te.serve([Request(i, tokens=x, keep=k, max_new_tokens=b)
                         for i, ((x, k), b) in enumerate(zip(streams,
                                                             budgets))],
                        greedy_steps=4)
        assert sorted(tout) == sorted(jout) == [0, 1, 2]
        for rid in jout:
            np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))
            assert tout[rid].shape == (budgets[rid],)
    assert te.ring_rebuilds == je.ring_rebuilds
    assert te.cache_stack_count == je.cache_stack_count == 0


def test_decode_tokens_group_matches_jax(f32):
    """The legacy group decode (stacks per-request caches): equal tokens
    and one stack counted on each side."""
    je, te = f32
    rng = np.random.default_rng(7)
    S, steps = 40, 3
    jc, tc, jf, tf, starts = [], [], [], [], []
    for _ in range(2):
        x, keep = _stream(rng, S, te.cfg.frontend_dim, 0.7)
        jr = je.roi_prefill(jnp.asarray(x), jnp.asarray(keep), block=32,
                            max_seq=64)
        tr = te.roi_prefill(x, keep, block=32, max_seq=64)
        jc.append(jr.caches)
        tc.append(tr.caches)
        jf.append(jnp.argmax(jr.logits[:, -1], -1))
        tf.append(torch.argmax(tr.logits[:, -1], dim=-1))
        starts.append(tr.n_kept)
    j_before, t_before = je.cache_stack_count, te.cache_stack_count
    jt, _ = je.decode_tokens_group(jc, jf, starts, steps)
    tt, _ = te.decode_tokens_group(tc, tf, starts, steps)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert te.cache_stack_count - t_before == \
        je.cache_stack_count - j_before == 1


def test_serve_deadline_matches_jax(f32):
    """The deadline former: equal tokens and an equal ServeReport."""
    je, te = f32
    rng = np.random.default_rng(8)
    reqs = []
    for i in range(5):
        x, keep = _stream(rng, 48, te.cfg.frontend_dim, 0.6)
        reqs.append(dict(rid=i, tokens=x, keep=keep, max_new_tokens=3,
                         group=i % 2, arrival_s=0.3 * i))
    jres, jrep = je.serve_deadline([JRequest(**r) for r in reqs],
                                   group_sizes={0: 2, 1: 3}, deadline_s=0.5,
                                   greedy_steps=3)
    tres, trep = te.serve_deadline([Request(**r) for r in reqs],
                                   group_sizes={0: 2, 1: 3}, deadline_s=0.5,
                                   greedy_steps=3)
    assert sorted(tres) == sorted(jres)
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]))
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert trep.deadline_flushes > 0 and trep.straggler_requests > 0


def test_bf16_logits_within_reference_bar(bf16):
    je, te = bf16
    x, keep = _stream(np.random.default_rng(0), 150, te.cfg.frontend_dim)
    jr = je.roi_prefill(jnp.asarray(x), jnp.asarray(keep), block=32)
    tr = te.roi_prefill(x, keep, block=32)
    assert tr.logits.dtype == torch.bfloat16
    np.testing.assert_allclose(tr.logits.float().numpy(), _np(jr.logits),
                               atol=2e-2)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_attention_layers_match_jax(softcap):
    """blockwise_attention with packed positions (PAD rows, a KV chunk that
    halves to divide Skv) and both decode attentions against JAX's."""
    rng = np.random.default_rng(11)
    B, S, H, D = 2, 96, 4, 16
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    pos = np.stack([np.sort(rng.choice(4 * S, S, replace=False))
                    for _ in range(B)]).astype(np.int32)
    pos[:, -10:] = np.iinfo(np.int32).max
    want = JL.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  softcap=softcap, kv_chunk=64,
                                  q_positions=jnp.asarray(pos),
                                  kv_positions=jnp.asarray(pos))
    got = TL.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 softcap=softcap, kv_chunk=64,
                                 q_positions=torch.from_numpy(pos),
                                 kv_positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got[:, :-10].numpy(),
                               np.asarray(want)[:, :-10], atol=1e-5)
    # decode: one query against a 2-KV-head cache, per-sequence lengths
    q1 = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kc, vc = (rng.normal(size=(B, S, 2, D)).astype(np.float32)
              for _ in range(2))
    clen = np.array([17, 60])
    full = TL.decode_attention(torch.from_numpy(q1),
                               TL.repeat_kv(torch.from_numpy(kc), 2),
                               TL.repeat_kv(torch.from_numpy(vc), 2),
                               torch.from_numpy(clen), softcap=softcap)
    grouped = TL.decode_attention_grouped(
        torch.from_numpy(q1), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(clen), softcap=softcap)
    jfull = JL.decode_attention(jnp.asarray(q1),
                                JL.repeat_kv(jnp.asarray(kc), 2),
                                JL.repeat_kv(jnp.asarray(vc), 2),
                                jnp.asarray(clen), softcap=softcap)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=1e-5)
    np.testing.assert_allclose(grouped.numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", PORTED)
def test_configs_and_params_mirror_reference(arch):
    """The registry, parameter counts and the random parameter tree
    (names, shapes, dtypes, norms of ones, the truncated fan-in normal)
    of each ported arch."""
    for smoke in (False, True):
        # every field of the JAX package's config; ``qk_norm`` is the
        # port's own, set where the JAX package keys it on the name
        port = dataclasses.asdict(get_config(arch, smoke))
        assert port.pop("qk_norm") == arch.startswith("qwen3")
        assert port == dataclasses.asdict(jget_config(arch, smoke))
        assert get_config(arch, smoke).param_count() == \
            jget_config(arch, smoke).param_count()
        assert get_config(arch, smoke).active_param_count() == \
            jget_config(arch, smoke).active_param_count()
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = get_config(arch, smoke=True)
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jspecs = JM.param_specs(jget_config(arch, smoke=True))
    assert sorted(tp) == sorted(jspecs)
    for name, t in tp.items():
        assert tuple(t.shape) == jspecs[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(jspecs[name].dtype), name
    assert count_params(tp) == sum(int(np.prod(s.shape))
                                   for s in jspecs.values())
    for name in tp:
        if name.endswith(("ln1", "ln2", "norm")):
            assert bool((tp[name] == 1).all()), name
    if cfg.frontend == "vit_patch":
        assert bool((tp["frontend_b"] == 0).all())
    # a d_model-fan-in projection: the attention's query, or rwkv6's
    # receptance
    wq = next(tp[k] for k in sorted(tp)
              if k.endswith(("_wq", "_wr"))).float()
    std = 1 / np.sqrt(cfg.d_model)
    assert float(wq.abs().max()) <= 2 * std + 1e-3
    assert abs(float(wq.std()) / std - 0.88) < 0.05   # truncated at 2 std


def test_qk_norm_follows_the_flag_not_the_name():
    """A renamed qwen3 config keeps its q/k norms and a dense config named
    like qwen3 gains none: the tree reads ``cfg.qk_norm`` only."""
    def norms(cfg):
        return sorted(k for k in param_tree(cfg, lambda *a: None)
                      if k.endswith(("qnorm", "knorm")))

    qwen = get_config("qwen3-moe-235b-a22b", smoke=True)
    assert norms(qwen) == ["blocks_knorm", "blocks_qnorm"]
    assert norms(qwen.replace(name="renamed")) == norms(qwen)
    assert norms(qwen.replace(qk_norm=False)) == []
    dense = get_config(ARCH, smoke=True)
    assert norms(dense.replace(name="qwen3-dense")) == []
    assert norms(dense.replace(qk_norm=True)) == [
        "blocks_knorm", "blocks_qnorm"]


def test_arch_ids_equal_the_reference():
    """Every arch of the JAX package, in its order; an unknown id raises
    ``KeyError``."""
    assert ARCH_IDS == JARCH_IDS
    assert sorted(ARCH_IDS) == sorted(PORTED)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_no_hidden_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        params_from_numpy({"embed": np.zeros((2, 2), np.float32)})
    cache = TM.init_cache(cfg, 1, 8, "cpu")
    assert cache["blocks"][0].device.type == "cpu"


def test_init_cache_resolves_its_device(monkeypatch):
    """``init_cache`` without a device runs on the card: with none it
    raises ``resolve_device``'s error instead of allocating on the CPU."""
    cfg = get_config(ARCH, smoke=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 8)
    k, v = TM.init_cache(cfg, 2, 8, device="cpu")["blocks"]
    assert k.device.type == v.device.type == "cpu"
    assert tuple(k.shape) == (cfg.num_layers, 2, 8, cfg.num_kv_heads,
                              cfg.head_dim)
