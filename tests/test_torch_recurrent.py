"""The port's recurrent-state families, rwkv6-7b (``ssm``) and zamba2-2.7b's
Mamba2 hybrid (``hybrid``), against the JAX package, on the CPU.

The scans and blocks in float32 within 1e-5 absolute and 1e-5 of the
value's size (their outputs and states reach ~10-50, where a float32
step is ~1e-6 and the einsums sum in another order); the SMOKE models
with the JAX package's parameters carried across by
``params_from_numpy``, inputs drawn from numpy seeds, the JAX side under
``jax.jit`` as its engine runs it: prefill logits and every state within
1e-4 in float32, three decode steps with equal greedy tokens, and
``serve`` tokens equal.  bfloat16 whole models hold the JAX package's bar
(5e-2, tests/test_arch_smoke.py).  ROADMAP C-R5 (a packed prompt's
padding rows run through the recurrence) and C-R6 (a ring slot's stale
state seeds the next prefill) are reproduced, not fixed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import forward as JF
from repro.models import model as JM
from repro.models import rwkv as JR
from repro.models import ssm as JS
from repro.models.params import init_params as jinit_params
from repro.models.params import param_specs
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import ServeConfig, get_config
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import forward as TF
from repro_torch.models import model as TM
from repro_torch.models import rwkv as TR
from repro_torch.models import ssm as TS
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serving import engine as teng
from repro_torch.serving.engine import Request, ServingEngine

F32 = dict(dtype="float32", kv_cache_dtype="float32")
ARCHS = ["rwkv6-7b", "zamba2-2.7b"]


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    """(JAX config, port config, JAX params, port params) at SMOKE."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype == "float32":
        jcfg, cfg = jcfg.replace(**F32), cfg.replace(**F32)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    return jcfg, cfg, jp, tp


@functools.lru_cache(maxsize=None)
def _jit(arch, dtype="float32"):
    """The JAX model's prefill, decode and vmapped group decode, jitted."""
    jcfg = _pair(arch, dtype)[0]
    prefill = jax.jit(lambda p, b, c, pos, last: JM.prefill(
        p, jcfg, b, c, positions=pos, last_index=last))
    decode = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    group = jax.jit(lambda p, t, c, pos: jax.vmap(
        lambda tb, cb, pb: JM.decode_step(p, jcfg, tb, cb, pb))(t, c, pos))
    return prefill, decode, group


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree):
    """The tensors of a cache tree, in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _close_trees(tc, jc, atol=1e-4, swap=False):
    """Every leaf within ``atol``; with ``swap`` the JAX tree is a vmapped
    group's (G, L, 1, ...) stack, the port's (L, G, ...)."""
    tl, jl = _leaves(tc), _leaves(jc)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = _np(j)
        if swap:
            j = np.swapaxes(j[:, :, 0], 0, 1)
        np.testing.assert_allclose(t.float().numpy(), j, atol=atol)


def _tokens(rng, cfg, *shape):
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the scans
# ---------------------------------------------------------------------------

def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("S", [16, 31, 32, 48])
def test_wkv_chunked_matches_jax(S, seeded):
    """Chunks of 16, or halved until they divide S (31: one token a
    chunk); with and without a carried-in state: the output and the final
    state within 1e-5 (absolute and relative)."""
    rng = np.random.default_rng(S + seeded)
    B, H, P = 2, 3, 4
    r, k, v = (_rand(rng, B, S, H, P) for _ in range(3))
    lw = np.clip(-np.exp(_rand(rng, B, S, H, P)), TR.LOG_DECAY_CLAMP, 0.0)
    u = _rand(rng, H, P)
    st = _rand(rng, B, H, P, P) if seeded else None
    jo, js = JR.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, lw, u)),
                            init_state=None if st is None
                            else jnp.asarray(st))
    to, ts = TR.wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, lw, u)),
                            init_state=None if st is None
                            else torch.from_numpy(st))
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
def test_ssd_chunked_matches_jax(chunk, seeded):
    """The SSD scan at chunks 1 to 32 over S = 32, with and without a
    carried-in state: y and the final state within 1e-5 (absolute and
    relative)."""
    rng = np.random.default_rng(chunk + 10 * seeded)
    B, S, H, P, N = 2, 32, 3, 4, 5
    xh = _rand(rng, B, S, H, P)
    dt = np.log1p(np.exp(_rand(rng, B, S, H)))
    A_log = _rand(rng, H) * 0.5
    Bc, Cc = _rand(rng, B, S, N), _rand(rng, B, S, N)
    st = _rand(rng, B, H, N, P) if seeded else None
    args = (xh, dt, A_log, Bc, Cc)
    jy, js = JS.ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                            init_state=None if st is None
                            else jnp.asarray(st))
    ty, ts = TS.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                            init_state=None if st is None
                            else torch.from_numpy(st))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5, rtol=1e-5)


def test_recurrent_steps_match_jax():
    """``wkv_step`` and ``ssd_step``: one token's output and state within
    1e-5."""
    rng = np.random.default_rng(7)
    B, H, P, N = 2, 3, 4, 5
    r, k, v = (_rand(rng, B, 1, H, P) for _ in range(3))
    lw = -np.exp(_rand(rng, B, 1, H, P))
    u, st = _rand(rng, H, P), _rand(rng, B, H, P, P)
    jo, js = JR.wkv_step(*(jnp.asarray(a) for a in (st, r, k, v, lw, u)))
    to, ts = TR.wkv_step(*(torch.from_numpy(a) for a in (st, r, k, v, lw, u)))
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5)
    xh, dt = _rand(rng, B, 1, H, P), np.abs(_rand(rng, B, 1, H))
    A_log, Bc, Cc = _rand(rng, H), _rand(rng, B, 1, N), _rand(rng, B, 1, N)
    st = _rand(rng, B, H, N, P)
    args = (st, xh, dt, A_log, Bc, Cc)
    jy, js = JS.ssd_step(*(jnp.asarray(a) for a in args))
    ty, ts = TS.ssd_step(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5)


@pytest.mark.parametrize("tail", [None, "float32", "bfloat16"])
def test_causal_conv_matches_jax(tail):
    """The causal conv, without a tail and with a carried one: y within
    1e-5 and the new tail equal, in jnp's promoted dtype (a bfloat16 tail
    meeting float32 inputs comes back float32)."""
    rng = np.random.default_rng(11)
    x, w, b = _rand(rng, 2, 9, 6), _rand(rng, 4, 6), _rand(rng, 6)
    t = None if tail is None else _rand(rng, 2, 3, 6)
    jt = None if t is None else jnp.asarray(t, getattr(jnp, tail))
    tt = None if t is None else torch.from_numpy(t).to(getattr(torch, tail))
    jy, jn = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             jt)
    ty, tn = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), tt)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5)
    np.testing.assert_array_equal(tn.numpy(), _np(jn))
    assert tn.dtype == ty.dtype == torch.float32 and str(jn.dtype) == "float32"


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _block_case(arch, seed):
    """Layer 0's parameters of both sides, a (2, 16, D) input and a random
    carried-in state."""
    jcfg, cfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(seed)
    jl = {k[7:]: v[0] for k, v in jp.items() if k.startswith("blocks_")}
    tl = TF.layer_params(TF._sub(tp, "blocks_"), 0)
    x = _rand(rng, 2, 16, cfg.d_model)
    if arch == "rwkv6-7b":
        H, P, D = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.d_model
        st = (_rand(rng, 2, H, P, P), _rand(rng, 2, D), _rand(rng, 2, D))
        return (jcfg, cfg, jl, tl, x, st,
                lambda a, p, s, one: JR.rwkv6_block(
                    a, p, jcfg, JR.RWKVState(*s), single_step=one),
                lambda a, p, s, one: TR.rwkv6_block(
                    a, p, cfg, TR.RWKVState(*s), single_step=one))
    H, N, P = cfg.ssm_num_heads, cfg.ssm_state_dim, cfg.ssm_head_dim
    st = (_rand(rng, 2, H, N, P),
          _rand(rng, 2, cfg.ssm_conv_width - 1, TS.conv_dim(cfg)))
    return (jcfg, cfg, jl, tl, x, st,
            lambda a, p, s, one: JS.mamba2_block(
                a, JF._mamba_pdict(p), jcfg, JS.MambaState(*s),
                single_step=one),
            lambda a, p, s, one: TS.mamba2_block(
                a, TF._mamba_pdict(p), cfg, TS.MambaState(*s),
                single_step=one))


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_matches_jax(arch, single):
    """``rwkv6_block`` and ``mamba2_block`` from a random state, over 16
    tokens or one: the output and every state within 1e-5 (absolute and
    relative)."""
    jcfg, cfg, jl, tl, x, st, jblock, tblock = _block_case(arch, 3)
    if single:
        x = x[:, :1]
    jy, js = jax.jit(jblock, static_argnums=3)(
        jnp.asarray(x), jl, tuple(jnp.asarray(s) for s in st), single)
    ty, ts = tblock(torch.from_numpy(x), tl,
                    tuple(torch.from_numpy(s) for s in st), single)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=1e-5)
    for t, j in zip(ts, js):
        np.testing.assert_allclose(t.numpy(), _np(j), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_specs(arch):
    """``init_params`` at SMOKE: JAX's names, shapes and dtypes; norms of
    ones, mix offsets of zeros, A = exp(m_A_log) in [1, 16], the decay
    base's ramp from -6 to -1."""
    cfg = get_config(arch, smoke=True)
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = param_specs(jget_config(arch, smoke=True))
    assert sorted(tp) == sorted(specs)
    for name, t in tp.items():
        assert tuple(t.shape) == specs[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(specs[name].dtype), name
    if arch == "rwkv6-7b":
        assert bool((tp["ln_in"] == 1).all())
        assert bool((tp["blocks_maa_wkvrg"] == 0).all())
        ramp = tp["blocks_decay_base"]
        assert float(ramp[:, 0].max()) == -6.0
        assert float(ramp[:, -1].min()) == pytest.approx(-1.0)
        assert bool((ramp == ramp[:1]).all())
    else:
        A = torch.exp(tp["blocks_m_A_log"])
        assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0 + 1e-4
        assert bool((tp["blocks_m_D"] == 1).all())
        assert bool((tp["sa_ln1"] == 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """A 40-token prompt: the last row's logits and every state (and the
    hybrid's KV caches) within 1e-4, then three decode steps, each with
    the same greedy token; the caches after them."""
    jcfg, cfg, jp, tp = _pair(arch)
    jprefill, jdecode, _ = _jit(arch)
    rng = np.random.default_rng(1)
    S = 40
    toks = _tokens(rng, cfg, 1, S + 3)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                      JM.init_cache(jcfg, 1, S + 3), None, None)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        TM.init_cache(cfg, 1, S + 3, "cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    _close_trees(tc, jc)
    for i in range(3):
        t = toks[:, S + i:S + i + 1]
        jl, jc = jdecode(jp, jnp.asarray(t), jc, S + i)
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(t), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
        assert int(tl.argmax()) == int(jnp.argmax(jl))
    _close_trees(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_within_reference_bar(arch):
    """bfloat16 prefill and one decode step's logits within atol = rtol =
    5e-2 of JAX's, the JAX package's bar for bfloat16 whole models
    (tests/test_arch_smoke.py); 2e-2 does not hold for rwkv6.  Both sides
    round every op's bfloat16 output, but XLA keeps float32 inside its
    fusions and sums float32 products in another order, so elements sit
    a bfloat16 step apart.  Measured (CPU, torch 2.13, jax 0.9.0):
    rwkv6-7b 0.0195 prefill, 0.0217 decode; zamba2-2.7b 0.0084, 0.0068."""
    jcfg, cfg, jp, tp = _pair(arch, "bfloat16")
    jprefill, jdecode, _ = _jit(arch, "bfloat16")
    toks = _tokens(np.random.default_rng(3), cfg, 1, 41)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :40])},
                      JM.init_cache(jcfg, 1, 41), None, None)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :40])},
                        TM.init_cache(cfg, 1, 41, "cpu"))
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(), _np(jl), atol=5e-2,
                               rtol=5e-2)
    jl, _ = jdecode(jp, jnp.asarray(toks[:, 40:]), jc, 40)
    tl, _ = TM.decode_step(tp, cfg, torch.from_numpy(toks[:, 40:]), tc, 40)
    np.testing.assert_allclose(tl.float().numpy(), _np(jl), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_group_decode_matches_jax(arch):
    """Three prompts of different lengths prefilled alone, stacked, and
    decoded as one (G,) group at their own positions (the hybrid's RoPE
    and KV rows per row): four teacher-forced steps' logits and the
    caches after them within 1e-4 of JAX's vmapped per-request decode."""
    jcfg, cfg, jp, tp = _pair(arch)
    jprefill, _, jgroup = _jit(arch)
    lens, steps = [16, 33, 48], 4
    max_seq = max(lens) + steps
    rng = np.random.default_rng(2)
    prompts = [_tokens(rng, cfg, 1, n) for n in lens]
    feed = _tokens(rng, cfg, len(lens), steps)
    jcs, tcs = [], []
    for p in prompts:
        jcs.append(jprefill(jp, {"tokens": jnp.asarray(p)},
                            JM.init_cache(jcfg, 1, max_seq), None, None)[1])
        tcs.append(TM.prefill(tp, cfg, {"tokens": torch.from_numpy(p)},
                              TM.init_cache(cfg, 1, max_seq, "cpu"))[1])
    jc = jax.tree.map(lambda *xs: jnp.stack(xs), *jcs)
    tc = teng._tree_map(lambda *xs: torch.cat(xs, dim=1), *tcs)
    pos = np.array(lens)
    for i in range(steps):
        jl, jc = jgroup(jp, jnp.asarray(feed[:, i, None, None]), jc,
                        jnp.asarray(pos + i))
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(feed[:, i, None]),
                                tc, torch.from_numpy(pos + i))
        np.testing.assert_allclose(tl.numpy(), _np(jl)[:, 0], atol=1e-4)
    _close_trees(tc, jc, swap=True)


def test_cache_layouts():
    """``init_cache``: rwkv6's three float32 states; zamba2's float32 SSD
    state, its bfloat16 conv tail whatever the model's dtype, and one KV
    cache per application of a shared block."""
    cfg = _pair("rwkv6-7b")[1]
    wkv, st, sc = TM.init_cache(cfg, 3, 20, "cpu")
    assert tuple(wkv.shape) == (2, 3, 4, 16, 16)
    assert tuple(st.shape) == tuple(sc.shape) == (2, 3, 64)
    assert {t.dtype for t in (wkv, st, sc)} == {torch.float32}
    cfg = _pair("zamba2-2.7b")[1]
    c = TM.init_cache(cfg, 3, 20, "cpu")
    ssm, conv = c["states"]
    assert tuple(ssm.shape) == (6, 3, 8, 16, 16) and ssm.dtype == torch.float32
    assert tuple(conv.shape) == (6, 3, 3, 160) and conv.dtype == torch.bfloat16
    assert tuple(c["attn"][0].shape) == (2, 3, 20, 4, 16)
    assert c["attn"][0].dtype == torch.float32          # kv_cache_dtype


def test_conv_tail_dtype_after_prefill_and_in_the_ring():
    """zamba2 in float32: ``prefill`` returns the conv tail in float32, as
    JAX's does (the bfloat16 cache meets float32 inputs), so a direct
    prefill -> decode carries it unrounded; the engine's slot write casts
    it into the ring's bfloat16, as JAX's ``_ring_write`` does, to the
    same values."""
    jcfg, cfg, jp, tp = _pair("zamba2-2.7b")
    toks = _tokens(np.random.default_rng(9), cfg, 1, 24)
    je = JEngine(jcfg, JServeConfig(max_batch=2), jp)
    te = ServingEngine(cfg, ServeConfig(max_batch=2), tp)
    jring = je._ensure_ring(1, 32)
    _, jslot = je.prefill({"tokens": jnp.asarray(toks)},
                          caches=jax.tree.map(lambda x: x[0], jring))
    assert str(jslot["states"][1].dtype) == "float32"
    jring = je._ring_write(jring, jslot, 0)
    ring = te._ensure_ring(1, 32)
    slot = teng._tree_map(lambda t: t[:, 0:1], ring)
    _, new = te.prefill({"tokens": toks}, caches=slot)
    assert new["states"][1].dtype == torch.float32
    np.testing.assert_allclose(new["states"][1].numpy(),
                               _np(jslot["states"][1]), atol=1e-4)
    teng._write_slot(slot, new)
    assert ring["states"][1].dtype == torch.bfloat16
    assert str(jring["states"][1].dtype) == "bfloat16"
    assert torch.equal(ring["states"][1][:, 0:1],
                       new["states"][1].to(torch.bfloat16))
    _close_trees(ring, jax.tree.map(lambda x: x[0], jring), atol=2e-2)


# ---------------------------------------------------------------------------
# the engine, C-R5, C-R6 and the launcher
# ---------------------------------------------------------------------------

def _requests(cfg, rng):
    """Four requests, two dense and two RoI-packed."""
    out = []
    for i, n in enumerate([20, 45, 70, 33]):
        keep = rng.random(n) < 0.6 if i % 2 else None
        out.append(dict(rid=i, tokens=_tokens(rng, cfg, n), keep=keep,
                        max_new_tokens=6 - i % 2))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(arch):
    """``serve`` twice over the same group: equal greedy tokens each time
    -- the second from slots that still hold the first serve's decoded
    states, which seed the prefill on both sides (C-R6) -- one ring build,
    no stacking, and the ring's dtypes after it equal JAX's."""
    jcfg, cfg, jp, tp = _pair(arch)
    je = JEngine(jcfg, JServeConfig(max_batch=4, roi_sparsity=True), jp)
    te = ServingEngine(cfg, ServeConfig(max_batch=4, roi_sparsity=True), tp)
    reqs = _requests(cfg, np.random.default_rng(5))
    for _ in range(2):
        jout = je.serve([JRequest(**r) for r in reqs], greedy_steps=6)
        tout = te.serve([Request(**r) for r in reqs], greedy_steps=6)
        assert sorted(tout) == sorted(jout) == [0, 1, 2, 3]
        for rid in jout:
            np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))
    assert te.ring_rebuilds == je.ring_rebuilds == 1
    assert te.cache_stack_count == je.cache_stack_count == 0
    assert [str(t.dtype).split(".")[-1] for t in _leaves(te._ring)] == \
        [str(j.dtype) for j in _leaves(je._ring)]


def test_stale_ring_state_reproduces_c_r6():
    """C-R6: a serve's prefill starts from its slot's contents, which after
    a flush are the last request's decoded states.  rwkv6 at SMOKE: a
    request served after another in the same slot gets other tokens than
    on a fresh engine, on both sides alike."""
    jcfg, cfg, jp, tp = _pair("rwkv6-7b")
    rng = np.random.default_rng(0)
    first = dict(rid=0, tokens=_tokens(rng, cfg, 40), max_new_tokens=6)
    second = dict(rid=1, tokens=_tokens(rng, cfg, 33), max_new_tokens=6)
    outs = []
    for J, S, R, Req in ((JEngine, JServeConfig, jp, JRequest),
                         (ServingEngine, ServeConfig, tp, Request)):
        fresh = J(jcfg if J is JEngine else cfg, S(max_batch=1), R)
        alone = fresh.serve([Req(**second)], greedy_steps=6)[1]
        used = J(jcfg if J is JEngine else cfg, S(max_batch=1), R)
        after = used.serve([Req(**first), Req(**second)], greedy_steps=6)[1]
        outs.append((np.asarray(alone), np.asarray(after)))
    (ja, jb), (ta, tb) = outs
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    assert not np.array_equal(ta, tb)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_prompt_reproduces_c_r5(arch):
    """C-R5: a keep-all prompt of 96 tokens packed to 128 rows runs the
    recurrence through its 32 padding rows, and decode starts from that
    state.  The packed prefill equals a dense one (1e-4), and its decode
    logits are JAX's within 1e-4 and stand apart from the dense path's."""
    jcfg, cfg, jp, tp = _pair(arch)
    jprefill, jdecode, _ = _jit(arch)
    S, steps = 96, 2
    toks = _tokens(np.random.default_rng(4), cfg, S + steps)
    keep = np.ones(S, bool)
    jpk, jpos, n = jops.pack_tokens(jnp.asarray(toks[:S]), jnp.asarray(keep),
                                    128)
    tpk, tpos, tn = tops.pack_tokens(torch.from_numpy(toks[:S]),
                                     torch.from_numpy(keep), 128)
    assert int(n) == tn == S and tpk.shape[0] == 128
    max_seq = 128 + steps
    jl, jc = jprefill(jp, {"tokens": jpk[None]},
                      JM.init_cache(jcfg, 1, max_seq), jpos[None], S - 1)
    tl, tc = TM.prefill(tp, cfg, {"tokens": tpk[None]},
                        TM.init_cache(cfg, 1, max_seq, "cpu"),
                        positions=tpos[None], last_index=S - 1)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    dl, dc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[None, :S])},
                        TM.init_cache(cfg, 1, max_seq, "cpu"))
    np.testing.assert_allclose(tl.numpy(), dl.numpy(), atol=1e-4)
    for i in range(steps):
        t = toks[None, S + i:S + i + 1]
        jl, jc = jdecode(jp, jnp.asarray(t), jc, S + i)
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(t), tc, S + i)
        dl, dc = TM.decode_step(tp, cfg, torch.from_numpy(t), dc, S + i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
        assert np.abs(tl.numpy() - dl.numpy()).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_row_equals_kept_only_prefill(arch):
    """What C-R5 leaves standing, the card's identity (b): ``roi_prefill``'s
    logits at n_kept - 1 equal a dense prefill of the kept tokens alone
    (1e-4), the kept rows being a prefix of the packed rows."""
    _, cfg, _, tp = _pair(arch)
    te = ServingEngine(cfg, ServeConfig(max_batch=1, roi_sparsity=True), tp)
    rng = np.random.default_rng(6)
    toks = _tokens(rng, cfg, 150)
    keep = rng.random(150) < 0.5
    res = te.roi_prefill(toks, keep, block=64)
    dense, _ = te.prefill({"tokens": toks[None, keep]},
                          max_seq=int(keep.sum()))
    assert res.n_kept == int(keep.sum())
    np.testing.assert_allclose(res.logits.numpy(), dense.numpy(), atol=1e-4)


def test_decode_tokens_group_stacks_every_cache():
    """The legacy group decode on the hybrid's states and KV caches: equal
    tokens to JAX's."""
    jcfg, cfg, jp, tp = _pair("zamba2-2.7b")
    je = JEngine(jcfg, JServeConfig(max_batch=4), jp)
    te = ServingEngine(cfg, ServeConfig(max_batch=4), tp)
    rng = np.random.default_rng(6)
    jc, tc, jf, tf, starts = [], [], [], [], []
    for n in (25, 40):
        toks = _tokens(rng, cfg, 1, n)
        jl, c = je.prefill({"tokens": jnp.asarray(toks)}, max_seq=48)
        jc.append(c)
        jf.append(jnp.argmax(jl[:, -1], -1))
        tl, c = te.prefill({"tokens": toks}, max_seq=48)
        tc.append(c)
        tf.append(torch.argmax(tl[:, -1], dim=-1))
        starts.append(n)
    jt, _ = je.decode_tokens_group(jc, jf, starts, 4)
    tt, _ = te.decode_tokens_group(tc, tf, starts, 4)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert te.cache_stack_count == 1


def test_serve_deadline_matches_jax():
    """The deadline former over rwkv6: two camera groups, a deadline
    flush and a straggler; the same tokens and report as JAX's."""
    jcfg, cfg, jp, tp = _pair("rwkv6-7b")
    je = JEngine(jcfg, JServeConfig(max_batch=4), jp)
    te = ServingEngine(cfg, ServeConfig(max_batch=4), tp)
    rng = np.random.default_rng(8)
    reqs = [dict(rid=i, tokens=_tokens(rng, cfg, 20 + 3 * i),
                 max_new_tokens=3, group=i % 2, arrival_s=t)
            for i, t in enumerate([0.0, 0.1, 0.2, 1.5, 1.6, 1.7])]
    jout, jrep = je.serve_deadline([JRequest(**r) for r in reqs],
                                   {0: 3, 1: 2}, 1.0, greedy_steps=3)
    tout, trep = te.serve_deadline([Request(**r) for r in reqs],
                                   {0: 3, 1: 2}, 1.0, greedy_steps=3)
    assert sorted(tout) == sorted(jout)
    for rid in jout:
        np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))
    assert (trep.complete_flushes, trep.deadline_flushes,
            trep.straggler_requests, trep.release_s) == \
        (jrep.complete_flushes, jrep.deadline_flushes,
         jrep.straggler_requests, jrep.release_s)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_recurrent_archs(capsys, arch):
    """``launch.serve.main --arch`` for both families, RoI-packed, on the
    CPU: one line of tokens a request."""
    out = tserve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                       "--prompt-len", "40", "--new-tokens", "3", "--roi"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert sorted(out) == [0, 1]
    assert all(t.shape == (3,) for t in out.values())
    assert lines[:2] == [f"req {i}: {out[i].tolist()}" for i in range(2)]
    assert lines[2].endswith("(RoI-packed prefill) on cpu")
