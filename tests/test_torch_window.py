"""The port's sliding-window and local/global decoders (h2o-danube3-4b,
gemma3-27b) and the dense configs copied with them (mistral-nemo-12b,
deepseek-67b) against the JAX package, on the CPU.

Every arch at its SMOKE size in float32 (weights and KV caches), with the
JAX package's ``init_params`` carried across through
``params_from_numpy``; inputs drawn from numpy seeds.  Bars: 1e-5 per
layer, 1e-4 on logits and caches, greedy tokens equal.  The JAX side runs
under ``jax.jit``, as its engine does: XLA folds the RoPE frequencies at
compile time, and only those tables match the port's at ``PAD_POS``
(``layers.rope_table``), which the packed-prompt ring (C-R4) attends.
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import init_params as jinit_params
from repro.obs import loadgen as jlg
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import ServeConfig, get_config
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import params_from_numpy
from repro_torch.obs import loadgen as tlg
from repro_torch.serving.engine import Request, ServingEngine
from torch_compare import assert_same

F32 = dict(dtype="float32", kv_cache_dtype="float32")
WINDOWED = ["h2o-danube3-4b", "gemma3-27b"]
DENSE = ["mistral-nemo-12b", "deepseek-67b"]


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX config, port config, JAX params, port params) at SMOKE, f32."""
    jcfg = jget_config(arch, smoke=True).replace(**F32)
    cfg = get_config(arch, smoke=True).replace(**F32)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    return jcfg, cfg, jp, tp


@functools.lru_cache(maxsize=None)
def _jit(arch):
    """The JAX model's prefill, decode and group decode, jitted."""
    jcfg = _pair(arch)[0]
    prefill = jax.jit(lambda p, b, c, pos, last: JM.prefill(
        p, jcfg, b, c, positions=pos, last_index=last))
    decode = jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c, pos))
    group = jax.jit(lambda p, t, c, pos: jax.vmap(
        lambda tb, cb, pb: JM.decode_step(p, jcfg, tb, cb, pb))(t, c, pos))
    return prefill, decode, group


def _np(x):
    return np.asarray(x, np.float32)


def _close_caches(tc, jc, atol=1e-4):
    assert sorted(tc) == sorted(jc)
    for key in jc:
        for j in range(2):
            np.testing.assert_allclose(tc[key][j].numpy(), _np(jc[key][j]),
                                       atol=atol, err_msg=key)


def _tokens(rng, cfg, *shape):
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _packed_positions(rng, B, S, n_pad):
    pos = np.stack([np.sort(rng.choice(2 * S, S, replace=False))
                    for _ in range(B)]).astype(np.int32)
    if n_pad:
        pos[:, -n_pad:] = np.iinfo(np.int32).max
    return pos


@pytest.mark.parametrize("S,window,q_block,softcap,n_pad", [
    (96, 32, 512, 0.0, 0),       # one query block: the span is the rows
    (96, 16, 32, 30.0, 0),       # three blocks of 32, spans of 48
    (75, 8, 512, 0.0, 0),        # q_block halves to 1: every row a block
    (64, 100, 16, 0.0, 0),       # a window past the sequence
    (128, 24, 32, 0.0, 40),      # packed positions with PAD rows
    (100, 16, 64, 0.0, 20),      # q_block halves to 4, PAD rows
])
def test_banded_attention_matches_jax(S, window, q_block, softcap, n_pad):
    """Banded blockwise attention: every row, PAD rows included (their
    keys reach the ring, C-R4), within 1e-5 of JAX's."""
    rng = np.random.default_rng(S + window)
    B, H, D = 2, 4, 16
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    pos = _packed_positions(rng, B, S, n_pad) if n_pad else None
    jpos = None if pos is None else jnp.asarray(pos)
    tpos = None if pos is None else torch.from_numpy(pos)
    want = JL.blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), window=window,
        softcap=softcap, q_block=q_block, q_positions=jpos,
        kv_positions=jpos)
    got = TL.blockwise_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), window=window,
        softcap=softcap, q_block=q_block, q_positions=tpos,
        kv_positions=tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("window", [0, 5, 40])
def test_windowed_decode_attention_matches_jax(window):
    """Both decode attentions with a window, per-row cache lengths."""
    rng = np.random.default_rng(window)
    B, Smax, H, KH, D = 3, 48, 4, 2, 16
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kc, vc = (rng.normal(size=(B, Smax, KH, D)).astype(np.float32)
              for _ in range(2))
    clen = np.array([3, 30, 48])
    want = JL.decode_attention(jnp.asarray(q), JL.repeat_kv(jnp.asarray(kc), 2),
                               JL.repeat_kv(jnp.asarray(vc), 2),
                               jnp.asarray(clen), window=window)
    jgrp = JL.decode_attention_grouped(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(clen),
                                       window=window)
    t = [torch.from_numpy(a) for a in (q, kc, vc, clen)]
    full = TL.decode_attention(t[0], TL.repeat_kv(t[1], 2),
                               TL.repeat_kv(t[2], 2), t[3], window=window)
    grp = TL.decode_attention_grouped(*t, window=window)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(grp.numpy(), np.asarray(jgrp), atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", WINDOWED + DENSE)
def test_prefill_and_decode_match_jax(arch):
    """A dense prompt past the window: the last row's logits, every cache
    (rings, global and trailing layers) and three decode steps' logits
    within 1e-4."""
    jcfg, cfg, jp, tp = _pair(arch)
    jprefill, jdecode, _ = _jit(arch)
    rng = np.random.default_rng(1)
    S = 70
    toks = _tokens(rng, cfg, 1, S + 3)
    jc = JM.init_cache(jcfg, 1, S + 3)
    tc = TM.init_cache(cfg, 1, S + 3, "cpu")
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jc, None,
                      None)
    tl, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(toks[:, :S])},
                        tc)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    _close_caches(tc, jc)
    for i in range(3):
        t = toks[:, S + i:S + i + 1]
        jl, jc = jdecode(jp, jnp.asarray(t), jc, S + i)
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(t), tc, S + i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4)
    _close_caches(tc, jc)


def test_gemma3_pattern_layout():
    """gemma3 SMOKE: one super-block of five local layers and a global
    one, then one trailing local layer; local rings of the window, the
    global cache of max_seq."""
    cfg = _pair("gemma3-27b")[1]
    caches = TM.init_cache(cfg, 2, 50, "cpu")
    assert {k: tuple(v[0].shape) for k, v in caches.items()} == {
        "local": (5, 2, 32, 2, 16), "global": (1, 2, 50, 2, 16),
        "trail": (1, 2, 32, 2, 16)}
    short = TM.init_cache(cfg, 1, 20, "cpu")
    assert short["local"][0].shape[2] == short["trail"][0].shape[2] == 20


@pytest.mark.parametrize("arch", WINDOWED)
def test_ring_group_decode_matches_jax(arch):
    """A (G,) group whose prompts end on both sides of the window (W =
    32): each row writes its own ring slot and sees its own valid set.
    Four teacher-forced steps' logits within 1e-4 of JAX's vmapped
    per-request decode, and the rings after them."""
    jcfg, cfg, jp, tp = _pair(arch)
    jprefill, _, jgroup = _jit(arch)
    lens = [10, 31, 32, 33, 50, 75]
    steps = 4
    max_seq = max(lens) + steps
    rng = np.random.default_rng(2)
    prompts = [_tokens(rng, cfg, 1, n) for n in lens]
    feed = _tokens(rng, cfg, len(lens), steps)
    jcs, tcs = [], []
    for p in prompts:
        _, jc = jprefill(jp, {"tokens": jnp.asarray(p)},
                         JM.init_cache(jcfg, 1, max_seq), None, None)
        _, tc = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(p)},
                           TM.init_cache(cfg, 1, max_seq, "cpu"))
        jcs.append(jc)
        tcs.append(tc)
    jc = jax.tree.map(lambda *xs: jnp.stack(xs), *jcs)
    tc = {key: tuple(torch.cat([c[key][j] for c in tcs], dim=1)
                     for j in range(2)) for key in tcs[0]}
    assert all(v[0].shape[2] == 32 for k, v in tc.items() if k != "global")
    pos = np.array(lens)
    for i in range(steps):
        jl, jc = jgroup(jp, jnp.asarray(feed[:, i, None, None]), jc,
                        jnp.asarray(pos + i))
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(feed[:, i, None]),
                                tc, torch.from_numpy(pos + i))
        np.testing.assert_allclose(tl.numpy(), _np(jl)[:, 0], atol=1e-4)
    for key in jc:
        for j in range(2):
            np.testing.assert_allclose(
                tc[key][j].numpy(), np.swapaxes(_np(jc[key][j])[:, :, 0],
                                                0, 1), atol=1e-4)


def test_ring_valid_slots_are_the_slot_positions_rule():
    """Ring decode attends the slots below a length of pos + 1, without
    a window: the same set as the JAX package's slot positions, pos -
    ((pos - s) mod W) >= 0, at every position, a (G,) vector of them."""
    W = 8
    pos = torch.arange(3 * W)
    slot_pos = pos[:, None] - (pos[:, None] - torch.arange(W)[None]) % W
    got = TL._decode_valid(pos + 1, W, pos.device)
    assert torch.equal(got, slot_pos >= 0)


@pytest.mark.parametrize("arch", WINDOWED)
def test_ring_group_decode_grouped_layout(arch):
    """``decode_grouped_attn`` routes the ring through the grouped decode
    attention too: a (G,) group of mixed prompt lengths on both sides of
    the window gives the repeated layout's logits (f32, 1e-5)."""
    _, cfg, _, tp = _pair(arch)
    lens, steps = [10, 33, 50], 3
    rng = np.random.default_rng(5)
    prompts = [_tokens(rng, cfg, 1, n) for n in lens]
    feed = torch.from_numpy(_tokens(rng, cfg, len(lens), steps))
    outs = []
    for c in (cfg, cfg.replace(decode_grouped_attn=True)):
        tcs = [TM.prefill(tp, c, {"tokens": torch.from_numpy(p)},
                          TM.init_cache(c, 1, max(lens) + steps, "cpu"))[1]
               for p in prompts]
        tc = {key: tuple(torch.cat([t[key][j] for t in tcs], dim=1)
                         for j in range(2)) for key in tcs[0]}
        pos = torch.tensor(lens)
        outs.append([TM.decode_step(tp, c, feed[:, i, None], tc, pos + i)[0]
                     for i in range(steps)])
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch", WINDOWED)
def test_ring_identity(arch):
    """The port against itself, as tests/test_arch_smoke.py's ring test:
    a prompt past the window prefilled into rings, then its last token
    decoded, gives a full prefill's last logits (f32, 1e-4)."""
    _, cfg, _, tp = _pair(arch)
    toks = torch.from_numpy(_tokens(np.random.default_rng(3), cfg, 2, 64))
    S = toks.shape[1]
    assert cfg.window_size < S
    caches = TM.init_cache(cfg, 2, S + 8, "cpu")
    _, caches = TM.prefill(tp, cfg, {"tokens": toks[:, :-1]}, caches)
    dec, _ = TM.decode_step(tp, cfg, toks[:, -1:], caches, S - 1)
    full, _ = TM.prefill(tp, cfg, {"tokens": toks},
                         TM.init_cache(cfg, 2, S + 8, "cpu"))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=1e-4)


@pytest.mark.parametrize("arch", WINDOWED)
def test_packed_prompt_ring_reproduces_c_r4(arch):
    """C-R4, the JAX package's packed-prompt ring: a prompt of 200 kept
    tokens packed to 256 rows leaves its padding rows in the window's
    ring, and ring decode counts them as keys.  The port reproduces it:
    prefill and decode logits within 1e-4 of JAX's.  Both stand apart
    from a dense prefill of the same tokens, which is the fault."""
    jcfg, cfg, jp, tp = _pair(arch)
    jprefill, jdecode, _ = _jit(arch)
    S, steps = 200, 2
    rng = np.random.default_rng(4)
    toks = _tokens(rng, cfg, S + steps)
    keep = np.ones(S, bool)
    jpk, jpos, n = jops.pack_tokens(jnp.asarray(toks[:S]), jnp.asarray(keep),
                                    128)
    tpk, tpos, tn = tops.pack_tokens(torch.from_numpy(toks[:S]),
                                     torch.from_numpy(keep), 128)
    assert int(n) == tn == S and tpk.shape[0] == 256
    max_seq = 256 + steps
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


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------

def _requests(cfg, rng):
    """Four requests, two dense and two RoI-packed, ending on both sides of
    the window."""
    out = []
    for i, n in enumerate([20, 45, 70, 33]):
        keep = rng.random(n) < 0.6 if i % 2 else None
        out.append(dict(rid=i, tokens=_tokens(rng, cfg, n), keep=keep,
                        max_new_tokens=6 - i % 2))
    return out


@pytest.mark.parametrize("arch", WINDOWED + DENSE)
def test_serve_matches_jax(arch):
    """``serve`` twice over the same group: equal greedy tokens, one group
    cache build for the same geometry, no stacking."""
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


def test_decode_tokens_group_stacks_every_cache(monkeypatch):
    """The legacy group decode on gemma3's local, global and trailing
    caches: equal tokens to JAX's."""
    jcfg, cfg, jp, tp = _pair("gemma3-27b")
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


@pytest.mark.parametrize("arch", ["h2o-danube3-4b", "gemma3-27b"])
def test_drive_serve_matches_jax(arch):
    """``obs.loadgen.drive_serve`` runs unchanged on the windowed archs:
    the same panel as the JAX package's, less the host wall."""
    jcfg, cfg, jp, tp = _pair(arch)
    je = JEngine(jcfg, JServeConfig(max_batch=4), jp)
    te = ServingEngine(cfg, ServeConfig(max_batch=4), tp)
    kw = dict(n_requests=6, group_size=3, prompt_len=40, greedy_steps=2)
    t = tlg.drive_serve(te, 8.0, **kw)
    j = jlg.drive_serve(je, 8.0, **kw)
    assert t.pop("serve_wall_s") > 0 and j.pop("serve_wall_s") > 0
    assert_same(t, j)


@pytest.mark.parametrize("roi", [False, True])
def test_launcher_main_on_the_cpu(capsys, roi):
    """``launch.serve.main``: the JAX launcher's flags and default arch
    (h2o-danube3-4b SMOKE), one line of tokens a request."""
    argv = ["--device", "cpu", "--requests", "3", "--prompt-len", "40",
            "--new-tokens", "3"] + (["--roi"] if roi else [])
    out = tserve.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert sorted(out) == [0, 1, 2]
    assert all(t.shape == (3,) for t in out.values())
    assert lines[:3] == [f"req {i}: {out[i].tolist()}" for i in range(3)]
    assert lines[3].startswith("9 tokens in ") and lines[3].endswith(
        f"({'RoI-packed' if roi else 'dense'} prefill) on cpu")
