"""The port's whisper-small encoder-decoder (``encdec``) against the JAX
package, on the CPU.

whisper-small at its SMOKE size (2 + 2 layers, d_model 64, 4 heads of 16,
``max_target_len`` 32), with the JAX package's ``init_params`` carried
across through ``params_from_numpy`` and inputs drawn from numpy seeds.
The JAX side runs under ``jax.jit``, as a served model would.  Bars:
``layernorm`` and ``gelu_mlp`` within 1e-6 and 1e-5 in float32 (XLA and
torch sum in other orders), and in bfloat16 within one bfloat16 step;
``sinusoid_positions`` within two float32 steps of its largest angle
(C-R7); the trunks and ``cross_kv`` within 1e-5 in float32; ``prefill``
and 40 greedy decode steps (past ``max_target_len``, so the position
clamp is held) within 1e-4 with equal tokens; bfloat16 models within
atol = rtol = 5e-2 (the JAX package's bar, tests/test_arch_smoke.py) on
teacher-forced tokens.  Float32 and bfloat16 frames both (jnp's
promotion keeps a float32 frame stream's encoder in float32).
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.params import init_params as jinit_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import ServeConfig, get_config
from repro_torch.models import forward as TF
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "whisper-small"
F32 = dict(dtype="float32", kv_cache_dtype="float32")
B, S_ENC, T = 2, 24, 5
DECODE_STEPS = 40           # positions 5..44, past max_target_len = 32
FRAMES = ["float32", "bfloat16"]


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    """(JAX config, port config, JAX params, port params) at SMOKE."""
    jcfg, cfg = jget_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    if dtype == "float32":
        jcfg, cfg = jcfg.replace(**F32), cfg.replace(**F32)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    return jcfg, cfg, jp, tp


@functools.lru_cache(maxsize=None)
def _jit(dtype="float32"):
    """The JAX model's trunks, prefill, decode and vmapped group decode,
    jitted."""
    jcfg = _pair(dtype)[0]
    return dict(
        encoder=jax.jit(lambda p, f: JF.encoder_trunk(p, jcfg, f)),
        cross_kv=jax.jit(lambda p, m: JF.cross_kv(p, jcfg, m)),
        decoder=jax.jit(lambda p, t, m: JF.decoder_trunk(
            p, jcfg, t, m, mode="train")[0]),
        decoder_cached=jax.jit(lambda p, t, c: JF.decoder_trunk(
            p, jcfg, t, None, mode="prefill", caches=c)),
        prefill=jax.jit(lambda p, b, c: JM.prefill(p, jcfg, b, c)),
        decode=jax.jit(lambda p, t, c, pos: JM.decode_step(p, jcfg, t, c,
                                                            pos)),
        group=jax.jit(lambda p, t, c, pos: jax.vmap(
            lambda tb, cb, pb: JM.decode_step(p, jcfg, tb, cb, pb))(
                t, c, pos)))


def _np(x):
    return np.asarray(x, np.float32)


def _frames(seed, frames_dtype, n=B, s=S_ENC):
    """(JAX frames, port frames) of one numpy draw, in ``frames_dtype``."""
    f = np.random.default_rng(seed).normal(size=(n, s, 64)).astype(
        np.float32)
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    if frames_dtype == "bfloat16":
        jf, tf = jf.astype(jnp.bfloat16), tf.to(torch.bfloat16)
    return jf, tf


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _close_caches(tc, jc, atol=1e-4):
    for key in ("self", "cross"):
        for j in range(2):
            assert tc[key][j].dtype == getattr(torch, str(jc[key][j].dtype))
            np.testing.assert_allclose(tc[key][j].float().numpy(),
                                       _np(jc[key][j]), atol=atol,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """Float32 within 1e-6; bfloat16 (computed in float32, cast back)
    within one bfloat16 step of the value."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 7, 64)) * 3 + 1).astype(np.float32)
    w, b = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = JL.layernorm(jx, jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = TL.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == tx.dtype
    tol = dict(atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -8,
                                                           atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_gelu_mlp_matches_jax(x_dtype, w_dtype):
    """The biased tanh-GELU MLP in jnp's promoted dtype: float32 within
    1e-5 (float32 activations against bfloat16 weights included: the
    product stays float32), bfloat16 within 5e-2."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) / np.sqrt(s[0])
          for s in ((64, 128), (128,), (128, 64), (64,))]
    jd, td = getattr(jnp, x_dtype), getattr(torch, x_dtype)
    jw, tw = getattr(jnp, w_dtype), getattr(torch, w_dtype)
    want = JL.gelu_mlp(jnp.asarray(x).astype(jd),
                       *(jnp.asarray(w).astype(jw) for w in ws))
    got = TL.gelu_mlp(torch.from_numpy(x).to(td),
                      *(torch.from_numpy(w).to(tw) for w in ws))
    assert str(got.dtype)[6:] == str(want.dtype)
    tol = 1e-5 if x_dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol,
                               rtol=tol if x_dtype != "float32" else 0)


@pytest.mark.parametrize("S,D", [(24, 64), (40, 64), (448, 768),
                                 (1500, 768)])
def test_sinusoid_positions_match_jax(S, D):
    """The table against JAX's eager and compiled tables, within two
    float32 steps of the largest angle (S - 1 times the first inverse
    timescale, 1): the inverse timescales come from float32 ``exp``s that
    round differently (C-R7), and a step of one moves an angle by up to
    S - 1 steps of it."""
    got = TL.sinusoid_positions(S, D).numpy()
    assert got.shape == (S, D) and got.dtype == np.float32
    bar = 2 * float(np.spacing(np.float32(S - 1)))
    for want in (JL.sinusoid_positions(S, D),
                 jax.jit(lambda: JL.sinusoid_positions(S, D))()):
        np.testing.assert_allclose(got, _np(want), atol=bar, rtol=0)


def test_sinusoid_table_depends_on_xla_folding_c_r7():
    """C-R7, reproduced: the JAX table is not one function of (S, D).  At
    SMOKE widths XLA folds the compiled table at compile time, off the
    eager one; at whisper-small's 1,500 x 768 both take XLA's float32
    ``exp``, which is a float32 step off a correctly rounded exp in some
    inverse timescales, so the angles at position 1,499 move by up to
    1.2e-4.  The port's table is torch's float32 (within the bar of
    ``test_sinusoid_positions_match_jax``)."""
    small = [_np(JL.sinusoid_positions(24, 64)),
             _np(jax.jit(lambda: JL.sinusoid_positions(24, 64))())]
    assert not np.array_equal(*small)
    full = [_np(JL.sinusoid_positions(1500, 768)),
            _np(jax.jit(lambda: JL.sinusoid_positions(1500, 768))())]
    assert np.array_equal(*full)
    lt = np.float32(np.log(np.float32(10_000.0))) / np.float32(383)
    arg = -lt * np.arange(384, dtype=np.float32)
    rounded = np.exp(arg.astype(np.float64)).astype(np.float32)
    xla = _np(jnp.exp(jnp.asarray(arg)))
    assert (xla != rounded).sum() > 0
    assert np.abs(full[0] - TL.sinusoid_positions(1500, 768).numpy()).max() \
        > 1e-5


# ---------------------------------------------------------------------------
# the trunks and the cross K/V (float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames_dtype", FRAMES)
def test_encoder_trunk_matches_jax(frames_dtype):
    """The memory within 1e-5, in JAX's dtype (a float32 model promotes
    bfloat16 frames)."""
    _, cfg, jp, tp = _pair()
    jf, tf = _frames(3, frames_dtype)
    want = _jit()["encoder"](jp, jf)
    got = TF.encoder_trunk(tp, cfg, tf)
    assert str(got.dtype)[6:] == str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_promotes_float32_frames(dtype):
    """jnp's promotion: float32 frames keep a bfloat16 model's encoder,
    memory and cross K/V in float32; bfloat16 frames keep them in
    bfloat16.  The port's dtypes equal JAX's and its values hold the
    model's bar."""
    jcfg, cfg, jp, tp = _pair(dtype)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for frames_dtype in FRAMES:
        jf, tf = _frames(4, frames_dtype)
        jm = _jit(dtype)["encoder"](jp, jf)
        tm = TF.encoder_trunk(tp, cfg, tf)
        jk, jv = _jit(dtype)["cross_kv"](jp, jm)
        tk, tv = TF.cross_kv(tp, cfg, tm)
        for got, want in ((tm, jm), (tk, jk), (tv, jv)):
            assert str(got.dtype)[6:] == str(want.dtype)
            np.testing.assert_allclose(got.float().numpy(), _np(want),
                                       atol=tol, rtol=tol if tol > 1e-5
                                       else 0)


def test_cross_kv_matches_jax():
    """Each decoder layer's cross K and V of one memory within 1e-5:
    (L, B, S_enc, KH, Dh)."""
    jcfg, cfg, jp, tp = _pair()
    m = np.random.default_rng(5).normal(size=(B, S_ENC, 64)).astype(
        np.float32)
    jk, jv = _jit()["cross_kv"](jp, jnp.asarray(m))
    tk, tv = TF.cross_kv(tp, cfg, torch.from_numpy(m))
    assert tuple(tk.shape) == (cfg.decoder_layers, B, S_ENC,
                               cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=1e-5)


@pytest.mark.parametrize("n_tok", [1, 7, 32])
def test_decoder_trunk_without_caches_matches_jax(n_tok):
    """The no-cache branch (cross-attention projecting k and v of the
    memory in every layer) within 1e-5 of JAX's ``mode="train"`` branch,
    up to ``max_target_len`` tokens."""
    _, cfg, jp, tp = _pair()
    m = np.random.default_rng(6).normal(size=(B, S_ENC, 64)).astype(
        np.float32)
    toks = _tokens(7, B, n_tok)
    want = _jit()["decoder"](jp, jnp.asarray(toks), jnp.asarray(m))
    got, caches = TF.decoder_trunk(tp, cfg, torch.from_numpy(toks),
                                   torch.from_numpy(m))
    assert caches is None
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_decoder_trunk_with_caches_matches_jax():
    """The cached branch in prefill: x within 1e-5 and the self caches
    written in place (rows [0, T)) within 1e-5 of JAX's; the cross caches
    read, not written; and its rows equal the no-cache branch's over the
    same tokens (the cross K/V from ``cross_kv`` of the same memory)."""
    jcfg, cfg, jp, tp = _pair()
    m = np.random.default_rng(8).normal(size=(B, S_ENC, 64)).astype(
        np.float32)
    toks = _tokens(9, B, 11)
    jc = JM.init_cache(jcfg, B, S_ENC)
    jc["cross"] = _jit()["cross_kv"](jp, jnp.asarray(m))
    jx, jc = _jit()["decoder_cached"](jp, jnp.asarray(toks), jc)
    tc = TM.init_cache(cfg, B, S_ENC, "cpu")
    tc["cross"] = TF.cross_kv(tp, cfg, torch.from_numpy(m))
    cross = tuple(t.clone() for t in tc["cross"])
    self_k = tc["self"][0]
    tx, out = TF.decoder_trunk(tp, cfg, torch.from_numpy(toks), None,
                               mode="prefill", caches=tc)
    assert out is tc and out["self"][0] is self_k
    assert all(torch.equal(a, b) for a, b in zip(cross, tc["cross"]))
    np.testing.assert_allclose(tx.numpy(), _np(jx), atol=1e-5)
    _close_caches(tc, jc, atol=1e-5)
    plain, _ = TF.decoder_trunk(tp, cfg, torch.from_numpy(toks),
                                torch.from_numpy(m))
    np.testing.assert_allclose(tx.numpy(), plain.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the model: prefill and decode
# ---------------------------------------------------------------------------

def test_init_cache_mirrors_jax():
    """{"self": (L, B, max_target_len, KH, Dh) in ``kv_cache_dtype``,
    "cross": bfloat16 (L, B, max_seq, KH, Dh)} on the device asked for;
    without one it needs the card."""
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg, _, _ = _pair(dtype)
        jc, tc = JM.init_cache(jcfg, 3, 20), TM.init_cache(cfg, 3, 20, "cpu")
        assert sorted(tc) == sorted(jc) == ["cross", "self"]
        for key in jc:
            for j in range(2):
                assert tuple(tc[key][j].shape) == jc[key][j].shape
                assert str(tc[key][j].dtype)[6:] == str(jc[key][j].dtype)
                assert tc[key][j].device.type == "cpu"
                assert not tc[key][j].any()


def test_init_cache_resolves_its_device(monkeypatch):
    cfg = _pair()[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(cfg, 1, 8)


def _run(dtype, frames_dtype, force=None, seed=10):
    """Prefill of T tokens over S_ENC frames, then DECODE_STEPS decode
    steps -- greedy on each side, or fed ``force`` (B, DECODE_STEPS) on
    both.  Returns the JAX and port logits per step, tokens per step and
    final caches."""
    jcfg, cfg, jp, tp = _pair(dtype)
    fns = _jit(dtype)
    jf, tf = _frames(seed, frames_dtype)
    toks = _tokens(seed + 1, B, T)
    jl, jc = fns["prefill"](jp, {"frames": jf, "tokens": jnp.asarray(toks)},
                            JM.init_cache(jcfg, B, S_ENC))
    tl, tc = TM.prefill(tp, cfg, {"frames": tf,
                                  "tokens": torch.from_numpy(toks)},
                        TM.init_cache(cfg, B, S_ENC, "cpu"))
    out = {"j": [jl], "t": [tl], "jtok": [], "ttok": []}
    for i in range(DECODE_STEPS):
        if force is None:
            jt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
            tt = tl[:, -1].argmax(-1).numpy().astype(np.int32)
        else:
            jt = tt = force[:, i]
        out["jtok"].append(jt)
        out["ttok"].append(tt)
        jl, jc = fns["decode"](jp, jnp.asarray(jt[:, None]), jc, T + i)
        tl, tc = TM.decode_step(tp, cfg, torch.from_numpy(tt[:, None]).long(),
                                tc, T + i)
        out["j"].append(jl)
        out["t"].append(tl)
    out["jc"], out["tc"] = jc, tc
    return out


@pytest.mark.parametrize("frames_dtype", FRAMES)
def test_prefill_and_decode_match_jax(frames_dtype):
    """Float32: prefill's last logits, then 40 greedy decode steps
    (positions 5..44, past ``max_target_len`` = 32: the decoder's
    position row and the self cache's last slot clamp, as
    ``dynamic_slice`` and ``dynamic_update_slice`` do) within 1e-4 with
    equal tokens; the caches within 1e-4 and in JAX's dtypes."""
    out = _run("float32", frames_dtype)
    for got, want in zip(out["t"], out["j"]):
        assert tuple(got.shape) == want.shape == (B, 1, 256)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
    for a, b in zip(out["ttok"], out["jtok"]):
        np.testing.assert_array_equal(a, b)
    _close_caches(out["tc"], out["jc"])


@pytest.mark.parametrize("frames_dtype", FRAMES)
def test_bf16_model_matches_jax(frames_dtype):
    """The bfloat16 model on teacher-forced tokens (a bfloat16 near-tie
    may flip a greedy token on one side): every step's logits within
    atol = rtol = 5e-2, the caches in JAX's dtypes (float32 frames give
    float32 cross K/V)."""
    force = _tokens(12, B, DECODE_STEPS)
    out = _run("bfloat16", frames_dtype, force=force)
    for got, want in zip(out["t"], out["j"]):
        assert str(got.dtype)[6:] == str(want.dtype) == "bfloat16"
        np.testing.assert_allclose(got.float().numpy(), _np(want),
                                   atol=5e-2, rtol=5e-2)
    _close_caches(out["tc"], out["jc"], atol=5e-2)
    want = torch.float32 if frames_dtype == "float32" else torch.bfloat16
    assert out["tc"]["cross"][0].dtype == want


def test_vector_pos_equals_scalar_and_clamps_per_row():
    """A (B,) ``pos`` of one value equals the scalar path bitwise; a (B,)
    ``pos`` of different values, one past ``max_target_len``, equals the
    JAX decode vmapped over the rows (its per-request scalars) within
    1e-4, each row's position row and cache slot clamped on its own."""
    jcfg, cfg, jp, tp = _pair()
    _, tf = _frames(13, "float32")
    toks = torch.from_numpy(_tokens(14, B, T))
    logits, caches = TM.prefill(tp, cfg, {"frames": tf, "tokens": toks},
                                TM.init_cache(cfg, B, S_ENC, "cpu"))
    nxt = logits[:, -1].argmax(-1)[:, None]
    c2 = {k: tuple(t.clone() for t in v) for k, v in caches.items()}
    a, ca = TM.decode_step(tp, cfg, nxt, caches, T)
    b, cb = TM.decode_step(tp, cfg, nxt, c2, torch.full((B,), T))
    assert torch.equal(a, b)
    for key in ("self", "cross"):
        for j in range(2):
            assert torch.equal(ca[key][j], cb[key][j])
    # per-row positions, against JAX's per-request decode vmapped over the
    # rows (caches stacked per request, batch 1 each)
    pos = np.array([T + 1, cfg.max_target_len + 3], np.int32)
    jt = _tokens(15, B, 1)
    jc = jax.tree.map(lambda x: jnp.asarray(
        np.swapaxes(np.asarray(x.float()), 0, 1)[:, :, None]), ca)
    jc = {k: tuple(v) for k, v in jc.items()}
    jl, _ = _jit()["group"](jp, jnp.asarray(jt[:, None]), jc,
                            jnp.asarray(pos))
    tl, _ = TM.decode_step(tp, cfg, torch.from_numpy(jt).long(), ca,
                           torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), _np(jl)[:, 0], atol=1e-4)


def test_decoder_positions_clamp_as_dynamic_slice():
    """``_dec_positions``: rows [pos, pos + T), the start clamped to [0,
    max_target_len - T] per sequence, as ``dynamic_slice_in_dim`` clamps
    it."""
    _, cfg, jp, tp = _pair()
    Tmax = cfg.max_target_len
    for T_, pos in ((1, 0), (1, Tmax - 1), (1, Tmax + 9), (4, Tmax - 2),
                    (Tmax, 0), (3, 5)):
        want = jax.lax.dynamic_slice_in_dim(jp["dec_pos"], pos, T_, 0)
        got = TF._dec_positions(tp, T_, pos, "cpu")
        assert tuple(got.shape) == (1, T_, cfg.d_model)
        np.testing.assert_array_equal(got[0].numpy(), _np(want))
    got = TF._dec_positions(tp, 2, torch.tensor([3, Tmax + 5]), "cpu")
    np.testing.assert_array_equal(got[1].numpy(), tp["dec_pos"][-2:].numpy())
    np.testing.assert_array_equal(got[0].numpy(), tp["dec_pos"][3:5].numpy())


# ---------------------------------------------------------------------------
# the serving engine (C-R8)
# ---------------------------------------------------------------------------

def test_engine_cannot_serve_whisper_c_r8():
    """C-R8, reproduced: ``serve`` feeds a request's tokens alone, and the
    encdec prefill needs ``batch["frames"]``: ``KeyError: 'frames'`` in
    both engines.  ``ServingEngine.prefill`` given frames works in both,
    logits within 1e-4 (float32)."""
    jcfg, cfg, jp, tp = _pair()
    toks = _tokens(16, 6)
    engines = (JEngine(jcfg, JServeConfig(max_batch=2, max_seq=64), jp),
               ServingEngine(cfg, ServeConfig(max_batch=2, max_seq=64), tp))
    for eng, req in zip(engines, (JRequest, Request)):
        with pytest.raises(KeyError, match="frames"):
            eng.serve([req(0, tokens=toks, max_new_tokens=2)],
                      greedy_steps=2)
    f = np.random.default_rng(17).normal(size=(1, S_ENC, 64)).astype(
        np.float32)
    want, _ = engines[0].prefill({"frames": jnp.asarray(f),
                                  "tokens": jnp.asarray(toks[None])},
                                 max_seq=S_ENC)
    got, _ = engines[1].prefill({"frames": f, "tokens": toks[None]},
                                max_seq=S_ENC)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4)
