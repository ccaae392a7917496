"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX package's,
on the CPU: the schedule, the clipping, the decay mask, three update
steps on carried parameters, gradients and state (float32 leaves within
1e-6 of their largest |value|, bfloat16 leaves within one bfloat16
step), and the four cases of
``tests/test_optim.py`` on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.optim import adamw as JA
from repro_torch.configs import TrainConfig
from repro_torch.optim import adamw as TA

# (name, shape, dtype): 2-D leaves decay, 1-D ones do not
LEAVES = [("w", (12, 9), "float32"), ("b", (9,), "float32"),
          ("emb", (16, 8), "bfloat16"), ("norm", (8,), "bfloat16"),
          ("stack", (3, 5, 7), "bfloat16")]


def _tree(rng, scale=1.0):
    return {n: (rng.normal(size=s) * scale).astype(np.float32)
            for n, s, _ in LEAVES}


def _jax(tree):
    return {n: jnp.asarray(tree[n], getattr(jnp, dt)) for n, _, dt in LEAVES}


def _port(tree):
    return {n: torch.from_numpy(tree[n]).to(getattr(torch, dt))
            for n, _, dt in LEAVES}


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _assert_leaf(got, want, name):
    g, w = _np(got), _np(want)
    if got.dtype == torch.bfloat16:
        # one bfloat16 step at |want|: 2^(exponent - 7)
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(g - w) <= step).all(), name
    else:
        # relative to the leaf's largest |value|: an element near 0 is a
        # cancellation (p - lr * delta, b1 * m + (1 - b1) * g), where XLA
        # may contract into an FMA and the last bit moves
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("step", [0, 1, 7, 10, 55, 100, 250])
def test_cosine_schedule_matches_jax(step):
    """Steps 0, 1, inside the warmup, its end, mid-decay, the end and
    past it."""
    kw = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    want = float(JA.cosine_schedule(JTrainConfig(**kw),
                                    jnp.asarray(step, jnp.int32)))
    got = TA.cosine_schedule(TrainConfig(**kw),
                             torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-12)


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm_matches_jax(scale):
    """Below the norm (untouched) and above it (scaled to 1), bfloat16
    leaves cast back to bfloat16."""
    g = _tree(np.random.default_rng(1), scale)
    want, wn = JA.clip_by_global_norm(_jax(g))
    got, gn = TA.clip_by_global_norm(_port(g))
    assert abs(float(gn) - float(wn)) <= 1e-6 * float(wn)
    assert (float(gn) > 1) == (scale > 1)
    for n, _, _ in LEAVES:
        assert got[n].dtype == _port(g)[n].dtype
        _assert_leaf(got[n], want[n], n)


def test_decay_mask_matches_jax():
    p = _tree(np.random.default_rng(2))
    assert TA._decay_mask(_port(p)) == JA._decay_mask(_jax(p))


def test_three_updates_match_jax(monkeypatch):
    """Three steps from a carried JAX state at step 4 (warmup 5, so the
    schedule turns on the way), each on its own gradients, with
    transposed and sliced leaves: parameters and moments against JAX's;
    the update is in place and returns the tensors it was given."""
    monkeypatch.setattr(TA, "_SLICE", 7)      # several slices a leaf
    rng = np.random.default_rng(3)
    tcfg = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=5,
                total_steps=20)
    jp = _jax(_tree(rng))
    js = JA.adamw_init(jp)
    js = js._replace(step=jnp.asarray(4, jnp.int32),
                     m=jax.tree.map(lambda a: a + 0.01, js.m),
                     v=jax.tree.map(lambda a: a + 1e-4, js.v))
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        getattr(torch, str(v.dtype))) for k, v in jp.items()}
    ts = TA.adamw_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert int(ts.step) == 4 and ts.step.dtype == torch.int32
    for i in range(3):
        g = _tree(rng, scale=0.3 if i else 3.0)
        tg = _port(g)
        tg["w"] = tg["w"].T.contiguous().T            # a transposed layout
        jp, js, jm = JA.adamw_update(jp, _jax(g), js, JTrainConfig(**tcfg))
        ids = {k: id(v) for k, v in tp.items()}
        tp, ts, tm = TA.adamw_update(tp, tg, ts, TrainConfig(**tcfg))
        assert {k: id(v) for k, v in tp.items()} == ids
        assert int(ts.step) == int(js.step) == 5 + i
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * float(
            jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
        for n, _, _ in LEAVES:
            _assert_leaf(tp[n], jp[n], n)
            _assert_leaf(ts.m[n], js.m[n], "m " + n)
            _assert_leaf(ts.v[n], js.v[n], "v " + n)


def test_slicing_changes_no_bit(monkeypatch):
    """Slices of 7 elements and whole leaves give the same bits."""
    rng = np.random.default_rng(4)
    p0, g = _tree(rng), _port(_tree(rng))
    out = []
    for size in (7, 1 << 26):
        monkeypatch.setattr(TA, "_SLICE", size)
        p = _port(p0)
        st = TA.adamw_init(p, device="cpu")
        TA.adamw_update(p, g, st, TrainConfig(warmup_steps=0))
        out.append((p, st))
    for n, _, _ in LEAVES:
        for a, b in ((out[0][0][n], out[1][0][n]),
                     (out[0][1].m[n], out[1][1].m[n]),
                     (out[0][1].v[n], out[1][1].v[n])):
            assert torch.equal(a, b), n


def test_init_and_abstract_state():
    p = _port(_tree(np.random.default_rng(5)))
    st = TA.adamw_init(p, device="cpu")
    ab = TA.adamw_abstract(p)
    assert st.step.dtype == ab.step.dtype == torch.int32
    assert ab.step.device.type == "meta"
    for n in p:
        for t in (st.m[n], st.v[n], ab.m[n], ab.v[n]):
            assert t.shape == p[n].shape and t.dtype == torch.float32
        assert not st.m[n].any() and not st.v[n].any()
    assert st.m["w"] is not st.v["w"]


# ---------------------------------------------------------------------------
# tests/test_optim.py on the port
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    tcfg = TrainConfig(learning_rate=0.1, weight_decay=0.0,
                       warmup_steps=5, total_steps=200)
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 4))
                              .astype(np.float32))
    params = {"w": torch.zeros((4, 4), requires_grad=True)}
    state = TA.adamw_init(params, device="cpu")

    def loss_fn(p):
        return torch.sum((p["w"] - target) ** 2)

    for _ in range(150):
        grads = dict(zip(params, torch.autograd.grad(loss_fn(params),
                                                     list(params.values()))))
        params, state, _ = TA.adamw_update(params, grads, state, tcfg)
    assert float(loss_fn(params).detach()) < 1e-2


def test_schedule_warmup_and_decay():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(TA.cosine_schedule(tcfg, torch.tensor(s)))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] < lrs[2]
    assert abs(lrs[2] - 1e-3) < 1e-9          # peak at end of warmup
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 1e-4) < 1e-9          # floor = 0.1 * peak


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0), "b": torch.full((10,), 10.0)}
    clipped, gn = TA.clip_by_global_norm(g, max_norm=1.0)
    assert abs(float(gn) - np.sqrt(2000.0)) < 1e-3
    total = sum(float(torch.sum(x ** 2)) for x in clipped.values())
    assert abs(total - 1.0) < 1e-4


def test_weight_decay_mask_skips_1d():
    tcfg = TrainConfig(learning_rate=0.0, weight_decay=1.0)
    # lr=0: params must not move regardless of decay
    params = {"w": torch.ones((3, 3)), "norm": torch.ones((3,))}
    state = TA.adamw_init(params, device="cpu")
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    new_p, _, _ = TA.adamw_update(params, grads, state, tcfg)
    assert torch.allclose(new_p["w"], torch.ones((3, 3)))
    assert torch.allclose(new_p["norm"], torch.ones((3,)))
