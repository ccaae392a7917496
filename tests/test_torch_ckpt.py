"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the JAX
package's five cases (round trip, torn step ignored, gc and latest, async
save, shape mismatch), and checkpoints of a SMOKE ``TrainState`` saved
by one package and loaded by the other, bitwise on every leaf (bf16 and
the int32 step included), with the same file names and an equal parsed
``MANIFEST.json``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import load_checkpoint as jload
from repro.checkpoint.ckpt import save_checkpoint as jsave
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget_config
from repro.train.loop import init_state as jinit_state
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import TrainConfig, get_config
from repro_torch.optim.adamw import AdamWState, adamw_state_from_numpy
from repro_torch.models.params import params_from_numpy
from repro_torch.train.loop import TrainState, init_state, state_template


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones((4,), dtype=torch.bfloat16)},
            "meta": {"step_count": torch.tensor(7, dtype=torch.int32)}}


def _template(trees):
    return {g: {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in t.items()} for g, t in trees.items()}


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    trees = _tree()
    save_checkpoint(d, 3, trees)
    step, out = load_checkpoint(d, _template(trees), device="cpu")
    assert step == 3
    for g in trees:
        for k in trees[g]:
            assert _equal(out[g][k], trees[g][k]), (g, k)


def test_torn_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    trees = _tree()
    save_checkpoint(d, 1, trees)
    save_checkpoint(d, 2, trees)
    os.remove(os.path.join(d, "step_000002", "COMMIT"))  # a crash mid-save
    step, _ = load_checkpoint(d, _template(trees), device="cpu")
    assert step == 1


def test_manager_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(str(tmp_path))) == ["step_000003",
                                                 "step_000004"]
    assert len(mgr.write_s) == 4


def test_async_save_then_restore(tmp_path):
    """The save snapshots before it returns: the tensors are changed in
    place afterwards (as AdamW does) and the checkpoint keeps the old
    values; the restored tensors are fresh."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    trees = _tree()
    want = trees["params"]["w"].clone()
    mgr.save(5, trees)
    trees["params"]["w"].add_(1.0)
    mgr.wait()
    step, out = mgr.restore(_template(trees), device="cpu")
    assert step == 5
    assert _equal(out["params"]["w"], want)
    out["params"]["w"].add_(1.0)
    again = load_checkpoint(str(tmp_path), _template(trees), device="cpu")
    assert _equal(again[1]["params"]["w"], want)


def test_restore_resolves_its_device(tmp_path, monkeypatch):
    """Without a device both loaders restore onto the card: with none
    they raise ``resolve_device``'s error instead of landing on the
    CPU."""
    d = str(tmp_path)
    trees = _tree()
    save_checkpoint(d, 1, trees)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint(d, _template(trees))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointManager(d).restore(_template(trees))


def test_shape_mismatch_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros((2, 2))
    with pytest.raises(AssertionError):
        load_checkpoint(d, _template(bad), device="cpu")


# ---------------------------------------------------------------------------
# across the packages: a SMOKE TrainState, bf16 weights, f32 moments
# ---------------------------------------------------------------------------

ARCH = "h2o-danube3-4b"


def _jax_state():
    """A JAX TrainState at SMOKE (bf16 weights) with moved moments and
    step 3, so that no leaf is trivially zero."""
    cfg = jget_config(ARCH, smoke=True)
    st = jinit_state(cfg, JTrainConfig(), jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def noise(x):
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32))

    opt = st.opt._replace(step=jnp.asarray(3, jnp.int32),
                          m=jax.tree.map(noise, st.opt.m),
                          v=jax.tree.map(lambda x: noise(x) ** 2,
                                         st.opt.v))
    return st._replace(opt=opt)


def _files(d, step):
    return sorted(os.listdir(os.path.join(d, f"step_{step:06d}", "arrays")))


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:06d}", "MANIFEST.json")) as f:
        return json.load(f)


def _port_of(jst):
    """The same state as port tensors on the CPU."""
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in jst.params.items()}, "cpu")
    opt = adamw_state_from_numpy(
        (np.asarray(jst.opt.step),
         {k: np.asarray(v) for k, v in jst.opt.m.items()},
         {k: np.asarray(v) for k, v in jst.opt.v.items()}), "cpu")
    return TrainState(params, opt)


def _same_leaf(t, j):
    j = np.asarray(j)
    if t.dtype == torch.bfloat16:
        return j.dtype.name == "bfloat16" and np.array_equal(
            t.view(torch.int16).numpy(), j.view(np.int16))
    return t.numpy().dtype == j.dtype and np.array_equal(t.numpy(), j)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jst = _jax_state()
    jsave(jd, 4, {"state": jst._asdict()})
    step, trees = load_checkpoint(jd, state_template(get_config(
        ARCH, smoke=True)), device="cpu")
    assert step == 4
    st = TrainState(trees["state"]["params"], trees["state"]["opt"])
    assert isinstance(st.opt, AdamWState)
    assert st.params["embed"].dtype == torch.bfloat16
    assert st.opt.step.dtype == torch.int32 and int(st.opt.step) == 3
    for k in jst.params:
        assert _same_leaf(st.params[k], jst.params[k]), k
        assert _same_leaf(st.opt.m[k], jst.opt.m[k]), k
        assert _same_leaf(st.opt.v[k], jst.opt.v[k]), k
    # the port writes the same files and manifest
    save_checkpoint(td, 4, {"state": _port_of(jst)._asdict()})
    assert _files(td, 4) == _files(jd, 4)
    assert "state__opt__.m__blocks_w1.npy" in _files(td, 4)
    assert _manifest(td, 4) == _manifest(jd, 4)


def test_port_checkpoint_loads_in_jax(tmp_path):
    d = str(tmp_path)
    jst = _jax_state()
    save_checkpoint(d, 2, {"state": _port_of(jst)._asdict()})
    template = {"state": jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jst._asdict())}
    step, out = jload(d, template)
    assert step == 2
    got = out["state"]
    assert got["opt"].step.dtype == jnp.int32 and int(got["opt"].step) == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jst._asdict())):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))


def test_port_state_roundtrip_is_fresh(tmp_path):
    """A port TrainState (init_state on the CPU) saved through the
    manager and restored: every leaf bitwise, in fresh tensors."""
    cfg = get_config(ARCH, smoke=True)
    st = init_state(cfg, TrainConfig(seed=3), device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"state": st._asdict()})
    step, trees = mgr.restore(state_template(cfg), device="cpu")
    assert step == 1 and len(mgr.write_s) == 1
    got = TrainState(trees["state"]["params"], trees["state"]["opt"])
    for k in st.params:
        for a, b in ((got.params[k], st.params[k]),
                     (got.opt.m[k], st.opt.m[k]), (got.opt.v[k],
                                                   st.opt.v[k])):
            assert _equal(a, b), k
            assert a.untyped_storage().data_ptr() != \
                b.untyped_storage().data_ptr()
    assert _equal(got.opt.step, st.opt.step)
