"""The port's distribution pieces on the CPU: the sharding rules against the
JAX package's, the int8 compression bitwise against jnp, the training
route on one gloo rank (bitwise equal to ``mesh=None``), and a (1, 2)
mesh of two gloo ranks (tp and dp_only each one step, against the
single process); the two-rank data-axis route is in
``test_torch_ranks.py``, the model-axis route in ``test_torch_tp_*.py``.

Spec rules: all ten archs at FULL under tp, fsdp, fsdp_pod and dp_only,
with no mesh and with stand-in meshes (2, 4), (4, 1) and (2, 2, 4) (the
JAX functions read only ``mesh.shape``), entry by entry.  The two-rank
int8 all-reduce runs through ``tests/torch_dist_worker.py`` in a
subprocess with a timeout (a hung rank fails the test).
"""
import datetime
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.distributed import compression as JC
from repro.distributed import shardings as JS
from repro.models import model as JM
from repro.models.params import param_specs as jparam_specs
from repro_torch.configs import SHAPES, TrainConfig, get_config
from repro_torch.data.lm import SyntheticLM
from repro_torch.distributed import compression as TC
from repro_torch.distributed import shardings as TS
from repro_torch.distributed.fault import ElasticMesh
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.models import model as TM
from repro_torch.models.dist import DistContext
from repro_torch.models.params import param_specs
from repro_torch.train.loop import init_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
MESHES = {"none": None, "2x4": {"data": 2, "model": 4},
          "4x1": {"data": 4, "model": 1},
          "2x2x4": {"pod": 2, "data": 2, "model": 4}}
MODES = ["tp", "fsdp", "fsdp_pod", "dp_only"]


def _mesh(name):
    shape = MESHES[name]
    return None if shape is None else SimpleNamespace(shape=shape)


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, JP))


def _leaves(tree):
    """The port's specs in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, TS.P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def _same_specs(got, want):
    """Port specs (a tree) and JAX specs, leaf by leaf in JAX's order."""
    got = _leaves(got)
    want = _jleaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, TS.P) and tuple(g) == tuple(w), (g, w)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch, mode):
    """param_pspecs (single- and multi-pod), batch_pspecs_for on the
    train_4k cell's inputs and cache_pspecs on a 4 x 1,024 serving
    cache, on every mesh, entry by entry."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs, jspecs = param_specs(cfg), jparam_specs(jcfg)
    cache = jax.eval_shape(lambda: JM.init_cache(jcfg, 4, 1024))
    tcache = jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta"), cache)
    for name in MESHES:
        mesh = _mesh(name)
        multi_pod = name == "2x2x4"
        for mp in (False, True):
            got = TS.param_pspecs(cfg, specs, mode, mp, mesh=mesh)
            want = JS.param_pspecs(jcfg, jspecs, mode, mp, mesh=mesh)
            assert list(got) == list(want)
            _same_specs(got, want)
        if mesh is None:
            continue
        _same_specs(
            TS.batch_pspecs_for(TM.input_specs(cfg, SHAPES["train_4k"]),
                                mesh, multi_pod),
            JS.batch_pspecs_for(JM.input_specs(jcfg, JSHAPES["train_4k"]),
                                mesh, multi_pod))
        _same_specs(TS.cache_pspecs(tcache, mesh, multi_pod),
                    JS.cache_pspecs(cache, mesh, multi_pod))
    assert tuple(TS.batch_pspec(True)) == tuple(JS.batch_pspec(True))


# the JAX package's four spec units (tests/test_distributed.py)

def test_param_pspecs_tp_roles():
    cfg = get_config("deepseek-67b")
    ps = TS.param_pspecs(cfg, param_specs(cfg), "tp")
    assert ps["blocks_wq"] == TS.P(None, None, "model")
    assert ps["blocks_wo"] == TS.P(None, "model", None)
    assert ps["blocks_w2"] == TS.P(None, "model", None)
    assert ps["embed"] == TS.P("model", None)
    assert ps["final_norm"] == TS.P()


def test_param_pspecs_fsdp_adds_data_axis():
    cfg = get_config("deepseek-67b")
    spec = TS.param_pspecs(cfg, param_specs(cfg), "fsdp")["blocks_w1"]
    flat = [a for entry in spec if entry is not None
            for a in (entry if isinstance(entry, tuple) else (entry,))]
    assert "model" in flat and "data" in flat


def test_param_pspecs_expert_sharding():
    cfg = get_config("qwen3-moe-235b-a22b")
    ps = TS.param_pspecs(cfg, param_specs(cfg), "tp")
    assert ps["blocks_moe_wg"] == TS.P(None, "model", None, None)


def test_param_pspecs_indivisible_vocab_replicates():
    cfg = get_config("whisper-small")           # vocab 51865
    assert TS.param_pspecs(cfg, param_specs(cfg), "tp")["embed"] == TS.P()


def test_model_axis_raises_and_names_a6d():
    """A model axis above 1 no longer raises in ``DistContext`` or
    ``make_dist`` (tensor and expert parallelism, A6d), nor in serving
    (A6e: the cache holds the rank's KV heads); a serving batch that does
    not divide over the batch axes asks for the sequence split over them
    (``kv_seq_shard``, A6c); dp_only joins
    the model axis to the batch axes; ``ElasticMesh`` shapes as the JAX
    package's."""
    mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    assert DistContext(mesh=mesh).tp == 2
    d = TS.make_dist(mesh)
    assert d.tp == 2 and d.dp == 1 and d.batch_axes == ("data",)
    cfg = get_config(ARCH, smoke=True)
    k, _ = TM.init_cache(cfg, 1, 8, "cpu", dist=d)["blocks"]
    assert k.shape[2:4] == (8, cfg.num_kv_heads // 2)
    with pytest.raises(ValueError, match="kv_seq_shard"):
        TM.init_cache(cfg, 1, 8, "cpu", dist=TS.make_dist(SimpleNamespace(
            shape={"data": 2, "model": 2})))
    d = TS.make_dist(mesh, dp_only=True)
    assert d.tp == 1 and d.dp == 2 and d.batch_axes == ("data", "model")
    d = TS.make_dist(SimpleNamespace(shape={"data": 4, "model": 1}))
    assert d.tp == 1 and d.dp == 4 and d.manual_moe
    from repro.distributed.fault import ElasticMesh as JElastic
    for n in (1, 2, 8, 12, 64):
        for tp, pods in ((1, 1), (2, 1), (1, 2), (4, 2)):
            if n >= tp:
                assert ElasticMesh(tp, pods).shape_for(n) == \
                    JElastic(tp, pods).shape_for(n)


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def _int8_inputs():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                     3.5, 0.0, -0.0], np.float32)
    two = rng.normal(size=(6, 12)).astype(np.float32)
    two[1] = ties                             # exact .5 ties at scale 1
    two[2] = 0.0                              # a zero row
    two[3] = 1e-3
    two[3, 4] = 3e4                           # one large value
    return {"one": rng.normal(size=(17,)).astype(np.float32) * 5,
            "ties": ties.copy(), "zeros": np.zeros(5, np.float32),
            "two": two,
            "three": rng.normal(size=(3, 4, 16)).astype(np.float32) * 1e-3}


@pytest.mark.parametrize("name", ["one", "ties", "zeros", "two", "three"])
def test_quantize_int8_bitwise(name):
    x = _int8_inputs()[name]
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = TC.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = TC.dequantize_int8(q, s, dt)
        want = np.asarray(JC.dequantize_int8(jq, js, jdt))
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))


def _run_worker(case, out_dir, timeout=150, **args):
    r = subprocess.run([sys.executable, WORKER, case, str(out_dir),
                        json.dumps(args)], capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return torch.load(os.path.join(str(out_dir), "result.pt"))


def test_int8_allreduce_mean_two_ranks_bitwise(tmp_path):
    """Two gloo ranks against JAX's ``_allreduce_one`` under
    ``jax.vmap(axis_name="data")``, where psum runs without devices."""
    rng = np.random.default_rng(1)
    base = _int8_inputs()
    per = {k: np.stack([v, (v * rng.uniform(0.5, 2.0, v.shape)).astype(
        np.float32)]) for k, v in base.items()}
    torch.save({k: torch.from_numpy(v) for k, v in per.items()},
               str(tmp_path / "inputs.pt"))
    got = _run_worker("int8", tmp_path, world=2,
                      inputs=str(tmp_path / "inputs.pt"))
    for k, v in per.items():
        want = jax.vmap(lambda g: JC._allreduce_one(g, "data"),
                        axis_name="data")(jnp.asarray(v))
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[0]))


# ---------------------------------------------------------------------------
# the data-axis route
# ---------------------------------------------------------------------------

ARCH = "h2o-danube3-4b"


def _cfg(arch=ARCH):
    return get_config(arch, smoke=True).replace(dtype="float32",
                                                kv_cache_dtype="float32")


def _tcfg(mode, microbatch=0, compression="none"):
    return TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12,
                       seed=0, sharding_mode=mode, microbatch=microbatch,
                       grad_compression=compression)


def _run(cfg, tcfg, mesh, steps=3, B=4, S=32):
    data = SyntheticLM(cfg.vocab_size, S, B, seed=0)
    state = init_state(cfg, tcfg, mesh, device="cpu")
    step = make_train_step(cfg, tcfg, mesh)
    mets = []
    for s in range(steps):
        state, m = step(state, data.batch(s, device="cpu"))
        mets.append({k: m[k].clone() for k in m})
    return state, mets


@pytest.mark.parametrize("variant", [(0, "none"), (2, "int8")])
@pytest.mark.parametrize("mode", ["tp", "fsdp", "dp_only"])
def test_one_rank_route_equals_no_mesh_bitwise(tmp_path, mode, variant):
    """On a one-rank gloo group, 3 steps on the mesh equal 3 steps with
    ``mesh=None`` bit for bit: parameters, both moments, the metrics."""
    cfg, tcfg = _cfg(), _tcfg(mode, *variant)
    want, wmets = _run(cfg, tcfg, None)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got, gmets = _run(cfg, tcfg, make_train_mesh((1, 1), device="cpu"))
    finally:
        dist.destroy_process_group()
    assert torch.equal(got.opt.step, want.opt.step)
    for n in want.params:
        assert torch.equal(got.params[n], want.params[n]), n
        assert torch.equal(got.opt.m[n], want.opt.m[n]), n
        assert torch.equal(got.opt.v[n], want.opt.v[n]), n
    for g, w in zip(gmets, wmets):
        assert g.keys() == w.keys()
        assert all(torch.equal(g[k], w[k]) for k in w)


def test_model_axis_two_ranks(tmp_path):
    """A (1, 2) mesh: tp (the model-axis route) and dp_only each run a
    step, its loss the single-process step's within 1e-5 relative."""
    res = _run_worker("model_axis", tmp_path, world=2, arch=ARCH,
                      mode="dp_only", batch=4, seq=32)
    cfg, tcfg = _cfg(), _tcfg("dp_only")
    _, mets = _run(cfg, tcfg, None, steps=1)
    want = float(mets[0]["loss"])
    for mode in ("tp", "dp_only"):
        assert abs(res[mode] - want) <= 1e-5 * want, (mode, res[mode])
