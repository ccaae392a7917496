"""Units of the model-axis route on the CPU: the four autograd collectives
of ``distributed.tensor_parallel`` on 2 and 4 gloo ranks (and the
identity on one), two-dim ``Placement``s against the JAX package's
``param_pspecs`` for every arch and mode, the serving entry points
over a model axis and the sequence split over the batch axes (A6c), an
indivisible vocabulary
at tp 4, and an elastic restore from a (2, 2) fsdp checkpoint onto a
(1, 4) tp mesh.  The multi-rank
cases run through ``tests/torch_dist_worker.py``; the bars of the route
are ``tests/torch_tp_cases.py``'s.
"""
import math
from types import SimpleNamespace

import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.distributed import shardings as JS
from repro.models.params import param_specs as jparam_specs
from repro_torch.configs import ServeConfig, get_config
from repro_torch.distributed import shardings as TS
from repro_torch.distributed import tensor_parallel as T
from repro_torch.models import model as TM
from repro_torch.models.dist import DistContext
from repro_torch.models.params import init_params, param_specs
from repro_torch.serving.engine import ServingEngine
from repro_torch.train.loop import train
from test_torch_dist import _run_worker
from torch_tp_cases import S, run_arch, smoke, tcfg


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_forward_and_backward(tmp_path, world):
    """Rank r's input x[r] (3, 8); each rank's loss weights the output by
    its own w[r]: copy_to gives x[r] and the sum of the w[r]; reduce_from
    the sum of the x[r] and w[r]; gather_last the x[r] side by side and
    w[r]'s r-th slice; scatter_last of a replicated (3, 8 world) the r-th
    slice and every rank's first 8 columns of w side by side."""
    every = _run_worker("collectives", tmp_path, world=world)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(world, 3, 8, generator=gen)
    w = torch.randn(world, 3, 8 * world, generator=gen)
    for r, res in enumerate(every):
        c, rd, ga, sc = (res[k] for k in ("copy_to", "reduce_from",
                                          "gather_last", "scatter_last"))
        assert torch.equal(c["y"], x[r])
        torch.testing.assert_close(c["g"], w[:, :, :8].sum(0), rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(rd["y"], x.sum(0), rtol=0, atol=1e-6)
        assert torch.equal(rd["g"], w[r][:, :8])
        assert torch.equal(ga["y"], torch.cat(list(x), dim=-1))
        assert torch.equal(ga["g"], w[r][:, r * 8:(r + 1) * 8])
        assert torch.equal(sc["y"], x[0])
        assert torch.equal(sc["g"], torch.cat([w[i][:, :8]
                                               for i in range(world)], -1))


def test_collectives_are_identities_on_one_rank():
    """Without a mesh, or over a model axis of 1, each collective returns
    its input itself: the one-device arithmetic stays bit for bit."""
    x = torch.randn(3, 8, requires_grad=True)
    for ctx in (None, DistContext(mesh=None),
                DistContext(mesh=SimpleNamespace(shape={"data": 2,
                                                        "model": 1}))):
        for fn in (T.copy_to, T.reduce_from, T.gather_last, T.scatter_last):
            assert fn(x, ctx) is x
    assert not T.split_dim(8, 8, None)
    with pytest.raises(ValueError):
        T.split_dim(3, 8, DistContext(mesh=SimpleNamespace(
            shape={"data": 1, "model": 2})))


class _Mesh:
    """A stand-in ``TrainMesh`` at one rank's coordinates (no group)."""

    def __init__(self, shape, coords):
        self.shape, self.coords = dict(shape), dict(coords)
        self.axis_names = tuple(shape)

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in self.axis_names:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i


def _entry_axes(entry):
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


@pytest.mark.parametrize("mode", ["tp", "fsdp", "fsdp_pod", "dp_only"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_two_dim_placements_follow_jax_specs(arch, mode):
    """Every leaf of every arch at FULL, on (data 2, model 4) and (pod 2,
    data 2, model 4) stand-in meshes: the port's ``Placement`` of its spec
    splits the dim JAX's spec puts on the model axis alone over the model
    axis and the dim of any other entry over the batch axes, and its
    local shape is the global shape over each entry's ranks."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs, jspecs = param_specs(cfg), jparam_specs(jcfg)
    for shape in ({"data": 2, "model": 4},
                  {"pod": 2, "data": 2, "model": 4}):
        mesh = _Mesh(shape, {a: 0 for a in shape})
        mp = "pod" in shape
        got = TS.param_pspecs(cfg, specs, mode, mp, mesh=mesh)
        want = JS.param_pspecs(jcfg, jspecs, mode, mp, mesh=mesh)
        for name, v in specs.items():
            js = want[name]
            assert isinstance(js, JP)
            pl = TS.Placement(mesh, got[name])
            model = [d for d, e in enumerate(js) if _entry_axes(e)
                     == ("model",) and mesh.size("model") > 1]
            batch = [d for d, e in enumerate(js) if _entry_axes(e)
                     and _entry_axes(e) != ("model",)
                     and mesh.size(_entry_axes(e)) > 1]
            assert (pl.model[0] if pl.model else None) == \
                (model[0] if model else None), (name, js)
            assert (pl.batch[0] if pl.batch else None) == \
                (batch[0] if batch else None), (name, js)
            local = tuple(n // mesh.size(_entry_axes(e)) if d < len(js)
                          else n for d, (n, e) in enumerate(
                              zip(v.shape, list(js) + [None] * len(v.shape))))
            assert pl.local_shape(v.shape) == local, (name, js)


def test_two_dim_placement_shards_the_coordinates_block():
    """On a (data 2, model 4) stand-in mesh at (data 1, model 2), a leaf
    split on dim 1 over data and dim 2 over model is the (1, 2) block;
    its model shard is the model block whole over data; the moments'
    batch slice of a model shard is the same block."""
    full = torch.arange(3 * 4 * 8, dtype=torch.float32).reshape(3, 4, 8)
    mesh = _Mesh({"data": 2, "model": 4}, {"data": 1, "model": 2})
    pl = TS.Placement(mesh, TS.P(None, "data", "model"))
    assert pl.model == (2, ("model",)) and pl.batch == (1, ("data",))
    assert torch.equal(pl.shard(full), full[:, 2:4, 4:6])
    assert torch.equal(pl.shard_batch(full[:, :, 4:6]), full[:, 2:4, 4:6])
    assert pl.row_axes(3) == ("model",) and pl.axes == ("model", "data")
    tp_only = TS.Placement(mesh, TS.P(None, None, "model"))
    assert tp_only.batch is None and not tp_only == pl
    assert tp_only.shard_batch(full) is full
    dp = TS.Placement(mesh, TS.P(None, ("data", "model"), None))
    assert dp.model is None and dp.batch == (1, ("data", "model"))
    with pytest.raises(ValueError):
        TS.Placement(mesh, TS.P("model", None, "model"))


def test_serving_entry_points_raise_naming_a6e():
    """Serving over a model axis (A6e) no longer raises: under a context
    over a model axis of 2, ``init_cache`` gives the rank's KV heads and
    ``ServingEngine`` builds, its group replicated over the batch axes;
    at tp 4 with KH 2 the cache holds a quarter of the sequence, max_seq
    rounded up to a multiple of 4; a model axis of 1 serves as one
    device.  The sequence split over the batch axes (A6c) no longer
    raises either: a serving batch that does not divide over them asks
    for ``kv_seq_shard``, under which every batch rank holds all rows
    and its slice of the sequence, as ``cache_placements`` cuts it."""
    from repro_torch.models.cache_layout import kv_layout
    cfg = get_config("h2o-danube3-4b", smoke=True)
    L, Dh = cfg.num_layers, cfg.head_dim
    d2 = DistContext(mesh=_Mesh({"data": 1, "model": 2},
                                {"data": 0, "model": 1}))
    k, v = TM.init_cache(cfg, 1, 8, "cpu", dist=d2)["blocks"]
    assert k.shape == v.shape == (L, 1, 8, 1, Dh)
    d4 = DistContext(mesh=_Mesh({"data": 1, "model": 4},
                                {"data": 0, "model": 3}))
    k, _ = TM.init_cache(cfg, 1, 10, "cpu", dist=d4)["blocks"]
    assert k.shape == (L, 1, 3, 2, Dh)
    assert kv_layout(cfg, d4).slice(3) == (9, 12, False, True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, ServeConfig(), params, dist=DistContext(
        mesh=_Mesh({"data": 2, "model": 2}, {"data": 1, "model": 0})))
    assert eng.dist.tp == 2 and eng.dist.dp == 1
    caches = TM.init_cache(cfg, 1, 8, "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    one = DistContext(mesh=SimpleNamespace(shape={"data": 2, "model": 1}))
    logits, _ = TM.prefill(params, cfg, {"tokens": tok}, caches, dist=one)
    assert logits.shape == (1, 1, cfg.vocab_size)
    mesh = _Mesh({"data": 2, "model": 2}, {"data": 1, "model": 1})
    dp2 = DistContext(mesh=mesh)
    with pytest.raises(ValueError, match="kv_seq_shard"):
        TM.init_cache(cfg, 3, 8, "cpu", dist=dp2)
    seq = DistContext(mesh=mesh, kv_seq_shard=True)
    k, _ = TM.init_cache(cfg, 3, 8, "cpu", dist=seq)["blocks"]
    assert k.shape == (L, 3, 4, 1, Dh)
    assert kv_layout(cfg, seq).slice(4) == (4, 8, False, True)
    whole = TM.init_cache(cfg, 2, 8, "cpu")
    pl = TS.cache_placements(cfg, whole, mesh, kv_seq_shard=True)
    assert pl["blocks"][0].shard(whole["blocks"][0]).shape == \
        TM.init_cache(cfg, 2, 8, "cpu", dist=seq)["blocks"][0].shape
    pl = TS.cache_placements(cfg, whole, mesh)["blocks"][0]
    assert pl.shard(whole["blocks"][0]).shape == \
        TM.init_cache(cfg, 2, 8, "cpu", dist=dp2)["blocks"][0].shape


def test_indivisible_vocabulary_stays_replicated(tmp_path):
    """h2o-danube3-4b SMOKE with a vocabulary of 250: replicated on the
    model axis at tp 4 (250 % 4), split at tp 2 on the (2, 2) mesh; both
    routes hold the bars."""
    res = run_arch(tmp_path, "h2o-danube3-4b", 4,
                   overrides={"vocab_size": 250},
                   variants=[([1, 4], "tp", 0, "none"),
                             ([2, 2], "fsdp", 2, "none")])
    assert not res[0]["model_split"]["embed"]
    assert res[1]["model_split"]["embed"]
    assert res[0]["model_split"]["blocks_wk"]      # KV heads 2 over 4


def test_elastic_restore_across_model_axes(tmp_path):
    """A checkpoint written at step 4 by a (2, 2) fsdp run restores onto
    a (1, 4) tp mesh through a fault at its step 0, which runs steps 4
    and 5: every loss within 1e-5 relative of the uninterrupted
    single-process run's."""
    arch = "h2o-danube3-4b"
    res = _run_worker("elastic", tmp_path, timeout=240, world=4, arch=arch,
                      mode="fsdp", save_mesh=[2, 2], load_mesh=[1, 4],
                      load_mode="tp", batch=4, seq=S, steps=4, total=6,
                      ckpt_every=2, workdir=str(tmp_path / "ckpt"))
    clean = train(smoke(arch), tcfg("fsdp"), steps=6, batch_shape=(4, S),
                  verbose=False, device="cpu")
    assert res["restarts"] == 1 and len(res["cont"]) == 2
    for a, b in zip(res["first"] + res["cont"], clean.losses):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
