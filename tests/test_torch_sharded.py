"""The port's sharded fleet runtime (``repro_torch.fleet.sharded``, the
shard plan, the fleet mesh and its placement, ``ShardedActivationCache``,
``sharded_fleet_step`` and the four shard-aware harness functions)
against the JAX package's, on the CPU.

The JAX package's ``ShardedSuperlaunch`` runs live with its four Pallas
kernels swapped for traceable jnp (``torch_jax_oracle.py``): in-process
on a one-device mesh (the ``jax_sharded_oracle`` fixture) and on two
forced host devices in a subprocess (``run_jax_sharded``).  Stats (gate
stats rows included), dispatch counters, cache counters and epochs are
equal; head maps within 1e-5 (JAX applies the head as a matmul).
Inside the port the sharded step is held bitwise against the
single-device ``superlaunch_forward_reuse`` and ``step_full`` against
``superlaunch_forward``, at several shard counts, on one device and on
two device blocks (``cpu`` and ``cpu:0`` name one memory as two devices,
so the per-device launch route runs here too)."""
import collections
import pickle
import threading
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import torch_sharded_cases as C
from repro import obs as jobs
from repro.fleet import runtime as jrt
from repro.fleet import sharded as jsharded
from repro.kernels import ops as jops
from repro.launch.mesh import make_fleet_mesh as jmesh
from repro_torch import obs as tobs
from repro_torch.core import pipeline as tpipe, scene as tscene
from repro_torch.distributed.shardings import (fleet_state_sharding,
                                               put_fleet_state)
from repro_torch.fleet import drift as tdrift, faults as tfaults
from repro_torch.fleet import runtime as trt
from repro_torch.fleet import sharded as tsharded
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import FLEET_AXIS, make_fleet_mesh
from repro_torch.obs import loadgen as tlg
from repro_torch.serving import detector as tdet
from torch_compare import assert_same
from torch_jax_oracle import detector_pair, run_jax_sharded
from torch_jax_oracle import jax_sharded_oracle  # noqa: F401  (fixture)

HEAD_TOL = 1e-5
CPU, CPU0 = torch.device("cpu"), torch.device("cpu", 0)
MESHES = {"one_device": [CPU], "two_blocks": [CPU, CPU0]}


@pytest.fixture(scope="module")
def dets():
    return detector_pair(0, channels=C.CHANNELS, tile=C.TILE)


@pytest.fixture(scope="module")
def grids():
    return C.ragged_grids()


@pytest.fixture(scope="module")
def trace(grids):
    return C.frame_trace(grids)


def _same_maps(a, b):
    assert list(a) == list(b)
    for g in b:
        assert len(a[g]) == len(b[g])
        for x, y in zip(a[g], b[g]):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), g


def _close_maps(port, want):
    assert list(port) == list(want)
    for g in want:
        assert len(port[g]) == len(want[g])
        for x, y in zip(port[g], want[g]):
            x, y = C.to_np(x), np.asarray(y)
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=0, atol=HEAD_TOL)


def _same_runs(port, want):
    """Port and JAX ``run_steps`` records: dispatches and stats exactly,
    maps within the head bar."""
    assert len(port) == len(want)
    for (pm, pc, ps), (jm, jc, js) in zip(port, want):
        assert pc == jc
        assert_same(ps, js)
        _close_maps(pm, jm)


def _flat_threshold(threshold, grids):
    """The sharded per-gid threshold as the single-device fleet's flat
    per-camera array."""
    if not isinstance(threshold, dict):
        return threshold
    return np.concatenate([np.asarray(threshold.get(g, np.zeros(len(gs))),
                                      np.float64)
                           for g, gs in grids.items()])


# ---------------------------------------------------------------------------
# the shard plan, the mesh, the placement
# ---------------------------------------------------------------------------

@given(st.lists(st.integers(0, 40), min_size=1, max_size=24),
       st.integers(1, 8))
@settings(max_examples=60, deadline=None)
def test_shard_plan_bit_exact(tile_counts, n_shards):
    grids = [[np.ones((1, t), bool)] if t else [np.zeros((1, 1), bool)]
             for t in tile_counts]
    t, j = tops.shard_plan(grids, n_shards), jops.shard_plan(grids, n_shards)
    assert t.n_shards == j.n_shards and t.n_groups == j.n_groups
    np.testing.assert_array_equal(t.assignment, j.assignment)
    np.testing.assert_array_equal(t.tile_counts, j.tile_counts)
    np.testing.assert_array_equal(t.shard_tiles, j.shard_tiles)
    assert t.imbalance == j.imbalance
    for s in range(n_shards):
        assert t.shard_groups(s) == j.shard_groups(s)


def test_shard_plan_rejects_zero_shards():
    for ops in (tops, jops):
        with pytest.raises(ValueError):
            ops.shard_plan([[np.ones((1, 1), bool)]], 0)


def test_fleet_mesh_and_placement(monkeypatch):
    """``n_shards`` beyond the visible devices raises unless ``devices=``
    places them; shards on one device form one block, in shard order;
    ``put_fleet_state`` splits (S, ...) stacks by block."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError):
        make_fleet_mesh(1)
    mesh = make_fleet_mesh(3, devices=["cpu", CPU0])
    assert mesh.shape[FLEET_AXIS] == 3
    assert mesh.devices == [CPU, CPU0, CPU]
    sh = fleet_state_sharding(mesh)
    assert sh.blocks == ((CPU, (0, 2)), (CPU0, (1,)))
    assert [sh.locate(s) for s in range(3)] == [(0, 0), (1, 0), (0, 1)]
    assert make_fleet_mesh(0, devices=["cpu"]).shape[FLEET_AXIS] == 1
    a = np.arange(12).reshape(3, 4)
    placed = put_fleet_state(mesh, {"a": a, "b": (torch.ones(3, 2),)})
    assert [t.tolist() for t in placed["a"]] == [[a[0].tolist(),
                                                  a[2].tolist()],
                                                 [a[1].tolist()]]
    assert [t.shape for t in placed["b"][0]] == [(2, 2), (1, 2)]
    with pytest.raises(ValueError):
        put_fleet_state(mesh, np.zeros((2, 1)))


# ---------------------------------------------------------------------------
# against the JAX package's sharded runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thr", list(C.THRESHOLDS))
def test_one_shard_against_jax(jax_sharded_oracle, dets, grids, trace, thr):
    """S = 1, in-process: every step's stats, gate stats rows and
    dispatches, the cache's counters and epochs; an empty fleet launches
    nothing in both."""
    jd, td = dets
    threshold = C.THRESHOLDS[thr]
    jr = jsharded.ShardedSuperlaunch(jd, grids, jmesh(1))
    tr = tsharded.ShardedSuperlaunch(td, grids, make_fleet_mesh(
        1, devices=["cpu"]))
    jc, tc = jr.make_cache(), tr.make_cache()
    want = C.run_steps(jrt.sharded_fleet_step, jr, jc, trace, threshold)
    got = C.run_steps(trt.sharded_fleet_step, tr, tc, trace, threshold)
    _same_runs(got, want)
    assert got[C.STATIC_STEP][1] == {"tile_delta_gate": 1}
    assert got[0][2].cold_shards == 1 and got[0][1]["tile_delta_gate"] == 1
    assert_same(C.cache_counters(tc), C.cache_counters(jc))
    assert tc.compute_fraction == jc.compute_fraction

    empty = {0: [np.zeros((2, 2), bool)], 1: [np.zeros((1, 3), bool)]}
    f = {0: [np.zeros((16, 16, 3), np.float32)],
         1: [np.zeros((8, 24, 3), np.float32)]}
    runs = []
    for pkg, det, mesh in ((jsharded, jd, jmesh(1)),
                           (tsharded, td, make_fleet_mesh(
                               1, devices=["cpu"]))):
        rt = pkg.ShardedSuperlaunch(det, empty, mesh)
        step = jrt.sharded_fleet_step if pkg is jsharded \
            else trt.sharded_fleet_step
        runs.append(C.run_steps(step, rt, rt.make_cache(), [f]))
    _same_runs(*runs)
    assert runs[0][0][1] == {} and not runs[0][0][0][0][0].any()


JAX_TWO_SHARDS = """
import pickle, sys, types
import jax, numpy as np
import torch_sharded_cases as C
from repro.core import pipeline, scene
from repro.fleet import drift, faults
from repro.fleet.runtime import sharded_fleet_step
from repro.fleet.sharded import ShardedSuperlaunch
from repro.launch.mesh import make_fleet_mesh
from repro.obs import loadgen
from repro.serving.detector import DetectorConfig, RoIDetector

assert len(jax.devices()) == 2
det = RoIDetector(DetectorConfig(tile=C.TILE, channels=C.CHANNELS),
                  jax.random.PRNGKey(0))
grids, mesh = C.ragged_grids(), make_fleet_mesh(2)
trace = C.frame_trace(grids)
res = {}
rt = ShardedSuperlaunch(det, grids, mesh)
cache = rt.make_cache()
res["assignment"] = rt.plan.assignment
res["steps"] = C.run_steps(sharded_fleet_step, rt, cache, trace)
cache.invalidate_group(1)
res["steps"] += C.run_steps(sharded_fleet_step, rt, cache, trace[-1:])
res["cache"] = C.cache_counters(cache)
res["on_shard"] = [rt.groups_on_shard(s) for s in range(2)]
rt = ShardedSuperlaunch(det, grids, mesh)
rep, outs, tot = loadgen.drive_sharded(rt, trace, rt.make_cache(),
                                       keep_outputs=True)
res["drive"] = (rep, [C.maps_np(o) for o in outs], dict(tot))
schedule = faults.FaultSchedule((
    faults.FaultEvent("shard", 2, 3, shard=0),
    faults.FaultEvent("freeze", 1, 4, gid=0, cam=1)))
for key, sched in (("chaos_none", None), ("chaos", schedule)):
    rt = ShardedSuperlaunch(det, grids, mesh)
    cache = rt.make_cache()
    rep, outs, tot, lost = faults.drive_chaos_sharded(
        rt, trace, cache, schedule=sched, keep_outputs=True)
    res[key] = (rep, [C.maps_np(o) for o in outs], dict(tot), lost,
                C.cache_counters(cache))
pkg = types.SimpleNamespace(scene=scene, pipeline=pipeline, drift=drift,
                            faults=faults,
                            ShardedSuperlaunch=ShardedSuperlaunch,
                            sharded_fleet_step=sharded_fleet_step)
# the reference's rebuild_group zeroes a plane of the canvas with
# ``.at[s].set``, which this jax refuses on a mesh-sharded array (no
# out_sharding): a listener that runs first hands it the same values on
# the host, and rebuild_group puts them back on the mesh
def canvas_to_host(cache):
    if cache.canvas is not None:
        cache.canvas = np.asarray(cache.canvas)
res["drift"] = C.drift_run(pkg, det, mesh, grids, canvas_to_host)[:4]
with open(sys.argv[1], "wb") as fh:
    pickle.dump(res, fh)
"""


@pytest.fixture(scope="module")
def jax_two(tmp_path_factory):
    """The JAX package's runtime on two forced host devices: the steps
    with an ``invalidate_group``, the drivers and the drift case."""
    path = tmp_path_factory.mktemp("jax_two") / "two.pkl"
    script = ("import sys\nsys.argv = ['-', %r]\n" % str(path)
              + JAX_TWO_SHARDS)
    run_jax_sharded(script, devices=2)
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _port_two(td, grids):
    rt = tsharded.ShardedSuperlaunch(td, grids, make_fleet_mesh(
        2, devices=["cpu"]))
    return rt, rt.make_cache()


def test_two_shards_against_jax(jax_two, dets, grids, trace):
    """S = 2 against the JAX package's two-device run: the plan, every
    step, the cache; ``invalidate_group`` colds one shard on both."""
    _, td = dets
    rt, cache = _port_two(td, grids)
    np.testing.assert_array_equal(rt.plan.assignment, jax_two["assignment"])
    assert len(set(rt.plan.assignment.tolist())) == 2
    got = C.run_steps(trt.sharded_fleet_step, rt, cache, trace)
    cache.invalidate_group(1)
    got += C.run_steps(trt.sharded_fleet_step, rt, cache, trace[-1:])
    _same_runs(got, jax_two["steps"])
    assert got[-1][2].cold_shards == 1
    assert_same(C.cache_counters(cache), jax_two["cache"])
    assert [rt.groups_on_shard(s) for s in range(2)] == jax_two["on_shard"]


def test_drive_sharded_against_jax(jax_two, dets, grids, trace):
    """``drive_sharded``: reports (less walls), kept maps and dispatches
    as JAX's; its maps equal ``drive_fleet``'s bitwise."""
    _, td = dets
    rt, cache = _port_two(td, grids)
    rep, outs, tot = tlg.drive_sharded(rt, trace, cache, keep_outputs=True)
    jrep, jouts, jtot = jax_two["drive"]
    assert_same(rep, jrep)
    assert dict(tot) == jtot
    for a, b in zip(outs, jouts):
        _close_maps(a, b)
    _, fouts, _ = tlg.drive_fleet(td, trace, grids,
                                  tdet.PackedActivationCache(),
                                  keep_outputs=True)
    for a, b in zip(outs, fouts):
        _same_maps(a, b)


def test_chaos_sharded_against_jax(jax_two, dets, grids, trace):
    """``drive_chaos_sharded``: with no schedule it is ``drive_sharded``;
    a shard loss at step 2 (with a frozen camera) cold-marks exactly the
    lost shard's groups, as JAX's; ``shard_failover`` alone too."""
    _, td = dets
    rt, cache = _port_two(td, grids)
    _, plain, plain_tot = tlg.drive_sharded(rt, trace, cache,
                                            keep_outputs=True)
    schedule = tfaults.FaultSchedule((
        tfaults.FaultEvent("shard", 2, 3, shard=0),
        tfaults.FaultEvent("freeze", 1, 4, gid=0, cam=1)))
    for key, sched in (("chaos_none", None), ("chaos", schedule)):
        rt, cache = _port_two(td, grids)
        rep, outs, tot, lost = tfaults.drive_chaos_sharded(
            rt, trace, cache, schedule=sched, keep_outputs=True)
        jrep, jouts, jtot, jlost, jcache = jax_two[key]
        assert_same(rep, jrep)
        assert dict(tot) == jtot and lost == jlost
        assert_same(C.cache_counters(cache), jcache)
        for a, b in zip(outs, jouts):
            _close_maps(a, b)
        if sched is None:
            assert tot == plain_tot and lost == {}
            for a, b in zip(outs, plain):
                _same_maps(a, b)
    assert lost == {2: rt.groups_on_shard(0)} and rep[2].cold
    rt, cache = _port_two(td, grids)
    cache.valid[:] = True
    assert tfaults.shard_failover(rt, cache, 1) == rt.groups_on_shard(1)
    assert cache.valid.tolist() == [True, False]


def test_drift_rebuild_against_jax(jax_two, dets, grids):
    """``wire_shard_invalidation`` with a ``DriftAdapter``: a failover
    re-solve and a drift re-solve each cold only the owning shard and
    rebuild its tables, as JAX's; the re-solved group's maps equal a cold
    ``superlaunch_forward`` on the new grids bitwise, and the other
    shard computes only what its own frames changed."""
    _, td = dets
    pkg = types.SimpleNamespace(scene=tscene, pipeline=tpipe, drift=tdrift,
                                faults=tfaults,
                                ShardedSuperlaunch=tsharded.ShardedSuperlaunch,
                                sharded_fleet_step=trt.sharded_fleet_step)
    steps, new, counters, owner, rt = C.drift_run(
        pkg, td, make_fleet_mesh(2, devices=["cpu"]), grids)
    jsteps, jnew, jcounters, jowner = jax_two["drift"]
    _same_runs(steps, jsteps)
    assert_same(new, jnew)
    assert_same(counters, jcounters)
    assert owner == jowner
    assert counters["shard_invalidations"].tolist() == [
        2 if s == owner else 0 for s in range(2)]
    assert steps[1][2].per_shard_computed[1 - owner] == 0
    for _, _, stats in steps[2:]:
        # the other shard stays warm: its frames hold still
        assert stats.cold_shards == 1
        assert stats.per_shard_computed[1 - owner] == 0
    frames = C.drift_frames(new)[1]
    want = td.superlaunch_forward(frames, new)
    assert sum(int(g.sum()) for g in new[C.DRIFT_GID]) > 0
    for i, m in enumerate(steps[-1][0][C.DRIFT_GID]):
        np.testing.assert_array_equal(m, C.to_np(want[C.DRIFT_GID][i]))


# ---------------------------------------------------------------------------
# inside the port: bitwise against the single-device path
# ---------------------------------------------------------------------------

def _flat_gate_stats(rt, stats):
    """The shards' gate stats rows in the single-device fleet's row order
    (groups in gid order): each shard's rows split by its groups."""
    by_gid = {}
    for s, rows in enumerate(stats.gate_stats):
        start = 0
        for g in rt.groups_on_shard(s):
            n = sum(int(a.sum()) for a in rt.grids[g])
            by_gid[g] = rows[start:start + n] if n else np.zeros((0, 8))
            start += n
    return np.concatenate([by_gid[g] for g in rt.gids])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("thr", list(C.THRESHOLDS))
@pytest.mark.parametrize("S", [1, 2, 3])
def test_bitwise_equal_to_single_device(dets, grids, trace, S, thr, mesh):
    _, td = dets
    threshold = C.THRESHOLDS[thr]
    rt = tsharded.ShardedSuperlaunch(td, grids, make_fleet_mesh(
        S, devices=MESHES[mesh]))
    cache, pcache = rt.make_cache(), tdet.PackedActivationCache()
    for i, f in enumerate(trace):
        want, wstats = td.superlaunch_forward_reuse(
            f, grids, pcache, _flat_threshold(threshold, grids))
        got, counts, stats = trt.sharded_fleet_step(rt, f, cache, threshold)
        _same_maps(got, want)
        assert (stats.raw_changed, stats.changed_out, stats.computed) == (
            wstats.raw_changed, wstats.changed_out, wstats.computed)
        assert stats.canvas_bytes == wstats.canvas_bytes
        if i:
            np.testing.assert_array_equal(_flat_gate_stats(rt, stats),
                                          wstats.gate_stats)
    full = rt.step_full(trace[0])
    _same_maps(full, td.superlaunch_forward(trace[0], grids))


def test_cross_shard_halo_offsets(dets):
    """Two shards, each one camera of 2 x 2 tiles with no padding row, so
    shard 1's rows sit right after shard 0's in the block: a neighbour
    offset off by a shard would read the other shard's tiles."""
    _, td = dets
    grids = {0: [np.ones((2, 2), bool)], 1: [np.ones((2, 2), bool)]}
    rng = np.random.default_rng(5)
    frames = [{g: [rng.random((16, 16, 3)).astype(np.float32)]
               for g in grids} for _ in range(3)]
    frames[2][1] = frames[1][1]                   # shard 1 static
    rt = tsharded.ShardedSuperlaunch(td, grids, make_fleet_mesh(
        2, devices=["cpu"]))
    assert rt.n_max == 4 and rt._n_s == [4, 4]
    cache, pcache = rt.make_cache(), tdet.PackedActivationCache()
    for f in frames:
        want, _ = td.superlaunch_forward_reuse(f, grids, pcache)
        got, _, stats = trt.sharded_fleet_step(rt, f, cache)
        _same_maps(got, want)
    assert stats.per_shard_computed == [4, 0] and stats.k_max == 4
    _same_maps(rt.step_full(frames[0]),
               td.superlaunch_forward(frames[0], grids))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pipeline_with_three_queued(dets, grids, trace, mesh):
    """Three submits before the first collect: every collected map equals
    the synchronous step's bitwise (the canvas is written in place, so a
    step's maps are copied before a later conv writes it); host planning
    runs with a device step in flight."""
    _, td = dets
    rt = tsharded.ShardedSuperlaunch(td, grids, make_fleet_mesh(
        2, devices=MESHES[mesh]))
    sync_rt = tsharded.ShardedSuperlaunch(td, grids, make_fleet_mesh(
        2, devices=MESHES[mesh]))
    cache = sync_rt.make_cache()
    want = [tlg.kept_maps(sync_rt.step_reuse(f, cache)[0]) for f in trace]
    pipe = tsharded.AsyncShardedPipeline(rt, rt.make_cache())
    for f in trace[:3]:
        pipe.submit(f)
    outs = [pipe.collect()]
    for f in trace[3:]:
        pipe.submit(f)
    outs += pipe.drain()
    assert [s for s, _, _ in outs] == list(range(len(trace)))
    for (_, got, stats), w in zip(outs, want):
        _same_maps(got, w)
    assert outs[C.STATIC_STEP][2].k_max == 0
    assert pipe.overlap_fraction > 0.5
    assert len(pipe.latencies) == len(trace) and pipe.p99_latency_s > 0
    with pytest.raises(RuntimeError):
        pipe.collect()


def _rebuilt(td, grids, gid, new, S=2):
    """A runtime two steps warm on ``grids``, then group ``gid``
    re-solved to ``new`` (invalidated, rebuilt); returns (runtime, cache,
    the packed block before the rebuild, the old n_max)."""
    rt = tsharded.ShardedSuperlaunch(td, grids, make_fleet_mesh(
        S, devices=["cpu"]))
    cache = rt.make_cache()
    tr = C.frame_trace(grids)
    for f in tr[:2]:
        trt.sharded_fleet_step(rt, f, cache)
    before = [p.clone() for p in cache.packed]
    old_n = rt.n_max
    cache.invalidate_group(gid)
    rt.rebuild_group(gid, new, cache=cache)
    return rt, cache, before, old_n, tr


def test_rebuild_group_branches(dets):
    """``rebuild_group``: a grown mask grows ``n_max`` and re-pads the
    packed rows and epochs, the other shard staying warm; a changed camera
    count drops everything; a shard rebuilt empty has its canvas plane
    zeroed.  Each next step equals a cold recompute on the new grids."""
    _, td = dets
    grids = {0: [np.ones((2, 2), bool)], 1: [np.eye(3, dtype=bool)]}
    # grown: group 1 from 3 to 9 tiles -> n_max 4 -> 16
    rt, cache, before, old_n, tr = _rebuilt(
        td, grids, 1, [np.ones((3, 3), bool)])
    owner = cache.owner_shard(1)
    assert (old_n, rt.n_max) == (4, 16)
    assert cache.packed[0].shape[1] == 16 and cache.epoch_np.shape == (2, 16)
    other = 1 - owner
    assert torch.equal(cache.packed[0][other, :old_n], before[0][other])
    assert not cache.packed[0][other, old_n:].any()
    f = dict(tr[1])
    f[1] = [np.random.default_rng(1).random((24, 24, 3)).astype(np.float32)]
    got, _, stats = trt.sharded_fleet_step(rt, f, cache)
    assert stats.cold_shards == 1 and stats.per_shard_computed[other] == 0
    _same_maps(got, td.superlaunch_forward(f, rt.grids))
    # camera count: group 1 gains a camera -> F_max 1 -> 2
    rt, cache, _, _, tr = _rebuilt(td, grids, 1, [np.eye(3, dtype=bool),
                                                  np.ones((1, 2), bool)])
    assert rt.F_max == 2 and cache.packed is None and cache.canvas is None
    assert not cache.valid.any()
    f = dict(tr[1])
    f[1] = [tr[1][1][0], np.full((8, 16, 3), 0.5, np.float32)]
    got, _, stats = trt.sharded_fleet_step(rt, f, cache)
    assert stats.cold_shards == 2
    _same_maps(got, td.superlaunch_forward(f, rt.grids))
    # empty: group 1's shard rebuilt to no tile, its plane zeroed at once
    rt, cache, _, _, tr = _rebuilt(td, grids, 1, [np.zeros((3, 3), bool)])
    owner = cache.owner_shard(1)
    assert rt._n_s[owner] == 0 and not cache.canvas[0][owner].any()
    got, counts, stats = trt.sharded_fleet_step(rt, tr[1], cache)
    assert stats.k_max == 0 and dict(counts) == {"tile_delta_gate": 1}
    assert not got[1][0].any()
    _same_maps(got, td.superlaunch_forward(tr[1], rt.grids))


# ---------------------------------------------------------------------------
# spans and metrics
# ---------------------------------------------------------------------------

def _spans(o):
    """(name, args, thread role, parent) of each recorded span, as
    ``test_torch_obs.py`` reduces them."""
    evs = o.trace.events()
    names = o.trace.thread_names()
    main = threading.current_thread().name
    out = []
    for i, (name, tid, t0, dur, args) in enumerate(evs):
        if tid >= o.trace.TRACK_TID_BASE:
            role = "track:" + names[tid]
        else:
            role = "main" if names[tid] == main else "other"
        parents = [(d, n) for j, (n, tj, s, d, _) in enumerate(evs)
                   if j != i and tj == tid and s <= t0 and t0 + dur <= s + d]
        out.append((name, args, role, min(parents)[1] if parents else None))
    return out


def _snapshot(o):
    out = {}
    for name, fam in o.metrics.REGISTRY.snapshot().items():
        vals = fam["values"]
        if not vals:
            continue
        if name == "step_wall_s":
            vals = [(v["labels"], v["value"]["count"]) for v in vals]
        out[name] = (fam["type"], fam["labels"], vals)
    return out


def test_spans_and_metrics_as_jax(jax_sharded_oracle, dets, grids, trace):
    """``sharded_fleet_step``'s span and metrics and the pipeline's gate,
    host_plan, device_compute and collect spans, by name, args, thread
    role and parent, and the metrics by value (step walls by count)."""
    jd, td = dets
    seen = []
    for o, pkg, step, det, mesh in (
            (tobs, tsharded, trt.sharded_fleet_step, td,
             make_fleet_mesh(1, devices=["cpu"])),
            (jobs, jsharded, jrt.sharded_fleet_step, jd, jmesh(1))):
        for x in (tobs, jobs):
            x.configure(enabled=False, reset=True)
        try:
            with o.enabled():
                rt = pkg.ShardedSuperlaunch(det, grids, mesh)
                cache = rt.make_cache()
                for f in trace[:3]:
                    step(rt, f, cache)
                pipe = pkg.AsyncShardedPipeline(rt, cache)
                for f in trace[2:]:
                    pipe.submit(f)
                pipe.collect()
                pipe.drain()
            seen.append((_spans(o), _snapshot(o)))
        finally:
            for x in (tobs, jobs):
                x.configure(enabled=False, reset=True)
    (tspans, tsnap), (jspans, jsnap) = seen
    assert tspans == jspans
    assert tsnap == jsnap
    names = collections.Counter(s[0] for s in tspans)
    assert names == {"sharded_fleet_step": 3, "gate": 3, "host_plan": 3,
                     "device_compute": 3, "collect": 3}
    assert {s[2] for s in tspans if s[0] == "device_compute"} == \
        {"track:device"}
