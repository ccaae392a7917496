"""The port's fleet offline phase and fleet-online fork
(``repro_torch.fleet.topology`` and ``.runtime``) against the JAX
package's, on the 4x5 fleet of ``tests/test_fleet.py``'s end-to-end test
(groups uniform 21, sparse 22, rush_hour 23, bursty 24; 30 s scenes,
200 profile frames, the greedy solver).

All of it is host numpy copied from ``repro``: the fleet's detections, each
group's masks and ``cam_grids``, and every online metric are held bit for
bit (``torch_compare.assert_same``); only host wall clocks (``wall_s``)
are not compared."""
import numpy as np
import pytest

from repro.core import pipeline as jpipe
from repro.fleet import runtime as jrt, topology as jtopo
from repro.net import batcher as jbatch, links as jlinks
from repro_torch.core import pipeline as tpipe
from repro_torch.fleet import runtime as trt, topology as ttopo
from repro_torch.net import batcher as tbatch, links as tlinks
from torch_compare import assert_same

GROUPS = [("uniform", 21), ("sparse", 22), ("rush_hour", 23),
          ("bursty", 24)]
PROFILE = 200


def _fleet(topo):
    return topo.build_fleet(topo.FleetConfig(
        groups=[topo.GroupSpec(p, seed=s) for p, s in GROUPS],
        duration_s=30))


@pytest.fixture(scope="module")
def fleets():
    return _fleet(ttopo), _fleet(jtopo)


@pytest.fixture(scope="module")
def offlines(fleets):
    tf, jf = fleets
    return (trt.run_fleet_offline(tf, tpipe.OfflineConfig(
                profile_frames=PROFILE, solver="greedy")),
            jrt.run_fleet_offline(jf, jpipe.OfflineConfig(
                profile_frames=PROFILE, solver="greedy")))


def test_build_fleet(fleets):
    tf, jf = fleets
    assert tf.num_groups == 4 and tf.num_cameras == 20
    assert_same(tf, jf)
    assert_same(tf.all_cameras(), jf.all_cameras())
    assert ttopo.cross_group_leakage(tf, 50) \
        == jtopo.cross_group_leakage(jf, 50) == 0


def test_build_fleet_with_a_traffic_shift():
    spec = dict(duration_s=12, spacing_m=400.0)
    shift = dict(shift_at_s=6.0, shift_entry_weights=(0.1, 0.1, 0.4, 0.4))
    tf = ttopo.build_fleet(ttopo.FleetConfig(
        groups=[ttopo.GroupSpec("rush_hour", seed=5, overrides=shift)],
        **spec))
    jf = jtopo.build_fleet(jtopo.FleetConfig(
        groups=[jtopo.GroupSpec("rush_hour", seed=5, overrides=shift)],
        **spec))
    assert_same(tf, jf)


@pytest.mark.parametrize("gid", range(len(GROUPS)))
def test_run_fleet_offline_per_group(offlines, gid):
    t, j = offlines
    tg, jg = t.per_group[gid], j.per_group[gid]
    assert tg.mask == jg.mask and len(jg.mask) > 0
    assert_same(tg.cam_grids, jg.cam_grids)
    assert_same(tg, jg)
    assert tg.fleet_density == jg.fleet_density


def test_fleet_density(offlines):
    t, j = offlines
    assert t.fleet_density == j.fleet_density > 0.0


ONLINE = [
    dict(),
    dict(coverage_thresh=1.0),
    dict(transport="simulated"),
    dict(transport="simulated", net="congested"),
]


def _online_cfg(pipe, links, batcher, spec):
    spec = dict(spec)
    if spec.get("net") == "congested":
        spec["net"] = batcher.NetConfig(
            link=links.LinkConfig(
                jitter_std=0.3, seed=2,
                congestion=links.default_congestion_trace(10.0)),
            deadline_s=0.8)
    return pipe.OnlineConfig(**spec)


@pytest.mark.parametrize("spec", ONLINE)
def test_run_fleet_online(fleets, offlines, spec):
    (tf, jf), (to, jo) = fleets, offlines
    t = trt.run_fleet_online(tf, to.per_group,
                             _online_cfg(tpipe, tlinks, tbatch, spec),
                             PROFILE, 300)
    j = jrt.run_fleet_online(jf, jo.per_group,
                             _online_cfg(jpipe, jlinks, jbatch, spec),
                             PROFILE, 300)
    assert_same(t, j)
    assert 0.0 < j.accuracy_min <= j.accuracy_mean <= 1.0
    assert (j.transport is None) == (spec.get("transport") is None)


def test_run_fleet_online_with_keep_masks(fleets, offlines):
    """Reducto keep masks per group, one group left unfiltered and one
    camera of another left out (a partial dict)."""
    (tf, jf), (to, jo) = fleets, offlines
    n = 100
    keep = {g.gid: {c.cam_id: (np.arange(n) % 3) != 1
                    for c in g.scene.cameras[:4 if g.gid == 1 else 5]}
            for g in jf.groups if g.gid != 2}
    for transport in ("analytic", "simulated"):
        t = trt.run_fleet_online(tf, to.per_group,
                                 tpipe.OnlineConfig(transport=transport),
                                 PROFILE, PROFILE + n, frame_keep=keep)
        j = jrt.run_fleet_online(jf, jo.per_group,
                                 jpipe.OnlineConfig(transport=transport),
                                 PROFILE, PROFILE + n, frame_keep=keep)
        assert_same(t, j)
        assert j.frames_reduced > 0


def test_fleet_online_rejects_the_single_scene_keep(fleets, offlines):
    tf, to = fleets[0], offlines[0]
    with pytest.raises(ValueError):
        trt.run_fleet_online(tf, to.per_group,
                             tpipe.OnlineConfig(frame_keep={}), PROFILE, 300)
