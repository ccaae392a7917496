"""The port's offline and online phases (``repro_torch.core``) against the
JAX package's (``repro.core``), on the same seeds.

``repro_torch.core`` is a numpy copy of ``repro.core``: the same
``np.random.default_rng`` draws in the same order, the same set cover,
the same codec arithmetic.  So every result is held bit for bit
(``torch_compare.assert_same``: integers, masks and arrays equal, floats
``==``); only the host wall clocks (``wall_s``) are not compared.  The
scene is cut to 20 s and the profile to 100 frames (60 for the exact
solver's scene-sized instance) to keep the file within seconds."""
import numpy as np
import pytest

from repro.core import (association as jassoc, compression as jcomp,
                        filters as jfilt, grouping as jgroup,
                        pipeline as jpipe, reducto as jreducto,
                        reid as jreid, scene as jscene, setcover as jsc)
from repro_torch.core import (association as tassoc, compression as tcomp,
                              filters as tfilt, grouping as tgroup,
                              pipeline as tpipe, reducto as treducto,
                              reid as treid, scene as tscene,
                              setcover as tsc)
from torch_compare import assert_same

SECONDS = 20
PROFILE = 100


@pytest.fixture(scope="module")
def scenes():
    cfg = dict(duration_s=SECONDS, seed=3)
    return (tscene.generate_scene(tscene.SceneConfig(**cfg)),
            jscene.generate_scene(jscene.SceneConfig(**cfg)))


@pytest.fixture(scope="module")
def offlines(scenes):
    ts, js = scenes
    return (tpipe.run_offline(ts, tpipe.OfflineConfig(
                profile_frames=PROFILE, solver="greedy")),
            jpipe.run_offline(js, jpipe.OfflineConfig(
                profile_frames=PROFILE, solver="greedy")))


@pytest.mark.parametrize("profile", ["uniform", "rush_hour", "sparse",
                                     "bursty"])
def test_generate_scene_detections(profile):
    cfg = dict(duration_s=15, seed=5, spawn_profile=profile)
    t = tscene.generate_scene(tscene.SceneConfig(**cfg))
    j = jscene.generate_scene(jscene.SceneConfig(**cfg))
    assert_same(t, j)
    assert sum(len(f) for f in j.detections) > 0


def test_noisy_reid_records(scenes):
    ts, js = scenes
    t = treid.run_noisy_reid(ts, treid.ReIDNoiseConfig(), 0, PROFILE)
    j = jreid.run_noisy_reid(js, jreid.ReIDNoiseConfig(), 0, PROFILE)
    assert_same(t, j)
    assert_same(treid.characterize_pairwise(t, len(ts.cameras)),
                jreid.characterize_pairwise(j, len(js.cameras)))


@pytest.mark.parametrize("enabled", [True, False])
def test_apply_filters_and_stats(scenes, enabled):
    ts, js = scenes
    t = treid.run_noisy_reid(ts, None, 0, PROFILE)
    j = jreid.run_noisy_reid(js, None, 0, PROFILE)
    tout = tfilt.apply_filters(t, len(ts.cameras),
                               tfilt.FilterConfig(enabled=enabled))
    jout = jfilt.apply_filters(j, len(js.cameras),
                               jfilt.FilterConfig(enabled=enabled))
    assert_same(tout, jout)
    if enabled:
        assert jout[1].pairs_fitted > 0


def test_association_table(offlines):
    t, j = offlines
    recs = t.reid_records
    tt = tassoc.build_association_table(
        recs, tassoc.TileUniverse.build(t.universe.cameras))
    jt = jassoc.build_association_table(
        j.reid_records, jassoc.TileUniverse.build(j.universe.cameras))
    assert_same(tt, jt)
    assert_same(t.table, j.table)
    assert len(jt.constraints) > 0


def _paper_tables():
    """Paper Table 1 / Figure 2's two-camera instance, in both packages
    (the instance of ``tests/test_core_setcover.py``)."""
    out = []
    for assoc, geometry in ((tassoc, tscene), (jassoc, jscene)):
        Camera = geometry.Camera
        P = np.eye(3, 4)
        uni = assoc.TileUniverse.build([Camera(0, 6 * 64, 4 * 64, P),
                                        Camera(1, 6 * 64, 4 * 64, P)])

        def tiles(cam, *one_based):
            return frozenset(cam * 24 + t - 1 for t in one_based)
        R = assoc.Region
        cons = [[R(0, tiles(0, 9, 10, 15, 16)), R(1, tiles(1, 7, 8, 13, 14))],
                [R(0, tiles(0, 3, 4, 9, 10))], [R(0, tiles(0, 4, 5, 10, 11))],
                [R(0, tiles(0, 11))], [R(1, tiles(1, 2, 8))],
                [R(1, tiles(1, 3))], [R(1, tiles(1, 3, 9))]]
        out.append(assoc.AssociationTable(uni, cons,
                                          [(0, k) for k in range(1, 8)]))
    return out


@pytest.mark.parametrize("method", ["greedy", "exact", "milp"])
def test_set_cover_paper_instance(method):
    t, j = _paper_tables()
    tr, jr = tsc.solve(t, method), jsc.solve(j, method)
    assert_same(tr, jr)
    assert len(jr.mask) == 12


@pytest.mark.parametrize("method,profile", [("greedy", PROFILE),
                                            ("exact", 60)])
def test_set_cover_on_the_scene(scenes, method, profile):
    ts, js = scenes
    t = tpipe.run_offline(ts, tpipe.OfflineConfig(profile_frames=profile,
                                                  solver=method))
    j = jpipe.run_offline(js, jpipe.OfflineConfig(profile_frames=profile,
                                                  solver=method))
    assert_same(t.solve, j.solve)
    assert_same(tsc.preprocess(t.table.constraints),
                jsc.preprocess(j.table.constraints))
    if method == "exact":
        assert j.solve.optimal


def test_warm_start_solve(offlines):
    t, j = offlines
    assert_same(tsc.solve_warm(t.table, t.mask), jsc.solve_warm(j.table,
                                                                j.mask))


def test_group_tiles(offlines):
    t, j = offlines
    rng = np.random.default_rng(0)
    grids = [t.cam_grids[c] for c in sorted(t.cam_grids)]
    grids += [rng.random((9, 14)) < p for p in (0.2, 0.5, 0.9)]
    for g in grids:
        tg, jg = tgroup.group_tiles(g), jgroup.group_tiles(g)
        assert_same(tg, jg)
        assert tgroup.groups_cover(g, tg)
    assert_same(t.cam_groups, j.cam_groups)


def test_codec_bytes(offlines):
    t, j = offlines
    cams_t, cams_j = t.universe.cameras, j.universe.cameras
    tc = tcomp.CodecModel.calibrated(cams_t, 10.0)
    jc = jcomp.CodecModel.calibrated(cams_j, 10.0)
    assert_same(tc, jc)
    for ct, cj in zip(cams_t, cams_j):
        c = ct.cam_id
        for n, act in ((10, 1.0), (7, 0.3)):
            assert tc.full_frame_bytes(c, n, act) \
                == jc.full_frame_bytes(c, n, act)
            assert tc.groups_bytes(c, t.cam_groups[c], n, act) \
                == jc.groups_bytes(c, j.cam_groups[c], n, act)
            assert tc.tiles_bytes(c, 17, n, act) == jc.tiles_bytes(c, 17, n,
                                                                   act)
        assert tcomp.fit_boundary_constant(c) == jcomp.fit_boundary_constant(c)
    assert_same(tpipe.segment_network_bytes(cams_t, t.cam_groups, tc, None,
                                            10, 10),
                jpipe.segment_network_bytes(cams_j, j.cam_groups, jc, None,
                                            10, 10))


def test_run_offline_mask_and_grids(offlines):
    t, j = offlines
    assert t.mask == j.mask and len(j.mask) > 0
    assert_same(t.cam_grids, j.cam_grids)
    assert_same(t, j)               # every field but the wall clock
    assert t.fleet_density == j.fleet_density
    for c in t.cam_grids:
        assert t.mask_area_px(c) == j.mask_area_px(c)


def test_full_frame_offline(scenes):
    ts, js = scenes
    assert_same(tpipe.full_frame_offline(ts), jpipe.full_frame_offline(js))


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(coverage_thresh=1.0),
    dict(roi_inference=False, segment_s=2.0),
    dict(transport="simulated"),
])
def test_run_online_metrics(scenes, offlines, cfg):
    (ts, js), (to, jo) = scenes, offlines
    t = tpipe.run_online(ts, to, tpipe.OnlineConfig(**cfg), PROFILE, 200)
    j = jpipe.run_online(js, jo, jpipe.OnlineConfig(**cfg), PROFILE, 200)
    assert_same(t, j)
    assert 0.0 < j.accuracy <= 1.0


def test_run_online_with_reducto_keep_mask(scenes, offlines):
    (ts, js), (to, jo) = scenes, offlines
    tk = treducto.keep_masks_for_threshold(ts, to, 0.01, PROFILE, 200, True)
    jk = jreducto.keep_masks_for_threshold(js, jo, 0.01, PROFILE, 200, True)
    assert_same(tk, jk)
    assert any((~k).any() for k in jk.values())
    for transport in ("analytic", "simulated"):
        t = tpipe.run_online(ts, to, tpipe.OnlineConfig(
            frame_keep=tk, transport=transport), PROFILE, 200)
        j = jpipe.run_online(js, jo, jpipe.OnlineConfig(
            frame_keep=jk, transport=transport), PROFILE, 200)
        assert_same(t, j)
        assert j.frames_reduced > 0


@pytest.mark.parametrize("target", [0.9, 1.0])
def test_tune_and_run(scenes, offlines, target):
    (ts, js), (to, jo) = scenes, offlines
    t = treducto.tune_and_run(ts, to, target, profile=(0, PROFILE),
                              evalw=(PROFILE, 200))
    j = jreducto.tune_and_run(js, jo, target, profile=(0, PROFILE),
                              evalw=(PROFILE, 200))
    assert_same(t, j)
