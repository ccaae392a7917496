"""The port's load generator, fleet drivers, serve leg and camera stream
pipeline (``repro_torch.obs.loadgen``, ``fleet.faults.drive_chaos``,
``data.streams``) against the JAX package's, on the CPU.

The grid and trace builders, the fault and link specs and the transport
window are host numpy copies, held bit for bit
(``torch_compare.assert_same``).  The drivers run the JAX package's
detector under the ``jax_oracle`` fixture (``torch_jax_oracle.py``):
reports (all but their host walls), dispatch counters and detections are
equal, head maps within 1e-5 (the f32 bar of ``tests/test_fleet.py``),
and ``run_point``'s result equal except its timed fields, which are
compared by presence.  The serve leg runs the port's engine against the
JAX engine at internvl2-26b SMOKE in float32."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget_config
from repro.core import pipeline as jpipe
from repro.core.scene import SceneConfig as JSceneConfig
from repro.core.scene import generate_scene as jgenerate_scene
from repro.data.streams import CameraStreamPipeline as JPipeline
from repro.fleet import faults as jfaults
from repro.models.params import init_params as jinit_params
from repro.obs import loadgen as jlg
from repro.serving import detector as jdet
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core import pipeline as tpipe
from repro_torch.core.scene import SceneConfig, generate_scene
from repro_torch.data import CameraStreamPipeline
from repro_torch.fleet import faults as tfaults
from repro_torch.models.params import params_from_numpy
from repro_torch.obs import loadgen as tlg
from repro_torch.serving import detector as tdet
from repro_torch.serving.engine import ServingEngine
from torch_compare import assert_same
from torch_jax_oracle import detector_pair
from torch_jax_oracle import jax_oracle  # noqa: F401  (fixture)

CHANNELS = (6, 8)
QSTEP = 0.125        # the gate's quantizer step at unit-scale frames
# the timed fields of run_point's result and of its SLO panel
TIMED = {"drive_wall_s", "step_wall_p50_s", "step_wall_p99_s"}


def _cfgs(**kw):
    return (tlg.LoadgenConfig(channels=CHANNELS, **kw),
            jlg.LoadgenConfig(channels=CHANNELS, **kw))


# ---------------------------------------------------------------------------
# the host builders, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [(1, 2), (2, 3), (3, 1)])
@pytest.mark.parametrize("static_fraction", [0.0, 0.75, 1.0])
def test_grids_and_frame_trace_bit_exact(scale, static_fraction):
    tc, jc = _cfgs(steps=4)
    tg, jg = tlg.make_grids(tc, *scale), jlg.make_grids(jc, *scale)
    assert_same(tg, jg)
    assert_same(tlg.make_frame_trace(tc, tg, static_fraction),
                jlg.make_frame_trace(jc, jg, static_fraction))
    assert_same(tlg.make_frame_trace(tc, tg, static_fraction, steps=2,
                                     seed_offset=5),
                jlg.make_frame_trace(jc, jg, static_fraction, steps=2,
                                     seed_offset=5))


@pytest.mark.parametrize("spec", ["none", "random:3:0", "random:5:7",
                                  "freeze:0.1@1-3", "noise:1.0@0-2",
                                  "blackout:0.0@2-5"])
def test_faults_for_bit_exact(spec):
    tc, jc = _cfgs()
    t = tlg.faults_for(tc, tlg.SweepPoint(2, 3, faults=spec))
    j = jlg.faults_for(jc, jlg.SweepPoint(2, 3, faults=spec))
    assert (t is None) == (j is None) == (spec == "none")
    assert_same(t, j)


@pytest.mark.parametrize("congestion", ["none", "episode:0.5",
                                        "episode:0.1", "trace:lte_uplink"])
def test_link_for_bit_exact(congestion):
    tc, jc = _cfgs()
    assert_same(tlg.link_for(tc, congestion), jlg.link_for(jc, congestion))
    assert tlg.SweepPoint(1, 1, congestion).severity \
        == jlg.SweepPoint(1, 1, congestion).severity


@pytest.mark.parametrize("congestion", ["none", "episode:0.5",
                                        "trace:lte_uplink"])
@pytest.mark.parametrize("static_fraction", [0.5, 0.9])
def test_transport_window_bit_exact(congestion, static_fraction):
    tc, jc = _cfgs()
    assert_same(tlg.transport_window(tc, 6, congestion, static_fraction),
                jlg.transport_window(jc, 6, congestion, static_fraction))


def test_link_for_rejects_unknown_spec():
    tc, jc = _cfgs()
    for lg, c in ((tlg, tc), (jlg, jc)):
        with pytest.raises(ValueError):
            lg.link_for(c, "storm:3")


def test_sweep_point_to_dict():
    p = ("episode:0.5", 0.75, "random:3:0")
    assert tlg.SweepPoint(4, 5, *p).to_dict() \
        == jlg.SweepPoint(4, 5, *p).to_dict()


# ---------------------------------------------------------------------------
# the drivers, the JAX package's detector under the jax_oracle fixture
# ---------------------------------------------------------------------------

def _fixture(steps=4, scale=(2, 2), static_fraction=0.5):
    tc, jc = _cfgs(steps=steps)
    jd, td = detector_pair(0, channels=CHANNELS, tile=tc.tile)
    grids = tlg.make_grids(tc, *scale)
    frames = tlg.make_frame_trace(tc, grids, static_fraction)
    return tc, jc, td, jd, grids, frames


def _assert_maps_close(t_list, j_list):
    assert len(t_list) == len(j_list)
    for t_outs, j_outs in zip(t_list, j_list):
        assert list(t_outs) == list(j_outs)
        for g in j_outs:
            for a, b in zip(t_outs[g], j_outs[g]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-5, rtol=0)


@pytest.mark.parametrize("threshold", [0.0, 40.0])
def test_drive_fleet_matches_jax(jax_oracle, threshold):
    _, _, td, jd, grids, frames = _fixture()
    t_rep, t_out, t_total = tlg.drive_fleet(
        td, frames, grids, tdet.PackedActivationCache(), threshold, QSTEP,
        keep_outputs=True)
    j_rep, j_out, j_total = jlg.drive_fleet(
        jd, frames, grids, jdet.PackedActivationCache(), threshold, QSTEP,
        keep_outputs=True)
    assert t_total == j_total
    assert_same(t_rep, j_rep)
    _assert_maps_close(t_out, j_out)
    assert tlg.accuracy_vs_exact(td, frames, grids, t_out) \
        == jlg.accuracy_vs_exact(jd, frames, grids, j_out)


def test_drive_fleet_adds_no_dispatches():
    """``drive_fleet``'s dispatch counter is an inline ``fleet_reuse_step``
    loop's, step kind for step kind."""
    from repro_torch.fleet.runtime import fleet_reuse_step
    _, _, td, _, grids, frames = _fixture()
    cache, inline = tdet.PackedActivationCache(), []
    for fs in frames:
        inline.append(fleet_reuse_step(td, fs, grids, cache, 0.0, QSTEP)[1])
    reports, _, total = tlg.drive_fleet(td, frames, grids,
                                        tdet.PackedActivationCache(), 0.0,
                                        QSTEP)
    assert [r.dispatches for r in reports] == [dict(c) for c in inline]
    assert total == sum(inline, type(total)())


def test_kept_maps_outlive_the_step():
    """The maps a fleet step returns are views of the cache's canvas; the
    drivers keep copies, so step 0's kept maps are step 0's maps after
    two more steps whose content changes."""
    tc, _ = _cfgs(steps=3)
    det = tdet.RoIDetector(tdet.DetectorConfig(channels=CHANNELS,
                                               tile=tc.tile), device="cpu")
    grids = tlg.make_grids(tc, 2, 2)
    frames = tlg.make_frame_trace(tc, grids, 0.0)
    cold = [det.superlaunch_forward(f, grids) for f in frames]
    cache = tdet.PackedActivationCache()
    _, kept, _ = tlg.drive_fleet(det, frames, grids, cache,
                                 keep_outputs=True)
    _, kept_chaos, _, _ = tfaults.drive_chaos(
        det, frames, grids, tdet.PackedActivationCache(),
        keep_outputs=True)
    canvas_moved = False
    for got, want in zip(kept, cold):
        for g in want:
            for c, (a, b) in enumerate(zip(got[g], want[g])):
                assert torch.equal(a, b)
                assert a.data_ptr() != cache.canvas.data_ptr()
                canvas_moved |= not torch.equal(
                    cache.canvas[len(grids[0]) * g + c, :b.shape[0],
                                 :b.shape[1]], cold[0][g][c])
    assert canvas_moved            # the trace's content does change
    for got, want in zip(kept_chaos, cold):
        for g in want:
            assert all(torch.equal(a, b) for a, b in zip(got[g], want[g]))


def _schedule(fs):
    return fs.FaultSchedule((
        fs.FaultEvent("freeze", 1, 4, gid=0, cam=1),
        fs.FaultEvent("noise", 1, 3, gid=1, cam=0, amp=1.5),
        fs.FaultEvent("blackout", 2, 6, gid=1, cam=1)))


@pytest.mark.parametrize("scripted", [False, True])
def test_drive_chaos_matches_jax(jax_oracle, scripted):
    _, _, td, jd, grids, frames = _fixture(steps=6, static_fraction=0.0)
    liveness = dict(freeze_window=2, min_expected_rate=0.1)
    t_mon = tfaults.LivenessMonitor(4, tfaults.LivenessConfig(**liveness))
    j_mon = jfaults.LivenessMonitor(4, jfaults.LivenessConfig(**liveness))
    t = tfaults.drive_chaos(
        td, frames, grids, tdet.PackedActivationCache(), 0.0, QSTEP,
        schedule=_schedule(tfaults) if scripted else None, monitor=t_mon,
        keep_outputs=True, seed=3)
    j = jfaults.drive_chaos(
        jd, frames, grids, jdet.PackedActivationCache(), 0.0, QSTEP,
        schedule=_schedule(jfaults) if scripted else None, monitor=j_mon,
        keep_outputs=True, seed=3)
    assert_same(t[0], j[0])
    _assert_maps_close(t[1], j[1])
    assert t[2] == j[2] and t[3] == j[3]
    assert t_mon.confirmed == j_mon.confirmed
    assert t_mon.suspect_at == j_mon.suspect_at
    np.testing.assert_array_equal(t_mon.ema_rate, j_mon.ema_rate)
    if not scripted:
        # no schedule: drive_fleet, bit for bit and count for count
        _, ref_out, ref_total = tlg.drive_fleet(
            td, frames, grids, tdet.PackedActivationCache(), 0.0, QSTEP,
            keep_outputs=True)
        assert t[2] == ref_total
        for a, b in zip(t[1], ref_out):
            for g in a:
                assert all(torch.equal(x, y) for x, y in zip(a[g], b[g]))


POINTS = [(2, 2, "none", 0.5, "none"),
          (2, 2, "episode:0.5", 0.75, "random:3:0"),
          (1, 3, "trace:lte_uplink", 0.9, "freeze:0.1@1-3")]


@pytest.mark.parametrize("point", POINTS)
def test_run_point_matches_jax(jax_oracle, point):
    tc, jc, td, jd, _, _ = _fixture()
    t = tlg.run_point(tc, td, tlg.SweepPoint(*point))
    j = jlg.run_point(jc, jd, jlg.SweepPoint(*point))
    for res in (t, j):
        assert TIMED & set(res) | TIMED & set(res["slo"]) == TIMED
        for k in TIMED:
            res.pop(k, None)
            res["slo"].pop(k, None)
        assert all(s.pop("wall_s") > 0 for s in res["slo"]["steps"])
    assert len(t["slo"]["steps"]) == tc.steps
    assert_same(t, j)


# ---------------------------------------------------------------------------
# the serve leg: internvl2-26b SMOKE in float32
# ---------------------------------------------------------------------------

F32 = dict(dtype="float32", kv_cache_dtype="float32")


def _engines(family):
    jcfg = jget_config("internvl2-26b", smoke=True).replace(**F32)
    cfg = get_config("internvl2-26b", smoke=True).replace(**F32)
    if family == "dense":
        jcfg, cfg = jcfg.replace(family="dense"), cfg.replace(family="dense")
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    scfg = dict(max_batch=4, roi_sparsity=True)
    return (JEngine(jcfg, JServeConfig(**scfg), jp),
            ServingEngine(cfg, ServeConfig(**scfg), tp))


SERVE = dict(n_requests=6, n_groups=2, group_size=3, deadline_s=0.5,
             prompt_len=32, greedy_steps=2, seed=0)


@pytest.mark.parametrize("rate_hz", [4.0, 32.0])
def test_drive_serve_matches_jax_on_token_prompts(rate_hz):
    """Token-id prompts, as the JAX package sends them: the vlm config
    made a text model, so the JAX ``drive_serve`` runs as it is."""
    je, te = _engines("dense")
    t, j = (lg.drive_serve(e, rate_hz, **SERVE)
            for lg, e in ((tlg, te), (jlg, je)))
    assert t.pop("serve_wall_s") > 0 and j.pop("serve_wall_s") > 0
    assert_same(t, j)


@pytest.mark.parametrize("rate_hz", [4.0, 32.0])
def test_drive_serve_vlm_matches_jax_engine(rate_hz):
    """Patch-stream prompts on the vlm: the same requests through the
    JAX engine's ``serve_deadline`` give the same tokens, flushes,
    stragglers and waits as the port's panel reports."""
    je, te = _engines("vlm")
    t = tlg.drive_serve(te, rate_hz, **SERVE)
    reqs = tlg.serve_requests(te.cfg, rate_hz, SERVE["n_requests"],
                              SERVE["n_groups"], SERVE["prompt_len"],
                              SERVE["greedy_steps"], SERVE["seed"])
    jreqs = [JRequest(**dataclasses.asdict(r)) for r in reqs]
    tres, trep = te.serve_deadline(
        reqs, {g: SERVE["group_size"] for g in range(SERVE["n_groups"])},
        SERVE["deadline_s"], SERVE["greedy_steps"])
    jres, jrep = je.serve_deadline(
        jreqs, {g: SERVE["group_size"] for g in range(SERVE["n_groups"])},
        SERVE["deadline_s"], SERVE["greedy_steps"])
    assert sorted(tres) == sorted(jres) == list(range(SERVE["n_requests"]))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]))
    assert_same(trep, jrep)
    waits = np.asarray([jrep.wait_s(r) for r in jreqs])
    assert t["served"] == len(jres)
    assert (t["complete_flushes"], t["deadline_flushes"],
            t["straggler_requests"]) == (jrep.complete_flushes,
                                         jrep.deadline_flushes,
                                         jrep.straggler_requests)
    assert (t["wait_p50_s"], t["wait_p99_s"], t["wait_mean_s"]) == (
        float(np.percentile(waits, 50)), float(np.percentile(waits, 99)),
        float(waits.mean()))


# ---------------------------------------------------------------------------
# the camera stream pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream_pair():
    ts = generate_scene(SceneConfig(duration_s=30, seed=4))
    js = jgenerate_scene(JSceneConfig(duration_s=30, seed=4))
    to = tpipe.run_offline(ts, tpipe.OfflineConfig(profile_frames=150,
                                                   solver="greedy"))
    jo = jpipe.run_offline(js, jpipe.OfflineConfig(profile_frames=150,
                                                   solver="greedy"))
    return (ts, to), (js, jo)


@pytest.mark.parametrize("seed,fps", [(0, 10), (5, 4)])
def test_stream_pipeline_bit_exact(stream_pair, seed, fps):
    (ts, to), (js, jo) = stream_pair
    tp = CameraStreamPipeline(ts, to, patch_dim=16, frames_per_segment=fps,
                              seed=seed)
    jp = JPipeline(js, jo, patch_dim=16, frames_per_segment=fps, seed=seed)
    tsegs, jsegs = list(tp.segments(150, 172)), list(jp.segments(150, 172))
    assert_same(tsegs, jsegs)
    for a, b in zip(tsegs, jsegs):
        assert a.keep_fraction == b.keep_fraction
        for f in range(a.t1 - a.t0):
            assert_same(tp.fleet_tokens(a, f), jp.fleet_tokens(b, f))
    assert [tp.num_patches(c.cam_id) for c in ts.cameras] \
        == [jp.num_patches(c.cam_id) for c in js.cameras]
