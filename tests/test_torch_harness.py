"""The port's harnesses -- the regression sentinel (``repro_torch.obs.
sentinel``), the fault layer (``fleet.faults``) and the drift adapter
(``fleet.drift``) -- against the JAX package's, on the CPU.

All three are host numpy copies, so every result is held bit for bit
(``torch_compare.assert_same``; host wall clocks, ``wall_s``, are not
compared): the sentinel's reports and renders on temporary histories and
on the repo's ``BENCH_history.jsonl``; fault schedules, injected frames
(the noise's bits on numpy frames and on CPU tensors), uplink episodes,
per-camera gate activity, liveness sequences, failover re-solves and
degraded coverage; the drift adapter's events, masks and grids after
``run_adaptive_online`` with and without scheduled shrinks, and its
listener reentrancy guard with a plain activation cache as listener."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core import scene as jscene
from repro.fleet import drift as jdrift
from repro.fleet import faults as jfaults
from repro.obs import sentinel as jsent
from repro.serving import detector as jdet
from repro_torch.core import pipeline as tpipe
from repro_torch.core import scene as tscene
from repro_torch.fleet import drift as tdrift
from repro_torch.fleet import faults as tfaults
from repro_torch.obs import sentinel as tsent
from repro_torch.serving import detector as tdet
from torch_compare import assert_same

ROOT = Path(__file__).resolve().parents[1]
HISTORY = ROOT / "BENCH_history.jsonl"


# ---------------------------------------------------------------------------
# sentinel
# ---------------------------------------------------------------------------

def _rec(sha, walls, schema=1, **blocks):
    return {"schema": schema, "ts": "t", "git_sha": sha, "mode": "m",
            "panels": [], "headline_walls": walls, **blocks}


BASE = {"stack.stack_kernel_wall_s": 0.06, "obs.overhead_frac": 0.01}
HISTORIES = {
    "empty": [],
    "one_sha": [_rec("a", BASE), _rec("a", dict(BASE, **{
        "stack.stack_kernel_wall_s": 0.05}))],
    "clean": [_rec(f"s{i}", BASE) for i in range(4)],
    "regression": [_rec(f"s{i}", BASE) for i in range(3)] + [_rec("h", {
        "stack.stack_kernel_wall_s": 0.2, "obs.overhead_frac": 0.2})],
    "improvement": [_rec(f"s{i}", BASE) for i in range(3)] + [_rec("h", {
        "stack.stack_kernel_wall_s": 0.01, "obs.overhead_frac": -0.2})],
    "blocks": [_rec(f"s{i}", BASE, frontier={"p99_s": 1.0 + i},
                    chaos={"mttr_steps": 2.0, "coverage_restored_ratio":
                           1.0}, canvas={"static_canvas_bytes": 0.0})
               for i in range(6)] + [_rec("h", BASE, frontier={
                   "p99_s": 9.0}, chaos={"mttr_steps": 5.0,
                                         "coverage_restored_ratio": 0.5},
                   canvas={"static_canvas_bytes": 8.0})],
    "skipped": ["not json",
                json.dumps({"git_sha": "old", "headline_walls": {}}),
                json.dumps({"schema": "1", "git_sha": "x",
                            "headline_walls": {}}),
                json.dumps({"schema": 1, "git_sha": 3,
                            "headline_walls": {}})]
               + [_rec(f"s{i}", BASE) for i in range(2)],
}


def _write(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write((r if isinstance(r, str) else json.dumps(r)) + "\n")
            f.write("\n")


@pytest.mark.parametrize("name", sorted(HISTORIES) + ["repo", "missing"])
@pytest.mark.parametrize("window", [1, 5])
def test_sentinel_analyze_matches_jax(tmp_path, name, window):
    if name == "repo":
        path = HISTORY
    else:
        path = tmp_path / "history.jsonl"
        if name != "missing":
            _write(path, HISTORIES[name])
    t = tsent.analyze_path(str(path), window=window)
    j = jsent.analyze_path(str(path), window=window)
    assert_same(t, j)
    assert t.render() == j.render()
    assert (t.status, t.has_regression) == (j.status, j.has_regression)
    assert_same(t.regressions, j.regressions)
    assert [f.rel for f in t.findings] == [f.rel for f in j.findings]
    records, warnings = tsent.load_history(str(path))
    assert_same((records, warnings), jsent.load_history(str(path)))
    assert_same(tsent.reduce_by_sha(records), jsent.reduce_by_sha(records))
    if name == "regression":
        assert t.has_regression


def test_sentinel_history_line_not_an_object_raises_in_both(tmp_path):
    """A JSON line that is not an object is neither skipped nor gated:
    the JAX sentinel raises on it, and so does its copy."""
    path = tmp_path / "history.jsonl"
    _write(path, [json.dumps([1, 2]), _rec("a", BASE)])
    for sent in (tsent, jsent):
        with pytest.raises(AttributeError):
            sent.load_history(str(path))


@pytest.mark.parametrize("history", [None, "repo", "missing"])
def test_sentinel_self_test_matches_jax(tmp_path, history):
    path = {None: None, "repo": str(HISTORY),
            "missing": str(tmp_path / "none.jsonl")}[history]
    t = tsent.self_test(path)
    assert t == jsent.self_test(path)
    assert all(v for k, v in t.items() if k != "flagged_metrics")


@pytest.mark.parametrize("metric", [
    "stack.stack_kernel_wall_s", "obs.overhead_frac", "chaos.mttr_steps",
    "mttr_steps", "chaos.detect_latency_steps", "chaos.uncovered_frac_p99",
    "chaos.coverage_restored_ratio", "canvas.static_canvas_bytes",
    "canvas.canvas_bytes_per_step", "frontier.p50_reduction",
    "frontier.accuracy_floor", "slo.deadline_hit_rate"])
def test_sentinel_rules_match_jax(metric):
    t, j = tsent.rule_for(metric), jsent.rule_for(metric)
    assert_same(t, j)
    assert t.describe() == j.describe()


# ---------------------------------------------------------------------------
# faults: schedules, the injector, uplink episodes, liveness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,t0,t1", [("meteor", 0, 1), ("freeze", 5, 5),
                                         ("noise", 3, 2)])
def test_fault_event_validation_matches_jax(kind, t0, t1):
    for fs in (tfaults, jfaults):
        with pytest.raises(ValueError):
            fs.FaultEvent(kind, t0, t1)


@pytest.mark.parametrize("seed,n,kinds", [
    (0, 3, ("blackout", "freeze", "noise")), (7, 5, ("noise",)),
    (11, 8, ("blackout", "freeze", "noise", "uplink", "shard"))])
def test_fault_schedule_random_matches_jax(seed, n, kinds):
    args = (seed, n, 12, 3, 4)
    t = tfaults.FaultSchedule.random(*args, n_shards=2, kinds=kinds)
    j = jfaults.FaultSchedule.random(*args, n_shards=2, kinds=kinds)
    assert_same(t, j)
    for step in range(13):
        assert_same(t.active(step), j.active(step))
        assert_same(t.frame_events(step), j.frame_events(step))
        assert_same(t.shard_starts(step), j.shard_starts(step))
        assert tfaults.FaultInjector(t).blacked_out(step) \
            == jfaults.FaultInjector(j).blacked_out(step)
    assert t.off == j.off is False
    off = tfaults.FaultSchedule(t.events, enabled=False)
    assert off.off and off.active(3) == [] and off.shard_starts(3) == []


def _schedule(fs):
    return fs.FaultSchedule((
        fs.FaultEvent("freeze", 1, 3, gid=0, cam=1),
        fs.FaultEvent("blackout", 0, 2, gid=1, cam=0),
        fs.FaultEvent("noise", 1, 4, gid=1, cam=1, amp=0.7),
        fs.FaultEvent("noise", 2, 3, gid=0, cam=0, amp=1.9),
        fs.FaultEvent("uplink", 1, 3, gid=0, cam=2)))


def _frame_steps(n_steps=5, shape=(6, 5, 3)):
    rng = np.random.default_rng(3)
    return [{g: [rng.normal(size=shape).astype(np.float32)
                 for _ in range(3)] for g in (0, 1)}
            for _ in range(n_steps)]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_injector_matches_jax(as_tensor):
    """The injector's frames, step by step: numpy frames into both
    packages, and the port's on CPU tensors too.  The noise's bits equal
    the JAX injector's; untouched cameras keep their objects."""
    ti = tfaults.FaultInjector(_schedule(tfaults), seed=5)
    ji = jfaults.FaultInjector(_schedule(jfaults), seed=5)
    for step, frames in enumerate(_frame_steps()):
        tin = ({g: [torch.from_numpy(f.copy()) for f in fs]
                for g, fs in frames.items()} if as_tensor else frames)
        tout = ti.apply(step, tin)
        jout = ji.apply(step, frames)
        assert (tout is tin) == (jout is frames)
        faulted = {(e.gid, e.cam)
                   for e in _schedule(tfaults).frame_events(step)}
        for g in frames:
            for c, (a, b) in enumerate(zip(tout[g], jout[g])):
                a = a.numpy() if as_tensor else a
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)
                if (g, c) not in faulted:
                    assert tout[g][c] is tin[g][c]
        assert ti.blacked_out(step) == ji.blacked_out(step)
    assert ti.injected_steps == ji.injected_steps == 4


def test_injector_off_returns_the_same_object():
    frames = _frame_steps(1)[0]
    for schedule in (None, tfaults.FaultSchedule(()), tfaults.FaultSchedule(
            (tfaults.FaultEvent("noise", 0, 2),), enabled=False)):
        inj = tfaults.FaultInjector(schedule)
        assert inj.off and inj.apply(0, frames) is frames
        assert inj.blacked_out(0) == set() and inj.injected_steps == 0


@pytest.mark.parametrize("segment_s", [0.5, 1.5])
def test_uplink_episodes_and_flat_index_match_jax(segment_s):
    grids = {3: [None, None], 0: [None, None, None], 1: [None, None]}
    tflat, jflat = tfaults.flat_cam_index(grids), \
        jfaults.flat_cam_index(grids)
    assert tflat == jflat
    flat = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 0): 3, (1, 1): 4}
    assert_same(tfaults.uplink_episodes(_schedule(tfaults), segment_s, flat),
                jfaults.uplink_episodes(_schedule(jfaults), segment_s, flat))
    assert tfaults.uplink_episodes(None, segment_s, flat) == ()


@pytest.mark.parametrize("threshold", ["zero", "scalar", "per_camera",
                                       "cold"])
def test_per_camera_changed_matches_jax(threshold):
    rng = np.random.default_rng(8)
    n, cams = 40, 5
    cam_of_row = np.sort(rng.integers(0, cams, n))
    stats = rng.integers(0, 200, (n, 8)).astype(np.int32)
    stats[rng.random(n) < 0.5, :] = 0
    thr = {"zero": 0.0, "scalar": 60.0, "cold": 0.0,
           "per_camera": np.array([0.0, 10.0, 50.0, 0.0, 120.0])}[threshold]
    s = None if threshold == "cold" else stats
    t = tfaults.per_camera_changed(s, thr, cam_of_row, cams + 1)
    j = jfaults.per_camera_changed(s, thr, cam_of_row, cams + 1)
    assert_same(t, j)


def _activity(seed, steps=30, cams=4):
    """Per-step changed-tile counts: cameras active, then going quiet at
    staggered steps (one never moves), some waking up again."""
    rng = np.random.default_rng(seed)
    act = rng.integers(1, 6, (steps, cams))
    act[:, 3] = 0
    act[10:16, 0] = 0
    act[12:, 1] = 0
    act[rng.random((steps, cams)) < 0.1] = 0
    return act


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("occupancy", [False, True])
def test_liveness_sequences_match_jax(seed, occupancy):
    cfg = dict(freeze_window=3, min_expected_rate=0.5, min_occupancy=3)
    tm = tfaults.LivenessMonitor(4, tfaults.LivenessConfig(**cfg))
    jm = jfaults.LivenessMonitor(4, jfaults.LivenessConfig(**cfg))
    occ = ({10: 5, 11: 0, 12: 1, 13: 4} if occupancy else None)
    flat_of_cam = ({10: 0, 11: 1, 12: 2, 13: 3} if occupancy else None)
    for step, changed in enumerate(_activity(seed)):
        assert tm.update(step, changed, occ, flat_of_cam) \
            == jm.update(step, changed, occ, flat_of_cam)
        assert tm.confirmed == jm.confirmed
        assert tm.suspect_at == jm.suspect_at
        assert tm.confirmed_at == jm.confirmed_at
        for f in ("streak", "ema_rate", "_quiet_rate"):
            assert_same(getattr(tm, f), getattr(jm, f))
    for cam in range(4):
        for t0 in (0, 10):
            assert tm.detect_latency_steps(cam, t0) \
                == jm.detect_latency_steps(cam, t0)


# ---------------------------------------------------------------------------
# scene fixtures: failover, degraded coverage, drift
# ---------------------------------------------------------------------------

SHIFT = dict(entry_weights=(0.5, 0.5, 0.0, 0.0), shift_at_s=40.0,
             shift_entry_weights=(0.0, 0.0, 0.5, 0.5))


def _scene_pair(**kw):
    scenes = (tscene.generate_scene(tscene.SceneConfig(**kw)),
              jscene.generate_scene(jscene.SceneConfig(**kw)))
    offs = (tpipe.run_offline(scenes[0], tpipe.OfflineConfig(
                profile_frames=300, solver="greedy")),
            jpipe.run_offline(scenes[1], jpipe.OfflineConfig(
                profile_frames=300, solver="greedy")))
    return scenes, offs


@pytest.fixture(scope="module")
def still():
    return _scene_pair(duration_s=50, seed=2)


@pytest.fixture(scope="module")
def shifted():
    return _scene_pair(duration_s=80, seed=2, **SHIFT)


def _warm(pkg, scene, off, t0=300, t1=380):
    ad = pkg.DriftAdapter(scene, off, pkg.DriftConfig(confirm_frames=10 ** 9))
    for t in range(t0, t1):
        ad.observe(t, scene.detections[t])
    return ad


def _assert_adapters_same(ta, ja):
    assert ta.mask == ja.mask
    assert_same(ta.cam_grids, ja.cam_grids)
    assert_same(ta.events, ja.events)
    assert_same(ta.shrink_events, ja.shrink_events)
    assert ta.coverage() == ja.coverage()
    assert ta.occupancy_by_camera() == ja.occupancy_by_camera()
    assert ta.traffic_rate() == ja.traffic_rate()
    assert dict(ta.residual_counts) == dict(ja.residual_counts)


@pytest.mark.parametrize("dead", ["busiest", "first", "all"])
def test_failover_resolve_matches_jax(still, dead):
    (ts, js), (to, jo) = still
    ta, ja = _warm(tdrift, ts, to), _warm(jdrift, js, jo)
    _assert_adapters_same(ta, ja)
    occ = ta.occupancy_by_camera()
    cams = {"busiest": [max(occ, key=occ.get)], "first": [0],
            "all": [c.cam_id for c in ts.cameras]}[dead]
    calls = ([], [])
    ta.add_mask_listener(lambda a: calls[0].append(a))
    ja.add_mask_listener(lambda a: calls[1].append(a))
    te = tfaults.failover_resolve(ta, cams, t=380)
    je = jfaults.failover_resolve(ja, cams, t=380)
    assert_same(te, je)
    _assert_adapters_same(ta, ja)
    assert calls == ([ta], [ja])
    assert ta._last_resolve_t == ja._last_resolve_t == 380


@pytest.mark.parametrize("t", [380, 420, 455])
def test_degraded_coverage_matches_jax(still, t):
    (ts, js), (to, jo) = still
    ta, ja = _warm(tdrift, ts, to), _warm(jdrift, js, jo)
    occ = ta.occupancy_by_camera()
    for dead in ([], [max(occ, key=occ.get)], [0, 1]):
        assert tfaults.degraded_coverage(ta, ts.detections[t], dead) \
            == jfaults.degraded_coverage(ja, js.detections[t], dead)


@pytest.mark.parametrize("shrink", [False, True])
def test_run_adaptive_online_matches_jax(shifted, shrink):
    """A scripted traffic shift (N/S profiling, E/W online): the same
    re-solves (and shrinks) at the same frames, the same masks and grids,
    the same per-frame coverage trajectory; the activation cache the
    port's driver takes as a listener is invalidated on each change."""
    (ts, js), (to, jo) = shifted
    kw = (dict(shrink_enabled=True, shrink_low_rate=100.0,
               shrink_cooldown_frames=150, shrink_profile_frames=250)
          if shrink else {})
    cache = tdet.PackedActivationCache()
    t = tdrift.run_adaptive_online(ts, to, 300, 800, tdrift.DriftConfig(**kw),
                                   listeners=[lambda _: cache.invalidate()])
    j = jdrift.run_adaptive_online(js, jo, 300, 800, jdrift.DriftConfig(**kw))
    # the port's driver wires the cache before the first frame: one
    # invalidation for every mask change
    assert cache.invalidations == t.resolves + t.adapter.shrinks
    for f in ("frame_t", "appearances", "covered"):
        assert_same(getattr(t, f), getattr(j, f))
    _assert_adapters_same(t.adapter, j.adapter)
    assert t.resolves == j.resolves >= 1
    assert t.adapter.shrinks == j.adapter.shrinks
    assert (t.adapter.shrinks > 0) == shrink
    for a, b in ((300, 400), (400, 800), (650, 800)):
        assert t.coverage_between(a, b) == j.coverage_between(a, b)


def test_maybe_shrink_gates_match_jax(still):
    """Shrink's gates (disabled, too early, busy traffic, cooldown), then
    one re-profile at a lull, step for step."""
    (ts, js), (to, jo) = still
    kw = dict(shrink_enabled=True, shrink_low_rate=100.0,
              shrink_profile_frames=200, shrink_cooldown_frames=50)
    ta = tdrift.DriftAdapter(ts, to, tdrift.DriftConfig(**kw))
    ja = jdrift.DriftAdapter(js, jo, jdrift.DriftConfig(**kw))
    got = []
    for t in (100, 300, 320, 360, 420):
        ta.observe(t, ts.detections[t])
        ja.observe(t, js.detections[t])
        got.append((ta.maybe_shrink(t, ts), ja.maybe_shrink(t, js)))
        _assert_adapters_same(ta, ja)
    assert all(a == b for a, b in got)
    assert [a for a, _ in got][:1] == [False]     # t < profile frames
    off = tdrift.DriftAdapter(ts, to, tdrift.DriftConfig())
    assert not off.maybe_shrink(400, ts) and not off.shrink_events


@pytest.mark.parametrize("reenter", [False, True])
def test_mask_listener_invalidates_a_plain_cache_once(still, reenter):
    """The activation cache as a mask listener (``lambda _:
    cache.invalidate()``): a failover and a drift re-solve invalidate it
    once each, also when another listener re-enters the fan-out, as the
    JAX adapter and cache do."""
    (ts, js), (to, jo) = still
    counts = []
    for pkg, fs, det, scene, off in (
            (tdrift, tfaults, tdet, ts, to), (jdrift, jfaults, jdet, js, jo)):
        ad = _warm(pkg, scene, off, t1=340)
        cache = det.PackedActivationCache()
        ad.add_mask_listener(lambda _, c=cache: c.invalidate())
        if reenter:
            ad.add_mask_listener(lambda a: a._notify_mask_update())
        ad._notify_mask_update()
        fs.failover_resolve(ad, [0], t=340)
        ad._resolve(341)
        assert not ad._notifying
        counts.append((cache.invalidations, ad.resolves, len(ad.mask)))
    assert counts[0] == counts[1]
    assert counts[0][0] == 3
