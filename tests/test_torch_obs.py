"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), and its spans and metrics on the ported paths.

Span timestamps differ between the two packages; their structure must
not: each comparison reduces a span to its name, its args, its thread's
role (the test's thread, another host thread, or a named track) and the
name of the span it nests in on the same thread.  Metric values that
time a run (``step_wall_s``) are compared by count; every other metric
value must be equal.  The JAX package's fleet steps and former run under
the ``jax_oracle`` fixture (``torch_jax_oracle.py``); its serving engine
runs live at internvl2-26b's SMOKE size, as in ``test_torch_serving.py``.
With obs on, the port's steps must give the same outputs, bitwise, and
the same dispatch counts as with obs off, and ``kernel_counts()`` must
equal ``count_kernels``."""
import collections
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.registry import get_config as jget_config
from repro.core import pipeline as jpipe, scene as jscene
from repro.fleet import runtime as jrt
from repro.kernels import ops as jops
from repro.models.params import init_params as jinit_params
from repro.net import batcher as jbatch
from repro.serving import detector as jdet
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import obs as tobs
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core import pipeline as tpipe, scene as tscene
from repro_torch.fleet import runtime as trt
from repro_torch.kernels import ops as tops
from repro_torch.models.params import params_from_numpy
from repro_torch.net import batcher as tbatch
from repro_torch.serving import detector as tdet
from repro_torch.serving.engine import Request, ServingEngine
from torch_jax_oracle import detector_pair
from torch_jax_oracle import jax_oracle  # noqa: F401  (fixture)

T = 8
TIMED = {"step_wall_s"}          # metric families whose values are times


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test leaves both packages' observability off and empty."""
    for o in (tobs, jobs):
        o.configure(enabled=False, reset=True)
    yield
    for o in (tobs, jobs):
        o.configure(enabled=False, reset=True)


def _spans(o):
    """The recorded spans as (name, args, thread role, parent name), in
    recording order; the parent is the innermost span on the same thread
    whose interval holds this one."""
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
                   if j != i and tj == tid and s <= t0
                   and t0 + dur <= s + d]
        parent = min(parents)[1] if parents else None
        out.append((name, args, role, parent))
    return out


def _snapshot(o, families=None):
    snap = o.metrics.REGISTRY.snapshot()
    out = {}
    for name, fam in snap.items():
        if families is not None and name not in families:
            continue
        if not fam["values"]:
            continue
        vals = fam["values"]
        if name in TIMED:
            vals = [(v["labels"], v["value"]["count"]) for v in vals]
        out[name] = (fam["type"], fam["labels"], vals)
    return out


# ---------------------------------------------------------------------------
# the span API and its export
# ---------------------------------------------------------------------------

def _span_script(o):
    with o.enabled():
        with o.trace.span("outer", step=1, n=np.int64(3)) as sp:
            with o.trace.span("inner", k="a"):
                pass
            h = o.trace.begin("device_compute", step=0)
            sp.set(done=True)
        with o.trace.span("after"):
            pass
        h.end(rows=4)
        h.end(rows=5)                      # a second end is a no-op
        t = threading.Thread(
            target=lambda: o.trace.span("worker", w=1).__enter__().__exit__(),
            name="obs-worker")
        t.start()
        t.join()
    with o.trace.span("off"):              # disabled: records nothing
        pass


def test_disabled_by_default_records_nothing():
    assert not tobs.is_enabled()
    with tobs.trace.span("x", a=1) as sp:
        sp.set(b=2)
    tobs.trace.begin("dev").end()
    assert tobs.trace.span_count() == 0
    assert tobs.trace.span("x") is tobs.trace.NULL_SPAN
    c = tobs.metrics.counter("t_torch_disabled")
    c.inc(5)
    assert c.total() == 0


def test_span_records_match_jax():
    for o in (tobs, jobs):
        _span_script(o)
    t, j = _spans(tobs), _spans(jobs)
    assert t == j
    assert [s[0] for s in t] == ["inner", "outer", "after",
                                 "device_compute", "worker"]
    assert t[0][3] == "outer" and t[3][2] == "track:device"
    assert t[4][2] == "other"


def test_chrome_trace_structure_matches_jax(tmp_path):
    docs = []
    for o, name in ((tobs, "t.json"), (jobs, "j.json")):
        _span_script(o)
        path = tmp_path / name
        doc = o.export.chrome_trace(str(path))
        assert json.loads(path.read_text()) == doc
        docs.append(doc)

    def shape(doc, o):
        names = o.trace.thread_names()
        evs = doc["traceEvents"]
        meta = [e for e in evs if e["ph"] == "M"
                and e["name"] == "process_name"]
        xs = [(e["name"], e["cat"], e["args"],
               "track" if e["tid"] >= o.trace.TRACK_TID_BASE
               else names[e["tid"]] == threading.current_thread().name)
              for e in evs if e["ph"] == "X"]
        assert all(set(e) == {"ph", "cat", "pid", "tid", "ts", "dur",
                              "name", "args"}
                   for e in evs if e["ph"] == "X")
        return [(m["args"], m["tid"]) for m in meta], xs, \
            doc["displayTimeUnit"]
    assert shape(docs[0], tobs) == shape(docs[1], jobs)


def test_enabled_is_scoped_and_configure_resets():
    for o in (tobs, jobs):
        with o.enabled():
            assert o.is_enabled()
            with o.trace.span("s"):
                pass
            o.metrics.counter("t_scoped").inc(2)
        assert not o.is_enabled()
        assert o.trace.span_count() == 1
        assert o.configure(reset=True) is False
        assert o.trace.span_count() == 0
        assert o.metrics.counter("t_scoped").total() == 0


# ---------------------------------------------------------------------------
# the typed registry
# ---------------------------------------------------------------------------

def _registry_script(o):
    m = o.metrics
    c = m.counter("t_reg_c", "help", labels=("cam", "kind"))
    g = m.gauge("t_reg_g")
    h = m.histogram("t_reg_h", labels=("path",))
    errors = []
    for bad in (lambda: m.gauge("t_reg_c", labels=("cam", "kind")),
                lambda: m.counter("t_reg_c", labels=("cam",))):
        with pytest.raises(ValueError) as e:
            bad()
        errors.append(str(e.value))
    assert m.counter("t_reg_c", labels=("cam", "kind")) is c
    with o.enabled():
        c.inc(2, cam="c0", kind="a")
        c.inc(3.5, cam="c1", kind="a")
        with pytest.raises(ValueError) as e:
            c.inc(1, cam="c0")
        errors.append(str(e.value))
        g.set(7)
        g.set(np.float32(2.5))
        for v in (1.0, 3.0, 10.0, 0.5):
            h.observe(v, path="p")
    vals = (c.value(cam="c0", kind="a"), c.total(), g.value(),
            h.count(path="p"), h.percentile(50, path="p"),
            h.percentile(99, path="p"))
    snap = _snapshot(o, {"t_reg_c", "t_reg_g", "t_reg_h"})
    full = m.REGISTRY.snapshot()
    json.dumps(full)
    m.REGISTRY.reset()
    after = (c.total(), g.value(), h.count(path="p"))
    return errors, vals, snap, after, "t_reg_c" in m.REGISTRY.names()


def test_registry_matches_jax():
    t, j = _registry_script(tobs), _registry_script(jobs)
    assert t == j
    assert t[3] == (0, 0.0, 0) and t[4]


def test_core_families_match_jax():
    """The instrument families the runtimes bump, declared alike."""
    t, j = tobs.metrics.REGISTRY, jobs.metrics.REGISTRY
    core = [n for n in j.names() if not n.startswith("t_")]
    assert [n for n in t.names() if not n.startswith("t_")] == core
    for n in core:
        a, b = t.get(n), j.get(n)
        assert (a.kind, a.labelnames) == (b.kind, b.labelnames), n


# ---------------------------------------------------------------------------
# the kernel-dispatch mirror
# ---------------------------------------------------------------------------

def test_kernel_names_have_one_home():
    assert tops.KERNEL_NAMES is tobs.metrics.KERNEL_NAMES
    assert tobs.metrics.KERNEL_NAMES == jobs.metrics.KERNEL_NAMES


def test_dispatch_mirror_and_thread_isolation():
    """With obs on, every counted dispatch also bumps
    ``kernel_dispatches``; a dispatch made from another thread counts
    there and in ``KERNEL_COUNTS`` but never in this thread's region, as
    in the JAX package."""
    got = []
    for o, ops in ((tobs, tops), (jobs, jops)):
        with o.enabled():
            with ops.count_kernels() as region:
                ops.record_dispatch("roi_conv_entry")
                ops.record_dispatch("sbnet_scatter_fleet", 2)
                th = threading.Thread(
                    target=lambda: ops.record_dispatch("tile_delta_gate"))
                th.start()
                th.join()
            mirror = o.metrics.kernel_counts()
        ops.record_dispatch("roi_conv_stack")      # obs off: no mirror
        got.append((dict(region), mirror, o.metrics.kernel_counts()))
    assert got[0] == got[1]
    assert got[0][0] == {"roi_conv_entry": 1, "sbnet_scatter_fleet": 2}
    assert got[0][1] == {"roi_conv_entry": 1, "sbnet_scatter_fleet": 2,
                         "tile_delta_gate": 1}


# ---------------------------------------------------------------------------
# the fleet steps' spans and metrics
# ---------------------------------------------------------------------------

def _fleet_inputs():
    rng = np.random.default_rng(1)
    grids = {0: [rng.random((3, 4)) < 0.6, rng.random((3, 3)) < 0.7],
             1: [rng.random((2, 4)) < 0.8]}
    for gs in grids.values():
        for g in gs:
            g[1, 1] = True
    f0 = {g: [rng.normal(size=(a.shape[0] * T, a.shape[1] * T, 3))
              .astype(np.float32) for a in gs] for g, gs in grids.items()}
    f1 = {g: [f.copy() for f in fs] for g, fs in f0.items()}
    f1[0][1][2:7, 3:9] += 1.0                      # one camera moves
    return grids, [f0, f1, f1]                     # cold, warm, static


def _run_steps(rt, det, grids, frames, cache, to_dev):
    outs, counts = [], collections.Counter()
    o, c = rt.fleet_inference_step(det, to_dev(frames[0]), grids)
    outs.append(o)
    counts += c
    for f in frames:
        o, c, _ = rt.fleet_reuse_step(det, to_dev(f), grids, cache)
        outs.append({g: [np.array(h) for h in hs] for g, hs in o.items()})
        counts += c
    return outs, counts


def _torch_frames(frames):
    return {g: [torch.as_tensor(f) for f in fs] for g, fs in frames.items()}


def _jax_frames(frames):
    return {g: [jnp.asarray(f) for f in fs] for g, fs in frames.items()}


def test_fleet_steps_record_spans_and_metrics_as_jax(jax_oracle):
    jd, td = detector_pair(channels=(4, 6))
    grids, frames = _fleet_inputs()
    # the port with obs off, then on: the same bits and dispatches
    off, c_off = _run_steps(trt, td, grids, frames,
                            tdet.PackedActivationCache(), _torch_frames)
    with tobs.enabled(), tops.count_kernels() as region:
        on, c_on = _run_steps(trt, td, grids, frames,
                              tdet.PackedActivationCache(), _torch_frames)
    assert c_on == c_off == region
    assert tobs.metrics.kernel_counts() == dict(region)
    for a, b in zip(off, on):
        for g in a:
            for x, y in zip(a[g], b[g]):
                assert np.array_equal(np.asarray(x), np.asarray(y))
    assert not _spans(jobs)
    # the JAX package's steps under the oracle, obs on
    with jobs.enabled():
        _, jc = _run_steps(jrt, jd, grids, frames,
                           jdet.PackedActivationCache(), _jax_frames)
    assert jc == c_on
    assert _spans(tobs) == _spans(jobs)
    assert [s[0] for s in _spans(tobs)] == [
        "fleet_step"] + ["fleet_reuse_step"] * 3
    assert _snapshot(tobs) == _snapshot(jobs)
    assert tobs.metrics.TILES.value(kind="computed") > 0


# ---------------------------------------------------------------------------
# the transport and the deadline former
# ---------------------------------------------------------------------------

def test_transport_records_as_jax():
    got = []
    for o, scene, pipe in ((tobs, tscene, tpipe), (jobs, jscene, jpipe)):
        s = scene.generate_scene(scene.SceneConfig(duration_s=10, seed=2))
        off = pipe.run_offline(s, pipe.OfflineConfig(profile_frames=50,
                                                     solver="greedy"))
        cfg = pipe.OnlineConfig(transport="simulated")
        with o.enabled():
            pipe.online_system_metrics(s.cameras, off, cfg, 10.0, 50)
        got.append((_spans(o), _snapshot(o)))
    assert got[0] == got[1]
    assert got[0][0][0][0] == "transport"
    assert "transport_bytes" in got[0][1]


def test_former_releases_record_as_jax(jax_oracle):
    jd, td = detector_pair(channels=(4, 6))
    rng = np.random.default_rng(3)
    grids = [rng.random((3, 4)) < 0.6 for _ in range(2)]
    for g in grids:
        g[1, 1] = True
    frames = [rng.normal(size=(3 * T, 4 * T, 3)).astype(np.float32)
              for _ in range(4)]
    for o, batcher, det, cast in ((tobs, tbatch, td, np.asarray),
                                  (jobs, jbatch, jd, jnp.asarray)):
        former = batcher.DeadlineGroupFormer(det, [0, 1], deadline_s=0.5)
        mon = batcher.HeartbeatMonitor([0, 1])
        with o.enabled():
            former.offer(0.0, 0, cast(frames[0]), grids[0])
            former.offer(0.1, 1, cast(frames[1]), grids[1])   # full
            former.offer(1.0, 0, cast(frames[2]), grids[0])
            former.poll(1.6)                                   # deadline
            former.force_release(2.0)                          # empty
            mon.poll(3.5)
            mon.beat(4.0, 0)
            mon.poll(6.0)
    assert _spans(tobs) == _spans(jobs)
    assert [s[0] for s in _spans(tobs)] == ["release"] * 3
    assert _snapshot(tobs) == _snapshot(jobs)
    assert tobs.metrics.HEARTBEAT_EVENTS.value(event="dead") == 2


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def test_engine_records_as_jax():
    F32 = dict(dtype="float32", kv_cache_dtype="float32")
    jcfg = jget_config("internvl2-26b", smoke=True).replace(**F32)
    cfg = get_config("internvl2-26b", smoke=True).replace(**F32)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    je = JEngine(jcfg, JServeConfig(max_batch=2, roi_sparsity=True), jp)
    te = ServingEngine(cfg, ServeConfig(max_batch=2, roi_sparsity=True), tp)
    rng = np.random.default_rng(4)
    reqs = []
    for i in range(4):
        reqs.append(dict(
            rid=i, tokens=rng.standard_normal(
                (40, cfg.frontend_dim)).astype(np.float32),
            keep=rng.random(40) < 0.6, max_new_tokens=2, group=i % 2,
            arrival_s=0.3 * i))
    toks = []
    for o, eng, R in ((tobs, te, Request), (jobs, je, JRequest)):
        with o.enabled():
            a = eng.serve([R(**r) for r in reqs[:3]], greedy_steps=2)
            b, rep = eng.serve_deadline([R(**r) for r in reqs],
                                        group_sizes={0: 2, 1: 3},
                                        deadline_s=0.5, greedy_steps=2)
        toks.append(({k: np.asarray(v).tolist() for k, v in a.items()},
                     {k: np.asarray(v).tolist() for k, v in b.items()},
                     rep.deadline_flushes, rep.straggler_requests))
    assert toks[0] == toks[1]
    assert _spans(tobs) == _spans(jobs)
    names = [s[0] for s in _spans(tobs)]
    assert names.count("serve") == names.count("serve_deadline") == 1
    assert names.count("serve_flush") >= 4
    assert _snapshot(tobs) == _snapshot(jobs)
    assert tobs.metrics.SERVE_EVENTS.value(event="request") == 7


# ---------------------------------------------------------------------------
# the SLO panels
# ---------------------------------------------------------------------------

def _transport(batcher):
    lat = np.linspace(0.1, 1.0, 100)
    parts = {k: lat / 5 for k in ("wait", "encode", "network", "batching",
                                  "inference")}
    return batcher.TransportStats(
        latency_s=lat, parts=parts, frame_cam=np.zeros(100, np.int64),
        bytes_total=6e6, bytes_base=1e7, frames_sent=np.full(4, 25, np.int64),
        straggler_frames=5, deadline_hits=3, quality_min=0.8,
        shed_halo_bytes=3e6, shed_body_bytes=1e6)


class _Sharded:                     # ShardedReuseStats-shaped
    total_tiles, raw_changed, computed, launched = 10, 4, 6, 8
    cold_shards = 1


def test_slo_panels_match_jax():
    docs = []
    for o, det, batcher in ((tobs, tdet, tbatch), (jobs, jdet, jbatch)):
        stats = [det.ReuseStats(100, 20 + i, 25 + i, 30 + i, 32,
                                cold=(i == 0), canvas_bytes=512 * i)
                 for i in range(3)]
        steps = [o.slo.StepReport.from_reuse(
            i, 0.1 + 0.01 * i, {"roi_conv_entry": 1}, s)
            for i, s in enumerate(stats)]
        steps.append(o.slo.StepReport.from_reuse(3, 0.5, {}, _Sharded()))
        cache = det.PackedActivationCache()
        cache.steps, cache.cold_steps = 4, 1
        cache.launched_tiles, cache.total_tiles = 90, 400
        rep = o.slo.FleetSLOReport.build(
            steps=steps, transport=_transport(batcher), accuracy_floor=0.97,
            accuracy_mean=0.99, cache=cache, n_windows=30,
            uncovered_frac=[0.0, 0.1, 0.0])
        docs.append(rep.to_dict())
    assert docs[0] == docs[1]
    json.dumps(docs[0])
    assert docs[0]["n_steps"] == 4 and docs[0]["steps"][3]["cold"]
