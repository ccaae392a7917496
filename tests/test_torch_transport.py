"""The port's streaming runtime (``repro_torch.net.links`` and
``.batcher``) against the JAX package's, on the same seeds.

The link models, the closed-form FIFO, ``simulate_transport`` and the
heartbeat monitor are numpy copies: held bit for bit
(``torch_compare.assert_same``; ``TransportStats`` field by field).  The
deadline group former drives a detector: the port's on the CPU, the JAX
package's under the ``jax_oracle`` fixture (``torch_jax_oracle.py``).
Their release sequences must be equal and their head maps within 1e-5
(the f32 bar of ``tests/test_fleet.py``: XLA and torch sum the convs in
different orders); inside the port, the former's heads must equal the
same launches made directly on the detector, bitwise.  The reuse-mode
release with a folded straggler shows that the port's former copies a
wave's heads before the next wave overwrites the cache's canvas."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pipeline as jpipe, scene as jscene
from repro.net import batcher as jbatch, encoder as jenc, links as jlinks
from repro.serving import detector as jdet
from repro_torch.core import pipeline as tpipe, scene as tscene
from repro_torch.kernels import ops as tops
from repro_torch.net import batcher as tbatch, encoder as tenc, \
    links as tlinks
from repro_torch.serving import detector as tdet
from torch_compare import assert_same
from torch_jax_oracle import detector_pair
from torch_jax_oracle import jax_oracle  # noqa: F401  (fixture)

T = 8
GRID = (3, 4)
CHANNELS = (4, 6)


# ---------------------------------------------------------------------------
# links: bandwidth traces and the closed-form FIFO
# ---------------------------------------------------------------------------

def _link(links, spec):
    """One ``LinkConfig`` per package from a plain spec."""
    spec = dict(spec)
    if "congestion" in spec:
        spec["congestion"] = tuple(links.CongestionEpisode(*e)
                                   for e in spec["congestion"])
    if spec.get("trace") == "lte":
        spec["trace"] = links.load_bundled_trace()
    elif spec.get("trace") is not None:
        spec["trace"] = links.UplinkTrace(*spec["trace"])
    return links.LinkConfig(**spec)


LINK_SPECS = [
    dict(),
    dict(share="equal", jitter_std=0.4, seed=3),
    dict(jitter_std=0.25, seed=7,
         congestion=[(2.0, 6.0, 0.3), (4.0, 9.0, 0.5, (1, 3))]),
    dict(trace="lte", trace_scale=0.5),
    dict(trace=(np.arange(5.0), np.array([20., 5., 30., 8., 12.])),
         share="equal"),
    dict(congestion=[(3.0, 5.0, 0.0)]),                  # an outage
]


@pytest.mark.parametrize("spec", LINK_SPECS)
def test_bandwidth_traces(spec):
    rng = np.random.default_rng(4)
    load = rng.uniform(1e4, 1e6, size=(5, 12))
    t = tlinks.bandwidth_traces(_link(tlinks, spec), 30.0, load, 1.0)
    j = jlinks.bandwidth_traces(_link(jlinks, spec), 30.0, load, 1.0)
    assert_same(t, j)


def test_bundled_trace_is_a_copy():
    t, j = tlinks.load_bundled_trace(), jlinks.load_bundled_trace()
    assert_same(t, j)
    assert t.t_s.size > 100
    assert_same(tlinks.default_congestion_trace(20.0),
                jlinks.default_congestion_trace(20.0))


def test_fifo_departures_and_outages():
    rng = np.random.default_rng(5)
    arr = np.cumsum(rng.uniform(0.5, 1.5, size=(4, 30)), axis=1)
    tx = rng.uniform(0.1, 2.0, size=(4, 30))
    assert_same(tlinks.fifo_departures(arr, tx),
                jlinks.fifo_departures(arr, tx))
    assert_same(tlinks.queue_wait(arr, tx), jlinks.queue_wait(arr, tx))
    bw = rng.uniform(1e5, 1e6, size=(4, 30))
    bw[1, 5:9] = 0.0
    bw[3, 25:] = 0.0                  # an outage past the window's end
    assert_same(tlinks.outage_effective(arr, bw, 1.0, 3e5),
                jlinks.outage_effective(arr, bw, 1.0, 3e5))


# ---------------------------------------------------------------------------
# simulate_transport, through the online phase's pricing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def offlines():
    cfg = dict(duration_s=20, seed=1)
    ts = tscene.generate_scene(tscene.SceneConfig(**cfg))
    js = jscene.generate_scene(jscene.SceneConfig(**cfg))
    return ((ts, tpipe.run_offline(ts, tpipe.OfflineConfig(
                profile_frames=100, solver="greedy"))),
            (js, jpipe.run_offline(js, jpipe.OfflineConfig(
                profile_frames=100, solver="greedy"))))


NET_SPECS = [
    (dict(), {}, float("inf")),
    (dict(jitter_std=0.4, seed=3, congestion=[(2.0, 8.0, 0.3)]), {}, 0.8),
    (dict(congestion=[(1.0, 9.0, 0.2)]),
     dict(enabled=True, static_fraction=0.3, halo_static_fraction=0.6),
     1.0),
    (dict(trace="lte", trace_scale=0.2, share="equal"),
     dict(enabled=True, static_fraction=np.linspace(0.1, 0.5, 5)), 0.5),
    (dict(congestion=[(3.0, 6.0, 0.0)]), {}, 2.0),        # an outage
]


def _net(links, batcher, encoder, spec):
    link, rc, deadline = spec
    return batcher.NetConfig(link=_link(links, link),
                             rate_control=encoder.RateControlConfig(**rc),
                             deadline_s=deadline)


@pytest.mark.parametrize("spec", NET_SPECS)
@pytest.mark.parametrize("keep", [False, True])
def test_simulate_transport(offlines, spec, keep):
    (ts, to), (js, jo) = offlines
    n = 100
    k = {c.cam_id: (np.arange(n) % (2 + c.cam_id % 2)) != 1
         for c in ts.cameras} if keep else None
    tcfg = tpipe.OnlineConfig(transport="simulated",
                              net=_net(tlinks, tbatch, tenc, spec))
    jcfg = jpipe.OnlineConfig(transport="simulated",
                              net=_net(jlinks, jbatch, jenc, spec))
    t = tpipe.online_system_metrics(ts.cameras, to, tcfg, 10.0, n, k)
    j = jpipe.online_system_metrics(js.cameras, jo, jcfg, 10.0, n, k)
    assert_same(t, j)
    assert j[7].latency_s.size == int(j[7].frames_sent.sum()) > 0


def _stats(batcher, n, seed):
    r = np.random.default_rng(seed)
    lat = r.uniform(0.1, 2.0, n)
    return batcher.TransportStats(
        lat, {k: lat / 5 for k in ("wait", "encode", "network", "batching",
                                   "inference")},
        r.integers(0, 3, n), 1e6 * seed, 2e6 * seed,
        np.full(3, n // 3, np.int64), seed, seed + 1, 0.5 + 0.1 * seed,
        1e5, 2e5)


def test_transport_aggregation():
    mt = tbatch.merge_transport([_stats(tbatch, n, s)
                                 for s, n in ((1, 30), (2, 12))])
    mj = jbatch.merge_transport([_stats(jbatch, n, s)
                                 for s, n in ((1, 30), (2, 12))])
    assert_same(mt, mj)
    for prop in ("mean_s", "p50_s", "p99_s", "shed_bytes",
                 "straggler_frac"):
        assert getattr(mt, prop) == getattr(mj, prop)
    assert mt.parts_mean() == mj.parts_mean()
    assert mt.part_p99("network") == mj.part_p99("network")
    assert_same(tbatch.empty_transport(4), jbatch.empty_transport(4))
    assert_same(tbatch.merge_transport([]), jbatch.merge_transport([]))


# ---------------------------------------------------------------------------
# the heartbeat monitor
# ---------------------------------------------------------------------------

def _heartbeat_script(batcher):
    cfg = batcher.HeartbeatConfig(interval_s=1.0, timeout_beats=2.5,
                                  backoff_base_s=0.5, backoff_max_s=3.0)
    mon = batcher.HeartbeatMonitor([0, 1, 2], cfg, t0=0.0)
    dead = []
    for t in np.arange(0.0, 20.0, 0.5):
        for cam in (0, 1, 2):
            if cam == 1 and 3.0 <= t < 11.0:
                continue                 # camera 1 blacks out, then returns
            if cam == 2 and t >= 6.0:
                continue                 # camera 2 never comes back
            mon.beat(float(t), cam)
        dead.append(mon.poll(float(t) + 0.25))
    return mon, dead


def test_heartbeat_monitor_events():
    tm, tdead = _heartbeat_script(tbatch)
    jm, jdead = _heartbeat_script(jbatch)
    assert tdead == jdead
    assert tm.events == jm.events
    assert tm.dead == jm.dead == {2}
    assert tm.retries == jm.retries
    for cam in (0, 1, 2):
        a, b = tm.detect_latency(cam), jm.detect_latency(cam)
        assert a == b or (np.isnan(a) and np.isnan(b))
    kinds = {k for _, _, k in jm.events}
    assert kinds == {"dead", "retry", "restored"}


# ---------------------------------------------------------------------------
# the deadline group former
# ---------------------------------------------------------------------------

def _grids(n_cams, seed=1):
    rng = np.random.default_rng(seed)
    grids = [rng.random(GRID) < 0.6 for _ in range(n_cams)]
    for g in grids:
        g[1, 1] = True
    return grids


def _frames(n, seed=2):
    """``n`` frames of one scene: a static background with a moving patch
    (so warm reuse waves recompute a few tiles, not all)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(GRID[0] * T, GRID[1] * T, 3)).astype(np.float32)
    out = []
    for i in range(n):
        f = base.copy()
        y, x = (3 * i) % (base.shape[0] - 6), (5 * i) % (base.shape[1] - 6)
        f[y:y + 6, x:x + 6] = rng.normal(size=(6, 6, 3))
        out.append(f)
    return out


def _drive(former, script):
    """Run an arrival script (("offer", t, cam, frame, grid) or ("poll",
    t)) and return every release the former emitted, in order."""
    for ev in script:
        if ev[0] == "offer":
            former.offer(*ev[1:])
        elif ev[0] == "poll":
            former.poll(ev[1])
        else:
            former.force_release(ev[1])
    return former.releases


def _script(frames, grids, kind):
    """Arrival scripts of three cameras that exercise each release kind."""
    f = iter(frames)
    off = lambda t, c: ("offer", t, c, next(f), grids[c])  # noqa: E731
    if kind == "full_deadline_fold":
        return [off(0.0, 0), off(0.1, 1), off(0.2, 2),         # full
                off(1.0, 0), off(1.1, 1), ("poll", 1.6),       # deadline
                off(1.7, 2), ("poll", 2.3),                    # straggler
                off(3.0, 0), off(3.2, 0), off(3.3, 1),         # fold: 0
                off(3.4, 2),                                   # full
                ("force", 4.0),                                # empty
                off(4.1, 0), off(4.2, 1), off(4.3, 2)]
    if kind == "legacy":
        return [off(0.0, 0), off(0.2, 0),                      # superseded
                off(0.3, 1), off(0.4, 2),
                off(1.0, 0), off(1.1, 1), ("poll", 1.6), off(1.8, 2),
                ("poll", 2.5)]
    if kind == "reuse":
        return [off(0.0, 0), off(0.1, 1), off(0.2, 2),         # cold
                off(1.0, 0), off(1.1, 0), off(1.15, 1),        # fold: 0
                off(1.2, 2),                                   # 2 waves
                off(2.0, 0), off(2.1, 1), ("poll", 2.7),       # deadline
                off(2.8, 2), off(2.9, 0), off(2.95, 2),        # fold 2
                off(3.0, 1)]
    raise ValueError(kind)


def _to_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_releases_match(trel, jrel):
    assert len(trel) == len(jrel) > 0
    for a, b in zip(trel, jrel):
        assert (a.t, a.cams, a.straggler_cams, a.deadline_hit,
                a.superseded) == (b.t, b.cams, b.straggler_cams,
                                  b.deadline_hit, b.superseded)
        assert list(a.outputs) == list(b.outputs)
        assert {c: len(v) for c, v in a.folded_outputs.items()} \
            == {c: len(v) for c, v in b.folded_outputs.items()}
        for c in b.outputs:
            np.testing.assert_allclose(_to_np(a.outputs[c]),
                                       _to_np(b.outputs[c]),
                                       atol=1e-5, rtol=0)
            for x, y in zip(a.folded_outputs.get(c, []),
                            b.folded_outputs.get(c, [])):
                np.testing.assert_allclose(_to_np(x), _to_np(y),
                                           atol=1e-5, rtol=0)


def _former_pair(kind, fold=True, reuse=None):
    jd, td = detector_pair(channels=CHANNELS)
    grids = _grids(3)
    frames = _frames(16)
    kw = dict(expected_cams=[0, 1, 2], deadline_s=0.5,
              fold_stragglers=fold)
    if reuse is not None:
        tkw = dict(kw, reuse_cache=tdet.PackedActivationCache(),
                   fold_gate=reuse)
        jkw = dict(kw, reuse_cache=jdet.PackedActivationCache(),
                   fold_gate=reuse)
    else:
        tkw = jkw = kw
    tf = tbatch.DeadlineGroupFormer(td, **tkw)
    jf = jbatch.DeadlineGroupFormer(jd, **jkw)
    with tops.count_kernels() as tc:
        trel = _drive(tf, _script(frames, grids, kind))
    jscript = [(e[0], e[1], e[2], jnp.asarray(e[3]), e[4])
               if e[0] == "offer" else e
               for e in _script(frames, grids, kind)]
    jrel = _drive(jf, jscript)
    return tf, jf, trel, jrel, td, frames, grids, tc


@pytest.mark.parametrize("kind,fold", [("full_deadline_fold", True),
                                       ("legacy", False)])
def test_former_releases_match_jax(jax_oracle, kind, fold):
    tf, jf, trel, jrel, td, frames, grids, tc = _former_pair(kind, fold)
    _assert_releases_match(trel, jrel)
    assert (tf.straggler_count, tf.reclaimed_launches) \
        == (jf.straggler_count, jf.reclaimed_launches)
    kinds = {(r.deadline_hit, r.superseded, bool(r.folded_outputs),
              bool(r.cams)) for r in trel}
    if kind == "legacy":
        assert any(r.superseded for r in trel)
    else:
        assert (True, False, False, False) in kinds      # forced, empty
        assert any(r.folded_outputs for r in trel)
        assert any(r.deadline_hit and r.cams for r in trel)
        assert any(r.straggler_cams for r in trel)
    # one launch chain per non-empty release, nothing else
    n = sum(1 for r in trel if r.cams)
    assert dict(tc) == {"roi_conv_entry": n, "roi_conv_stack": n,
                        "sbnet_scatter_fleet": n}
    # inside the port: each release == fleet_forward on its entries
    script = _script(frames, grids, kind)
    queued = {}
    it = iter(trel)
    for ev in script:
        if ev[0] == "offer":
            _, t, cam, f, g = ev
            if not fold and queued.get(cam):
                _check_direct(td, next(it), queued)
                queued = {}
            queued.setdefault(cam, []).append((f, g))
            if set(queued) >= {0, 1, 2}:
                _check_direct(td, next(it), queued)
                queued = {}
        else:
            nxt = [r for r in trel if r.t == ev[1]]
            if nxt and (ev[0] == "force" or queued):
                _check_direct(td, next(it), queued)
                queued = {}


def _check_direct(td, rel, queued):
    cams = sorted(queued)
    assert rel.cams == cams
    if not cams:
        assert rel.outputs == {} and rel.folded_outputs == {}
        return
    entries = [(c, f, g) for c in cams for f, g in queued[c]]
    outs = td.fleet_forward([torch.as_tensor(f) for _, f, _ in entries],
                            [g for _, _, g in entries])
    want, folded = {}, {}
    for (c, _, _), o in zip(entries, outs):
        if c in want:
            folded.setdefault(c, []).append(want[c])
        want[c] = o
    for c in cams:
        assert torch.equal(rel.outputs[c], want[c])
        for x, y in zip(rel.folded_outputs.get(c, []), folded.get(c, [])):
            assert torch.equal(x, y)
        assert len(rel.folded_outputs.get(c, [])) == len(folded.get(c, []))


@pytest.mark.parametrize("fold_gate", ["capture", "current"])
def test_former_reuse_releases_match_jax(jax_oracle, fold_gate):
    """Reuse mode: every release replays its queued segments as waves of
    ``fleet_forward_reuse``.  The folded straggler's head comes from an
    earlier wave than the slot's head; the port's must equal the JAX
    former's, and the same waves run directly and copied."""
    tf, jf, trel, jrel, td, frames, grids, tc = _former_pair(
        "reuse", reuse=fold_gate)
    _assert_releases_match(trel, jrel)
    assert (tf.reuse_waves, tf.reuse_launched_tiles,
            tf.reuse_total_tiles, tf.reclaimed_launches) \
        == (jf.reuse_waves, jf.reuse_launched_tiles,
            jf.reuse_total_tiles, jf.reclaimed_launches)
    folds = [r for r in trel if r.folded_outputs]
    assert len(folds) == 2 and tf.reuse_waves == 6
    # a folded head differs from its slot's newest head: a view the next
    # wave overwrote would have made them equal
    for r in folds:
        for c, fs in r.folded_outputs.items():
            assert not torch.equal(fs[0], r.outputs[c])

    # the same waves, directly on a second detector and cache
    _, td2 = detector_pair(channels=CHANNELS)
    cache = tdet.PackedActivationCache()
    retained = {}
    script = _script(frames, grids, "reuse")
    queued = {}
    it = iter(trel)
    for ev in script:
        if ev[0] == "offer":
            queued.setdefault(ev[2], []).append((ev[3], ev[4]))
            if set(queued) >= {0, 1, 2}:
                _check_waves(td2, cache, next(it), queued, retained,
                             fold_gate)
                queued = {}
        elif ev[0] == "poll" and any(r.t == ev[1] for r in trel):
            _check_waves(td2, cache, next(it), queued, retained, fold_gate)
            queued = {}
    assert next(it, None) is None


def _check_waves(td, cache, rel, queued, retained, fold_gate):
    n_waves = max(len(q) for q in queued.values())
    order = range(n_waves) if fold_gate == "capture" \
        else range(n_waves - 1, -1, -1)
    filler = dict(retained)
    for c, q in queued.items():
        filler.setdefault(c, q[0])
    heads_by = {}
    for w in order:
        frames, grids = [], []
        for c in (0, 1, 2):
            q = queued.get(c)
            if q and w < len(q):
                f, g = q[w]
                if fold_gate == "capture":
                    filler[c] = (f, g)
            else:
                f, g = filler[c]
            frames.append(torch.as_tensor(f))
            grids.append(g)
        heads, _ = td.fleet_forward_reuse(frames, grids, cache, 0.0)
        for i, c in enumerate((0, 1, 2)):
            q = queued.get(c)
            if q and w < len(q):
                heads_by[(c, w)] = heads[i].clone()
    for c, q in queued.items():
        want = [heads_by[(c, w)] for w in range(len(q))]
        assert torch.equal(rel.outputs[c], want[-1])
        got = rel.folded_outputs.get(c, [])
        assert len(got) == len(want) - 1
        for x, y in zip(got, want[:-1]):
            assert torch.equal(x, y)
        retained[c] = q[-1]


def test_former_frames_go_to_the_detector_device():
    """Numpy frames become f32 tensors on the detector's device as they
    arrive: the CPU here, because the detector was built there."""
    _, td = detector_pair(channels=CHANNELS)
    former = tbatch.DeadlineGroupFormer(td, [0], deadline_s=1.0)
    f = _frames(1)[0].astype(np.float64)
    rel = former.offer(0.0, 0, f, _grids(1)[0])
    assert rel is not None and rel.outputs[0].device.type == "cpu"
    assert rel.outputs[0].dtype == torch.float32
    want = td.fleet_forward([torch.as_tensor(f, dtype=torch.float32)],
                            _grids(1))[0]
    assert torch.equal(rel.outputs[0], want)
