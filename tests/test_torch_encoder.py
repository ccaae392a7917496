"""The port's edge encoder (``repro_torch.net.encoder``) against the JAX
package's ``repro.net.encoder``: packetization, the rate controller, the
gate-threshold schedule and the static-tile fractions, on seeded random
inputs.  The numpy functions must agree exactly; the fractions run the
port's kernels (plain versions here) and the JAX side's Pallas kernels
through ``repro.kernels.ref`` (they do not trace on this jax).  The last
tests close the loop inside the port: the fleet step's gate stats feed the
rate controller with no launch, ``tile_static_fraction`` with exactly one."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.net import encoder as jenc
from repro_torch.fleet import runtime as trt
from repro_torch.kernels import ops as tops
from repro_torch.net import encoder as tenc
from repro_torch.serving import detector as tdet

C, S = 6, 9


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _cameras(rng):
    cams, groups = [], {}
    for cid in range(C):
        tile = 16
        w, h = int(rng.integers(5, 12)) * tile - 7, int(rng.integers(4, 9)) \
            * tile
        cams.append(SimpleNamespace(cam_id=cid, tile=tile, width=w,
                                    height=h))
        # camera 2 has no positive-area rectangle: it ships nothing
        groups[cid] = [] if cid == 2 else [
            SimpleNamespace(x0=int(rng.integers(0, 4)),
                            y0=int(rng.integers(0, 3)),
                            w=int(rng.integers(1, 5)),
                            h=int(rng.integers(1, 4)))
            for _ in range(int(rng.integers(1, 4)))]
    codec = SimpleNamespace(boundary_k=rng.uniform(0.5, 3.0, C),
                            rho=rng.uniform(0.01, 0.1, C), header_bytes=120)
    return cams, groups, codec


@pytest.mark.parametrize("with_keep", [False, True])
def test_packetization_matches_jax(with_keep):
    rng = np.random.default_rng(0)
    cams, groups, codec = _cameras(rng)
    t_coef = tenc.camera_coefficients(cams, groups, codec)
    j_coef = jenc.camera_coefficients(cams, groups, codec)
    for f in ("body", "halo", "headers", "has_mask", "per_frame"):
        _equal(getattr(t_coef, f), getattr(j_coef, f))
    keep = ({c.cam_id: rng.random(S * 10 - 3) < 0.7 for c in cams}
            if with_keep else None)
    sent = tenc.sent_matrix(cams, t_coef, keep, S, 10)
    _equal(sent, jenc.sent_matrix(cams, j_coef, keep, S, 10))
    _equal(tenc.activity(sent), jenc.activity(sent))
    _equal(tenc.segment_byte_matrices(t_coef, sent),
           jenc.segment_byte_matrices(j_coef, sent))
    num = rng.uniform(0, 10, (C, S)) * (rng.random((C, S)) < 0.8)
    den = rng.uniform(0, 5, (C, S)) * (rng.random((C, S)) < 0.8)
    _equal(tenc.zero_safe_div(num, den), jenc.zero_safe_div(num, den))


def _byte_mats(rng):
    body = rng.uniform(1e4, 5e4, (C, S))
    halo = rng.uniform(0.1, 0.4, (C, S)) * body
    headers = np.full((C, S), 240.0)
    arrivals = np.arange(S)[None, :] + rng.uniform(0, 0.2, (C, 1))
    # every other camera sits behind a congested uplink
    bw = np.where(np.arange(C)[:, None] % 2 == 1, 2e4, 1e7) \
        * rng.uniform(0.8, 1.2, (C, S))
    return arrivals, body, halo, headers, bw


@pytest.mark.parametrize("kind", ["scalar", "per_camera", "start_floor"])
def test_rate_control_matches_jax(kind):
    rng = np.random.default_rng(1)
    arrivals, body, halo, headers, bw = _byte_mats(rng)
    fracs = dict(static_fraction=0.4, halo_static_fraction=0.8)
    if kind != "scalar":
        fracs = dict(static_fraction=rng.uniform(0, 1, C),
                     halo_static_fraction=rng.uniform(0, 1, C))
    floor = (arrivals + rng.uniform(0, 3, (C, S))
             if kind == "start_floor" else None)
    got = tenc.rate_controlled_departures(
        arrivals, body, halo, headers, bw,
        tenc.RateControlConfig(enabled=True, **fracs), start_floor=floor)
    want = jenc.rate_controlled_departures(
        arrivals, body, halo, headers, bw,
        jenc.RateControlConfig(enabled=True, **fracs), start_floor=floor)
    _equal(got, want)
    quality = got[2]
    assert (quality[1::2].min(axis=1) < 1).all()
    if floor is None:                   # an outage floor backs up every link
        assert (quality[0::2] == 1).all()


@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("halo_gain", [None, 0.25])
def test_gate_threshold_schedule_matches_jax(shape, halo_gain):
    rng = np.random.default_rng(2)
    q = rng.uniform(0.35, 1.0, (C, S) if shape == "2d" else (C,))
    q[0] = 1.0
    got = tenc.gate_threshold_schedule(q, 16, 3, base_threshold=0.5,
                                       gain=0.5, halo_gain=halo_gain)
    want = jenc.gate_threshold_schedule(q, 16, 3, base_threshold=0.5,
                                        gain=0.5, halo_gain=halo_gain)
    _equal(got, want)
    assert got.shape == ((C,) if halo_gain is None else (C, 2))


def test_static_fraction_from_stats_matches_jax():
    rng = np.random.default_rng(3)
    stats = np.zeros((40, tops.STATS_WIDTH), np.int32)
    stats[:, 0] = rng.integers(0, 200, 40)
    for ratio in (0.05, 0.1, 0.5):
        got = tenc.static_fraction_from_stats(stats, 3, 16, ratio)
        assert got == jenc.static_fraction_from_stats(stats, 3, 16, ratio)
        assert tenc.static_fraction_from_stats(torch.as_tensor(stats), 3,
                                               16, ratio) == got
    assert tenc.static_fraction_from_stats(stats[:0], 3, 16) == 0.0


def _jax_delta(cur, prev, idx, th, tw, qstep=8.0, coef_bits=6, run_bits=10,
               interpret=True):
    jops.record_dispatch("tile_delta")
    return jnp.asarray(jref.tile_delta(cur, prev, idx, th, tw, qstep,
                                       coef_bits, run_bits))


def _jax_halo(cur, prev, idx, th, tw, qstep=8.0, coef_bits=6, run_bits=10,
              interpret=True):
    jops.record_dispatch("tile_delta_halo")
    return jnp.asarray(jref.tile_delta_halo(cur, prev, idx, th, tw, qstep,
                                            coef_bits, run_bits))


@pytest.fixture
def jax_deltas(monkeypatch):
    """The JAX encoder's two kernel calls as ``repro.kernels.ref``."""
    monkeypatch.setattr(jops, "tile_delta", _jax_delta)
    monkeypatch.setattr(jops, "tile_delta_halo", _jax_halo)


def _frames(seed, shape=(48, 64, 3)):
    rng = np.random.default_rng(seed)
    prev = rng.normal(size=shape).astype(np.float32) * 4
    cur = prev.copy()
    cur[8:24, 16:40] += rng.normal(size=(16, 24, 3)).astype(np.float32) * 20
    cur[40:44, 0:3] += 0.5                  # sub-quantum flicker
    grid = rng.random((-(-shape[0] // 8), -(-shape[1] // 8))) < 0.7
    return cur, prev, grid


@pytest.mark.parametrize("qstep", [1.0, 8.0])
def test_fractions_match_jax(jax_deltas, qstep):
    cur, prev, grid = _frames(4)
    for fn in ("tile_static_fraction", "tile_halo_static_fraction"):
        got = getattr(tenc, fn)(cur, prev, grid, 8, qstep=qstep,
                                device="cpu")
        want = getattr(jenc, fn)(cur, prev, grid, 8, qstep=qstep)
        assert got == want, fn
        assert 0.0 < got < 1.0, (fn, got)
    t_cur = torch.as_tensor(cur)
    assert tenc.tile_static_fraction(t_cur, torch.as_tensor(prev), grid, 8,
                                     qstep=qstep, device="cpu") == \
        tenc.tile_static_fraction(cur, prev, grid, 8, qstep=qstep,
                                  device="cpu")
    empty = np.zeros_like(grid)
    assert tenc.tile_static_fraction(cur, prev, empty, 8, device="cpu") == 0
    assert tenc.tile_halo_static_fraction(cur, prev, empty, 8,
                                          device="cpu") == 0.0


def test_partial_tiles_priced_on_the_zero_padded_frame(jax_deltas):
    """A grid past the frame's edge: the port prices the frame pair
    zero-padded to the grid's extent, as the fleet step's canvas holds it."""
    cur, prev, grid = _frames(5, shape=(44, 61, 3))
    assert grid.shape == (6, 8)
    grid[-1, -1] = True
    pad = ((0, 48 - 44), (0, 64 - 61), (0, 0))
    for fn in ("tile_static_fraction", "tile_halo_static_fraction"):
        got = getattr(tenc, fn)(cur, prev, grid, 8, device="cpu")
        want = getattr(jenc, fn)(np.pad(cur, pad), np.pad(prev, pad), grid,
                                 8)
        assert got == want, fn


def _fleet(seed, t=8):
    rng = np.random.default_rng(seed)
    grids = {0: [rng.random((4, 5)) < 0.7, rng.random((3, 4)) < 0.7],
             1: [rng.random((5, 3)) < 0.7]}
    frames = {g: [rng.normal(size=(gr.shape[0] * t - 3, gr.shape[1] * t, 3))
                  .astype(np.float32) for gr in gs]
              for g, gs in grids.items()}
    return rng, grids, frames


def test_gate_stats_feed_rate_control_without_a_launch():
    """The twin of ``tests/test_reuse.py``'s shared-dispatch test: the fast
    route reads the fleet gate's stats rows and launches nothing;
    ``tile_static_fraction`` launches exactly one ``tile_delta`` and gives
    the same fraction, for every camera (ragged frames included)."""
    t = 8
    rng, grids, frames = _fleet(6, t)
    det = tdet.RoIDetector(tdet.DetectorConfig(tile=t), seed=1,
                           device="cpu")
    cache = tdet.PackedActivationCache()
    trt.fleet_reuse_step(det, frames, grids, cache)
    cur = {g: [f.copy() for f in fs] for g, fs in frames.items()}
    cur[0][0][5:9, 5:20] += 30.0
    cur[1][0][2:4, 2:4] += 0.5
    _, counts, st = trt.fleet_reuse_step(det, cur, grids, cache)
    assert counts["tile_delta_gate"] == 1 and "tile_delta" not in counts
    flat_cur = [f for g in cur for f in cur[g]]
    flat_prev = [f for g in frames for f in frames[g]]
    flat_grids = [gr for g in grids for gr in grids[g]]
    for c, (fc, fp, gr) in enumerate(zip(flat_cur, flat_prev, flat_grids)):
        rows = st.gate_stats[cache.idx_np[:, 0] == c]
        with tops.count_kernels() as fast:
            f_fast = tenc.static_fraction_from_stats(rows, 3, t)
            f_pass = tenc.tile_static_fraction(fc, fp, gr, t, stats=rows)
        with tops.count_kernels() as slow:
            f_slow = tenc.tile_static_fraction(fc, fp, gr, t, device="cpu")
        assert fast == {} and slow == {"tile_delta": 1}
        assert f_fast == f_pass == f_slow, c
        idx = tops.mask_to_indices(gr)
        a, b = tenc.pad_to_grid(fc, fp, gr.shape, t, device="cpu")
        body = tops.tile_delta(a, b, torch.as_tensor(idx), t, t).numpy()
        np.testing.assert_array_equal(body[:, :4], rows[:, :4])
    assert tenc.static_fraction_from_stats(st.gate_stats, 3, t) < 1.0


def test_fractions_have_no_hidden_device(monkeypatch):
    """Numpy or CPU frames run on the card unless the caller passes
    ``device="cpu"``: without a card the fractions raise, never drop to
    the CPU on their own.  Precomputed stats rows need no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cur, prev, grid = _frames(7)
    for frames in ((cur, prev), (torch.as_tensor(cur), torch.as_tensor(prev))):
        for fn in (tenc.tile_static_fraction, tenc.tile_halo_static_fraction):
            with pytest.raises(RuntimeError):
                fn(*frames, grid, 8)
            assert 0.0 <= fn(*frames, grid, 8, device="cpu") <= 1.0
        with pytest.raises(RuntimeError):
            tenc.pad_to_grid(*frames, grid.shape, 8)
    a, b = tenc.pad_to_grid(cur, prev, grid.shape, 8, device="cpu")
    assert a.device.type == b.device.type == "cpu"
    stats = np.zeros((4, tops.STATS_WIDTH), np.int32)
    assert tenc.tile_static_fraction(cur, prev, grid, 8, stats=stats) == 1.0
