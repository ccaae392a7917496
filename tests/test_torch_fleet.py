"""The whole slice: the port's fleet steps against the JAX package's.

The JAX package's Pallas kernels do not trace on this jax, so its own
``fleet_inference_step`` and ``fleet_reuse_step``, and its detector's
single-camera and per-layer paths, run here under the ``jax_oracle``
fixture (``torch_jax_oracle.py``): the ten kernel wrappers the detector
calls swapped for compositions of ``repro.kernels.ref`` and pure jnp that
also count their dispatches.  Both reference modes run: the canvas gate
and the packed gate.  Both
sides get the same numpy frames and weights; ReuseStats and dispatch
counters must match exactly, head maps within atol 1e-5 (the f32 bar of
``tests/test_fleet.py``).  The port's own invariants (threshold-0 reuse
bit-identical to a full recompute, gate-only all-static steps, canvas-byte
accounting, the fused stack equal to the per-layer chain) are checked
inside the port."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.fleet import runtime as jrt
from repro.kernels import ops as jops
from repro.serving import detector as jdet
from repro_torch.fleet import runtime as trt
from repro_torch.serving import detector as tdet
from torch_jax_oracle import detector_pair as _dets
from torch_jax_oracle import jax_oracle  # noqa: F401  (fixture)

T = 8
QSTEP = 0.125        # the gate's quantizer step at unit-scale frames
GRID_SHAPES = {0: [(4, 5), (3, 4), (5, 3)], 1: [(4, 4), (2, 6)]}
# ragged frames: a few pixels short of or past their grid extent
FRAME_SHAPES = {0: [(30, 40), (24, 29), (40, 24)], 1: [(32, 32), (13, 50)]}


# ---------------------------------------------------------------------------
# a mostly static 8-step trace
# ---------------------------------------------------------------------------

def _grids(seed):
    rng = np.random.default_rng(seed)
    grids = {g: [rng.random(s) < 0.55 for s in ss]
             for g, ss in GRID_SHAPES.items()}
    for gs in grids.values():
        for gg in gs:
            gg[1, 1] = True
    return grids


def _trace(seed, n_steps=8):
    """Frames per step: static except a moving patch, a sub-threshold
    flicker and fully static steps (3 and 6)."""
    rng = np.random.default_rng(seed)
    frames = {g: [rng.normal(size=s + (3,)).astype(np.float32)
                  for s in ss] for g, ss in FRAME_SHAPES.items()}
    steps = [frames]
    for k in range(1, n_steps):
        cur = {g: [f.copy() for f in fs] for g, fs in steps[-1].items()}
        if k not in (3, 6):
            g = k % 2
            cam = k % len(cur[g])
            f = cur[g][cam]
            y = int(rng.integers(0, f.shape[0] - 6))
            x = int(rng.integers(0, f.shape[1] - 6))
            f[y:y + 6, x:x + 6] = rng.normal(size=(6, 6, 3))
            if k in (2, 5):
                cur[1 - g][0][:4, :4] += 0.01      # flicker below QSTEP/2
        steps.append(cur)
    return steps


def _jax_frames(frames):
    return {g: [jnp.asarray(f) for f in fs] for g, fs in frames.items()}


def _assert_heads_close(t_outs, j_outs):
    assert set(t_outs) == set(j_outs)
    for g in j_outs:
        for a, b in zip(t_outs[g], j_outs[g]):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=0)


def _assert_stats_equal(ts, js):
    for f in dataclasses.fields(js):
        a, b = getattr(ts, f.name), getattr(js, f.name)
        if f.name == "gate_stats":
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        else:
            assert a == b, (f.name, a, b)


def _reuse_steps_match_jax(threshold, ref_mode):
    jd, td = _dets()
    grids = _grids(1)
    jcache = jdet.PackedActivationCache(ref_mode=ref_mode)
    tcache = tdet.PackedActivationCache(ref_mode=ref_mode)
    kinds = set()
    for k, frames in enumerate(_trace(2)):
        j_outs, j_counts, j_stats = jrt.fleet_reuse_step(
            jd, _jax_frames(frames), grids, jcache, threshold, QSTEP)
        t_outs, t_counts, t_stats = trt.fleet_reuse_step(
            td, frames, grids, tcache, threshold, QSTEP)
        assert t_counts == j_counts, k
        _assert_stats_equal(t_stats, j_stats)
        _assert_heads_close(t_outs, j_outs)
        kinds.add("cold" if t_stats.cold else
                  "static" if t_stats.computed == 0 else "changed")
    assert kinds == {"cold", "static", "changed"}
    np.testing.assert_array_equal(tcache.epoch_np, jcache.epoch_np)


@pytest.mark.parametrize("threshold", [0.0, 40.0])
def test_reuse_steps_match_jax(jax_oracle, threshold):
    _reuse_steps_match_jax(threshold, "canvas")


@pytest.mark.parametrize("threshold", [0.0, 40.0])
def test_packed_reuse_steps_match_jax(jax_oracle, threshold):
    """The packed reference mode (gate B5, references advanced row for row
    from its windows output) against the JAX package's packed mode."""
    _reuse_steps_match_jax(threshold, "packed")


def test_inference_step_matches_jax(jax_oracle):
    jd, td = _dets(3)
    grids = _grids(4)
    frames = _trace(5, n_steps=1)[0]
    j_outs, j_counts = jrt.fleet_inference_step(jd, _jax_frames(frames),
                                                grids)
    t_outs, t_counts = trt.fleet_inference_step(td, frames, grids)
    assert t_counts == j_counts
    _assert_heads_close(t_outs, j_outs)


def test_dense_forward_matches_jax():
    jd, td = _dets(6)
    x = np.random.default_rng(7).normal(size=(20, 27, 3)).astype(np.float32)
    np.testing.assert_allclose(td.dense_forward(x).numpy(),
                               np.asarray(jd.dense_forward(jnp.asarray(x))),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the port's own invariants (CPU, plain versions)
# ---------------------------------------------------------------------------

def test_threshold0_reuse_is_bitwise_full_recompute():
    _, td = _dets(8)
    grids = _grids(9)
    cache = tdet.PackedActivationCache()
    tile_bytes = T * T * td.head.shape[-1] * 4
    for k, frames in enumerate(_trace(10)):
        outs, counts, stats = trt.fleet_reuse_step(td, frames, grids, cache)
        kept = {g: [h.clone() for h in hs] for g, hs in outs.items()}
        full, _ = trt.fleet_inference_step(td, frames, grids)
        for g in full:
            for a, b in zip(kept[g], full[g]):
                assert torch.equal(a, b), (k, g)
        if not stats.cold:
            assert stats.canvas_bytes == stats.changed_out * tile_bytes
        if k in (3, 6):                          # all-static steps
            assert counts == {"tile_delta_gate": 1}
            assert stats.computed == 0 and stats.canvas_bytes == 0


def test_empty_fleet_launches_nothing():
    _, td = _dets()
    grids = {g: [np.zeros(s, bool) for s in ss]
             for g, ss in GRID_SHAPES.items()}
    frames = _trace(11, n_steps=1)[0]
    outs, counts = trt.fleet_inference_step(td, frames, grids)
    assert counts == {}
    assert all(float(h.abs().sum()) == 0 for hs in outs.values() for h in hs)
    cache = tdet.PackedActivationCache()
    for _ in range(2):
        outs, counts, stats = trt.fleet_reuse_step(td, frames, grids, cache)
        assert counts == {} and stats.total_tiles == 0


def test_mask_change_misses_the_cache():
    _, td = _dets()
    grids = _grids(12)
    frames = _trace(13, n_steps=1)[0]
    cache = tdet.PackedActivationCache()
    assert trt.fleet_reuse_step(td, frames, grids, cache)[2].cold
    assert not trt.fleet_reuse_step(td, frames, grids, cache)[2].cold
    moved = {g: [gg.copy() for gg in gs] for g, gs in grids.items()}
    moved[0][0][0, 0] = not moved[0][0][0, 0]
    assert trt.fleet_reuse_step(td, frames, moved, cache)[2].cold
    assert cache.cold_steps == 2


def test_single_layer_stack_free_chain():
    """A 1-layer net has no stack launch, on both sides."""
    _, td = _dets(channels=(8,))
    grids = _grids(14)
    frames = _trace(15, n_steps=1)[0]
    _, counts = trt.fleet_inference_step(td, frames, grids)
    assert counts == {"roi_conv_entry": 1, "sbnet_scatter_fleet": 1}


def _interior_trace(seed, t=T, n_steps=6):
    """Frames whose motion stays inside tile interiors (each changed
    tile's 2-pixel rim stays bit-static), with all-static repeats: the
    regime where the canvas and packed reference modes are defined to
    agree at every threshold."""
    rng = np.random.default_rng(seed)
    shapes = {0: [(3, 4), (2, 2)], 1: [(4, 3)]}
    grids = {g: [rng.random(s) < 0.7 for s in ss] for g, ss in shapes.items()}
    for gs in grids.values():
        for gg in gs:
            gg[0, 0] = True
    cur = {g: [rng.normal(size=(s[0] * t, s[1] * t, 3)).astype(np.float32)
               for s in ss] for g, ss in shapes.items()}
    steps = [cur]
    for step in range(1, n_steps):
        if step % 3 != 2:                        # else an all-static repeat
            cur = {g: [f.copy() for f in fs] for g, fs in cur.items()}
            f = cur[int(rng.integers(2))][0]
            ty = int(rng.integers(f.shape[0] // t))
            tx = int(rng.integers(f.shape[1] // t))
            f[ty * t + 2:ty * t + t - 2, tx * t + 2:tx * t + t - 2] += \
                rng.normal(size=(t - 4, t - 4, 3)).astype(np.float32)
        steps.append(cur)
    return grids, steps


@pytest.mark.parametrize("threshold", [0.0, 40.0, 1e9])
def test_ref_modes_bitwise_equal(threshold):
    """The port-side twin of ``tests/test_canvas.py``'s mode test: canvas
    and packed references give equal ReuseStats (gate stats included) and
    bitwise-equal head maps at exact, lossy and everything-reused
    thresholds; at threshold 0 both equal a full recompute."""
    _, td = _dets(16, channels=(4, 6))
    grids, steps = _interior_trace(17)
    caches = {m: tdet.PackedActivationCache(ref_mode=m)
              for m in ("canvas", "packed")}
    for k, frames in enumerate(steps):
        out = {m: trt.fleet_reuse_step(td, frames, grids, c, threshold,
                                       QSTEP) for m, c in caches.items()}
        (c_outs, c_counts, c_st), (p_outs, p_counts, p_st) = \
            out["canvas"], out["packed"]
        assert c_counts == p_counts, k
        _assert_stats_equal(p_st, c_st)
        for g in grids:
            for a, b in zip(c_outs[g], p_outs[g]):
                assert torch.equal(a, b), (k, g)
        if threshold == 0.0:
            full, _ = trt.fleet_inference_step(td, frames, grids)
            for g in grids:
                for a, b in zip(c_outs[g], full[g]):
                    assert torch.equal(a, b), (k, g)
    assert caches["packed"].ref_canvas is None
    assert caches["canvas"].ref_win is None
    np.testing.assert_array_equal(caches["canvas"].epoch_np,
                                  caches["packed"].epoch_np)


# ---------------------------------------------------------------------------
# the single-camera and per-layer paths (B6-B9)
# ---------------------------------------------------------------------------

def _camera(seed, shape=(4, 5), density=0.5):
    """A grid and a whole-tile frame (the JAX package leaves a partial
    last tile row undefined; the port pads)."""
    rng = np.random.default_rng(seed)
    grid = rng.random(shape) < density
    grid[1, 1] = True
    x = rng.normal(size=(shape[0] * T, shape[1] * T, 3)).astype(np.float32)
    return grid, x


def _counted(fn, *args):
    with jops.count_kernels() as jc, tdet.kops.count_kernels() as tc:
        out = fn(*args)
    return out, dict(jc), dict(tc)


@pytest.mark.parametrize("path", ["roi_forward", "roi_forward_layers"])
def test_single_camera_paths_match_jax(jax_oracle, path):
    """The port's ``roi_forward`` / ``roi_forward_layers`` against the JAX
    detector's: equal dispatch counters, head maps within atol 1e-5."""
    jd, td = _dets(20)
    grid, x = _camera(21)
    j_out, j_counts, _ = _counted(getattr(jd, path), jnp.asarray(x), grid)
    t_out, _, t_counts = _counted(getattr(td, path), x, grid)
    assert t_counts == j_counts == (
        {"roi_conv_entry": 1, "roi_conv_stack": 1, "sbnet_scatter": 1}
        if path == "roi_forward" else
        {"roi_conv": 1, "roi_conv_packed": 2, "sbnet_scatter": 1})
    assert tuple(t_out.shape) == tuple(j_out.shape) == x.shape[:2] + (10,)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=0)


def test_fleet_forward_layers_matches_jax(jax_oracle):
    """The per-layer fleet chain against the JAX detector's: equal
    dispatch counters, head maps within atol 1e-5 on ragged frames."""
    jd, td = _dets(22)
    grids = _grids(23)
    frames = _trace(24, n_steps=1)[0]
    flat_g = [g for gs in grids.values() for g in gs]
    flat_f = [f for fs in frames.values() for f in fs]
    j_outs, j_counts, _ = _counted(jd.fleet_forward_layers,
                                   [jnp.asarray(f) for f in flat_f], flat_g)
    t_outs, _, t_counts = _counted(td.fleet_forward_layers, flat_f, flat_g)
    assert t_counts == j_counts == {"roi_conv_fleet": 1,
                                    "roi_conv_packed": 2,
                                    "sbnet_scatter_fleet": 1}
    _assert_heads_close({0: t_outs}, {0: j_outs})


@pytest.mark.parametrize("density", [0.3, 1.0])
def test_forward_switch_matches_jax(jax_oracle, density):
    """``forward`` takes the RoI path below ``switch_density`` and the
    dense path at or above it, as the JAX detector does."""
    jd, td = _dets(25)
    grid, x = _camera(26, density=density)
    j_out, j_counts, _ = _counted(jd.forward, jnp.asarray(x), grid)
    t_out, _, t_counts = _counted(td.forward, x, grid)
    assert t_counts == j_counts
    assert bool(t_counts) == (grid.mean() < td.cfg.switch_density)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=0)


def test_fused_equals_per_layer_bitwise():
    """Inside the port: the fused stack equals the per-layer chain
    bitwise, on one camera and on the fleet; ``roi_forward`` equals the
    one-camera ``fleet_forward``, and each camera's map of the fleet."""
    _, td = _dets(27)
    grids = _grids(28)
    frames = _trace(29, n_steps=1)[0]
    flat_g = [g for gs in grids.values() for g in gs]
    flat_f = [f for fs in frames.values() for f in fs]
    fused = td.fleet_forward(flat_f, flat_g)
    layers = td.fleet_forward_layers(flat_f, flat_g)
    for c, (f, g) in enumerate(zip(flat_f, flat_g)):
        one = td.roi_forward(f, g)
        assert torch.equal(fused[c], layers[c]), c
        assert torch.equal(one, td.roi_forward_layers(f, g)), c
        assert torch.equal(one, td.fleet_forward([f], [g])[0]), c
        assert torch.equal(one, fused[c]), c


def test_roi_forward_ragged_frame_is_padded_to_its_grid():
    """A 1080-px-style frame (the last tile row partial) runs on both
    paths: the tiles are computed on the frame zero-padded to the grid,
    as on the fleet canvas, and the map is cropped to the frame."""
    _, td = _dets(30)
    rng = np.random.default_rng(31)
    grid = rng.random((5, 4)) < 0.6
    grid[-1] = True                        # the partial row is active
    x = rng.normal(size=(5 * T - 3, 4 * T - 5, 3)).astype(np.float32)
    padded = np.zeros((5 * T, 4 * T, 3), np.float32)
    padded[:x.shape[0], :x.shape[1]] = x
    want = td.roi_forward(padded, grid)[:x.shape[0], :x.shape[1]]
    for path in (td.roi_forward, td.roi_forward_layers):
        got = path(x, grid)
        assert tuple(got.shape) == x.shape[:2] + (10,)
        assert torch.equal(got, want)


def test_single_camera_empty_mask_launches_nothing():
    _, td = _dets(32)
    grid, x = _camera(33)
    empty = np.zeros_like(grid)
    for path in (td.roi_forward, td.roi_forward_layers, td.forward):
        with tdet.kops.count_kernels() as c:
            out = path(x, empty)
        assert c == {} and tuple(out.shape) == x.shape[:2] + (10,)
        assert float(out.abs().sum()) == 0
    with tdet.kops.count_kernels() as c:
        outs = td.fleet_forward_layers([x, x], [empty, empty])
    assert c == {} and all(float(h.abs().sum()) == 0 for h in outs)


def test_roi_conv_batched_equals_per_frame():
    """``roi_conv_batched``: B frames sharing one mask in one dispatch,
    equal to B8 frame by frame bitwise."""
    _, td = _dets(34)
    grid, _ = _camera(35)
    rng = np.random.default_rng(36)
    xs = torch.as_tensor(rng.normal(size=(4,) + (grid.shape[0] * T,
                                                 grid.shape[1] * T, 3))
                         .astype(np.float32))
    idx, _, _ = td._mask_tables(grid)
    w = td.weights[0]
    with tdet.kops.count_kernels() as c:
        batch = tdet.kops.roi_conv_batched(xs, w, idx, T, T)
    assert c == {"roi_conv": 1}
    for b in range(4):
        assert torch.equal(batch[b], tdet.kops.roi_conv(xs[b], w, idx, T, T))
