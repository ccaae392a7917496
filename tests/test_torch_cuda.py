"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a machine with a card and PyTorch
alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.fleet import runtime as trt
from repro_torch.kernels import _build, ops as tops, ref as tref
from repro_torch.kernels import roi_attention, roi_conv, sbnet, tile_delta
from repro_torch.net import encoder as tenc
from repro_torch.serving import detector as tdet

SHAPES = [(4, 5), (3, 4), (5, 3)]          # per-camera tile grids


def _fleet(seed, tile, density=0.55):
    rng = np.random.default_rng(seed)
    grids = [rng.random(s) < density for s in SHAPES]
    for g in grids:
        g[1, 1] = True
    idx, _ = tops.fleet_indices(grids)
    nbr = tops.fleet_neighbor_table(grids)
    H = max(s[0] for s in SHAPES) * tile
    W = max(s[1] for s in SHAPES) * tile
    return rng, grids, idx, nbr, H, W


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU run covers the plain "
                    "versions")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# odd widths and channel counts that are not multiples of the kernels'
# 8-channel chunk, one to three stack layers, tiles of 8 and 16
@pytest.mark.cuda
@pytest.mark.parametrize("tile,channels", [
    (8, (8, 16, 16)), (16, (8, 16, 16)), (8, (8, 16)), (8, (6, 12, 10, 5))])
def test_cuda_kernels_match_plain_versions(cuda, tile, channels):
    rng, _, idx, nbr, H, W = _fleet(6, tile)
    C = len(SHAPES)
    chans = (3,) + channels
    x = rng.normal(size=(C, H, W, 3)).astype(np.float32)
    ws = [(rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci))
          .astype(np.float32) for ci, co in zip(chans[:-1], chans[1:])]
    d = {k: _t(v).to(cuda) for k, v in dict(x=x, idx=idx, nbr=nbr).items()}
    w0, *dws = [_t(w).to(cuda) for w in ws]
    before = dict(_build.LAUNCHES)
    p = roi_conv.roi_conv_entry(d["x"], w0, d["idx"], tile, tile)
    p_ref = tref.roi_conv_entry(d["x"], w0, d["idx"], tile, tile)
    assert (p - p_ref).abs().max().item() <= 1e-4
    s = roi_conv.roi_conv_stack(p_ref, dws, d["nbr"])
    s_ref = tref.roi_conv_stack(p_ref, dws, d["nbr"])
    assert (s - s_ref).abs().max().item() <= 1e-4
    base = torch.zeros((C, H, W, channels[-1]), device=cuda)
    out = sbnet.sbnet_scatter_fleet(s_ref, d["idx"], base.clone())
    assert torch.equal(out, tref.sbnet_scatter_fleet(s_ref, d["idx"], base))
    xp = torch.nn.functional.pad(d["x"], (0, 0, 1, 1, 1, 1))
    prev = xp + (torch.rand_like(xp) < 0.2) * 20.0
    for q in (1.0, 8.0, 13.0):
        assert torch.equal(
            tile_delta.tile_delta_gate_canvas(xp, prev, d["idx"], tile, tile,
                                              q),
            tref.tile_delta_gate_canvas(xp, prev, d["idx"], tile, tile, q))
    torch.cuda.synchronize()
    for k in ("roi_conv_entry", "roi_conv_stack", "sbnet_scatter_fleet",
              "tile_delta_gate_canvas"):
        assert _build.LAUNCHES[k] > before.get(k, 0)


def _half_grid_pair(rng, shape):
    """(prev, cur) on a 0.5 grid (deltas on rounding ties), 30% moved,
    with a -0.0 over a 0.0."""
    prev = (rng.integers(-40, 40, shape) * 0.5).astype(np.float32)
    cur = prev.copy()
    moved = rng.random(shape) < 0.3
    cur[moved] += (rng.integers(-60, 60, moved.sum()) * 0.5) \
        .astype(np.float32)
    cur[..., 0, :3, :] = -0.0
    prev[..., 0, :3, :] = 0.0
    return prev, cur


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("cin", [3, 5])
def test_cuda_tile_delta_family_matches_plain_versions(cuda, tile, cin):
    """B5 (packed gate, stats and windows), B10 and B11 bit-exact against
    their plain versions; references of mixed age for B5."""
    rng, grids, idx, _, H, W = _fleet(9, tile)
    prev, cur = _half_grid_pair(rng, (len(SHAPES), H, W, cin))
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    cur_p = _t(np.pad(cur, pad)).to(cuda)
    prev_p = _t(np.pad(prev, pad)).to(cuda)
    d_idx = _t(idx).to(cuda)
    ref_win = tref.gather_windows(prev_p, d_idx, tile, tile)
    fresh = torch.as_tensor(rng.random(idx.shape[0]) < 0.3, device=cuda)
    ref_win[fresh] = tref.gather_windows(cur_p, d_idx, tile, tile)[fresh]
    before = dict(_build.LAUNCHES)
    for q in (1.0, 8.0, 13.0):
        s, w = tile_delta.tile_delta_gate(cur_p, ref_win, d_idx, tile, tile,
                                          q)
        s_ref, w_ref = tref.tile_delta_gate(cur_p, ref_win, d_idx, tile,
                                            tile, q)
        assert torch.equal(s, s_ref) and torch.equal(w, w_ref)
        for c, g in enumerate(grids):
            rows = _t(tops.mask_to_indices(g)).to(cuda)
            a, b = _t(cur[c]).to(cuda), _t(prev[c]).to(cuda)
            assert torch.equal(
                tile_delta.tile_delta(a, b, rows, tile, tile, q),
                tref.tile_delta(a, b, rows, tile, tile, q))
            assert torch.equal(
                tile_delta.tile_delta_halo(a, b, rows, tile, tile, q),
                tref.tile_delta_halo(a, b, rows, tile, tile, q))
    torch.cuda.synchronize()
    for k in ("tile_delta_gate", "tile_delta", "tile_delta_halo"):
        assert _build.LAUNCHES[k] > before.get(k, 0)


def _gate_planes(rng, shape, kind):
    """(prev, cur) zero-padded (C, H+2, W+2, Cin) planes for the gate:
    "ties" -- ``_half_grid_pair`` with NaNs in cur, in prev and in both at
    the same places; "changed" -- every element, the padding too, moved by
    16 to 32, so no window holds a zero."""
    if kind == "changed":
        prev = rng.normal(size=shape).astype(np.float32)
        return prev, prev + rng.uniform(16, 32, shape).astype(np.float32)
    C, Hp, Wp, cin = shape
    prev, cur = _half_grid_pair(rng, (C, Hp - 2, Wp - 2, cin))
    spots = rng.choice(cur.size, 12, replace=False)
    cur.reshape(-1)[spots[:8]] = np.nan
    prev.reshape(-1)[spots[4:]] = np.nan
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    return np.pad(prev, pad), np.pad(cur, pad)


def _bits_equal(a, b):
    """Bitwise equality of float32 tensors, NaNs included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# (th, tw, Cin): window rows of 30, 50, 54, 90 (two of the kernel's
# 64-element chunks), 27 (odd) and 102 floats; 16x16 at Cin 3 is the
# detector's instance
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "changed"])
@pytest.mark.parametrize("th,tw,cin", [
    (8, 8, 3), (8, 8, 5), (16, 16, 3), (16, 16, 5), (8, 7, 3), (32, 32, 3)])
def test_cuda_gates_bitwise_on_hard_content(cuda, kind, th, tw, cin):
    """B1 and B5 (stats and windows) bitwise against their plain versions
    at qstep 1, 8 and 13, and B5's stats == B1's on the same reference.
    The route function agrees with the launcher, and at the detector's
    extents the generic instance (copies 4 bytes off an 8-byte boundary)
    gives the detector's bits."""
    rng = np.random.default_rng(11)
    grids = [rng.random(s) < 0.55 for s in SHAPES]
    for g in grids:
        g[1, 1] = True
    idx = _t(tops.fleet_indices(grids)[0]).to(cuda)
    shape = (len(SHAPES), max(s[0] for s in SHAPES) * th + 2,
             max(s[1] for s in SHAPES) * tw + 2, cin)
    prev_p, cur_p = (_t(a).to(cuda) for a in _gate_planes(rng, shape, kind))
    ref_win = tref.gather_windows(prev_p, idx, th, tw)
    inputs = [(cur_p, prev_p, ref_win)]
    routes = ["generic"]
    if (cin, th, tw) == tile_delta.GATE_DETECTOR:
        inputs.append(tuple(_misaligned(a) for a in inputs[0]))
        routes.insert(0, "detector")
    lib = _build.library()
    for (c, p, w), route in zip(inputs, routes):
        for r in (p, w):
            args = (cin, th, tw, c.shape[2], c.data_ptr(), r.data_ptr())
            assert tile_delta.gate_route(*args) == route
            assert lib.tile_delta_gate_route(*args, None) == \
                (route == "detector")
    before = dict(_build.LAUNCHES)
    for q in (1.0, 8.0, 13.0):
        want1 = tref.tile_delta_gate_canvas(cur_p, prev_p, idx, th, tw, q)
        want_s, want_w = tref.tile_delta_gate(cur_p, ref_win, idx, th, tw,
                                              q)
        if kind == "changed":
            assert int(want1[:, tops.GATE_WIN_EXACT].min()) == \
                (th + 2) * (tw + 2) * cin
        for c, p, w in inputs:
            got1 = tile_delta.tile_delta_gate_canvas(c, p, idx, th, tw, q)
            s, win = tile_delta.tile_delta_gate(c, w, idx, th, tw, q)
            assert torch.equal(got1, want1)
            assert torch.equal(s, want_s) and torch.equal(s, got1)
            assert _bits_equal(win, want_w)
    torch.cuda.synchronize()
    for k in ("tile_delta_gate_canvas", "tile_delta_gate"):
        assert _build.LAUNCHES[k] > before.get(k, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 100, 6536])
def test_cuda_gate_compact_equals_full(cuda, n):
    """A gate launch on any subset of the fleet's rows, in any order, gives
    the full launch's bits on those rows (B1; B5 with the subset's
    reference rows)."""
    tile, C, H, W, fleet_n = 16, 20, 1088, 1920, 52288
    rng = np.random.default_rng(n)
    cells = np.sort(rng.choice(C * (H // tile) * (W // tile), fleet_n,
                               replace=False))
    cam, rest = np.divmod(cells, (H // tile) * (W // tile))
    ty, tx = np.divmod(rest, W // tile)
    idx = torch.as_tensor(np.stack([cam, ty, tx], 1).astype(np.int32),
                          device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    cur_p = torch.nn.functional.pad(
        torch.randn((C, H, W, 3), generator=gen, device=cuda),
        (0, 0, 1, 1, 1, 1))
    prev_p = cur_p + (torch.rand(cur_p.shape, generator=gen, device=cuda)
                      < 0.01) * 20.0
    ref_win = tref.gather_windows(prev_p, idx, tile, tile)
    sub = torch.as_tensor(rng.permutation(fleet_n)[:n], device=cuda)
    full = tile_delta.tile_delta_gate_canvas(cur_p, prev_p, idx, tile, tile)
    part = tile_delta.tile_delta_gate_canvas(cur_p, prev_p,
                                             idx[sub].contiguous(), tile,
                                             tile)
    assert torch.equal(part, full[sub])
    s_full, w_full = tile_delta.tile_delta_gate(cur_p, ref_win, idx, tile,
                                                tile)
    s, w = tile_delta.tile_delta_gate(cur_p, ref_win[sub].contiguous(),
                                      idx[sub].contiguous(), tile, tile)
    assert torch.equal(s_full, full)
    assert torch.equal(s, full[sub]) and torch.equal(w, w_full[sub])


@pytest.mark.cuda
def test_cuda_fractions_on_a_ragged_grid(cuda):
    """A grid past the frame's edge (the 1080-px legs' case): the
    fractions on the card equal those on the CPU, and B10's rows equal the
    canvas gate's body columns on the same camera."""
    t = 16
    rng = np.random.default_rng(10)
    grid = rng.random((5, 4)) < 0.6
    grid[-1] = True
    prev = rng.normal(size=(5 * t - 8, 4 * t - 5, 3)).astype(np.float32)
    cur = prev.copy()
    cur[20:60, 10:40] += 30.0
    for fn in (tenc.tile_static_fraction, tenc.tile_halo_static_fraction):
        on_card = fn(_t(cur).to(cuda), _t(prev).to(cuda), grid, t)
        assert on_card == fn(cur, prev, grid, t, device="cpu")
        assert fn(cur, prev, grid, t) == on_card  # numpy: the card
    a, b = tenc.pad_to_grid(_t(cur).to(cuda), _t(prev).to(cuda),
                             grid.shape, t)
    rows = _t(tops.mask_to_indices(grid)).to(cuda)
    body = tile_delta.tile_delta(a, b, rows, t, t)
    pad = (0, 0, 1, 1, 1, 1)
    gate = tile_delta.tile_delta_gate_canvas(
        torch.nn.functional.pad(a, pad)[None].contiguous(),
        torch.nn.functional.pad(b, pad)[None].contiguous(),
        torch.nn.functional.pad(rows, (1, 0)), t, t)
    assert torch.equal(body[:, :4], gate[:, :4])


def _frame_pair(rng, shape, kind):
    """(prev, cur) (H, W, C) frames: "ties" -- ``_half_grid_pair``;
    "saturate" -- the same with NaN, +-Inf and +-3e10 deltas (cur and prev
    both infinite at some places), whose quotients the quantizer's cast
    saturates at every qstep here; "changed" -- every element moved by 16
    to 32, so no scan row holds a zero run."""
    if kind == "changed":
        prev = rng.normal(size=shape).astype(np.float32)
        return prev, prev + rng.uniform(16, 32, shape).astype(np.float32)
    prev, cur = _half_grid_pair(rng, shape)
    if kind == "saturate":
        spots = rng.choice(cur.size, 40, replace=False)
        for k, v in enumerate((np.nan, np.inf, -np.inf, 3e10, -3e10)):
            cur.reshape(-1)[spots[8 * k:8 * k + 6]] = v
            prev.reshape(-1)[spots[8 * k + 4:8 * k + 8]] = v
    return prev, cur


# (th, tw, C): scan rows of 24 (a partial 32-lane chunk), 40, 48 (the
# detector's), 80 and 72 (two 64-element chunks) and 21 floats (odd); a
# 40-pixel column strip (two 32-pixel chunks); Cin 3 and 5
DELTA_CASES = [(8, 8, 3), (8, 8, 5), (16, 16, 3), (16, 16, 5), (8, 7, 3),
               (16, 24, 3), (40, 8, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ties", "saturate", "changed"])
@pytest.mark.parametrize("th,tw,cin", DELTA_CASES)
def test_cuda_frame_pair_kernels_bitwise_on_hard_content(cuda, kind, th, tw,
                                                         cin):
    """B10 and B11 bitwise against their plain versions on the card and on
    the CPU (both saturate their casts), at qstep 1, 8 and 13.  The route
    function agrees with the launcher, and at the detector's extents the
    generic instance (copies 4 bytes off an 8-byte boundary) gives the
    detector's bits."""
    rng = np.random.default_rng(12)
    grid = rng.random((5, 6)) < 0.6
    grid[0, 0] = grid[-1, -1] = True
    prev, cur = _frame_pair(rng, (5 * th, 6 * tw, cin), kind)
    rows = _t(tops.mask_to_indices(grid))
    inputs = [(_t(cur).to(cuda), _t(prev).to(cuda))]
    routes = ["generic"]
    if (cin, th, tw) == tile_delta.GATE_DETECTOR:
        inputs.append(tuple(_misaligned(a) for a in inputs[0]))
        routes.insert(0, "detector")
    lib = _build.library()
    for (c, p), route in zip(inputs, routes):
        args = (cin, th, tw, c.shape[1], c.data_ptr(), p.data_ptr())
        assert tile_delta.delta_route(*args) == route
        assert lib.tile_delta_route(*args) == (route == "detector")
    d_rows = rows.to(cuda)
    before = dict(_build.LAUNCHES)
    for fn, plain in ((tile_delta.tile_delta, tref.tile_delta),
                      (tile_delta.tile_delta_halo, tref.tile_delta_halo)):
        for q in (1.0, 8.0, 13.0):
            want = plain(*inputs[0], d_rows, th, tw, q)
            assert torch.equal(want.cpu(),
                               plain(_t(cur), _t(prev), rows, th, tw, q))
            for c, p in inputs:
                assert torch.equal(fn(c, p, d_rows, th, tw, q), want)
            if kind == "changed" and fn is tile_delta.tile_delta:
                assert (want[:, 1] == th * tw * cin).all()
                assert (want[:, 2] == 0).all()
    torch.cuda.synchronize()
    for k in ("tile_delta", "tile_delta_halo"):
        assert _build.LAUNCHES[k] == before.get(k, 0) + 3 * len(inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("name,th,tw,frame", [
    ("tile_delta", 80, 80, (160, 240)),
    ("tile_delta_halo", 1088, 1024, (1088, 1920))])
def test_cuda_frame_pair_kernels_past_the_old_cap(cuda, name, th, tw, frame):
    """Tiles whose quantized deltas passed the 48 KB the kernels once kept
    in shared memory (B10: 19,200 at 80x80x3; B11: 12,672 in the ring of
    1088x1024x3) give their plain versions' bits; an empty set launches
    nothing."""
    rng = np.random.default_rng(13)
    prev, cur = (_t(a).to(cuda) for a in _frame_pair(
        rng, frame + (3,), "ties"))
    ny, nx = frame[0] // th, frame[1] // tw
    rows = _t(np.argwhere(np.ones((ny, nx), bool)).astype(np.int32)) \
        .to(cuda)
    fn, plain = getattr(tile_delta, name), getattr(tref, name)
    before = _build.LAUNCHES[name]
    for q in (1.0, 8.0, 13.0):
        assert torch.equal(fn(cur, prev, rows, th, tw, q),
                           plain(cur, prev, rows, th, tw, q))
    assert fn(cur, prev, rows[:0], th, tw).shape == (0, tops.STATS_WIDTH)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 3


def _trace(seed, n_steps=6):
    """Ragged frames, static except a moving patch; step 3 is static."""
    rng = np.random.default_rng(seed)
    frames = {0: [rng.normal(size=(30, 40, 3)), rng.normal(size=(24, 29, 3))],
              1: [rng.normal(size=(40, 24, 3))]}
    frames = {g: [f.astype(np.float32) for f in fs]
              for g, fs in frames.items()}
    steps = [frames]
    for k in range(1, n_steps):
        cur = {g: [f.copy() for f in fs] for g, fs in steps[-1].items()}
        if k != 3:
            f = cur[k % 2][0]
            y = int(rng.integers(0, f.shape[0] - 6))
            x = int(rng.integers(0, f.shape[1] - 6))
            f[y:y + 6, x:x + 6] = rng.normal(size=(6, 6, 3))
        steps.append(cur)
    return steps


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_cuda_fleet_steps_match_cpu(cuda, threshold):
    """The fleet step on the card against the same step on the CPU: equal
    dispatches and ReuseStats (gate stats included), head maps within
    1e-4, and on the card the threshold-0 reuse identity bitwise."""
    _, grids, _, _, _, _ = _fleet(7, 8)
    grids = {0: grids[:2], 1: grids[2:]}
    cfg = tdet.DetectorConfig(tile=8)
    cpu = tdet.RoIDetector(cfg, seed=3, device="cpu")
    gpu = tdet.RoIDetector.from_numpy(cfg, [w.numpy() for w in cpu.weights],
                                      cpu.head.numpy(), device=cuda)
    c_cache, g_cache = tdet.PackedActivationCache(), \
        tdet.PackedActivationCache()
    for frames in _trace(8):
        g_frames = {g: [_t(f).to(cuda) for f in fs]
                    for g, fs in frames.items()}
        c_out, c_counts, c_stats = trt.fleet_reuse_step(
            cpu, frames, grids, c_cache, threshold, 0.125)
        g_out, g_counts, g_stats = trt.fleet_reuse_step(
            gpu, g_frames, grids, g_cache, threshold, 0.125)
        assert g_counts == c_counts
        for f in dataclasses.fields(c_stats):
            a, b = getattr(g_stats, f.name), getattr(c_stats, f.name)
            if f.name == "gate_stats":
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name
        for g in c_out:
            for a, b in zip(g_out[g], c_out[g]):
                assert (a.cpu() - b).abs().max().item() <= 1e-4
        if threshold == 0.0:
            kept = {g: [h.clone() for h in hs] for g, hs in g_out.items()}
            full, _ = trt.fleet_inference_step(gpu, g_frames, grids)
            assert all(torch.equal(a, b) for g in full
                       for a, b in zip(kept[g], full[g]))


@pytest.mark.cuda
def test_cuda_ref_modes_bitwise_equal(cuda):
    """On the card, canvas and packed reference modes at threshold 0: equal
    dispatches and ReuseStats (gate stats included), bitwise-equal head
    maps, both equal to a cold recompute."""
    _, grids, _, _, _, _ = _fleet(11, 8)
    grids = {0: grids[:2], 1: grids[2:]}
    det = tdet.RoIDetector(tdet.DetectorConfig(tile=8), seed=4, device=cuda)
    caches = {m: tdet.PackedActivationCache(ref_mode=m)
              for m in ("canvas", "packed")}
    for frames in _trace(12):
        g_frames = {g: [_t(f).to(cuda) for f in fs]
                    for g, fs in frames.items()}
        c_out, c_counts, c_st = trt.fleet_reuse_step(
            det, g_frames, grids, caches["canvas"], 0.0, 0.125)
        c_out = {g: [h.clone() for h in hs] for g, hs in c_out.items()}
        p_out, p_counts, p_st = trt.fleet_reuse_step(
            det, g_frames, grids, caches["packed"], 0.0, 0.125)
        assert c_counts == p_counts
        for f in dataclasses.fields(c_st):
            a, b = getattr(p_st, f.name), getattr(c_st, f.name)
            if f.name == "gate_stats":
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name
        full, _ = trt.fleet_inference_step(det, g_frames, grids)
        assert all(torch.equal(a, b) and torch.equal(a, f)
                   for g in full
                   for a, b, f in zip(c_out[g], p_out[g], full[g]))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("channels", [(8, 16, 16), (6, 12, 5)])
def test_cuda_slice_kernels_match_plain_versions(cuda, tile, channels):
    """B6 (each later layer), B7, B8 (one frame and a batch) within 1e-4 of
    their plain versions; B9 bit-exact.  The instances of the entry kernel
    agree bit for bit: ReLU of B7 is B2, B8 is B2 on one camera."""
    rng, grids, idx, nbr, H, W = _fleet(40, tile)
    C = len(SHAPES)
    chans = (3,) + channels
    ws = [_t((rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci))
             .astype(np.float32)).to(cuda)
          for ci, co in zip(chans[:-1], chans[1:])]
    x = _t(rng.normal(size=(C, H, W, 3)).astype(np.float32)).to(cuda)
    d_idx, d_nbr = _t(idx).to(cuda), _t(nbr).to(cuda)
    before = dict(_build.LAUNCHES)
    f = roi_conv.roi_conv_fleet(x, ws[0], d_idx, tile, tile)
    assert (f - tref.roi_conv_fleet(x, ws[0], d_idx, tile, tile)).abs() \
        .max().item() <= 1e-4
    assert torch.equal(torch.relu(f), roi_conv.roi_conv_entry(
        x, ws[0], d_idx, tile, tile))
    p = torch.relu(tref.roi_conv_fleet(x, ws[0], d_idx, tile, tile))
    for w in ws[1:]:
        got = roi_conv.roi_conv_packed(p, w, d_nbr)
        want = tref.roi_conv_packed(p, w, d_nbr)
        assert (got - want).abs().max().item() <= 1e-4
        p = torch.relu(want)
    frame = x[0].contiguous()
    rows = _t(tops.mask_to_indices(grids[0])).to(cuda)
    one = roi_conv.roi_conv(frame, ws[0], rows, tile, tile)
    assert (one - tref.roi_conv(frame, ws[0], rows, tile, tile)).abs() \
        .max().item() <= 1e-4
    assert torch.equal(one, f[d_idx[:, 0] == 0])
    batch = roi_conv.roi_conv(x, ws[0], rows, tile, tile)
    assert all(torch.equal(batch[b], roi_conv.roi_conv(
        x[b].contiguous(), ws[0], rows, tile, tile)) for b in range(C))
    act = _t(rng.normal(size=(H, W, 10)).astype(np.float32)).to(cuda)
    tiles = sbnet.sbnet_gather(act, rows, tile, tile)
    assert torch.equal(tiles, tref.sbnet_gather(act, rows, tile, tile))
    base = torch.zeros_like(act)
    out = sbnet.sbnet_scatter(tiles, rows, base.clone())
    assert torch.equal(out, tref.sbnet_scatter(tiles, rows, base))
    torch.cuda.synchronize()
    for k in ("roi_conv_fleet", "roi_conv_packed", "roi_conv",
              "sbnet_gather", "sbnet_scatter"):
        assert _build.LAUNCHES[k] > before.get(k, 0)


def _misaligned(t):
    """A copy of ``t`` whose data start 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
def test_cuda_entry_routes_agree_bitwise(cuda):
    """The entry family's two instances give the same bits: the frames at
    the detector's extents take the compiled-in instance, a copy 4 bytes
    off a 16-byte boundary the generic one (B2, B7, B8 on one frame and
    batched).  ReLU of B7 is B2, B8 is B7's rows of its camera and the
    batch is B8 frame by frame, bitwise; all within 1e-5 of the plain
    versions."""
    tile = 16
    rng, grids, idx, _, H, W = _fleet(70, tile)
    C = len(SHAPES)
    x = _t(rng.normal(size=(C, H, W, 3)).astype(np.float32)).to(cuda)
    w = _t((rng.normal(size=(3, 3, 3, 8)) / np.sqrt(27))
           .astype(np.float32)).to(cuda)
    xm = _misaligned(x)
    lib = _build.library()
    for frames, route in ((x, "detector"), (xm, "generic")):
        assert roi_conv.entry_route(3, 8, tile, tile, W,
                                    frames.data_ptr()) == route
        assert lib.roi_conv_entry_route(3, 8, tile, tile, W,
                                        frames.data_ptr()) == \
            (route == "detector")
    d_idx = _t(idx).to(cuda)
    fleet = roi_conv.roi_conv_fleet(x, w, d_idx, tile, tile)
    entry = roi_conv.roi_conv_entry(x, w, d_idx, tile, tile)
    assert torch.equal(fleet, roi_conv.roi_conv_fleet(xm, w, d_idx, tile,
                                                      tile))
    assert torch.equal(entry, roi_conv.roi_conv_entry(xm, w, d_idx, tile,
                                                      tile))
    assert torch.equal(torch.relu(fleet), entry)
    assert (fleet - tref.roi_conv_fleet(x, w, d_idx, tile, tile)).abs() \
        .max().item() <= 1e-5
    rows = _t(tops.mask_to_indices(grids[0])).to(cuda)
    batch = roi_conv.roi_conv(x, w, rows, tile, tile)
    assert torch.equal(batch, roi_conv.roi_conv(xm, w, rows, tile, tile))
    for b in range(C):
        one = roi_conv.roi_conv(x[b], w, rows, tile, tile)
        assert torch.equal(batch[b], one), b
        assert torch.equal(one, roi_conv.roi_conv(_misaligned(x[b]), w, rows,
                                                  tile, tile)), b
    assert torch.equal(batch[0], fleet[d_idx[:, 0] == 0])
    assert (batch - tref.roi_conv(x, w, rows, tile, tile)).abs().max() \
        .item() <= 1e-5


# compact sets as the warm step launches them: one tile, fewer tiles than
# the card has SMs, an eighth of the fleet's rows, and all of them in
# another order, out of the 4x5 fleet's 52,288 tiles on 1088x1920 frames
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 100, 6536, 52288])
def test_cuda_entry_compact_equals_full(cuda, n):
    """A launch on any subset of the rows, in any order, gives the full
    launch's bits on those rows (B2 and B7)."""
    tile, C, H, W, fleet_n = 16, 20, 1088, 1920, 52288
    rng = np.random.default_rng(n)
    cells = np.sort(rng.choice(C * (H // tile) * (W // tile), fleet_n,
                               replace=False))
    cam, rest = np.divmod(cells, (H // tile) * (W // tile))
    ty, tx = np.divmod(rest, W // tile)
    idx = torch.as_tensor(np.stack([cam, ty, tx], 1).astype(np.int32),
                          device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((C, H, W, 3), generator=gen, device=cuda)
    w = torch.randn((3, 3, 3, 8), generator=gen, device=cuda) / 27 ** 0.5
    sub = torch.as_tensor(rng.permutation(fleet_n)[:n], device=cuda)
    for fn in (roi_conv.roi_conv_entry, roi_conv.roi_conv_fleet):
        full = fn(x, w, idx, tile, tile)
        part = fn(x, w, idx[sub].contiguous(), tile, tile)
        assert part.shape == (n, tile, tile, 8)
        assert torch.equal(part, full[sub])


def _border_case(seed, Cin, Cout, th, tw, shapes, cuda):
    """Frames whose tile grids have every border tile active and the
    interior at random, their (cam, ty, tx) rows and seeded weights."""
    rng = np.random.default_rng(seed)
    grids = []
    for s in shapes:
        g = rng.random(s) < 0.4
        g[0, :] = g[-1, :] = g[:, 0] = g[:, -1] = True
        grids.append(g)
    idx, _ = tops.fleet_indices(grids)
    H = max(s[0] for s in shapes) * th
    W = max(s[1] for s in shapes) * tw
    x = rng.normal(size=(len(shapes), H, W, Cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, Cin, Cout)) / np.sqrt(9 * Cin)) \
        .astype(np.float32)
    return grids, _t(idx).to(cuda), _t(x).to(cuda), _t(w).to(cuda)


# the shapes of tests/test_torch_entry.py: the detector's extents, W * Cin
# % 4 == 2 (tile 8 x 10; Cin 5 on 6x6 tiles), Cin 5 with Cout 12
@pytest.mark.cuda
@pytest.mark.parametrize("Cin,Cout,th,tw,shapes", [
    (3, 8, 16, 16, [(3, 4), (2, 3), (4, 2)]),
    (3, 8, 8, 10, [(4, 5), (3, 3)]),
    (5, 12, 16, 16, [(3, 3), (2, 4)]),
    (5, 12, 6, 6, [(4, 5), (5, 3)]),
])
def test_cuda_entry_family_at_borders(cuda, Cin, Cout, th, tw, shapes):
    """B2, B7 and B8 within 1e-5 of their plain versions on tiles at every
    frame border and corner, on the instance the route names; B8 on each
    camera's frame equals B7's rows of that camera bitwise."""
    grids, idx, x, w = _border_case(Cin * 100 + th, Cin, Cout, th, tw,
                                    shapes, cuda)
    route = roi_conv.entry_route(Cin, Cout, th, tw, x.shape[2],
                                 x.data_ptr())
    assert route == ("detector" if (Cin, Cout, th, tw) ==
                     roi_conv.ENTRY_DETECTOR else "generic")
    assert _build.library().roi_conv_entry_route(
        Cin, Cout, th, tw, x.shape[2], x.data_ptr()) == (route == "detector")
    fleet = roi_conv.roi_conv_fleet(x, w, idx, th, tw)
    assert (fleet - tref.roi_conv_fleet(x, w, idx, th, tw)).abs().max() \
        .item() <= 1e-5
    entry = roi_conv.roi_conv_entry(x, w, idx, th, tw)
    assert (entry - tref.roi_conv_entry(x, w, idx, th, tw)).abs().max() \
        .item() <= 1e-5
    assert torch.equal(torch.relu(fleet), entry)
    for c in range(len(grids)):
        sel = idx[:, 0] == c
        rows = idx[sel, 1:].contiguous()
        one = roi_conv.roi_conv(x[c], w, rows, th, tw)
        assert (one - tref.roi_conv(x[c], w, rows, th, tw)).abs().max() \
            .item() <= 1e-5
        assert torch.equal(one, fleet[sel])
        batch = roi_conv.roi_conv(x, w, rows, th, tw)
        assert (batch - tref.roi_conv(x, w, rows, th, tw)).abs().max() \
            .item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16])
def test_cuda_fused_equals_per_layer_bitwise(cuda, tile):
    """With the kernels: the fused stack (B2 + B3) equals the per-layer
    chain (B7 or B8, then B6 + ReLU per layer) bitwise, on the fleet and
    on each camera of ragged frames; ``roi_forward`` equals the one-camera
    ``fleet_forward``."""
    _, grids, _, _, _, _ = _fleet(41, tile)
    det = tdet.RoIDetector(tdet.DetectorConfig(tile=tile), seed=5,
                           device=cuda)
    rng = np.random.default_rng(42)
    frames = [torch.as_tensor(rng.normal(size=(g.shape[0] * tile - 3,
                                               g.shape[1] * tile - 1, 3))
                              .astype(np.float32), device=cuda)
              for g in grids]
    fused = det.fleet_forward(frames, grids)
    layers = det.fleet_forward_layers(frames, grids)
    for c, (f, g) in enumerate(zip(frames, grids)):
        one = det.roi_forward(f, g)
        assert torch.equal(fused[c], layers[c]), c
        assert torch.equal(one, det.roi_forward_layers(f, g)), c
        assert torch.equal(one, det.fleet_forward([f], [g])[0]), c
        assert torch.equal(one, fused[c]), c


# B3's persistent grid at the launch sizes that stress it: one tile, fewer
# tiles than one wave of CTAs, and a count that is no multiple of the grid
# (1,621 is prime); the detector's widths (the compiled-in instance) and
# odd widths (the generic one)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 200, 1621])
@pytest.mark.parametrize("channels", [(8, 16, 16), (6, 12, 10, 5)])
def test_cuda_stack_launch_sizes(cuda, n, channels):
    """B3 within 1e-4 of its plain version and bitwise equal to the
    per-layer chain (B6 + ReLU per layer) on a grid of exactly n active
    tiles of 16x16."""
    tile = 16
    rng = np.random.default_rng(n + len(channels))
    shape = (1, 1) if n == 1 else (40, 50) if n > 200 else (10, 25)
    grid = np.zeros(shape[0] * shape[1], bool)
    grid[rng.permutation(grid.size)[:n]] = True
    grid = grid.reshape(shape)
    nbr = _t(tops.fleet_neighbor_table([grid])).to(cuda)
    packed = torch.relu(_t(rng.normal(size=(n, tile, tile, channels[0]))
                           .astype(np.float32)).to(cuda))
    ws = [_t((rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci))
             .astype(np.float32)).to(cuda)
          for ci, co in zip(channels[:-1], channels[1:])]
    before = _build.LAUNCHES["roi_conv_stack"]
    got = roi_conv.roi_conv_stack(packed, ws, nbr)
    want = tref.roi_conv_stack(packed, ws, nbr)
    chain = packed
    for w in ws:
        chain = torch.relu(roi_conv.roi_conv_packed(chain, w, nbr))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["roi_conv_stack"] == before + 1
    assert got.shape == (n, tile, tile, channels[-1])
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, chain)


def _chain_case(rng, grids, idx, nbr, tile, chans, cuda):
    """ReLU'd packed input and seeded weights for ``chans`` on the card."""
    packed = torch.relu(_t(rng.normal(size=(idx.shape[0], tile, tile,
                                            chans[0]))
                           .astype(np.float32)).to(cuda))
    ws = [_t((rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci))
             .astype(np.float32)).to(cuda)
          for ci, co in zip(chans[:-1], chans[1:])]
    return packed, ws, _t(nbr).to(cuda)


# B6's compile-time instances (8 -> 16 and 16 -> 16 at tile 16) and the
# generic one (other tiles, odd widths)
@pytest.mark.cuda
@pytest.mark.parametrize("tile", [4, 8, 16])
@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16), (6, 12), (12, 5)])
def test_cuda_packed_layer_is_the_stack_body(cuda, tile, cin, cout):
    """B6 within 1e-4 of its plain version, with negative outputs (no
    ReLU); B6 is the stack kernel at one layer with its ReLU off, so its
    ReLU equals B3 at L = 1 on both routes, bitwise."""
    rng, grids, idx, nbr, _, _ = _fleet(50 + tile + cin, tile)
    packed, (w,), d_nbr = _chain_case(rng, grids, idx, nbr, tile,
                                      (cin, cout), cuda)
    before = dict(_build.LAUNCHES)
    got = roi_conv.roi_conv_packed(packed, w, d_nbr)
    want = tref.roi_conv_packed(packed, w, d_nbr)
    ring = roi_conv.roi_conv_stack(packed, [w], d_nbr)
    layers = roi_conv.roi_conv_stack_layers(packed, [w], d_nbr)
    torch.cuda.synchronize()
    assert got.shape == (idx.shape[0], tile, tile, cout)
    assert (got - want).abs().max().item() <= 1e-4
    assert got.min().item() < 0
    assert torch.equal(torch.relu(got), ring)
    assert torch.equal(torch.relu(got), layers)
    assert _build.LAUNCHES["roi_conv_packed"] == \
        before.get("roi_conv_packed", 0) + 1
    assert _build.LAUNCHES["roi_conv_stack"] == \
        before.get("roi_conv_stack", 0) + 2


# deeper than the ring route takes (L > tile), and at the ring's own depths
@pytest.mark.cuda
@pytest.mark.parametrize("tile,chans", [
    (4, (8, 16, 16, 16, 16, 16)), (16, (8,) + (16,) * 9),
    (8, (8, 16, 16)), (16, (8, 16, 16)), (8, (6, 12, 10, 5))])
def test_cuda_stack_layers_route(cuda, tile, chans):
    """The layer-by-layer route: one counted launch, bitwise equal to the
    B6 + ReLU chain and, where the ring route also applies, to it; within
    1e-4 of the plain version."""
    rng, grids, idx, nbr, _, _ = _fleet(60 + tile + len(chans), tile)
    packed, ws, d_nbr = _chain_case(rng, grids, idx, nbr, tile, chans, cuda)
    before = _build.LAUNCHES["roi_conv_stack"]
    got = roi_conv.roi_conv_stack_layers(packed, ws, d_nbr)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["roi_conv_stack"] == before + 1
    # the entry point's own route: this one past the ring's depth, else
    # the ring
    assert torch.equal(got, roi_conv.roi_conv_stack(packed, ws, d_nbr))
    chain = packed
    for w in ws:
        chain = torch.relu(roi_conv.roi_conv_packed(chain, w, d_nbr))
    assert got.shape == (idx.shape[0], tile, tile, chans[-1])
    assert torch.equal(got, chain)
    want = tref.roi_conv_stack(packed, ws, d_nbr)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_alignment_checks(cuda):
    """B3, B6 and B12's bf16 instance read 16-byte vectors, so a contiguous
    view that starts off a 16-byte boundary raises; B12's f32 instance
    reads scalars and takes one."""
    n, tile = 4, 16
    grid = np.ones((2, 2), bool)
    nbr = _t(tops.fleet_neighbor_table([grid])).to(cuda)
    flat = torch.ones(n * tile * tile * 8 + 1, device=cuda)
    packed = flat[1:].view(n, tile, tile, 8)
    ws = [torch.zeros((3, 3, 8, 16), device=cuda),
          torch.zeros((3, 3, 16, 16), device=cuda)]
    with pytest.raises(ValueError):
        roi_conv.roi_conv_stack(packed, ws, nbr)
    with pytest.raises(ValueError):
        roi_conv.roi_conv_packed(packed, ws[0], nbr)
    S, H, D = 128, 2, 32
    rng = np.random.default_rng(5)
    pos = _t(_packed_positions(rng, S, 100)).to(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        flat = _t(rng.normal(size=S * H * D + 1).astype(np.float32)) \
            .to(cuda, dtype)
        q = flat[1:].view(S, H, D)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError):
                roi_attention.roi_attention(q, q, q, pos, 64, 64)
        else:
            got, _ = roi_attention.roi_attention(q, q, q, pos, 64, 64)
            want, _ = tref.roi_attention(q, q, q, pos, 64, 64)
            assert (got - want)[:100].abs().max().item() <= 2e-5


def _packed_positions(rng, S, n_kept, span=4):
    pos = np.full(S, roi_attention.PAD_POS, np.int32)
    pos[:n_kept] = np.sort(rng.choice(span * S, n_kept, replace=False))
    return pos


# the sweep of tests/test_kernels.py and the block-skip shapes of
# tests/test_packed_path.py (bq = bk = 32, 25% and 60% kept)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("S,H,D,bq,bk,keep", [
    (128, 2, 32, 64, 64, 0.8), (256, 4, 64, 128, 128, 0.8),
    (256, 1, 128, 64, 128, 0.8), (256, 2, 32, 32, 32, 0.25),
    (256, 2, 32, 32, 32, 0.6), (512, 3, 16, 128, 64, 0.5),
    (256, 2, 120, 64, 128, 0.8), (128, 2, 24, 64, 64, 0.8)])
def test_cuda_roi_attention_matches_plain_version(cuda, dtype, tol, S, H, D,
                                                  bq, bk, keep):
    """B12 against its plain version on real rows; the skipped and the
    exhaustive walk bitwise equal on real rows; visited counts equal to
    the host bound (every block without the skip)."""
    rng = np.random.default_rng(S + D + bq)
    n_kept = int(keep * S)
    pos = _packed_positions(rng, S, n_kept)
    q, k, v = (torch.as_tensor(rng.normal(size=(S, H, D)), dtype=dtype,
                               device=cuda) for _ in range(3))
    p = torch.as_tensor(pos, device=cuda)
    before = _build.LAUNCHES["roi_attention"]
    out, vis = tops.roi_attention(q, k, v, p, bq, bk, return_stats=True)
    full, vis_full = tops.roi_attention(q, k, v, p, bq, bk,
                                        causal_skip=False, return_stats=True)
    want, want_vis = tref.roi_attention(q, k, v, p, bq, bk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["roi_attention"] == before + 2
    assert out.dtype == dtype and out.shape == (S, H, D)
    err = (out[:n_kept].float() - want[:n_kept].float()).abs().max().item()
    assert err <= tol
    if dtype == torch.bfloat16:
        # per element: one to two bf16 steps of |want| plus room for f32
        # sums, the bar of chip_smoke.py (ATTN_REL, ATTN_ABS)
        g, w = out[:n_kept].float(), want[:n_kept].float()
        share = ((g - w).abs() / (2.0 ** -7 * w.abs() + 1e-3)).max().item()
        assert share <= 1.0
    # rows the kernel defines on padding too: the mixed q-block's, equal
    # to the plain version's (which mirrors its visit bound)
    assert (out.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(out[:n_kept], full[:n_kept])
    bound = tops.attention_visit_bound(pos, bq, bk)
    np.testing.assert_array_equal(vis.cpu().numpy(),
                                  np.broadcast_to(bound, (H, S // bq)))
    assert torch.equal(vis, want_vis)
    assert (vis_full == S // bk).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("S,H,D,bq,bk", [
    (96, 2, 32, 16, 16), (96, 2, 32, 16, 48), (192, 2, 64, 96, 64),
    (512, 2, 64, 256, 128), (512, 1, 128, 256, 16)])
def test_cuda_roi_attention_any_dividing_blocks(cuda, dtype, tol, S, H, D,
                                                bq, bk):
    """C1: blocks the kernel has no instance for, against the plain
    version at those blocks on real rows; real rows bitwise equal to a
    launch of ``kernel_blocks``' instance on the tokens padded to it; the
    visited counts equal the host bound at the caller's blocks; skip ==
    exhaustive on real rows."""
    rng = np.random.default_rng(S + bq + bk)
    n_kept = int(0.7 * S)
    pos = _packed_positions(rng, S, n_kept)
    q, k, v = (torch.as_tensor(rng.normal(size=(S, H, D)), dtype=dtype,
                               device=cuda) for _ in range(3))
    p = torch.as_tensor(pos, device=cuda)
    out, vis = tops.roi_attention(q, k, v, p, bq, bk, return_stats=True)
    full = tops.roi_attention(q, k, v, p, bq, bk, causal_skip=False)
    want, want_vis = tref.roi_attention(q, k, v, p, bq, bk)
    kq, kk = roi_attention.kernel_blocks(bq, bk)
    Sp = -(-S // np.lcm(kq, kk)) * int(np.lcm(kq, kk))
    pad = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Sp - S))
           for t in (q, k, v)]
    pp = torch.nn.functional.pad(p, (0, Sp - S), value=roi_attention.PAD_POS)
    direct, _ = roi_attention.roi_attention(*pad, pp, kq, kk)
    assert out.shape == (S, H, D) and vis.shape == (H, S // bq)
    g, w = out[:n_kept].float(), want[:n_kept].float()
    assert (g - w).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        share = ((g - w).abs() / (2.0 ** -7 * w.abs() + 1e-3)).max().item()
        assert share <= 1.0
    assert torch.equal(out[:n_kept], direct[:n_kept])
    assert torch.equal(out[:n_kept], full[:n_kept])
    bound = tops.attention_visit_bound(pos, bq, bk)
    np.testing.assert_array_equal(vis.cpu().numpy(),
                                  np.broadcast_to(bound, (H, S // bq)))
    assert torch.equal(vis, want_vis)


@pytest.mark.cuda
def test_cuda_roi_attention_all_padding_and_dense(cuda):
    """An all-padding stream visits nothing and gives exact zeros; keep-all
    positions give plain causal attention."""
    S = 128
    pos = torch.full((S,), roi_attention.PAD_POS, dtype=torch.int32,
                     device=cuda)
    q = torch.ones((S, 1, 16), device=cuda)
    out, vis = tops.roi_attention(q, q, q, pos, 64, 64, return_stats=True)
    assert int(vis.sum()) == 0 and float(out.abs().max()) == 0.0
    rng = np.random.default_rng(21)
    q, k, v = (torch.as_tensor(rng.normal(size=(S, 2, 32)),
                               dtype=torch.float32, device=cuda)
               for _ in range(3))
    ar = torch.arange(S, dtype=torch.int32, device=cuda)
    out = tops.roi_attention(q, k, v, ar, 64, 64)
    logits = torch.einsum("qhd,khd->hqk", q, k) / np.sqrt(32)
    logits = logits.masked_fill(~torch.ones(S, S, dtype=torch.bool,
                                            device=cuda).tril(), -1e30)
    want = torch.einsum("hqk,khd->qhd", logits.softmax(-1), v)
    assert (out - want).abs().max().item() <= 2e-5


@pytest.mark.cuda
def test_cuda_roi_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((96, 1, 32), device=cuda)
    pos = torch.zeros(96, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        roi_attention.roi_attention(q, q, q, pos, 64, 64)     # S % 64
    q = torch.zeros((128, 1, 136), device=cuda)
    pos = torch.zeros(128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        roi_attention.roi_attention(q, q, q, pos, 64, 64)     # D = 136


# ---------------------------------------------------------------------------
# the windowed and MoE decoders' plain PyTorch on the card (no kernel of
# their own): the same functions on CUDA and CPU tensors, at SMOKE widths
# ---------------------------------------------------------------------------

def _both(cuda, *arrays):
    return ([torch.as_tensor(a) for a in arrays],
            [torch.as_tensor(a).to(cuda) for a in arrays])


@pytest.mark.cuda
@pytest.mark.parametrize("S,window,q_block,n_pad", [
    (256, 32, 64, 0), (200, 48, 512, 40), (129, 16, 512, 0)])
def test_cuda_banded_attention_matches_cpu(cuda, S, window, q_block, n_pad):
    """Banded blockwise attention (PAD rows included) within 1e-5 of the
    CPU's."""
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(S)
    q, k, v = (rng.normal(size=(2, S, 4, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.stack([np.sort(rng.choice(2 * S, S, replace=False))
                    for _ in range(2)]).astype(np.int32)
    if n_pad:
        pos[:, -n_pad:] = roi_attention.PAD_POS
    cpu, dev = _both(cuda, q, k, v, pos)
    want, got = (TL.blockwise_attention(*t[:3], window=window,
                                        q_block=q_block, q_positions=t[3],
                                        kv_positions=t[3])
                 for t in (cpu, dev))
    assert (got.cpu() - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("cf,shared", [(4.0, True), (0.5, False)])
def test_cuda_moe_layer_matches_cpu(cuda, cf, shared):
    """``moe_layer`` with and without drops: the routing and the dropped
    share equal, y and the aux loss within 1e-5 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as TMoE
    cfg = get_config("deepseek-moe-16b", smoke=True).replace(
        capacity_factor=cf, dtype="float32")
    rng = np.random.default_rng(int(cf * 10))
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    arrays = [rng.normal(size=s) / np.sqrt(s[-2]) for s in
              ((2, 40, D), (D, E), (E, D, Fe), (E, D, Fe), (E, Fe, D))]
    if shared:
        arrays += [rng.normal(size=s) / np.sqrt(s[0]) for s in
                   ((D, 64), (D, 64), (64, D))]
    cpu, dev = _both(cuda, *(a.astype(np.float32) for a in arrays))
    outs = [TMoE.moe_layer(*t[:5], cfg, shared=tuple(t[5:]) or None)
            for t in (cpu, dev)]
    (wy, waux, wdrop), (gy, gaux, gdrop) = outs
    _, wi, _ = TMoE.router_topk(cpu[0], cpu[1], cfg.experts_per_token)
    _, gi, _ = TMoE.router_topk(dev[0], dev[1], cfg.experts_per_token)
    assert torch.equal(gi.cpu(), wi)
    assert (gy.cpu() - wy).abs().max().item() <= 1e-5
    assert abs(float(gaux) - float(waux)) <= 1e-5
    assert float(gdrop) == float(wdrop) and (float(wdrop) > 0) == (cf < 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube3-4b", "gemma3-27b",
                                  "deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_cuda_decoders_match_cpu(cuda, arch):
    """A prompt past the window prefilled into the rings, then three
    decode steps of a (2,) group at different positions: logits within
    1e-4 of the CPU's, float32."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.models.params import init_params
    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               kv_cache_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 73))
    logits = []
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        t = torch.as_tensor(toks, device=dev)
        caches = TM.init_cache(cfg, 2, 80, dev)
        out = [TM.prefill(p, cfg, {"tokens": t[:, :70]}, caches)[0]]
        pos = torch.tensor([70, 66], device=dev)
        for i in range(3):
            out.append(TM.decode_step(p, cfg, t[:, 70 + i:71 + i], caches,
                                      pos + i)[0])
        logits.append([o.cpu() for o in out])
    for want, got in zip(*logits):
        assert (got - want).abs().max().item() <= 1e-4


# ---------------------------------------------------------------------------
# the recurrent families' plain PyTorch on the card (rwkv6, zamba2's Mamba2
# hybrid; no kernel of their own), against the CPU at SMOKE widths
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_cuda_recurrent_blocks_match_cpu(cuda, arch):
    """Layer 0's ``rwkv6_block`` / ``mamba2_block`` over 48 tokens from a
    random state, then one step from the state it returns: the outputs
    and every state within 1e-4 of the CPU's, float32."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward as TF, rwkv as TR, ssm as TS
    from repro_torch.models.params import init_params
    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               kv_cache_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lp = TF.layer_params(TF._sub(params, "blocks_"), 0)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 49, cfg.d_model)).astype(np.float32)
    if arch == "rwkv6-7b":
        H, P, D = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.d_model
        st = [rng.normal(size=s).astype(np.float32)
              for s in ((2, H, P, P), (2, D), (2, D))]

        def block(a, p, s, one):
            return TR.rwkv6_block(a, p, cfg, TR.RWKVState(*s),
                                  single_step=one)
    else:
        H, N, P = cfg.ssm_num_heads, cfg.ssm_state_dim, cfg.ssm_head_dim
        st = [rng.normal(size=s).astype(np.float32)
              for s in ((2, H, N, P),
                        (2, cfg.ssm_conv_width - 1, TS.conv_dim(cfg)))]
        lp = TF._mamba_pdict(lp)

        def block(a, p, s, one):
            return TS.mamba2_block(a, p, cfg, TS.MambaState(*s),
                                   single_step=one)
    outs = []
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in lp.items()}
        xs = torch.as_tensor(x, device=dev)
        y, s = block(xs[:, :48], p, [torch.as_tensor(a, device=dev)
                                     for a in st], False)
        y1, s1 = block(xs[:, 48:], p, s, True)
        outs.append([t.cpu() for t in (y, *s, y1, *s1)])
    for want, got in zip(*outs):
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_cuda_recurrent_models_match_cpu(cuda, arch):
    """A 64-token prefill of a (2,) batch into the states (and zamba2's KV
    caches), then three decode steps at different positions: the logits
    and every cache within 1e-4 of the CPU's, float32."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import _tree_map
    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               kv_cache_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 67))
    results, trees = [], []
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        t = torch.as_tensor(toks, device=dev)
        logits, caches = TM.prefill(p, cfg, {"tokens": t[:, :64]},
                                    TM.init_cache(cfg, 2, 70, dev))
        out = [logits]
        pos = torch.tensor([64, 60], device=dev)
        for i in range(3):
            logits, caches = TM.decode_step(p, cfg, t[:, 64 + i:65 + i],
                                            caches, pos + i)
            out.append(logits)
        results.append([o.cpu() for o in out])
        trees.append(caches)

    def close(want, got):
        assert (got.float().cpu() - want.float()).abs().max().item() <= 1e-4

    for want, got in zip(*results):
        close(want, got)
    _tree_map(close, *trees)


# ---------------------------------------------------------------------------
# whisper's encoder-decoder (plain PyTorch, no kernel of its own), against
# the CPU at SMOKE widths
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("frames_dtype", [torch.float32, torch.bfloat16])
def test_cuda_whisper_matches_cpu(cuda, frames_dtype):
    """whisper-small SMOKE in float32: the encoder's memory over 40 frames
    of a (2,) batch, a 6-token prefill, then 8 decode steps at different
    positions (one row past ``max_target_len``): the memory, the logits
    and every cache within 1e-4 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward as TF
    from repro_torch.models import model as TM
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import _tree_map
    cfg = get_config("whisper-small", smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(2, 40, cfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 14))
    results, trees = [], []
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        f = torch.as_tensor(frames, device=dev).to(frames_dtype)
        t = torch.as_tensor(toks, device=dev)
        out = [TF.encoder_trunk(p, cfg, f)]
        logits, caches = TM.prefill(p, cfg, {"frames": f, "tokens": t[:, :6]},
                                    TM.init_cache(cfg, 2, 40, dev))
        out.append(logits)
        pos = torch.tensor([6, cfg.max_target_len - 3], device=dev)
        for i in range(8):
            logits, caches = TM.decode_step(p, cfg, t[:, 6 + i:7 + i],
                                            caches, pos + i)
            out.append(logits)
        results.append([o.cpu() for o in out])
        trees.append(caches)

    def close(want, got):
        assert (got.float().cpu() - want.float()).abs().max().item() <= 1e-4

    for want, got in zip(*results):
        close(want, got)
    _tree_map(close, *trees)


# ---------------------------------------------------------------------------
# the training step's plain PyTorch on the card (train_loss for every
# family, remat, causal_skip, AdamW, SyntheticLM), against the CPU at SMOKE
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["h2o-danube3-4b", "gemma3-27b", "mistral-nemo-12b",
               "deepseek-67b", "internvl2-26b", "deepseek-moe-16b",
               "qwen3-moe-235b-a22b", "rwkv6-7b", "zamba2-2.7b",
               "whisper-small"]


def _train_case(arch, seed=0, S=64):
    """(cfg, float32 params on the CPU, a CPU batch) at SMOKE."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.models import model as TM
    from repro_torch.models.params import init_params
    cfg = get_config(arch, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    b = TM.make_batch(cfg, ShapeCell("t", S, 2, "train"),
                      torch.Generator().manual_seed(seed + 1), "cpu")
    return cfg, params, {k: v.float() if v.is_floating_point() else v
                         for k, v in b.items()}


def _loss_and_grads(cfg, params, b, dev, **kw):
    from repro_torch.models import model as TM
    p = {k: v.detach().to(dev).requires_grad_(True)
         for k, v in params.items()}
    loss, metrics = TM.train_loss(p, cfg, {k: v.to(dev)
                                           for k, v in b.items()}, **kw)
    names = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in names],
                                allow_unused=True, materialize_grads=True)
    return (loss.detach().cpu(), {k: v.detach().cpu()
                                  for k, v in metrics.items()},
            {k: g.cpu() for k, g in zip(names, grads)})


def _grads_close(got, want, rel):
    for k in want:
        scale = max(want[k].abs().max().item(), 1e-30)
        assert (got[k] - want[k]).abs().max().item() <= rel * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_cuda_train_loss_matches_cpu(cuda, arch):
    """float32 at SMOKE: the loss within 1e-5 and every gradient leaf
    within 1e-4 of its largest |g| of the CPU's (the path the CPU tests
    hold against JAX) -- or within twice the CPU path's own rounding
    floor, where larger: how far its gradients move when the embedding
    moves by 2^-24 of itself (rwkv6's draw sits at 2.1e-4-3.5e-4) --,
    metrics within 1e-6; remat on == off within 1e-6 on the card."""
    cfg, params, b = _train_case(arch)
    l_cpu, m_cpu, g_cpu = _loss_and_grads(cfg, params, b, "cpu")
    l_dev, m_dev, g_dev = _loss_and_grads(cfg, params, b, cuda)
    assert abs(l_dev.item() - l_cpu.item()) <= 1e-5 * max(1, l_cpu.item())
    for k in m_cpu:
        assert abs(m_dev[k].item() - m_cpu[k].item()) <= 1e-6, k
    floor = 0.0
    for seed in (1, 2):
        e = params["embed"]
        e = e * (1 + 2 ** -24 * torch.randn(
            e.shape, generator=torch.Generator().manual_seed(seed)))
        g_p = _loss_and_grads(cfg, dict(params, embed=e), b, "cpu")[2]
        floor = max(floor, max(
            ((g_p[k] - g_cpu[k]).abs().max()
             / g_cpu[k].abs().max().clamp_min(1e-30)).item() for k in g_cpu))
    _grads_close(g_dev, g_cpu, max(1e-4, 2 * floor))
    l_nr, _, g_nr = _loss_and_grads(cfg, params, b, cuda, remat=False)
    assert abs(l_nr.item() - l_dev.item()) <= 1e-6
    _grads_close(g_nr, g_dev, 1e-6)


@pytest.mark.cuda
def test_cuda_causal_skip_equals_exhaustive_walk(cuda):
    """blockwise_attention at S = 2,048 (4 query blocks, 2 chunks), f32:
    the skip bitwise the exhaustive walk on every row; and mistral-nemo's
    loss with causal_skip == without, its gradients within 1e-6."""
    from repro_torch.models import layers as TL
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((2, 2048, 4, 32), generator=g, device=cuda)
               for _ in range(3))
    assert torch.equal(TL.blockwise_attention(q, k, v, causal_skip=True),
                       TL.blockwise_attention(q, k, v))
    cfg, params, b = _train_case("mistral-nemo-12b", S=2048)
    l_skip, _, g_skip = _loss_and_grads(cfg, params, b, cuda,
                                        causal_skip=True)
    l_ex, _, g_ex = _loss_and_grads(cfg, params, b, cuda)
    assert abs(l_skip.item() - l_ex.item()) <= 1e-6
    _grads_close(g_skip, g_ex, 1e-6)


@pytest.mark.cuda
def test_cuda_adamw_matches_cpu(cuda):
    """Three AdamW steps on h2o-danube3-4b SMOKE's leaves (bf16 and f32)
    with its gradients: parameters and moments within 1e-6 of each
    leaf's largest on the CPU."""
    from repro_torch.configs import TrainConfig
    from repro_torch.optim import adamw as TA
    cfg, params, b = _train_case("h2o-danube3-4b")
    _, _, grads = _loss_and_grads(cfg, params, b, "cpu")
    params["embed"] = params["embed"].bfloat16()
    tcfg = TrainConfig(warmup_steps=2, total_steps=10)
    runs = []
    for dev in ("cpu", cuda):
        p = {k: v.clone().to(dev) for k, v in params.items()}
        st = TA.adamw_init(p, device=dev)
        for i in range(3):
            g = {k: (v * (1 + i)).to(dev, p[k].dtype)
                 for k, v in grads.items()}
            p, st, _ = TA.adamw_update(p, g, st, tcfg)
        runs.append([{k: v.float().cpu() for k, v in t.items()}
                     for t in (p, st.m, st.v)])
    for want, got in zip(*runs):
        _grads_close(got, want, 1e-6)


@pytest.mark.cuda
def test_cuda_synthetic_lm_is_the_cpu_stream(cuda):
    from repro_torch.data.lm import SyntheticLM
    d = SyntheticLM(32000, 512, 4, seed=3)
    for step in (0, 9):
        a, b = d.batch(step, device="cpu"), d.batch(step)
        assert b["tokens"].device.type == "cuda"
        for k in a:
            assert torch.equal(a[k], b[k].cpu())


def _loop_state(params, dev):
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import TrainState
    p = {k: v.detach().clone().to(dev) for k, v in params.items()}
    return TrainState(p, adamw_init(p, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tp", "fsdp", "dp_only"])
def test_cuda_one_rank_route_equals_no_mesh(cuda, tmp_path, mode):
    """h2o-danube3-4b SMOKE on a one-rank NCCL mesh, without compression
    and with int8 over 2 microbatches: 3 steps == 3 steps with
    ``mesh=None``, bitwise (parameters, both moments, metrics), under
    deterministic algorithms."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import init_state, make_train_step
    cfg = get_config("h2o-danube3-4b", smoke=True)
    data = SyntheticLM(cfg.vocab_size, 128, 4, seed=0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_train_mesh((1, 1), device=cuda)
        for mb, comp in ((0, "none"), (2, "int8")):
            tcfg = TrainConfig(microbatch=mb, grad_compression=comp,
                               sharding_mode=mode, warmup_steps=2)
            runs = []
            for m in (None, mesh):
                st = init_state(cfg, tcfg, m, device=cuda)
                step = make_train_step(cfg, tcfg, m)
                mets = []
                for s in range(3):
                    st, met = step(st, data.batch(s, device=cuda))
                    mets.append(met)
                runs.append((st, mets))
            (a, am), (b, bm) = runs
            assert torch.equal(a.opt.step, b.opt.step)
            for n in a.params:
                assert torch.equal(a.params[n], b.params[n]), n
                assert torch.equal(a.opt.m[n], b.opt.m[n]), n
                assert torch.equal(a.opt.v[n], b.opt.v[n]), n
            for x, y in zip(am, bm):
                assert all(torch.equal(x[k], y[k]) for k in x)
    finally:
        torch.use_deterministic_algorithms(was)
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube3-4b", "deepseek-moe-16b",
                                  "zamba2-2.7b"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    """``make_train_step`` at SMOKE in float32 with 2 microbatches, and
    with int8: the gradients AdamW receives on the card within 1e-4 of
    each leaf's largest of the CPU's (plus one quantization step of the
    row's scale under int8), the loss and grad_norm within 1e-5;
    ``quantize_int8`` on the card == the CPU's, bitwise."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.distributed.compression import quantize_int8
    from repro_torch.train.loop import make_train_step
    cfg, params, _ = _train_case(arch)
    batch = SyntheticLM(cfg.vocab_size, 64, 4, seed=0).batch(0,
                                                            device="cpu")
    for comp in ("none", "int8"):
        step = make_train_step(cfg, TrainConfig(microbatch=2,
                                                grad_compression=comp))
        _, want = step.gradients(_loop_state(params, "cpu"), batch)
        _, got = step.gradients(_loop_state(params, cuda), batch)
        for k, g in want.items():
            allow = 1e-4 * g.abs().max().clamp_min(1e-30)
            if comp == "int8":
                allow = allow + quantize_int8(g)[1]
            assert bool(((got[k].cpu() - g).abs() <= allow).all()), k
        _, mc = step(_loop_state(params, "cpu"), batch)
        _, md = step(_loop_state(params, cuda), batch)
        for k in ("loss", "grad_norm"):
            assert abs(md[k].item() - mc[k].item()) <= 1e-5 * max(
                1.0, abs(mc[k].item())), k
        if comp == "int8":
            g = want["embed"]
            qc, sc = quantize_int8(g)
            qd, sd = quantize_int8(g.to(cuda))
            assert torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc)


@pytest.mark.cuda
def test_cuda_tensor_parallel_collectives_one_rank(cuda, tmp_path):
    """On a one-rank NCCL (1, 1) mesh the four autograd collectives
    return their CUDA input itself, and a two-dim placement's shard,
    gather and batch gather are the full tensor."""
    import torch.distributed as dist

    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.shardings import P, Placement, make_dist
    from repro_torch.launch.mesh import make_train_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_train_mesh((1, 1), device=cuda)
        d = make_dist(mesh)
        x = torch.randn(3, 8, device=cuda, requires_grad=True)
        for fn in (T.copy_to, T.reduce_from, T.gather_last,
                   T.scatter_last):
            assert fn(x, d) is x
        pl = Placement(mesh, P(None, "data", "model"))
        full = torch.randn(2, 4, 8, device=cuda)
        assert pl.shard(full) is full and pl.gather(full) is full
        assert pl.gather_batch(full) is full
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_cuda_one_rank_model_axis_route_equals_no_mesh(cuda, tmp_path,
                                                       arch):
    """The SMOKE MoE, RWKV6 and Mamba2 families under tp and fsdp with
    int8 over 2 microbatches on a one-rank NCCL mesh: 2 steps == 2 steps
    with ``mesh=None``, bitwise, under deterministic algorithms."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import init_state, make_train_step
    cfg = get_config(arch, smoke=True)
    data = SyntheticLM(cfg.vocab_size, 64, 4, seed=0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_train_mesh((1, 1), device=cuda)
        for mode in ("tp", "fsdp"):
            tcfg = TrainConfig(microbatch=2, grad_compression="int8",
                               sharding_mode=mode, warmup_steps=2)
            runs = []
            for m in (None, mesh):
                st = init_state(cfg, tcfg, m, device=cuda)
                step = make_train_step(cfg, tcfg, m)
                mets = []
                for s in range(2):
                    st, met = step(st, data.batch(s, device=cuda))
                    mets.append(met)
                runs.append((st, mets))
            (a, am), (b, bm) = runs
            for n in a.params:
                assert torch.equal(a.params[n], b.params[n]), (mode, n)
                assert torch.equal(a.opt.v[n], b.opt.v[n]), (mode, n)
            for x, y in zip(am, bm):
                assert all(torch.equal(x[k], y[k]) for k in x)
    finally:
        torch.use_deterministic_algorithms(was)
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
def test_cuda_flash_decode_combine_matches_cpu(cuda, grouped):
    """The flash-decoding combine on the card: a cache split into 4
    slices, each slice's ``decode_partial`` combined by hand (a fully
    masked slice weighs exactly 0), within 1e-6 of the card's
    ``decode_attention`` on the whole cache and within 1e-5 of the CPU's;
    ``flash_decode`` on one rank the same."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(3)
    B, H, KH, D, S, n = 3, 8, 2, 64, 256, 4
    q = torch.randn((B, 1, H, D), generator=g)
    k, v = (torch.randn((B, S, KH, D), generator=g) for _ in range(2))
    clen = torch.tensor([40, 256, 200])
    kw = dict(window=100, softcap=30.0)

    def whole(q, k, v, c):
        if grouped:
            return L.decode_attention_grouped(q, k, v, c, **kw)
        return L.decode_attention(q, L.repeat_kv(k, H // KH),
                                  L.repeat_kv(v, H // KH), c, **kw)

    want = whole(q, k, v, clen)
    qc, kc, vc, cc = (t.to(cuda) for t in (q, k, v, clen))
    w = S // n
    parts = [L.decode_partial(qc, kc[:, r * w:(r + 1) * w],
                              vc[:, r * w:(r + 1) * w], cc, offset=r * w,
                              grouped=grouped, **kw) for r in range(n)]
    m_r = torch.stack([p[0] for p in parts])
    wt = torch.exp(m_r - m_r.amax(dim=0))
    assert bool((wt[0, 1] == 0).all()) and bool((wt[3, 0] == 0).all())
    l = sum(p[1] * wt[r] for r, p in enumerate(parts))
    o = sum(p[2] * wt[r][..., None] for r, p in enumerate(parts))
    got = (o / l[..., None])[:, None]
    assert bool(torch.isfinite(got).all())
    assert float((got - whole(qc, kc, vc, cc)).abs().max()) <= 1e-6
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    one = L.flash_decode(qc, kc, vc, cc, grouped=grouped, **kw)
    assert float((one.cpu() - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_tp2_serving_matches_one_rank_cpu(cuda, tmp_path):
    """Serving at tp = 2 on the card: two gloo rank processes on the one
    card (``tests/torch_dist_worker.py``'s ``serve`` case on CUDA
    tensors), h2o-danube3-4b (own KV heads; a window ring) and
    gemma3-27b at SMOKE in float32 on a (1, 2) mesh: prefill's and every
    teacher-forced decode step's logits, the cache shards and the
    engine's tokens against the one-rank path on the CPU, with the bars
    of ``tests/torch_tp_serve_cases.py``."""
    import json
    import os
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_tp_serve_cases as C
    cases = ["h2o-danube3-4b", "gemma3-27b"]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_dist_worker.py")
    r = subprocess.run([sys.executable, worker, "serve", str(tmp_path),
                        json.dumps({"world": 2, "cases": cases,
                                    "device": "cuda"})],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = C.results_by_case(torch.load(tmp_path / "result.pt"))
    for case in cases:
        for what in ("logits", "caches", "tokens"):
            C.check_case(res, case, 2, what)
