"""The port's tile-delta family against the JAX package's oracles.

On the CPU every wrapper takes its plain version; those are held here
bit-exactly against ``repro.kernels.ref``: ``tile_delta`` (B10) and
``tile_delta_halo`` (B11) directly, the packed gate ``tile_delta_gate``
(B5) against a per-row composition of ``ref.tile_delta`` over each
(current window, reference window) pair, and its windows output against
the JAX package's ``ops.gather_windows`` (pure jnp).  Inputs sit on a 0.5
grid so that many deltas land on rounding ties, and a -0.0 vs 0.0 pair is
no exact change.  On NaN, +-Inf, +-3e10 and -0.0 content -- where numpy's
cast in ``repro.kernels.ref`` gives x86's INT_MIN and XLA's saturates --
B10 and B11 are held against the JAX package's own pure-jnp arithmetic,
``_tile_stats`` and ``_halo_strip_stats`` composed as its kernel bodies
compose them.  The route rule of B10's and B11's instances is held here
too.  ``tests/test_torch_cuda.py`` holds the CUDA kernels against the
plain versions on the card."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tile_delta as jtd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tile_delta

TH = TW = 8
SHAPES = [(4, 5), (3, 4), (5, 3)]          # per-camera tile grids
QSTEPS = [1.0, 8.0, 13.0]


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _pair(rng, shape):
    """A (prev, cur) pair on a 0.5 grid, 30% of the values moved, and a
    -0.0 in cur over a 0.0 in prev."""
    prev = (rng.integers(-40, 40, shape) * 0.5).astype(np.float32)
    cur = prev.copy()
    moved = rng.random(shape) < 0.3
    cur[moved] += (rng.integers(-60, 60, moved.sum()) * 0.5) \
        .astype(np.float32)
    corner = (0,) * (len(shape) - 2)
    cur[corner + (0, slice(0, 4))] = -0.0
    prev[corner + (0, slice(0, 4))] = 0.0
    return prev, cur


def _frame_case(seed, cin=3):
    rng = np.random.default_rng(seed)
    grid = rng.random((5, 6)) < 0.6
    grid[0, 0] = grid[-1, -1] = True
    prev, cur = _pair(rng, (5 * TH, 6 * TW, cin))
    return prev, cur, tops.mask_to_indices(grid)


@pytest.mark.parametrize("qstep", QSTEPS)
def test_tile_delta_plain_bit_exact(qstep):
    prev, cur, idx = _frame_case(0)
    got = tile_delta.tile_delta(_t(cur), _t(prev), _t(idx), TH, TW, qstep)
    want = jref.tile_delta(cur, prev, idx, TH, TW, qstep)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 1] > 0).any() and (want[:, 2] > 0).any()


@pytest.mark.parametrize("qstep", QSTEPS)
@pytest.mark.parametrize("cin", [3, 5])
def test_tile_delta_halo_plain_bit_exact(qstep, cin):
    prev, cur, idx = _frame_case(1, cin)
    got = tile_delta.tile_delta_halo(_t(cur), _t(prev), _t(idx), TH, TW,
                                     qstep)
    want = jref.tile_delta_halo(cur, prev, idx, TH, TW, qstep)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 1] > 0).any()


def test_halo_column_strips_scan_y_major():
    """A column strip is one scan row, y-major and channel-minor: a zero
    run through the channels of consecutive pixels of the left column
    joins across pixel rows, and never across strips."""
    cur = np.zeros((TH, TW, 2), np.float32)
    prev = np.zeros_like(cur)
    cur[::2, 0, 1] = 16.0                   # left column, odd lanes
    idx = np.zeros((1, 2), np.int32)
    got = tref.tile_delta_halo(_t(cur), _t(prev), _t(idx), TH, TW)
    want = jref.tile_delta_halo(cur, prev, idx, TH, TW)
    np.testing.assert_array_equal(got.numpy(), want)
    # the left column's TH/2 nonzeros, and the corner again in the top row
    assert want[0, 1] == TH // 2 + 1


def _fleet_windows(seed, cin=3):
    rng = np.random.default_rng(seed)
    grids = [rng.random(s) < 0.55 for s in SHAPES]
    for g in grids:
        g[1, 1] = True
    idx, _ = tops.fleet_indices(grids)
    H = max(s[0] for s in SHAPES) * TH
    W = max(s[1] for s in SHAPES) * TW
    prev, cur = _pair(rng, (len(SHAPES), H, W, cin))
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    return np.pad(prev, pad), np.pad(cur, pad), idx


def _gate_oracle(cur_p, ref_win, idx, qstep):
    """The packed gate's rows from ``ref.tile_delta`` over each window
    pair: the body as one (th, tw) tile, the window as one (th+2, tw+2)
    tile, and the exact count of differing positions."""
    cw = np.asarray(jops.gather_windows(jnp.asarray(cur_p),
                                        jnp.asarray(idx), TH, TW))
    one = np.zeros((1, 2), np.int32)
    rows = []
    for c, p in zip(cw, ref_win):
        body = jref.tile_delta(c[1:-1, 1:-1], p[1:-1, 1:-1], one, TH, TW,
                               qstep)[0]
        win = jref.tile_delta(c, p, one, TH + 2, TW + 2, qstep)[0]
        rows.append([*body[:4], int((c != p).sum()), win[0], 0, 0])
    return np.asarray(rows, np.int32), cw


@pytest.mark.parametrize("qstep", QSTEPS)
def test_packed_gate_plain_bit_exact(qstep):
    prev_p, cur_p, idx = _fleet_windows(2)
    rng = np.random.default_rng(3)
    # references of mixed age: the previous frame's windows, some rows
    # already advanced to the current frame
    ref_win = np.array(jops.gather_windows(jnp.asarray(prev_p),
                                           jnp.asarray(idx), TH, TW))
    fresh = rng.random(idx.shape[0]) < 0.3
    ref_win[fresh] = np.asarray(jops.gather_windows(
        jnp.asarray(cur_p), jnp.asarray(idx[fresh]), TH, TW))
    stats, wins = tile_delta.tile_delta_gate(_t(cur_p), _t(ref_win),
                                             _t(idx), TH, TW, qstep)
    want, want_wins = _gate_oracle(cur_p, ref_win, idx, qstep)
    assert stats.dtype == torch.int32
    np.testing.assert_array_equal(stats.numpy(), want)
    np.testing.assert_array_equal(wins.numpy(), want_wins)
    assert (want[fresh, tops.GATE_WIN_EXACT] == 0).all()
    assert want[~fresh, tops.GATE_WIN_EXACT].max() > 0


@pytest.mark.parametrize("qstep", QSTEPS)
def test_packed_gate_equals_canvas_gate_on_previous_frame(qstep):
    """References gathered from the previous frame: the packed gate's rows
    equal the canvas gate's and the JAX package's ``ref.tile_delta_gate``."""
    prev_p, cur_p, idx = _fleet_windows(4)
    ref_win = tops.gather_windows(_t(prev_p), _t(idx), TH, TW)
    stats, _ = tile_delta.tile_delta_gate(_t(cur_p), ref_win, _t(idx), TH,
                                          TW, qstep)
    canvas = tile_delta.tile_delta_gate_canvas(_t(cur_p), _t(prev_p),
                                               _t(idx), TH, TW, qstep)
    assert torch.equal(stats, canvas)
    np.testing.assert_array_equal(stats.numpy(), jref.tile_delta_gate(
        cur_p[:, 1:-1, 1:-1], prev_p[:, 1:-1, 1:-1], idx, TH, TW, qstep))


def test_gather_windows_matches_jax():
    _, cur_p, idx = _fleet_windows(5, cin=5)
    got = tops.gather_windows(_t(cur_p), _t(idx), TH, TW)
    want = jops.gather_windows(jnp.asarray(cur_p), jnp.asarray(idx), TH, TW)
    assert tuple(got.shape) == (idx.shape[0], TH + 2, TW + 2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_body_columns_equal_tile_delta_per_camera():
    """The gate's body columns equal ``tile_delta`` on the same camera's
    unpadded frame pair: the zero-dispatch rate-control feed."""
    prev_p, cur_p, idx = _fleet_windows(6)
    gate = tref.tile_delta_gate_canvas(_t(cur_p), _t(prev_p), _t(idx), TH,
                                       TW)
    for c in range(len(SHAPES)):
        rows = idx[:, 0] == c
        td = tref.tile_delta(_t(cur_p[c, 1:-1, 1:-1]),
                             _t(prev_p[c, 1:-1, 1:-1]),
                             _t(idx[rows, 1:]), TH, TW)
        assert torch.equal(gate[rows, :4], td[:, :4])


def test_wrappers_count_and_skip_empty_sets():
    prev, cur, idx = _frame_case(7)
    prev_p, cur_p, fidx = _fleet_windows(8)
    ref_win = tops.gather_windows(_t(prev_p), _t(fidx), TH, TW)
    empty2 = torch.zeros((0, 2), dtype=torch.int32)
    empty3 = torch.zeros((0, 3), dtype=torch.int32)
    with tops.count_kernels() as c:
        assert tops.tile_delta(_t(cur), _t(prev), empty2, TH, TW).shape \
            == (0, tops.STATS_WIDTH)
        assert tops.tile_delta_halo(_t(cur), _t(prev), empty2, TH,
                                    TW).shape == (0, tops.STATS_WIDTH)
        s, w = tops.tile_delta_gate(_t(cur_p), ref_win[:0], empty3, TH, TW)
        assert s.shape == (0, tops.STATS_WIDTH)
        assert w.shape == (0, TH + 2, TW + 2, 3)
        tops.gather_windows(_t(cur_p), _t(fidx), TH, TW)
    assert c == {}
    with tops.count_kernels() as c:
        tops.tile_delta(_t(cur), _t(prev), _t(idx), TH, TW)
        tops.tile_delta_halo(_t(cur), _t(prev), _t(idx), TH, TW)
        tops.tile_delta_gate(_t(cur_p), ref_win, _t(fidx), TH, TW)
    assert c == {"tile_delta": 1, "tile_delta_halo": 1,
                 "tile_delta_gate": 1}


def test_launchers_refuse_other_devices():
    m = torch.device("meta")
    frame = torch.zeros((16, 16, 3), device=m)
    idx2 = torch.zeros((1, 2), dtype=torch.int32, device=m)
    with pytest.raises(ValueError):
        tile_delta.tile_delta(frame, frame, idx2, 8, 8)
    with pytest.raises(ValueError):
        tile_delta.tile_delta_halo(frame, frame, idx2, 8, 8)
    with pytest.raises(ValueError):
        tile_delta.tile_delta_gate(
            torch.zeros((1, 18, 18, 3), device=m),
            torch.zeros((1, 10, 10, 3), device=m),
            torch.zeros((1, 3), dtype=torch.int32, device=m), 8, 8)


def _special(rng, shape, kind):
    """A ``_pair`` whose deltas the quantizer's cast must saturate or zero:
    "nan" -- NaNs in cur, in prev and in both at one place; "inf" -- +-Inf
    in cur, in prev, and in both (Inf - Inf is NaN); "huge" -- +-3e10 in
    cur or prev (past 2^31 at every qstep here); "negzero" -- -0.0 over
    0.0 and 0.0 over -0.0 at many places."""
    prev, cur = _pair(rng, shape)
    spots = rng.choice(cur.size, 60, replace=False)
    c, p = cur.reshape(-1), prev.reshape(-1)
    if kind == "negzero":
        c[spots[:30]], p[spots[:30]] = -0.0, 0.0
        c[spots[30:]], p[spots[30:]] = 0.0, -0.0
        return prev, cur
    values = {"nan": (np.nan,), "inf": (np.inf, -np.inf),
              "huge": (3e10, -3e10)}[kind]
    for k, v in enumerate(np.resize(values, 6)):
        part = spots[10 * k:10 * k + 10]
        c[part[:7]] = v                       # cur alone, then both
        p[part[4:]] = v if k % 2 else -v      # prev alone or both
    return prev, cur


def _jnp_tile_delta(cur, prev, idx, th, tw, qstep):
    """B10's rows from the JAX package's ``_tile_stats`` on each tile."""
    cut = [(slice(ty * th, ty * th + th), slice(tx * tw, tx * tw + tw))
           for ty, tx in idx]
    c = jnp.stack([jnp.asarray(cur[s]) for s in cut])
    p = jnp.stack([jnp.asarray(prev[s]) for s in cut])
    return np.asarray(jax.vmap(lambda a, b: jtd._tile_stats(
        a, b, qstep, jtd.COEF_BITS, jtd.RUN_BITS))(c, p))


def _jnp_tile_delta_halo(cur, prev, idx, th, tw, qstep):
    """B11's rows from the JAX package's ``_halo_strip_stats`` on each
    tile's 4 strips, summed as ``_tile_delta_halo_kernel`` sums them."""
    rows = []
    for ty, tx in idx:
        y0, x0 = ty * th, tx * tw
        sels = [(slice(y0, y0 + 1), slice(x0, x0 + tw)),
                (slice(y0 + th - 1, y0 + th), slice(x0, x0 + tw)),
                (slice(y0, y0 + th), slice(x0, x0 + 1)),
                (slice(y0, y0 + th), slice(x0 + tw - 1, x0 + tw))]
        nnz = runs = sabs = jnp.asarray(0, jnp.int32)
        for sel in sels:
            a, b, d = jtd._halo_strip_stats(jnp.asarray(cur[sel]),
                                            jnp.asarray(prev[sel]), qstep)
            nnz, runs, sabs = nnz + a, runs + b, sabs + d
        nbytes = (nnz * jtd.COEF_BITS + runs * jtd.RUN_BITS + 7) // 8
        rows.append([nbytes, nnz, runs, sabs, 0, 0, 0, 0])
    return np.asarray(rows, np.int32)


JNP_ORACLES = {"tile_delta": _jnp_tile_delta,
               "tile_delta_halo": _jnp_tile_delta_halo}


@pytest.mark.parametrize("qstep", QSTEPS)
@pytest.mark.parametrize("kind", ["nan", "inf", "huge", "negzero"])
@pytest.mark.parametrize("name", ["tile_delta", "tile_delta_halo"])
def test_plain_versions_match_jnp_on_special_content(name, kind, qstep):
    """The cast saturates as XLA's: NaN gives 0, +-Inf and +-3e10 the int32
    extremes (sum|q| wraps mod 2^32 as JAX's int32 sum), -0.0 gives 0."""
    rng = np.random.default_rng(30)
    grid = rng.random((5, 6)) < 0.6
    grid[0, 0] = grid[-1, -1] = True
    idx = tops.mask_to_indices(grid)
    prev, cur = _special(rng, (5 * TH, 6 * TW, 3), kind)
    got = getattr(tile_delta, name)(_t(cur), _t(prev), _t(idx), TH, TW,
                                    qstep)
    with np.errstate(invalid="ignore"):
        want = JNP_ORACLES[name](cur, prev, idx, TH, TW, qstep)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind in ("inf", "huge"):         # a saturated |q| reached the sums
        assert (np.abs(want[:, 3].astype(np.int64)) > 2 ** 30).any()


@pytest.mark.parametrize("name,th,tw,frame", [
    ("tile_delta", 80, 80, (160, 240)),
    ("tile_delta_halo", 1088, 1024, (1088, 1920))])
def test_plain_versions_past_the_old_cap_match_jnp(name, th, tw, frame):
    """Tiles past the 48 KB of quantized deltas the CUDA kernels once kept
    in shared memory (B10 80x80x3, B11's ring of 1088x1024x3): the plain
    versions the card is held to give JAX's rows."""
    rng = np.random.default_rng(31)
    prev, cur = _pair(rng, frame + (3,))
    idx = np.argwhere(np.ones((frame[0] // th, frame[1] // tw), bool)) \
        .astype(np.int32)
    got = getattr(tile_delta, name)(_t(cur), _t(prev), _t(idx), th, tw)
    want = JNP_ORACLES[name](cur, prev, idx, th, tw, 8.0)
    np.testing.assert_array_equal(got.numpy(), want)


# (C, th, tw, frame width W, addresses...) -> the instance
@pytest.mark.parametrize("args,route", [
    ((3, 16, 16, 1920, 0, 256), "detector"),       # a padded 1920-px leg
    ((3, 16, 16, 1280, 8, 1032), "detector"),      # the 1280-px centre
    ((3, 16, 16, 1921, 0, 256), "generic"),        # rows of odd floats
    ((3, 16, 16, 1920, 4, 256), "generic"),        # cur off 8 bytes
    ((3, 16, 16, 1920, 0, 260), "generic"),        # prev off 8 bytes
    ((5, 16, 16, 1920, 0, 256), "generic"),        # other C
    ((3, 8, 8, 1920, 0, 256), "generic"),          # other tile
    ((3, 16, 8, 1920, 0, 256), "generic"),         # a non-square tile
])
def test_delta_route_rule(args, route):
    assert tile_delta.delta_route(*args) == route
