"""The reuse gate's plain versions against the JAX package's oracle, on
hard content, and the rule that picks the gate kernel's instance.

B1 (``tile_delta_gate_canvas``) and B5 (``tile_delta_gate``) take their
plain versions on the CPU; both are held bit-exactly against the JAX
package (it has no live Pallas oracle here): on finite content against
``repro.kernels.ref.tile_delta_gate``, and where a delta is NaN, infinite
or past 2^31 -- which numpy's cast there turns into x86's INT_MIN and
XLA's saturates -- against the pure-jnp ``_batched_stats`` composed as the
gate's kernel body composes it.  B5's windows are held against
``repro.kernels.ops.gather_windows`` (pure jnp).  The contents are the
ones the kernel's run scan and quantizer find hardest: deltas on 0.5-grid
rounding ties with a -0.0 over a 0.0, the same with NaNs (one a window: in
the current frame, in the reference, or in both at one place), frames
where every element changed, so that no body holds a zero run, and NaN,
+-Inf, +-3e10 and -0.0 at many places.  Window rows of (tw+2)*Cin floats: 30 and 50 at
tile 8 (under and over the 32 lanes of a warp), 54 and 90 at tile 16 (a
partial last chunk of 32, and of the kernel's 64-element chunks), 27 at
8x7 (odd).  ``tests/test_torch_cuda.py`` holds the kernel against the
plain versions on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import tile_delta as jtd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tile_delta

SHAPES = [(4, 5), (3, 4), (5, 3)]          # per-camera tile grids
CASES = [(8, 8, 3), (8, 8, 5), (16, 16, 3), (16, 16, 5), (8, 7, 3)]
QSTEPS = [1.0, 8.0, 13.0]


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _frames(rng, grids, th, tw, cin, kind):
    """(prev, cur) unpadded (C, H, W, Cin) frames of ``kind``: "ties" --
    values on a 0.5 grid, 30% moved by multiples of 0.5, a -0.0 over a 0.0
    in each camera's first row; "nan" -- the same with a NaN at the centre
    of some active tiles, in cur, in prev or in both, so a window holds at
    most one; "changed" -- every element moved by 16 to 32."""
    shape = (len(grids), max(s[0] for s in SHAPES) * th,
             max(s[1] for s in SHAPES) * tw, cin)
    prev = (rng.integers(-40, 40, shape) * 0.5).astype(np.float32)
    if kind == "changed":
        return prev, prev + rng.uniform(16, 32, shape).astype(np.float32)
    cur = prev.copy()
    moved = rng.random(shape) < 0.3
    cur[moved] += (rng.integers(-60, 60, moved.sum()) * 0.5) \
        .astype(np.float32)
    cur[:, 0, :3, :] = -0.0
    prev[:, 0, :3, :] = 0.0
    if kind == "nan":
        for k, (cam, ty, tx) in enumerate(tops.fleet_indices(grids)[0][::4]):
            y, x = ty * th + th // 2, tx * tw + tw // 2
            targets = ((cur,), (prev,), (cur, prev))[k % 3]
            for a in targets:
                a[cam, y, x, k % cin] = np.nan
    return prev, cur


def _jnp_gate(cur_p, prev_p, idx, th, tw, qstep):
    """The gate's rows from the JAX package's ``_batched_stats`` on the
    windows of the padded planes, composed as ``_tile_delta_gate_kernel``
    composes them: the body's stats, the window's exact change count and
    byte estimate."""
    cw = jops.gather_windows(jnp.asarray(cur_p), jnp.asarray(idx), th, tw)
    pw = jops.gather_windows(jnp.asarray(prev_p), jnp.asarray(idx), th, tw)
    body = jtd._batched_stats(cw[:, 1:1 + th, 1:1 + tw],
                              pw[:, 1:1 + th, 1:1 + tw], qstep,
                              jtd.COEF_BITS, jtd.RUN_BITS)
    win_bytes = jtd._batched_stats(cw, pw, qstep, jtd.COEF_BITS,
                                   jtd.RUN_BITS)[0]
    exact = jnp.sum((cw != pw).astype(jnp.int32), axis=(1, 2, 3))
    zero = jnp.zeros_like(exact)
    return np.asarray(jnp.stack([*body, exact, win_bytes, zero, zero], 1))


def _special(rng, grids, th, tw, cin, kind):
    """``_frames`` "ties" with NaN, +-Inf or +-3e10 (past 2^31 at every
    qstep here) at 60 places, in the current frame, in the reference or
    in both (Inf - Inf is NaN); "negzero": -0.0 over 0.0 and 0.0 over
    -0.0 at 60 places."""
    prev, cur = _frames(rng, grids, th, tw, cin, "ties")
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


def _case(seed, th, tw, cin, kind):
    rng = np.random.default_rng(seed)
    grids = [rng.random(s) < 0.55 for s in SHAPES]
    for g in grids:
        g[1, 1] = True
    idx, _ = tops.fleet_indices(grids)
    prev, cur = _frames(rng, grids, th, tw, cin, kind)
    return prev, cur, idx


@pytest.mark.parametrize("qstep", QSTEPS)
@pytest.mark.parametrize("th,tw,cin", CASES)
@pytest.mark.parametrize("kind", ["ties", "nan", "changed"])
def test_gate_plain_versions_match_reference(kind, th, tw, cin, qstep):
    """B1 against the reference canvas and B5 against the windows gathered
    from it: both give the oracle's rows (``ref.tile_delta_gate``; the
    jnp stats where a delta is NaN), and B5's windows are the current
    frames' windows."""
    prev, cur, idx = _case(20, th, tw, cin, kind)
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    cur_p, prev_p = _t(np.pad(cur, pad)), _t(np.pad(prev, pad))
    if kind == "nan":           # XLA's saturating cast: JAX's jnp stats
        with np.errstate(invalid="ignore"):
            want = _jnp_gate(cur_p, prev_p, idx, th, tw, qstep)
    else:
        want = jref.tile_delta_gate(cur, prev, idx, th, tw, qstep)
    canvas = tile_delta.tile_delta_gate_canvas(cur_p, prev_p, _t(idx), th,
                                               tw, qstep)
    ref_win = tops.gather_windows(prev_p, _t(idx), th, tw)
    stats, wins = tile_delta.tile_delta_gate(cur_p, ref_win, _t(idx), th,
                                             tw, qstep)
    assert canvas.dtype == stats.dtype == torch.int32
    np.testing.assert_array_equal(canvas.numpy(), want)
    np.testing.assert_array_equal(stats.numpy(), want)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(
        jops.gather_windows(jnp.asarray(cur_p.numpy()), jnp.asarray(idx),
                            th, tw)))
    if kind == "changed":       # no zero run in any body
        assert (want[:, tops.GATE_BODY_RUNS] == 0).all()
        assert (want[:, tops.GATE_BODY_NNZ] == th * tw * cin).all()
    else:                       # ties, runs, and unchanged -0.0 over 0.0
        assert (want[:, tops.GATE_BODY_RUNS] > 0).any()
        assert (want[:, tops.GATE_WIN_EXACT] > 0).any()
    if kind == "nan":           # a NaN is an exact change wherever it is
        nan_rows = np.isnan(wins.numpy()).any(axis=(1, 2, 3)) | np.isnan(
            ref_win.numpy()).any(axis=(1, 2, 3))
        assert nan_rows.any()
        assert (want[nan_rows, tops.GATE_WIN_EXACT] > 0).all()


@pytest.mark.parametrize("qstep", QSTEPS)
@pytest.mark.parametrize("th,tw,cin", [(8, 8, 3), (16, 16, 5), (8, 7, 3)])
@pytest.mark.parametrize("kind", ["nan", "inf", "huge", "negzero"])
def test_gate_plain_versions_match_jnp_on_special_content(kind, th, tw, cin,
                                                          qstep):
    """The cast saturates as XLA's: NaN gives 0, +-Inf and +-3e10 the int32
    extremes (sum|q| wraps mod 2^32 as JAX's int32 sum), -0.0 gives 0 and
    is no exact change.  B1 and B5 give the jnp stats' rows."""
    rng = np.random.default_rng(21)
    grids = [rng.random(s) < 0.55 for s in SHAPES]
    for g in grids:
        g[1, 1] = True
    idx, _ = tops.fleet_indices(grids)
    prev, cur = _special(rng, grids, th, tw, cin, kind)
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    cur_p, prev_p = np.pad(cur, pad), np.pad(prev, pad)
    with np.errstate(invalid="ignore"):
        want = _jnp_gate(cur_p, prev_p, idx, th, tw, qstep)
    canvas = tile_delta.tile_delta_gate_canvas(_t(cur_p), _t(prev_p),
                                               _t(idx), th, tw, qstep)
    ref_win = tops.gather_windows(_t(prev_p), _t(idx), th, tw)
    stats, _ = tile_delta.tile_delta_gate(_t(cur_p), ref_win, _t(idx), th,
                                          tw, qstep)
    np.testing.assert_array_equal(canvas.numpy(), want)
    np.testing.assert_array_equal(stats.numpy(), want)
    if kind in ("inf", "huge"):         # a saturated |q| reached the sums
        assert (np.abs(want[:, 3].astype(np.int64)) > 2 ** 30).any()


# (Cin, th, tw, padded width Wp, addresses...) -> the instance
@pytest.mark.parametrize("args,route", [
    ((3, 16, 16, 1922, 0, 256), "detector"),       # a 1920-px leg
    ((3, 16, 16, 1282, 8, 1032), "detector"),      # the 1280-px centre
    ((3, 16, 16, 1922, 0, 256, 512), "detector"),  # packed: windows out
    ((3, 16, 16, 1921, 0, 256), "generic"),        # rows of odd floats
    ((3, 16, 16, 1922, 4, 256), "generic"),        # frames off 8 bytes
    ((3, 16, 16, 1922, 0, 260), "generic"),        # reference off 8 bytes
    ((3, 16, 16, 1922, 0, 256, 12), "generic"),    # windows off 8 bytes
    ((5, 16, 16, 1922, 0, 256), "generic"),        # other Cin
    ((3, 8, 8, 1922, 0, 256), "generic"),          # other tile
    ((3, 16, 8, 1922, 0, 256), "generic"),         # a non-square tile
])
def test_gate_route_rule(args, route):
    assert tile_delta.gate_route(*args) == route
