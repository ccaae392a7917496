"""The reuse gate's plain versions against the JAX package's oracle, on
hard content, and the rule that picks the gate kernel's instance.

B1 (``tile_delta_gate_canvas``) and B5 (``tile_delta_gate``) take their
plain versions on the CPU; both are held bit-exactly against
``repro.kernels.ref.tile_delta_gate`` (the JAX package has no live Pallas
oracle here), and B5's windows against ``repro.kernels.ops.gather_windows``
(pure jnp).  The contents are the ones the kernel's run scan and quantizer
find hardest: deltas on 0.5-grid rounding ties with a -0.0 over a 0.0, the
same with NaNs (one a window: in the current frame, in the reference, or in
both at one place), and frames where every element changed, so that no
body holds a zero run.  Window rows of (tw+2)*Cin floats: 30 and 50 at
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
    from it: both give the oracle's rows, and B5's windows are the current
    frames' windows."""
    prev, cur, idx = _case(20, th, tw, cin, kind)
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    cur_p, prev_p = _t(np.pad(cur, pad)), _t(np.pad(prev, pad))
    with np.errstate(invalid="ignore"):
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
