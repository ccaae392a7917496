"""The gather + conv family (B2 ``roi_conv_entry``, B7 ``roi_conv_fleet``,
B8 ``roi_conv``): the choice of the kernel's instance, and the plain
versions against ``repro.kernels.ref.roi_conv`` on tiles at every frame
border and corner.

The shapes are the ones the kernel's load plan treats specially: the
detector's (Cin 3, Cout 8, 16x16 tiles), frames whose rows are not whole
16-byte vectors (W * Cin not a multiple of 4), and Cin 5 with Cout 12 (not
a multiple of the kernel's 8-channel chunk).  On the CPU the wrappers take
their plain versions, which ``tests/test_torch_cuda.py`` holds the kernel
against on the card; here they are held against the JAX package's oracle
within 1e-5 (the two sides sum in other orders)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import roi_conv


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("Cin,Cout,th,tw,W,address,want", [
    (3, 8, 16, 16, 1920, 0, "detector"),          # the fleet's frames
    (3, 8, 16, 16, 1280, 4096, "detector"),       # the centre camera
    (3, 8, 16, 16, 16, 16, "detector"),
    (3, 8, 16, 16, 1920, 4, "generic"),           # a view off 16 bytes
    (3, 8, 16, 16, 1920, 8, "generic"),
    (3, 8, 16, 16, 1921, 0, "generic"),           # W * Cin % 4 == 3
    (3, 8, 16, 16, 50, 0, "generic"),             # W * Cin % 4 == 2
    (5, 12, 16, 16, 1920, 0, "generic"),
    (3, 16, 16, 16, 1920, 0, "generic"),
    (4, 8, 16, 16, 1920, 0, "generic"),
    (3, 8, 8, 8, 1920, 0, "generic"),
    (3, 8, 16, 8, 1920, 0, "generic"),
    (3, 8, 8, 16, 1920, 0, "generic"),
])
def test_entry_route(Cin, Cout, th, tw, W, address, want):
    """The detector's compiled-in instance takes its own extents on
    frames of whole 16-byte rows that start on a 16-byte boundary; every
    other case takes the generic instance."""
    assert roi_conv.entry_route(Cin, Cout, th, tw, W, address) == want


def _border_fleet(seed, Cin, Cout, th, tw, shapes):
    """Frames whose tile grids have every border tile active (both
    corners of both edges) and the interior at random; seeded weights."""
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
    return grids, idx, x, w


def _reference(x, w, rows, th, tw):
    return np.asarray(jref.roi_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(rows), th, tw))


# (Cin, Cout, th, tw, per-camera tile grids): the detector's extents; W *
# Cin % 4 == 2 at tile 8 x 10 and at Cin 5 on 6x6 tiles; Cin 5, Cout 12
@pytest.mark.parametrize("Cin,Cout,th,tw,shapes", [
    (3, 8, 16, 16, [(3, 4), (2, 3), (4, 2)]),
    (3, 8, 8, 10, [(4, 5), (3, 3)]),
    (5, 12, 16, 16, [(3, 3), (2, 4)]),
    (5, 12, 6, 6, [(4, 5), (5, 3)]),
])
def test_entry_family_plain_matches_reference_at_borders(Cin, Cout, th, tw,
                                                         shapes):
    """B7 and B2 camera by camera, B8 on each camera's own frame and on
    the frames sharing one camera's rows, all against the JAX oracle's
    full-frame SAME conv, with tiles at tx = 0, the last tx, ty = 0 and
    the last ty of every camera."""
    grids, idx, x, w = _border_fleet(Cin * 100 + th, Cin, Cout, th, tw,
                                     shapes)
    for c, g in enumerate(grids):
        rows = idx[idx[:, 0] == c, 1:]
        assert {0, g.shape[0] - 1} <= set(rows[:, 0].tolist())
        assert {0, g.shape[1] - 1} <= set(rows[:, 1].tolist())
    fleet = roi_conv.roi_conv_fleet(_t(x), _t(w), _t(idx), th, tw).numpy()
    entry = roi_conv.roi_conv_entry(_t(x), _t(w), _t(idx), th, tw).numpy()
    assert fleet.shape == (idx.shape[0], th, tw, Cout)
    assert fleet.min() < 0
    np.testing.assert_array_equal(entry, np.maximum(fleet, 0))
    for c, g in enumerate(grids):
        sel = idx[:, 0] == c
        rows = idx[sel, 1:]
        want = _reference(x[c], w, rows, th, tw)
        np.testing.assert_allclose(fleet[sel], want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(entry[sel], np.asarray(jax.nn.relu(want)),
                                   atol=1e-5, rtol=0)
        # one camera's frame cut to its own grid, and every frame of the
        # stack under this camera's rows in one batch
        h, wd = g.shape[0] * th, g.shape[1] * tw
        own = _t(x[c, :h, :wd])
        one = roi_conv.roi_conv(own, _t(w), _t(rows), th, tw).numpy()
        np.testing.assert_allclose(
            one, _reference(x[c, :h, :wd], w, rows, th, tw), atol=1e-5,
            rtol=0)
        batch = tops.roi_conv_batched(_t(x), _t(w), _t(rows), th, tw)
        assert batch.shape == (len(grids), rows.shape[0], th, tw, Cout)
        for b in range(len(grids)):
            np.testing.assert_allclose(
                batch[b].numpy(), _reference(x[b], w, rows, th, tw),
                atol=1e-5, rtol=0)
