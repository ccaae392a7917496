"""The port's kernels against the JAX package's oracles.

On the CPU every wrapper takes its plain version (``repro_torch.kernels
.ref``); those are held here against ``repro.kernels.ref``: the gate stats
and the scatter bit-exact, the convolutions within the f32 bar of
``tests/test_fleet.py`` (atol 1e-5; the two sides sum in other orders).
``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on the card."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.kernels import roi_conv, sbnet, tile_delta

TH = TW = 8
SHAPES = [(4, 5), (3, 4), (5, 3)]          # per-camera tile grids


def _fleet(seed, density=0.55):
    rng = np.random.default_rng(seed)
    grids = [rng.random(s) < density for s in SHAPES]
    for g in grids:
        g[1, 1] = True
    idx, _ = tops.fleet_indices(grids)
    nbr = tops.fleet_neighbor_table(grids)
    H = max(s[0] for s in SHAPES) * TH
    W = max(s[1] for s in SHAPES) * TW
    return rng, grids, idx, nbr, H, W


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("qstep", [1.0, 8.0, 13.0])
def test_gate_plain_bit_exact(qstep):
    rng, _, idx, _, H, W = _fleet(0)
    C = len(SHAPES)
    # values on a 0.5 grid put many deltas exactly on rounding ties
    prev = (rng.integers(-40, 40, (C, H, W, 3)) * 0.5).astype(np.float32)
    cur = prev.copy()
    moved = rng.random(cur.shape) < 0.3
    cur[moved] += (rng.integers(-60, 60, moved.sum()) * 0.5).astype(np.float32)
    cur[0, 0, :4] = -0.0                    # -0.0 == 0.0: no exact change
    prev[0, 0, :4] = 0.0
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    got = tile_delta.tile_delta_gate_canvas(
        _t(np.pad(cur, pad)), _t(np.pad(prev, pad)), _t(idx), TH, TW,
        qstep=qstep)
    want = jref.tile_delta_gate(cur, prev, idx, TH, TW, qstep=qstep)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:, tops.GATE_WIN_EXACT].max() > 0


def test_scatter_plain_bit_exact_per_camera():
    rng, _, idx, _, H, W = _fleet(1)
    C, A = len(SHAPES), 10
    n = idx.shape[0]
    # repeat-last padding rows, as the reuse path sends them
    idx_p = np.concatenate([idx, np.repeat(idx[-1:], 3, axis=0)])
    packed = rng.normal(size=(n, TH, TW, A)).astype(np.float32)
    packed_p = np.concatenate([packed, np.repeat(packed[-1:], 3, axis=0)])
    base = rng.normal(size=(C, H, W, A)).astype(np.float32)
    got = sbnet.sbnet_scatter_fleet(_t(packed_p), _t(idx_p), _t(base.copy()))
    for c in range(C):
        rows = idx[:, 0] == c
        want = jref.sbnet_scatter(jnp.asarray(packed[rows]),
                                  jnp.asarray(idx[rows, 1:]),
                                  jnp.asarray(base[c]), TH, TW)
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want))


def test_entry_plain_matches_reference_conv():
    rng, _, idx, _, H, W = _fleet(2)
    C = len(SHAPES)
    x = rng.normal(size=(C, H, W, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 8)) / np.sqrt(27)).astype(np.float32)
    got = roi_conv.roi_conv_entry(_t(x), _t(w), _t(idx), TH, TW).numpy()
    for c in range(C):
        rows = idx[:, 0] == c
        want = jax.nn.relu(jref.roi_conv(jnp.asarray(x[c]), jnp.asarray(w),
                                         jnp.asarray(idx[rows, 1:]), TH, TW))
        np.testing.assert_allclose(got[rows], np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_stack_plain_matches_reference_packed_chain():
    rng, grids, idx, nbr, _, _ = _fleet(3)
    n = idx.shape[0]
    packed = np.maximum(rng.normal(size=(n, TH, TW, 8)), 0).astype(np.float32)
    ws = [(rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci))
          .astype(np.float32) for ci, co in [(8, 16), (16, 16)]]
    got = roi_conv.roi_conv_stack(_t(packed), [_t(w) for w in ws],
                                  _t(nbr)).numpy()
    for c, g in enumerate(grids):
        rows = idx[:, 0] == c
        p = jnp.asarray(packed[rows])
        cidx = jnp.asarray(idx[rows, 1:])
        for w in ws:
            p = jax.nn.relu(jref.roi_conv_packed(p, cidx, g.shape,
                                                 jnp.asarray(w)))
        np.testing.assert_allclose(got[rows], np.asarray(p), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("tile,layers", [(4, 6), (2, 3)])
def test_stack_plain_deeper_than_tile_matches_reference_chain(tile, layers):
    """Past the ring route's depth (more layers than the tile is wide, the
    stack kernel's layer-by-layer route): the plain stack against the JAX
    chain ``relu(roi_conv_packed)``, camera by camera."""
    rng, grids, idx, nbr, _, _ = _fleet(30 + tile)
    assert roi_conv.stack_route(layers, tile, tile) == "layers"
    n = idx.shape[0]
    packed = np.maximum(rng.normal(size=(n, tile, tile, 8)), 0) \
        .astype(np.float32)
    chans = (8,) + (16,) * layers
    ws = [(rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci))
          .astype(np.float32) for ci, co in zip(chans[:-1], chans[1:])]
    got = roi_conv.roi_conv_stack(_t(packed), [_t(w) for w in ws],
                                  _t(nbr)).numpy()
    assert got.shape == (n, tile, tile, 16)
    for c, g in enumerate(grids):
        rows = idx[:, 0] == c
        p = jnp.asarray(packed[rows])
        cidx = jnp.asarray(idx[rows, 1:])
        for w in ws:
            p = jax.nn.relu(jref.roi_conv_packed(p, cidx, g.shape,
                                                 jnp.asarray(w)))
        np.testing.assert_allclose(got[rows], np.asarray(p), atol=1e-5,
                                   rtol=0)


def test_stack_route_ring_within_the_tile_else_layers():
    """The ring route while each tile's recomputed ring reaches only its 8
    neighbours (L <= min(th, tw, 8)), the layer-by-layer route beyond."""
    assert roi_conv.stack_route(2, 16, 16) == "ring"       # the detector
    assert roi_conv.stack_route(8, 16, 16) == "ring"
    assert roi_conv.stack_route(9, 16, 16) == "layers"
    assert roi_conv.stack_route(4, 4, 8) == "ring"
    assert roi_conv.stack_route(5, 4, 8) == "layers"
    assert roi_conv.stack_route(1, 1, 1) == "ring"
    assert roi_conv.stack_route(2, 1, 1) == "layers"
    for th, tw in [(2, 2), (4, 4), (8, 8), (3, 16)]:
        for L in range(1, 12):
            assert roi_conv.stack_route(L, th, tw) == (
                "ring" if L <= min(th, tw, 8) else "layers")
    with pytest.raises(ValueError):
        roi_conv.stack_route(0, 16, 16)


def test_stack_plain_zero_halo_from_neighbor_table():
    """A -1 slot is a zero halo at every layer: dropping a neighbour from
    the table equals zeroing that neighbour's tile on the full frame."""
    rng, grids, idx, nbr, _, _ = _fleet(4)
    n = idx.shape[0]
    packed = np.maximum(rng.normal(size=(n, TH, TW, 8)), 0).astype(np.float32)
    ws = [_t((rng.normal(size=(3, 3, 8, 8)) / 8).astype(np.float32))]
    keep = np.ones(n, bool)
    keep[np.nonzero(nbr[0] >= 0)[0][:1]] = False
    cidx, cnbr = tops.compact_tables(idx, nbr, np.ones(n, bool))
    cnbr = np.where(np.isin(cnbr, np.nonzero(~keep)[0]), -1, cnbr)
    got = tref.roi_conv_stack(_t(packed), ws, _t(cnbr.astype(np.int32)))
    zeroed = packed.copy()
    zeroed[~keep] = 0
    want = tref.roi_conv_stack(_t(zeroed), ws, _t(nbr))
    np.testing.assert_array_equal(got[keep].numpy(), want[keep].numpy())


def test_wrappers_count_dispatches_and_skip_empty_sets():
    rng, _, idx, nbr, H, W = _fleet(5)
    x = _t(rng.normal(size=(len(SHAPES), H, W, 3)).astype(np.float32))
    w0 = _t(rng.normal(size=(3, 3, 3, 8)).astype(np.float32))
    ws = [_t(rng.normal(size=(3, 3, 8, 16)).astype(np.float32))]
    empty = torch.zeros((0, 3), dtype=torch.int32)
    with tops.count_kernels() as c:
        assert tops.roi_conv_entry(x, w0, empty, TH, TW).shape == (0, 8, 8, 8)
        base = torch.zeros((len(SHAPES), H, W, 16))
        assert tops.sbnet_scatter_fleet(torch.zeros((0, 8, 8, 16)), empty,
                                        base) is base
        assert tops.sbnet_scatter_changed(torch.zeros((0, 8, 8, 16)), empty,
                                          base) is base
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        assert tops.tile_delta_gate_canvas(xp, xp, empty, TH, TW).shape \
            == (0, tops.STATS_WIDTH)
        assert tops.roi_conv_stack(torch.zeros((0, 8, 8, 8)), ws,
                                   torch.zeros((0, 8), dtype=torch.int32)) \
            .shape == (0, 8, 8, 16)
    assert c == {}
    with tops.count_kernels() as c:
        p = tops.roi_conv_entry(x, w0, _t(idx), TH, TW)
        p = tops.roi_conv_stack(p, ws, _t(nbr))
        tops.sbnet_scatter_fleet(p, _t(idx), base)
        tops.sbnet_scatter_changed(p, _t(idx), base)
        tops.tile_delta_gate_canvas(xp, xp, _t(idx), TH, TW)
    assert c == {"roi_conv_entry": 1, "roi_conv_stack": 1,
                 "sbnet_scatter_fleet": 1, "sbnet_scatter_changed": 1,
                 "tile_delta_gate": 1}


def test_launchers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card is refused:
    no plain-version fallback off the CPU."""
    m = torch.device("meta")
    idx = torch.zeros((1, 3), dtype=torch.int32, device=m)
    frames = torch.zeros((1, 8, 8, 3), device=m)
    with pytest.raises(ValueError):
        tile_delta.tile_delta_gate_canvas(frames, frames, idx, 6, 6)
    with pytest.raises(ValueError):
        roi_conv.roi_conv_entry(frames, torch.zeros((3, 3, 3, 8), device=m),
                                idx, 8, 8)
    with pytest.raises(ValueError):
        roi_conv.roi_conv_stack(torch.zeros((1, 8, 8, 8), device=m),
                                [torch.zeros((3, 3, 8, 8), device=m)],
                                torch.zeros((1, 8), dtype=torch.int32,
                                            device=m))
    with pytest.raises(ValueError):
        sbnet.sbnet_scatter_fleet(torch.zeros((1, 8, 8, 3), device=m), idx,
                                  frames)


# ---------------------------------------------------------------------------
# the per-layer chain and the single-camera path: B6-B9
# ---------------------------------------------------------------------------

def test_packed_layer_plain_matches_reference():
    """B6: one packed layer (no ReLU) against the scatter / SAME conv /
    gather oracle, camera by camera; the stack equals B6 + ReLU per layer
    bitwise."""
    rng, grids, idx, nbr, _, _ = _fleet(20)
    n = idx.shape[0]
    packed = np.maximum(rng.normal(size=(n, TH, TW, 8)), 0).astype(np.float32)
    ws = [(rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci))
          .astype(np.float32) for ci, co in [(8, 16), (16, 16)]]
    got = roi_conv.roi_conv_packed(_t(packed), _t(ws[0]), _t(nbr)).numpy()
    assert got.min() < 0                    # no ReLU
    for c, g in enumerate(grids):
        rows = idx[:, 0] == c
        want = jref.roi_conv_packed(jnp.asarray(packed[rows]),
                                    jnp.asarray(idx[rows, 1:]), g.shape,
                                    jnp.asarray(ws[0]))
        np.testing.assert_allclose(got[rows], np.asarray(want), atol=1e-5,
                                   rtol=0)
    p = _t(packed)
    for w in ws:
        p = torch.relu(roi_conv.roi_conv_packed(p, _t(w), _t(nbr)))
    assert torch.equal(p, roi_conv.roi_conv_stack(
        _t(packed), [_t(w) for w in ws], _t(nbr)))


def test_roi_conv_plain_matches_reference():
    """B8: one camera's gather + conv (no ReLU) against ``ref.roi_conv``;
    a batch of frames sharing the rows equals B8 frame by frame."""
    rng = np.random.default_rng(21)
    grid = rng.random((4, 5)) < 0.6
    rows = tops.mask_to_indices(grid)
    frames = rng.normal(size=(3, 4 * TH, 5 * TW, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 8)) / np.sqrt(27)).astype(np.float32)
    got = roi_conv.roi_conv(_t(frames[0]), _t(w), _t(rows), TH, TW)
    want = jref.roi_conv(jnp.asarray(frames[0]), jnp.asarray(w),
                         jnp.asarray(rows), TH, TW)
    assert got.shape == (rows.shape[0], TH, TW, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    batch = tops.roi_conv_batched(_t(frames), _t(w), _t(rows), TH, TW)
    assert batch.shape == (3, rows.shape[0], TH, TW, 8)
    for b in range(3):
        assert torch.equal(batch[b], roi_conv.roi_conv(
            _t(frames[b]), _t(w), _t(rows), TH, TW))


def test_fleet_conv_plain_matches_reference():
    """B7: the fleet gather + conv without ReLU against ``ref.roi_conv``
    per camera; its ReLU is B2 bitwise."""
    rng, _, idx, _, H, W = _fleet(22)
    C = len(SHAPES)
    x = rng.normal(size=(C, H, W, 3)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 8)) / np.sqrt(27)).astype(np.float32)
    got = roi_conv.roi_conv_fleet(_t(x), _t(w), _t(idx), TH, TW)
    for c in range(C):
        rows = idx[:, 0] == c
        want = jref.roi_conv(jnp.asarray(x[c]), jnp.asarray(w),
                             jnp.asarray(idx[rows, 1:]), TH, TW)
        np.testing.assert_allclose(got[rows].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    assert torch.equal(torch.relu(got), roi_conv.roi_conv_entry(
        _t(x), _t(w), _t(idx), TH, TW))


def test_gather_scatter_plain_bit_exact():
    """B9: one camera's gather and in-place scatter against
    ``ref.sbnet_gather`` / ``ref.sbnet_scatter``, bit-exact."""
    rng = np.random.default_rng(23)
    grid = rng.random((5, 4)) < 0.5
    rows = tops.mask_to_indices(grid)
    C = 10
    x = rng.normal(size=(5 * TH, 4 * TW, C)).astype(np.float32)
    got = sbnet.sbnet_gather(_t(x), _t(rows), TH, TW)
    want = jref.sbnet_gather(jnp.asarray(x), jnp.asarray(rows), TH, TW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    packed = rng.normal(size=(rows.shape[0], TH, TW, C)).astype(np.float32)
    base = rng.normal(size=x.shape).astype(np.float32)
    tb = _t(base.copy())
    assert sbnet.sbnet_scatter(_t(packed), _t(rows), tb) is tb
    want = jref.sbnet_scatter(jnp.asarray(packed), jnp.asarray(rows),
                              jnp.asarray(base), TH, TW)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(want))
    assert torch.equal(sbnet.sbnet_gather(tb, _t(rows), TH, TW),
                       _t(packed))


def test_slice_wrappers_count_dispatches_and_skip_empty_sets():
    """The B6-B9 wrappers count under their own names, ``roi_conv_batched``
    as one ``roi_conv``; zero rows are no dispatch."""
    rng, _, idx, nbr, H, W = _fleet(24)
    x = _t(rng.normal(size=(len(SHAPES), H, W, 3)).astype(np.float32))
    w0 = _t(rng.normal(size=(3, 3, 3, 8)).astype(np.float32))
    w1 = _t(rng.normal(size=(3, 3, 8, 16)).astype(np.float32))
    e2 = torch.zeros((0, 2), dtype=torch.int32)
    e3 = torch.zeros((0, 3), dtype=torch.int32)
    frame = x[0].contiguous()
    with tops.count_kernels() as c:
        assert tops.roi_conv_fleet(x, w0, e3, TH, TW).shape == (0, TH, TW, 8)
        assert tops.roi_conv(frame, w0, e2, TH, TW).shape == (0, TH, TW, 8)
        assert tops.roi_conv_batched(x, w0, e2, TH, TW).shape \
            == (len(SHAPES), 0, TH, TW, 8)
        assert tops.roi_conv_packed(torch.zeros((0, TH, TW, 8)), w1,
                                    torch.zeros((0, 8), dtype=torch.int32)) \
            .shape == (0, TH, TW, 16)
        assert tops.sbnet_gather(frame, e2, TH, TW).shape == (0, TH, TW, 3)
        base = torch.zeros((H, W, 3))
        assert tops.sbnet_scatter(torch.zeros((0, TH, TW, 3)), e2, base) \
            is base
    assert c == {}
    rows = _t(idx[idx[:, 0] == 0, 1:])
    with tops.count_kernels() as c:
        p = tops.roi_conv_fleet(x, w0, _t(idx), TH, TW)
        tops.roi_conv_packed(p, w1, _t(nbr))
        tops.roi_conv(frame, w0, rows, TH, TW)
        tops.roi_conv_batched(x, w0, rows, TH, TW)
        tiles = tops.sbnet_gather(frame, rows, TH, TW)
        tops.sbnet_scatter(tiles, rows, base)
    assert c == {"roi_conv_fleet": 1, "roi_conv_packed": 1, "roi_conv": 2,
                 "sbnet_gather": 1, "sbnet_scatter": 1}


def test_slice_launchers_refuse_other_devices():
    """B6-B9's launchers refuse a tensor that is neither on the CPU nor
    on a CUDA card: no plain-version fallback off the CPU."""
    m = torch.device("meta")
    idx2 = torch.zeros((1, 2), dtype=torch.int32, device=m)
    idx3 = torch.zeros((1, 3), dtype=torch.int32, device=m)
    w = torch.zeros((3, 3, 3, 8), device=m)
    frame = torch.zeros((8, 8, 3), device=m)
    with pytest.raises(ValueError):
        roi_conv.roi_conv_fleet(frame[None], w, idx3, 8, 8)
    with pytest.raises(ValueError):
        roi_conv.roi_conv(frame, w, idx2, 8, 8)
    with pytest.raises(ValueError):
        roi_conv.roi_conv_packed(torch.zeros((1, 8, 8, 8), device=m),
                                 torch.zeros((3, 3, 8, 8), device=m),
                                 torch.zeros((1, 8), dtype=torch.int32,
                                             device=m))
    with pytest.raises(ValueError):
        sbnet.sbnet_gather(frame, idx2, 8, 8)
    with pytest.raises(ValueError):
        sbnet.sbnet_scatter(torch.zeros((1, 8, 8, 3), device=m), idx2, frame)
