"""The benchmark's own counts against hand arithmetic: FLOPs and bytes a
tile, the gate's bytes, the tiles the inputs need."""
import numpy as np
import pytest

from portbench import yardstick as Y

DET = {"channels": [8, 16, 16], "num_anchors": 2,
       "head_outputs_per_anchor": 5}


def test_flops_per_pixel_and_tile():
    # 3->8, 8->16, 16->16 3x3 convs: 2*9*(24 + 128 + 256)
    assert Y.conv_flop_per_px([8, 16, 16]) == 432 + 2304 + 4608 == 7344
    assert Y.head_flop_per_px([8, 16, 16], 10) == 320
    assert Y.detector_flop_per_tile(DET, 16) == 256 * 7664


def test_conv_chain_work():
    flops, nbytes = Y.conv_chain_work(DET, 16)
    assert flops == 256 * 7344
    # frame tile (3) in, stack output (16) out, head tile (10) in and out
    assert nbytes == 256 * (3 + 16 + 10 + 10) * 4 == 39936


def test_least_time_takes_the_larger_bound():
    peak = Y.peaks("NVIDIA H100 80GB HBM3")
    flops, nbytes = Y.conv_chain_work(DET, 16)
    assert Y.least_s(nbytes, flops, peak) == pytest.approx(flops / 67e12)
    assert Y.least_s(3.35e12, 0, peak) == pytest.approx(1.0)
    assert Y.peaks("some other card") is None


@pytest.mark.parametrize("grid,want", [
    ([[1]], 18 * 18),                       # one window
    ([[1, 1]], 18 * 34),                    # two side by side share a seam
    ([[1, 0, 1]], 2 * 18 * 18),             # 16 px apart: no overlap
    ([[1, 0], [0, 1]], 2 * 18 * 18 - 4),    # diagonal: 2x2 corner shared
])
def test_window_cover(grid, want):
    assert Y.window_cover_px(np.array(grid, bool), 16) == want


def test_gate_bytes_by_hand():
    g = np.array([[1]], bool)
    assert Y.gate_bytes([g], 16) == 2 * 324 * 3 * 4 + 11 * 4 == 7820


def test_window_hits_by_hand():
    # rows 16..31, cols 16..31: windows of tiles 0..2 meet it each way
    hits = Y.window_hits([(16, 16, 16, 16)], (4, 6), 16)
    want = np.zeros((4, 6), bool)
    want[0:3, 0:3] = True
    assert np.array_equal(hits, want)
    # a 64-px car at (40, 8): rows 40..103 -> tiles 2..6, cols 8..71 -> 0..4
    hits = Y.window_hits([(40, 8, 64, 64)], (8, 8), 16)
    assert np.argwhere(hits.any(1)).ravel().tolist() == [2, 3, 4, 5, 6]
    assert np.argwhere(hits.any(0)).ravel().tolist() == [0, 1, 2, 3, 4]
    # a 20 x 33 box at (32, 15): rows 32..51 -> tiles 1..3 (row 32 is
    # tile 1's halo), cols 15..47 -> tiles 0..3 (col 15 is tile 1's
    # halo, col 47 tile 3's)
    hits = Y.window_hits([(32, 15, 20, 33)], (8, 8), 16)
    assert np.argwhere(hits.any(1)).ravel().tolist() == [1, 2, 3]
    assert np.argwhere(hits.any(0)).ravel().tolist() == [0, 1, 2, 3]


def test_dilation_and_needed_tiles():
    active = np.ones((7, 7), bool)
    one = np.zeros((7, 7), bool)
    one[3, 3] = True
    assert Y.dilate(one, active).sum() == 9
    # a tile window of one pixel, two later layers: 5x5 around the hit
    rect = [(3 * 16 + 4, 3 * 16 + 4, 1, 1)]
    assert Y.needed_tiles(active, False, rect, 16, 2) == 25
    holes = active.copy()
    holes[:, 4] = False                      # a column of inactive tiles
    # the dilation does not cross it: rows 1..5 of columns 1..3
    assert Y.needed_tiles(holes, False, rect, 16, 2) == 5 * 3
    assert Y.needed_tiles(holes, True, [], 16, 2) == holes.sum()
    assert Y.needed_tiles(active, False, [], 16, 2) == 0


def test_port_kernel_roles():
    assert Y.kernel_role("void (anonymous namespace)::tile_delta_gate_kernel"
                         "<true>(float const*)") == "gate"
    for k in ("roi_conv_entry_kernel", "roi_conv_stack_kernel",
              "roi_conv_layers_kernel", "tile_copy_kernel"):
        assert Y.kernel_role(f"void {k}<1>(int)") == "conv"
    assert not Y.is_port_kernel("void at::native::elementwise_kernel<128>")
