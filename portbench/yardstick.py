"""The benchmark's own arithmetic: peaks, work per tile, tiles the inputs
need.

Nothing here reads the program: the operations and bytes a fleet step
needs are worked out from the configuration's layer shapes and from the
changes the benchmark's own traffic made, so a later change to the
program cannot move the yardstick.  A roofline share is the least time
the card could take for that work (the larger of operations over the
peak rate and bytes over the memory bandwidth) over the time measured.
"""
from __future__ import annotations

import numpy as np

# Published peaks (NVIDIA's data sheet, SXM part, dense, at the 700 W
# power limit), keyed by the name ``torch.cuda.get_device_name`` gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flop_per_s": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}
F32 = 4   # bytes of a float32 and of an int32
# the program's kernels on the fleet path, by the names the profiler
# reports: the delta gate (B1), and the conv chain -- entry (B2), stack
# (B3; its layer-by-layer route past the ring's depth), scatter (B4)
KERNELS = {"tile_delta_gate_kernel": "gate", "roi_conv_entry_kernel": "conv",
           "roi_conv_stack_kernel": "conv", "roi_conv_layers_kernel": "conv",
           "tile_copy_kernel": "conv"}


def kernel_role(name: str):
    """"gate" or "conv" for a kernel of the fleet path, else None."""
    for kernel, role in KERNELS.items():
        if kernel in name:
            return role
    return None


def is_port_kernel(name: str) -> bool:
    return kernel_role(name) is not None


def peaks(device_name: str):
    """The device's peak rates, or None for a device the table lacks."""
    return PEAKS.get(device_name)


def least_s(nbytes: float, flops: float, peak) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / peak["hbm_bytes_per_s"],
               flops / peak["f32_flop_per_s"])


def conv_flop_per_px(channels) -> int:
    """3x3 convolution FLOPs a pixel of the stack 3 -> channels[0] -> ...,
    two operations a multiply-add."""
    chans = (3,) + tuple(channels)
    return sum(2 * 9 * ci * co for ci, co in zip(chans[:-1], chans[1:]))


def head_flop_per_px(channels, outputs: int) -> int:
    """The 1x1 head's FLOPs a pixel: the last channels to ``outputs``."""
    return 2 * channels[-1] * outputs


def detector_flop_per_tile(det_cfg: dict, tile: int) -> int:
    """Every FLOP of the detector on one tile: the convolutions and the
    head (7,664 a pixel for channels (8, 16, 16) and 10 outputs)."""
    outputs = det_cfg["num_anchors"] * det_cfg["head_outputs_per_anchor"]
    return tile * tile * (conv_flop_per_px(det_cfg["channels"])
                          + head_flop_per_px(det_cfg["channels"], outputs))


def conv_chain_work(det_cfg: dict, tile: int):
    """(FLOPs, bytes) of the entry, stack and scatter kernels on one
    tile: the convolutions' FLOPs; the frame tile read, the stack's output
    written, the head tile read by the scatter and written to the canvas,
    each once."""
    chans = det_cfg["channels"]
    outputs = det_cfg["num_anchors"] * det_cfg["head_outputs_per_anchor"]
    px = tile * tile
    nbytes = px * (3 + chans[-1] + 2 * outputs) * F32
    return px * conv_flop_per_px(chans), nbytes


def window_cover_px(grid: np.ndarray, tile: int) -> int:
    """Distinct pixels of the zero-padded plane that the active tiles'
    haloed (tile + 2)-pixel windows cover: a gate reads each once from the
    frame and once from the reference."""
    g = np.asarray(grid, bool)
    if not g.any():
        return 0
    # a padded plane row r is covered iff a window of an active tile holds
    # it: the tile's rows, one above and one below, in padded coordinates
    body = np.kron(g, np.ones((tile, tile), bool))
    plane = np.zeros((body.shape[0] + 2, body.shape[1] + 2), bool)
    plane[1:-1, 1:-1] = body
    rows = plane.copy()
    rows[1:] |= plane[:-1]
    rows[:-1] |= plane[1:]
    cover = rows.copy()
    cover[:, 1:] |= rows[:, :-1]
    cover[:, :-1] |= rows[:, 1:]
    return int(cover.sum())


def gate_bytes(grids, tile: int, cin: int = 3) -> int:
    """Bytes one gate launch over every active tile must move: the covered
    pixels of the frames and of the reference, the (cam, ty, tx) rows
    read and the 8-wide stats rows written."""
    cover = sum(window_cover_px(g, tile) for g in grids)
    n = sum(int(np.count_nonzero(g)) for g in grids)
    return 2 * cover * cin * F32 + n * (3 + 8) * F32


def dilate(changed: np.ndarray, active: np.ndarray) -> np.ndarray:
    """One 8-neighbour dilation of a tile set over the active tiles."""
    c = np.zeros((changed.shape[0] + 2, changed.shape[1] + 2), bool)
    c[1:-1, 1:-1] = changed
    out = changed.copy()
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out |= c[dy:dy + changed.shape[0], dx:dx + changed.shape[1]]
    return out & active


def window_hits(rects, grid_shape, tile: int) -> np.ndarray:
    """Tiles whose haloed entry window (the tile and one pixel around it)
    holds a pixel of any ``(y0, x0, h, w)`` rectangle."""
    hit = np.zeros(grid_shape, bool)
    gh, gw = grid_shape
    for y0, x0, h, w in rects:
        # window rows ty*t - 1 .. ty*t + t meet rows y0 .. y0 + h - 1
        ty0 = max(-(-(y0 - tile) // tile), 0)
        ty1 = min((y0 + h) // tile, gh - 1)
        tx0 = max(-(-(x0 - tile) // tile), 0)
        tx1 = min((x0 + w) // tile, gw - 1)
        if ty0 <= ty1 and tx0 <= tx1:
            hit[ty0:ty1 + 1, tx0:tx1 + 1] = True
    return hit


def needed_tiles(grid: np.ndarray, keyframe: bool, rects, tile: int,
                 later_layers: int) -> int:
    """Active tiles of one camera whose output a step has to recompute:
    every active tile on a keyframe, else those whose entry window holds a
    changed pixel, dilated once per later conv layer over active
    neighbours."""
    active = np.asarray(grid, bool)
    if keyframe:
        return int(active.sum())
    changed = window_hits(rects, active.shape, tile) & active
    for _ in range(later_layers):
        changed = dilate(changed, active)
    return int(changed.sum())
