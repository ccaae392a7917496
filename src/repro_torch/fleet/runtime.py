"""The kernel-level fleet step: every camera of every group in one launch
chain, with its dispatch structure asserted on every step.

``fleet_inference_step`` is the cold super-launch: one fused gather + conv
entry kernel, one layer-stack kernel for every later layer, one scatter --
at most 3 dispatches per fleet step, whatever the number of groups and
layers.  ``fleet_reuse_step`` is the delta-gated variant: one
``tile_delta_gate`` dispatch prices every active tile against the cache,
the same chain runs on the changed tiles only, and one changed-only
scatter updates the persistent head-map canvas.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np

from repro_torch.kernels import ops as kops


def _n_tiles(grids: Dict[int, List[np.ndarray]]) -> int:
    return sum(int(np.count_nonzero(np.asarray(g, bool)))
               for gs in grids.values() for g in gs)


def fleet_inference_step(det, frames: Dict[int, List],
                         grids: Dict[int, List[np.ndarray]]):
    """One fleet step: ALL groups' cameras as ONE super-launch chain.

    frames[gid] / grids[gid]: per-camera (H, W, 3) frames and RoI tile
    grids of group ``gid``.  Returns ({gid: per-camera head maps},
    dispatch Counter).  Asserts the super-launch structure: one entry, one
    layer stack (none for a 1-layer net), one scatter; an all-empty fleet
    launches nothing."""
    with kops.count_kernels() as c:
        outs = det.superlaunch_forward(frames, grids)
    total: collections.Counter = collections.Counter(c)
    expected = {} if _n_tiles(grids) == 0 else {
        "roi_conv_entry": 1,
        "roi_conv_stack": 1 if det.num_conv_layers > 1 else 0,
        "sbnet_scatter_fleet": 1}
    observed = {k: total[k] for k in expected}
    assert observed == expected and not set(total) - set(expected), \
        f"super-launch dispatch structure broken: {dict(total)}"
    assert sum(total.values()) <= 3, \
        f"fleet step must stay within 3 dispatches: {dict(total)}"
    return outs, total


def fleet_reuse_step(det, frames: Dict[int, List],
                     grids: Dict[int, List[np.ndarray]], cache,
                     threshold=0.0, qstep: float = 8.0):
    """One delta-gated fleet step, compute proportional to CHANGED tiles,
    through ``RoIDetector.superlaunch_forward_reuse``.  Returns ({gid:
    head maps}, dispatch Counter, ReuseStats); the head maps are views of
    ``cache.canvas``, valid until the next step on ``cache``.  Asserts the
    delta-gated structure on every step:

    * a cold step is the plain super-launch: entry, stack, full scatter;
    * a changed step is one gate, entry, stack and one changed-only
      scatter;
    * an all-static step is the gate ALONE;
    * an all-empty fleet launches nothing."""
    with kops.count_kernels() as c:
        outs, stats = det.superlaunch_forward_reuse(frames, grids, cache,
                                                    threshold, qstep)
    total: collections.Counter = collections.Counter(c)
    stack = 1 if det.num_conv_layers > 1 else 0
    if _n_tiles(grids) == 0:
        expected = {}
    elif stats.cold:
        expected = {"roi_conv_entry": 1, "roi_conv_stack": stack,
                    "sbnet_scatter_fleet": 1}
    elif stats.computed == 0:
        expected = {"tile_delta_gate": 1}
    else:
        expected = {"tile_delta_gate": 1, "roi_conv_entry": 1,
                    "roi_conv_stack": stack, "sbnet_scatter_changed": 1}
    expected = {k: v for k, v in expected.items() if v}
    observed = {k: total[k] for k in expected}
    assert observed == expected and not set(total) - set(expected), \
        f"delta-gated dispatch structure broken: {dict(total)}"
    conv = sum(v for k, v in total.items() if k != "tile_delta_gate")
    assert conv <= 3, \
        f"reuse step must keep the <=3-dispatch conv ceiling: {dict(total)}"
    return outs, total, stats
