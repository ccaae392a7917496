"""Reducto-style frame filtering and the CrossRoI-Reducto integration
(paper §5.4, Fig 12, Table 4).

Reducto keeps a frame only when a cheap low-level difference feature against
the last *sent* frame exceeds a threshold; the threshold is tuned offline on
profiling clips to meet an accuracy target.  Our difference feature is the
symmetric-difference area of (mask-clipped) object boxes between the current
frame and the last sent one — the analytic stand-in for Reducto's pixel/edge
differencing, computed from the same scene ground truth the codec model uses.

CrossRoI-Reducto = the identical machinery run on *mask-cropped* content:
features only see what survives the RoI crop, exactly like Fig 12 (masks
first, frame filter second).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.geometry import BBox
from repro_torch.core.pipeline import (OfflineResult, OnlineConfig,
                                       OnlineMetrics, bbox_mask_area,
                                       run_online)
from repro_torch.core.scene import Scene


def _clip_box_to_mask(scene: Scene, offline: OfflineResult, cam: int,
                      b: BBox) -> float:
    """Area of bbox ∩ RoI mask (pixelwise over tile rectangles)."""
    return bbox_mask_area(scene.cameras[cam], offline.cam_grids[cam], b)


def _frame_boxes(scene: Scene, cam: int, t: int) -> Dict[int, BBox]:
    return {d.obj: d.bbox for d in scene.detections[t] if d.cam == cam}


def diff_feature(scene: Scene, offline: OfflineResult, cam: int,
                 t: int, t_last: int, use_mask: bool) -> float:
    """Symmetric-difference area of object content between t and t_last,
    normalized by the (masked) frame area."""
    cur = _frame_boxes(scene, cam, t)
    prev = _frame_boxes(scene, cam, t_last)
    c = scene.cameras[cam]
    denom = offline.mask_area_px(cam) if use_mask else c.width * c.height
    denom = max(denom, 1.0)
    changed = 0.0
    for obj in set(cur) | set(prev):
        b0, b1 = prev.get(obj), cur.get(obj)
        if b0 is None or b1 is None:
            b = b1 or b0
            a = _clip_box_to_mask(scene, offline, cam, b) if use_mask \
                else b.area
            changed += a
            continue
        # moved content: union - intersection of the two boxes
        ix = max(0.0, min(b0.right, b1.right) - max(b0.left, b1.left))
        iy = max(0.0, min(b0.bottom, b1.bottom) - max(b0.top, b1.top))
        if use_mask:
            a0 = _clip_box_to_mask(scene, offline, cam, b0)
            a1 = _clip_box_to_mask(scene, offline, cam, b1)
            inter = min(a0, a1) * (ix * iy) / max(min(b0.area, b1.area), 1.0)
            changed += a0 + a1 - 2 * inter
        else:
            changed += b0.area + b1.area - 2 * ix * iy
    return changed / denom


def keep_masks_for_threshold(scene: Scene, offline: OfflineResult,
                             threshold: float, t0: int, t1: int,
                             use_mask: bool) -> Dict[int, np.ndarray]:
    """Greedy online filtering: keep frame iff diff vs last-kept > threshold.
    The first frame of every segment is always kept (Reducto's anchor)."""
    keep: Dict[int, np.ndarray] = {}
    for c in scene.cameras:
        cid = c.cam_id
        k = np.zeros(t1 - t0, bool)
        last = t0
        k[0] = True
        for t in range(t0 + 1, t1):
            f = diff_feature(scene, offline, cid, t, last, use_mask)
            if f > threshold:
                k[t - t0] = True
                last = t
        keep[cid] = k
    return keep


@dataclass
class ReductoResult:
    target: float
    achieved: float
    threshold: float
    metrics: OnlineMetrics


def tune_and_run(scene: Scene, offline: OfflineResult, target: float,
                 online_cfg: Optional[OnlineConfig] = None,
                 profile: Tuple[int, int] = (0, 600),
                 evalw: Tuple[int, int] = (600, 1800),
                 use_mask: bool = True) -> ReductoResult:
    """Offline: pick the most aggressive threshold meeting the accuracy
    target on the profiling window; online: apply it on the eval window."""
    online_cfg = online_cfg or OnlineConfig()
    if target >= 1.0:  # paper: filtering disabled at 100% target
        m = run_online(scene, offline, online_cfg, *evalw)
        return ReductoResult(target, m.accuracy, 0.0, m)

    # tune with a safety margin: the threshold is chosen on the profiling
    # window but deployed out-of-window, so meeting the bare target during
    # profiling undershoots online (Reducto has the same generalization
    # slack; its paper rows also land a little under/over target)
    margin = 0.015 if target < 1.0 else 0.0
    grid = np.concatenate([[0.0], np.geomspace(1e-4, 0.5, 24)])
    best_thr = 0.0
    for thr in grid:
        keep = keep_masks_for_threshold(scene, offline, thr, *profile,
                                        use_mask=use_mask)
        cfg_p = OnlineConfig(segment_s=online_cfg.segment_s,
                             bandwidth_mbps=online_cfg.bandwidth_mbps,
                             rtt_ms=online_cfg.rtt_ms,
                             roi_inference=online_cfg.roi_inference,
                             frame_keep=keep)
        m = run_online(scene, offline, cfg_p, *profile)
        if m.accuracy >= min(target + margin, 1.0):
            best_thr = float(thr)
        else:
            break
    keep = keep_masks_for_threshold(scene, offline, best_thr, *evalw,
                                    use_mask=use_mask)
    cfg_e = OnlineConfig(segment_s=online_cfg.segment_s,
                         bandwidth_mbps=online_cfg.bandwidth_mbps,
                         rtt_ms=online_cfg.rtt_ms,
                         roi_inference=online_cfg.roi_inference,
                         frame_keep=keep)
    m = run_online(scene, offline, cfg_e, *evalw)
    return ReductoResult(target, m.accuracy, best_thr, m)
