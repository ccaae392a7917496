"""ReID noise model — raw (error-prone) re-identification results.

The paper runs DiDi-MTMC over the profiling clips and characterizes its raw
output, per ordered camera pair, into TP / FP / FN / TN (§4.2.1, Table 2).
The dataset is not redistributable, so we reproduce the *error structure*:
starting from exact geometric ground truth (core/scene.py), we corrupt the
ID assignments with pairwise error rates calibrated to Table 2:

  FN: a cross-camera appearance pair is *split* — the two appearances of the
      same object get different IDs.  Table 2: FN usually outweighs TP
      (e.g. C3->C5: 155 TP vs 1871 FN).  We model FN as track-level events
      (ReID loses a track for a stretch, not per-frame coin flips) so the
      SVM filter sees the realistic blobs-of-errors structure.
  FP: a detection is *merged* with a wrong object in the destination camera.
      Table 2: rarer than FN, and concentrated where bbox statistics are
      degenerate (small/far boxes) — we bias FP toward small boxes so the
      regression filter has realistic outliers to find.

The output schema matches the paper's: <left, top, width, height, id> per
detection per frame (§4.1.1 step 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.geometry import BBox
from repro_torch.core.scene import Detection, Scene


@dataclass(frozen=True)
class ReIDRecord:
    """One raw ReID output row: a detection plus its *assigned* id."""
    cam: int
    t: int
    bbox: BBox
    rid: int          # id assigned by the (noisy) ReID algorithm
    obj: int          # ground-truth object id (held for evaluation only)


# Table 2 of the paper, used to calibrate pairwise error rates.  Rates are
# aggregated over the table:  FN/(TP+FN) per pair ranges ~0.4..0.95,
# FP/(TP+FP) ranges ~0..0.43.
PAPER_TABLE2_FN_RATE = 0.62   # median FN fraction among positives
PAPER_TABLE2_FP_RATE = 0.30   # FP fraction among positive assignments
                              # (Table 2 ranges 0..43%, e.g. C1->C2 253/588)


@dataclass
class ReIDNoiseConfig:
    fn_rate: float = PAPER_TABLE2_FN_RATE
    fp_rate: float = PAPER_TABLE2_FP_RATE
    fn_burst_len: float = 14.0   # mean frames per FN burst (track-level)
    small_box_bias: float = 2.0  # FP odds multiplier for small boxes
    seed: int = 1


def run_noisy_reid(scene: Scene, cfg: Optional[ReIDNoiseConfig] = None,
                   t0: int = 0, t1: Optional[int] = None) -> List[ReIDRecord]:
    """Produce raw ReID records over frames [t0, t1) of the scene.

    ID space: ground-truth object ids, except where noise splits (FN: fresh
    negative ids) or merges (FP: the id of a different co-visible object).
    """
    cfg = cfg or ReIDNoiseConfig()
    rng = np.random.default_rng(cfg.seed)
    t1 = len(scene.detections) if t1 is None else t1

    # --- FN bursts: per (cam, obj) track, sample stretches where the track's
    # cross-camera link is lost (the detection gets a private id).
    track_frames: Dict[Tuple[int, int], List[int]] = {}
    for fr in scene.detections[t0:t1]:
        for d in fr:
            track_frames.setdefault((d.cam, d.obj), []).append(d.t)

    split_frames: Dict[Tuple[int, int], set] = {}
    next_neg_id = 1_000_000
    split_ids: Dict[Tuple[int, int], int] = {}
    for key, frames in track_frames.items():
        n = len(frames)
        lost = np.zeros(n, bool)
        i = 0
        while i < n:
            if rng.random() < cfg.fn_rate / max(cfg.fn_burst_len, 1.0):
                burst = max(1, int(rng.exponential(cfg.fn_burst_len)))
                lost[i:i + burst] = True
                i += burst
            else:
                i += 1
        if lost.any():
            split_frames[key] = {frames[i] for i in np.nonzero(lost)[0]}
            split_ids[key] = next_neg_id
            next_neg_id += 1

    # --- FP merges: per frame, pick detections (biased toward small boxes)
    # and reassign them the id of another object visible in a different cam.
    records: List[ReIDRecord] = []
    for fr in scene.detections[t0:t1]:
        if not fr:
            continue
        med_area = float(np.median([d.bbox.area for d in fr]))
        by_cam: Dict[int, List[Detection]] = {}
        for d in fr:
            by_cam.setdefault(d.cam, []).append(d)
        for d in fr:
            rid = d.obj
            key = (d.cam, d.obj)
            if key in split_frames and d.t in split_frames[key]:
                rid = split_ids[key]
            else:
                odds = cfg.fp_rate / (1.0 - cfg.fp_rate)
                if d.bbox.area < 0.5 * med_area:
                    odds *= cfg.small_box_bias
                p = odds / (1.0 + odds)
                if rng.random() < p * 0.35:  # only a slice of frames actually FP
                    # merge with a *plausible* wrong object from another
                    # camera: ReID confuses similar-looking (similar-sized)
                    # detections, so bias toward the closest bbox areas
                    others = [o for c, dets in by_cam.items() if c != d.cam
                              for o in dets if o.obj != d.obj]
                    if others:
                        others.sort(key=lambda o: abs(o.bbox.area
                                                      - d.bbox.area))
                        pick = others[:max(3, len(others) // 4)]
                        rid = pick[rng.integers(len(pick))].obj
            records.append(ReIDRecord(d.cam, d.t, d.bbox, rid, d.obj))
    return records


# ---------------------------------------------------------------------------
# Pairwise TP/FP/FN/TN characterization (reproduces paper Table 2)
# ---------------------------------------------------------------------------

def characterize_pairwise(records: List[ReIDRecord], num_cams: int
                          ) -> np.ndarray:
    """counts[src, dst] = (TP, FP, FN, TN) as defined in §4.2.1.

    For each detection in the source camera at time t:
      positive(gt)  = its ground-truth object also appears in dst at t
      positive(rid) = its assigned id matches some assigned id in dst at t
      TP: positive(rid) and the matched dst detection is the same gt object
      FP: positive(rid) but matched to a wrong gt object (or gt-negative)
      FN: positive(gt) but not matched under the assigned ids
      TN: negative(gt) and not matched
    """
    counts = np.zeros((num_cams, num_cams, 4), np.int64)
    by_t_cam: Dict[Tuple[int, int], List[ReIDRecord]] = {}
    for r in records:
        by_t_cam.setdefault((r.t, r.cam), []).append(r)
    times = sorted({r.t for r in records})
    for t in times:
        for src in range(num_cams):
            src_rows = by_t_cam.get((t, src), [])
            if not src_rows:
                continue
            for dst in range(num_cams):
                if dst == src:
                    continue
                dst_rows = by_t_cam.get((t, dst), [])
                dst_rids = {r.rid: r for r in dst_rows}
                dst_objs = {r.obj for r in dst_rows}
                for r in src_rows:
                    gt_pos = r.obj in dst_objs
                    match = dst_rids.get(r.rid)
                    if match is not None:
                        if gt_pos and match.obj == r.obj:
                            counts[src, dst, 0] += 1  # TP
                        else:
                            counts[src, dst, 1] += 1  # FP
                    else:
                        if gt_pos:
                            counts[src, dst, 2] += 1  # FN
                        else:
                            counts[src, dst, 3] += 1  # TN
    return counts
