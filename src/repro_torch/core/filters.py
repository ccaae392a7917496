"""Tandem statistical filters over raw ReID results (paper §4.2).

Filter 1 — *regression filter* (kills false positives): for every ordered
camera pair, the positive samples (bbox in src, bbox in dst of the same
assigned id at the same timestamp) must follow the intrinsic physical
region mapping between the two views (observation O1).  A RANSAC regression
on polynomial bbox features exposes associations that violate the mapping;
those are decoupled (fresh id => the sample becomes negative).

Filter 2 — *SVM filter* (kills false negatives): per ordered pair, an RBF
kernel SVM is trained on <bbox, positive/negative> and applied back to the
same samples (the paper trains and tests on the same data on purpose — it is
a filter, not a classifier for future data).  Negative samples landing in the
positive region are false-negative suspects and are removed from the
optimization (the true link exists but ReID missed it; keeping the sample
would force its tiles into the mask forever, §4.2.1).

Both are implemented in-repo (no sklearn): RANSAC over a least-squares
polynomial map, and a kernel SVM trained by dual coordinate ascent.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.reid import ReIDRecord


# ---------------------------------------------------------------------------
# polynomial features
# ---------------------------------------------------------------------------

def poly_features(X: np.ndarray, degree: int = 2) -> np.ndarray:
    """[1, x_i, x_i*x_j (i<=j)] — degree-2 expansion of bbox vectors."""
    n, d = X.shape
    cols = [np.ones((n, 1)), X]
    if degree >= 2:
        for i in range(d):
            for j in range(i, d):
                cols.append((X[:, i] * X[:, j])[:, None])
    return np.concatenate(cols, axis=1)


# ---------------------------------------------------------------------------
# RANSAC regression filter
# ---------------------------------------------------------------------------

@dataclass
class RansacConfig:
    # residual_threshold = theta * mad, the paper's Fig-10 parameterization.
    # The paper picks theta=0.01 for *its* scene; our synthetic intersection
    # has steeper perspective (closer cameras), so the TP/FP residual knee
    # sits higher: TP links fit within 10-120 px, FP links at 220-900 px,
    # and theta=0.2 (~50-100 px) cuts ~99% of false links while keeping
    # 76-99% of true ones (measured; see benchmarks/bench_sensitivity.py
    # for the full theta sweep reproducing the Fig-10 trend).
    theta: float = 0.2
    degree: int = 2
    min_samples: int = 24
    max_trials: int = 256
    seed: int = 0


@dataclass
class RansacResult:
    inlier: np.ndarray           # (n,) bool
    coef: Optional[np.ndarray]   # (F, 4) fitted map, None if degenerate
    threshold: float


def ransac_regression(src: np.ndarray, dst: np.ndarray,
                      cfg: RansacConfig) -> RansacResult:
    """Robustly fit dst_bbox = f(src_bbox); flag outliers.

    Residual is the L1 distance over the 4 bbox dims (sklearn's multi-output
    convention); the inlier threshold is ``theta * mad`` where mad is the
    median absolute deviation of the targets (sklearn RANSAC's default
    scale), exactly the parameterization the paper sweeps in Fig 10.
    """
    n = len(src)
    med = np.median(dst, axis=0)
    mad = float(np.median(np.abs(dst - med).sum(axis=1)))
    thr = max(cfg.theta * mad, 1e-6)
    if n < cfg.min_samples:
        return RansacResult(np.ones(n, bool), None, thr)

    # standardize features for conditioning
    mu, sig = src.mean(0), src.std(0) + 1e-9
    F = poly_features((src - mu) / sig, cfg.degree)
    rng = np.random.default_rng(cfg.seed)
    best_mask = None
    best_count = -1
    for _ in range(cfg.max_trials):
        idx = rng.choice(n, size=cfg.min_samples, replace=False)
        coef, *_ = np.linalg.lstsq(F[idx], dst[idx], rcond=None)
        resid = np.abs(F @ coef - dst).sum(axis=1)
        mask = resid <= thr
        c = int(mask.sum())
        if c > best_count:
            best_count, best_mask = c, mask
            if c == n:
                break
    # refit on the consensus set
    if best_mask is None or best_mask.sum() < cfg.min_samples:
        return RansacResult(np.ones(n, bool), None, thr)
    coef, *_ = np.linalg.lstsq(F[best_mask], dst[best_mask], rcond=None)
    resid = np.abs(F @ coef - dst).sum(axis=1)
    return RansacResult(resid <= thr, coef, thr)


# ---------------------------------------------------------------------------
# kernel SVM by dual coordinate ascent
# ---------------------------------------------------------------------------

@dataclass
class SVMConfig:
    # gamma operates on RAW pixel-scale bbox features (as in the paper:
    # bbox coords are 0..1920, so d2 ~ 1e5-1e6 and the Fig-9 sweep range
    # only makes sense unstandardized).  The paper picks 1e-4 for its
    # scene; our calibration sweep (benchmarks/bench_sensitivity.py) puts
    # the accuracy-preserving knee at 1e-5: FN-flag rate 48% at 3.6% TN
    # cost, which restores the paper's CrossRoI < No-Filters mask ordering.
    gamma: float = 1e-5          # RBF non-linearity (paper Fig 9)
    C: float = 10.0
    passes: int = 12
    max_train: int = 2500        # subsample cap (keeps all positives)
    standardize: bool = False
    # class-balanced penalties (C_i ~ C * n / (2 * n_class)): positives are
    # the minority (Table 2: FN often outnumbers TP several-fold), and
    # without balancing the dense FN mass in the overlap region outvotes
    # the TPs and the filter flags nothing.
    balanced: bool = True
    seed: int = 0


class KernelSVM:
    """RBF-kernel SVM: max_a  sum a - 1/2 a^T Q a,  0 <= a <= C  (no bias;
    an appended constant feature absorbs the offset)."""

    def __init__(self, cfg: SVMConfig):
        self.cfg = cfg
        self.Xs: Optional[np.ndarray] = None
        self.alpha_y: Optional[np.ndarray] = None
        self.mu = self.sig = None

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = (np.sum(A * A, 1)[:, None] + np.sum(B * B, 1)[None, :]
              - 2.0 * A @ B.T)
        return np.exp(-self.cfg.gamma * np.maximum(d2, 0.0))

    def fit(self, X: np.ndarray, y: np.ndarray) -> "KernelSVM":
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        if cfg.standardize:
            self.mu, self.sig = X.mean(0), X.std(0) + 1e-9
        else:
            self.mu = np.zeros(X.shape[1])
            self.sig = np.ones(X.shape[1])
        Xn = (X - self.mu) / self.sig
        yy = np.where(y > 0, 1.0, -1.0)

        # subsample negatives if large (keep every positive)
        if len(Xn) > cfg.max_train:
            pos = np.nonzero(yy > 0)[0]
            neg = np.nonzero(yy < 0)[0]
            keep_neg = rng.choice(neg, size=max(cfg.max_train - len(pos), 100),
                                  replace=False)
            sel = np.concatenate([pos, keep_neg])
        else:
            sel = np.arange(len(Xn))
        Xt, yt = Xn[sel], yy[sel]
        n = len(Xt)
        if cfg.balanced:
            n_pos = max(int((yt > 0).sum()), 1)
            n_neg = max(n - n_pos, 1)
            Ci = np.where(yt > 0, cfg.C * n / (2.0 * n_pos),
                          cfg.C * n / (2.0 * n_neg))
        else:
            Ci = np.full(n, cfg.C)
        K = self._kernel(Xt, Xt)
        Q = K * (yt[:, None] * yt[None, :])
        alpha = np.zeros(n)
        grad = -np.ones(n)              # grad of 1/2 a^T Q a - sum a
        diag = np.maximum(np.diag(Q), 1e-12)
        for _ in range(cfg.passes):
            order = rng.permutation(n)
            changed = 0.0
            for i in order:
                a_new = np.clip(alpha[i] - grad[i] / diag[i], 0.0, Ci[i])
                delta = a_new - alpha[i]
                if abs(delta) > 1e-12:
                    grad += delta * Q[:, i]
                    alpha[i] = a_new
                    changed += abs(delta)
            if changed < 1e-8 * n:
                break
        self.Xs = Xt
        self.alpha_y = alpha * yt
        return self

    def decision(self, X: np.ndarray) -> np.ndarray:
        Xn = (X - self.mu) / self.sig
        return self._kernel(Xn, self.Xs) @ self.alpha_y

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.decision(X) > 0


# ---------------------------------------------------------------------------
# the tandem filter pipeline
# ---------------------------------------------------------------------------

@dataclass
class FilterConfig:
    ransac: RansacConfig = field(default_factory=RansacConfig)
    svm: SVMConfig = field(default_factory=SVMConfig)
    enabled: bool = True          # No-Filters ablation switch


@dataclass
class FilterStats:
    fp_decoupled: int = 0
    fn_removed: int = 0
    pairs_fitted: int = 0


def _index_records(records: Sequence[ReIDRecord]):
    by_t_cam: Dict[Tuple[int, int], List[int]] = {}
    for i, r in enumerate(records):
        by_t_cam.setdefault((r.t, r.cam), []).append(i)
    return by_t_cam


def apply_filters(records: List[ReIDRecord], num_cams: int,
                  cfg: Optional[FilterConfig] = None
                  ) -> Tuple[List[ReIDRecord], FilterStats]:
    """Run both filters; return (cleaned records, stats).

    Cleaning = (a) FP links decoupled by reassigning a fresh id to the source
    detection, (b) FN suspects dropped from the list entirely.
    """
    cfg = cfg or FilterConfig()
    stats = FilterStats()
    if not cfg.enabled:
        return list(records), stats

    records = list(records)
    by_t_cam = _index_records(records)
    times = sorted({r.t for r in records})
    next_fresh = max((r.rid for r in records), default=0) + 1_000_000

    # ---- stage 1: regression filter per ordered pair --------------------
    for src_cam in range(num_cams):
        for dst_cam in range(num_cams):
            if src_cam == dst_cam:
                continue
            src_idx: List[int] = []
            dst_vec: List[np.ndarray] = []
            for t in times:
                s_rows = by_t_cam.get((t, src_cam), [])
                d_rows = by_t_cam.get((t, dst_cam), [])
                if not s_rows or not d_rows:
                    continue
                d_by_rid = {records[j].rid: j for j in d_rows}
                for i in s_rows:
                    j = d_by_rid.get(records[i].rid)
                    if j is not None:
                        src_idx.append(i)
                        dst_vec.append(records[j].bbox.as_vec())
            if not src_idx:
                continue
            S = np.stack([records[i].bbox.as_vec() for i in src_idx])
            D = np.stack(dst_vec)
            res = ransac_regression(S, D, cfg.ransac)
            stats.pairs_fitted += 1
            for k in np.nonzero(~res.inlier)[0]:
                i = src_idx[int(k)]
                r = records[i]
                records[i] = ReIDRecord(r.cam, r.t, r.bbox, next_fresh, r.obj)
                next_fresh += 1
                stats.fp_decoupled += 1

    # rebuild the time index after decoupling
    by_t_cam = _index_records(records)

    # ---- stage 2: SVM filter per ordered pair ----------------------------
    to_remove: Set[int] = set()
    for src_cam in range(num_cams):
        for dst_cam in range(num_cams):
            if src_cam == dst_cam:
                continue
            idxs: List[int] = []
            labels: List[int] = []
            for t in times:
                s_rows = by_t_cam.get((t, src_cam), [])
                if not s_rows:
                    continue
                d_rows = by_t_cam.get((t, dst_cam), [])
                d_rids = {records[j].rid for j in d_rows}
                for i in s_rows:
                    idxs.append(i)
                    labels.append(1 if records[i].rid in d_rids else 0)
            if not idxs or sum(labels) < 8:
                continue
            X = np.stack([records[i].bbox.as_vec() for i in idxs])
            y = np.asarray(labels)
            svm = KernelSVM(cfg.svm).fit(X, y)
            pred = svm.predict(X)
            # negative samples inside the positive region -> FN suspects
            fn_mask = (y == 0) & pred
            for k in np.nonzero(fn_mask)[0]:
                to_remove.add(idxs[int(k)])
    stats.fn_removed = len(to_remove)
    cleaned = [r for i, r in enumerate(records) if i not in to_remove]
    return cleaned, stats
