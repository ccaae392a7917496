"""RoI-mask combinatorial optimization (paper §3.3, Eq. 1-2).

    min |M|   s.t.  every constraint keeps >= 1 appearance region R with
                    all tiles of R inside M.

The paper hands this to Gurobi; we solve it in-repo:

  * ``greedy``   — cost-effectiveness greedy over regions (new-tiles /
                   newly-satisfied-constraints), the classic ln(n) set-cover
                   heuristic adapted to the one-of-many-regions constraint.
  * ``exact``    — branch-and-bound on the region choice of the most
                   constrained unsatisfied constraint, bounded by an
                   LP-relaxation lower bound (scipy HiGHS linprog) and
                   warm-started by the greedy incumbent.
  * ``milp``     — scipy.optimize.milp (HiGHS) on the full ILP; used as the
                   cross-check oracle in tests.

Preprocessing does most of the work on real instances: constraints are
dedup'd, single-region constraints force their tiles in, and constraints
already satisfied by forced tiles are dropped — what survives is a small
core instance.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.association import AssociationTable, Region


@dataclass
class SolveResult:
    mask: FrozenSet[int]          # chosen global tile ids (the union mask M)
    lower_bound: float            # certified LB on |M| (exact => LB == |M|)
    method: str
    nodes: int = 0
    optimal: bool = False
    wall_s: float = 0.0


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

@dataclass
class CoreInstance:
    forced: Set[int]                       # tiles forced by singleton constraints
    constraints: List[List[FrozenSet[int]]]  # residual tile-sets (forced removed)


def preprocess(constraints: Sequence[Sequence[Region]]) -> CoreInstance:
    # dedup by the multiset of region tile-sets
    seen = set()
    uniq: List[List[FrozenSet[int]]] = []
    for regions in constraints:
        key = frozenset(r.tiles for r in regions)
        if key in seen:
            continue
        seen.add(key)
        # drop dominated regions (a superset of another candidate never helps)
        tsets = sorted((r.tiles for r in regions), key=len)
        kept: List[FrozenSet[int]] = []
        for ts in tsets:
            if not any(k <= ts for k in kept):
                kept.append(ts)
        uniq.append(kept)

    forced: Set[int] = set()
    remaining = uniq
    while True:
        progress = False
        nxt: List[List[FrozenSet[int]]] = []
        for regions in remaining:
            resid = [ts - forced for ts in regions]
            if any(len(r) == 0 for r in resid):
                continue  # already satisfied
            if len(resid) == 1:
                forced |= resid[0]
                progress = True
                continue
            nxt.append([frozenset(r) for r in resid])
        remaining = nxt
        if not progress:
            break
    # final sweep: constraints satisfied by late-forced tiles
    remaining = [
        [ts - forced for ts in regions] for regions in remaining
        if not any(len(ts - forced) == 0 for ts in regions)
    ]
    # re-dedup the residual core
    seen2 = set()
    core: List[List[FrozenSet[int]]] = []
    for regions in remaining:
        key = frozenset(frozenset(ts) for ts in regions)
        if key not in seen2:
            seen2.add(key)
            core.append([frozenset(ts) for ts in regions])
    return CoreInstance(forced, core)


# ---------------------------------------------------------------------------
# greedy
# ---------------------------------------------------------------------------

def _greedy_core(core: CoreInstance,
                 seed: Optional[Set[int]] = None) -> Set[int]:
    """Cost-effectiveness greedy on a bitset representation.

    The set-based formulation recomputed constraint satisfaction for every
    (constraint, region) pair per iteration — O(n^3) Python set ops.  Here
    every region is one row of a bool matrix over the core's tile universe;
    per-constraint satisfaction of a candidate collapses to a vectorized
    "any region's residual ⊆ candidate" matrix reduction, and residuals are
    updated incrementally after each pick instead of rebuilt.  Candidate
    enumeration order (constraint order, then region order) matches the old
    code, so tie-breaking — and therefore the chosen mask — is identical.

    ``seed`` warm-starts the solve from an existing mask (the online
    drift adapter re-solves incrementally): seeded tiles count as already
    chosen — constraints with a fully-seeded region are satisfied up
    front, residuals shrink accordingly, and the greedy only pays for
    tiles the seed doesn't already cover.  The returned set contains ONLY
    the newly chosen tiles (callers union with their seed).  ``seed=None``
    (or empty) is byte-identical to the cold solve."""
    ncons = len(core.constraints)
    if ncons == 0:
        return set()
    tiles = sorted({t for regions in core.constraints
                    for ts in regions for t in ts})
    tidx = {t: i for i, t in enumerate(tiles)}
    nt = len(tiles)
    region_cons: List[int] = []            # region row -> owning constraint
    rows: List[np.ndarray] = []
    for ci, regions in enumerate(core.constraints):
        for ts in regions:
            row = np.zeros(nt, bool)
            row[[tidx[t] for t in ts]] = True
            rows.append(row)
            region_cons.append(ci)
    R = np.stack(rows)                     # (nreg, nt) region membership
    rcons = np.asarray(region_cons)

    resid = R.copy()                       # region tiles still uncovered
    chosen = np.zeros(nt, bool)
    unsat = np.ones(ncons, bool)

    if seed:
        seeded = np.zeros(nt, bool)
        hits = [tidx[t] for t in seed if t in tidx]
        if hits:
            seeded[hits] = True
            resid &= ~seeded               # seeded tiles are free
            unsat[rcons[~resid.any(axis=1)]] = False

    while unsat.any():
        best = None                        # (score, region_row_index)
        # candidates: every region of every unsatisfied constraint, in the
        # original (constraint, region) order
        cand = np.nonzero(unsat[rcons])[0]
        resid_counts = resid.sum(axis=1)
        for ri in cand:
            new = resid[ri]
            n_new = int(resid_counts[ri])
            # regions fully covered once `new` joins chosen: residual ⊆ new
            sat_region = ~np.any(resid & ~new, axis=1)
            nsat = int(np.count_nonzero(
                np.bincount(rcons[sat_region], minlength=ncons)
                .astype(bool) & unsat))
            score = (n_new / max(nsat, 1), n_new)
            if best is None or score < best[0]:
                best = (score, ri)
        new = resid[best[1]].copy()
        chosen |= new
        resid &= ~new                      # incremental residual update
        unsat[rcons[~resid.any(axis=1)]] = False
    return {tiles[i] for i in np.nonzero(chosen)[0]}


def solve_greedy(table: AssociationTable) -> SolveResult:
    t0 = time.time()
    core = preprocess(table.constraints)
    chosen = _greedy_core(core)
    mask = frozenset(core.forced | chosen)
    return SolveResult(mask, float(len(core.forced)), "greedy",
                       wall_s=time.time() - t0)


def solve_warm(table: AssociationTable, seed_mask) -> SolveResult:
    """Incremental greedy re-solve seeded from an existing mask.

    The online drift adapter's path: constraints come from a recent
    observation window, ``seed_mask`` is the currently deployed mask.  The
    result always contains the seed (deployed tiles are not retracted
    mid-stream — shrinking is an offline decision) plus the cheapest greedy
    completion for the constraints the seed no longer covers.  Cost scales
    with the residual core, not the full offline instance."""
    t0 = time.time()
    seed = set(seed_mask)
    core = preprocess(table.constraints)
    chosen = _greedy_core(core, seed=seed)
    mask = frozenset(seed | core.forced | chosen)
    return SolveResult(mask, float(len(core.forced)), "greedy-warm",
                       wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# LP relaxation (lower bound)
# ---------------------------------------------------------------------------

def _lp_bound(core: CoreInstance) -> float:
    """LP relaxation of the residual core (forced tiles excluded)."""
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    tiles = sorted({t for regions in core.constraints
                    for ts in regions for t in ts})
    if not tiles or not core.constraints:
        return 0.0
    tidx = {t: i for i, t in enumerate(tiles)}
    regions_flat: List[FrozenSet[int]] = []
    cons_regions: List[List[int]] = []
    for regions in core.constraints:
        row = []
        for ts in regions:
            row.append(len(regions_flat))
            regions_flat.append(ts)
        cons_regions.append(row)

    nt, nr, nc = len(tiles), len(regions_flat), len(core.constraints)
    nvar = nt + nr
    # minimize sum x_t ; y_r <= x_t for t in r ; sum_{r in c} y_r >= 1
    c = np.zeros(nvar)
    c[:nt] = 1.0
    n_ineq = sum(len(r) for r in regions_flat) + nc
    A = lil_matrix((n_ineq, nvar))
    b = np.zeros(n_ineq)
    row = 0
    for ri, ts in enumerate(regions_flat):
        for t in ts:
            A[row, nt + ri] = 1.0      # y_r - x_t <= 0
            A[row, tidx[t]] = -1.0
            row += 1
    for ci, rs in enumerate(cons_regions):
        for ri in rs:
            A[row, nt + ri] = -1.0     # -sum y_r <= -1
        b[row] = -1.0
        row += 1
    res = linprog(c, A_ub=A.tocsr(), b_ub=b, bounds=[(0, 1)] * nvar,
                  method="highs")
    return float(res.fun) if res.success else 0.0


# ---------------------------------------------------------------------------
# exact branch & bound
# ---------------------------------------------------------------------------

def solve_exact(table: AssociationTable, *, node_cap: int = 200_000,
                time_cap_s: float = 60.0) -> SolveResult:
    t0 = time.time()
    core = preprocess(table.constraints)
    incumbent = _greedy_core(core)
    best = set(incumbent)
    lb_root = _lp_bound(core)
    nodes = 0
    capped = False

    def bound(chosen: Set[int], unsat: List[int]) -> float:
        """Cheap LB: chosen + max over constraints of min residual tiles."""
        if not unsat:
            return len(chosen)
        need = max(min(len(ts - chosen) for ts in core.constraints[ci])
                   for ci in unsat)
        return len(chosen) + need

    def dfs(chosen: Set[int], unsat: List[int]):
        nonlocal best, nodes, capped
        if capped:
            return
        nodes += 1
        if nodes > node_cap or time.time() - t0 > time_cap_s:
            capped = True
            return
        if not unsat:
            if len(chosen) < len(best):
                best = set(chosen)
            return
        if bound(chosen, unsat) >= len(best):
            return
        # branch on the constraint with fewest candidate regions, trying
        # cheapest-residual regions first
        ci = min(unsat, key=lambda i: (len(core.constraints[i]),
                                       min(len(ts - chosen)
                                           for ts in core.constraints[i])))
        options = sorted(core.constraints[ci], key=lambda ts: len(ts - chosen))
        for ts in options:
            nchosen = chosen | ts
            nunsat = [cj for cj in unsat if cj != ci and
                      not any(t2 <= nchosen for t2 in core.constraints[cj])]
            if len(nchosen) < len(best):
                dfs(nchosen, nunsat)

    unsat0 = [i for i in range(len(core.constraints))]
    dfs(set(), unsat0)
    mask = frozenset(core.forced | best)
    lb = len(core.forced) + lb_root
    optimal = (not capped) or len(mask) <= np.ceil(lb - 1e-6)
    return SolveResult(mask, float(lb), "exact", nodes=nodes,
                       optimal=optimal, wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# scipy MILP (oracle)
# ---------------------------------------------------------------------------

def solve_milp(table: AssociationTable, *, time_cap_s: float = 120.0
               ) -> SolveResult:
    from scipy.optimize import LinearConstraint, milp
    from scipy.sparse import lil_matrix

    t0 = time.time()
    core = preprocess(table.constraints)
    tiles = sorted({t for regions in core.constraints
                    for ts in regions for t in ts})
    if not tiles:
        return SolveResult(frozenset(core.forced), float(len(core.forced)),
                           "milp", optimal=True, wall_s=time.time() - t0)
    tidx = {t: i for i, t in enumerate(tiles)}
    regions_flat: List[FrozenSet[int]] = []
    cons_regions: List[List[int]] = []
    for regions in core.constraints:
        row = []
        for ts in regions:
            row.append(len(regions_flat))
            regions_flat.append(ts)
        cons_regions.append(row)
    nt, nr = len(tiles), len(regions_flat)
    nvar = nt + nr
    c = np.zeros(nvar)
    c[:nt] = 1.0
    n_rows = sum(len(r) for r in regions_flat) + len(cons_regions)
    A = lil_matrix((n_rows, nvar))
    lo = np.full(n_rows, -np.inf)
    hi = np.zeros(n_rows)
    row = 0
    for ri, ts in enumerate(regions_flat):
        for t in ts:
            A[row, nt + ri] = 1.0
            A[row, tidx[t]] = -1.0
            row += 1
    for ci, rs in enumerate(cons_regions):
        for ri in rs:
            A[row, nt + ri] = 1.0
        lo[row], hi[row] = 1.0, np.inf
        row += 1
    res = milp(c=c,
               constraints=LinearConstraint(A.tocsc(), lo, hi),
               integrality=np.ones(nvar),
               bounds=__import__("scipy.optimize", fromlist=["Bounds"])
               .Bounds(0, 1),
               options={"time_limit": time_cap_s})
    if res.x is None:
        return solve_exact(table)
    chosen = {tiles[i] for i in range(nt) if res.x[i] > 0.5}
    mask = frozenset(core.forced | chosen)
    return SolveResult(mask, len(core.forced) + float(res.fun), "milp",
                       optimal=bool(res.status == 0),
                       wall_s=time.time() - t0)


def solve(table: AssociationTable, method: str = "exact", **kw) -> SolveResult:
    if method == "greedy":
        return solve_greedy(table)
    if method == "exact":
        return solve_exact(table, **kw)
    if method == "milp":
        return solve_milp(table, **kw)
    raise ValueError(method)
