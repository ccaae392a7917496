"""Tile grouping (paper §4.3.2): merge fine-grained RoI tiles into maximal
rectangles to recover video-compression efficacy.

Greedy loop: find the largest inscribed rectangle of the remaining mask
(maximal-rectangle-in-binary-matrix via the histogram/stack DP, O(M) per
iteration), emit it as one group, clear it, repeat — overall O(M^2) worst
case exactly as the paper states.  Runs offline; zero online cost.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class TileGroup:
    """A merged rectangle, in tile units: rows [y0, y0+h), cols [x0, x0+w)."""
    y0: int
    x0: int
    h: int
    w: int

    @property
    def num_tiles(self) -> int:
        return self.h * self.w


def _largest_rectangle(grid: np.ndarray) -> Tuple[int, TileGroup]:
    """Largest all-True axis-aligned rectangle. Returns (area, group)."""
    H, W = grid.shape
    heights = np.zeros(W, np.int64)
    best_area = 0
    best = TileGroup(0, 0, 0, 0)
    for y in range(H):
        heights = np.where(grid[y], heights + 1, 0)
        # classic stack-based largest rectangle in histogram
        stack: List[int] = []
        x = 0
        while x <= W:
            cur = heights[x] if x < W else 0
            if not stack or cur >= heights[stack[-1]]:
                stack.append(x)
                x += 1
            else:
                top = stack.pop()
                left = stack[-1] + 1 if stack else 0
                h = int(heights[top])
                area = h * (x - left)
                if area > best_area:
                    best_area = area
                    best = TileGroup(y - h + 1, left, h, x - left)
        # (x loop consumed the sentinel)
    return best_area, best


def group_tiles(grid: np.ndarray) -> List[TileGroup]:
    """grid: (tiles_y, tiles_x) bool RoI mask -> disjoint covering rectangles."""
    work = grid.copy()
    groups: List[TileGroup] = []
    while work.any():
        area, g = _largest_rectangle(work)
        if area <= 0:   # numerical safety; cannot happen while work.any()
            break
        work[g.y0:g.y0 + g.h, g.x0:g.x0 + g.w] = False
        groups.append(g)
    return groups


def groups_cover(grid: np.ndarray, groups: List[TileGroup]) -> bool:
    """Invariant check: groups exactly tile the mask, disjointly."""
    acc = np.zeros_like(grid, dtype=np.int64)
    for g in groups:
        acc[g.y0:g.y0 + g.h, g.x0:g.x0 + g.w] += 1
    return bool(np.all((acc == 1) == grid) and np.all(acc <= 1))
