"""Cross-camera region-association lookup table (paper §3.2, Table 1).

From (filtered) ReID records we build, per timestamp and per object id, the
*appearance regions*: for each camera where the object appears, the least
set of tiles covering its bbox.  The RoI optimization (core/setcover.py)
then requires at least one appearance region per (t, id) to be fully inside
the union mask.

Tiles are referred to by *global* ids: ``offset[cam] + local_tile_index`` so
one flat universe spans the whole camera fleet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

from repro_torch.core.geometry import Camera
from repro_torch.core.reid import ReIDRecord


@dataclass(frozen=True)
class Region:
    """One appearance region: a camera plus the covering tile set."""
    cam: int
    tiles: FrozenSet[int]        # *global* tile ids

    def __len__(self) -> int:
        return len(self.tiles)


@dataclass
class TileUniverse:
    cameras: Sequence[Camera]
    offsets: np.ndarray          # (N+1,) prefix offsets into the global space

    @classmethod
    def build(cls, cameras: Sequence[Camera]) -> "TileUniverse":
        offs = np.zeros(len(cameras) + 1, np.int64)
        for i, c in enumerate(cameras):
            offs[i + 1] = offs[i] + c.num_tiles
        return cls(cameras, offs)

    @property
    def num_tiles(self) -> int:
        return int(self.offsets[-1])

    def globalize(self, cam: int, local_tiles: FrozenSet[int]) -> FrozenSet[int]:
        off = int(self.offsets[cam])
        return frozenset(off + t for t in local_tiles)

    def localize(self, gids) -> Dict[int, List[int]]:
        """Split global tile ids back into {cam: [local ids]}."""
        out: Dict[int, List[int]] = {c.cam_id: [] for c in self.cameras}
        for g in gids:
            cam = int(np.searchsorted(self.offsets, g, side="right") - 1)
            out[cam].append(int(g - self.offsets[cam]))
        return out

    def cam_mask_grid(self, cam: int, gids) -> np.ndarray:
        """Binary (tiles_y, tiles_x) grid of a camera's mask tiles."""
        c = self.cameras[cam]
        grid = np.zeros((c.tiles_y, c.tiles_x), bool)
        for t in self.localize(gids)[cam]:
            grid[t // c.tiles_x, t % c.tiles_x] = True
        return grid


@dataclass
class AssociationTable:
    """constraints[i] = candidate appearance regions of one (t, id) pair."""
    universe: TileUniverse
    constraints: List[List[Region]]
    keys: List[Tuple[int, int]]  # (t, rid) per constraint — for debugging


def build_association_table(records: Sequence[ReIDRecord],
                            universe: TileUniverse) -> AssociationTable:
    per_tid: Dict[Tuple[int, int], Dict[int, set]] = {}
    for r in records:
        cam = universe.cameras[r.cam]
        tiles = cam.bbox_tiles(r.bbox)
        if not tiles:
            continue
        slot = per_tid.setdefault((r.t, r.rid), {})
        # same object twice in one camera frame cannot happen in our schema,
        # but unioning is the safe merge if a detector double-fires
        slot[r.cam] = slot.get(r.cam, set()) | set(tiles)

    constraints: List[List[Region]] = []
    keys: List[Tuple[int, int]] = []
    for key, cams in per_tid.items():
        regions = [Region(c, universe.globalize(c, frozenset(ts)))
                   for c, ts in sorted(cams.items())]
        constraints.append(regions)
        keys.append(key)
    return AssociationTable(universe, constraints, keys)
