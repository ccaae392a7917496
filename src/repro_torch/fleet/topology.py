"""Multi-intersection fleet topology (city-scale scene composition).

The paper evaluates one intersection (5 cameras); its pitch is city scale.
This module composes the single-intersection scene (`core/scene.py`) into a
fleet of K intersections laid out on a coarse world grid, each with its own
traffic profile (rush-hour, sparse, bursty — `scene.SPAWN_PROFILES`), seed,
and optional scripted traffic shift.

Two properties the rest of the fleet stack relies on, both by construction:

* **Per-group isolation** — each group's scene is generated in its own
  local frame with the standard camera rig; placing the group at a world
  offset translates cameras and vehicles together, and pinhole projection
  is invariant under that joint translation.  A group's detections are
  therefore *bit-identical* to running the single-intersection scene in
  isolation, so per-group offline results match the standalone pipeline
  exactly (tested in tests/test_fleet.py).
* **Zero cross-group correlation** — with the default spacing (600 m),
  another intersection's vehicles project far below the detector's minimum
  box area in any camera, so no cross-group appearance can enter the
  association table.  `cross_group_leakage` measures this directly by
  projecting every group's vehicles into every *other* group's cameras.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scene import (Scene, SceneConfig, SPAWN_PROFILES,
                                    default_cameras, generate_scene)

TRAFFIC_PROFILES = tuple(SPAWN_PROFILES)


@dataclass
class GroupSpec:
    """One intersection: a traffic profile plus scene-config overrides."""
    profile: str = "uniform"
    seed: int = 0
    overrides: Dict = field(default_factory=dict)   # extra SceneConfig kwargs


@dataclass
class FleetConfig:
    groups: List[GroupSpec]
    duration_s: int = 90
    spacing_m: float = 600.0        # world grid pitch between intersections
    tile: int = 64

    @property
    def num_groups(self) -> int:
        return len(self.groups)


@dataclass
class FleetGroup:
    gid: int
    spec: GroupSpec
    scene: Scene                    # generated in the group's LOCAL frame
    offset_xy: np.ndarray           # world offset of the intersection

    @property
    def num_cameras(self) -> int:
        return len(self.scene.cameras)


@dataclass
class FleetScene:
    cfg: FleetConfig
    groups: List[FleetGroup]

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def cams_per_group(self) -> int:
        return self.groups[0].num_cameras if self.groups else 0

    @property
    def num_cameras(self) -> int:
        return sum(g.num_cameras for g in self.groups)

    def global_cam(self, gid: int, local_cam: int) -> int:
        """Flat fleet-wide camera row index (groups are contiguous)."""
        return sum(g.num_cameras for g in self.groups[:gid]) + local_cam

    def all_cameras(self):
        """Flat camera list aligned with ``global_cam`` indices."""
        return [c for g in self.groups for c in g.scene.cameras]


def _grid_offsets(k: int, spacing: float) -> np.ndarray:
    side = int(np.ceil(np.sqrt(max(k, 1))))
    offs = [(spacing * (i % side), spacing * (i // side)) for i in range(k)]
    return np.asarray(offs, np.float64)


def build_fleet(cfg: FleetConfig) -> FleetScene:
    offs = _grid_offsets(cfg.num_groups, cfg.spacing_m)
    groups = []
    for gid, spec in enumerate(cfg.groups):
        if spec.profile not in SPAWN_PROFILES:
            raise ValueError(f"unknown traffic profile {spec.profile!r}; "
                             f"one of {TRAFFIC_PROFILES}")
        kwargs = {"duration_s": cfg.duration_s, "seed": spec.seed,
                  "spawn_profile": spec.profile, **spec.overrides}
        scfg = SceneConfig(**kwargs)    # overrides win on conflicts
        scene = generate_scene(scfg, default_cameras(cfg.tile))
        groups.append(FleetGroup(gid, spec, scene, offs[gid]))
    return FleetScene(cfg, groups)


def cross_group_leakage(fleet: FleetScene, frame_step: int = 25) -> int:
    """Count cross-group appearances: boxes another group's vehicle would
    project into this group's cameras, over a strided frame sample.

    A vehicle of group g at local position ``xy`` sits at ``xy + off_g`` in
    the world, i.e. at ``xy + off_g - off_h`` in group h's local frame —
    so the check needs no world-frame camera rebuild.  Must be 0 at sane
    spacing: distant vehicles fall below the detector's minimum box area
    (the same cull the scene generator applies to its own vehicles)."""
    leaks = 0
    for g in fleet.groups:
        scfg = g.scene.cfg
        for t in range(0, scfg.num_frames, frame_step):
            tt = t / scfg.fps
            for v in g.scene.vehicles:
                pos = v.position(tt, scfg)
                if pos is None:
                    continue
                xy, heading = pos
                for h in fleet.groups:
                    if h.gid == g.gid:
                        continue
                    rel = xy + g.offset_xy - h.offset_xy
                    for cam in h.scene.cameras:
                        bb = cam.project_box(rel, scfg.vehicle_length,
                                             scfg.vehicle_width,
                                             scfg.vehicle_height, heading)
                        if bb is not None and bb.area >= 24 * 24:
                            leaks += 1
    return leaks
