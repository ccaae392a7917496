"""Synthetic multi-camera traffic-intersection scene.

Reproduces the structure of the paper's evaluation scene (AI City Challenge
S02: 5 cameras around one intersection with complicated viewpoint overlap):
vehicles travel through a 4-way intersection on straight/turning trajectories;
5 cameras with overlapping fields of view observe them. Ground truth is
geometric, so ReID labels are exact and the noise model (core/reid.py) can be
calibrated against the paper's Table 2 error distributions.

Scale mirrors the paper: 10 fps, ~180 s, >30k bounding boxes across cameras.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.geometry import BBox, Camera, look_at_camera


@dataclass(frozen=True)
class Detection:
    cam: int
    t: int            # frame index
    obj: int          # ground-truth vehicle id
    bbox: BBox


@dataclass
class SceneConfig:
    num_cameras: int = 5
    fps: int = 10
    duration_s: int = 180
    spawn_rate: float = 0.55       # vehicles per second
    seed: int = 0
    road_halfwidth: float = 7.0    # two lanes each way
    approach_len: float = 80.0
    speed_range: Tuple[float, float] = (6.0, 14.0)  # m/s
    vehicle_length: float = 4.6
    vehicle_width: float = 1.9
    vehicle_height: float = 1.6
    # --- traffic profile (fleet scenario diversity; see fleet/topology) ---
    # "uniform" keeps the original constant-rate spawn process (and, with
    # the remaining fields at their defaults, the exact legacy RNG stream,
    # so seeded scenes are bit-identical to earlier revisions).
    spawn_profile: str = "uniform"       # uniform | rush_hour | sparse | bursty
    entry_weights: Optional[Tuple[float, ...]] = None  # over N, S, E, W
    turn_probs: Tuple[float, float, float] = (0.6, 0.2, 0.2)
    # --- scripted traffic shift (mask-drift evaluation, paper §5.5) ------
    # From ``shift_at_s`` on, new vehicles spawn with the shifted entry /
    # turn distributions — e.g. profiling on N/S traffic and shifting to
    # E/W traffic moves the occupied corridors, which is exactly the drift
    # the online adapter has to chase.
    shift_at_s: Optional[float] = None
    shift_entry_weights: Optional[Tuple[float, ...]] = None
    shift_turn_probs: Optional[Tuple[float, float, float]] = None

    @property
    def num_frames(self) -> int:
        return self.fps * self.duration_s


def default_cameras(tile: int = 64) -> List[Camera]:
    """5 cameras around the intersection; camera 5 is 1280x960 (as in the
    dataset used by the paper).

    Layout matches real corner-pole deployments (AI City S02 structure):
    each leg camera sits near the intersection core looking *outward* along
    its own street, and a wide center camera overlooks the core box.  Legs
    therefore overlap the center camera (and each other only marginally),
    which reproduces the paper's Table-2 label structure (TN >> FN >= TP >
    FP per ordered pair) instead of an everything-overlaps fleet."""
    specs = [
        # (eye, target, focal, w, h) — leg cameras sit on poles behind the
        # core box looking up their street (coverage: core stub + 0..80 m of
        # the street); the center mast overlooks the core + 20-32 m street
        # stubs, so every leg camera shares its near segment with the center
        # view and the legs share the core with each other.
        ((7.0, -20.0, 10.0), (1.0, 45.0, 0.0), 1600.0, 1920, 1080),   # N leg
        ((-20.0, -7.0, 10.5), (45.0, 1.0, 0.0), 1600.0, 1920, 1080),  # E leg
        ((-7.0, 20.0, 9.5), (-1.0, -45.0, 0.0), 1600.0, 1920, 1080),  # S leg
        ((20.0, 7.0, 11.0), (-45.0, -1.0, 0.0), 1600.0, 1920, 1080),  # W leg
        ((10.0, 10.0, 30.0), (0.0, 0.0, 0.0), 1000.0, 1280, 960),     # center
    ]
    return [look_at_camera(i, np.array(e), np.array(t), f, w, h, tile)
            for i, (e, t, f, w, h) in enumerate(specs)]


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

_DIRS = {  # approach heading unit vectors: N/S/E/W entries into intersection
    "N": np.array([0.0, -1.0]),
    "S": np.array([0.0, 1.0]),
    "E": np.array([-1.0, 0.0]),
    "W": np.array([1.0, 0.0]),
}
_TURNS = {  # (entry, exit) pairs: straight, left, right
    "N": ["S", "E", "W"],
    "S": ["N", "W", "E"],
    "E": ["W", "N", "S"],
    "W": ["E", "S", "N"],
}


@dataclass
class Vehicle:
    vid: int
    t0: float
    speed: float
    entry: str
    exit: str
    lane_offset: float

    def position(self, t: float, cfg: SceneConfig):
        """Returns (xy (2,), heading) or None if outside the scene."""
        s = (t - self.t0) * self.speed
        if s < 0:
            return None
        a = cfg.approach_len
        d_in = _DIRS[self.entry]
        d_out = -_DIRS[self.exit]
        entry_pt = -d_in * a  # spawn point
        # lane offset: right-hand side of travel direction
        perp_in = np.array([-d_in[1], d_in[0]])
        perp_out = np.array([-d_out[1], d_out[0]])
        turn_r = 9.0  # intersection maneuver radius
        leg1 = a - turn_r
        if s <= leg1:  # approach
            xy = entry_pt + d_in * s + perp_in * self.lane_offset
            return xy, float(np.arctan2(d_in[1], d_in[0]))
        # inside intersection: blend headings along an arc (quadratic bezier)
        arc_len = turn_r * (np.pi / 2 if self.entry != _opposite(self.exit)
                            else 2.0)
        s2 = s - leg1
        if s2 <= arc_len:
            u = s2 / arc_len
            p0 = entry_pt + d_in * leg1 + perp_in * self.lane_offset
            p2 = d_out * turn_r + perp_out * self.lane_offset
            # corner control point: intersection of approach & exit lines
            p1 = np.where(np.abs(d_in) > 0.5, p2, p0)
            xy = (1 - u) ** 2 * p0 + 2 * u * (1 - u) * p1 + u ** 2 * p2
            d = 2 * (1 - u) * (p1 - p0) + 2 * u * (p2 - p1)
            n = np.linalg.norm(d)
            if n < 1e-6:
                d = d_out
                n = 1.0
            return xy, float(np.arctan2(d[1] / n, d[0] / n))
        # exit leg
        s3 = s2 - arc_len
        start = d_out * turn_r + perp_out * self.lane_offset
        xy = start + d_out * s3
        if np.max(np.abs(xy)) > a + 5:
            return None
        return xy, float(np.arctan2(d_out[1], d_out[0]))


def _opposite(d: str) -> str:
    return {"N": "S", "S": "N", "E": "W", "W": "E"}[d]


# ---------------------------------------------------------------------------
# spawn-intensity profiles (per-group scenario diversity for fleet scenes)
# ---------------------------------------------------------------------------
# name -> (peak multiplier, intensity(t, duration) in [0, peak]); spawning
# uses Poisson thinning at the peak rate, so any bounded profile is exact.

SPAWN_PROFILES = {
    "uniform": (1.0, lambda t, T: 1.0),
    # commute ramp: quiet shoulders, ~1.6x the base rate at mid-window
    "rush_hour": (1.6, lambda t, T: 0.4 + 1.2 * float(
        np.sin(np.pi * min(max(t / max(T, 1e-9), 0.0), 1.0)))),
    # light overnight traffic
    "sparse": (0.35, lambda t, T: 0.35),
    # platoons: 15 s bursts every 45 s, near-empty gaps between
    "bursty": (1.8, lambda t, T: 1.8 if (t % 45.0) < 15.0 else 0.2),
}


@dataclass
class Scene:
    cfg: SceneConfig
    cameras: List[Camera]
    vehicles: List[Vehicle]
    # detections[t] = list[Detection]; gt_tracks[(cam, obj)] = frames present
    detections: List[List[Detection]] = field(default_factory=list)

    def detections_at(self, t: int) -> List[Detection]:
        return self.detections[t]

    def all_detections(self):
        for frame in self.detections:
            yield from frame


def generate_scene(cfg: Optional[SceneConfig] = None,
                   cameras: Optional[List[Camera]] = None) -> Scene:
    cfg = cfg or SceneConfig()
    cameras = cameras or default_cameras()
    rng = np.random.default_rng(cfg.seed)

    vehicles: List[Vehicle] = []
    vid = 0
    t = 0.0
    legacy = (cfg.spawn_profile == "uniform" and cfg.entry_weights is None
              and cfg.turn_probs == (0.6, 0.2, 0.2)
              and cfg.shift_at_s is None)
    if legacy:
        # original constant-rate process, draw-for-draw (seed stability)
        while t < cfg.duration_s:
            gap = rng.exponential(1.0 / cfg.spawn_rate)
            t += gap
            entry = rng.choice(list(_DIRS))
            exit_ = rng.choice(_TURNS[entry], p=[0.6, 0.2, 0.2])
            vehicles.append(Vehicle(
                vid=vid,
                t0=t,
                speed=float(rng.uniform(*cfg.speed_range)),
                entry=entry,
                exit=exit_,
                lane_offset=float(rng.uniform(2.0,
                                              cfg.road_halfwidth - 1.5)),
            ))
            vid += 1
    else:
        peak, intensity = SPAWN_PROFILES[cfg.spawn_profile]
        dirs = list(_DIRS)
        while t < cfg.duration_s:
            gap = rng.exponential(1.0 / (cfg.spawn_rate * peak))
            t += gap
            # Poisson thinning: accept at the local intensity
            if rng.random() >= intensity(t, cfg.duration_s) / peak:
                continue
            shifted = cfg.shift_at_s is not None and t >= cfg.shift_at_s
            ew = (cfg.shift_entry_weights if shifted
                  and cfg.shift_entry_weights is not None
                  else cfg.entry_weights)
            tp = (cfg.shift_turn_probs if shifted
                  and cfg.shift_turn_probs is not None else cfg.turn_probs)
            entry = rng.choice(dirs, p=ew)
            exit_ = rng.choice(_TURNS[entry], p=list(tp))
            vehicles.append(Vehicle(
                vid=vid,
                t0=t,
                speed=float(rng.uniform(*cfg.speed_range)),
                entry=entry,
                exit=exit_,
                lane_offset=float(rng.uniform(2.0,
                                              cfg.road_halfwidth - 1.5)),
            ))
            vid += 1

    detections: List[List[Detection]] = []
    for fi in range(cfg.num_frames):
        tt = fi / cfg.fps
        frame: List[Detection] = []
        for v in vehicles:
            if tt < v.t0 - 1 or tt > v.t0 + 60:
                continue
            pos = v.position(tt, cfg)
            if pos is None:
                continue
            xy, heading = pos
            for cam in cameras:
                bb = cam.project_box(xy, cfg.vehicle_length,
                                     cfg.vehicle_width, cfg.vehicle_height,
                                     heading)
                if bb is not None and bb.area >= 24 * 24:
                    frame.append(Detection(cam.cam_id, fi, v.vid, bb))
        detections.append(frame)
    return Scene(cfg, cameras, vehicles, detections)
