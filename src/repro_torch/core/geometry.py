"""Camera geometry for the multi-camera traffic scene.

Cameras are pinhole models looking at a common ground plane; the
ground-to-image mapping is the homography the paper's region associations
implicitly rely on (observation O1: cross-camera region associations are
physical). Bounding boxes come from projecting a 3-D vehicle box and taking
the image-axis-aligned hull, clipped to the frame.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class BBox:
    """<left, top, width, height> in pixels — the paper's ReID record form."""
    left: float
    top: float
    width: float
    height: float

    @property
    def right(self) -> float:
        return self.left + self.width

    @property
    def bottom(self) -> float:
        return self.top + self.height

    @property
    def area(self) -> float:
        return max(self.width, 0.0) * max(self.height, 0.0)

    def as_vec(self) -> np.ndarray:
        return np.array([self.left, self.top, self.width, self.height],
                        np.float64)

    def iou(self, o: "BBox") -> float:
        ix = max(0.0, min(self.right, o.right) - max(self.left, o.left))
        iy = max(0.0, min(self.bottom, o.bottom) - max(self.top, o.top))
        inter = ix * iy
        union = self.area + o.area - inter
        return inter / union if union > 0 else 0.0


@dataclass(frozen=True)
class Camera:
    cam_id: int
    width: int
    height: int
    # 3x4 projection matrix (pinhole): x_img ~ P @ [X Y Z 1]
    P: np.ndarray
    tile: int = 64  # basic tile size (paper: 64x64)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    def project(self, pts: np.ndarray) -> np.ndarray:
        """pts: (N,3) world -> (N,2) pixels (may be outside the frame)."""
        homog = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        img = homog @ self.P.T
        return img[:, :2] / np.maximum(img[:, 2:3], 1e-9)

    def in_front(self, pts: np.ndarray) -> np.ndarray:
        homog = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        return (homog @ self.P.T)[:, 2] > 0.1

    def project_box(self, center_xy: np.ndarray, length: float, width: float,
                    height: float, heading: float) -> Optional[BBox]:
        """Project a 3-D vehicle box; None if not visible."""
        c, s = np.cos(heading), np.sin(heading)
        dx, dy = length / 2, width / 2
        corners = []
        for ex in (-dx, dx):
            for ey in (-dy, dy):
                wx = center_xy[0] + ex * c - ey * s
                wy = center_xy[1] + ex * s + ey * c
                for z in (0.0, height):
                    corners.append([wx, wy, z])
        corners = np.asarray(corners)
        if not self.in_front(corners).all():
            return None
        uv = self.project(corners)
        left = float(np.min(uv[:, 0]))
        right = float(np.max(uv[:, 0]))
        top = float(np.min(uv[:, 1]))
        bottom = float(np.max(uv[:, 1]))
        # clip to frame
        l = max(left, 0.0)
        t = max(top, 0.0)
        r = min(right, float(self.width))
        b = min(bottom, float(self.height))
        if r - l < 4 or b - t < 4:
            return None
        # visibility: enough of the box inside the frame
        full = (right - left) * (bottom - top)
        if full <= 0 or (r - l) * (b - t) / full < 0.33:
            return None
        return BBox(l, t, r - l, b - t)

    # --- tiles -------------------------------------------------------------
    def bbox_tiles(self, b: BBox) -> frozenset:
        """Least set of tile indices covering the (in-frame part of the)
        bbox (paper §3.2).  Clamped to the frame: a bbox hanging past the
        left/top edge must not wrap to the previous row's tiles."""
        x0 = max(int(b.left) // self.tile, 0)
        x1 = int(np.ceil(b.right / self.tile) - 1)
        y0 = max(int(b.top) // self.tile, 0)
        y1 = int(np.ceil(b.bottom / self.tile) - 1)
        x1 = min(x1, self.tiles_x - 1)
        y1 = min(y1, self.tiles_y - 1)
        return frozenset(
            y * self.tiles_x + x
            for y in range(y0, y1 + 1) for x in range(x0, x1 + 1))

    def tile_pixel_box(self, idx: int) -> Tuple[int, int, int, int]:
        y, x = divmod(idx, self.tiles_x)
        return (x * self.tile, y * self.tile,
                min(self.tile, self.width - x * self.tile),
                min(self.tile, self.height - y * self.tile))


def look_at_camera(cam_id: int, eye: np.ndarray, target: np.ndarray,
                   focal_px: float, width: int = 1920, height: int = 1080,
                   tile: int = 64) -> Camera:
    """Build a pinhole camera from eye/target positions (z-up world)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)  # image y grows downward
    R = np.stack([right, down, fwd])  # world->cam rotation
    t = -R @ eye
    K = np.array([[focal_px, 0, width / 2],
                  [0, focal_px, height / 2],
                  [0, 0, 1.0]])
    P = K @ np.concatenate([R, t[:, None]], axis=1)
    return Camera(cam_id, width, height, P, tile)
