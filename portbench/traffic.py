"""Camera traffic for the fleet cells, made on the device from the seed.

One general generator reads a mix's parameters (``portbench/traffic/
<name>.json``) and the configuration's frozen vehicle tracks
(``portbench/configs/<name>.tracks.json``: each camera's vehicle boxes a
frame, from the same scenes the offline masks were solved on, after the
profile), and writes each step's frames in place, as a server's hardware
decoder would hand them over:

* each camera has a static background of 8-bit pixel values, drawn from
  the seed;
* a keyframe re-draws the camera's whole frame: the background plus fresh
  small integer noise (re-quantisation changes every pixel).  Camera
  ``c`` keyframes at the steps ``t`` with ``(t + c) % gop == 0``, so
  keyframes are staggered across the fleet; between keyframes the static
  pixels decode bit-identical;
* step ``t`` shows the tracks' frame ``t + start_frame`` (modulo their
  length): each vehicle's box is painted with the top-left corner of a
  texture drawn from the seed, in the order of the vehicles' numbers, so a later one
  covers an earlier one.  A step restores the previous step's boxes from
  the static frame and paints the new ones.  The boxes are the
  configuration's data: every run seed gets the same work, and draws its
  own pixels (backgrounds, keyframe noise, texture).

Every frame is a pure function of (seed, camera, step): ``frame_at``
rebuilds any step's frame for the reference, and ``changes`` lists what a
step changed, for the benchmark's count of the tiles the inputs need.
"""
from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1
# domain tags of the seeded streams
_BACKGROUND, _NOISE, _TEXTURE = 1, 2, 3
FIELDS = 5   # a box: (vehicle, y0, x0, h, w)


def mix(*keys) -> np.ndarray:
    """A 64-bit hash of integer keys (scalars or arrays, broadcast):
    splitmix64 over the keys in turn.  Any Python int is taken mod 2**64."""
    h = np.full((), 0x9E3779B97F4A7C15, np.uint64)
    with np.errstate(over="ignore"):
        for k in keys:
            if isinstance(k, int):
                k = np.uint64(k & MASK64)
            else:
                k = np.asarray(k).astype(np.int64).view(np.uint64)
            x = (h ^ k) + np.uint64(0x9E3779B97F4A7C15)
            x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            h = x ^ (x >> np.uint64(31))
    return h


def seed_of(*keys) -> int:
    """``mix`` of scalar keys as a Python int, for a ``torch.Generator``."""
    return int(mix(*keys))


def tracks_boxes(tracks: dict):
    """Each camera's boxes of a tracks file, in its cameras' order: a list
    over frames of (n, 5) int64 arrays (vehicle, y0, x0, h, w)."""
    out = []
    for cam in tracks["cameras"]:
        out.append([np.asarray(f, np.int64).reshape(-1, FIELDS)
                    for f in cam["boxes"]])
    return out


class CameraTraffic:
    """The frames of a fleet of cameras, advanced a step at a time.

    ``camera_hw``: (H, W) per flat camera; ``boxes``: per flat camera, a
    list over the replayed frames of its (n, 5) boxes (``tracks_boxes``).
    Cameras of one size share one (n, H, W, 3) float32 tensor;
    ``frames[c]`` is camera ``c``'s view, updated in place by
    ``advance``."""

    def __init__(self, params: dict, camera_hw, boxes, seed: int, device):
        self.gop = int(params["gop"])
        self.bg_lo, self.bg_hi = (int(v) for v in params["background"])
        self.noise = int(params["keyframe_noise"])
        self.start = int(params["start_frame"])
        self.seed = seed & MASK64
        self.device = torch.device(device)
        self.hw = [tuple(int(v) for v in hw) for hw in camera_hw]
        self.n_cams = len(self.hw)
        if len(boxes) != self.n_cams:
            raise ValueError("the tracks' cameras are not the fleet's")
        lengths = {len(b) for b in boxes}
        if len(lengths) != 1 or 0 in lengths:
            raise ValueError("every camera's tracks need the same frames")
        self.n_frames = lengths.pop()
        self.boxes = [[np.asarray(f, np.int64).reshape(-1, FIELDS)
                       for f in frames] for frames in boxes]
        for c, (frames, (h, w)) in enumerate(zip(self.boxes, self.hw)):
            for f in frames:
                if ((f[:, 1] < 0) | (f[:, 2] < 0) | (f[:, 3] < 1)
                        | (f[:, 4] < 1) | (f[:, 1] + f[:, 3] > h)
                        | (f[:, 2] + f[:, 4] > w)).any():
                    raise ValueError(f"camera {c} has a box out of frame")
        # cameras of one size share a tensor: slot[c] = (class, index)
        shapes = sorted(set(self.hw), key=self.hw.index)
        self.slot = [(shapes.index(hw), sum(1 for d in self.hw[:c]
                                            if d == hw))
                     for c, hw in enumerate(self.hw)]
        self.live = [torch.zeros((self.hw.count(s),) + s + (3,),
                                 dtype=torch.float32, device=self.device)
                     for s in shapes]
        self.static = [torch.zeros_like(t) for t in self.live]
        # each camera's background, drawn once from the seed
        self.background = [torch.empty(t.shape, dtype=torch.uint8,
                                       device=self.device)
                           for t in self.live]
        self.frames = [self.live[k][j] for k, j in self.slot]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed_of(self.seed, _TEXTURE))
        self.texture = torch.randint(
            0, 256, (max(h for h, _ in self.hw), max(w for _, w in self.hw),
                     3), generator=gen,
            device=self.device).to(torch.float32)
        self._gen = torch.Generator(device=self.device)
        for c, (k, j) in enumerate(self.slot):
            self._gen.manual_seed(seed_of(self.seed, _BACKGROUND, c))
            self.background[k][j].random_(self.bg_lo, self.bg_hi + 1,
                                          generator=self._gen)
        self.t = None

    # -- what a step holds ---------------------------------------------------
    def keyframes(self, t: int) -> np.ndarray:
        """(C,) bool: the cameras that keyframe at step ``t`` (all at 0)."""
        if t == 0:
            return np.ones(self.n_cams, bool)
        return (t + np.arange(self.n_cams)) % self.gop == 0

    def boxes_at(self, c: int, t: int) -> np.ndarray:
        """(n, 5) camera ``c``'s boxes at step ``t``: (vehicle, y0, x0, h,
        w), by vehicle."""
        return self.boxes[c][(t + self.start) % self.n_frames]

    def changes(self, t: int):
        """What step ``t`` changed against step ``t - 1``: (keyframe (C,)
        bool, rects: per camera a list of (y0, x0, h, w) -- the old and the
        new boxes of each vehicle that moved, came or went)."""
        kf = self.keyframes(t)
        rects = [[] for _ in range(self.n_cams)]
        if t == 0:
            return kf, rects
        for c in range(self.n_cams):
            old = {int(r[0]): tuple(int(v) for v in r[1:])
                   for r in self.boxes_at(c, t - 1)}
            new = {int(r[0]): tuple(int(v) for v in r[1:])
                   for r in self.boxes_at(c, t)}
            for v in sorted(set(old) | set(new)):
                if old.get(v) == new.get(v):
                    continue
                rects[c] += [b for b in (old.get(v), new.get(v)) if b]
        return kf, rects

    # -- making frames -------------------------------------------------------
    def _fill_static(self, out: torch.Tensor, bg: torch.Tensor, c: int,
                     t: int) -> None:
        """The static frame of camera ``c`` as of its last keyframe at or
        before step ``t``: its background ``bg`` plus that keyframe's
        noise."""
        key = t - (t + c) % self.gop
        self._gen.manual_seed(seed_of(self.seed, _NOISE, c, key))
        out.random_(-self.noise, self.noise + 1, generator=self._gen)
        out.add_(bg).clamp_(0, 255)

    def _paint(self, img: torch.Tensor, c: int, t: int) -> None:
        """Draw camera ``c``'s boxes of step ``t`` onto ``img`` (H, W, 3)."""
        for _, y, x, h, w in self.boxes_at(c, t).tolist():
            img[y:y + h, x:x + w].copy_(self.texture[:h, :w])

    def advance(self, t: int) -> None:
        """Make ``frames`` hold step ``t``: ``t`` is 0 or the step after the
        last one."""
        if t != 0 and t != (self.t or 0) + 1:
            raise ValueError(f"step {t} after step {self.t}")
        kf = self.keyframes(t)
        for c in range(self.n_cams):
            k, j = self.slot[c]
            live, static = self.live[k][j], self.static[k][j]
            if kf[c]:
                self._fill_static(static, self.background[k][j], c, t)
                live.copy_(static)
            else:
                for _, y, x, h, w in self.boxes_at(c, t - 1).tolist():
                    live[y:y + h, x:x + w].copy_(static[y:y + h, x:x + w])
            self._paint(live, c, t)
        self.t = t

    def frame_at(self, c: int, t: int) -> torch.Tensor:
        """Camera ``c``'s frame at step ``t``, made anew: equal bit for bit
        to what ``advance(t)`` left in ``frames[c]``."""
        k, j = self.slot[c]
        out = torch.empty(self.hw[c] + (3,), dtype=torch.float32,
                          device=self.device)
        self._fill_static(out, self.background[k][j], c, t)
        self._paint(out, c, t)
        return out
