"""Multi-camera stream pipeline: scene sim -> patch-token segments -- the
port's copy of ``repro.data.streams`` (host numpy).

Bridges the CrossRoI core to the transformer serving stack: per segment and
camera it emits (a) the RoI keep-mask at patch granularity derived from the
offline set-cover masks, and (b) synthetic patch embeddings (the modality
frontend is a stub per the assignment: ``input_specs()``-style precomputed
embeddings).  The serving engine packs kept patches with
kernels/ops.pack_tokens and prefillss the packed stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np

from repro_torch.core.pipeline import OfflineResult
from repro_torch.core.scene import Scene


@dataclass
class StreamSegment:
    t0: int
    t1: int
    # per camera: (n_frames, n_patches) bool keep + (n_frames, n_patches, D)
    keep: Dict[int, np.ndarray]
    patches: Dict[int, np.ndarray]

    @property
    def keep_fraction(self) -> float:
        tot = sum(int(k.size) for k in self.keep.values())
        kept = sum(int(k.sum()) for k in self.keep.values())
        return kept / max(tot, 1)


@dataclass
class CameraStreamPipeline:
    scene: Scene
    offline: OfflineResult
    patch_dim: int = 64
    frames_per_segment: int = 10
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        # patch grid == tile grid (one token per RoI tile)
        self._grids = {c.cam_id: self.offline.cam_grids[c.cam_id]
                       for c in self.scene.cameras}

    def num_patches(self, cam: int) -> int:
        return int(self._grids[cam].size)

    def segments(self, t0: int, t1: int) -> Iterator[StreamSegment]:
        step = self.frames_per_segment
        for s in range(t0, t1, step):
            e = min(s + step, t1)
            keep, patches = {}, {}
            for c in self.scene.cameras:
                cid = c.cam_id
                grid = self._grids[cid].reshape(-1)
                n = grid.size
                k = np.broadcast_to(grid, (e - s, n)).copy()
                # embeddings: deterministic per (cam, frame, patch)
                rng = np.random.default_rng(
                    (self.seed, cid, s) if self.seed else (cid, s))
                patches[cid] = rng.standard_normal(
                    (e - s, n, self.patch_dim)).astype(np.float32)
                keep[cid] = k
            yield StreamSegment(s, e, keep, patches)

    def fleet_tokens(self, seg: StreamSegment, frame: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenate all cameras' patch tokens for one frame of a segment.
        Returns (tokens (N, D), keep (N,)) in camera order."""
        toks = np.concatenate([seg.patches[c.cam_id][frame]
                               for c in self.scene.cameras], axis=0)
        keep = np.concatenate([seg.keep[c.cam_id][frame]
                               for c in self.scene.cameras], axis=0)
        return toks, keep
