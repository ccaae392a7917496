"""Fault tolerance: elastic re-meshing, straggler detection, fault
injection; the port's copy of ``repro.distributed.fault``.

The recovery path is launcher-level: detect -> restore the latest
checkpoint onto the surviving ranks (``ElasticMesh`` picks the new
shape) -> replay the data stream deterministically from the restored
step counter.  ``train.loop.train`` wires these pieces together.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class ElasticMesh:
    """Builds the largest usable mesh from an available rank count.

    Keeps the model axis fixed (the tensor-parallel degree is a property
    of the model fit) and shrinks or grows the data axis; at multi-pod
    scale the pod axis drops to 1 before the data axis shrinks.
    """
    model_parallel: int
    prefer_pods: int = 1

    def shape_for(self, n_devices: int) -> Tuple[Tuple[int, ...],
                                                 Tuple[str, ...]]:
        tp = self.model_parallel
        if n_devices < tp:
            raise RuntimeError(
                f"{n_devices} devices cannot fit model axis {tp}")
        rest = n_devices // tp
        if self.prefer_pods > 1 and rest % self.prefer_pods == 0 \
                and rest >= 2 * self.prefer_pods:
            return ((self.prefer_pods, rest // self.prefer_pods, tp),
                    ("pod", "data", "model"))
        return ((rest, tp), ("data", "model"))

    def build(self, device=None):
        """The training mesh over every rank of the initialized process
        group (``launch.mesh.make_train_mesh``)."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_train_mesh
        shape, axes = self.shape_for(dist.get_world_size())
        return make_train_mesh(shape, axes, device)


@dataclass
class StragglerMonitor:
    """Per-step wall-time tracker with a robust deadline.

    deadline = median * tolerance over a sliding window; a step exceeding
    it is a straggler event, recorded and surfaced.
    """
    window: int = 50
    tolerance: float = 3.0
    min_samples: int = 5
    times: List[float] = field(default_factory=list)
    events: List[Tuple[int, float, float]] = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        is_straggler = False
        if len(self.times) >= self.min_samples:
            deadline = float(np.median(self.times[-self.window:])) \
                * self.tolerance
            if dt > deadline:
                is_straggler = True
                self.events.append((step, dt, deadline))
        self.times.append(dt)
        return is_straggler

    @property
    def median_step_s(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


class InjectedFault(RuntimeError):
    pass


@dataclass
class FaultInjector:
    """Deterministically raise at configured steps (tests, drills)."""
    fail_at_steps: Tuple[int, ...] = ()
    fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFault(f"injected fault at step {step}")


__all__ = ["ElasticMesh", "StragglerMonitor", "InjectedFault",
           "FaultInjector"]
