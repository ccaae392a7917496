"""Distribution context threaded through model code, the port's copy of
``repro.models.dist``.

Model functions take a ``DistContext`` that names the batch axes (data
parallel, possibly ("pod", "data")) and the model (tensor) axis.
``dist=None``, or a context with no mesh, means one device.  The port
runs one device only: the multi-device routes (meshes, sharded
parameters and batches, expert parallelism) come with the training
loop's slice, A6b in ROADMAP.md, so a context with a mesh raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class DistContext:
    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # expert parallelism through the partitioner instead of the explicit
    # dispatch, as in the JAX package; no effect without a mesh
    auto_moe: bool = False

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "DistContext with a mesh: the multi-device routes come with "
                "the training loop's slice (A6b in ROADMAP.md); the port "
                "runs one device, mesh=None")

    # one device: no model-parallel ranks, no data-parallel replicas
    @property
    def manual_moe(self) -> bool:
        """Whether MoE runs expert-parallel over the model axis."""
        return False

    @property
    def tp(self) -> int:
        return 1

    @property
    def dp(self) -> int:
        return 1


LOCAL = DistContext(mesh=None)
