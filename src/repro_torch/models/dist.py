"""Distribution context threaded through model code, the port's copy of
``repro.models.dist``.

Model functions take a ``DistContext`` that names the batch axes (data
parallel, possibly ("pod", "data")) and the model (tensor) axis.
``dist=None``, or a context with no mesh, means one device.  With a
training mesh (``launch.mesh.TrainMesh``) the port runs the data-axis
route: each rank runs the model code on its own rows of the batch, and
the training loop reduces the gradients over the batch axes.  A model
axis above 1 (tensor parallelism, the expert-parallel MoE route) comes
with A6d in ROADMAP.md, so a context over one raises.
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
        if self.tp > 1:
            raise NotImplementedError(
                f"DistContext over a model axis of {self.tp}: tensor and "
                f"expert parallelism over the model axis come with A6d in "
                f"ROADMAP.md; the port runs the data axes (a model axis "
                f"of 1, or dp_only)")

    @property
    def manual_moe(self) -> bool:
        """Whether MoE runs expert-parallel over the model axis."""
        return (not self.auto_moe and self.mesh is not None
                and self.model_axis in self.mesh.shape)

    @property
    def tp(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape.get(self.model_axis, 1)

    @property
    def dp(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for ax in self.batch_axes:
            n *= self.mesh.shape[ax]
        return n

    def batch_group(self):
        """The process group of the batch axes (a mesh's only)."""
        return self.mesh.group(self.batch_axes)


LOCAL = DistContext(mesh=None)
