"""Distribution context threaded through model code, the port's copy of
``repro.models.dist``.

Model functions take a ``DistContext`` that names the batch axes (data
parallel, possibly ("pod", "data")) and the model (tensor) axis.
``dist=None``, or a context with no mesh, means one device.  With a
training mesh (``launch.mesh.TrainMesh``) each rank runs the model code
on its own rows of the batch and, over a model axis above 1, on its
model shard of the parameters: column- and row-parallel projections,
the vocabulary and the experts split over the model group, with the
collectives of ``distributed.tensor_parallel`` written out where the
JAX package's partitioner inserts them.  The training loop reduces the
gradients over the batch axes.  The port takes the explicit
expert-parallel route whatever ``auto_moe`` says: it has no partitioner
to defer to (ROADMAP.md, deliberate differences).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class DistContext:
    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # the JAX package's expert parallelism through its partitioner instead
    # of the explicit dispatch; the port has no partitioner and takes the
    # explicit route either way
    auto_moe: bool = False

    @property
    def manual_moe(self) -> bool:
        """Whether the JAX package runs MoE through its explicit
        ``shard_map`` on this context."""
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

    @property
    def model_rank(self) -> int:
        """This rank's index along the model axis (0 without one)."""
        if self.tp == 1:
            return 0
        return self.mesh.index(self.model_axis)

    def batch_group(self):
        """The process group of the batch axes (a mesh's only)."""
        return self.mesh.group(self.batch_axes)

    def model_group(self):
        """The process group of the model axis (a mesh's only)."""
        return self.mesh.group(self.model_axis)

    def all_group(self):
        """The process group of the batch axes and the model axis."""
        return self.mesh.group(tuple(self.batch_axes) + (self.model_axis,))


LOCAL = DistContext(mesh=None)
