"""The meshes: the fleet mesh, the devices the sharded fleet runtime's
shards live on, and the training mesh over the ranks of a process group.

Camera groups never leak across each other, so they shard over a 1-D
``"shard"`` axis with no collectives on the hot path
(``fleet.sharded``).  A ``FleetMesh`` is an explicit list of
``torch.device``s, one per shard; shards listed on the same device share
one stacked block of state there and one launch per kernel
(``distributed.shardings``).

A ``TrainMesh`` lays the ranks of the initialized ``torch.distributed``
process group row-major over the JAX package's axes, ``("data",
"model")`` or ``("pod", "data", "model")``, one device a rank: the card
of the rank's local index under NCCL, the CPU under gloo.  It gives the
process group of any set of axes -- the model group, the batch axes'
group beside a live model axis -- and this rank's coordinate.  The
production and debug meshes of the JAX package's ``launch/mesh.py`` are
not ported yet (A6c in ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

# the fleet-serving mesh axis: camera groups shard over it
FLEET_AXIS = "shard"


class FleetMesh:
    """One device per shard along ``FLEET_AXIS``: ``devices[s]`` holds
    shard ``s``'s state; ``shape[FLEET_AXIS]`` is the shard count."""

    def __init__(self, devices: Sequence[torch.device]):
        if not devices:
            raise ValueError("a fleet mesh needs at least one device")
        self.devices: List[torch.device] = [_pin_index(torch.device(d))
                                            for d in devices]

    @property
    def shape(self) -> Dict[str, int]:
        return {FLEET_AXIS: len(self.devices)}

    def __repr__(self) -> str:
        return f"FleetMesh({[str(d) for d in self.devices]})"


def _pin_index(dev: torch.device) -> torch.device:
    """A CUDA device without an index is the current one, so ``"cuda"``
    and ``"cuda:0"`` name one block; other devices stay as given."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_fleet_mesh(n_shards: int = 0,
                    devices: Optional[Sequence] = None) -> FleetMesh:
    """The 1-D fleet mesh for the sharded runtime.

    Without ``devices``: one visible CUDA device per shard, ``n_shards``
    = 0 taking every one; more shards than devices raises.  With
    ``devices`` (the port's stand-in for the JAX package's forced host
    device count, which simulates more devices than the host has): shard
    ``s`` lives on ``devices[s % len(devices)]``, so several shards can
    share one card, or the CPU; ``n_shards`` = 0 takes one shard per
    listed device."""
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        n = n_shards or avail
        if n < 1 or n > avail:
            raise ValueError(
                f"make_fleet_mesh({n_shards}): {avail} CUDA device(s) "
                f"visible; pass devices= to place several shards on one "
                f"device")
        return FleetMesh([torch.device("cuda", i) for i in range(n)])
    devices = list(devices)
    if not devices:
        raise ValueError("make_fleet_mesh: devices= is empty")
    n = n_shards or len(devices)
    return FleetMesh([devices[s % len(devices)] for s in range(n)])


TRAIN_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


class TrainMesh:
    """The ranks of the process group laid row-major over ``axes``, with
    ``shape[axis]`` ranks along each (``shape`` is a dict, as a JAX
    mesh's).  ``device`` is this rank's device.  The process group of
    every set of axes is made when the mesh is: ``new_group`` is
    collective, so every rank makes every group, in one order."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device: torch.device):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("a training mesh needs an initialized "
                               "torch.distributed process group")
        shape, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(shape) != len(axes) or math.prod(shape) != \
                dist.get_world_size():
            raise ValueError(f"mesh {shape} over {axes} does not lay out "
                             f"{dist.get_world_size()} ranks")
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.device = _pin_index(torch.device(device))
        self.rank = dist.get_rank()
        self.coords: Dict[str, int] = self._coords(self.rank)
        # a group for each proper subset of the live axes (the empty one
        # included: each rank alone); the whole live set is the world
        live = [a for a in axes if self.shape[a] > 1]
        self._groups: Dict[tuple, object] = {}
        for bits in range(2 ** len(live) - 1):
            sub = tuple(a for i, a in enumerate(live) if bits >> i & 1)
            members: Dict[tuple, List[int]] = {}
            for r in range(math.prod(shape)):
                c = self._coords(r)
                members.setdefault(tuple(c[a] for a in live
                                         if a not in sub), []).append(r)
            mine = tuple(self.coords[a] for a in live if a not in sub)
            for key, ranks in members.items():
                g = dist.new_group(ranks)
                if key == mine:
                    self._groups[sub] = g

    def _coords(self, rank: int) -> Dict[str, int]:
        coords = []
        for n in reversed(tuple(self.shape.values())):
            coords.append(rank % n)
            rank //= n
        return dict(zip(self.axis_names, reversed(coords)))

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple; names
        not on the mesh count 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index along ``axes``, in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in self.axis_names:
            if a in axes:
                i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes`` (``"model"``: the model group; the batch
        axes: the ranks of this rank's model coordinate); its ranks are
        ordered as ``index`` orders them."""
        import torch.distributed as dist
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        live = tuple(a for a in self.axis_names if a in axes
                     and self.shape[a] > 1)
        if live in self._groups:
            return self._groups[live]
        return dist.group.WORLD

    def __repr__(self) -> str:
        return f"TrainMesh({self.shape}, {self.device})"


def make_train_mesh(shape: Sequence[int], axes: Optional[Sequence[str]]
                    = None, device=None) -> TrainMesh:
    """A training mesh of ``shape`` over the initialized process group,
    with the JAX package's axis names for its rank unless ``axes`` is
    given.  ``device``: this rank's device, the card unless the caller
    passes another; a card without an index is the one of the rank's
    local index (``LOCAL_RANK``, as ``torchrun`` sets it)."""
    import os

    from repro_torch import resolve_device
    axes = tuple(axes) if axes is not None else TRAIN_AXES[len(shape)]
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return TrainMesh(shape, axes, device)


__all__ = ["FLEET_AXIS", "FleetMesh", "make_fleet_mesh", "TRAIN_AXES",
           "TrainMesh", "make_train_mesh"]
