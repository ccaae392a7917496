"""Placement of the sharded fleet runtime's stacked state over a fleet mesh.

Every piece of sharded fleet state is stacked as ``(S, ...)`` with one
padded shape for all shards.  Shards that share a device share one block
of that stack there: a block is the ``(S_b, ...)`` rows of its shards, in
shard order, so one kernel launch per device serves every shard on it
(on a one-device mesh the whole ``(S, ...)`` stack is one block).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import FleetMesh


@dataclass(frozen=True)
class FleetStateSharding:
    """Where each shard's rows of an ``(S, ...)`` stack live: ``blocks``
    holds (device, the shards on it in order), devices in order of first
    appearance on the mesh."""
    blocks: Tuple[Tuple[torch.device, Tuple[int, ...]], ...]

    @property
    def n_shards(self) -> int:
        return sum(len(shards) for _, shards in self.blocks)

    def locate(self, shard: int) -> Tuple[int, int]:
        """(block, position within the block) of ``shard``."""
        for b, (_, shards) in enumerate(self.blocks):
            if shard in shards:
                return b, shards.index(shard)
        raise IndexError(f"shard {shard} is not on the mesh")


def fleet_state_sharding(mesh: FleetMesh) -> FleetStateSharding:
    """The blocks of a fleet mesh: shards grouped by their device."""
    order: List[torch.device] = []
    members = {}
    for s, dev in enumerate(mesh.devices):
        if dev not in members:
            order.append(dev)
            members[dev] = []
        members[dev].append(s)
    return FleetStateSharding(tuple((d, tuple(members[d])) for d in order))


def put_fleet_state(mesh: FleetMesh, tree):
    """Place a pytree (dicts, lists, tuples) of ``(S, ...)`` stacked
    arrays or tensors on the mesh: each leaf becomes a list of its
    blocks' ``(S_b, ...)`` tensors, one per device."""
    sharding = fleet_state_sharding(mesh)

    def one(a):
        a = torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray) \
            else torch.as_tensor(a)
        if a.shape[0] != sharding.n_shards:
            raise ValueError(f"stacked state of {a.shape[0]} shards on a "
                             f"{sharding.n_shards}-shard mesh")
        return [a[list(shards)].to(dev).contiguous()
                for dev, shards in sharding.blocks]

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return one(t)

    return walk(tree)


__all__ = ["FleetStateSharding", "fleet_state_sharding", "put_fleet_state"]
