"""The fleet mesh: the devices the sharded fleet runtime's shards live on.

Camera groups never leak across each other, so they shard over a 1-D
``"shard"`` axis with no collectives on the hot path
(``fleet.sharded``).  A ``FleetMesh`` is an explicit list of
``torch.device``s, one per shard; shards listed on the same device share
one stacked block of state there and one launch per kernel
(``distributed.shardings``).
"""
from __future__ import annotations

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


__all__ = ["FLEET_AXIS", "FleetMesh", "make_fleet_mesh"]
