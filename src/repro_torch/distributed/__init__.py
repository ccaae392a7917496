"""Placement of sharded state: the sharded fleet runtime's stacked
per-shard state over a fleet mesh (``distributed.shardings``)."""
