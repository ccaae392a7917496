"""Fleet layer: many intersections, one engine.

Sits between the offline solver (``repro_torch.core``) and the serving
stack (``repro_torch.serving``): ``topology`` composes the
single-intersection scene into K independent camera groups with per-group
traffic profiles; ``runtime`` runs the offline phase per group, the fleet
online phase as one vectorized evaluation, and the kernel-level fleet
steps (cold and delta-gated) as one super-launch chain for every group;
``drift`` keeps the deployed RoI masks tracking traffic shifts with
warm-started incremental re-solves; ``faults`` injects camera faults,
detects them from the gate's own stats and re-solves around dead cameras;
``sharded`` partitions camera groups over a fleet mesh (one launch per
kernel per device, no collectives) with an async host/device pipeline.
"""
from repro_torch.fleet.topology import (FleetConfig, FleetGroup, FleetScene,
                                        GroupSpec, TRAFFIC_PROFILES,
                                        build_fleet, cross_group_leakage)
from repro_torch.fleet.runtime import (FleetOfflineResult, FleetOnlineMetrics,
                                       fleet_inference_step, fleet_reuse_step,
                                       run_fleet_offline, run_fleet_online,
                                       sharded_fleet_step)
from repro_torch.fleet.drift import (AdaptiveRunResult, DriftAdapter,
                                     DriftConfig, DriftEvent, ShrinkEvent,
                                     run_adaptive_online,
                                     wire_shard_invalidation)
from repro_torch.fleet.sharded import (AsyncShardedPipeline,
                                       ShardedReuseStats, ShardedSuperlaunch)

__all__ = [
    "FleetConfig", "FleetGroup", "FleetScene", "GroupSpec",
    "TRAFFIC_PROFILES", "build_fleet", "cross_group_leakage",
    "FleetOfflineResult", "FleetOnlineMetrics", "fleet_inference_step",
    "fleet_reuse_step", "run_fleet_offline", "run_fleet_online",
    "sharded_fleet_step",
    "AdaptiveRunResult", "DriftAdapter", "DriftConfig", "DriftEvent",
    "ShrinkEvent", "run_adaptive_online", "wire_shard_invalidation",
    "AsyncShardedPipeline", "ShardedReuseStats", "ShardedSuperlaunch",
]
