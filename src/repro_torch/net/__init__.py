"""Edge-to-server streaming runtime, the port's copy of ``repro.net``.

The subsystem between the codec model and the serving engine: per-camera
uplinks (``links``: bandwidth traces, jitter, congestion episodes, FIFO
queuing), RoI-aware packetization and the backlog-driven rate controller
with its static-tile feeds (``encoder``, fed by the ``tile_delta`` and
``tile_delta_halo`` CUDA kernels or by the fleet step's own gate stats),
and server-side deadline-based group batching with straggler accounting
(``batcher``).  ``simulate_transport`` evaluates the whole path as array
ops over every (camera, segment, frame) at once and returns per-frame
latency distributions; in the uncongested limit it converges to the
analytic ``core.pipeline.online_system_metrics`` formula.
"""
from repro_torch.net.links import (CongestionEpisode, LinkConfig,
                                   UplinkTrace, bandwidth_traces,
                                   default_congestion_trace, fifo_departures,
                                   load_bundled_trace, queue_wait)
from repro_torch.net.encoder import (CameraCoefficients, RateControlConfig,
                                     activity, camera_coefficients,
                                     gate_threshold_schedule,
                                     rate_controlled_departures,
                                     segment_byte_matrices, sent_matrix,
                                     static_fraction_from_stats,
                                     tile_halo_static_fraction,
                                     tile_static_fraction, zero_safe_div)
from repro_torch.net.batcher import (DeadlineGroupFormer, NetConfig, Release,
                                     TransportStats, merge_transport,
                                     simulate_transport)

__all__ = [
    "CongestionEpisode", "LinkConfig", "UplinkTrace", "bandwidth_traces",
    "default_congestion_trace", "fifo_departures", "load_bundled_trace",
    "queue_wait",
    "CameraCoefficients", "RateControlConfig", "activity",
    "camera_coefficients", "gate_threshold_schedule",
    "rate_controlled_departures",
    "segment_byte_matrices", "sent_matrix", "static_fraction_from_stats",
    "tile_halo_static_fraction", "tile_static_fraction", "zero_safe_div",
    "DeadlineGroupFormer", "NetConfig", "Release", "TransportStats",
    "merge_transport", "simulate_transport",
]
