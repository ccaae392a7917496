"""The edge side of the stream: RoI packetization, the backlog-driven rate
controller and its static-tile feeds (``encoder``), fed by the
``tile_delta`` and ``tile_delta_halo`` CUDA kernels or by the fleet step's
own gate stats."""
from repro_torch.net.encoder import (CameraCoefficients, RateControlConfig,
                                     activity, camera_coefficients,
                                     gate_threshold_schedule,
                                     rate_controlled_departures,
                                     segment_byte_matrices, sent_matrix,
                                     static_fraction_from_stats,
                                     tile_halo_static_fraction,
                                     tile_static_fraction, zero_safe_div)

__all__ = [
    "CameraCoefficients", "RateControlConfig", "activity",
    "camera_coefficients", "gate_threshold_schedule",
    "rate_controlled_departures", "segment_byte_matrices", "sent_matrix",
    "static_fraction_from_stats", "tile_halo_static_fraction",
    "tile_static_fraction", "zero_safe_div",
]
