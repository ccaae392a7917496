"""CrossRoI core: the paper's contribution as a composable library.

Offline phase: scene profiling -> noisy ReID -> tandem statistical filters
-> cross-camera association table -> set-cover RoI masks -> tile grouping.
Online phase: mask-cropped tile streaming (codec model) + RoI-based
inference (the SBNet-style CUDA kernels in repro_torch.kernels) + metrics.
"""
from repro_torch.core.association import (AssociationTable, Region,
                                          TileUniverse,
                                          build_association_table)
from repro_torch.core.compression import CodecModel, EncoderModel
from repro_torch.core.filters import (FilterConfig, KernelSVM, RansacConfig,
                                      SVMConfig, apply_filters,
                                      ransac_regression)
from repro_torch.core.grouping import TileGroup, group_tiles, groups_cover
from repro_torch.core.pipeline import (OfflineConfig, OfflineResult,
                                       OnlineConfig, OnlineMetrics,
                                       ServerModel, bbox_arrays,
                                       coverage_flags_batched,
                                       full_frame_offline, run_offline,
                                       run_online, segment_network_bytes)
from repro_torch.core.reducto import ReductoResult, tune_and_run
from repro_torch.core.reid import (ReIDNoiseConfig, ReIDRecord,
                                   characterize_pairwise, run_noisy_reid)
from repro_torch.core.scene import Scene, SceneConfig, default_cameras, \
    generate_scene
from repro_torch.core import setcover

__all__ = [
    "AssociationTable", "Region", "TileUniverse", "build_association_table",
    "CodecModel", "EncoderModel", "FilterConfig", "KernelSVM", "RansacConfig",
    "SVMConfig", "apply_filters", "ransac_regression", "TileGroup",
    "group_tiles", "groups_cover", "OfflineConfig", "OfflineResult",
    "OnlineConfig", "OnlineMetrics", "ServerModel", "full_frame_offline",
    "run_offline", "run_online", "bbox_arrays", "coverage_flags_batched",
    "segment_network_bytes", "ReductoResult", "tune_and_run",
    "ReIDNoiseConfig", "ReIDRecord", "characterize_pairwise",
    "run_noisy_reid", "Scene", "SceneConfig", "default_cameras",
    "generate_scene", "setcover",
]
