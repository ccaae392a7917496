"""CrossRoI quickstart on the PyTorch port: offline RoI optimization + online
evaluation.

  PYTHONPATH=src python examples/torch_quickstart.py

Generates the synthetic 5-camera intersection (the paper's AI-City-S02
structure), profiles 60 s to build cross-camera RoI masks, then evaluates
the online phase on the next 60 s against the full-frame baseline.  The
offline and online phases are host numpy, copies of the JAX package's
``repro.core``: this prints what ``examples/quickstart.py`` prints.
"""
import time

from repro_torch.core import (OfflineConfig, OnlineConfig,
                              full_frame_offline, run_offline, run_online)
from repro_torch.core.scene import SceneConfig, generate_scene


def main():
    t0 = time.time()
    scene = generate_scene(SceneConfig(duration_s=120, seed=0))
    n_det = sum(len(f) for f in scene.detections)
    print(f"scene: {len(scene.vehicles)} vehicles, {n_det} detections, "
          f"5 cameras ({time.time()-t0:.1f}s)")

    # offline phase: noisy ReID -> filters -> association -> set cover
    off = run_offline(scene, OfflineConfig(profile_frames=600,
                                           solver="exact"))
    print(f"offline: |M| = {len(off.mask)}/{off.universe.num_tiles} tiles "
          f"({off.fleet_density:.0%} of fleet pixels), "
          f"solver={off.solve.method} optimal={off.solve.optimal}, "
          f"filters removed {off.filter_stats.fn_removed} FN / decoupled "
          f"{off.filter_stats.fp_decoupled} FP")

    # online phase vs baseline
    m = run_online(scene, off, OnlineConfig(), 600, 1200)
    base = run_online(scene, full_frame_offline(scene),
                      OnlineConfig(roi_inference=False), 600, 1200)
    print(f"\n{'':12s}{'accuracy':>10s}{'net Mbps':>10s}{'latency s':>11s}"
          f"{'server Hz':>11s}")
    print(f"{'baseline':12s}{base.accuracy:10.4f}{base.network_mbps:10.2f}"
          f"{base.latency_s:11.3f}{base.server_hz:11.1f}")
    print(f"{'crossroi':12s}{m.accuracy:10.4f}{m.network_mbps:10.2f}"
          f"{m.latency_s:11.3f}{m.server_hz:11.1f}")
    print(f"\nnetwork -{1-m.network_mbps/base.network_mbps:.0%} "
          f"latency -{1-m.latency_s/base.latency_s:.0%} "
          f"(paper: 42-65% / 25-34%)")


if __name__ == "__main__":
    main()
