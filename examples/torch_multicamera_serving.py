"""End-to-end driver on the PyTorch port: multi-camera video analytics
served by the framework, on the CUDA card.

  PYTHONPATH=src python examples/torch_multicamera_serving.py [--device cpu]

The paper's full online pipeline, wired through every layer of the stack:
  1. offline phase computes cross-camera RoI masks (core/)
  2. the camera stream pipeline emits per-segment patch tokens + keep-lists
     derived from the masks (data/streams.py)
  3. the RoI detector runs SBNet-style sparse conv on active tiles
     (serving/detector.py -> the CUDA kernels in kernels/csrc)
  4. the serving engine prefills the *packed* fleet patch stream through a
     (smoke) VLM backbone — the CrossRoI technique as token sparsity —
     and decodes a short analytics summary (serving/engine.py)

It runs on the card unless ``--device`` names another device; on the CPU
the kernel wrappers take their plain PyTorch versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ServeConfig, get_config
from repro_torch.core import OfflineConfig, OnlineConfig, run_offline, \
    run_online
from repro_torch.core.scene import SceneConfig, generate_scene
from repro_torch.data import CameraStreamPipeline
from repro_torch.models.params import init_params
from repro_torch.serving.detector import DetectorConfig, RoIDetector
from repro_torch.serving.engine import ServingEngine


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(device=None):
    dev = resolve_device(device)
    t0 = time.time()
    scene = generate_scene(SceneConfig(duration_s=90, seed=0))
    off = run_offline(scene, OfflineConfig(profile_frames=600))
    print(f"offline masks: {off.fleet_density:.0%} of fleet pixels kept "
          f"({time.time()-t0:.1f}s)")

    # --- detector on RoI tiles (one frame, camera 1) -----------------------
    det = RoIDetector(DetectorConfig(), seed=1, device=dev)
    grid = np.kron(off.cam_grids[0], np.ones((4, 4), bool))[:33, :60]
    frame = torch.as_tensor(np.random.default_rng(0).normal(
        size=(grid.shape[0] * 16, grid.shape[1] * 16, 3)),
        dtype=torch.float32, device=dev)
    det.forward(frame, grid)                 # first call builds the kernels
    sync(dev)
    t1 = time.time()
    heat = det.forward(frame, grid)
    sync(dev)
    print(f"RoI detector: frame {tuple(frame.shape[:2])}, density "
          f"{grid.mean():.0%}, est speedup "
          f"{det.speedup_estimate(float(grid.mean())):.2f}x, heat map "
          f"{tuple(heat.shape)} finite {bool(torch.isfinite(heat).all())} "
          f"({(time.time()-t1) * 1e3:.1f} ms on {dev})")

    # --- packed VLM prefill over the fleet stream --------------------------
    cfg = get_config("internvl2-26b", smoke=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    engine = ServingEngine(cfg, ServeConfig(roi_sparsity=True), params)
    pipe = CameraStreamPipeline(scene, off, patch_dim=cfg.frontend_dim)
    seg = next(pipe.segments(600, 610))
    toks, keep = pipe.fleet_tokens(seg, frame=0)
    # pad to the engine block; patch streams enter via the VLM frontend
    res = engine.roi_prefill(torch.as_tensor(toks, dtype=torch.bfloat16,
                                             device=dev),
                             torch.as_tensor(keep, device=dev), block=128)
    print(f"packed prefill: {res.n_kept}/{res.n_total} fleet patch tokens "
          f"({res.compute_fraction:.0%} of dense compute)")
    nxt = torch.argmax(res.logits[:, -1], -1)
    out, _ = engine.decode_tokens(res.caches, nxt, res.n_kept, 6)
    print(f"decoded analytics tokens: {out[0].tolist()}")

    # --- whole-system accounting -------------------------------------------
    m = run_online(scene, off, OnlineConfig(), 600, 900)
    print(f"\nsystem: accuracy {m.accuracy:.4f}, network "
          f"{m.network_mbps:.1f} Mbps, server {m.server_hz:.0f} Hz, "
          f"latency {m.latency_s:.2f} s   (total {time.time()-t0:.1f}s)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
