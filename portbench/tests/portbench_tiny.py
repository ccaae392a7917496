"""A tiny fleet cell on the CPU, for the benchmark's own tests.

``make_root`` lays out a checkout-like directory: ``BENCHMARK.json`` with
one cell, ``tiny.h264``, the benchmark's drivers and metric readers as
they are, and a configuration of 2 small cameras with frozen masks and
vehicle tracks, and a small traffic mix of its own -- new files, as a
later change would add them.  The program runs its plain CPU path.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
STAND_IN = "crossroi_4x5.h264"

CONFIG = {
    "name": "tiny", "driver": "fleet",
    "deployment": "two small cameras", "source": "test", "intersections": 1,
    "groups": [["uniform", 1]], "cameras_per_intersection": 2,
    "camera_hw": [[64, 96], [48, 64]], "fps": 10, "tile_px": 16,
    "detector": {"channels": [8, 16, 16], "num_anchors": 2,
                 "head_outputs_per_anchor": 5, "dtype": "float32",
                 "tf32": False},
    "masks": "portbench/configs/tiny.masks.json",
    "tracks": "portbench/configs/tiny.tracks.json",
    "limits": {"maps_rel_err": 1e-4},
}
TRAFFIC = {"gop": 3, "start_frame": 0, "background": [16, 235],
           "keyframe_noise": 2, "threshold": 0.0, "qstep": 8.0,
           "warmup_steps": 3, "sample_maps": 2, "trace_after": 1,
           "trace_steps": 2}
# 32-px mask cells: camera 0 is 2 x 3 cells, camera 1 2 x 2
MASKS = {"config": "tiny", "made_by": "test", "cell_px": 32, "cameras": [
    {"group": 0, "camera": 0, "height": 64, "width": 96,
     "rows": ["110", "011"]},
    {"group": 0, "camera": 1, "height": 48, "width": 64,
     "rows": ["10", "11"]}]}


N_FRAMES = 6


def tiny_boxes(f: int, hw):
    """Frame ``f``'s (vehicle, y0, x0, h, w) boxes of a camera of size
    ``hw``: vehicle 1 moves down and right, vehicle 2 left and is gone in
    frame 3, vehicle 3 stands still."""
    h, w = hw
    rows = [(1, 4 + 3 * f, 2 + 5 * f, 12, 16)]
    if f != 3:
        rows.append((2, 20, w - 14 - 6 * f, 14, 10))
    rows.append((3, h - 12, 0, 10, 10))
    return rows


def tiny_tracks(frames=N_FRAMES):
    """The tiny configuration's tracks file."""
    return {"config": "tiny", "made_by": "test", "frames": [0, frames],
            "fields": ["vehicle", "y0", "x0", "h", "w"],
            "cameras": [{"group": 0, "camera": c, "boxes": [
                [v for row in tiny_boxes(f, hw) for v in row]
                for f in range(frames)]}
                for c, hw in enumerate(CONFIG["camera_hw"])]}


@pytest.fixture
def one_thread():
    """The tiny runs' CPU operations on one thread, as the test workers
    share the machine's cores; the worker's setting comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def grids():
    """The tiny configuration's tile grids at 16 px."""
    return [np.kron(np.array([[c == "1" for c in r] for r in cam["rows"]]),
                    np.ones((2, 2), bool)) for cam in MASKS["cameras"]]


def make_root(tmp: Path, traffic=None, per_layer=None) -> Path:
    root = Path(tmp)
    pb = root / "portbench"
    for sub in ("drivers", "metrics"):
        shutil.copytree(BENCH / sub, pb / sub)
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    (pb / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (pb / "configs" / "tiny.masks.json").write_text(json.dumps(MASKS))
    (pb / "configs" / "tiny.tracks.json").write_text(
        json.dumps(tiny_tracks()))
    (pb / "traffic" / "tiny_h264.json").write_text(
        json.dumps(dict(TRAFFIC, **(traffic or {}))))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "test",
                        "file": "portbench/configs/tiny.json",
                        "reduced": [], "why": "test"}]
    spec["workloads"] = [{"name": "tiny.h264", "config": "tiny",
                          "traffic": "tiny_h264", "chips": 1, "why": "test"}]
    # the tiny cell stands in for STAND_IN: it reports that cell's metrics
    spec["end_to_end"] = [m for m in spec["end_to_end"]
                          if STAND_IN in m.get("workloads", [STAND_IN])]
    e2e = {m["name"] for m in spec["end_to_end"]}
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if STAND_IN in m.get("workloads", ())
                         or ("workloads" not in m and m["moves"] in e2e)]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.h264"]
    spec["per_layer"] += per_layer or []
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
