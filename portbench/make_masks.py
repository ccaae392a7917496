#!/usr/bin/env python3
"""Freeze a fleet configuration's offline RoI masks as a data file.

    PYTHONPATH=src python3 portbench/make_masks.py crossroi_4x5

Reads ``portbench/configs/<name>.json``, builds its fleet of
intersections with the port's scene generator (``repro_torch.fleet``:
one ``GroupSpec`` per ``groups`` entry, ``offline.duration_s`` seconds
of scene), runs the port's offline phase on the host
(``run_fleet_offline``: noisy ReID, filters, association table and the
``offline.solver`` set cover over ``offline.profile_frames`` frames), and
writes each camera's mask grid at ``offline.mask_cell_px`` pixels to the
file the configuration names under ``masks``, one string of 0 and 1 per
grid row.  It also freezes the vehicles those scenes hold after the
profile, the frames the online phase serves, as each camera's boxes a
frame (the file the configuration names under ``tracks``), which the
benchmark's traffic replays.  It then records the masks' tile counts and
the boxes' counts in the configuration file (``active_tiles``,
``active_tiles_per_group``, ``boxes_per_camera_frame``).

The benchmark reads the frozen file and never runs the offline phase, so
a later change to the set cover does not change the work a cell does.
Run on the host only; the whole 16-intersection fleet takes a few
minutes.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def camera_boxes(scene, cam, frames):
    """Per frame of ``frames``, camera ``cam``'s vehicle boxes as one flat
    list of (vehicle, y0, x0, h, w), whole pixels (the box's floor and
    ceiling) clipped to the frame, by vehicle; an empty box is left out."""
    out = []
    for t in frames:
        rows = []
        for d in scene.detections_at(t):
            if d.cam != cam.cam_id:
                continue
            b = d.bbox
            y0, x0 = max(int(np.floor(b.top)), 0), max(int(np.floor(b.left)), 0)
            y1 = min(int(np.ceil(b.top + b.height)), cam.height)
            x1 = min(int(np.ceil(b.left + b.width)), cam.width)
            if y1 > y0 and x1 > x0:
                rows.append((int(d.obj), y0, x0, y1 - y0, x1 - x0))
        out.append([v for row in sorted(rows) for v in row])
    return out


def main(name: str) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.pipeline import OfflineConfig
    from repro_torch.fleet import (FleetConfig, GroupSpec, build_fleet,
                                   run_fleet_offline)

    cfg_path = ROOT / "portbench" / "configs" / f"{name}.json"
    cfg = json.loads(cfg_path.read_text())
    off_cfg = cfg["offline"]
    cell = off_cfg["mask_cell_px"]
    t0 = time.perf_counter()
    fleet = build_fleet(FleetConfig(
        groups=[GroupSpec(profile, seed=seed)
                for profile, seed in cfg["groups"]],
        duration_s=off_cfg["duration_s"], tile=cell))
    t_build = time.perf_counter() - t0
    off = run_fleet_offline(fleet, OfflineConfig(
        profile_frames=off_cfg["profile_frames"], solver=off_cfg["solver"]))
    scale = (cell // cfg["tile_px"]) ** 2
    online = range(off_cfg["profile_frames"],
                   off_cfg["duration_s"] * cfg["fps"])
    cameras, per_group, tracks, boxes = [], [], [], []
    for g, o in zip(fleet.groups, off.per_group):
        tiles = 0
        for cam in g.scene.cameras:
            grid = np.asarray(o.cam_grids[cam.cam_id], bool)
            cameras.append({"group": g.gid, "camera": cam.cam_id,
                            "height": cam.height, "width": cam.width,
                            "rows": ["".join("1" if v else "0" for v in row)
                                     for row in grid]})
            tiles += int(grid.sum()) * scale
            tracks.append({"group": g.gid, "camera": cam.cam_id,
                           "boxes": camera_boxes(g.scene, cam, online)})
        per_group.append(tiles)
        boxes.append(round(sum(len(f) for t in tracks[-len(g.scene.cameras):]
                               for f in t["boxes"]) / 5
                           / len(online) / len(g.scene.cameras), 3))
        print(f"group {g.gid} ({g.spec.profile}, seed {g.spec.seed}): "
              f"{tiles} tiles of {cfg['tile_px']} px, solver optimal "
              f"{o.solve.optimal}, host {o.wall_s:.2f} s", flush=True)
    masks = {
        "config": name,
        "made_by": (f"portbench/make_masks.py {name}: repro_torch.fleet."
                    f"build_fleet ({off_cfg['duration_s']} s scenes) then "
                    f"run_fleet_offline ({off_cfg['profile_frames']} "
                    f"profile frames, {off_cfg['solver']} set cover)"),
        "cell_px": cell,
        "cameras": cameras,
    }
    out = ROOT / cfg["masks"]
    out.write_text(json.dumps(masks, indent=0) + "\n")
    out_tracks = ROOT / cfg["tracks"]
    out_tracks.write_text(
        '{"config": %s, "made_by": %s, "frames": %s, "fields": %s, '
        '"cameras": [\n%s\n]}\n' % (
            json.dumps(name),
            json.dumps(f"portbench/make_masks.py {name}: the vehicle boxes "
                       f"of the same scenes after the profile, frames "
                       f"{online.start} to {online.stop - 1}"),
            json.dumps([online.start, online.stop]),
            json.dumps(["vehicle", "y0", "x0", "h", "w"]),
            ",\n".join(json.dumps(t, separators=(",", ":"))
                        for t in tracks)))
    cfg["active_tiles"] = int(sum(per_group))
    cfg["active_tiles_per_group"] = per_group
    cfg["boxes_per_camera_frame"] = boxes
    cfg_path.write_text(json.dumps(cfg, indent=1) + "\n")
    print(f"{name}: {sum(per_group)} active tiles of {cfg['tile_px']} px; "
          f"build_fleet {t_build:.1f} s, run_fleet_offline {off.wall_s:.1f} "
          f"s; wrote {out.relative_to(ROOT)} and "
          f"{out_tracks.relative_to(ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
