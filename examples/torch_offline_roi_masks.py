"""Offline-phase deep dive on the PyTorch port: watch each CrossRoI stage do
its work.

  PYTHONPATH=src python examples/torch_offline_roi_masks.py

Shows: raw ReID error structure (Table 2), filter effects, the association
table, exact-vs-greedy set cover, tile grouping, and an ASCII render of
each camera's mask.
"""
import numpy as np

from repro_torch.core import setcover
from repro_torch.core.association import (TileUniverse,
                                          build_association_table)
from repro_torch.core.filters import FilterConfig, apply_filters
from repro_torch.core.grouping import group_tiles
from repro_torch.core.reid import ReIDNoiseConfig, characterize_pairwise, \
    run_noisy_reid
from repro_torch.core.scene import SceneConfig, generate_scene


def main():
    scene = generate_scene(SceneConfig(duration_s=60, seed=0))
    records = run_noisy_reid(scene, ReIDNoiseConfig(), 0, 600)
    counts = characterize_pairwise(records, 5)
    print("raw ReID (src=C1):  TP   FP   FN   TN")
    for d in range(1, 5):
        tp, fp, fn, tn = counts[0, d]
        print(f"  C1->C{d+1}:        {tp:4d} {fp:4d} {fn:4d} {tn:4d}")

    cleaned, stats = apply_filters(records, 5, FilterConfig())
    print(f"\nfilters: {stats.fp_decoupled} FP decoupled, "
          f"{stats.fn_removed} FN removed")

    universe = TileUniverse.build(scene.cameras)
    tab = build_association_table(cleaned, universe)
    multi = sum(1 for c in tab.constraints if len(c) > 1)
    print(f"association table: {len(tab.constraints)} constraints, "
          f"{multi} with cross-camera choice")

    g = setcover.solve(tab, "greedy")
    e = setcover.solve(tab, "exact")
    print(f"set cover: greedy |M|={len(g.mask)}  "
          f"exact |M|={len(e.mask)} (LB={e.lower_bound:.0f}, "
          f"optimal={e.optimal}, {e.nodes} nodes, {e.wall_s:.1f}s)")

    for cam in scene.cameras:
        grid = universe.cam_mask_grid(cam.cam_id, e.mask)
        groups = group_tiles(grid)
        print(f"\nC{cam.cam_id+1} mask: {int(grid.sum())} tiles -> "
              f"{len(groups)} groups")
        for row in grid:
            print("  " + "".join("#" if v else "." for v in row))


if __name__ == "__main__":
    main()
