"""Roofline runner: the three roofline terms of every (arch x shape) cell
on the production mesh, counted whole.

The JAX package compiles four reduced, fully unrolled variants of each
cell -- two depths by two sequence lengths at a reduced batch -- and
fits and extrapolates, because XLA's cost analysis counts a scan body
once.  The port's layer and chunk loops are Python, so one rank's step
counted at the cell's full depth, sequence and batch (``launch.counter``
on ``meta`` tensors in the fake process group, ``launch.dryrun``) is
already the whole cell: there is no fit, and ``calib_seqs``,
``calib_batch`` and ``_fit_and_extrapolate`` have no counterpart.
Training counts one microbatch of the whole batch, as the JAX package's
calibration compiles it.

  PYTHONPATH=src python -m repro_torch.launch.roofline_run \
      --out results/roofline.json
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import all_cells, get_config
from repro_torch.launch import roofline as R
from repro_torch.launch.counter import count
from repro_torch.launch.dryrun import auto_mode, fake_world
from repro_torch.launch.mesh import CHIPS_PER_POD, make_production_mesh
from repro_torch.launch.steps import build_cell


def run_cell(arch: str, shape_name: str, sharding_mode: str = "auto",
             verbose: bool = True, cfg_transform=None, tcfg_kwargs=None,
             cell_transform=None, label: str = "") -> dict:
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    cell = SHAPES[shape_name]
    if cell_transform is not None:
        cell = cell_transform(cell)
    fake_world(CHIPS_PER_POD)
    mesh = make_production_mesh(device="meta")
    if sharding_mode == "auto":
        sharding_mode = auto_mode(cfg, cell, mesh, False)
    tcfg = TrainConfig(microbatch=1, sharding_mode=sharding_mode,
                       **(tcfg_kwargs or {})) \
        if cell.kind == "train" else None
    t0 = time.time()
    fn, args, _ = build_cell(cfg, cell, mesh, False, sharding_mode,
                             tcfg=tcfg)
    c = count(fn, *args)
    rec = {"arch": arch, "shape": shape_name, "sharding": sharding_mode,
           "label": label, "ok": True, "chips": CHIPS_PER_POD,
           "model_flops": R.model_flops_for(cfg, cell),
           "flops_per_dev": float(c.flops),
           "hbm_bytes_per_dev": float(c.hbm_bytes),
           "coll_bytes_per_dev": float(c.coll["total"]),
           "coll_by_kind": dict(c.coll), "mem_per_device": int(c.peak_bytes),
           "wall_s": round(time.time() - t0, 1)}
    if verbose:
        t = R.RooflineTerms(arch, shape_name, "16x16", c.flops, c.hbm_bytes,
                            c.coll["total"], dict(c.coll),
                            rec["model_flops"], CHIPS_PER_POD,
                            mem_per_device=c.peak_bytes)
        print(t.row(), f"  ({rec['wall_s']}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/roofline.json")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args(argv)
    results = []
    cells = [(a, c.name) for a, c, ok in all_cells() if ok]
    if args.arch:
        wanted = set(args.arch.split(","))
        cells = [(a, s) for a, s in cells if a in wanted
                 and (not args.shape or s == args.shape)]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for arch, shape in cells:
        try:
            results.append(run_cell(arch, shape))
        except Exception as e:
            traceback.print_exc()
            results.append({"arch": arch, "shape": shape, "ok": False,
                            "error": str(e)[:500]})
        with open(args.out, "w") as f:     # incremental: survive kills
            json.dump(results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells counted -> {args.out}")
    return results


if __name__ == "__main__":
    main()
