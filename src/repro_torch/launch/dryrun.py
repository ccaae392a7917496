"""Dry run of the production meshes on one host: run one rank's step of
every (arch x shape x mesh) cell on ``meta`` tensors and count what it
does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b \
      --shape train_4k [--multi-pod] [--sharding fsdp] [--calibrate]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      --out results.json

Where the JAX package forces 512 host devices and lowers each cell for
XLA's cost analysis, the port initializes PyTorch's fake process group
at the mesh's world size as rank ``--rank`` and runs that rank's real
step -- the model code, its collectives, the optimizer -- on ``meta``
tensors under ``launch.counter`` (no memory is allocated, no collective
moves data).  Per cell it prints the counts (FLOPs, HBM bytes,
collective bytes by kind, the peak of live bytes) beside
``estimate_cell``'s HBM estimate against the H100's 80 GiB.  The record
keeps the JAX package's keys: ``lower_s`` is the host seconds to build
the rank's shards, ``compile_s`` those of the counted step,
``mem_per_device`` the counter's peak.

``--calibrate`` also counts the cell at ``roofline.calib_depths`` and
extrapolates to the full depth, as the JAX package does to undo XLA's
scan-once counting.  The port's loops count every layer, so there it is
a check: ``calibrated["rel_err"]`` is each extrapolation's relative
distance from the full-depth count (0 for a stack of identical layers;
not for gemma3's pattern, whose full depth is not a whole number of
calibration units).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import (ARCH_IDS, all_cells,
                                          cell_is_applicable, get_config)
from repro_torch.launch import roofline as R
from repro_torch.launch.counter import count
from repro_torch.launch.memory import estimate_cell
from repro_torch.launch.mesh import CHIPS_PER_POD, make_production_mesh
from repro_torch.launch.steps import auto_microbatch, build_cell


def fake_world(world: int, rank: int = 0) -> None:
    """PyTorch's fake process group of ``world`` ranks, this process as
    ``rank`` (a group of another size is torn down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def auto_mode(cfg, cell, mesh, multi_pod: bool) -> str:
    """tp where it fits the card, else the FSDP upgrade (the JAX
    package's ``--sharding auto``)."""
    k0 = auto_microbatch(cfg, cell, mesh, multi_pod) \
        if cell.kind == "train" else 1
    est0 = estimate_cell(cfg, cell, mesh, multi_pod, "tp", microbatch=k0)
    return "tp" if est0["fits"] else ("fsdp_pod" if multi_pod else "fsdp")


def _counted(cfg, cell, mesh, multi_pod, sharding_mode):
    """(the counts of one step of ``cfg`` at ``cell``, build seconds,
    the step's meta)."""
    t0 = time.time()
    fn, args, meta = build_cell(cfg, cell, mesh, multi_pod, sharding_mode)
    t_build = time.time() - t0
    c = count(fn, *args)
    return c, t_build, meta


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             sharding_mode: str = "tp", calibrate: bool = False,
             verbose: bool = True, rank: int = 0) -> dict:
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    chips = 2 * CHIPS_PER_POD if multi_pod else CHIPS_PER_POD
    mesh_name = "2x16x16" if multi_pod else "16x16"
    fake_world(chips, rank)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    if sharding_mode == "auto":
        sharding_mode = auto_mode(cfg, cell, mesh, multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "sharding": sharding_mode, "rank": rank, "ok": False}

    c, t_build, meta = _counted(cfg, cell, mesh, multi_pod, sharding_mode)
    k = meta.get("microbatch", 1)
    est = estimate_cell(cfg, cell, mesh, multi_pod, sharding_mode,
                        microbatch=k)
    rec.update(
        ok=True, lower_s=round(t_build, 2), compile_s=round(c.seconds, 2),
        flops_per_dev=float(c.flops), bytes_per_dev=float(c.hbm_bytes),
        coll_bytes=dict(c.coll), mem_per_device=int(c.peak_bytes),
        ops=c.ops, microbatch=k,
        mem_estimate=round(est["total"]), fits=bool(est["fits"]),
        mem_breakdown={kk: round(v) for kk, v in est.items()
                       if kk not in ("total", "fits")},
    )

    if calibrate:
        l1, l2 = R.calib_depths(cfg)
        cal = {}
        for L in (l1, l2):
            cc, _, _ = _counted(R.with_depth(cfg, L), cell, mesh, multi_pod,
                                sharding_mode)
            cal[L] = {"flops": cc.flops, "bytes": cc.hbm_bytes,
                      "coll": cc.coll["total"]}
        lf = R.full_depth(cfg)
        full = {"flops": c.flops, "bytes": c.hbm_bytes,
                "coll": c.coll["total"]}
        ext = {key: R.extrapolate(cal[l1][key], cal[l2][key], l1, l2, lf)
               for key in full}
        rec["calibrated"] = dict(
            depths=[l1, l2], full_depth=lf, **ext,
            rel_err={key: abs(ext[key] - v) / v if v else abs(ext[key])
                     for key, v in full.items()})
        rec["model_flops"] = R.model_flops_for(cfg, cell)
        rec["chips"] = chips

    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name} ({sharding_mode}) "
              f"rank {rank}] build {t_build:.1f}s step {c.seconds:.1f}s "
              f"({c.ops} ops)  {c.flops:.3e} FLOP {c.hbm_bytes:.3e} B  "
              f"coll {c.coll['total'] / 2 ** 20:.1f} MiB  "
              f"peak {c.peak_bytes / 2 ** 30:.2f} GiB  mem/dev est "
              f"{est['total'] / 2 ** 30:.2f} GiB "
              f"({'FITS' if rec['fits'] else 'OVER'})  mb={k}", flush=True)
        if calibrate:
            cr = rec["calibrated"]
            print(f"    calibrated/dev: {cr['flops']:.3e} FLOP "
                  f"{cr['bytes']:.3e} B hbm  {cr['coll']:.3e} B coll  "
                  f"rel err {cr['rel_err']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--sharding", default="auto",
                    choices=["auto", "tp", "fsdp", "fsdp_pod"])
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch, cell, ok in all_cells(include_skips=True):
            if ok:
                cells.append((arch, cell.name))
            else:
                print(f"[skip] {arch} x {cell.name} (recorded skip: "
                      f"long_500k runs only the long-context archs)")
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        if not cell_is_applicable(args.arch, args.shape):
            print(f"[skip] {args.arch} x {args.shape} is a recorded skip")
            return []
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    results = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                # calibration only on the single-pod mesh (the multi-pod
                # pass is the sharding-coherence proof)
                results.append(run_cell(arch, shape, multi_pod=mp,
                                        sharding_mode=args.sharding,
                                        calibrate=args.calibrate and not mp,
                                        rank=args.rank))
            except Exception as e:
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "ok": False, "error": str(e)[:500]})
    n_ok = sum(r["ok"] for r in results)
    print(f"\n== {n_ok}/{len(results)} cells counted ==")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    if n_ok < len(results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
