"""Hillclimbing driver: the chosen cells, each with an ordered list of
variants (paper-faithful baseline first, beyond-paper after), the JAX
package's experiments on the port's counts.

Each variant counts its cell whole (``launch.roofline_run``) and reports
the three roofline terms on the H100's constants (``launch.mesh``).

  PYTHONPATH=src python -m repro_torch.launch.perf [--exp A|A2|B|C] \
      --out results/perf.json
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import COLL_BW, HBM_BW, PEAK_FLOPS_BF16
from repro_torch.launch.roofline_run import run_cell


def _packed_cell(keep: float):
    def t(cell: ShapeCell) -> ShapeCell:
        s_kept = int(round(cell.seq_len * keep / 1024)) * 1024
        return ShapeCell(cell.name + f"_roi{keep:.2f}", s_kept,
                         cell.global_batch, cell.kind)
    return t


# experiment -> (arch, shape, [(label, kwargs), ...])
EXPERIMENTS = {
    # A: the most collective-bound cell of the JAX package's baseline
    # table -- rwkv6 train
    "A": ("rwkv6-7b", "train_4k", [
        ("baseline_tp", {}),
        ("fsdp", dict(sharding_mode="fsdp")),
        ("fsdp+no_remat", dict(sharding_mode="fsdp",
                               tcfg_kwargs={"remat": "none"})),
        ("dp_only+no_remat", dict(sharding_mode="dp_only",
                                  tcfg_kwargs={"remat": "none"})),
    ]),
    # A2: the big dense train cell -- the paper-era TP baseline vs
    # beyond-paper sharding/attention changes
    "A2": ("deepseek-67b", "train_4k", [
        ("baseline_tp", {}),
        ("fsdp", dict(sharding_mode="fsdp")),
        ("tp+causal_skip", dict(tcfg_kwargs={"causal_skip": True})),
        ("fsdp+causal_skip", dict(sharding_mode="fsdp",
                                  tcfg_kwargs={"causal_skip": True})),
    ]),
    # B: the paper's own technique -- VLM prefill over the fleet stream;
    # keep=0.42 is the JAX package's measured set-cover fleet density
    "B": ("internvl2-26b", "prefill_32k", [
        ("baseline_dense", {}),
        ("roi_packed_0.42", dict(cell_transform=_packed_cell(0.42))),
        ("roi_packed_0.42+fsdp", dict(cell_transform=_packed_cell(0.42),
                                      sharding_mode="fsdp")),
    ]),
    # C: decode against a 32k cache
    "C": ("deepseek-67b", "decode_32k", [
        ("baseline", {}),
        ("grouped_attn", dict(cfg_transform=lambda c: c.replace(
            decode_grouped_attn=True))),
        ("grouped+fp8_kv", dict(cfg_transform=lambda c: c.replace(
            decode_grouped_attn=True, kv_cache_dtype="float8_e4m3fn"))),
    ]),
}


def terms(rec):
    return (rec["flops_per_dev"] / PEAK_FLOPS_BF16,
            rec["hbm_bytes_per_dev"] / HBM_BW,
            rec["coll_bytes_per_dev"] / COLL_BW)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default=None, choices=list(EXPERIMENTS))
    ap.add_argument("--out", default="results/perf.json")
    args = ap.parse_args(argv)
    exps = [args.exp] if args.exp else list(EXPERIMENTS)
    all_recs = []
    for e in exps:
        arch, shape, variants = EXPERIMENTS[e]
        print(f"\n=== experiment {e}: {arch} x {shape} ===", flush=True)
        base_bound = None
        for label, kw in variants:
            try:
                rec = run_cell(arch, shape, label=label, verbose=False, **kw)
            except Exception as ex:
                traceback.print_exc()
                all_recs.append({"exp": e, "label": label, "ok": False,
                                 "error": str(ex)[:300]})
                continue
            rec["exp"] = e
            tc, tm, tx = terms(rec)
            bound = max(tc, tm, tx)
            if base_bound is None:
                base_bound = bound
            dom = ("compute", "memory", "collective")[
                (tc, tm, tx).index(bound)]
            print(f"  {label:22s} c={tc:9.3e} m={tm:9.3e} x={tx:9.3e} "
                  f"dom={dom:10s} bound={bound:9.3e} "
                  f"({base_bound / bound:4.2f}x vs base)", flush=True)
            rec.update(t_compute=tc, t_memory=tm, t_collective=tx,
                       dominant=dom, bound=bound,
                       speedup_vs_base=base_bound / bound)
            all_recs.append(rec)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(all_recs, f, indent=1)
    print(f"\nwrote {args.out}")
    return all_recs


if __name__ == "__main__":
    main()
