"""The port's dry run in a process of its own, for ``test_torch_dryrun.py``:
PyTorch's fake process group is process-wide state, so no test process
initializes it.  Run as a script it counts every case of ``CASES`` and
writes their results as JSON:

  python tests/torch_dryrun_worker.py OUT.json

Each case's result is ``{"ok": True, ...}`` or ``{"ok": False, "error":
traceback}``.  Imports no JAX.
"""
import json
import math
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# one arch a family
FAMILIES = {"dense": "h2o-danube3-4b", "vlm": "internvl2-26b",
            "moe": "deepseek-moe-16b", "ssm": "rwkv6-7b",
            "hybrid": "zamba2-2.7b", "encdec": "whisper-small"}
DEBUG_MESHES = ((2, 2), (2, 4), (2, 2, 2))
# SMOKE cells: (seq_len, global batch, kind); "long" is a batch of one,
# which the batch axes do not divide: the caches' sequence over them
KINDS = {"train": (64, 8, "train"), "prefill": (64, 8, "prefill"),
         "decode": (128, 8, "decode"), "long": (256, 1, "decode")}
RANK_SUM_ARCHS = ("h2o-danube3-4b", "deepseek-moe-16b")
RANK_SUM_MESHES = ((1, 1), (1, 2), (2, 1))
RANK_SUM_CELL = (64, 4)


def _counts(c):
    return {"flops": c.flops, "bytes": c.hbm_bytes, "coll": c.coll,
            "peak": c.peak_bytes, "ops": c.ops}


def _count_cell(cfg, cell, shape, rank, tcfg=None):
    from repro_torch.launch.counter import count
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.steps import build_cell
    fake_world(math.prod(shape), rank)
    mesh = make_train_mesh(shape, device="meta")
    fn, args, meta = build_cell(cfg, cell, mesh, len(shape) == 3,
                                tcfg=tcfg)
    return dict(_counts(count(fn, *args)), **meta)


def debug_cells():
    """Every family at SMOKE, each kind, on each debug mesh, counted as
    its last rank."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    out = {}
    for fam, arch in FAMILIES.items():
        cfg = get_config(arch, smoke=True)
        for kind, (S, B, k) in KINDS.items():
            for shape in DEBUG_MESHES:
                key = f"{fam}:{kind}:{'x'.join(map(str, shape))}"
                try:
                    out[key] = dict(ok=True, **_count_cell(
                        cfg, ShapeCell(kind, S, B, k), shape,
                        math.prod(shape) - 1))
                except Exception:
                    out[key] = {"ok": False,
                                "error": traceback.format_exc()[-3000:]}
    return out


def rank_sums():
    """Each rank's FLOPs of a train step (remat off, one microbatch) and a
    prefill step of a dense and an MoE arch at SMOKE, on each mesh."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeCell
    S, B = RANK_SUM_CELL
    out = {}
    for arch in RANK_SUM_ARCHS:
        cfg = get_config(arch, smoke=True)
        for kind in ("train", "prefill"):
            tcfg = TrainConfig(remat="none", microbatch=1) \
                if kind == "train" else None
            for shape in RANK_SUM_MESHES:
                out[f"{arch}:{kind}:{shape[0]}x{shape[1]}"] = [
                    _count_cell(cfg, ShapeCell(kind, S, B, kind), shape, r,
                                tcfg)["flops"]
                    for r in range(shape[0] * shape[1])]
    return {"ok": True, "flops": out}


def collectives():
    """h2o-danube3-4b SMOKE decode (seq 128, batch 8) on (2, 4), rank 5."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    c = _count_cell(get_config("h2o-danube3-4b", smoke=True),
                    ShapeCell("decode", 128, 8, "decode"), (2, 4), 5)
    return {"ok": True, "coll": c["coll"]}


def calibrate():
    """``run_cell`` with ``--calibrate``'s counts: h2o-danube3-4b FULL
    decode_32k on the production mesh."""
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("h2o-danube3-4b", "decode_32k", calibrate=True,
                   verbose=False)
    return dict(rec, ok=rec["ok"])


def main_cell():
    """``dryrun.main`` on h2o-danube3-4b FULL long_500k (the production
    mesh, rank 3)."""
    from repro_torch.launch.dryrun import main
    recs = main(["--arch", "h2o-danube3-4b", "--shape", "long_500k",
                 "--rank", "3"])
    return {"ok": True, "records": recs}


CASES = {"debug": debug_cells, "rank_sums": rank_sums,
         "collectives": collectives, "calibrate": calibrate,
         "main": main_cell}


def main():
    warnings.filterwarnings("ignore")
    import torch
    torch.set_num_threads(1)
    res = {}
    for name, fn in CASES.items():
        try:
            res[name] = fn()
        except Exception:
            res[name] = {"ok": False, "error": traceback.format_exc()[-3000:]}
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
