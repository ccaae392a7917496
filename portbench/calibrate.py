#!/usr/bin/env python3
"""Read the compared number of the program and of its control over many
seeds in one process, to set a cell's limit from.

    python3 portbench/calibrate.py --workload crossroi_4x5.h264 \\
        --seconds 3 --seeds 3000000101 3000000102 ...

Each seed runs the cell as ``run.py`` does (set-up, a window of
``--seconds`` at the cell's own load, the comparison over the last step's
cameras and the sampled maps), and also reads the control on the same
maps: the plain reference computed in TF32 in the program's place.  One
JSON line a seed: the program's ``maps_rel_err`` and the control's
``control_rel_err``.  The benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, caches_in_checkout  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    caches_in_checkout()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        outcome, _ = harness.run_cell(
            ROOT, args.workload, seed, args.seconds, False,
            torch.device("cuda", 0), t0, readings=True)
        checks = {c.name: c.value for c in outcome.checks}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "steps": len(outcome.run.step_s), **checks,
                          "s": time.perf_counter() - t0}), flush=True)
        del outcome
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
