#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload crossroi_4x5.h264 --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program under ``src/repro_torch/``.  The cell's configuration
names its driver, which sets the program up on the card, warms it up on
the cell's own traffic, measures a window of ``--seconds`` and checks the
outputs against the plain reference.  With ``--trace 0`` the line holds
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from a profiled stretch of the window.  The compared numbers and
their limits are the last lines of standard error and the last key of
the result line.  Exits non-zero, printing no result, without enough
CUDA devices, without the program, or if the run loaded JAX or the JAX
package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def caches_in_checkout() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own kernel library is built under ``build/``)."""
    base = ROOT / "build" / "portbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    caches_in_checkout()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell, _ = harness.find_cell(harness.load_spec(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s)", file=sys.stderr)
        return 2
    outcome, metrics = harness.run_cell(
        ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in outcome.notes + harness.check_lines(outcome):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(outcome, metrics), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
