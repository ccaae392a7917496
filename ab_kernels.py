#!/usr/bin/env python3
"""Time B1 (``tile_delta_gate_canvas``), B5 (``tile_delta_gate``), B2
(``roi_conv_entry``), B8 (``roi_conv``), B3 (``roi_conv_stack``), B6
(``roi_conv_packed``) and B12 (``roi_attention``, bf16) of two checkouts of
this repository in turns, on one card.

    python3 ab_kernels.py --other DIR

``DIR`` is another checkout (for example the parent commit, unpacked with
``git archive``).  Each turn is its own process, which builds that
checkout's kernels under its own ``build/`` and times, with CUDA events
(median of 7 after a warm-up), at the main paths' shapes:

* B1 and B5 on the 4x5 fleet of ``chip_smoke.py`` (52,288 tiles of
  16x16), the frames after ``chip_smoke.py``'s patches against the
  frames before them (a canvas for B1, its windows for B5), and against
  a reference where every element differs (``*_changed``), each by CUDA
  events and by the profiler's device time (``*_device_ms``);
* B2 on the same fleet (52,288 tiles of 16x16 on the
  stacked 1088x1920 frames, 3 -> 8 channels), and B8 on its first leg
  (2,432 tiles of one 1088x1920 frame), as ``roi_forward_layers`` runs it;
* B3 on the same fleet (the default (8, 16, 16) detector), on the plain
  entry output;
* B6 on the same fleet, each of the detector's two later layers (8 -> 16
  on the plain entry output, 16 -> 16 on the plain first layer's ReLU);
* B12 at the serving slice (the fleet stream's 9,472 packed positions,
  48 heads of 128, bf16, blocks of 128), with and without the causal skip;
* B10 and B11 (``tile_delta``, ``tile_delta_halo``) on each of the 20
  cameras' frame pairs (the same frames as B1's, padded to the grid), as
  the rate-control feed calls them, one launch a camera: by CUDA events
  and by the profiler's device time with its count of kernel records (a
  reading short of 20 launches x 7 calls is printed as invalid, not as a
  time), beside a launch of one tile a camera (the per-launch floor), the
  host time of the 20 calls (the wrappers' enqueue, median of 7), and the
  feed over the 20 cameras (``tile_static_fraction``,
  ``tile_halo_static_fraction``): its wall, median of 5, and the stages
  of one pass, each ended by a synchronize -- ``pad_to_grid``, the rows'
  host-to-device copy, the kernel, the stats' device-to-host copy.

Each turn also reports the machine code of B3's instance for the
detector (the (8, 16, 16) stack on 16x16 tiles): its ptxas register
count and a digest of its SASS (``cuobjdump -sass``, the function's name
line left out), so two checkouts can be shown to run the same code; the
same registers (``cuobjdump -res-usage``) and digest for each kernel of
``tile_delta.cu`` (B10, B11); and the registers of the gate's kernels.

The turns run other, this, this, other; the script prints each turn's
times as a JSON line, then, for B10 and B11, each turn's device time and
whether every valid turn of this checkout is below every valid turn of
the other, then the card's name and power limit.  With ``--turn`` it runs
one turn for the checkout it lives in (or ``--root``).
"""
import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


DETECTOR_STACK = "roi_conv_stack_kernelILi8ELi16ELi16ELi16E"


# the kernels of tile_delta.cu (B10, B11) and of tile_delta_gate.cu (B1,
# B5), by their mangled names
DELTA_STATS = "tile_delta_stats_kernel"
GATE = "tile_delta_gate_kernel"


def cuobjdump(_build, what: str) -> str:
    """``cuobjdump what`` on the library ``_build`` (that checkout's build
    module) built."""
    so = _build.BUILD_ROOT / _build._digest() / "libkernels.so"
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), what, str(so)], capture_output=True,
                          text=True, timeout=300).stdout


def sass_digests(dump: str, pattern: str) -> dict:
    """A digest of each SASS function whose name holds ``pattern``, keyed
    by the name."""
    digest = {}
    for f in re.split(r"\n\s*Function : ", dump):
        name, _, rest = f.partition("\n")
        if pattern in name:
            # the instructions, up to the row of dots that ends the function
            code = re.split(r"\n\s*\.{5,}", rest)[0]
            digest[name.strip()] = hashlib.sha256(
                " ".join(code.split()).encode()).hexdigest()[:16]
    return digest


def registers(usage: str, pattern: str) -> dict:
    """The registers of each function whose name holds ``pattern``, from
    ``cuobjdump -res-usage``."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function ([^\s:]+):\s*REG:(\d+)", usage) if pattern in m.group(1)}


def kernel_code(_build) -> dict:
    """Registers and SASS digests of B3's detector instance and of
    ``tile_delta.cu``'s kernels, and the gate kernels' registers."""
    regs = [r[1] for r in _build.ptxas_report() if DETECTOR_STACK in r[0]]
    dump, usage = cuobjdump(_build, "-sass"), cuobjdump(_build, "-res-usage")
    delta_regs, delta_sass = (registers(usage, DELTA_STATS),
                              sass_digests(dump, DELTA_STATS))
    return {"detector_stack_code": {
                "registers": regs, "sass_sha256_16": list(
                    sass_digests(dump, DETECTOR_STACK).values())},
            "tile_delta_code": {k: [delta_regs.get(k), v]
                                for k, v in sorted(delta_sass.items())},
            "gate_registers": registers(usage, GATE)}


def gate_times(torch, cs, det, nxt, grids, x, idx) -> dict:
    """B1 and B5 on the fleet: the next frames ``nxt`` against the frames
    ``x``, and against a reference where every element differs."""
    from repro_torch.kernels import ref, tile_delta
    xn, _, _ = det._stack_frames(cs.flat(nxt), cs.flat(grids))
    pad = (0, 0, 1, 1, 1, 1)
    cur_p = torch.nn.functional.pad(xn, pad)
    ref_c = torch.nn.functional.pad(x, pad)
    g = torch.Generator(device=cur_p.device).manual_seed(cs.SEED + 10)
    ref_d = cur_p + 16.0 + 16.0 * torch.rand(cur_p.shape, generator=g,
                                             device=cur_p.device)
    t, out = cs.TILE, {}
    for suffix, canvas in (("", ref_c), ("_changed", ref_d)):
        packed = ref.gather_windows(canvas, idx, t, t)
        for name, rw in (("tile_delta_gate_canvas", canvas),
                         ("tile_delta_gate", packed)):
            def fn(kfn=getattr(tile_delta, name), rw=rw):
                return kfn(cur_p, rw, idx, t, t)
            out[name + suffix + "_ms"] = cs.time_ms(torch, fn)
            out[name + suffix + "_device_ms"] = cs.device_ms(
                torch, fn, "tile_delta_gate_kernel")
    return out


def device_reading(torch, fn, kernel, launches, reps=7):
    """(ms per call or None, records): the profiler's device time of the
    kernels named ``kernel`` that ``fn`` launches, ``launches`` a call,
    over ``reps`` calls after a warm-up, and its count of kernel records.
    With fewer than ``launches * reps`` records the profiler missed some:
    the reading is invalid (None), not a time.  (This script's own copy of
    ``chip_smoke.device_ms``: the other checkout's may not count.)"""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    records = sum(e.count for e in hits)
    if records < launches * reps:
        return None, records
    return sum(e.device_time_total for e in hits) / reps / 1e3, records


def host_ms(torch, fn, reps=7):
    """Median host time of ``fn`` alone (the launches' enqueue), each pass
    started and followed by a synchronize that is not timed."""
    passes = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        passes.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(passes)


def feed(torch, kfn, fraction, triples, t, reps=5) -> dict:
    """The rate-control feed over the cameras of ``triples`` (cur, prev,
    grid): the wall of ``fraction`` for every camera (median of
    ``reps``), and the stages of one pass through kernel ``kfn``, each
    ended by a synchronize and summed over the cameras."""
    from repro_torch.net import encoder as enc

    def wall():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for cur, prev, grid in triples:
            fraction(cur, prev, grid, t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    wall()
    walls = [wall() for _ in range(reps)]
    stages = dict.fromkeys(("pad_to_grid", "rows_h2d", "kernel",
                            "stats_d2h"), 0.0)
    for cur, prev, grid in triples:
        marks = [time.perf_counter()]
        a, b = enc.pad_to_grid(cur, prev, grid.shape, t)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        rows = enc._tile_rows(grid, a.device)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        stats = kfn(a, b, rows, t, t)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        stats.cpu()
        marks.append(time.perf_counter())
        for k, t0, t1 in zip(stages, marks, marks[1:]):
            stages[k] += (t1 - t0) * 1e3
    return {"walls_ms": walls, "median_ms": statistics.median(walls),
            "stages_ms": stages}


def delta_times(torch, cs, nxt, frames, grids) -> dict:
    """B10 and B11 on each camera's pair of ``nxt`` and ``frames``, padded
    to its grid as the feed pads it, one launch a camera."""
    from repro_torch.kernels import ops, tile_delta
    from repro_torch.net import encoder as enc
    t, out = cs.TILE, {}
    triples = list(zip(cs.flat(nxt), cs.flat(frames), cs.flat(grids)))
    pairs = []
    for cur, prev, grid in triples:
        a, b = enc.pad_to_grid(cur, prev, grid.shape, t)
        pairs.append((a, b, torch.as_tensor(ops.mask_to_indices(grid),
                                            device=a.device)))
    ones = [(a, b, rows[:1]) for a, b, rows in pairs]
    for name, fraction in (("tile_delta", enc.tile_static_fraction),
                           ("tile_delta_halo",
                            enc.tile_halo_static_fraction)):
        kfn = getattr(tile_delta, name)
        for tag, sets in (("", pairs), ("_one_tile", ones)):
            def fn(sets=sets):
                return [kfn(a, b, rows, t, t) for a, b, rows in sets]
            out[f"{name}{tag}_ms"] = cs.time_ms(torch, fn)
            out[f"{name}{tag}_device_ms"], out[f"{name}{tag}_records"] = \
                device_reading(torch, fn, DELTA_STATS, len(sets))
        out[f"{name}_host_ms"] = host_ms(
            torch, lambda: [kfn(a, b, rows, t, t) for a, b, rows in pairs])
        out[f"{name}_feed"] = feed(torch, kfn, fraction, triples, t)
    return out


def turn(root: Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref, roi_attention, roi_conv

    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng, gen, grids, frames = cs.build_fleet(torch, dev)
    det = cs.build_detector(dev)
    _, _, idx, nbr = det._fleet_tables(cs.flat(grids))
    x, _, _ = det._stack_frames(cs.flat(frames), cs.flat(grids))
    t, w0 = cs.TILE, det.weights[0]
    nxt = cs.with_patches(torch, frames, grids, rng, gen, 20.0)
    gates = gate_times(torch, cs, det, nxt, grids, x, idx)
    deltas = delta_times(torch, cs, nxt, frames, grids)
    del nxt
    b2 = cs.time_ms(torch, lambda: roi_conv.roi_conv_entry(x, w0, idx, t, t))
    leg, leg_grid = cs.flat(frames)[0], cs.flat(grids)[0]
    xl = det._stack_frames([leg], [leg_grid])[0][0]
    rows = torch.as_tensor(ops.mask_to_indices(leg_grid), device=dev)
    b8 = cs.time_ms(torch, lambda: roi_conv.roi_conv(xl, w0, rows, t, t))
    e_p = ref.roi_conv_entry(x, w0, idx, t, t)
    ws = det.weights[1:]
    b3 = cs.time_ms(torch, lambda: roi_conv.roi_conv_stack(e_p, ws, nbr))
    h = torch.relu(ref.roi_conv_packed(e_p, ws[0], nbr))
    b6 = [cs.time_ms(torch, lambda a=a, w=w: roi_conv.roi_conv_packed(
        a, w, nbr)) for a, w in ((e_p, ws[0]), (h, ws[1]))]
    keep = cs.fleet_keep(grids)
    del x, xl, e_p, h, frames, det
    _, pos, _ = ops.pack_tokens(torch.arange(keep.size, device=dev),
                                torch.as_tensor(keep, device=dev))
    S, H, D = pos.shape[0], cs.SLICE_HEADS, cs.SLICE_HEAD_DIM
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    q, k, v = (torch.randn((S, H, D), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    b12 = cs.time_ms(torch, lambda: roi_attention.roi_attention(
        q, k, v, pos, 128, 128, True))
    b12_exh = cs.time_ms(torch, lambda: roi_attention.roi_attention(
        q, k, v, pos, 128, 128, False))
    return {"root": str(root), "n_tiles": int(idx.shape[0]),
            "leg_tiles": int(rows.shape[0]), **gates, **deltas,
            "roi_conv_entry_ms": b2,
            "roi_conv_ms": b8, "roi_conv_stack_ms": b3,
            "roi_conv_packed_ms": b6,
            "roi_attention_ms": b12,
            "roi_attention_exhaustive_ms": b12_exh,
            **kernel_code(_build),
            "device": torch.cuda.get_device_name(0)}


def delta_verdict(name: str, this: list, other: list) -> str:
    """One line on ``name``'s device time in the turns of this checkout
    and of the other: each turn's reading (or "invalid" with its records),
    and whether every valid reading of this one is below every valid
    reading of the other."""
    def readings(turns):
        return [t.get(f"{name}_device_ms") for t in turns]

    def show(turns):
        return ", ".join(
            "invalid ({} records)".format(t.get(f"{name}_records"))
            if t.get(f"{name}_device_ms") is None
            else "{:.4f}".format(t[f"{name}_device_ms"]) for t in turns)

    a = [v for v in readings(this) if v is not None]
    b = [v for v in readings(other) if v is not None]
    below = bool(a and b) and max(a) < min(b)
    return (f"{name} device ms: this checkout {show(this)}; the other "
            f"{show(other)}; every valid turn of this one below every valid "
            f"turn of the other: {below}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="another checkout to compare")
    ap.add_argument("--turn", action="store_true", help="run one turn")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="the checkout a turn times (default: this one)")
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.root.resolve())), flush=True)
        return 0
    if args.other is None:
        ap.error("give --other DIR, or --turn")
    other = args.other.resolve()
    turns = []
    for root in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--turn", "--root", str(root)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        turns.append(json.loads(line))
    for name in ("tile_delta", "tile_delta_halo"):
        print(delta_verdict(name, turns[1:3], turns[::3]), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
