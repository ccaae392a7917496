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
  48 heads of 128, bf16, blocks of 128), with and without the causal skip.

Each turn also reports the machine code of B3's instance for the
detector (the (8, 16, 16) stack on 16x16 tiles): its ptxas register
count and a digest of its SASS (``cuobjdump -sass``, the function's name
line left out), so two checkouts can be shown to run the same code; the
same registers (``cuobjdump -res-usage``) and digest for each kernel of
``tile_delta.cu`` (B10, B11); and the registers of the gate's kernels.

The turns run other, this, this, other; the script prints each turn's
times as a JSON line, then the card's name and power limit.  With
``--turn`` it runs one turn for the checkout it lives in (or ``--root``).
"""
import argparse
import hashlib
import json
import re
import subprocess
import sys
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


def gate_times(torch, cs, det, rng, gen, frames, grids, x, idx) -> dict:
    """B1 and B5 on the fleet: the next frames (``cs.with_patches``, as
    ``chip_smoke.py`` makes them) against the frames ``x``, and against a
    reference where every element differs."""
    from repro_torch.kernels import ref, tile_delta
    nxt = cs.with_patches(torch, frames, grids, rng, gen, 20.0)
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
    gates = gate_times(torch, cs, det, rng, gen, frames, grids, x, idx)
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
            "leg_tiles": int(rows.shape[0]), **gates,
            "roi_conv_entry_ms": b2,
            "roi_conv_ms": b8, "roi_conv_stack_ms": b3,
            "roi_conv_packed_ms": b6,
            "roi_attention_ms": b12,
            "roi_attention_exhaustive_ms": b12_exh,
            **kernel_code(_build),
            "device": torch.cuda.get_device_name(0)}


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
    for root in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--turn", "--root", str(root)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
