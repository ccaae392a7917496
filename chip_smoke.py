#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its fleet step on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code
is non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. every kernel of the fleet step against its plain PyTorch version on the
   card, at the main path's shapes: the gate and the scatter bit-exact,
   the two convolutions within 1e-4 (FMA contraction and summation order
   differ; the plain versions use no TF32); each kernel's time (CUDA
   events, median of 7) beside the plain version's and its bound;
3. the main path at full size -- the 4-group x 5-camera fleet at the
   paper's camera sizes (four 1920x1080 legs and one 1280x960 centre
   camera per group), default detector (channels (8, 16, 16), tile 16, 2
   anchors), RoI masks at density 0.35 on the offline 64-px grid: one cold
   step, six warm steps each giving 5 cameras a fresh 64x64 patch, one
   all-static step and two lossy warm steps at threshold 40.  Every step
   checks the runtime's dispatch structure; the warm threshold-0 steps are
   bitwise equal to a cold recompute through the kernels; the cold step
   is within 1e-4 of the plain-version composition;
4. a ``kernels`` JSON line with each kernel's launches on the main path.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the ``src/repro_torch`` package beside this file, it exits
non-zero and prints no result.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
TILE = 16
LEG_HW, CENTER_HW = (1080, 1920), (960, 1280)
GROUPS, CAMS = 4, 5
MASK_DENSITY = 0.35            # offline 64-px grid, expanded x4 to tiles
PATCH = 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
CONV_TOL = 1e-4

KERNELS = {
    "tile_delta_gate_canvas": ("src/repro_torch/kernels/csrc/tile_delta_gate.cu",
                               "src/repro/kernels/tile_delta.py:280"),
    "roi_conv_entry": ("src/repro_torch/kernels/csrc/roi_conv_entry.cu",
                       "src/repro/kernels/roi_conv.py:283"),
    "roi_conv_stack": ("src/repro_torch/kernels/csrc/roi_conv_stack.cu",
                       "src/repro/kernels/roi_conv.py:435"),
    "sbnet_scatter": ("src/repro_torch/kernels/csrc/sbnet_scatter.cu",
                      "src/repro/kernels/sbnet.py:109"),
}


def say(*parts):
    print(*parts, flush=True)


def time_ms(torch, fn, reps=7):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi():
    """The card's name and power limit, one line per card, as
    ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()


def bound(nbytes, flops):
    """(least time in ms, what bounds it) for this work on the card."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# the fleet: masks, frames, detector
# ---------------------------------------------------------------------------

def build_fleet(torch, dev):
    rng = np.random.default_rng(SEED)
    grids, frames = {}, {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for g in range(GROUPS):
        grids[g], frames[g] = [], []
        for c in range(CAMS):
            h, w = CENTER_HW if c == CAMS - 1 else LEG_HW
            coarse = rng.random((-(-h // 64), -(-w // 64))) < MASK_DENSITY
            grids[g].append(np.kron(coarse, np.ones((4, 4), bool)))
            frames[g].append(torch.randn((h, w, 3), generator=gen,
                                         device=dev))
    return rng, gen, grids, frames


def build_detector(dev):
    """The default detector with weights from a seeded numpy generator."""
    from repro_torch.serving.detector import DetectorConfig, RoIDetector
    prng = np.random.default_rng(SEED + 1)
    cfg = DetectorConfig()
    chans = (3,) + tuple(cfg.channels)
    weights = [prng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)
               for ci, co in zip(chans[:-1], chans[1:])]
    head = prng.normal(size=(chans[-1], cfg.num_anchors * 5)) \
        / np.sqrt(chans[-1])
    return RoIDetector.from_numpy(cfg, weights, head, device=dev)


def with_patches(torch, frames, grids, rng, gen, amplitude):
    """The next frames: 5 of the 20 cameras get one fresh 64x64 patch at a
    random active tile (about one vehicle); ``amplitude`` lifts it above
    the gate's quantizer step for the lossy steps."""
    flat = [(g, c) for g in frames for c in range(len(frames[g]))]
    nxt = {g: list(fs) for g, fs in frames.items()}
    for k in rng.choice(len(flat), size=5, replace=False):
        g, c = flat[k]
        f = frames[g][c].clone()
        ys, xs = np.nonzero(grids[g][c])
        j = int(rng.integers(len(ys)))
        y0 = min(int(ys[j]) * TILE, f.shape[0] - PATCH)
        x0 = min(int(xs[j]) * TILE, f.shape[1] - PATCH)
        f[y0:y0 + PATCH, x0:x0 + PATCH] = amplitude + torch.randn(
            (PATCH, PATCH, 3), generator=gen, device=f.device)
        nxt[g][c] = f
    return nxt


def flat(d):
    return [x for g in d for x in d[g]]


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(torch, det, frames, frames_next, grids):
    from repro_torch.kernels import ref, roi_conv, sbnet, tile_delta
    from repro_torch.serving.detector import _head_rows

    dev = det.device
    t = TILE
    _, _, idx, nbr = det._fleet_tables(flat(grids))
    n = idx.shape[0]
    x, _, _ = det._stack_frames(flat(frames), flat(grids))
    xn, _, _ = det._stack_frames(flat(frames_next), flat(grids))
    pad = (0, 0, 1, 1, 1, 1)
    ref_c = torch.nn.functional.pad(x, pad)
    cur_p = torch.nn.functional.pad(xn, pad)
    # the distinct pixels the active tiles' haloed windows cover
    cover = torch.zeros(cur_p.shape[:3], dtype=torch.bool, device=dev)
    cover[ref.tile_index(idx, t, t, t + 2, t + 2)] = True
    win_px_padded = int(cover.sum())
    win_px_frame = int(cover[:, 1:-1, 1:-1].sum())
    w0, ws = det.weights[0], det.weights[1:]
    chans = [w0.shape[-1]] + [w.shape[-1] for w in ws]
    A = det.head.shape[-1]
    results = {}

    def record(name, err, ok, k_fn, p_fn, nbytes, flops, lib_fn=None,
               check=""):
        ms = time_ms(torch, k_fn)
        plain_ms = time_ms(torch, p_fn, reps=5)
        lib_ms = time_ms(torch, lib_fn) if lib_fn is not None else None
        b_ms, b_by = bound(nbytes, flops)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             check=check)
        say(f"[kernels] {name}: {check} max_abs_err={err} ok={ok} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}) library_ms={lib_ms} n={n}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    # B1: the gate, bit-exact
    g_k = tile_delta.tile_delta_gate_canvas(cur_p, ref_c, idx, t, t)
    g_p = ref.tile_delta_gate_canvas(cur_p, ref_c, idx, t, t)
    torch.cuda.synchronize()
    record("tile_delta_gate_canvas",
           float((g_k - g_p).abs().max()), torch.equal(g_k, g_p),
           lambda: tile_delta.tile_delta_gate_canvas(cur_p, ref_c, idx, t, t),
           lambda: ref.tile_delta_gate_canvas(cur_p, ref_c, idx, t, t),
           2 * win_px_padded * 3 * 4 + n * (3 + 8) * 4,
           3 * 2 * n * (t + 2) ** 2 * 3, check="bit-exact")
    del g_k, g_p, ref_c

    # B2: the entry conv, within CONV_TOL
    e_k = roi_conv.roi_conv_entry(x, w0, idx, t, t)
    e_p = ref.roi_conv_entry(x, w0, idx, t, t)
    err = float((e_k - e_p).abs().max())
    record("roi_conv_entry", err, err <= CONV_TOL,
           lambda: roi_conv.roi_conv_entry(x, w0, idx, t, t),
           lambda: ref.roi_conv_entry(x, w0, idx, t, t),
           win_px_frame * 3 * 4 + w0.numel() * 4 + n * 3 * 4
           + n * t * t * chans[0] * 4,
           2 * 9 * 3 * chans[0] * t * t * n, check=f"atol {CONV_TOL}")
    del e_k

    # B3: the layer stack on the plain entry output, within CONV_TOL
    s_k = roi_conv.roi_conv_stack(e_p, ws, nbr)
    s_p = ref.roi_conv_stack(e_p, ws, nbr)
    err = float((s_k - s_p).abs().max())
    flops = sum(2 * 9 * ci * co * t * t * n
                for ci, co in zip(chans[:-1], chans[1:]))
    record("roi_conv_stack", err, err <= CONV_TOL,
           lambda: roi_conv.roi_conv_stack(e_p, ws, nbr),
           lambda: ref.roi_conv_stack(e_p, ws, nbr),
           n * t * t * (chans[0] + chans[-1]) * 4 + n * 8 * 4
           + sum(w.numel() for w in ws) * 4, flops,
           check=f"atol {CONV_TOL}")
    del s_k, e_p

    # B4: the scatter of head tiles into a fresh canvas, bit-exact; the
    # library yardstick is one index_put_ with precomputed pixel indices
    ph = _head_rows(s_p, det.head)
    del s_p
    base = torch.zeros(x.shape[:3] + (A,), device=dev)
    c_k = sbnet.sbnet_scatter_fleet(ph, idx, base.clone())
    c_p = ref.sbnet_scatter_fleet(ph, idx, base.clone())
    where = ref.tile_index(idx, t, t, t, t)
    where = tuple(w.expand(n, t, t) for w in where)
    record("sbnet_scatter", float((c_k - c_p).abs().max()),
           torch.equal(c_k, c_p),
           lambda: sbnet.sbnet_scatter_fleet(ph, idx, base),
           lambda: ref.sbnet_scatter_fleet(ph, idx, base),
           2 * n * t * t * A * 4 + n * 3 * 4, 0,
           lib_fn=lambda: base.index_put_(where, ph), check="bit-exact")
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def plain_composition(torch, det, frames, grids):
    """The cold step through the plain versions: entry, stack, head, scatter."""
    from repro_torch.kernels import ref
    from repro_torch.serving.detector import _head_rows
    t = TILE
    _, _, idx, nbr = det._fleet_tables(flat(grids))
    x, _, _ = det._stack_frames(flat(frames), flat(grids))
    packed = ref.roi_conv_stack(ref.roi_conv_entry(x, det.weights[0], idx,
                                                   t, t), det.weights[1:], nbr)
    canvas = torch.zeros(x.shape[:3] + (det.head.shape[-1],), device=x.device)
    return ref.sbnet_scatter_fleet(_head_rows(packed, det.head), idx, canvas)


def drive(torch, det, rng, gen, frames, grids):
    from repro_torch.fleet.runtime import fleet_inference_step, fleet_reuse_step
    from repro_torch.serving.detector import PackedActivationCache

    cache = PackedActivationCache()
    plan = ([("cold", 0.0, None)] + [("warm", 0.0, 0.0)] * 6
            + [("static", 0.0, None)] + [("lossy", 40.0, 20.0)] * 2)
    kinds = []
    for step, (label, thr, amp) in enumerate(plan):
        if amp is not None:
            frames = with_patches(torch, frames, grids, rng, gen, amp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        outs, counts, stats = fleet_reuse_step(det, frames, grids, cache, thr)
        b.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        st = {k: v for k, v in dataclasses.asdict(stats).items()
              if k != "gate_stats"}
        say(f"[step {step}] {label} threshold={thr} wall_ms={wall_ms:.3f} "
            f"event_ms={a.elapsed_time(b):.3f} counts={dict(counts)} "
            f"stats={st}")
        kind = ("cold" if stats.cold else
                "static" if stats.computed == 0 else "changed")
        kinds.append(kind)
        if label == "cold":
            assert kind == "cold"
            want = plain_composition(torch, det, frames, grids)
            err = max(float((h - want[i, :h.shape[0], :h.shape[1]])
                            .abs().max())
                      for i, h in enumerate(flat(outs)))
            say(f"[step {step}] cold maps vs plain composition: "
                f"max_abs_err={err}")
            assert err <= CONV_TOL, err
            del want
        elif label == "warm":
            assert kind == "changed", kind
            full, fc = fleet_inference_step(det, frames, grids)
            same = all(torch.equal(h, f) for h, f in zip(flat(outs),
                                                         flat(full)))
            say(f"[step {step}] threshold-0 reuse == cold recompute "
                f"bitwise: {same} (recompute counts {dict(fc)})")
            assert same
            del full
        elif label == "static":
            assert counts == {"tile_delta_gate": 1}, counts
            assert stats.canvas_bytes == 0
        else:
            assert kind == "changed" and 0 < stats.raw_changed < \
                stats.total_tiles, stats
        for h in flat(outs):
            assert torch.isfinite(h).all()
    return kinds


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the repro_torch package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ops

    # plain versions on the card never round to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name}; nvidia-smi: {' | '.join(smi)}")
    t0 = time.perf_counter()
    _build.library()
    say(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    rng, gen, grids, frames = build_fleet(torch, dev)
    det = build_detector(dev)
    n_tiles = sum(int(g.sum()) for g in flat(grids))
    say(f"[fleet] {GROUPS} groups x {CAMS} cameras, {n_tiles} active tiles "
        f"of {TILE}x{TILE}")

    nxt = with_patches(torch, frames, grids, np.random.default_rng(SEED + 2),
                       gen, 20.0)
    results = check_kernels(torch, det, frames, nxt, grids)
    del nxt
    torch.cuda.empty_cache()

    ops.KERNEL_COUNTS.clear()
    _build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    kinds = drive(torch, det, rng, gen, frames, grids)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    say(f"[main] steps {kinds}; dispatches {dict(ops.KERNEL_COUNTS)}; "
        f"launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    rows = []
    for kname, (source, replaces) in KERNELS.items():
        r = results[kname]
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=launches.get(kname, 0),
                         **r))
        assert launches.get(kname, 0) > 0, f"{kname} never launched"
    say(json.dumps({"kernels": rows}))
    for line in smi:
        say(line)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
