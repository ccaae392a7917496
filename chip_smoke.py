#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its fleet paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code
is non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. every kernel against its plain PyTorch version on the card, at the
   main paths' shapes: the delta kernels (the canvas gate B1, the packed
   gate B5 with its windows, the per-camera tile and halo pricing B10 and
   B11) and the tile copies (the fleet scatter B4, one camera's gather and
   scatter B9) bit-exact, the convolutions (the entry B2 and its
   ReLU-free twin B7, the stack B3, each per-layer packed layer B6 over
   the fleet, one camera's B8) within 1e-4 (FMA contraction and summation
   order differ; the plain versions use no TF32); each kernel's time (CUDA
   events, median of 7) beside the plain version's and its bound.  B5's
   stats also equal B1's on the same content, B10's rows B1's body
   columns, camera by camera; ReLU of B7 is B2 and B8 is B7's rows of its
   camera, bit for bit;
3. the main path at full size -- the 4-group x 5-camera fleet at the
   paper's camera sizes (four 1920x1080 legs and one 1280x960 centre
   camera per group), default detector (channels (8, 16, 16), tile 16, 2
   anchors), RoI masks at density 0.35 on the offline 64-px grid: one
   cold step, six warm steps each giving 5 cameras a fresh 64x64 patch,
   one all-static step, two lossy warm steps at threshold 40 whose
   patches change tile interiors only, and two lossy steps with whole
   tile-aligned patches, each step through a canvas-reference cache and
   (3b) a packed-reference cache in lockstep.  Every step checks the
   runtime's dispatch structure in both modes; the warm threshold-0 steps
   are bitwise equal to a cold recompute through the kernels; the cold
   step is within 1e-4 of the plain-version composition; on the cold,
   threshold-0, all-static and interior-lossy steps the two caches give
   equal ReuseStats (gate stats included) and bitwise-equal head maps;
3c. the edge rate-control loop, on both caches: one threshold-0 step to
   align the references, then a threshold-0 step whose gate stats give
   each camera's static fraction with no launch -- equal, camera by
   camera, to ``tile_static_fraction`` through B10 -- then the halo
   fractions through B11, the rate controller on seeded (20, 10) byte
   matrices behind an uplink that congests every other camera, its
   quality trace as a (20, 2) per-camera, per-tile-class threshold table,
   and one more step under that table: the unshed cameras bitwise equal to
   a cold recompute, sub-threshold changes on the congested cameras not
   recomputed, both caches equal;
3d. the per-layer and single-camera paths on the same fleet:
   ``fleet_forward_layers`` (B7, then B6 + ReLU per layer, B4) bitwise
   equal to ``fleet_forward`` (B2 + B3 + B4); for each of the 20 cameras
   ``roi_forward`` (B2 + B3 + B9's scatter, the frame padded to its grid)
   bitwise equal to ``roi_forward_layers`` (B8, B6 + ReLU, B9), to the
   one-camera ``fleet_forward`` and to the fleet's map; each path's
   dispatches as the JAX package's; ``forward`` on the RoI path at density
   0.35 and on the dense path with an all-true grid (within 1e-4 of
   ``roi_forward`` there, on the leg padded to its grid);
   ``roi_conv_batched`` over a group's four legs with one mask, one
   launch, bitwise equal to B8 frame by frame; B9's
   gather taking the RoI tiles of a full-frame SAME conv (``F.conv2d``,
   no TF32), within 1e-4 of B8, and of each ``roi_forward`` map, bitwise
   equal to the packed head rows;
4. a ``kernels`` JSON line with each kernel's launches on its path (B1-B5
   on the fleet path of phases 3 and 3b, B10 and B11 on the rate-control
   loop, B6-B9 on phase 3d's paths), each path driven with the counts set
   to 0.

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

CSRC = "src/repro_torch/kernels/csrc/"
GATE_CU = CSRC + "tile_delta_gate.cu"
DELTA_CU = CSRC + "tile_delta.cu"
ENTRY_CU = CSRC + "roi_conv_entry.cu"
SBNET_CU = CSRC + "sbnet.cu"
KERNELS = {
    "tile_delta_gate_canvas": (GATE_CU, "src/repro/kernels/tile_delta.py:280"),
    "tile_delta_gate": (GATE_CU, "src/repro/kernels/tile_delta.py:198"),
    "tile_delta": (DELTA_CU, "src/repro/kernels/tile_delta.py:94"),
    "tile_delta_halo": (DELTA_CU, "src/repro/kernels/tile_delta.py:361"),
    "roi_conv_entry": (ENTRY_CU, "src/repro/kernels/roi_conv.py:283"),
    "roi_conv_stack": (CSRC + "roi_conv_stack.cu",
                       "src/repro/kernels/roi_conv.py:435"),
    "sbnet_scatter_fleet": (SBNET_CU, "src/repro/kernels/sbnet.py:109"),
    "roi_conv_packed": (CSRC + "roi_conv_packed.cu",
                        "src/repro/kernels/roi_conv.py:519"),
    "roi_conv_fleet": (ENTRY_CU, "src/repro/kernels/roi_conv.py:160"),
    "roi_conv": (ENTRY_CU, "src/repro/kernels/roi_conv.py:68"),
    "sbnet_gather": (SBNET_CU, "src/repro/kernels/sbnet.py:35"),
    "sbnet_scatter": (SBNET_CU, "src/repro/kernels/sbnet.py:58"),
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


def with_patches(torch, frames, grids, rng, gen, amplitude,
                 interior=False):
    """The next frames: 5 of the 20 cameras get one fresh 64x64 patch at a
    random active tile (about one vehicle); ``amplitude`` lifts it above
    the gate's quantizer step for the lossy steps.  ``interior`` places the
    patch on the tile grid and keeps each covered tile's 2-pixel rim as it
    was: the motion stays inside tile interiors, where the canvas and
    packed reference modes agree at every threshold."""
    flat = [(g, c) for g in frames for c in range(len(frames[g]))]
    nxt = {g: list(fs) for g, fs in frames.items()}
    for k in rng.choice(len(flat), size=5, replace=False):
        g, c = flat[k]
        f = frames[g][c].clone()
        ys, xs = np.nonzero(grids[g][c])
        j = int(rng.integers(len(ys)))
        hi_y, hi_x = f.shape[0] - PATCH, f.shape[1] - PATCH
        if interior:
            hi_y, hi_x = hi_y // TILE * TILE, hi_x // TILE * TILE
        y0 = min(int(ys[j]) * TILE, hi_y)
        x0 = min(int(xs[j]) * TILE, hi_x)
        patch = amplitude + torch.randn((PATCH, PATCH, 3), generator=gen,
                                        device=f.device)
        region = f[y0:y0 + PATCH, x0:x0 + PATCH]
        if interior:
            lane = torch.arange(PATCH, device=f.device) % TILE
            keep = (lane >= 2) & (lane < TILE - 2)
            patch = torch.where((keep[:, None] & keep[None, :])[..., None],
                                patch, region)
        region.copy_(patch)
        nxt[g][c] = f
    return nxt


def flat(d):
    return [x for g in d for x in d[g]]


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def check_kernels(torch, det, frames, frames_next, grids):
    from repro_torch.kernels import ops, ref, roi_conv, sbnet, tile_delta
    from repro_torch.net.encoder import pad_to_grid
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
    del g_p

    # B5: the packed gate against the previous frame's windows, bit-exact
    # in its stats and its windows; on this content its stats are B1's
    ref_win = ref.gather_windows(ref_c, idx, t, t)
    s_k, w_k = tile_delta.tile_delta_gate(cur_p, ref_win, idx, t, t)
    s_p, w_p = ref.tile_delta_gate(cur_p, ref_win, idx, t, t)
    torch.cuda.synchronize()
    win_bytes = n * (t + 2) ** 2 * 3 * 4
    record("tile_delta_gate",
           max(float((s_k - s_p).abs().max()),
               float((w_k - w_p).abs().max())),
           torch.equal(s_k, s_p) and torch.equal(w_k, w_p)
           and torch.equal(s_k, g_k),
           lambda: tile_delta.tile_delta_gate(cur_p, ref_win, idx, t, t),
           lambda: ref.tile_delta_gate(cur_p, ref_win, idx, t, t),
           win_px_padded * 3 * 4 + 2 * win_bytes + n * (3 + 8) * 4,
           3 * 2 * n * (t + 2) ** 2 * 3,
           check="bit-exact (stats, windows; stats == B1's)")
    del s_k, w_k, s_p, w_p, ref_win, ref_c

    # B10, B11: each camera's frame pair, padded to its grid's extent;
    # B10's rows are B1's body columns on the camera's tiles
    pairs = []
    for c, (fc, fp, gr) in enumerate(zip(flat(frames_next), flat(frames),
                                         flat(grids))):
        a, b = pad_to_grid(fc, fp, gr.shape, t)
        rows = torch.as_tensor(ops.mask_to_indices(gr), device=dev)
        pairs.append((a, b, rows))
    cam = idx[:, 0]

    def per_camera(fn):
        return [fn(a, b, rows, t, t) for a, b, rows in pairs]

    for name, k_fn, p_fn, px in (
            ("tile_delta", tile_delta.tile_delta, ref.tile_delta, t * t),
            ("tile_delta_halo", tile_delta.tile_delta_halo,
             ref.tile_delta_halo, 4 * t - 4)):
        got, want = per_camera(k_fn), per_camera(p_fn)
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        if name == "tile_delta":
            ok = ok and all(torch.equal(a[:, :4], g_k[cam == c, :4])
                            for c, a in enumerate(got))
        record(name, max(float((a - b).abs().max()) for a, b in
                         zip(got, want) if a.numel()), ok,
               lambda: per_camera(k_fn), lambda: per_camera(p_fn),
               n * (2 * px * 3 * 4 + (2 + 8) * 4),
               3 * n * (t * t if name == "tile_delta" else 4 * t) * 3,
               check=f"bit-exact, {len(pairs)} cameras" + (
                   " (== B1's body columns)" if name == "tile_delta"
                   else ""))
    del pairs, g_k

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

    # B7: the entry without ReLU, within CONV_TOL; its ReLU is B2's bits
    f_k = roi_conv.roi_conv_fleet(x, w0, idx, t, t)
    f_p = ref.roi_conv_fleet(x, w0, idx, t, t)
    err = float((f_k - f_p).abs().max())
    same = torch.equal(torch.relu(f_k), e_k)
    del e_k, f_p
    record("roi_conv_fleet", err, err <= CONV_TOL and same,
           lambda: roi_conv.roi_conv_fleet(x, w0, idx, t, t),
           lambda: ref.roi_conv_fleet(x, w0, idx, t, t),
           win_px_frame * 3 * 4 + w0.numel() * 4 + n * 3 * 4
           + n * t * t * chans[0] * 4,
           2 * 9 * 3 * chans[0] * t * t * n,
           check=f"atol {CONV_TOL}; ReLU == B2 bitwise: {same}")

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
    del s_k

    # B6: each later layer of the per-layer chain on the plain ReLU'd
    # input, within CONV_TOL; timed as the chain's launches for all of them
    ins = [e_p]
    for w in ws[:-1]:
        ins.append(torch.relu(ref.roi_conv_packed(ins[-1], w, nbr)))
    err = 0.0
    for a, w in zip(ins, ws):
        err = max(err, float((roi_conv.roi_conv_packed(a, w, nbr)
                              - ref.roi_conv_packed(a, w, nbr)).abs().max()))
    layer_ms = [time_ms(torch, lambda a=a, w=w:
                        roi_conv.roi_conv_packed(a, w, nbr))
                for a, w in zip(ins, ws)]
    record("roi_conv_packed", err, err <= CONV_TOL,
           lambda: [roi_conv.roi_conv_packed(a, w, nbr)
                    for a, w in zip(ins, ws)],
           lambda: [ref.roi_conv_packed(a, w, nbr) for a, w in zip(ins, ws)],
           sum(n * t * t * (ci + co) * 4 + n * 8 * 4 + w.numel() * 4
               for ci, co, w in zip(chans[:-1], chans[1:], ws)), flops,
           check=f"atol {CONV_TOL}, {len(ws)} layers "
                 f"{chans[0]}->{'->'.join(map(str, chans[1:]))}, per layer "
                 f"ms {[round(v, 4) for v in layer_ms]}")
    del ins, e_p

    # B4: the scatter of head tiles into a fresh canvas, bit-exact; the
    # library yardstick is one index_put_ with precomputed pixel indices
    ph = _head_rows(s_p, det.head)
    del s_p
    base = torch.zeros(x.shape[:3] + (A,), device=dev)
    c_k = sbnet.sbnet_scatter_fleet(ph, idx, base.clone())
    c_p = ref.sbnet_scatter_fleet(ph, idx, base.clone())
    where = ref.tile_index(idx, t, t, t, t)
    where = tuple(w.expand(n, t, t) for w in where)
    record("sbnet_scatter_fleet", float((c_k - c_p).abs().max()),
           torch.equal(c_k, c_p),
           lambda: sbnet.sbnet_scatter_fleet(ph, idx, base),
           lambda: ref.sbnet_scatter_fleet(ph, idx, base),
           2 * n * t * t * A * 4 + n * 3 * 4, 0,
           lib_fn=lambda: base.index_put_(where, ph), check="bit-exact")
    del base, where

    # B8 and B9 on one 1920x1080 leg, padded to its grid's extent (1088
    # rows), as ``roi_forward`` hands it over
    leg, leg_grid = flat(frames)[0], flat(grids)[0]
    xl = det._stack_frames([leg], [leg_grid])[0][0]
    rows = torch.as_tensor(ops.mask_to_indices(leg_grid), device=dev)
    n1 = rows.shape[0]
    cam0 = idx[:, 0] == 0
    cover = torch.zeros((xl.shape[0] + 2, xl.shape[1] + 2), dtype=torch.bool,
                        device=dev)
    cover[ref.tile_index(torch.nn.functional.pad(rows, (1, 0)), t, t,
                         t + 2, t + 2)[1:]] = True
    leg_px = int(cover[1:-1, 1:-1].sum())
    o_k = roi_conv.roi_conv(xl, w0, rows, t, t)
    err = float((o_k - ref.roi_conv(xl, w0, rows, t, t)).abs().max())
    same = torch.equal(o_k, f_k[cam0])
    del f_k
    record("roi_conv", err, err <= CONV_TOL and same,
           lambda: roi_conv.roi_conv(xl, w0, rows, t, t),
           lambda: ref.roi_conv(xl, w0, rows, t, t),
           leg_px * 3 * 4 + w0.numel() * 4 + n1 * 2 * 4
           + n1 * t * t * chans[0] * 4, 2 * 9 * 3 * chans[0] * t * t * n1,
           check=f"atol {CONV_TOL}; == B7's rows of camera 0 bitwise: "
                 f"{same}; {n1} tiles")

    # B9 on the leg's plane of B4's canvas: the gather gives back B4's
    # head tiles; the library yardsticks index with precomputed pixels
    hm = c_k[0]
    where1 = tuple(w.expand(n1, t, t) for w in ref.tile_index(
        torch.nn.functional.pad(rows, (1, 0)), t, t, t, t)[1:])
    g_k = sbnet.sbnet_gather(hm, rows, t, t)
    g_p = ref.sbnet_gather(hm, rows, t, t)
    ok = torch.equal(g_k, g_p) and torch.equal(g_k, ph[cam0])
    copy_bytes = 2 * n1 * t * t * A * 4 + n1 * 2 * 4
    record("sbnet_gather", float((g_k - g_p).abs().max()), ok,
           lambda: sbnet.sbnet_gather(hm, rows, t, t),
           lambda: ref.sbnet_gather(hm, rows, t, t), copy_bytes, 0,
           lib_fn=lambda: hm[where1],
           check=f"bit-exact (== B4's head tiles); {n1} tiles")
    base1 = torch.zeros_like(hm)
    s_k = sbnet.sbnet_scatter(g_k, rows, base1.clone())
    s_p = ref.sbnet_scatter(g_k, rows, base1.clone())
    record("sbnet_scatter", float((s_k - s_p).abs().max()),
           torch.equal(s_k, s_p),
           lambda: sbnet.sbnet_scatter(g_k, rows, base1),
           lambda: ref.sbnet_scatter(g_k, rows, base1), copy_bytes, 0,
           lib_fn=lambda: base1.index_put_(where1, g_k),
           check=f"bit-exact; {n1} tiles")
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


# (label, threshold, patch amplitude or None for no new frame, interior)
PLAN = ([("cold", 0.0, None, False)] + [("warm", 0.0, 0.0, False)] * 6
        + [("static", 0.0, None, False)]
        + [("interior", 40.0, 20.0, True)] * 2
        + [("lossy", 40.0, 20.0, False)] * 2)
# the steps on which the canvas and packed reference modes agree by
# definition: no gate, exact gates, and lossy gates on interior motion
SAME_IN_BOTH_MODES = {"cold", "warm", "static", "interior"}


def timed_step(torch, det, frames, grids, cache, thr, tag, step, label):
    """One ``fleet_reuse_step``, timed (host clock around work that ends in
    a synchronize, and CUDA events) and printed."""
    from repro_torch.fleet.runtime import fleet_reuse_step
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
    shown = thr if np.ndim(thr) == 0 else f"table{np.shape(thr)}"
    say(f"[{tag} {step}] {label} threshold={shown} wall_ms={wall_ms:.3f} "
        f"event_ms={a.elapsed_time(b):.3f} counts={dict(counts)} "
        f"stats={st}")
    for h in flat(outs):
        assert torch.isfinite(h).all()
    return outs, counts, stats


def step_kind(stats):
    return ("cold" if stats.cold else
            "static" if stats.computed == 0 else "changed")


def check_kind(label, counts, stats):
    """The step kind the plan asks for, and its dispatch structure."""
    kind = step_kind(stats)
    if label == "cold":
        assert kind == "cold", kind
    elif label == "warm":
        assert kind == "changed", kind
    elif label == "static":
        assert counts == {"tile_delta_gate": 1}, counts
        assert stats.canvas_bytes == 0
    else:
        assert kind == "changed" and 0 < stats.raw_changed < \
            stats.total_tiles, stats
    return kind


def same_stats(a, b) -> bool:
    """Equal ReuseStats, the gate's stats rows included."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "gate_stats":
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def equals_recompute(torch, det, frames, grids, outs, cams=None):
    """Whether the head maps of ``cams`` (all by default) are bitwise
    equal to a cold recompute through the kernels."""
    from repro_torch.fleet.runtime import fleet_inference_step
    full, fc = fleet_inference_step(det, frames, grids)
    pairs = list(zip(flat(outs), flat(full)))
    cams = range(len(pairs)) if cams is None else cams
    return all(torch.equal(*pairs[c]) for c in cams), dict(fc)


def step_both(torch, det, frames, grids, caches, thr, tag, step, label,
              compare=True):
    """One step of the canvas and the packed cache on the same frames;
    with ``compare``, both give equal counts, ReuseStats and head maps.
    Returns {mode: (outs, counts, stats)}."""
    res = {m: timed_step(torch, det, frames, grids, c, thr, f"{tag}/{m}",
                         step, label)
           for m, c in caches.items()}
    if compare:
        (_, c_counts, c_st), (_, p_counts, p_st) = \
            res["canvas"], res["packed"]
        same = (c_counts == p_counts and same_stats(c_st, p_st)
                and torch.equal(caches["canvas"].canvas,
                                caches["packed"].canvas))
        say(f"[{tag} {step}] canvas == packed (counts, ReuseStats, head "
            f"maps bitwise): {same}")
        assert same
    return res


def drive(torch, det, rng, gen, frames, grids, caches):
    """Phases 3 and 3b: the plan's steps through the canvas and the packed
    cache in lockstep.  Returns the last frames and the step kinds."""
    kinds = []
    for step, (label, thr, amp, interior) in enumerate(PLAN):
        if amp is not None:
            frames = with_patches(torch, frames, grids, rng, gen, amp,
                                  interior)
        res = step_both(torch, det, frames, grids, caches, thr, "step", step,
                        label, compare=label in SAME_IN_BOTH_MODES)
        step_kinds = {m: check_kind(label, counts, stats)
                      for m, (_, counts, stats) in res.items()}
        assert step_kinds["canvas"] == step_kinds["packed"], step_kinds
        kinds.append(step_kinds["canvas"])
        outs = res["canvas"][0]
        if label == "cold":
            want = plain_composition(torch, det, frames, grids)
            err = max(float((h - want[i, :h.shape[0], :h.shape[1]])
                            .abs().max())
                      for i, h in enumerate(flat(outs)))
            say(f"[step {step}] cold maps vs plain composition: "
                f"max_abs_err={err}")
            assert err <= CONV_TOL, err
            del want
        elif label == "warm":
            same, fc = equals_recompute(torch, det, frames, grids, outs)
            say(f"[step {step}] threshold-0 reuse == cold recompute "
                f"bitwise: {same} (recompute counts {fc})")
            assert same
    return frames, kinds


def rate_control_loop(torch, det, rng, gen, frames, grids, caches):
    """Phase 3c, the edge rate-control loop on both caches."""
    from repro_torch.kernels import ops
    from repro_torch.net import (RateControlConfig, gate_threshold_schedule,
                                 rate_controlled_departures,
                                 static_fraction_from_stats,
                                 tile_halo_static_fraction,
                                 tile_static_fraction)

    def both(frames, thr, step, label):
        res = step_both(torch, det, frames, grids, caches, thr, "rate", step,
                        label)
        return res["canvas"][0], res["canvas"][2]

    # align the references: a threshold-0 step advances every row
    frames = with_patches(torch, frames, grids, rng, gen, 0.0)
    outs, st = both(frames, 0.0, 0, "align")
    assert step_kind(st) == "changed"
    same, _ = equals_recompute(torch, det, frames, grids, outs)
    say(f"[rate 0] threshold-0 reuse == cold recompute bitwise: {same}")
    assert same

    # the fractions: the gate's own stats rows (no launch) against B10
    prev = frames
    frames = with_patches(torch, frames, grids, rng, gen, 20.0)
    _, st = both(frames, 0.0, 1, "fractions")
    assert step_kind(st) == "changed"
    cam = caches["canvas"].idx_np[:, 0]
    n_cams = len(flat(grids))
    # the fleet packing is camera-major: camera c's rows are one range
    bounds = np.searchsorted(cam, np.arange(n_cams + 1))
    triples = list(zip(flat(frames), flat(prev), flat(grids)))

    def host_ms(fn):
        """Host wall of ``fn``, ending in a synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with ops.count_kernels() as fast:
        fast_f, fast_ms = host_ms(lambda: [
            static_fraction_from_stats(st.gate_stats[bounds[c]:bounds[c + 1]],
                                       3, TILE) for c in range(n_cams)])
    with ops.count_kernels() as slow:
        body_f, body_ms = host_ms(lambda: [
            tile_static_fraction(a, b, g, TILE) for a, b, g in triples])
        halo_f, halo_ms = host_ms(lambda: [
            tile_halo_static_fraction(a, b, g, TILE) for a, b, g in triples])
    say(f"[rate 1] static fractions from the gate stats ({dict(fast)} "
        f"dispatches, {fast_ms:.3f} ms) == tile_static_fraction through "
        f"B10 ({dict(slow)}; {body_ms:.3f} ms, the halo fractions "
        f"{halo_ms:.3f} ms): {fast_f == body_f}; body "
        f"{np.round(body_f, 4)}; halo {np.round(halo_f, 4)}")
    assert sum(fast.values()) == 0 and fast_f == body_f
    assert slow == {"tile_delta": n_cams, "tile_delta_halo": n_cams}, slow
    assert min(body_f) < 1.0

    # the rate controller behind an uplink that congests every other
    # camera, and its quality trace as per-camera, per-class thresholds
    prng = np.random.default_rng(SEED + 3)
    S = 10
    body = prng.uniform(2e4, 6e4, (n_cams, S))
    halo = prng.uniform(0.1, 0.4, (n_cams, S)) * body
    headers = np.full((n_cams, S), 240.0)
    arrivals = np.arange(S)[None, :] + prng.uniform(0, 0.2, (n_cams, 1))
    congested = np.arange(n_cams) % 2 == 1
    bw = np.where(congested[:, None], 2e4, 1e7) \
        * prng.uniform(0.8, 1.2, (n_cams, S))
    rc = RateControlConfig(enabled=True, static_fraction=np.array(body_f),
                           halo_static_fraction=np.array(halo_f))
    _, sent, quality, shed_h, shed_b = rate_controlled_departures(
        arrivals, body, halo, headers, bw, rc)
    thr = gate_threshold_schedule(quality, TILE, 3, gain=0.5, halo_gain=0.25)
    unshed = np.nonzero((thr == 0).all(axis=1))[0]
    say(f"[rate 2] quality min per camera {np.round(quality.min(axis=1), 4)}"
        f"; shed bytes halo {shed_h.sum():.1f} body {shed_b.sum():.1f} of "
        f"{(body + halo + headers).sum():.1f}; thresholds {thr.shape} "
        f"{np.round(thr[congested][0], 4)} on congested cameras, 0 on "
        f"{len(unshed)} cameras")
    assert thr.shape == (n_cams, 2)
    assert (thr[congested] > 0).all() and list(unshed) == \
        list(np.nonzero(~congested)[0])

    # one more step under the table: fresh sub-threshold patches
    frames = with_patches(torch, frames, grids, rng, gen, 0.0)
    outs, st = both(frames, thr, 2, "schedule")
    exact = st.gate_stats[:, ops.GATE_WIN_EXACT] > 0
    exact_congested = int(exact[congested[cam]].sum())
    # the unshed cameras gate exactly, so every raw-changed row beyond
    # their exact changes lies on a congested camera
    raw_congested = st.raw_changed - int(exact[~congested[cam]].sum())
    same, _ = equals_recompute(torch, det, frames, grids, outs, unshed)
    say(f"[rate 2] under the schedule: {st.raw_changed} raw-changed rows "
        f"of {int(exact.sum())} that changed at all; on congested cameras "
        f"{raw_congested} raw-changed of {exact_congested} changed; the "
        f"{len(unshed)} unshed cameras == cold recompute bitwise: {same}")
    assert same
    assert exact_congested > 0 and 0 <= raw_congested < exact_congested, \
        "the congested cameras' thresholds did not take effect"


FUSED = {"roi_conv_entry": 1, "roi_conv_stack": 1}
LAYERS = {"roi_conv_packed": 2}
# each path's dispatches, as the JAX package's detector counts them
STRUCTURE = {
    "fleet_forward": {**FUSED, "sbnet_scatter_fleet": 1},
    "fleet_forward_layers": {"roi_conv_fleet": 1, **LAYERS,
                             "sbnet_scatter_fleet": 1},
    "roi_forward": {**FUSED, "sbnet_scatter": 1},
    "roi_forward_layers": {"roi_conv": 1, **LAYERS, "sbnet_scatter": 1},
}


def layer_paths(torch, det, frames, grids):
    """Phase 3d: the per-layer and single-camera paths against the fused
    ones, bitwise, with their dispatch structures; the density switch;
    the batched single-camera conv; B9's gather on B8's oracle and on the
    head maps."""
    from repro_torch.kernels import ops
    from repro_torch.serving.detector import _head_rows
    t = TILE
    w0 = det.weights[0]
    walls = {}

    def run(name, fn, *args):
        """``fn(*args)`` with its dispatches (checked against the path's
        structure when it has one) and its host wall, ending in a
        synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ops.count_kernels() as c:
            out = fn(*args)
        torch.cuda.synchronize()
        walls.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        if name in STRUCTURE:
            assert dict(c) == STRUCTURE[name], (name, dict(c))
        return out, dict(c)

    fl_f, fl_g = flat(frames), flat(grids)
    fused, _ = run("fleet_forward", det.fleet_forward, fl_f, fl_g)
    layers, _ = run("fleet_forward_layers", det.fleet_forward_layers, fl_f,
                    fl_g)
    same = all(torch.equal(a, b) for a, b in zip(fused, layers))
    say(f"[layers] fleet_forward_layers == fleet_forward bitwise over "
        f"{sum(int(g.sum()) for g in fl_g)} tiles: {same}; walls "
        f"{walls['fleet_forward'][0]:.3f} / "
        f"{walls['fleet_forward_layers'][0]:.3f} ms")
    assert same
    del layers

    for c, (f, g) in enumerate(zip(fl_f, fl_g)):
        # the first call builds the camera's tables on the host
        one, _ = run("roi_forward", det.roi_forward, f, g)
        lay, _ = run("roi_forward_layers", det.roi_forward_layers, f, g)
        again, _ = run("roi_forward", det.roi_forward, f, g)
        solo, _ = run("fleet_forward", det.fleet_forward, [f], [g])
        same = (torch.equal(one, lay) and torch.equal(one, again)
                and torch.equal(one, solo[0]) and torch.equal(one, fused[c]))
        assert tuple(one.shape) == tuple(f.shape[:2]) + (det.head.shape[-1],)
        assert torch.isfinite(one).all()
        if not same:
            raise AssertionError(f"camera {c}: roi_forward, "
                                 f"roi_forward_layers and fleet_forward "
                                 f"differ")
    say(f"[layers] {len(fl_f)} cameras: roi_forward == roi_forward_layers == "
        f"one-camera fleet_forward == the fleet's map, bitwise: True; walls "
        f"ms roi_forward, tables built "
        f"{np.round(walls['roi_forward'][0::2], 3).tolist()}, cached "
        f"{np.round(walls['roi_forward'][1::2], 3).tolist()}; "
        f"roi_forward_layers "
        f"{np.round(walls['roi_forward_layers'], 3).tolist()}; one-camera "
        f"fleet_forward {np.round(walls['fleet_forward'][1:], 3).tolist()}")

    # the density switch, on the first leg; the dense check runs on the
    # leg padded to its grid (1088 rows), where the RoI path's tiles lie
    f0, g0 = fl_f[0], fl_g[0]
    r, rc = run("forward (RoI)", det.forward, f0, g0)
    assert rc == STRUCTURE["roi_forward"] and torch.equal(r, fused[0]), rc
    all_true = np.ones_like(g0)
    f0p = det._stack_frames([f0], [g0])[0][0]
    d, dc = run("forward (dense)", det.forward, f0p, all_true)
    want, _ = run("roi_forward", det.roi_forward, f0p, all_true)
    err = float((d - want).abs().max())
    say(f"[layers] forward: density {g0.mean():.3f} -> {rc}; all-true grid "
        f"-> dense, {dc} dispatches, max_abs_err vs roi_forward {err}")
    assert dc == {} and err <= CONV_TOL
    del fused, d, want, f0p

    # roi_conv_batched: the first group's four legs under one shared mask
    legs = frames[0][:4]
    xs, _, _ = det._stack_frames(legs, [g0] * len(legs))
    idx, idx3, nbr = det._mask_tables(g0)
    batch, bc = run("roi_conv_batched", ops.roi_conv_batched, xs, w0, idx, t,
                    t)
    per = [run("roi_conv", ops.roi_conv, xs[b], w0, idx, t, t)[0]
           for b in range(len(legs))]
    same = all(torch.equal(batch[b], per[b]) for b in range(len(legs)))
    say(f"[layers] roi_conv_batched over {len(legs)} legs, one mask: "
        f"{bc}; == B8 frame by frame bitwise: {same}")
    assert bc == {"roi_conv": 1} and same

    # B8's defining oracle: the RoI tiles of the full-frame SAME conv
    full = torch.nn.functional.conv2d(
        xs[0].permute(2, 0, 1)[None], w0.permute(3, 2, 0, 1), padding=1)
    full = full[0].permute(1, 2, 0).contiguous()
    tiles, gc = run("sbnet_gather", ops.sbnet_gather, full, idx, t, t)
    err = float((tiles - per[0]).abs().max())
    say(f"[layers] B9 gather of the full-frame F.conv2d (no TF32) vs B8: "
        f"{gc}, max_abs_err {err}")
    assert gc == {"sbnet_gather": 1} and err <= CONV_TOL
    del batch, per, full, tiles, xs

    # gather o scatter: each map, zero-padded to its grid, gathered at its
    # RoI tiles gives back the packed head rows (zero below the frame)
    for f, g in zip(fl_f, fl_g):
        idx, idx3, nbr = det._mask_tables(g)
        xs1, ch, cw = det._stack_frames([f], [g])
        ph = _head_rows(det._stack_chain(xs1, idx3, nbr), det.head)
        ys = idx[:, 0, None].long() * t + torch.arange(t, device=idx.device)
        ph[ys >= f.shape[0]] = 0
        hm = torch.zeros((ch, cw, ph.shape[-1]), device=ph.device)
        hm[:f.shape[0], :f.shape[1]] = det.roi_forward(f, g)
        back, _ = run("sbnet_gather", ops.sbnet_gather, hm, idx, t, t)
        if not torch.equal(back, ph):
            raise AssertionError("gather of roi_forward's map != head rows")
    say(f"[layers] {len(fl_f)} cameras: B9 gather of roi_forward's map == "
        f"the packed head rows bitwise: True")
    return walls


def run_path(torch, fn, *args):
    """Drive one path with every count set to 0 just before it; returns
    (its result, kernel launches, dispatches, peak GiB)."""
    from repro_torch.kernels import _build, ops
    torch.cuda.synchronize()
    ops.KERNEL_COUNTS.clear()
    _build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, dict(_build.LAUNCHES), dict(ops.KERNEL_COUNTS),
            torch.cuda.max_memory_allocated() / 2 ** 30)


# the path each kernel's ``launches`` is read from
PATH_OF = {"tile_delta": "rate", "tile_delta_halo": "rate",
           **{k: "layers" for k in ("roi_conv_packed", "roi_conv_fleet",
                                    "roi_conv", "sbnet_gather",
                                    "sbnet_scatter")}}


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
    from repro_torch.kernels import _build

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

    from repro_torch.serving.detector import PackedActivationCache
    caches = {"canvas": PackedActivationCache(),
              "packed": PackedActivationCache(ref_mode="packed")}
    launches = {}
    (frames, kinds), launches["fleet"], disp, peak = run_path(
        torch, drive, torch, det, rng, gen, frames, grids, caches)
    say(f"[main] fleet path, canvas and packed caches in lockstep: steps "
        f"{kinds}; dispatches {disp}; launches {launches['fleet']}; peak "
        f"memory {peak:.2f} GiB; ref_win "
        f"{caches['packed'].ref_win.numel() * 4 / 2 ** 30:.3f} GiB against "
        f"the reference canvas "
        f"{caches['canvas'].ref_canvas.numel() * 4 / 2 ** 30:.3f} GiB")
    torch.cuda.empty_cache()
    _, launches["rate"], disp, peak = run_path(
        torch, rate_control_loop, torch, det, rng, gen, frames, grids,
        caches)
    say(f"[main] rate-control loop: dispatches {disp}; launches "
        f"{launches['rate']}; peak memory {peak:.2f} GiB")
    del caches
    torch.cuda.empty_cache()
    _, launches["layers"], disp, peak = run_path(
        torch, layer_paths, torch, det, frames, grids)
    say(f"[main] per-layer and single-camera paths: dispatches {disp}; "
        f"launches {launches['layers']}; peak memory {peak:.2f} GiB")

    rows = []
    for kname, (source, replaces) in KERNELS.items():
        path = PATH_OF.get(kname, "fleet")
        n_launch = launches[path].get(kname, 0)
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=n_launch, path=path,
                         **results[kname]))
        assert n_launch > 0, f"{kname} never launched on the {path} path"
    say(json.dumps({"kernels": rows}))
    for line in smi:
        say(line)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
