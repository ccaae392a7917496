"""The fleet driver: CrossRoI's online step on frozen offline masks.

Set-up draws the detector's weights on the device from the seed, reads
the configuration's frozen masks, builds the traffic generator and runs
the mix's warm-up steps through the program's entry, so the first step
(cold: the fleet tables on these masks, the kernel library's build or
load) and every launch bucket the traffic reaches are paid before the
window.  The window is a closed loop: the generator writes the next
fleet snapshot, the host waits for it, and hands it to
``repro_torch.fleet.runtime.fleet_reuse_step`` over one
``PackedActivationCache``; a step ends when its maps are ready after a
synchronize, and the next snapshot follows at once: the server at
saturation.

``correct`` compares the head maps the timed steps produced with the
plain reference (``portbench/reference.py``) recomputed from the same
frames: every camera of the window's last step, whose canvas holds what
every earlier step left in it, and a sample of (step, camera) maps drawn
from the seed over the whole window (reservoir sampling), copied to host
memory as they were produced.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from portbench import harness, reference, tracing, yardstick
from portbench.traffic import CameraTraffic, seed_of, tracks_boxes

_WEIGHTS = 11   # domain tag of the detector's weights
_SAMPLE = 12    # ... and of the compared maps' sample


@dataclass
class FleetRun:
    """The records a run's metric readers read."""
    device_name: str
    config: dict
    grids: list                   # each flat camera's tile grid
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0               # camera frames served in the window
    step_s: List[float] = field(default_factory=list)
    # the window steps the profiler was on for (slowed by it)
    traced_i: List[int] = field(default_factory=list)
    # per window step: (active tiles, computed, launched, cold)
    steps: List[tuple] = field(default_factory=list)
    peak_mem_bytes: int = 0
    trace: Optional[tracing.DeviceTrace] = None
    traced_needed: List[int] = field(default_factory=list)


def load_fleet(root, config):
    """({gid: [per-camera tile grid]}, [(H, W) per flat camera]) from the
    configuration's frozen masks, expanded to ``tile_px`` tiles."""
    masks = harness.load_json(root, config["masks"])
    k = masks["cell_px"] // config["tile_px"]
    grids, hw = {}, []
    for cam in masks["cameras"]:
        coarse = np.array([[ch == "1" for ch in row] for row in cam["rows"]],
                          bool)
        grids.setdefault(cam["group"], []).append(
            np.kron(coarse, np.ones((k, k), bool)))
        hw.append((cam["height"], cam["width"]))
    if [list(v) for v in hw] != [list(v) for _ in grids
                                 for v in config["camera_hw"]]:
        raise ValueError("the masks' cameras are not the configuration's")
    return grids, hw


def draw_weights(det_cfg: dict, seed: int, device):
    """HWIO conv weights and the (C, A) head, drawn on ``device`` in one
    call from the seed, scaled as the program's own initialisation."""
    chans = (3,) + tuple(det_cfg["channels"])
    outputs = det_cfg["num_anchors"] * det_cfg["head_outputs_per_anchor"]
    shapes = [(3, 3, ci, co) for ci, co in zip(chans[:-1], chans[1:])]
    shapes.append((chans[-1], outputs))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, _WEIGHTS))
    flat = torch.randn(sum(int(np.prod(s)) for s in shapes), generator=gen,
                       device=device)
    parts = torch.split(flat, [int(np.prod(s)) for s in shapes])
    ws = [p.view(s) / float(np.sqrt(9 * s[2]))
          for p, s in zip(parts[:-1], shapes[:-1])]
    head = parts[-1].view(shapes[-1]) / float(np.sqrt(chans[-1]))
    return ws, head


class MapSampler:
    """A uniform sample of ``k`` (step, camera) head maps over a window of
    unknown length (reservoir sampling, draws from the seed), each copied
    off the device as it is produced."""

    def __init__(self, k: int, seed: int, camera_hw, n_outputs: int,
                 device):
        self.k = k
        self.rng = np.random.default_rng(seed_of(seed, _SAMPLE))
        self.kept: List[tuple] = []          # (step, camera, host map)
        pin = torch.device(device).type == "cuda"
        size = max(h * w for h, w in camera_hw) * n_outputs
        self.buffers = [torch.empty(size, dtype=torch.float32,
                                    pin_memory=pin) for _ in range(k)]
        self.hw = camera_hw
        self.n_outputs = n_outputs
        self.seen = 0

    def offer(self, t: int, maps) -> None:
        """Step ``t``'s maps (one per flat camera) are produced."""
        self.seen += 1
        if len(self.kept) < self.k:
            slot = len(self.kept)
            self.kept.append(None)
        else:
            slot = int(self.rng.integers(self.seen))
            if slot >= self.k:
                return
        c = int(self.rng.integers(len(maps)))
        h, w = self.hw[c]
        buf = self.buffers[slot][:h * w * self.n_outputs] \
            .view(h, w, self.n_outputs)
        buf.copy_(maps[c], non_blocking=True)
        self.kept[slot] = (t, c, buf)


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(cell: dict, config: dict, traffic_params: dict, seed: int,
        seconds: float, trace: bool, device, t_start: float, root,
        readings: bool = False) -> harness.Outcome:
    """One run of a fleet cell.  ``readings`` also reads the control's
    number (the reference in TF32 in the program's place) on the same
    maps, for setting the limit; the benchmark's own runs leave it off."""
    from repro_torch.fleet import runtime
    from repro_torch.serving.detector import (DetectorConfig,
                                              PackedActivationCache,
                                              RoIDetector)

    device = torch.device(device)
    cuda = device.type == "cuda"
    marks = [("imports", time.perf_counter())]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    tile = config["tile_px"]
    det_cfg = config["detector"]
    grids, hw = load_fleet(root, config)
    flat_grids = [g for gid in grids for g in grids[gid]]
    marks.append(("masks", time.perf_counter()))
    ws, head = draw_weights(det_cfg, seed, device)
    det = RoIDetector.from_numpy(
        DetectorConfig(channels=tuple(det_cfg["channels"]), tile=tile,
                       num_anchors=det_cfg["num_anchors"]),
        [w.cpu().numpy() for w in ws], head.cpu().numpy(), device=device)
    marks.append(("detector", time.perf_counter()))
    tracks = harness.load_json(root, config["tracks"])
    if [(c["group"], c["camera"]) for c in tracks["cameras"]] != \
            [(gid, i) for gid in grids for i in range(len(grids[gid]))]:
        raise ValueError("the tracks' cameras are not the masks'")
    traffic = CameraTraffic(traffic_params, hw, tracks_boxes(tracks), seed,
                            device)
    sync()
    marks.append(("traffic", time.perf_counter()))
    frames, pos = {}, 0
    for gid in grids:
        frames[gid] = traffic.frames[pos:pos + len(grids[gid])]
        pos += len(grids[gid])
    cache = PackedActivationCache()
    threshold = float(traffic_params["threshold"])
    qstep = float(traffic_params["qstep"])
    spans = {"on": False}

    def span(name):
        return torch.profiler.record_function(name) if spans["on"] \
            else contextlib.nullcontext()

    def step(t):
        with span(tracing.TRAFFIC_SPAN):
            traffic.advance(t)
            sync()
        t0 = time.perf_counter()
        with span(tracing.STEP_SPAN):
            outs, _, stats = runtime.fleet_reuse_step(
                det, frames, grids, cache, threshold=threshold, qstep=qstep)
            sync()
        return time.perf_counter() - t0, outs, stats

    for t in range(int(traffic_params["warmup_steps"])):
        step(t)
        if t == 0:
            marks.append(("cold step", time.perf_counter()))
    t = int(traffic_params["warmup_steps"])
    marks.append(("warm-up", time.perf_counter()))
    rec = FleetRun(torch.cuda.get_device_name(device) if cuda else "cpu",
                   config, flat_grids)
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sampler = MapSampler(int(traffic_params["sample_maps"]), seed, hw,
                         head.shape[-1], device)
    trace_at = int(traffic_params["trace_after"])
    trace_n = int(traffic_params["trace_steps"])
    traced_ts, prof = [], None
    rec.setup_s = time.perf_counter() - t_start
    marks.append(("map sampler", t_start + rec.setup_s))
    def serve(t):
        lat, outs, stats = step(t)
        rec.step_s.append(lat)
        rec.steps.append((stats.total_tiles, stats.computed, stats.launched,
                          stats.cold))
        sampler.offer(t, [m for g in outs for m in outs[g]])
        return outs

    w0 = time.perf_counter()
    i = 0
    while True:
        if trace and i == trace_at:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            spans["on"] = True
            outs = serve(t)               # settles the profiler; not read
            rec.traced_i.append(i)
            t, i = t + 1, i + 1
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                for _ in range(trace_n):
                    outs = serve(t)
                    traced_ts.append(t)
                    rec.traced_i.append(i)
                    t, i = t + 1, i + 1
            spans["on"] = False
            prof.__exit__(None, None, None)
            continue
        outs = serve(t)
        t, i = t + 1, i + 1
        if time.perf_counter() - w0 >= seconds and (
                not trace or prof is not None):
            break
    sync()
    rec.window_s = time.perf_counter() - w0
    rec.frames = len(rec.step_s) * len(flat_grids)
    rec.peak_mem_bytes = torch.cuda.max_memory_allocated(device) if cuda \
        else 0
    t_last = t - 1
    final = [m for g in outs for m in outs[g]]
    # the program's state is freed before the reference runs; the last
    # step's maps stay (views of its canvas)
    del det, cache, outs
    if cuda:
        torch.cuda.empty_cache()

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": rec.device_name, "count": int(cell["chips"]),
                "memory_peak_bytes": int(max(setup_peak,
                                             rec.peak_mem_bytes)),
                "power_limit": power_limit() if cuda else None}
    breakdown = None
    notes = ["set-up s: " + ", ".join(
        f"{name} {b - a:.3f}" for (name, b), (_, a)
        in zip(marks, [("start", t_start)] + marks[:-1])),
        "step ms quantiles (0, 5, 25, 50, 75, 95, 100): " + ", ".join(
            f"{q:.2f}" for q in np.percentile(
                np.asarray(rec.step_s) * 1e3, [0, 5, 25, 50, 75, 95, 100]))
        + f"; {len(rec.step_s)} steps, the rest of the window "
          f"{rec.window_s - sum(rec.step_s):.3f} s"]
    # the window in tenths of its host time: each tenth's steps and mean
    # step, to see whether the steps drift as a run goes on
    lat = np.asarray(rec.step_s) * 1e3
    ends = np.cumsum(rec.step_s)
    tenth = np.minimum((ends / max(ends[-1], 1e-12) * 10).astype(int), 9) \
        if len(ends) else np.zeros(0, int)
    notes.append("step ms mean by tenth of the window (steps): " + ", ".join(
        f"{lat[tenth == k].mean():.2f} ({int((tenth == k).sum())})"
        for k in range(10) if (tenth == k).any()))
    if prof is not None:
        on = np.zeros(len(lat), bool)
        on[rec.traced_i] = True
        notes.append(f"step ms: traced mean {lat[on].mean():.3f} over "
                     f"{on.sum()}, untraced mean {lat[~on].mean():.3f} "
                     f"over {(~on).sum()}")
        rec.trace = tracing.reduce_events(*tracing.profile_events(prof))
        later = det_cfg["channels"][1:]
        for tt in traced_ts:
            kf, rects = traffic.changes(tt)
            rec.traced_needed.append(sum(
                yardstick.needed_tiles(g, bool(kf[c]), rects[c], tile,
                                       len(later))
                for c, g in enumerate(flat_grids)))
        if rec.trace is not None:
            dev_info["busy_s"] = rec.trace.busy_s
            dev_info["window_s"] = rec.trace.window_s
            breakdown = tracing.breakdown(rec.trace)
        del prof

    checks, failed = compare(traffic, flat_grids, ws, head, tile, sampler,
                             final, t_last, config["limits"], readings)
    return harness.Outcome(rec, attempted=rec.frames, failed=failed,
                           checks=checks, device=dev_info,
                           breakdown=breakdown, notes=notes)


def compare(traffic, grids, ws, head, tile, sampler, final, t_last,
            limits, readings=False):
    """The compared numbers: the widest gap of a compared map to the
    reference's over the reference's largest |value| (``maps_rel_err``),
    over every camera of the last step and the sampled maps; with
    ``readings`` also the control's (``control_rel_err``)."""
    for c, f in enumerate(traffic.frames):
        if not torch.equal(traffic.frame_at(c, t_last), f):
            raise RuntimeError(f"camera {c}'s frame at step {t_last} does "
                               f"not remake bit for bit")
    items = [(t_last, c, m) for c, m in enumerate(final)]
    items += [kept for kept in sampler.kept if kept is not None]
    worst, ctrl, failed = 0.0, 0.0, 0
    limit = float(limits["maps_rel_err"])
    for t, c, got in items:
        frame = traffic.frame_at(c, t)
        want = reference.head_maps(frame, grids[c], ws, head, tile)
        err = reference.rel_err(got, want)
        failed += err > limit
        worst = max(worst, err)
        if readings:
            low = reference.head_maps(frame, grids[c], ws, head, tile,
                                      precision="tf32")
            ctrl = max(ctrl, reference.rel_err(low, want))
    checks = [harness.Check("maps_rel_err", worst, limit)]
    if readings:
        checks.append(harness.Check("control_rel_err", ctrl, limit))
    return checks, int(failed)
