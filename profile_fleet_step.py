#!/usr/bin/env python3
"""Where the port's fleet step spends its time on one NVIDIA card.

    python3 profile_fleet_step.py

Builds the fleet of ``chip_smoke.py`` (4 groups x 5 cameras at the
paper's camera sizes, RoI density 0.35, default detector), runs a cold
step and two warm-up warm steps, then profiles with ``torch.profiler``
each of: a cold step, three warm threshold-0 steps (5 cameras get a fresh
64x64 patch each) and an all-static step; the same warm and static steps
with the packed reference mode; and the rate controller's static-tile
fractions for the 20 cameras, through the kernels (``tile_static_fraction``
and ``tile_halo_static_fraction``: 20 launches each) and from the warm
step's gate stats (no launch); and the detector's fused and per-layer
paths (``chip_smoke.py`` phase 3d): ``fleet_forward`` and
``fleet_forward_layers`` over the fleet, ``roi_forward`` and
``roi_forward_layers`` on one 1920x1080 leg, its tables cached, after a
``cProfile`` of the first ``roi_forward`` call, which builds them; then,
the fleet freed, the serving path of ``chip_smoke.py`` phase 3e at full
width (internvl2-26b, bf16 weights drawn on the card): one
``roi_prefill`` of one frame's fleet patch stream (after a warm-up
prefill), B12 on that stream's layer-0 q/k/v (its CUDA-event span beside
its device time), and one greedy decode step of a 4-request group.  For
each it prints the step's
wall time (host clock around work that ends in a synchronize), the
device busy time (the sum of the kernel, copy and fill durations the
profiler traced), the device idle share, the device time by kernel and
the host time by operator.  Then ``cProfile`` times the Python side of a
warm and an all-static step, which ``torch.profiler`` does not see (numpy
planning, frame staging calls).
"""
import collections
import cProfile
import io
import pstats
import sys
import time

import numpy as np

import chip_smoke as cs


def profile_step(torch, step_fn, label, top=8):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] += e.time_range.elapsed_us()
    busy_us = sum(by_kernel.values())
    cs.say(f"[{label}] wall_ms={wall_us / 1e3:.3f} "
           f"device_busy_ms={busy_us / 1e3:.3f} "
           f"idle_share={1 - busy_us / wall_us:.3f}")
    for name, us in by_kernel.most_common(top):
        cs.say(f"[{label}]   device {us / 1e3:8.3f} ms  {name[:90]}")
    host = sorted(prof.key_averages(), key=lambda k: -k.self_cpu_time_total)
    for k in host[:8]:
        cs.say(f"[{label}]   host   {k.self_cpu_time_total / 1e3:8.3f} ms  "
               f"{k.key[:60]} x{k.count}")


def python_profile(torch, step_fn, label, top=14):
    """Wall time of one step and its Python functions by own time."""
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    step_fn()
    torch.cuda.synchronize()
    pr.disable()
    cs.say(f"[{label}] wall_ms={(time.perf_counter() - t0) * 1e3:.3f} "
           f"(under cProfile)")
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(top)
    for line in out.getvalue().splitlines():
        if line.strip() and line.lstrip()[0].isdigit():
            cs.say(f"[{label}]   {line.strip()[:150]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_fleet_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.fleet.runtime import fleet_reuse_step
    from repro_torch.kernels import _build
    from repro_torch.net import (static_fraction_from_stats,
                                 tile_halo_static_fraction,
                                 tile_static_fraction)
    from repro_torch.serving.detector import PackedActivationCache

    _build.library()
    dev = torch.device("cuda")
    rng, gen, grids, frames = cs.build_fleet(torch, dev)
    det = cs.build_detector(dev)
    cs.say(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: "
           f"{' | '.join(cs.nvidia_smi())}")
    cache = PackedActivationCache()
    state = {"frames": frames}

    def step(patch=True):
        if patch:
            state["frames"] = cs.with_patches(torch, state["frames"], grids,
                                              rng, gen, 0.0)
        return fleet_reuse_step(det, state["frames"], grids, cache)

    step(False)                                   # cold: seeds the cache
    step()
    step()
    cache.invalidate()
    profile_step(torch, lambda: step(False), "cold")
    for k in range(3):
        profile_step(torch, step, f"warm{k}")
    profile_step(torch, lambda: step(False), "static")
    python_profile(torch, step, "py-warm")
    python_profile(torch, lambda: step(False), "py-static")

    packed = PackedActivationCache(ref_mode="packed")
    fleet_reuse_step(det, state["frames"], grids, packed)   # cold seed

    def packed_step(patch=True):
        if patch:
            state["frames"] = cs.with_patches(torch, state["frames"], grids,
                                              rng, gen, 0.0)
        return fleet_reuse_step(det, state["frames"], grids, packed)

    packed_step()
    for k in range(2):
        profile_step(torch, packed_step, f"packed-warm{k}")
    profile_step(torch, lambda: packed_step(False), "packed-static")

    prev = state["frames"]
    state["frames"] = cs.with_patches(torch, prev, grids, rng, gen, 20.0)
    _, _, st = fleet_reuse_step(det, state["frames"], grids, cache)
    triples = list(zip(cs.flat(state["frames"]), cs.flat(prev),
                       cs.flat(grids)))
    # the fleet packing is camera-major: camera c's rows are one range
    bounds = np.searchsorted(cache.idx_np[:, 0], np.arange(len(triples) + 1))
    profile_step(torch, lambda: [tile_static_fraction(a, b, g, cs.TILE)
                                 for a, b, g in triples], "fractions-B10")
    profile_step(torch, lambda: [tile_halo_static_fraction(a, b, g, cs.TILE)
                                 for a, b, g in triples], "fractions-B11")
    profile_step(torch, lambda: [
        static_fraction_from_stats(st.gate_stats[bounds[c]:bounds[c + 1]], 3,
                                   cs.TILE)
        for c in range(len(triples))], "fractions-stats")

    fl_f, fl_g = cs.flat(state["frames"]), cs.flat(grids)
    det.fleet_forward_layers(fl_f, fl_g)          # warm-up
    profile_step(torch, lambda: det.fleet_forward(fl_f, fl_g), "fleet-fused")
    profile_step(torch, lambda: det.fleet_forward_layers(fl_f, fl_g),
                 "fleet-layers")
    leg, leg_grid = fl_f[0], fl_g[0]
    python_profile(torch, lambda: det.roi_forward(leg, leg_grid),
                   "py-roi-first")
    profile_step(torch, lambda: det.roi_forward(leg, leg_grid), "roi")
    profile_step(torch, lambda: det.roi_forward_layers(leg, leg_grid),
                 "roi-layers")
    keep = cs.fleet_keep(grids)
    del det, cache, packed, state, frames, prev, triples, st, fl_f, leg
    torch.cuda.empty_cache()
    profile_serving(torch, dev, keep)
    return 0


def profile_serving(torch, dev, keep):
    """One full-width ``roi_prefill``, B12 on its layer-0 tensors, and one
    4-request decode step, each under ``torch.profiler``."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import forward as F, layers as L, model as M
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config(cs.ARCH)
    params = init_params(cfg, torch.Generator(device=dev)
                         .manual_seed(cs.SEED), dev)
    engine = ServingEngine(cfg, ServeConfig(roi_sparsity=True), params)
    stream = np.random.default_rng((cs.SEED, 100)).standard_normal(
        (keep.size, cfg.frontend_dim), dtype=np.float32)
    packed, positions, _ = ops.pack_tokens(
        torch.as_tensor(stream, device=dev), torch.as_tensor(keep,
                                                             device=dev))
    pos = positions[None]
    x = M._front(params, cfg, {"tokens": torch.zeros((1, 0), dtype=torch.long,
                                                     device=dev),
                               "patches": packed[None]})
    lp = F.layer_params(F._sub(params, "blocks_"), 0)
    rope = F._rope(cfg, x.shape[1], positions=pos, device=dev)
    q, k, v = F.project_qkv(L.rmsnorm(x, lp["ln1"], cfg.norm_eps), lp, cfg,
                            rope)
    G = cfg.num_heads // cfg.num_kv_heads
    q, k, v = (t[0].contiguous() for t in (q, L.repeat_kv(k, G),
                                           L.repeat_kv(v, G)))
    del x, packed
    # B12 first: on an H100 with torch 2.11, a short session right after
    # the prefill's ~34k traced launches recorded no device activity
    span = cs.time_ms(torch, lambda: ops.roi_attention(q, k, v, positions))
    cs.say(f"[serve-b12] CUDA-event span {span:.4f} ms (median of 7)")
    profile_step(torch, lambda: ops.roi_attention(q, k, v, positions),
                 "serve-b12")
    del q, k, v

    engine.roi_prefill(stream, keep)                  # warm-up
    profile_step(torch, lambda: engine.roi_prefill(stream, keep),
                 "serve-prefill", top=14)

    n_req, n_kept = cs.N_REQUESTS, int(keep.sum())
    ring = M.init_cache(cfg, n_req, positions.shape[0] + cs.DECODE_STEPS,
                        dev)
    tok = torch.zeros((n_req, 1), dtype=torch.long, device=dev)
    at = torch.full((n_req,), n_kept, device=dev)
    engine._decode_group(tok, ring, at)               # warm-up
    profile_step(torch, lambda: engine._decode_group(tok, ring, at + 1),
                 "serve-decode")


if __name__ == "__main__":
    sys.exit(main())
