#!/usr/bin/env python3
"""Where a training step's time goes on one NVIDIA card: h2o-danube3-4b at
full width and depth (bf16 weights drawn on the card from a seed, float32
AdamW moments, ``TrainConfig()``, remat on), ``SyntheticLM`` batches of
4,096 tokens, at batch 1 and 2.

    python3 profile_train_step.py [--batches 1 2] [--steps 3]

For each batch size: the host-clock ms of each step (``train_loss`` ->
``torch.autograd.grad`` -> ``adamw_update``, ending in a synchronize),
the forward, backward and update apart (CUDA events), the peak memory,
then one step under ``torch.profiler`` -- the device's busy time against
the step's wall, and the kernels with the most device time.  Exits
non-zero without a CUDA device.
"""
import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "h2o-danube3-4b"


def say(*parts):
    print(*parts, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SHAPES, TrainConfig, get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import adamw_init, adamw_update

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg, tcfg = get_config(ARCH), TrainConfig()
    S = SHAPES["train_4k"].seq_len
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    for p in params.values():
        p.requires_grad_(True)
    state = adamw_init(params, dev)
    names = sorted(params)
    say(f"[train] {cfg.name} full size, {smi}; torch {torch.__version__}")

    def step(batch, events=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = M.train_loss(params, cfg, batch, remat=True)
        ev[1].record()
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        ev[2].record()
        _, st, _ = adamw_update(params, dict(zip(names, grads)), state,
                                tcfg)
        ev[3].record()
        if events is not None:
            events.append(ev)
        return st, loss

    for B in args.batches:
        data = SyntheticLM(cfg.vocab_size, S, B, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, events = [], []
        for i in range(args.steps):
            batch = data.batch(i, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(batch, events)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        split = [[a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
                 for ev in events[1:] or events]
        fwd, bwd, upd = (statistics.median(x) for x in zip(*split))
        say(f"[train] batch {B} x {S}: steps {[round(w, 1) for w in walls]} "
            f"ms (host clock, synchronized); median of the later steps: "
            f"forward {fwd:.1f}, backward {bwd:.1f}, AdamW {upd:.1f} ms "
            f"(events); peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
            f" GiB; loss {float(loss.detach()):.5f}")
        batch = data.batch(args.steps, device=dev)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state, _ = step(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        n = sum(e.count for e in rows)
        say(f"[train] batch {B}, profiled step: wall {wall:.1f} ms, device "
            f"busy {busy:.1f} ms ({busy / wall:.3f}), {n} kernel launches")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
            say(f"[train]   {e.self_device_time_total / 1e3:9.1f} ms "
                f"{e.count:6d}x {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
