"""Training launcher, on the CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube3-4b \
      --smoke --steps 50 --batch 8 --seq 256 [--workdir ckpts] \
      [--ckpt-every 20] [--fail-at 30] [--mesh d,m] [--device cpu]

The flags are the JAX launcher's (``repro.launch.train``), plus
``--device``: the card unless it names another device.  ``--smoke`` uses
the reduced config; ``--fail-at`` injects a fault to drill the restore
path.  ``--mesh d,m`` runs on a training mesh of ``d x m`` ranks: the
batch over ``d``, tensor and expert parallelism over ``m``.  Over more
than one rank, start one process a rank under ``torchrun``, which sets
the rendezvous (NCCL on the cards, gloo with ``--device cpu``):

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --smoke --mesh 2,1 --device cpu

A one-rank mesh started without ``torchrun`` makes its own group.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, TrainConfig, get_config
from repro_torch.distributed.fault import FaultInjector
from repro_torch.train.loop import train


def _process_group(device):
    """Join the ``torchrun`` rendezvous, or make a one-rank group."""
    import torch.distributed as dist
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        fd, path = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.unlink(path)
        dist.init_process_group(backend, init_method=f"file://{path}",
                                rank=0, world_size=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="h2o-danube3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--sharding", default="tp",
                    choices=["tp", "fsdp", "fsdp_pod"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="data,model (one process a rank)")
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatch=args.microbatch,
                       sharding_mode=args.sharding,
                       grad_compression=args.grad_compression)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_train_mesh
        d, m = (int(x) for x in args.mesh.split(","))
        _process_group(device)
        mesh = make_train_mesh((d, m), device=args.device)
    injector = FaultInjector((args.fail_at,)) if args.fail_at else None
    try:
        report = train(cfg, tcfg, steps=args.steps,
                       batch_shape=(args.batch, args.seq), mesh=mesh,
                       workdir=args.workdir, ckpt_every=args.ckpt_every,
                       injector=injector, device=device)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        print(f"\nfinal loss {report.final_loss:.4f} over "
              f"{report.steps_run} steps; restarts={report.restarts}; "
              f"median step {report.median_step_s*1e3:.0f} ms; "
              f"stragglers={len(report.straggler_events)}")


if __name__ == "__main__":
    main()
