"""A training run on the PyTorch port: a ~100M-param dense model for a
few hundred steps, with a mid-run injected fault to demonstrate
checkpoint/restore.

  PYTHONPATH=src python examples/torch_train_100m.py [--steps 300] \
      [--tiny] [--device cpu]

The port's copy of ``examples/train_100m.py``, on the CUDA card unless
``--device`` names another.  ``--tiny`` drops to the smoke config for a
fast run; the default 100M config takes a few CPU-minutes for 300 steps.
"""
import argparse
import tempfile
import time

from repro_torch.configs import TrainConfig, get_config
from repro_torch.distributed.fault import FaultInjector
from repro_torch.train.loop import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args()

    if args.tiny:
        cfg = get_config("h2o-danube3-4b", smoke=True)
    else:
        # ~100M-param llama-family config (danube3 shape, scaled down)
        cfg = get_config("h2o-danube3-4b").replace(
            num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32000)
    n = cfg.param_count()
    print(f"model: {n/1e6:.1f}M params ({cfg.num_layers}L d={cfg.d_model})")

    tcfg = TrainConfig(learning_rate=6e-4, warmup_steps=20,
                       total_steps=args.steps)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.time()
        report = train(cfg, tcfg, steps=args.steps,
                       batch_shape=(args.batch, args.seq),
                       workdir=workdir, ckpt_every=max(args.steps // 6, 1),
                       injector=FaultInjector((args.steps // 2,)),
                       log_every=max(args.steps // 10, 1),
                       device=args.device)
        dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(f"\nloss {report.losses[0]:.3f} -> {report.final_loss:.3f} "
          f"over {report.steps_run} steps ({report.restarts} restart); "
          f"{toks/dt:.0f} tok/s")
    assert report.final_loss < report.losses[0], "loss must decrease"


if __name__ == "__main__":
    main()
