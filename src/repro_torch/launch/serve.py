"""Serving launcher: batched requests against a (smoke) model, with the
CrossRoI RoI-packed prefill on keep-lists, on the CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube3-4b \
      --requests 4 --roi [--device cpu]

``--arch`` takes every arch the port runs (``configs.ARCH_IDS``): the
dense, moe, rwkv6 (``rwkv6-7b``) and Mamba2-hybrid (``zamba2-2.7b``)
decoders serve token prompts.

The flags are the JAX launcher's (``repro.launch.serve``), plus
``--device``: the card unless it names another device.  Weights are drawn
from a seeded ``torch.Generator`` at the arch's SMOKE size; the prompts are
random token ids, so a vlm arch (which takes patch streams) and
whisper-small (which takes frames, ``KeyError: 'frames'``) raise there, as
in the JAX launcher.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, ServeConfig, get_config
from repro_torch.models.params import init_params
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="h2o-danube3-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=192)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--roi", action="store_true",
                    help="RoI-sparsified prefill (keep-list packing)")
    ap.add_argument("--keep-frac", type=float, default=0.5)
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    engine = ServingEngine(cfg, ServeConfig(max_batch=4,
                                            roi_sparsity=args.roi), params)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        toks = rng.integers(0, cfg.vocab_size,
                            args.prompt_len).astype(np.int32)
        keep = rng.random(args.prompt_len) < args.keep_frac if args.roi \
            else None
        reqs.append(Request(i, tokens=toks, keep=keep,
                            max_new_tokens=args.new_tokens))

    t0 = time.time()
    out = engine.serve(reqs, greedy_steps=args.new_tokens)
    dt = time.time() - t0
    for rid, toks in sorted(out.items()):
        print(f"req {rid}: {toks.tolist()}")
    n_tok = sum(len(t) for t in out.values())
    print(f"{n_tok} tokens in {dt:.2f}s "
          f"({'RoI-packed' if args.roi else 'dense'} prefill) on {dev}")
    return out


if __name__ == "__main__":
    main()
