"""Shared cases of the model-axis route (tensor and expert parallelism over
the model group) on gloo ranks on the CPU, for ``test_torch_tp_*.py``.

Every arch at SMOKE in float32 runs ``make_train_step`` (so
``train_loss``) on (1, 2), (1, 4) and (2, 2) meshes, under ``tp`` and
``fsdp``, the (2, 2) mesh with 2 microbatches and int8 compression, and
``train()`` (the same steps through the launcher-level loop) on the
last variant of each world size, through ``tests/torch_dist_worker.py``'s
``variants`` case (one subprocess a world size).  Each run is held against the
single-process step on the same global batch.  A row-parallel
projection's all-reduce reorders a contraction's sum, so the route is
not bitwise; the bars are: losses and grad norms within 1e-5 relative,
the first step's reduced gradients within 1e-5 of each leaf's largest
(plus one quantization step of the leaf's row under int8), ``train()``'s
losses within 1e-5 relative, and every rank's copy of every parameter
bitwise equal after the steps.

Under int8 an element whose rounding flips between the two sums moves
by a whole quantization step, and AdamW carries it into the next step's
parameters, so the grad norms of the steps after the first are not held
against the single process's there (zamba2 at (1, 4) drifts 2.8e-5 by
the third step); the first step's grad norm is held within 1e-5 of the
norm of the route's own first-step gradients, which are held to the
single process's within their bar, and every step's loss within 1e-5.
"""
import dataclasses
import functools
import os
import sys

import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.distributed.compression import quantize_int8
from repro_torch.train.loop import init_state, make_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_dist import _run_worker  # noqa: E402
from torch_dist_worker import StepData  # noqa: E402

B, S, STEPS = 4, 32, 3
# (mesh, mode, microbatch, compression) by world size
VARIANTS = {
    2: [([1, 2], "tp", 0, "none"), ([1, 2], "fsdp", 0, "none")],
    4: [([1, 4], "tp", 0, "none"), ([1, 4], "fsdp", 0, "none"),
        ([2, 2], "tp", 2, "int8"), ([2, 2], "fsdp", 2, "int8")],
}


def smoke(arch, overrides=None):
    return get_config(arch, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32", **(overrides or {}))


def tcfg(mode, microbatch=0, compression="none"):
    return TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12,
                       seed=0, sharding_mode=mode, microbatch=microbatch,
                       grad_compression=compression)


def reference(cfg, tc):
    """The single-process step on the global batch: the first step's
    gradients (and, under int8, the uncompressed ones), then STEPS steps'
    metrics.  Without a mesh the sharding mode plays no part, so the
    variants of one arch share it (cached).  One thread, as the ranks
    run: at SMOKE sizes more only add overhead."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _reference(cfg, dataclasses.replace(tc, sharding_mode="tp"))
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=4)
def _reference(cfg, tc):
    data = StepData(cfg, S, B)
    state = init_state(cfg, tc, None, device="cpu")
    step = make_train_step(cfg, tc)
    _, grads = step.gradients(state, data.batch(0, device="cpu"))
    raw = None
    if tc.grad_compression == "int8":
        plain = make_train_step(cfg, TrainConfig(**{
            **tc.__dict__, "grad_compression": "none"}))
        _, raw = plain.gradients(state, data.batch(0, device="cpu"))
    mets = []
    for s in range(STEPS):
        state, m = step(state, data.batch(s, device="cpu"))
        mets.append({k: float(v) for k, v in m.items()})
    return grads, raw, mets


def check(got, cfg, tc):
    """One variant's worker result against ``reference``."""
    assert got["ranks_equal"]
    grads, raw, mets = reference(cfg, tc)
    for n, want in grads.items():
        allow = 1e-5 * want.abs().max().clamp_min(1e-30)
        if raw is not None:
            allow = allow + quantize_int8(raw[n])[1]
        assert bool(((got["grads"][n] - want).abs() <= allow).all()), n
    if raw is not None:
        own = torch.stack([g.double().square().sum()
                           for g in got["grads"].values()]).sum().sqrt()
        gn = got["mets"][0]["grad_norm"]
        assert abs(gn - float(own)) <= 1e-5 * float(own), (gn, float(own))
    for s in range(STEPS):
        g, w = got["mets"][s], mets[s]
        held = ("loss",) if raw is not None else ("loss", "grad_norm")
        for k in held:
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (s, k, g[k], w[k])
        if "train_losses" in got:
            assert abs(got["train_losses"][s] - w["loss"]) <= \
                1e-5 * abs(w["loss"]), (s, got["train_losses"][s], w["loss"])


def _variant_args(arch, overrides, variants):
    return [{"arch": arch, "overrides": overrides or {}, "mesh": m,
             "mode": mode, "microbatch": mb, "compression": c,
             "train": i == len(variants) - 1}
            for i, (m, mode, mb, c) in enumerate(variants)]


def run_archs(tmp_path, archs, world):
    """Every variant of ``world`` ranks for each of ``archs``, in one
    worker subprocess (the ranks' start-up is most of a run's time):
    {arch: the worker's results, one a variant}."""
    res = _run_worker(
        "variants", tmp_path, timeout=300, world=world, batch=B, seq=S,
        steps=STEPS, mode="tp",
        variants=[v for arch in archs
                  for v in _variant_args(arch, None, VARIANTS[world])])
    n = len(VARIANTS[world])
    return {arch: res[i * n:(i + 1) * n] for i, arch in enumerate(archs)}


def check_arch(res, arch, world, overrides=None, variants=None):
    """Each variant's result against the single-process step."""
    cfg = smoke(arch, overrides)
    for got, (_, mode, mb, c) in zip(res, variants or VARIANTS[world]):
        check(got, cfg, tcfg(mode, mb, c))


def run_arch(tmp_path, arch, world, overrides=None, variants=None):
    """Every variant of ``world`` ranks for ``arch``, each checked; the
    worker's results (for further checks)."""
    variants = variants or VARIANTS[world]
    res = _run_worker("variants", tmp_path, timeout=300, world=world,
                      batch=B, seq=S, steps=STEPS, mode="tp",
                      variants=_variant_args(arch, overrides, variants))
    check_arch(res, arch, world, overrides, variants)
    return res
