"""The port's fault-tolerant ``train()`` on the CPU: the JAX package's six
cases (tests/test_train_fault.py) on the port -- loss decreases on a
cycled stream, restore equals the clean run (here bitwise: the final
loss and every parameter), no checkpoint means the fault raises,
microbatches match the full batch, int8 tracks float32, the straggler
monitor -- and an elastic restore (saved by a 2-rank gloo run, continued
by one process, within the 2-rank bar of 1e-5 relative on the losses),
the launcher with an injected fault, and the port's example.
"""
import dataclasses
import os
import subprocess
import sys
import time

import pytest
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.lm import SyntheticLM
from repro_torch.distributed.fault import (FaultInjector, InjectedFault,
                                           StragglerMonitor)
from repro_torch.train.loop import train
from test_torch_dist import _run_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("h2o-danube3-4b", smoke=True)
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12,
                   seed=0)


class _CycledLM(SyntheticLM):
    """Replays a small fixed batch set, where a 12-step smoke run's
    progress is observable (fresh markov batches sit at the noise
    floor)."""

    def batch(self, step, **kw):
        return super().batch(step % 4, **kw)


def _cycled():
    return _CycledLM(CFG.vocab_size, 64, 4, seed=0)


def _train(cfg=CFG, tcfg=TCFG, **kw):
    kw.setdefault("batch_shape", (4, 64))
    return train(cfg, tcfg, verbose=False, device="cpu", **kw)


def test_loss_decreases():
    rep = _train(steps=12, data=_cycled())
    assert rep.steps_run == 12
    assert rep.losses[-1] < rep.losses[0]


def test_fault_restore_is_bit_exact(tmp_path):
    clean = _train(steps=10)
    faulted = _train(steps=10, workdir=str(tmp_path), ckpt_every=4,
                     injector=FaultInjector((7,)))
    assert faulted.restarts == 1 and len(faulted.restore_s) == 1
    assert faulted.losses[-1] == clean.losses[-1]
    a, b = faulted.final_state, clean.final_state
    assert torch.equal(a.opt.step, b.opt.step)
    for n in b.params:
        assert torch.equal(a.params[n], b.params[n]), n
        assert torch.equal(a.opt.m[n], b.opt.m[n]), n
        assert torch.equal(a.opt.v[n], b.opt.v[n]), n


def test_fault_before_first_checkpoint_restarts_cold(tmp_path):
    clean = _train(steps=4)
    faulted = _train(steps=4, workdir=str(tmp_path), ckpt_every=3,
                     injector=FaultInjector((2,)))
    assert faulted.restarts == 1 and faulted.restore_s == []
    assert faulted.losses[-1] == clean.losses[-1]


def test_fault_without_checkpointing_raises():
    with pytest.raises(InjectedFault):
        _train(steps=10, injector=FaultInjector((3,)))


def test_microbatch_matches_full_batch():
    t1 = _train(steps=3)
    t2 = _train(tcfg=dataclasses.replace(TCFG, microbatch=2), steps=3)
    # same data, gradients averaged over microbatches
    assert abs(t1.losses[0] - t2.losses[0]) <= 1e-4 * abs(t1.losses[0])
    assert abs(t1.losses[-1] - t2.losses[-1]) <= 2e-2 * abs(t1.losses[-1])


def test_int8_grad_compression_tracks_fp32():
    """int8-quantized gradients track the uncompressed trajectory: the
    final loss within 5% after 12 steps."""
    comp = _train(tcfg=dataclasses.replace(TCFG, grad_compression="int8"),
                  steps=12, data=_cycled())
    clean = _train(steps=12, data=_cycled())
    assert comp.losses[-1] < comp.losses[0]          # it does train
    assert comp.losses[-1] < clean.losses[-1] * 1.05


def test_straggler_monitor():
    mon = StragglerMonitor(window=10, tolerance=2.0, min_samples=3)
    for i in range(5):
        mon.start()
        time.sleep(0.01)
        assert not mon.stop(i)
    mon.start()
    time.sleep(0.1)           # 10x the median: flagged
    assert mon.stop(5)
    assert len(mon.events) == 1


def test_elastic_restore_across_rank_counts(tmp_path):
    """A checkpoint written by rank 0 of a (2, 1) fsdp mesh at step 4 is
    restored by one process (a fault at its step 0), which runs steps 4
    and 5: their losses equal the clean one-process run's within 1e-5
    relative."""
    work = tmp_path / "ckpt"
    res = _run_worker("train", tmp_path, world=2, arch="h2o-danube3-4b",
                      mode="fsdp", mesh=[2, 1], batch=4, seq=32, steps=4,
                      ckpt_every=2, workdir=str(work))
    cfg = CFG.replace(dtype="float32", kv_cache_dtype="float32")
    tcfg = dataclasses.replace(TCFG, sharding_mode="fsdp")
    clean = _train(cfg, tcfg, steps=6, batch_shape=(4, 32))
    for a, b in zip(res["losses"], clean.losses[:4]):
        assert abs(a - b) <= 1e-5 * abs(b)
    cont = _train(cfg, tcfg, steps=6, batch_shape=(4, 32),
                  workdir=str(work), ckpt_every=2,
                  injector=FaultInjector((0,)))
    assert cont.restarts == 1 and len(cont.losses) == 2
    for a, b in zip(cont.losses, clean.losses[4:]):
        assert abs(a - b) <= 1e-5 * abs(b)


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_launcher_restores_from_an_injected_fault(tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--arch",
                "h2o-danube3-4b", "--smoke", "--steps", "8",
                "--ckpt-every", "4", "--fail-at", "6", "--workdir",
                str(tmp_path), "--device", "cpu"])
    assert "[fault] step 6" in out and "restarts=1" in out


def test_example_trains_through_a_fault():
    """``examples/torch_train_100m.py --tiny`` at 80 steps (a fault at step
    40, checkpoints every 13): the loss falls from its first step (at 30
    steps the smoke model's loss on fresh markov batches has not yet
    moved below its first, and the example's assertion fails)."""
    out = _run(["examples/torch_train_100m.py", "--tiny", "--steps", "80",
                "--device", "cpu"])
    assert "(1 restart)" in out
