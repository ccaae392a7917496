"""The port's data-axis route on two gloo ranks on the CPU, against the
single-process step on the same global batch: a (2, 1) mesh under tp,
fsdp and dp_only (h2o-danube3-4b at SMOKE in float32), fsdp with int8,
and deepseek-moe's global aux loss.  This is the oracle of the JAX
package's failing sharded train-step test (ROADMAP.md C-R3).

The ranks run through ``tests/torch_dist_worker.py`` in a subprocess
with a timeout (a hung rank fails the test).  Bars: losses and grad
norms within 1e-5 relative, the first step's reduced gradients per leaf
within 1e-5 of its largest (plus a quantization step under int8), the
replicated parameters bitwise equal across ranks.
"""
import pytest

from repro_torch.data.lm import SyntheticLM
from repro_torch.distributed.compression import quantize_int8
from repro_torch.train.loop import init_state, make_train_step
from test_torch_dist import ARCH, _cfg, _run_worker, _tcfg


@pytest.mark.parametrize("arch,mode,microbatch,compression", [
    (ARCH, "tp", 2, "none"), (ARCH, "fsdp", 0, "none"),
    (ARCH, "dp_only", 2, "none"), (ARCH, "fsdp", 2, "int8"),
    ("deepseek-moe-16b", "fsdp", 2, "none")])
def test_two_ranks_match_single_process(tmp_path, arch, mode, microbatch,
                                        compression):
    """A (2, 1) mesh of gloo ranks against the single-process step on the
    same global batch; deepseek-moe's aux loss is the global batch's;
    under int8 the rows split over the ranks (the last dim of ``w1``)
    take the global row absmax, and each gradient is held within one
    quantization step of its row's scale more."""
    cfg, tcfg = _cfg(arch), _tcfg(mode, microbatch, compression)
    res = _run_worker("route", tmp_path, world=2, arch=arch, mode=mode,
                      microbatch=microbatch, compression=compression,
                      mesh=[2, 1], batch=4, seq=32, steps=3)
    assert res["ranks_equal"]
    if mode != "tp":
        assert res["split"]["embed"]        # the moments are split
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    state = init_state(cfg, tcfg, None, device="cpu")
    step = make_train_step(cfg, tcfg)
    _, grads = step.gradients(state, data.batch(0, device="cpu"))
    if compression == "int8":
        _, raw = make_train_step(cfg, _tcfg(mode, microbatch)).gradients(
            state, data.batch(0, device="cpu"))
    for n, want in grads.items():
        allow = 1e-5 * want.abs().max().clamp_min(1e-30)
        if compression == "int8":
            allow = allow + quantize_int8(raw[n])[1]
        assert bool(((res["grads"][n] - want).abs() <= allow).all()), n
    for s in range(3):
        state, m = step(state, data.batch(s, device="cpu"))
        got = res["mets"][s]
        assert abs(got["loss"] - float(m["loss"])) <= \
            1e-5 * abs(float(m["loss"])), (s, got, m)
        assert abs(got["grad_norm"] - float(m["grad_norm"])) <= \
            1e-5 * float(m["grad_norm"]), (s, got, m)
