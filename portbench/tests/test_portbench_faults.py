"""``correct`` against a broken timed path and against the control, on
the tiny cell on the CPU: the harness runs as on the card (set-up,
warm-up, window, comparison) with the program's step broken underneath.

The faults a fleet cell can have: a step that returns its state
unchanged; half of the batch (the cameras) left out; an answer altered
where it is produced.  The exchange between chips does not exist in a
one-chip cell.  The control is the plain reference computed in TF32 in
the program's place."""
import time

import pytest
import torch

import portbench_tiny as T
from portbench_tiny import one_thread  # noqa: F401
from portbench import harness, reference
from repro_torch.fleet import runtime

pytestmark = pytest.mark.usefixtures("one_thread")
REAL_STEP = runtime.fleet_reuse_step
WARMUP = T.TRAFFIC["warmup_steps"]


def run(tmp_path, trace=False):
    root = T.make_root(tmp_path)
    out, _ = harness.run_cell(root, "tiny.h264", 2 ** 31 + 3, 0.4, trace,
                              "cpu", time.perf_counter())
    return out


def stale_state():
    """From the window's first step on, every step hands back the last
    warm-up step's maps untouched."""
    calls = {"n": 0, "last": None}

    def step(det, frames, grids, cache, **kw):
        calls["n"] += 1
        if calls["n"] <= WARMUP:
            calls["last"] = REAL_STEP(det, frames, grids, cache, **kw)
        return calls["last"]
    return step


def half_the_cameras():
    """The second half of the cameras are handed their previous frames."""
    prev = {}

    def step(det, frames, grids, cache, **kw):
        flat = [(g, i) for g in frames for i in range(len(frames[g]))]
        held = {}
        for g, i in flat[len(flat) // 2:]:
            held[(g, i)] = prev.get((g, i), frames[g][i]).clone()
        prev.update({(g, i): frames[g][i].clone() for g, i in flat})
        stale = {g: [held.get((g, i), frames[g][i])
                     for i in range(len(frames[g]))] for g in frames}
        return REAL_STEP(det, stale, grids, cache, **kw)
    return step


def altered_answer():
    """One head value of each camera's map is changed where produced."""
    def step(det, frames, grids, cache, **kw):
        outs, counts, stats = REAL_STEP(det, frames, grids, cache, **kw)
        for g in outs:
            for m, gr in zip(outs[g], grids[g]):
                ty, tx = (int(v) for v in torch.nonzero(
                    torch.as_tensor(gr))[0])
                m[ty * 16 + 5, tx * 16 + 7, 3] += 1e-3 * float(
                    m.abs().max())
        return outs, counts, stats
    return step


def control():
    """The plain reference in TF32 writes each camera's maps."""
    def step(det, frames, grids, cache, **kw):
        outs, counts, stats = REAL_STEP(det, frames, grids, cache, **kw)
        for g in outs:
            for m, f, gr in zip(outs[g], frames[g], grids[g]):
                m.copy_(reference.head_maps(f, gr, det.weights, det.head, 16,
                                            precision="tf32"))
        return outs, counts, stats
    return step


def test_sound_run_is_correct(tmp_path):
    out = run(tmp_path)
    assert out.correct and out.checks[0].value < 1e-5


@pytest.mark.parametrize("fault", [stale_state, half_the_cameras,
                                   altered_answer, control])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(runtime, "fleet_reuse_step", fault())
    out = run(tmp_path)
    assert not out.correct
    assert out.failed > 0
    assert out.checks[0].value > out.checks[0].limit


def test_readings_put_the_control_above_the_limit(tmp_path):
    root = T.make_root(tmp_path)
    out, _ = harness.run_cell(root, "tiny.h264", 77, 0.3, False, "cpu",
                              time.perf_counter(), readings=True)
    got = {c.name: c for c in out.checks}
    assert got["maps_rel_err"].ok
    assert not got["control_rel_err"].ok
    assert got["control_rel_err"].value > 30 * got["maps_rel_err"].value


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12,
                      1.0 + 2 ** -10])
    want = torch.tensor([1.0, 1.0, 1.0 + 2 ** -9, -1.0, 1.0 + 2 ** -10])
    assert torch.equal(reference.round_tf32(x), want)


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    """The tiny cell on the card: the program within its limit, the
    control above it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = T.make_root(tmp_path)
    out, _ = harness.run_cell(root, "tiny.h264", 5, 0.5, True,
                              torch.device("cuda", 0), time.perf_counter(),
                              readings=True)
    got = {c.name: c for c in out.checks}
    assert got["maps_rel_err"].ok and not got["control_rel_err"].ok
