"""The port's synthetic LM data (``repro_torch.data.lm``) and training
configs against the JAX package's, on the CPU.

``SyntheticLM`` draws from its own generator, so its bits differ from the
JAX stream's; it is held to ``tests/test_data.py``'s five properties
(determinism, steps differ, labels are the shifted tokens, the markov
band, shard slices) and to its own structure.  ``ShapeCell``, ``SHAPES``,
``TrainConfig`` and ``all_cells`` equal the JAX package's field for field
and cell for cell.
"""
import dataclasses

import numpy as np
from hypothesis import given, settings, strategies as st

import repro.configs as JC
from repro.configs import base as JB
from repro.configs import registry as JR
from repro_torch import configs as TC
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.data import lm_batch_specs
from repro_torch.data.lm import SyntheticLM
from repro_torch.models.model import input_specs


def _batch(d, *args, **kw):
    return {k: v.numpy() for k, v in d.batch(*args, device="cpu",
                                             **kw).items()}


def test_batches_deterministic():
    d1 = SyntheticLM(1000, 64, 8, seed=3)
    d2 = SyntheticLM(1000, 64, 8, seed=3)
    for step in (0, 1, 17):
        a, b = _batch(d1, step), _batch(d2, step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_steps_and_seeds_differ():
    d = SyntheticLM(1000, 64, 8, seed=0)
    assert not np.array_equal(_batch(d, 0)["tokens"], _batch(d, 1)["tokens"])
    other = SyntheticLM(1000, 64, 8, seed=1)
    assert not np.array_equal(_batch(d, 0)["tokens"],
                              _batch(other, 0)["tokens"])


def test_labels_are_shifted_tokens():
    b = _batch(SyntheticLM(1000, 64, 4, seed=1), 0)
    assert b["tokens"].dtype == b["labels"].dtype == np.int32
    assert b["tokens"].shape == b["labels"].shape == (4, 64)
    # tokens[t+1] == labels[t] by construction
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_markov_band_structure():
    d = SyntheticLM(1000, 128, 8, seed=2, band=16)
    toks = _batch(d, 0)["tokens"]
    steps = (toks[:, 1:] - toks[:, :-1]) % 1000
    steps = np.minimum(steps, 1000 - steps)
    # outside the repeated span, consecutive tokens stay within the band
    assert float((steps <= 16).mean()) > 0.7


def test_markov_walk_and_repeated_span():
    """Every step of the walk outside the copied span within +-band (mod
    V), and the first ``span`` tokens of the S + 1 row again at ``S -
    span - 1``; tokens in [0, V)."""
    V, S, band = 500, 64, 5
    b = _batch(SyntheticLM(V, S, 6, seed=9, band=band), 4)
    row = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
    span = int((S + 1) * 0.25)
    off = S + 1 - span - 1
    np.testing.assert_array_equal(row[:, off:off + span], row[:, :span])
    d = (row[:, 1:off] - row[:, :off - 1]) % V
    assert (np.minimum(d, V - d) <= band).all()
    assert row.min() >= 0 and row.max() < V


def test_uniform_mode():
    b = _batch(SyntheticLM(50, 256, 4, mode="uniform", seed=5), 3)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 50
    assert len(np.unique(b["tokens"])) == 50
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 50))
def test_shard_slices_are_disjoint_partitions(step):
    """Property: sharded batches tile the global batch (replay invariant)."""
    d = SyntheticLM(500, 32, 8, seed=4)
    parts = [_batch(d, step, shard=s, num_shards=4) for s in range(4)]
    for p in parts:
        assert p["tokens"].shape == (2, 32)
    # determinism across shards: same shard twice is identical
    again = _batch(SyntheticLM(500, 32, 8, seed=4), step, shard=2,
                   num_shards=4)
    np.testing.assert_array_equal(parts[2]["tokens"], again["tokens"])
    assert not np.array_equal(parts[1]["tokens"], parts[2]["tokens"])


def test_lm_batch_specs_are_input_specs():
    cfg = TC.get_config("h2o-danube3-4b", smoke=True)
    cell = TC.SHAPES["train_4k"]
    specs = lm_batch_specs(cfg, cell)
    want = input_specs(cfg, cell)
    assert sorted(specs) == sorted(want) == ["labels", "tokens"]
    for k in specs:
        assert specs[k].shape == want[k].shape == (256, 4096)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_shape_cells_and_train_config_match_jax():
    assert [f.name for f in dataclasses.fields(TB.ShapeCell)] == \
        [f.name for f in dataclasses.fields(JB.ShapeCell)]
    assert list(TB.SHAPES) == list(JB.SHAPES)
    for name, cell in JB.SHAPES.items():
        assert dataclasses.asdict(TB.SHAPES[name]) == dataclasses.asdict(cell)
    tf = [(f.name, f.default) for f in dataclasses.fields(TB.TrainConfig)]
    jf = [(f.name, f.default) for f in dataclasses.fields(JB.TrainConfig)]
    assert tf == jf
    assert dataclasses.asdict(TB.TrainConfig()) == \
        dataclasses.asdict(JB.TrainConfig())


def test_all_cells_match_jax():
    for skips in (False, True):
        want = [(a, dataclasses.asdict(c), ok)
                for a, c, ok in JR.all_cells(include_skips=skips)]
        got = [(a, dataclasses.asdict(c), ok)
               for a, c, ok in TR.all_cells(include_skips=skips)]
        assert got == want
    assert len(want) == 40
    assert TR.LONG_CONTEXT_ARCHS == JR.LONG_CONTEXT_ARCHS
    for arch in JR.ARCH_IDS:
        for shape in JB.SHAPES:
            assert TR.cell_is_applicable(arch, shape) == \
                JR.cell_is_applicable(arch, shape)
    assert sorted(TC.__all__) == sorted(JC.__all__)
