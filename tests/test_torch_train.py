"""The port's training step for the dense and vlm families against the JAX
package, on the CPU: ``train_loss`` and its gradients, ``remat``,
``causal_skip``, the chunked cross-entropy, ``input_specs`` and
``make_batch``, ``DistContext``.

Every arch at SMOKE in float32, the JAX weights carried across, the same
numpy-seeded batch; the JAX side is ``jax.jit(jax.value_and_grad(
train_loss, remat=False))``.  Bars: the loss within 1e-5 x max(1,
|loss|), each gradient leaf within 1e-4 of its largest |g|; a bf16 arch's
loss within 2e-2, the serving bar.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.registry import all_cells as jall_cells
from repro.configs.registry import get_config as jget_config
from repro.models import forward as JF
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import ShapeCell, get_config
from repro_torch.models import forward as TF
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.dist import LOCAL, DistContext
from torch_train_cases import (assert_grads_close, batch, jax_loss_and_grads,
                               pair, port_loss_and_grads, port_params)

DENSE = ["h2o-danube3-4b", "gemma3-27b", "mistral-nemo-12b", "deepseek-67b",
         "internvl2-26b"]


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jp, npp = pair(arch)
    b = batch(cfg, seed=1)
    jl, _, jg = jax_loss_and_grads(jcfg, jp, b)
    loss, metrics, grads = port_loss_and_grads(cfg, port_params(npp), b,
                                               remat=False)
    assert metrics == {}
    assert abs(float(loss) - jl) <= 1e-5 * max(1.0, abs(jl))
    assert_grads_close(grads, jg)


def test_bf16_loss_matches_jax():
    """bfloat16 weights and activations: the loss within 2e-2, every
    gradient finite and in bfloat16."""
    jcfg, cfg, jp, npp = pair("h2o-danube3-4b", "bfloat16")
    b = batch(cfg, seed=2)
    jl, _, _ = jax_loss_and_grads(jcfg, jp, b)
    params = port_params(npp)
    loss, _, grads = port_loss_and_grads(cfg, params, b)
    assert abs(float(loss) - jl) <= 2e-2
    for k, g in grads.items():
        assert g.dtype == params[k].dtype, k
        assert bool(torch.isfinite(g.float()).all()), k


@pytest.mark.parametrize("arch", ["h2o-danube3-4b", "gemma3-27b",
                                  "internvl2-26b"])
def test_remat_equals_no_remat_bitwise(arch):
    """Recomputing the blocks in the backward pass changes no bit of the
    loss or of any gradient (a uniform windowed stack, gemma3's local,
    global and trailing layers, the vlm front)."""
    _, cfg, _, npp = pair(arch)
    b = batch(cfg, seed=3)
    params = port_params(npp)
    l0, _, g0 = port_loss_and_grads(cfg, params, b, remat=False)
    l1, _, g1 = port_loss_and_grads(cfg, params, b, remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# ---------------------------------------------------------------------------
# causal_skip
# ---------------------------------------------------------------------------

def _jax_skip(q, k, v, **kw):
    return jax.jit(functools.partial(JL.blockwise_attention, causal_skip=True,
                                     **kw))(*(jnp.asarray(a)
                                              for a in (q, k, v)))


def _qkv(S, seed, B=2, H=4, D=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("S,q_block,kv_chunk,softcap", [
    (64, 16, 32, 0.0),         # blocks of 16 over chunks of 32
    (96, 32, 16, 30.0),        # chunks smaller than blocks, softcap
    (256, 64, 128, 0.0),
    (100, 512, 1024, 0.0),     # one block: nothing to skip
])
def test_causal_skip_matches_jax_and_the_exhaustive_walk(S, q_block,
                                                         kv_chunk, softcap):
    """Within 1e-5 of JAX's causal skip, and bitwise the port's own
    exhaustive walk: a skipped chunk is fully masked for its rows, whose
    running max, denominator and accumulator it would leave as they
    are."""
    q, k, v = _qkv(S, S)
    kw = dict(q_block=q_block, kv_chunk=kv_chunk, softcap=softcap)
    want = _jax_skip(q, k, v, **kw)
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    got = TL.blockwise_attention(*tq, causal_skip=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(got, TL.blockwise_attention(*tq, **kw))


@pytest.mark.parametrize("S,q_block,kv_chunk", [(128, 16, 48), (60, 7, 16)])
def test_causal_skip_at_halved_blocks(S, q_block, kv_chunk):
    """Blocks halved to a few rows (kv_chunk 48 -> 1 at S = 128, 16 -> 4
    and q_block 7 -> 3 at S = 60): within 1e-5 of JAX and 1e-6 of the
    exhaustive walk, not bitwise -- the CPU BLAS takes another kernel for
    a product of a few rows, so a row's scores move by an ulp."""
    q, k, v = _qkv(S, S + 1)
    kw = dict(q_block=q_block, kv_chunk=kv_chunk)
    want = _jax_skip(q, k, v, **kw)
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    got = TL.blockwise_attention(*tq, causal_skip=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), TL.blockwise_attention(*tq, **kw).numpy(), atol=1e-6)


def test_causal_skip_applies_only_where_jax_applies_it():
    """Non-causal, cross (Sq != Skv) and windowed attention take the
    exhaustive walk or the band, as the JAX package does."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(64, 9))
    kw = dict(q_block=16, kv_chunk=16)
    for extra in (dict(causal=False), dict(window=24)):
        assert torch.equal(
            TL.blockwise_attention(q, k, v, causal_skip=True, **kw, **extra),
            TL.blockwise_attention(q, k, v, **kw, **extra))
    kx = k[:, :32]
    assert torch.equal(
        TL.blockwise_attention(q, kx, v[:, :32], causal_skip=True, **kw),
        TL.blockwise_attention(q, kx, v[:, :32], **kw))


def test_train_loss_causal_skip_matches_jax():
    """mistral-nemo at S = 2,048, past the default blocks (4 query blocks
    of 512, 2 chunks of 1,024): the loss and gradients with causal_skip
    against JAX's with causal_skip; the port's loss bitwise its
    exhaustive walk's, the gradients within 1e-6 of theirs."""
    jcfg, cfg, jp, npp = pair("mistral-nemo-12b")
    b = batch(cfg, seed=4, B=1, S=2048)
    jl, _, jg = jax_loss_and_grads(jcfg, jp, b, causal_skip=True)
    params = port_params(npp)
    loss, _, grads = port_loss_and_grads(cfg, params, b, causal_skip=True)
    assert abs(float(loss) - jl) <= 1e-5 * max(1.0, abs(jl))
    assert_grads_close(grads, jg)
    l_ex, _, g_ex = port_loss_and_grads(cfg, params, b)
    assert torch.equal(loss, l_ex)
    assert_grads_close(grads, {k: v.numpy() for k, v in g_ex.items()},
                       rel=1e-6)


# ---------------------------------------------------------------------------
# the cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(24, 16), (40, 512), (64, 16)])
def test_chunked_ce_and_cross_entropy_match_jax(S, chunk):
    """S = 24 halves the chunk 16 -> 8 (three chunks), S = 40 takes one
    chunk of 40, S = 64 four of 16; tied and untied embeddings."""
    rng = np.random.default_rng(S)
    for arch in ("mistral-nemo-12b", "deepseek-67b"):
        jcfg, cfg, jp, npp = pair(arch)
        x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
        want = JF.chunked_ce(jp, jcfg, jnp.asarray(x), jnp.asarray(labels),
                             chunk=chunk)
        tp = port_params(npp)
        got = TF.chunked_ce(tp, cfg, torch.from_numpy(x),
                            torch.from_numpy(labels), chunk=chunk)
        assert got.dtype == torch.float32
        got = got.detach()
        assert abs(float(got) - float(want)) <= 1e-5 * max(1, abs(float(want)))
    logits = rng.normal(size=(3, S, 50)).astype(np.float32) * 4
    lab = rng.integers(0, 50, (3, S))
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
    assert abs(float(got) - float(want)) <= 1e-6 * max(1, abs(float(want)))


def test_cross_entropy_grad_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 7, 33)).astype(np.float32) * 3
    lab = rng.integers(0, 33, (4, 7))
    want = jax.grad(JL.cross_entropy)(jnp.asarray(logits), jnp.asarray(lab))
    t = torch.from_numpy(logits).requires_grad_(True)
    TL.cross_entropy(t, torch.from_numpy(lab)).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-7)


# ---------------------------------------------------------------------------
# input specs, batches, the one-device context
# ---------------------------------------------------------------------------

def test_input_specs_match_jax_for_every_cell():
    """Every (arch, cell) of the grid, skips included, and a train cell at
    SMOKE: the same names, shapes and dtypes, as meta tensors."""
    cells = [(a, c) for a, c, _ in jall_cells(include_skips=True)]
    cells += [(a, JShapeCell("smoke_train", 64, 2, "train"))
              for a in dict(cells)]
    assert len(cells) == 50
    for arch, jcell in cells:
        for smoke in (False, True):
            want = JM.input_specs(jget_config(arch, smoke), jcell)
            got = TM.input_specs(get_config(arch, smoke),
                                 ShapeCell(jcell.name, jcell.seq_len,
                                           jcell.global_batch, jcell.kind))
            assert sorted(got) == sorted(want), arch
            for k, s in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == s.shape, (arch, k)
                assert str(got[k].dtype).split(".")[1] == s.dtype.name


def test_make_batch_draws_the_specs():
    cfg = get_config("internvl2-26b", smoke=True)
    cell = ShapeCell("t", 32, 3, "train")
    gen = torch.Generator().manual_seed(7)
    b = TM.make_batch(cfg, cell, gen, device="cpu")
    specs = TM.input_specs(cfg, cell)
    assert sorted(b) == sorted(specs)
    for k, v in b.items():
        assert v.shape == specs[k].shape and v.dtype == specs[k].dtype
    assert int(b["tokens"].min()) >= 0
    assert int(b["tokens"].max()) < cfg.vocab_size
    again = TM.make_batch(cfg, specs, torch.Generator().manual_seed(7),
                          device="cpu")
    for k in b:
        assert torch.equal(b[k], again[k])
    loss, _ = TM.train_loss(port_params(pair("internvl2-26b")[3]),
                            cfg.replace(dtype="float32"),
                            dict(b, patches=b["patches"].float()))
    assert bool(torch.isfinite(loss))


def test_one_device_context():
    """``LOCAL`` and ``DistContext()`` are one device (tp = dp = 1, no
    expert parallelism) and leave the loss as ``dist=None`` does; a mesh
    with a model axis above 1 is tensor parallelism (tp 2, A6d), under
    which a serving cache holds each rank's KV heads (A6e)."""
    assert LOCAL.mesh is None and LOCAL.tp == 1 and LOCAL.dp == 1
    assert not DistContext(auto_moe=True).manual_moe
    tp2 = DistContext(mesh=SimpleNamespace(shape={"data": 1, "model": 2}))
    assert tp2.tp == 2 and tp2.dp == 1
    kcfg = get_config("h2o-danube3-4b", smoke=True)
    k, _ = TM.init_cache(kcfg, 1, 8, "cpu", dist=tp2)["blocks"]
    assert k.shape == (kcfg.num_layers, 1, 8, kcfg.num_kv_heads // 2,
                       kcfg.head_dim)
    _, cfg, _, npp = pair("deepseek-moe-16b")
    b = {k: torch.from_numpy(v) for k, v in batch(cfg, seed=6).items()}
    params = port_params(npp)
    l0, m0 = TM.train_loss(params, cfg, b)
    l1, m1 = TM.train_loss(params, cfg, b, dist=LOCAL)
    assert torch.equal(l0, l1) and m0.keys() == m1.keys()
