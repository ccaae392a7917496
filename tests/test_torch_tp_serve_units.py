"""Units of serving over a model axis on the CPU, in one process: the
flash-decoding combine of ``models/layers.py`` against
``decode_attention`` on the whole cache, and the route on a one-rank
gloo group (a model axis of 1) bitwise equal to ``dist=None``.

The combine: a cache split into 2 and 4 slices, each slice's
``decode_partial`` at its offset, combined by hand (the running max over
the slices, each slice's sum and product weighted by exp(m_r - m)),
within 1e-6 of ``decode_attention`` (grouped and repeated), with a
softcap, a window, a ring's lengths, per-row lengths, and slices that
no row's slot in is valid (their weight exactly 0, no NaN).
"""
import datetime

import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed.shardings import make_dist
from repro_torch.launch.mesh import make_train_mesh
from repro_torch.models import layers as L
from torch_tp_serve_cases import CASES, STEPS, config, inputs, params_full

B, H, KH, D, SMAX = 3, 4, 2, 16, 32
# (per-row cache lengths, window): a window past some slices; a ring's
# lengths (pos + 1 clamped to its 32 slots); lengths that leave whole
# slices of row 0 masked
LENGTHS = {"window": ([32, 20, 9], 8), "ring": ([32, 32, 7], 0),
           "short": ([3, 17, 30], 0)}


def _cache(seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=g)
    k = torch.randn((B, SMAX, KH, D), generator=g)
    v = torch.randn((B, SMAX, KH, D), generator=g)
    return q, k, v


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("n", [2, 4])
def test_combine_of_slices_matches_decode_attention(n, lengths, softcap,
                                                    grouped):
    q, k, v = _cache(n)
    clen, window = LENGTHS[lengths]
    clen = torch.tensor(clen)
    if grouped:
        want = L.decode_attention_grouped(q, k, v, clen, window=window,
                                          softcap=softcap)
    else:
        want = L.decode_attention(q, L.repeat_kv(k, H // KH),
                                  L.repeat_kv(v, H // KH), clen,
                                  window=window, softcap=softcap)
    w = SMAX // n
    parts = [L.decode_partial(q, k[:, r * w:(r + 1) * w],
                              v[:, r * w:(r + 1) * w], clen, offset=r * w,
                              window=window, softcap=softcap,
                              grouped=grouped) for r in range(n)]
    m_r = torch.stack([p[0] for p in parts])                  # (n, B, H)
    m = m_r.amax(dim=0)
    wt = torch.exp(m_r - m)
    l = sum(p[1] * wt[r] for r, p in enumerate(parts))
    o = sum(p[2] * wt[r][..., None] for r, p in enumerate(parts))
    got = (o / l[..., None])[:, None]
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-6
    # a slice with no valid slot of a row weighs exactly 0
    kpos = torch.arange(SMAX)
    valid = kpos[None] < clen[:, None]
    if window:
        valid &= kpos[None] > clen[:, None] - 1 - window
    empty = [(r, b) for r in range(n) for b in range(B)
             if not bool(valid[b, r * w:(r + 1) * w].any())]
    assert empty
    for r, b in empty:
        assert bool((m_r[r, b] == L.NEG_INF).all())
        assert bool((parts[r][1][b] == 0).all())
        assert bool((wt[r, b] == 0).all())
    # on one rank flash_decode is the same combine of one slice
    one = L.flash_decode(q, k, v, clen, window=window, softcap=softcap,
                         grouped=grouped)
    assert float((one - want).abs().max()) <= 1e-6


# (KH, tp, window, max_seq) -> the slots a rank holds and the KVSlice of
# model rank 1: own KV heads (no rounding); the sequence split with
# max_seq rounded up to a multiple of tp -- a window cache becomes the
# ring once the rounded max_seq reaches the window, a non-ring cache is
# an exact slice, and a ring of a window that tp does not divide is held
# whole on every rank
LAYOUTS = [
    ((2, 2, 32, 30), (30, (0, 30, False, False))),
    ((2, 2, 32, 48), (32, (0, 32, True, False))),
    ((2, 4, 32, 29), (8, (8, 32, True, True))),
    ((2, 4, 32, 20), (5, (5, 20, False, True))),
    ((2, 4, 30, 48), (30, (0, 30, True, False))),
    ((2, 4, 30, 26), (7, (7, 28, False, True))),
    ((2, 4, 0, 134), (34, (34, 136, False, True))),
]


@pytest.mark.parametrize("spec,want", LAYOUTS)
def test_kv_layout_slots_and_slices(spec, want):
    """``kv_layout``'s slots of a cache and the ``KVSlice`` that a rank
    reads back from them and the layer's window: its offset, the
    global length, ring-ness and whether it is a slice."""
    from types import SimpleNamespace

    from repro_torch.models.cache_layout import kv_layout
    KH, tp, window, max_seq = spec
    cfg = SimpleNamespace(num_kv_heads=KH)
    d = SimpleNamespace(tp=tp, model_rank=1, model_axis="model",
                        kv_seq_shard=False)
    lay = kv_layout(cfg, d)
    slots = lay.slots(max_seq, window)
    assert (slots, tuple(lay.slice(slots, window))) == want


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group and its (1, 1) mesh's ``DistContext``."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield make_dist(make_train_mesh((1, 1), device="cpu"))
    finally:
        dist.destroy_process_group()


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_axis_of_one_is_bitwise_one_device(one_rank, case):
    """``init_cache``, ``prefill`` and the first decode step on a model
    axis of 1 equal ``dist=None`` bit for bit: the logits and every
    cache tensor."""
    from repro_torch.models import model as M
    cfg = config(case)
    params = params_full(cfg)
    batch, kw, steps, start, _ = inputs(cfg, case)
    out = []
    for d in (None, one_rank):
        caches = M.init_cache(cfg, steps.shape[0], CASES[case]["max_seq"],
                              "cpu", dist=d)
        with torch.no_grad():
            lp, caches = M.prefill(params, cfg, batch, caches, dist=d, **kw)
            ld, caches = M.decode_step(params, cfg, steps[:, :1], caches,
                                       start, dist=d)
        out.append((lp, ld, caches))
    assert STEPS >= 1 and _same(out[0], out[1])
