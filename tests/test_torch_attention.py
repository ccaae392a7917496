"""The port's packed attention (B12) and token packing against the JAX
package, on the CPU.

The Pallas kernel cannot be the oracle: on this image's jax it does not
trace (``pl.load`` is gone, ROADMAP C-R1).  The port's plain version --
what its wrapper runs on CPU tensors -- is held against
``repro.kernels.ref.roi_attention`` on real rows, and its visited counts
against ``repro.kernels.ops.attention_visit_bound``; the packing helpers
are pure jnp and run live, so the port's must equal them bit for bit.
The CUDA kernel meets the same plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops, ref as jref
from repro.kernels import roi_attention as jattn
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.kernels import roi_attention as tattn

PAD = int(jattn.PAD_POS)


def _packed_positions(rng, S, n_kept, span=4):
    pos = np.full(S, PAD, np.int32)
    pos[:n_kept] = np.sort(rng.choice(span * S, n_kept, replace=False))
    return pos


def _qkv(rng, S, H, D):
    return [rng.normal(size=(S, H, D)).astype(np.float32) for _ in range(3)]


def test_pad_pos_is_the_reference_s():
    assert tattn.PAD_POS == tops.PAD_POS == PAD


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 0.05)])
@pytest.mark.parametrize("S,H,D,bq,bk", [
    (128, 2, 32, 64, 64),
    (256, 4, 64, 128, 128),
    (256, 1, 128, 64, 128),
    (256, 2, 120, 64, 128),       # h2o-danube3-4b's head dim
    (128, 2, 24, 64, 64),
])
def test_plain_attention_matches_reference(dtype, tol, S, H, D, bq, bk):
    """The sweep of tests/test_kernels.py: the port's entry point on CPU
    tensors against the JAX package's ``ref.roi_attention``, on real rows;
    the skipped and exhaustive walks bitwise equal there."""
    rng = np.random.default_rng(S + D)
    q, k, v = _qkv(rng, S, H, D)
    n_kept = int(0.8 * S)
    pos = _packed_positions(rng, S, n_kept)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jref.roi_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(pos)),
        np.float32)
    # jnp's bf16 rounding of the inputs, as the JAX test feeds them
    tq, tk, tv = (torch.from_numpy(np.array(jnp.asarray(a, jdt), np.float32))
                  .to(getattr(torch, dtype)) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    with tops.count_kernels() as c:
        out = tops.roi_attention(tq, tk, tv, tpos, bq, bk)
        full = tops.roi_attention(tq, tk, tv, tpos, bq, bk,
                                  causal_skip=False)
    assert c == {"roi_attention": 2}
    assert out.dtype == tq.dtype and out.shape == (S, H, D)
    np.testing.assert_allclose(out[:n_kept].float().numpy(), want[:n_kept],
                               atol=tol, rtol=tol)
    assert torch.equal(out[:n_kept], full[:n_kept])


@pytest.mark.parametrize("D,width", [(120, 128), (24, 32)])
def test_head_dim_padding_equals_the_unpadded_plain_version(D, width):
    """The CUDA wrapper's head-dim padding on CPU tensors: zero columns up
    to the next kernel instance, the scale of the original D, then the
    slice -- through the plain version equal to the plain version at D
    (f32, 1e-6: the products sum over other widths), zero in the padded
    columns, the same visited counts."""
    rng = np.random.default_rng(D)
    S, H = 256, 2
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, S, H, D))
    pos = torch.from_numpy(_packed_positions(rng, S, 200))
    qp, kp, vp, scale = tattn.pad_head_dim(q, k, v)
    assert scale == 1.0 / D ** 0.5
    for t, a in ((qp, q), (kp, k), (vp, v)):
        assert t.shape == (S, H, width) and t.is_contiguous()
        assert torch.equal(t[..., :D], a) and not t[..., D:].any()
    got, vis = tref.roi_attention(qp, kp, vp, pos, 64, 128, scale=scale)
    want, want_vis = tref.roi_attention(q, k, v, pos, 64, 128)
    assert not got[..., D:].any()
    np.testing.assert_allclose(got[..., :D].numpy(), want.numpy(),
                               atol=1e-6, rtol=0)
    assert torch.equal(vis, want_vis)
    same = torch.zeros((4, 1, 64))
    assert tattn.pad_head_dim(same, same, same)[0] is same
    for bad in (0, 136):
        z = torch.zeros((4, 1, bad))
        with pytest.raises(ValueError):
            tattn.pad_head_dim(z, z, z)


def test_dense_positions_equal_plain_causal():
    """keep = all, positions = arange: plain causal attention."""
    rng = np.random.default_rng(21)
    S, H, D = 128, 2, 32
    q, k, v = _qkv(rng, S, H, D)
    out = tops.roi_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             torch.arange(S, dtype=torch.int32), 64, 64)
    logits = jnp.einsum("qhd,khd->hqk", q, k) / np.sqrt(D)
    logits = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None], logits,
                       -1e30)
    want = jnp.einsum("hqk,khd->qhd", jax.nn.softmax(logits, axis=-1), v)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("S,H,D,bq,bk,keep_frac", [
    (256, 2, 32, 32, 32, 0.25),
    (256, 2, 32, 32, 32, 0.6),
    (512, 1, 16, 64, 64, 0.25),
])
def test_visit_bounds_equal_the_reference(S, H, D, bq, bk, keep_frac):
    """The block-skip shapes of tests/test_packed_path.py: the block
    minima and the host visit bound equal JAX's, the plain version's
    visited counts equal the bound for every head, and it agrees with the
    reference on real rows."""
    rng = np.random.default_rng(6)
    n_kept = int(keep_frac * S)
    pos = _packed_positions(rng, S, n_kept)
    np.testing.assert_array_equal(
        tattn.block_min_positions(torch.from_numpy(pos), bk).numpy(),
        np.asarray(jattn.block_min_positions(jnp.asarray(pos), bk)))
    bound = tops.attention_visit_bound(pos, bq, bk)
    np.testing.assert_array_equal(bound,
                                  jops.attention_visit_bound(pos, bq, bk))
    q, k, v = _qkv(rng, S, H, D)
    out, vis = tops.roi_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  torch.from_numpy(pos), bq, bk,
                                  return_stats=True)
    assert vis.dtype == torch.int32 and vis.shape == (H, S // bq)
    np.testing.assert_array_equal(vis.numpy(),
                                  np.broadcast_to(bound, (H, S // bq)))
    want = np.asarray(jref.roi_attention(q, k, v, jnp.asarray(pos)))
    np.testing.assert_allclose(out[:n_kept].numpy(), want[:n_kept],
                               atol=2e-5)
    _, vis_full = tref.roi_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)),
                                     torch.from_numpy(pos), bq, bk, False)
    assert (vis_full == S // bk).all()
    real_q = -(-n_kept // bq)
    if S // bq == S // bk:            # the packed prefix's lower triangle
        assert bound.sum() == real_q * (real_q + 1) // 2


# blocks that divide S but that the kernel has no instance for (C1): the
# CUDA route runs them on kernel_blocks' instance over padded tokens and
# takes the visited counts from visit_bounds at the caller's blocks
ANY_BLOCKS = [(96, 16, 16), (96, 16, 48), (96, 48, 32), (512, 256, 128),
              (512, 256, 16), (192, 96, 64), (256, 32, 32), (384, 128, 96)]


@pytest.mark.parametrize("S,bq,bk", ANY_BLOCKS)
@pytest.mark.parametrize("keep_frac", [0.0, 0.3, 1.0])
def test_visit_bounds_at_any_dividing_blocks(S, bq, bk, keep_frac):
    """The CUDA route's visited counts at blocks outside the kernel's
    instances: ``visit_bounds`` equals the JAX package's host bound, the
    plain version's visited counts (every k-block without the skip), and
    the instance ``kernel_blocks`` picks takes the padded length."""
    rng = np.random.default_rng(S + bq + bk)
    n_kept = int(keep_frac * S)
    pos = _packed_positions(rng, S, n_kept)
    tpos = torch.from_numpy(pos)
    hi = tattn.visit_bounds(tpos, bq, bk)
    np.testing.assert_array_equal(hi.numpy(),
                                  jops.attention_visit_bound(pos, bq, bk))
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, S, 2, 16))
    _, vis = tref.roi_attention(q, k, v, tpos, bq, bk)
    assert torch.equal(vis, hi.to(torch.int32)[None].expand(2, S // bq))
    assert (tattn.visit_bounds(tpos, bq, bk, causal_skip=False)
            == S // bk).all()
    kq, kk = tattn.kernel_blocks(bq, bk)
    assert kq in tattn.BLOCKS_Q and kk % tattn.SUB_CHUNK == 0
    assert kq >= min(bq, tattn.BLOCKS_Q[-1]) and bk <= kk < bk + 32
    if bq in tattn.BLOCKS_Q and bk % tattn.SUB_CHUNK == 0:
        assert (kq, kk) == (bq, bk)


def test_all_padding_stream_gives_zeros():
    S = 128
    pos = torch.full((S,), PAD, dtype=torch.int32)
    q = torch.ones((S, 1, 16))
    out, vis = tops.roi_attention(q, q, q, pos, 64, 64, return_stats=True)
    assert int(vis.sum()) == 0
    assert float(out.abs().max()) == 0.0
    assert tops.attention_visit_bound(pos.numpy(), 64, 64).sum() == 0


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(10, 200))
def test_pack_unpack_bitwise_against_reference(seed, S):
    """The numpy seeds of tests/test_kernels.py: packed rows, positions,
    n_kept and the unpacked stream equal the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(S, 3)).astype(np.float32)
    keep = rng.random(S) < 0.6
    jp, jpos, jn = jops.pack_tokens(jnp.asarray(x), jnp.asarray(keep),
                                    block=64)
    tp, tpos, tn = tops.pack_tokens(torch.from_numpy(x),
                                    torch.from_numpy(keep), block=64)
    assert tn == int(jn) == int(keep.sum())
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tpos.dtype == torch.int32
    restored = tops.unpack_tokens(tp, tpos, S)
    np.testing.assert_array_equal(
        restored.numpy(), np.asarray(jops.unpack_tokens(jp, jpos, S)))
    np.testing.assert_array_equal(restored.numpy(),
                                  np.where(keep[:, None], x, 0.0))
