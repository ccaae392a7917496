"""The port's training step for the recurrent and encoder-decoder
families (rwkv6-7b's ``ssm``, zamba2-2.7b's Mamba2 ``hybrid``,
whisper-small's ``encdec``) against the JAX package, on the CPU.

At SMOKE in float32 with the JAX weights carried across and the same
numpy-seeded batch: the loss within 1e-5 x max(1, |loss|), each gradient
leaf within 1e-4 of its largest |g|.  The WKV and SSD chunk carries,
the masked exponents before ``exp`` and zamba2's shared blocks (their
gradients summed over every application) all sit on this path.
"""
import jax.numpy as jnp
import pytest
import torch

from torch_train_cases import (assert_grads_close, batch, jax_loss_and_grads,
                               pair, port_loss_and_grads, port_params)

ARCHS = ["rwkv6-7b", "zamba2-2.7b", "whisper-small"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jp, npp = pair(arch)
    b = batch(cfg, seed=21)
    jl, jm, jg = jax_loss_and_grads(jcfg, jp, b)
    loss, metrics, grads = port_loss_and_grads(cfg, port_params(npp), b,
                                               remat=False)
    assert metrics == {} == jm
    assert abs(float(loss) - jl) <= 1e-5 * max(1.0, abs(jl))
    assert_grads_close(grads, jg)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bitwise(arch):
    """Each RWKV6 block, each Mamba2 block (not the shared attention) and
    each encoder and decoder block recomputed in the backward pass: the
    loss and every gradient bitwise."""
    _, cfg, _, npp = pair(arch)
    b = batch(cfg, seed=22)
    params = port_params(npp)
    l0, _, g0 = port_loss_and_grads(cfg, params, b, remat=False)
    l1, _, g1 = port_loss_and_grads(cfg, params, b, remat=True)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_bf16_frames_train():
    """whisper in bfloat16 with bfloat16 frames, as ``input_specs`` gives
    them: the loss within the serving bar of JAX's, the gradients
    finite."""
    jcfg, cfg, jp, npp = pair("whisper-small", "bfloat16")
    b = batch(cfg, seed=23)
    jl, _, _ = jax_loss_and_grads(
        jcfg, jp, dict(b, frames=b["frames"].astype(jnp.bfloat16)))
    loss, _, grads = port_loss_and_grads(
        cfg, port_params(npp),
        dict(b, frames=torch.from_numpy(b["frames"]).bfloat16()))
    assert abs(float(loss) - jl) <= 2e-2
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads.values())
