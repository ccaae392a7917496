"""Mamba2 (SSD) blocks, the port's copy of ``repro.models.ssm``: a chunked
parallel scan for prefill and an O(1)-state recurrent step for decode.

Math (per head h, head dim P, state dim N, one group):
    a_t     = exp(dt_t * A_h)                      (scalar decay per head/step)
    state_t = a_t * state_{t-1} + dt_t * B_t (x) x_t^T    state: (N, P)
    y_t     = C_t . state_t + D_h * x_t

Chunked (chunk Q): intra-chunk is a masked attention-like product M[t, s]
= (C_t . B_s) * exp(la_t - la_s) * dt_s (s <= t; the exponent is masked
before ``exp``, since masked pairs have positive exponents), and the
(B, H, N, P) state carries between chunks.  The JAX package scans the
chunks; here every chunk's own terms run at once and only the carry is a
loop (one multiply-add a chunk), in the scan's order.  All SSD math runs
in float32.

Over a model group (training) ``in_proj`` is split on its last dim and
``out_proj`` on its first, as the JAX package's sharding rules split
them.  The contiguous split of ``in_proj``'s ``[z | x | B | C | dt]``
does not line up with those segments, and B and C are shared by every
head, so the product is gathered whole and the block runs replicated up
to ``out_proj``, whose rank takes its rows of the gated output.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import (copy_to, gather_last,
                                                     reduce_from,
                                                     scatter_last, split_dim)
from repro_torch.models.layers import activation, rmsnorm


class MambaState(NamedTuple):
    ssm: torch.Tensor   # (B, H, N, P) f32
    conv: torch.Tensor  # (B, cw - 1, conv_dim): the causal conv's FIR tail


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.ssm_inner + 2 * cfg.ssm_state_dim


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal FIR conv.  x: (B, S, Cd); w: (cw, Cd); b: (Cd,);
    ``tail``: (B, cw - 1, Cd), the previous segment's last inputs.  Returns
    (y (B, S, Cd) in x's dtype, the new tail).  The tail joins x in their
    promoted dtype, as ``jnp.concatenate`` promotes: a bfloat16 tail
    meeting float32 inputs comes back float32."""
    B, S, Cd = x.shape
    cw = w.shape[0]
    if tail is None:
        tail = torch.zeros((B, cw - 1, Cd), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(tail.dtype, x.dtype)
    xp = torch.cat([tail.to(dt), x.to(dt)], dim=1)
    y = torch.zeros((B, S, Cd), dtype=torch.float32, device=x.device)
    for i in range(cw):     # cw is 4: shifted adds, no conv primitive
        y = y + xp[:, i:i + S].float() * w[i].float()
    y = y + b.float()
    new_tail = xp[:, S:S + cw - 1] if cw > 1 else tail
    return activation(y, "silu").to(x.dtype), new_tail


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD.  xh: (B, S, H, P); dt: (B, S, H) f32 (after softplus);
    A_log: (H,); Bc, Cc: (B, S, N).  ``chunk`` is halved until it divides
    S.  Returns (y (B, S, H, P) f32, the final state)."""
    B, S, H, P = xh.shape
    N = Bc.shape[-1]
    chunk = max(1, min(chunk, S))
    while S % chunk:
        chunk //= 2
    nc = S // chunk
    dev = xh.device
    a = dt * (-torch.exp(A_log.float()))[None, None, :]   # (B, S, H) <= 0

    xq = xh.float().reshape(B, nc, chunk, H, P)
    dtq = dt.reshape(B, nc, chunk, H)
    aq = a.reshape(B, nc, chunk, H)
    Bq = Bc.float().reshape(B, nc, chunk, N)
    Cq = Cc.float().reshape(B, nc, chunk, N)
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=dev) \
        if init_state is None else init_state
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dev))

    # (B,c,Q,H), summed in float64 and rounded once, as the CPU's float32
    # cumsum does (CUDA's sums in float32; exp turns that rounding into
    # relative errors)
    la = torch.cumsum(aq.double(), dim=2).float()
    # intra-chunk: M[t,s,h] = (C_t.B_s) exp(la_t - la_s) dt_s (s <= t),
    # the exponent masked before exp
    CB = torch.einsum("bctn,bcsn->bcts", Cq, Bq)
    expo = la[:, :, :, None, :] - la[:, :, None, :, :]    # (B,c,t,s,H)
    expo = torch.where(tril[None, None, :, :, None], expo, -torch.inf)
    M = CB[..., None] * torch.exp(expo) * dtq[:, :, None, :, :]
    del expo
    y = torch.einsum("bctsh,bcshp->bcthp", M, xq)
    del M
    # the state update's terms
    w_in = torch.exp(la[:, :, -1:, :] - la) * dtq          # (B,c,Q,H)
    adds = torch.einsum("bcsn,bcshp->bchnp", Bq, xq * w_in[..., None])
    decay = torch.exp(la[:, :, -1, :])                    # (B,c,H)
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * decay[:, c][:, :, None, None] + adds[:, c]
    # inter-chunk: y_inter[t] = exp(la_t) * C_t . (the chunk's start state)
    y = y + torch.einsum("bctn,bchnp->bcthp", Cq, torch.stack(
        starts, dim=1)) * torch.exp(la)[..., None]
    return y.reshape(B, S, H, P), state


def ssd_step(state: torch.Tensor, xh: torch.Tensor, dt: torch.Tensor,
             A_log: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor):
    """One token.  xh: (B, 1, H, P); dt: (B, 1, H); Bc, Cc: (B, 1, N);
    state: (B, H, N, P).  Returns (y (B, 1, H, P) f32, the new state)."""
    a = torch.exp(dt[:, 0] * (-torch.exp(A_log.float()))[None, :])  # (B, H)
    upd = torch.einsum("bn,bhp,bh->bhnp", Bc[:, 0].float(),
                       xh[:, 0].float(), dt[:, 0])
    state_new = state * a[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), state_new)
    return y[:, None], state_new


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba2_block(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 state: Optional[MambaState] = None,
                 single_step: bool = False, dist=None):
    """x: (B, S, D).  p keys: in_proj (D, 2 inner + 2N + H), conv_w (cw,
    inner + 2N), conv_b, A_log (H,), D_skip (H,), dt_bias (H,), norm_w
    (inner,), out_proj (inner, D).  Returns (y, the new state); ``state``
    seeds the conv tail and the SSD state (zeros without it).  Over a
    model group (``dist``) as the module's docstring says."""
    B, S, _ = x.shape
    inner, N, H = cfg.ssm_inner, cfg.ssm_state_dim, cfg.ssm_num_heads
    P = cfg.ssm_head_dim

    if split_dim(p["in_proj"].shape[-1], 2 * inner + 2 * N + H, dist):
        zxbcdt = gather_last(copy_to(x, dist) @ p["in_proj"], dist)
    else:
        zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:2 * inner + 2 * N]
    dt_raw = zxbcdt[..., 2 * inner + 2 * N:]

    tail = state.conv if state is not None else None
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], tail)
    xc = xbc[..., :inner]
    Bc = xbc[..., inner:inner + N]
    Cc = xbc[..., inner + N:]

    dt = _softplus(dt_raw.float() + p["dt_bias"].float())
    xh = xc.reshape(B, S, H, P)

    prev = state.ssm if state is not None else None
    if single_step:
        assert prev is not None
        y, new_ssm = ssd_step(prev, xh, dt, p["A_log"], Bc, Cc)
    else:
        y, new_ssm = ssd_chunked(xh, dt, p["A_log"], Bc, Cc, cfg.ssm_chunk,
                                 init_state=prev)
    y = y + p["D_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, inner).to(x.dtype)
    y = y * activation(z, "silu")
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps)
    if split_dim(p["out_proj"].shape[0], inner, dist):
        return reduce_from(scatter_last(y, dist) @ p["out_proj"], dist), \
            MambaState(new_ssm, new_tail)
    return y @ p["out_proj"], MambaState(new_ssm, new_tail)
