#!/usr/bin/env python3
"""Rehearse, on the CPU, how B12's bf16 kernel rounds p before p @ v.

    PYTHONPATH=src python3 rehearse_attention_rounding.py

The tensor-core kernel (``csrc/roi_attention.cu``) takes the online
softmax in steps of 64 keys and feeds p to the tensor cores in bf16.  This
script emulates that walk in float32 PyTorch -- q k^T in f32 from bf16
inputs, scaled, masked on original positions, the online-softmax update,
p rounded to one bf16 or split into bf16 hi + lo halves (the sum l taken
over the same rounded values) -- at the serving slice's packed positions
(the fleet stream of ``chip_smoke.py``, its masks drawn by the same
``chip_smoke.fleet_grids``: 9,472 rows, 3,268 kept, blocks of 128) and
D = 128, on 4 heads of seeded numpy inputs of four kinds, and
prints for each design the largest share of ``chip_smoke.py``'s
per-element bar |got - want| <= 2^-7 |want| + 1e-3 against
``ref.roi_attention`` on real rows.  The card draws other numbers, so this
decides the design; the check is ``chip_smoke.py`` on the card.
"""
import numpy as np
import torch

import chip_smoke as cs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.roi_attention import PAD_POS, block_min_positions


def emulate(q, k, v, pos, split, block=128, step=64):
    """The kernel's walk over each q-block's visited keys, in f32."""
    S, H, D = q.shape
    kmin = block_min_positions(pos, block)
    out = torch.zeros((S, H, D))
    qf, kf, vf = q.float(), k.float(), v.float()
    for qi in range(S // block):
        pq = pos[qi * block:(qi + 1) * block]
        real = pq != PAD_POS
        pmax = int(pq[real].max()) if real.any() else -1
        hits = (kmin <= pmax).nonzero()
        hi = int(hits.max()) + 1 if hits.numel() else 0
        if hi == 0:
            continue
        qb = qf[qi * block:(qi + 1) * block].permute(1, 0, 2)
        m = torch.full((H, block, 1), -1e30)
        l = torch.zeros((H, block, 1))
        acc = torch.zeros((H, block, D))
        for k0 in range(0, hi * block, step):
            kb = kf[k0:k0 + step].permute(1, 0, 2)
            vb = vf[k0:k0 + step].permute(1, 0, 2)
            s = (qb @ kb.transpose(1, 2)) / D ** 0.5
            seen = pq[:, None] >= pos[k0:k0 + step][None, :]
            s = torch.where(seen[None], s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            p_hi = p.bfloat16().float()
            p_used = p_hi + (p - p_hi).bfloat16().float() if split else p_hi
            l = l * alpha + p_used.sum(-1, keepdim=True)
            acc = acc * alpha + p_used @ vb
            m = m_new
        rows = slice(qi * block, (qi + 1) * block)
        out[rows] = (acc / l.clamp_min(1e-30)).permute(1, 0, 2)
    return out.to(q.dtype)


HEADS = 4


def main():
    keep = cs.fleet_keep(cs.fleet_grids(np.random.default_rng(cs.SEED)))
    _, pos, n_kept = ops.pack_tokens(torch.arange(keep.size),
                                     torch.as_tensor(keep))
    S, H, D = pos.shape[0], HEADS, cs.SLICE_HEAD_DIM
    print(f"S={S} kept={n_kept} H={H} D={D}")
    rng = np.random.default_rng(cs.SEED + 5)
    # (label, scale of q and k, offset of v): normal inputs, sharper
    # softmax rows, and v with a common offset, as deep layers give
    for label, qk, v_off in (("normal", 1.0, 0.0), ("q, k x3", 3.0, 0.0),
                             ("q, k x3, v + 0.5", 3.0, 0.5),
                             ("q, k x2, v + 1.5", 2.0, 1.5)):
        q, k = (torch.as_tensor(qk * rng.normal(size=(S, H, D)),
                                dtype=torch.float32).bfloat16()
                for _ in range(2))
        v = torch.as_tensor(v_off + rng.normal(size=(S, H, D)),
                            dtype=torch.float32).bfloat16()
        want = ref.roi_attention(q, k, v, pos)[0][:n_kept].float()
        for split in (False, True):
            got = emulate(q, k, v, pos, split)[:n_kept].float()
            d = (got - want).abs()
            share = float((d / (cs.ATTN_REL * want.abs() + cs.ATTN_ABS)).max())
            print(f"{label:18s} p in {'bf16 hi + lo' if split else 'one bf16':12s}"
                  f" max error {float(d.max()):.6f}  largest bar share "
                  f"{share:.4f}  median |want| {float(want.abs().median()):.5f}",
                  flush=True)


if __name__ == "__main__":
    main()
