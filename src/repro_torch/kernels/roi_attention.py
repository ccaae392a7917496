"""RoI-packed prefill attention (CUDA kernel in ``csrc/roi_attention.cu``:
bf16 on the tensor cores, f32 on the CUDA cores).

Flash attention over the tokens ``ops.pack_tokens`` packs: causality
follows the tokens' ORIGINAL positions (``pos_q >= pos_k``), padding rows
carry ``PAD_POS`` (never attended by a real row), and with ``causal_skip``
each q-block walks only the k-blocks up to the last one whose minimum
position can be attended -- the bound ``block_min_positions`` feeds.
Skipped and exhaustive walks are bitwise equal on real rows; the visited
counts per (head, q-block) come back beside the output.  The kernel has
instances for the head dims ``HEAD_DIMS``; any other head dim up to 128
runs zero-padded to the next one (``pad_head_dim``).  It takes the q-blocks
``BLOCKS_Q`` and k-blocks of whole ``SUB_CHUNK``s; other blocks that divide
S run on the nearest instance (``kernel_blocks``) over the tokens padded
with ``PAD_POS`` rows, and their visited counts come from the positions
(``visit_bounds``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

PAD_POS = 2 ** 31 - 1          # INT32_MAX, on padding rows
HEAD_DIMS = (16, 32, 64, 128)
BLOCKS_Q = (32, 64, 128)
SUB_CHUNK = 32                 # block_k must be a multiple of this


def block_min_positions(positions: torch.Tensor,
                        block_k: int) -> torch.Tensor:
    """Per-k-block minimum original position, (S // block_k,) int32.
    For the packed layout it is ``positions[::block_k]``; the segment
    minimum stays right for any position vector."""
    S = positions.shape[0]
    return positions.reshape(S // block_k, block_k).amin(dim=1)


def visit_bounds(positions: torch.Tensor, block_q: int, block_k: int,
                 causal_skip: bool = True) -> torch.Tensor:
    """Each q-block's visit bound ``hi`` (S // block_q,): it walks
    k-blocks [0, hi), hi = 1 + the last k-block whose minimum position is
    at most the q-block's largest real position (0 without a real row);
    every k-block without ``causal_skip``."""
    S = positions.shape[0]
    nq, nk = S // block_q, S // block_k
    if not causal_skip:
        return torch.full((nq,), nk, dtype=torch.int64,
                          device=positions.device)
    kmin = block_min_positions(positions, block_k)
    pos_q = positions.reshape(nq, block_q)
    pmax = torch.where(pos_q != PAD_POS, pos_q, -1).amax(dim=1)
    hits = kmin[None, :] <= pmax[:, None]
    j = torch.arange(1, nk + 1, device=positions.device)
    return torch.where(hits, j, 0).amax(dim=1)


def kernel_blocks(block_q: int, block_k: int):
    """The kernel instance's (block_q, block_k) for the caller's blocks:
    the blocks themselves where the kernel takes them, else the next
    q-block of ``BLOCKS_Q`` (the largest past it) and the k-block rounded
    up to whole ``SUB_CHUNK``s."""
    bq = block_q if block_q in BLOCKS_Q else min(
        [b for b in BLOCKS_Q if b >= block_q], default=BLOCKS_Q[-1])
    return bq, -(-block_k // SUB_CHUNK) * SUB_CHUNK


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v (S, H, D) zero-padded on the last axis to the next kernel
    instance in ``HEAD_DIMS`` (fresh contiguous tensors; as given where D
    is one), and the softmax scale 1/sqrt(D) of the original D.  Exact:
    the zero columns add zero products to every q.k and give zero output
    columns, which the caller drops.  Raises for D outside 1..128."""
    D = q.shape[-1]
    if not 1 <= D <= HEAD_DIMS[-1]:
        raise ValueError(f"roi_attention: takes head_dim 1 to "
                         f"{HEAD_DIMS[-1]}, got D={D}")
    width = min(d for d in HEAD_DIMS if d >= D)
    if width != D:
        q, k, v = (torch.nn.functional.pad(t, (0, width - D))
                   for t in (q, k, v))
    return q, k, v, 1.0 / D ** 0.5


def roi_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, block_q: int = 128,
                  block_k: int = 128, causal_skip: bool = True):
    """q, k, v: (S, H, D) float32 or bfloat16 packed tokens, D at most
    128; positions: (S,) int32 original positions (``PAD_POS`` on padding
    rows); block_q and block_k divide S.  Returns (out (S, H, D) in q's
    dtype, visited (H, S // block_q) int32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, at the padded head dim where
    D is not an instance's.  Blocks the kernel has no instance for run
    on ``kernel_blocks``' instance over the tokens padded to whole blocks
    of it with zero rows at ``PAD_POS``: no real row attends a padding
    key, and a fully masked softmax step leaves a row's bits as they are,
    so real rows equal that instance's launch on the unpadded tokens;
    ``visited`` is then ``visit_bounds`` at the caller's blocks."""
    if q.device.type == "cpu":
        return ref.roi_attention(q, k, v, positions, block_q, block_k,
                                 causal_skip)
    name = "roi_attention"
    dev = _build.cuda_device(name, q, k, v, positions)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    _build.expect(name, "q", q, q.dtype, (None,) * 3)
    S, H, D = q.shape
    _build.expect(name, "k", k, q.dtype, (S, H, D))
    _build.expect(name, "v", v, q.dtype, (S, H, D))
    _build.expect(name, "positions", positions, torch.int32, (S,))
    if block_q <= 0 or block_k <= 0 or S % block_q or S % block_k:
        raise ValueError(f"{name}: S={S} must divide by block_q={block_q} "
                         f"and block_k={block_k} (pack_tokens pads)")
    bq, bk = kernel_blocks(block_q, block_k)
    q, k, v, scale = pad_head_dim(q, k, v)
    Sp = -(-S // math.lcm(bq, bk)) * math.lcm(bq, bk)
    if Sp != S:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Sp - S))
                   for t in (q, k, v))
        positions = torch.nn.functional.pad(positions, (0, Sp - S),
                                            value=PAD_POS)
    if q.dtype == torch.bfloat16 and \
            any(t.data_ptr() % 16 for t in (q, k, v, positions)):
        raise ValueError(f"{name}: bfloat16 q, k, v and positions must start "
                         f"on a 16-byte boundary (the kernel copies 16-byte "
                         f"rows)")
    out = torch.empty_like(q)
    visited = torch.empty((H, Sp // bq), dtype=torch.int32, device=dev)
    if S:
        kmin = block_min_positions(positions, bk).contiguous()
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.roi_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                positions.data_ptr(), kmin.data_ptr(), out.data_ptr(),
                visited.data_ptr(), Sp, H, q.shape[-1], bq, bk,
                int(causal_skip), int(q.dtype == torch.bfloat16), scale,
                _build.stream_handle(dev))
        _build.check(err, name)
        _build.LAUNCHES[name] += 1
    if (bq, bk) != (block_q, block_k):
        visited = visit_bounds(positions[:S], block_q, block_k, causal_skip
                               ).to(torch.int32)[None].expand(
                                   H, S // block_q).contiguous()
    if Sp != S or out.shape[-1] != D:
        out = out[:S, :, :D].contiguous()
    return out, visited
