"""Deterministic synthetic LM data, the port's copy of ``repro.data.lm``.

Stateless indexing: ``batch(step, shard, num_shards)`` is a pure function
of (seed, step, shard), so a restart replays the exact stream from the
restored step counter with no pipeline state to checkpoint.

Two generators:
  markov  -- an order-1 Markov chain with a banded transition (each token
             within +-band of the one before, mod the vocabulary) plus a
             repeated span (an induction pattern): a learnable signal, so
             a training loss visibly falls.
  uniform -- iid tokens (for pure-throughput runs).

Each (seed, step, shard) seeds its own CPU ``torch.Generator``; the batch
is drawn there and moved to the device, so the card and the CPU see the
same tokens.  The bits differ from the JAX package's threefry stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeCell


def lm_batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict:
    from repro_torch.models.model import input_specs
    return input_specs(cfg, cell)


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    mode: str = "markov"
    seed: int = 0
    band: int = 64          # markov: next token within +-band of current
    repeat_frac: float = 0.25  # fraction of each row that repeats a prefix

    def _generator(self, step: int, shard: int) -> torch.Generator:
        """The CPU generator of (seed, step, shard)."""
        state = np.random.SeedSequence([self.seed, step, shard])
        return torch.Generator().manual_seed(
            int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def batch(self, step: int, shard: int = 0, num_shards: int = 1,
              device=None) -> Dict[str, torch.Tensor]:
        """The global batch for ``step`` (or this shard's
        ``global_batch // num_shards`` rows of it), int32 ``tokens`` and
        ``labels`` (the tokens shifted by one) on ``device``: the card
        unless the caller passes one."""
        device = resolve_device(device)
        B = self.global_batch // num_shards
        gen = self._generator(step, shard)
        if self.mode == "uniform":
            toks = torch.randint(0, self.vocab_size, (B, self.seq_len + 1),
                                 generator=gen)
        else:
            toks = self._markov(gen, B)
        toks = toks.to(device=device, dtype=torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _markov(self, gen: torch.Generator, B: int) -> torch.Tensor:
        S = self.seq_len + 1
        start = torch.randint(0, self.vocab_size, (B, 1), generator=gen)
        steps = torch.randint(-self.band, self.band + 1, (B, S - 1),
                              generator=gen)
        # the walk tok_t = (tok_{t-1} + step_t) mod V, all at once
        toks = torch.remainder(
            torch.cat([start, start + torch.cumsum(steps, dim=1)], dim=1),
            self.vocab_size)
        # repeated span: the first span_len tokens again at a later offset
        span = max(int(S * self.repeat_frac), 1)
        off = S - span - 1
        toks[:, off:off + span] = toks[:, :span].clone()
        return toks
