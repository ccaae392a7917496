"""Where a rank's shard of the serving caches lies over a model group:
the one rule that ``model.init_cache`` builds the shard by, the
attention reads and writes it by (``forward._attn_tp``, whisper's
``forward.cross_kv``), RWKV6's block runs its heads by, and
``shardings.cache_placements`` states as ``Placement``s.

* Every leaf: B / dp rows over the batch axes (``batch_rows``).
* A KV cache (L, B, Smax, KH, Dh): the rank's KH / tp KV heads where
  KH % tp == 0, else its slice of the sequence, Smax / tp slots from
  slot model_rank * Smax / tp (flash decoding) -- ``cache_pspecs``'
  rule.  Under the sequence split a session's max_seq is rounded up to
  a multiple of tp, so that every cache divides but a sliding-window
  ring of a window that tp does not divide, which every rank holds
  whole, as ``cache_pspecs`` replicates a sequence that does not
  divide.  A rank tells the two apart, and finds its slice's global
  length and offset, from its slot count and the layer's window
  (``KVLayout.slice``).
* Whisper's cross K/V (L, B, S_enc, KH, Dh): the rank's KV heads where
  KH % tp == 0, else whole.
* RWKV6's wkv state (L, B, H, P, P): the rank's H / tp heads where its
  ``wr`` is column-split (``param_pspecs``' rule: d_model % tp == 0;
  ``rwkv_heads``); its shifts (L, B, D) whole, as x is.
* Mamba2's ssm and conv states whole: its block runs replicated after
  its gathered ``in_proj``.

The recurrent states differ from ``cache_pspecs``' "last divisible
trailing dim over model" rule: the port keeps each where its route
computes it (ROADMAP.md, deliberate differences).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

from repro_torch.configs.base import ModelConfig


def batch_rows(B: int, dist) -> int:
    """The rows a rank holds of a serving batch of ``B``: B / dp over the
    batch axes.  A batch that does not divide would take the sequence
    over the batch axes (``cache_pspecs``' long-context split), which
    raises: it comes with A6c in ROADMAP.md."""
    dp = 1 if dist is None else dist.dp
    if B % dp:
        raise NotImplementedError(
            f"a serving batch of {B} over {dp} batch ranks: the sequence "
            f"split over the batch axes comes with A6c in ROADMAP.md")
    return B // dp


def rwkv_heads(cfg: ModelConfig, tp: int, split: Optional[bool] = None
               ) -> int:
    """The RWKV6 heads a rank of a model group of ``tp`` runs and holds
    the wkv state of: H / tp where ``wr``'s columns are split over the
    group (``split``, as a rank's ``wr`` says; by default
    ``param_pspecs``' rule, d_model % tp == 0), else H.  A split that
    cuts a head raises."""
    H = cfg.ssm_num_heads
    if split is None:
        split = tp > 1 and cfg.d_model % tp == 0
    if not split:
        return H
    if H % tp:
        raise NotImplementedError(
            f"{H} RWKV6 heads over a model group of {tp}: the column "
            f"split of wr cuts heads")
    return H // tp


class KVSlice(NamedTuple):
    """A rank's slots of one KV cache: the global index of its first
    (``offset``), the global cache's slot count (``length``), whether the
    cache is a sliding-window ring (it holds ``window`` slots) and
    whether the slots are a slice of the sequence over the model group
    (``split``: decode combines every rank's partial stats)."""
    offset: int
    length: int
    ring: bool
    split: bool


@dataclass(frozen=True)
class KVLayout:
    """How a rank holds the KV caches over a model group of ``tp``: its
    ``heads`` KV heads of each, and with ``seq`` the slice of each one's
    sequence at its model ``rank`` (all KV heads)."""
    tp: int = 1
    rank: int = 0
    heads: int = 0
    seq: bool = False

    def slots(self, max_seq: int, window: int = 0) -> int:
        """The slots a rank holds of a cache for a session of ``max_seq``
        in a layer of ``window`` (0: none): min(window, max_seq) -- a
        ring once that is ``window`` -- over the sequence split with
        max_seq rounded up to a multiple of tp, cut by tp where it
        divides."""
        if self.seq:
            max_seq = -(-max_seq // self.tp) * self.tp
        S = min(window, max_seq) if window else max_seq
        return S // self.tp if self.seq and S % self.tp == 0 else S

    def slice(self, slots: int, window: int = 0) -> KVSlice:
        """The ``KVSlice`` of a rank's cache of ``slots`` in a layer of
        ``window``.  Under the sequence split, a cache of ``window``
        slots that tp does not divide is a ring held whole (a sliced
        cache of ``window`` slots would be a ring of window * tp, which
        ``slots`` never makes); every other cache is a slice."""
        split = self.seq and not (window % self.tp and slots == window)
        length = slots * self.tp if split else slots
        return KVSlice(self.rank * slots if split else 0, length,
                       window > 0 and length == window, split)


def kv_layout(cfg: ModelConfig, dist) -> KVLayout:
    """The rank's ``KVLayout`` under ``dist`` (one rank without one):
    KH / tp heads where KH % tp == 0, else every head and the sequence
    split."""
    tp = 1 if dist is None else dist.tp
    KH = cfg.num_kv_heads
    if KH % tp == 0:
        return KVLayout(tp, 0, KH // tp)
    return KVLayout(tp, dist.model_rank, KH, seq=True)


__all__ = ["batch_rows", "rwkv_heads", "KVSlice", "KVLayout", "kv_layout"]
