"""Where a rank's shard of the serving caches lies over a mesh: the one
rule that ``model.init_cache`` builds the shard by, the attention reads
and writes it by (``forward._attn_tp``, whisper's ``forward.cross_kv``),
RWKV6's block runs its heads by, and ``shardings.cache_placements``
states as ``Placement``s.

* Every leaf: B / dp rows over the batch axes (``batch_rows``); under
  the sequence split over the batch axes (``DistContext.kv_seq_shard``,
  which a batch that dp does not divide needs) all B rows on every
  batch rank, as the tokens are.
* A KV cache (L, B, Smax, KH, Dh): the rank's KH / tp KV heads where
  KH % tp == 0, else every KV head; and its slice of the sequence over
  the sequence axes -- the batch axes under the split, joined with the
  model axis where KH % tp != 0 (``cache_pspecs``' rule): n slices of
  Smax / n slots, the rank's from slot rank * Smax / n (flash
  decoding).  Under a sequence split a session's max_seq is rounded up
  to a multiple of n, so that every cache divides but a sliding-window
  ring of a window that n does not divide, which every rank holds
  whole, as ``cache_pspecs`` replicates a sequence that does not
  divide.  A rank tells the two apart, and finds its slice's global
  length and offset, from its slot count and the layer's window
  (``KVLayout.slice``).
* Whisper's cross K/V (L, B, S_enc, KH, Dh): the rank's KV heads where
  KH % tp == 0, else whole; its sequence whole.
* RWKV6's wkv state (L, B, H, P, P): the rank's H / tp heads where its
  ``wr`` is column-split (``param_pspecs``' rule: d_model % tp == 0;
  ``rwkv_heads``); its shifts (L, B, D) whole, as x is.
* Mamba2's ssm and conv states whole: its block runs replicated after
  its gathered ``in_proj``.

The recurrent states and whisper's cross K/V differ from
``cache_pspecs``' rules: the port keeps each where its route computes
it, the recurrent states' rows whole over the batch axes under the
sequence split (ROADMAP.md, deliberate differences).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

from repro_torch.configs.base import ModelConfig


def batch_rows(B: int, dist) -> int:
    """The rows a rank holds of a serving batch of ``B``: B / dp over the
    batch axes, or all B under the sequence split over them
    (``kv_seq_shard``).  A batch that dp does not divide needs that
    split: without it, it raises."""
    dp = 1 if dist is None else dist.dp
    if _over_batch(dist):
        return B
    if B % dp:
        raise ValueError(
            f"a serving batch of {B} over {dp} batch ranks: pass a "
            f"DistContext with kv_seq_shard=True (the sequence split over "
            f"the batch axes, every batch rank on all {B} rows)")
    return B // dp


def _over_batch(dist) -> bool:
    """Whether ``dist`` puts the serving caches' sequence over its batch
    axes (``kv_seq_shard`` on more than one batch rank)."""
    return dist is not None and dist.kv_seq_shard and dist.dp > 1


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
    """How a rank holds the KV caches: its ``heads`` KV heads of each
    (KH / tp, or all KH where the model group of ``tp`` does not split
    them), and the slice ``rank`` of ``n`` of each one's sequence over
    the mesh ``axes`` (none, ``n`` = 1: the sequence whole)."""
    tp: int = 1
    heads: int = 0
    n: int = 1
    rank: int = 0
    axes: Tuple[str, ...] = ()

    @property
    def seq(self) -> bool:
        """Whether the sequence is split."""
        return self.n > 1

    def slots(self, max_seq: int, window: int = 0) -> int:
        """The slots a rank holds of a cache for a session of ``max_seq``
        in a layer of ``window`` (0: none): min(window, max_seq) -- a
        ring once that is ``window`` -- over the sequence split with
        max_seq rounded up to a multiple of n, cut by n where it
        divides."""
        if self.seq:
            max_seq = -(-max_seq // self.n) * self.n
        S = min(window, max_seq) if window else max_seq
        return S // self.n if self.seq and S % self.n == 0 else S

    def slice(self, slots: int, window: int = 0) -> KVSlice:
        """The ``KVSlice`` of a rank's cache of ``slots`` in a layer of
        ``window``.  Under the sequence split, a cache of ``window``
        slots that n does not divide is a ring held whole (a sliced
        cache of ``window`` slots would be a ring of window * n, which
        ``slots`` never makes); every other cache is a slice."""
        split = self.seq and not (window % self.n and slots == window)
        length = slots * self.n if split else slots
        return KVSlice(self.rank * slots if split else 0, length,
                       window > 0 and length == window, split)


def kv_layout(cfg: ModelConfig, dist) -> KVLayout:
    """The rank's ``KVLayout`` under ``dist`` (one rank without one): KH /
    tp heads where KH % tp == 0, else every head and the sequence over
    the model axis; under ``kv_seq_shard`` the sequence over the batch
    axes too, ahead of the model axis (``cache_pspecs``' order).  The
    rank's slice is its row-major index over those axes."""
    tp = 1 if dist is None else dist.tp
    KH = cfg.num_kv_heads
    model = KH % tp != 0
    heads = KH if model else KH // tp
    axes, n, rank = (), 1, 0
    if _over_batch(dist):
        axes, n, rank = tuple(dist.batch_axes), dist.dp, dist.batch_rank
    if model:
        axes, n = axes + (dist.model_axis,), n * tp
        rank = rank * tp + dist.model_rank
    return KVLayout(tp, heads, n, rank, axes)


__all__ = ["batch_rows", "rwkv_heads", "KVSlice", "KVLayout", "kv_layout"]
