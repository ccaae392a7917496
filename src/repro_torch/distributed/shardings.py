"""Placement of sharded state: the training state's partition specs over
a training mesh, and the sharded fleet runtime's stacked per-shard state
over a fleet mesh.

**Training.**  ``param_pspecs`` pattern-matches the stable names of
``models/params.py``, as the JAX package's ``distributed/shardings.py``
does, in its modes:

  tp       -- tensor parallelism only: parameters replicated over the
              data axes, contracted / expanded dims over ``"model"``;
  fsdp     -- the same, plus the largest remaining divisible dim over
              ``"data"`` (fully sharded parameters and optimizer state);
  fsdp_pod -- the same over ``("pod", "data")``;
  dp_only  -- pure data parallelism over the whole mesh: no tensor role,
              the FSDP dim split over every axis.

The rules are plain logic over names and shapes, with the JAX package's
divisibility checks and its production axis sizes (pod 2, data 16,
model 16) when no mesh is given; ``P`` is the port's partition spec,
entry for entry a JAX ``PartitionSpec``.  ``named`` turns a spec into a
``Placement`` on a ``TrainMesh``: the dim split over the model axis
(tensor or expert parallelism) and the dim split over batch axes (FSDP,
ZeRO-1), each optional, with the collectives that cut a full tensor
into this rank's shard, reduce a gradient into it and gather it back --
over both splits, or over the batch axes alone (the model shard, which
the model code runs on).

**Fleet.**  Every piece of sharded fleet state is stacked as ``(S, ...)``
with one padded shape for all shards.  Shards that share a device share
one block of that stack there: a block is the ``(S_b, ...)`` rows of its
shards, in shard order, so one kernel launch per device serves every
shard on it (on a one-device mesh the whole ``(S, ...)`` stack is one
block).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import FleetMesh, TrainMesh

class P(tuple):
    """A partition spec: one entry per dim, ``None`` (not split), an axis
    name, or a tuple of axis names split over together.  A one-name tuple
    is that name, as JAX normalizes it."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# suffix-pattern rules: (regex on the trailing name, role); roles: "col"
# = shard the last dim on model; "row" = the second-to-last; "expert" =
# the expert dim; "vocab" = the vocabulary dim; "rep" = replicated
_RULES: Tuple[Tuple[str, str], ...] = (
    # order matters: expert/shared rules must fire before the generic
    # wg/w1 suffixes ("moe_wg" ends in "_wg" too)
    (r"(^|_)(moe_wg|moe_wu|moe_wd)$", "expert"),
    (r"(^|_)(shared_wg|shared_wu)$", "col"),
    (r"(^|_)shared_wd$", "row"),
    (r"(^|_)(wq|wk|wv|bq|bv)$", "col"),
    (r"(^|_)wo$", "row"),
    (r"(^|_)(w1|w3|b1|cmix_k|wr|wg)$", "col"),
    (r"(^|_)(w2|cmix_v)$", "row"),
    (r"(^|_)(m_in)$", "col"),
    (r"(^|_)(m_out)$", "row"),
    (r"(^|_)(embed|unembed)$", "vocab"),
    (r"(^|_)cmix_r$", "col"),
)


def _role(name: str) -> str:
    for pat, role in _RULES:
        if re.search(pat, name):
            return role
    return "rep"


def _spec_for(name: str, shape, mode: str, fsdp_axes, axis_size) -> P:
    """The spec of one parameter, respecting divisibility."""
    role = _role(name) if mode != "dp_only" else "rep"
    ndim = len(shape)
    model = "model"
    dims = [None] * ndim

    def ok(i, axes) -> bool:
        return shape[i] % axis_size(axes) == 0

    if role == "col" and ndim >= 2 and ok(ndim - 1, model):
        dims[-1] = model
    elif role == "row" and ndim >= 2 and ok(ndim - 2, model):
        dims[-2] = model
    elif role == "expert" and ndim >= 3 and ok(ndim - 3, model):
        dims[-3] = model            # (L, E, d, F): experts over model
    elif role == "vocab" and ok(0, model):
        dims[0] = model             # (V, d): vocab-sharded
    # (an indivisible vocabulary stays replicated on the model axis)

    if mode in ("fsdp", "fsdp_pod", "dp_only"):
        # shard the largest remaining divisible dim over the data axes
        free = [i for i, d in enumerate(dims)
                if d is None and shape[i] % axis_size(fsdp_axes) == 0
                and shape[i] >= axis_size(fsdp_axes)]
        if free:
            tgt = max(free, key=lambda i: shape[i])
            dims[tgt] = fsdp_axes
    if all(d is None for d in dims):
        return P()
    return P(*dims)


def _axis_size(mesh, axes) -> int:
    """The ranks along ``axes`` of ``mesh`` (anything with a ``shape``
    dict; absent axes count 1), or of the production mesh (pod 2, data
    16, model 16) without one."""
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1) if mesh is not None else \
            {"pod": 2, "data": 16, "model": 16}[a]
    return n


def param_pspecs(cfg, specs: Dict, mode: str = "tp",
                 multi_pod: bool = False, mesh=None) -> Dict:
    """The spec of every leaf of a parameter (or optimizer-moment) tree,
    divisibility checked against ``mesh``'s axis sizes (the production
    sizes without one)."""
    fsdp_axes = ("pod", "data") if multi_pod else ("data",)
    if mode == "fsdp_pod":
        fsdp_axes = ("pod", "data")
    if mode == "dp_only":
        # pure data parallelism over the whole mesh: the model axis joins
        # the data axes and no tensor role applies
        fsdp_axes = ("pod", "data", "model") if multi_pod \
            else ("data", "model")

    out = {}
    for name, v in specs.items():
        if len(v.shape) <= 1 or min(v.shape) == 0:
            out[name] = P()
        else:
            out[name] = _spec_for(name, v.shape, mode, fsdp_axes,
                                  lambda axes: _axis_size(mesh, axes))
    return out


def batch_pspec(multi_pod: bool = False) -> P:
    return P(("pod", "data") if multi_pod else ("data",))


def batch_pspecs_for(specs: Dict, mesh, multi_pod: bool = False) -> Dict:
    """Split the leading (batch) dim of every input when divisible; else
    the sequence dim (sequence parallelism) for a batch of 1."""
    b = ("pod", "data") if multi_pod else ("data",)
    dp = _axis_size(mesh, b)
    out = {}
    for k, v in specs.items():
        dims = [None] * len(v.shape)
        if v.shape and v.shape[0] % dp == 0 and v.shape[0] > 0:
            dims[0] = b
        elif len(v.shape) >= 2 and v.shape[1] % dp == 0:
            dims[1] = b            # (1, S, ...) long context: split S
        out[k] = P(*dims)
    return out


def tree_map(fn, tree):
    """``fn`` over the leaves of dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cache_pspecs(cache, mesh, multi_pod: bool = False,
                 kv_seq_shard: bool = False):
    """KV caches and recurrent states, shape-aware.

    kv (L, B, S, KH, Dh): B over data when divisible (else S takes data:
    sequence parallelism at batch 1); KH over model when divisible, else S
    over model.  ``model.init_cache`` builds a rank's shard of each KV
    cache as ``cache_placements`` cuts it (``models.cache_layout``: under
    the sequence split max_seq rounded up to a multiple of the model
    axis), and keeps the recurrent states where their route computes
    them, not by the last rule here (ROADMAP.md, deliberate
    differences)."""
    b = ("pod", "data") if multi_pod else ("data",)
    dp = _axis_size(mesh, b)
    tp = _axis_size(mesh, "model")

    def one(leaf):
        shape = leaf.shape
        nd = len(shape)
        if nd >= 5:      # (L, B, S, KH, Dh)
            L, B, S, KH, Dh = shape[-5:]
            bdim = b if (B % dp == 0 and not kv_seq_shard) else None
            s_axes = [] if bdim is not None else list(b)
            hdim = "model" if KH % tp == 0 else None
            if hdim is None:
                s_axes.append("model")
            sdim = tuple(s_axes) if s_axes else None
            if sdim is not None and S % _axis_size(mesh, sdim) != 0:
                sdim = None     # give up: replicate sequence
            return P(None, bdim, sdim, hdim, None)
        if nd == 3:      # (L, B, S) position cache: follow the kv B/S split
            L, B, S = shape
            if B % dp == 0 and not kv_seq_shard:
                return P(None, b, None)
            return P(None, None, b if S % dp == 0 else None)
        if nd >= 2:      # recurrent states (L, B, H, ...) / conv (L, B, W, C)
            B = shape[1]
            bdim = b if B % dp == 0 else None
            dims = [None, bdim] + [None] * (nd - 2)
            # shard the widest trailing dim over model when divisible
            for i in range(nd - 1, 1, -1):
                if shape[i] % tp == 0 and shape[i] >= tp:
                    dims[i] = "model"
                    break
            return P(*dims)
        return P()

    return tree_map(one, cache)


def cache_placements(cfg, cache, mesh: TrainMesh, multi_pod: bool = False,
                     kv_seq_shard: bool = False):
    """The ``Placement`` of every leaf of ``cfg``'s cache tree as
    ``models.cache_layout`` lays it out: ``shard`` cuts a whole cache
    into this rank's shard.  The KV caches take ``named`` of
    ``cache_pspecs``: under the sequence split over the batch axes
    (``kv_seq_shard``, or a batch that does not divide over them) their
    rows whole and their sequence over the batch axes, joined with the
    model axis where KH % tp != 0.  The recurrent states take their
    route's placement (rwkv6's wkv state by its heads where
    ``rwkv_heads`` splits them, its shifts and zamba2's states over the
    batch rows alone -- whole under the split), whisper's cross K/V its
    rows and KV heads (where KH % tp == 0), its sequence whole."""
    from repro_torch.models.cache_layout import rwkv_heads
    b = ("pod", "data") if multi_pod else ("data",)
    B = _first_leaf(cache).shape[1]
    split = kv_seq_shard or B % mesh.size(b) != 0
    rows = P(None, None) if split else P(None, b)

    def kv(tree):
        return named(mesh, cache_pspecs(tree, mesh, multi_pod, kv_seq_shard))

    if cfg.family == "ssm":
        split = rwkv_heads(cfg, mesh.size("model")) < cfg.ssm_num_heads
        wkv = P(*rows, "model") if split else rows
        return tuple(Placement(mesh, s) for s in (wkv, rows, rows))
    if cfg.family == "hybrid":
        return {"states": (Placement(mesh, rows),) * 2,
                "attn": kv(cache["attn"])}
    if cfg.family == "encdec":
        heads = "model" if cfg.num_kv_heads % mesh.size("model") == 0 \
            else None
        cross = Placement(mesh, P(*rows, None, heads, None))
        return {"self": kv(cache["self"]), "cross": (cross, cross)}
    return kv(cache)


def _first_leaf(tree):
    """The first tensor of a tree of dicts, lists and tuples."""
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def make_dist(mesh: Optional[TrainMesh], auto_moe: bool = False,
              dp_only: bool = False, kv_seq_shard: bool = False):
    """The model code's ``DistContext`` on ``mesh`` (one device without
    one): the batch axes, and the model axis -- joined to the batch axes
    under ``dp_only``; ``kv_seq_shard`` puts a serving cache's sequence
    over the batch axes (``models.cache_layout``)."""
    from repro_torch.models.dist import DistContext
    if mesh is None:
        return DistContext(mesh=None)
    axes = ("pod", "data", "model") if dp_only else ("pod", "data")
    batch_axes = tuple(a for a in axes if a in mesh.shape)
    return DistContext(mesh=mesh, batch_axes=batch_axes,
                       model_axis="model" if not dp_only else "__none__",
                       auto_moe=auto_moe, kv_seq_shard=kv_seq_shard)


def _lead(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` with ``dim`` moved first, contiguous (the collectives'
    layout)."""
    return t.movedim(dim, 0).contiguous()


class Placement:
    """One leaf's placement on a training mesh: at most one dim split over
    the model axis (``model``: (dim, axes)) and at most one over batch
    axes (``batch``: (dim, axes)), every other dim whole.  Spec entries
    over axes of one rank split nothing; an entry of the model axis alone
    is the model split, any other the batch split (``dp_only``'s
    ("data", "model") included)."""

    def __init__(self, mesh: TrainMesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)
        self.model = self.batch = None
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            if mesh.size(axes) == 1:
                continue
            kind = "model" if axes == ("model",) else "batch"
            if getattr(self, kind) is not None:
                raise ValueError(f"placement {self.spec} on {mesh.shape}: "
                                 f"two dims split over {kind} axes")
            setattr(self, kind, (d, axes))

    @property
    def split(self) -> bool:
        return self.model is not None or self.batch is not None

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every axis the leaf is split over."""
        return sum((s[1] for s in (self.model, self.batch) if s), ())

    def row_axes(self, ndim: int):
        """The axes that split the last of ``ndim`` dims (each rank then
        holds part of every row), or None."""
        for s in (self.model, self.batch):
            if s is not None and s[0] == ndim - 1:
                return s[1]
        return None

    def local_shape(self, shape) -> Tuple[int, ...]:
        shape = list(shape)
        for s in (self.model, self.batch):
            if s is not None:
                shape[s[0]] //= self.mesh.size(s[1])
        return tuple(shape)

    def __eq__(self, other) -> bool:
        return isinstance(other, Placement) and other.mesh is self.mesh \
            and (other.model, other.batch) == (self.model, self.batch)

    def __repr__(self) -> str:
        return (f"Placement({self.spec}, model={self.model}, "
                f"batch={self.batch})")

    def _narrow(self, t: torch.Tensor, which) -> torch.Tensor:
        if which is None:
            return t
        d, axes = which
        n = t.shape[d] // self.mesh.size(axes)
        return t.narrow(d, self.mesh.index(axes) * n, n)

    def _gather(self, t: torch.Tensor, which) -> torch.Tensor:
        if which is None:
            return t
        d, axes = which
        src = _lead(t, d)
        out = torch.empty((src.shape[0] * self.mesh.size(axes),)
                          + src.shape[1:], dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.mesh.group(axes))
        return out.movedim(0, d).contiguous()

    @torch.no_grad()
    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor, a fresh tensor (the full
        tensor itself where nothing is split)."""
        if not self.split:
            return full
        return self._narrow(self._narrow(full, self.model), self.batch) \
            .clone(memory_format=torch.contiguous_format)

    @torch.no_grad()
    def shard_batch(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a model shard (its batch split cut), a
        fresh tensor (``t`` itself without a batch split)."""
        if self.batch is None:
            return t
        return self._narrow(t, self.batch).clone(
            memory_format=torch.contiguous_format)

    @torch.no_grad()
    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (all-gathers over the
        batch split, then the model split; the shard itself where nothing
        is split)."""
        return self._gather(self._gather(shard, self.batch), self.model)

    @torch.no_grad()
    def gather_batch(self, shard: torch.Tensor) -> torch.Tensor:
        """The model shard from every batch rank's shard (an all-gather
        over the batch split alone)."""
        return self._gather(shard, self.batch)

    @torch.no_grad()
    def reduce_mean(self, g: torch.Tensor, batch_axes) -> torch.Tensor:
        """This rank's shard of the mean of the model-shard gradient ``g``
        over the ranks of ``batch_axes``: a reduce-scatter where the batch
        split runs over exactly those ranks, else an all-reduce and then
        the batch shard."""
        n = self.mesh.size(batch_axes)
        group = self.mesh.group(batch_axes)
        if self.batch is not None and self.mesh.size(self.batch[1]) == n:
            d = self.batch[0]
            src = _lead(g, d)
            out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                              dtype=src.dtype, device=src.device)
            dist.reduce_scatter_tensor(out, src, group=group)
            return out.div_(n).movedim(0, d).contiguous()
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return self.shard_batch(out.div_(n))


def named(mesh: TrainMesh, spec_tree):
    """Each spec of ``spec_tree`` as its ``Placement`` on ``mesh``."""
    return tree_map(lambda s: Placement(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# fleet-serving shardings (the sharded super-launch state)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FleetStateSharding:
    """Where each shard's rows of an ``(S, ...)`` stack live: ``blocks``
    holds (device, the shards on it in order), devices in order of first
    appearance on the mesh."""
    blocks: Tuple[Tuple[torch.device, Tuple[int, ...]], ...]

    @property
    def n_shards(self) -> int:
        return sum(len(shards) for _, shards in self.blocks)

    def locate(self, shard: int) -> Tuple[int, int]:
        """(block, position within the block) of ``shard``."""
        for b, (_, shards) in enumerate(self.blocks):
            if shard in shards:
                return b, shards.index(shard)
        raise IndexError(f"shard {shard} is not on the mesh")


def fleet_state_sharding(mesh: FleetMesh) -> FleetStateSharding:
    """The blocks of a fleet mesh: shards grouped by their device."""
    order: List[torch.device] = []
    members = {}
    for s, dev in enumerate(mesh.devices):
        if dev not in members:
            order.append(dev)
            members[dev] = []
        members[dev].append(s)
    return FleetStateSharding(tuple((d, tuple(members[d])) for d in order))


def put_fleet_state(mesh: FleetMesh, tree):
    """Place a pytree (dicts, lists, tuples) of ``(S, ...)`` stacked
    arrays or tensors on the mesh: each leaf becomes a list of its
    blocks' ``(S_b, ...)`` tensors, one per device."""
    sharding = fleet_state_sharding(mesh)

    def one(a):
        a = torch.as_tensor(np.asarray(a)) if isinstance(a, np.ndarray) \
            else torch.as_tensor(a)
        if a.shape[0] != sharding.n_shards:
            raise ValueError(f"stacked state of {a.shape[0]} shards on a "
                             f"{sharding.n_shards}-shard mesh")
        return [a[list(shards)].to(dev).contiguous()
                for dev, shards in sharding.blocks]

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return one(t)

    return walk(tree)


__all__ = ["P", "param_pspecs", "batch_pspec", "batch_pspecs_for",
           "cache_pspecs", "cache_placements", "make_dist", "named",
           "Placement", "tree_map", "FleetStateSharding",
           "fleet_state_sharding", "put_fleet_state"]
