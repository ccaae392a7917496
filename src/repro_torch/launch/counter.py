"""What one step of one rank does, counted as it runs: the port's
stand-in for XLA's ``cost_analysis`` and the partitioned HLO text that
the JAX package's dry run reads.

``count(fn, *args)`` runs ``fn(*args)`` under a ``TorchDispatchMode``
that sees every aten op the step dispatches -- the backward pass's too
-- and every c10d collective.  The dry run calls it on ``meta`` tensors
inside PyTorch's fake process group (``launch.dryrun``), so a step of a
production mesh's rank runs on one host with no memory behind its
tensors; the counts are the same on any device.  It returns a
``Counts``:

* ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention), the FLOPs of every such op the eager
  program runs -- a blockwise attention's masked blocks and a remat's
  recomputation included.  Elementwise ops, reductions and softmax
  count nothing, where XLA counts them.
* ``hbm_bytes``: each op's tensor inputs read once plus its outputs
  written once -- the eager program's own traffic, each op a kernel,
  with no fusion (XLA's "bytes accessed" counts a fused computation's
  operands once).  An in-place op reads its destination too, but a copy
  writes its destination without reading it, and an indexed write
  (``index_put_``, ``index_copy_``, ``scatter_``) reads its indices and
  values and writes as many elements as it has values.  View and alias
  ops and allocations move nothing; collectives are not HBM traffic.
* ``coll``: bytes by collective kind ("all-reduce", "all-gather",
  "reduce-scatter", "all-to-all"; another c10d op under its own name)
  and their ``"total"``, in
  the JAX package's convention: each collective's result size, an
  all-reduce's counted twice (a ring's reduce-scatter and all-gather
  phases).  A collective over a group of one rank moves nothing and
  counts nothing, as XLA drops it.
* ``peak_bytes``: the most bytes live on the rank at once: every
  tensor of ``args`` from the start, and each storage an op makes from
  that op to the release of its last reference (the autograd graph's
  saved tensors included).  Allocator rounding, fragmentation and a
  kernel's internal workspace are not counted.
* ``ops``: the aten ops dispatched; ``seconds``: the host time of the
  counted step.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops that make a tensor without writing it
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "resize_", "set_"}
# writes into their first argument without reading it: op -> the argument
# whose size is written (None: the destination whole)
_WRITES = {"copy_": None, "index_put_": 2, "_index_put_impl_": 2,
           "index_copy_": 3, "scatter_": 3}
# c10d op name -> the JAX package's collective kind (any other collective
# counts under its own name)
_KINDS = (("allreduce", "all-reduce"), ("reduce_scatter", "reduce-scatter"),
          ("allgather", "all-gather"), ("alltoall", "all-to-all"))


@dataclass
class Counts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll: Dict[str, float] = field(default_factory=lambda: {"total": 0.0})
    peak_bytes: int = 0
    ops: int = 0
    seconds: float = 0.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of an op's arguments or results: tensors, and lists,
    tuples and dicts of them (walked by hand: the counter runs on every
    op)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(_tensors(x))
    return out


def _kind(name: str) -> str:
    for key, kind in _KINDS:
        if key in name:
            return kind
    return name.split(".")[0]


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments (a
    ``ProcessGroup`` or, as the dispatcher passes it, its script object;
    1 without one)."""
    from torch.distributed import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                a._type().qualified_name().endswith("c10d.ProcessGroup"):
            a = ProcessGroup.unbox(a)
        if isinstance(a, ProcessGroup):
            return a.size()
    return 1


class StepCounter(TorchDispatchMode):
    """The dispatch mode behind ``count``: its totals in ``counts``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.counts = Counts()
        self._live: Dict[int, list] = {}     # storage -> [bytes, refs]
        self._seen = set()                   # ids of tracked tensors
        self._cur = 0

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until its last tracked reference
        goes."""
        if id(t) in self._seen:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            self._live[key] = [st.nbytes(), 0]
            self._cur += st.nbytes()
            self.counts.peak_bytes = max(self.counts.peak_bytes, self._cur)
        self._live[key][1] += 1
        self._seen.add(id(t))
        weakref.finalize(t, self._release, key, id(t))

    def _release(self, key: int, tid: int) -> None:
        self._seen.discard(tid)
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._cur -= entry[0]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counts
        c.ops += 1
        if func.namespace == "c10d":
            kind = _kind(func.__name__)
            if _group_size(args) > 1:
                # the result: a c10d op writes into its first argument
                nb = sum(_nbytes(t) for t in _tensors(args[0]))
                nb *= 2 if kind == "all-reduce" else 1
                c.coll[kind] = c.coll.get(kind, 0.0) + nb
                c.coll["total"] += nb
        else:
            packet = func.overloadpacket
            if packet in self.registry:
                c.flops += self.registry[packet](*args, **kwargs,
                                                 out_val=out)
            name = packet.__name__
            if not func.is_view and name not in _NO_TRAFFIC:
                ins = {id(t): t for t in _tensors((args, kwargs))}
                if name in _WRITES:
                    dst = args[0]
                    ins.pop(id(dst), None)
                    k = _WRITES[name]
                    src = dst if k is None or len(args) <= k \
                        or not isinstance(args[k], torch.Tensor) else args[k]
                    written = _nbytes(src)
                else:
                    written = sum(_nbytes(t) for t in _tensors(out))
                c.hbm_bytes += sum(_nbytes(t) for t in ins.values()) + \
                    written
        for t in _tensors(out):
            self.track(t)
        return out


def count(fn, *args) -> Counts:
    """``fn(*args)``'s ``Counts`` (see the module's docstring)."""
    mode = StepCounter()
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            mode.track(t)
    t0 = time.perf_counter()
    with mode:
        fn(*args)
    mode.counts.seconds = time.perf_counter() - t0
    return mode.counts


__all__ = ["Counts", "StepCounter", "count"]
