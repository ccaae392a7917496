"""Training loop: microbatched, data-parallel, fault-tolerant; the port's
copy of ``repro.train.loop``.

``make_train_step`` builds the step: ``model.train_loss`` under
``torch.autograd`` (remat and the causal block skip from
``TrainConfig``), gradient accumulation over ``TrainConfig.microbatch``
microbatches in a float32 accumulator, optional int8 gradient
quantization, then the in-place AdamW.  ``train()`` is the launcher-level
loop: checkpoint cadence, straggler monitoring, fault injection,
restore-and-continue on failure, deterministic data replay from the
restored step counter.

With a training mesh (``launch.mesh.TrainMesh``) the step runs over
``torch.distributed``, where the JAX package runs GSPMD: every rank
draws the global batch and keeps its rows as the JAX placement gives
them (the batch split into microbatches first, each microbatch then
over the batch axes; the ranks of a model group share their rows).  The
parameters are gathered over the batch axes into each rank's model
shard, which the model code runs on (tensor and expert parallelism over
a model axis above 1, ``models.forward``).  Each microbatch's gradients
are mean-reduced over the batch axes alone into the optimizer moments'
shards (ZeRO-1: reduce-scatter, or all-reduce where a leaf is not split
over them); the global norm sums the shards' squares in one all-reduce
over every rank, each shard counted once; AdamW runs on the shards and
the parameters are all-gathered back over the batch axes where their
spec replicates them there.  On a one-rank group every piece reduces to
the ``mesh=None`` step bit for bit.  Under a mesh rank 0 writes the
checkpoints, of the full arrays; every rank restores full arrays and
keeps its shard, so a checkpoint restores onto any (data, model)
shape.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.lm import SyntheticLM
from repro_torch.distributed.compression import (dequantize_int8,
                                                 quantize_int8)
from repro_torch.distributed.fault import (FaultInjector, InjectedFault,
                                           StragglerMonitor)
from repro_torch.distributed.shardings import (P, make_dist, named,
                                               param_pspecs)
from repro_torch.models.model import train_loss
from repro_torch.models.params import init_params, param_specs
from repro_torch.optim.adamw import (AdamWState, adamw_abstract,
                                     adamw_init, adamw_update)

_SLICE = 1 << 26        # elements quantized at a time (256 MiB in float32)


class TrainState(NamedTuple):
    params: Dict
    opt: AdamWState


def _qdq(g: torch.Tensor, absmax: Optional[torch.Tensor] = None):
    q, s = quantize_int8(g, absmax)
    return dequantize_int8(q, s, g.dtype)


@torch.no_grad()
def qdq_(g: torch.Tensor, group=None) -> torch.Tensor:
    """``g`` quantized to int8 and back (``_qdq``), in place, in slices of
    whole rows.  ``group``: the ranks that hold the rest of each row (the
    last dim split over them, by the model or the batch axes), whose
    absmax the scale takes."""
    if g.ndim < 2:
        return g.copy_(_qdq(g))
    rows = g.view(-1, g.shape[-1])
    step = max(1, _SLICE // g.shape[-1])
    for a in range(0, rows.shape[0], step):
        r = rows[a:a + step]
        amax = None
        if group is not None:
            import torch.distributed as dist
            amax = r.abs().amax(dim=-1, keepdim=True)
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        r.copy_(_qdq(r, amax))
    return g


def _opt_mode(tcfg: TrainConfig, multi_pod: bool) -> str:
    return tcfg.sharding_mode if tcfg.sharding_mode == "dp_only" \
        else ("fsdp_pod" if multi_pod else "fsdp")


def state_pspecs(cfg: ModelConfig, tcfg: TrainConfig, multi_pod: bool,
                 mesh=None) -> TrainState:
    """Parameters follow ``tcfg.sharding_mode``; the optimizer moments are
    always split over the data axes (ZeRO-1) on top of any model dims."""
    specs = param_specs(cfg)
    pspecs = param_pspecs(cfg, specs, tcfg.sharding_mode, multi_pod,
                          mesh=mesh)
    ospecs = param_pspecs(cfg, specs, _opt_mode(tcfg, multi_pod),
                          multi_pod, mesh=mesh)
    return TrainState(pspecs, AdamWState(P(), ospecs, ospecs))


def state_template(cfg: ModelConfig) -> Dict:
    """The checkpoint template of a training state: ``{"state": ...}`` of
    ``meta`` tensors of the full logical shapes."""
    specs = param_specs(cfg)
    return {"state": TrainState(specs, adamw_abstract(specs))._asdict()}


def _rows(batch: Dict, j: int, k: int, parts: int, index: int,
          device) -> Dict:
    """Microbatch ``j`` of ``k``, this rank's ``index``-th of ``parts``
    pieces of it, on ``device``."""
    out = {}
    for name, v in batch.items():
        mb = v.shape[0] // k
        if mb * k != v.shape[0] or mb % parts:
            raise ValueError(
                f"batch {name} of {v.shape[0]} rows: {k} microbatch(es) "
                f"over {parts} rank(s) do not divide it")
        n = mb // parts
        out[name] = v[j * mb + index * n:j * mb + (index + 1) * n].to(device)
    return out


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    multi_pod: bool = False,
                    auto_moe: Optional[bool] = None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``; ``batch`` is
    the global batch (on any device).  The state's tensors are updated in
    place: a caller that keeps the old state passes copies.
    ``step.gradients(state, batch)`` gives the step's gradients alone."""
    if auto_moe is None:
        auto_moe = False
    dist = make_dist(mesh, auto_moe=auto_moe,
                     dp_only=tcfg.sharding_mode == "dp_only")
    use_remat = tcfg.remat != "none"
    k = tcfg.microbatch if tcfg.microbatch and tcfg.microbatch > 1 else 1
    if mesh is not None:
        pl = named(mesh, state_pspecs(cfg, tcfg, multi_pod, mesh))
        ppl, opl = pl.params, pl.opt.m
        axes = dist.batch_axes
        group = mesh.group(axes)
        parts, index = mesh.size(axes), mesh.index(axes)
    else:
        parts, index = 1, 0

    def grad_fn(params, mbatch):
        """(loss, the gradients of ``params`` -- this rank's model
        shard)."""
        names = sorted(params)
        for p in params.values():
            p.requires_grad_(True)
        loss, metrics = train_loss(params, cfg, mbatch, dist=dist,
                                   remat=use_remat,
                                   causal_skip=tcfg.causal_skip)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), dict(zip(names, grads))

    def reduce(grads):
        """The microbatch's model-shard gradients, mean-reduced over the
        batch axes into the moments' shards (themselves on one
        device)."""
        if mesh is None:
            return grads
        return {n: opl[n].reduce_mean(g, axes) for n, g in grads.items()}

    def gradients(params, batch, device):
        """(loss, the gradients as ``adamw_update`` takes them)."""
        if k == 1:
            loss, grads = grad_fn(params, _rows(batch, 0, 1, parts, index,
                                                device))
            return loss, reduce(grads)
        acc, losses = None, []
        for j in range(k):
            loss, grads = grad_fn(params, _rows(batch, j, k, parts, index,
                                                device))
            grads = reduce(grads)
            losses.append(loss)
            if acc is None:
                acc = {n: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device)
                       for n, g in grads.items()}
            for n in list(grads):           # one microbatch's at a time
                acc[n].add_(grads.pop(n).float() / k)
        return torch.stack(losses).mean(), acc

    def compress(grads):
        if tcfg.grad_compression != "int8":
            return grads
        out = {}
        for n, g in grads.items():
            g = g.contiguous()
            row = opl[n].row_axes(g.ndim) if mesh is not None else None
            out[n] = qdq_(g, mesh.group(row) if row is not None else None)
        return out

    def grads_only(state: TrainState, batch: Dict) -> Tuple[torch.Tensor,
                                                             Dict]:
        """(this rank's loss, the gradients as ``step`` hands them to
        ``adamw_update``: accumulated, reduced into the moments' shards,
        quantized); the state is left as it was."""
        if mesh is None:
            params = state.params
            device = next(iter(params.values())).device
        else:       # the model shards, gathered over the batch axes
            params = {n: ppl[n].gather_batch(p)
                      for n, p in state.params.items()}
            device = mesh.device
        loss, grads = gradients(params, batch, device)
        return loss, compress(grads)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        loss, grads = grads_only(state, batch)
        if mesh is None:
            params, opt, mets = adamw_update(state.params, grads, state.opt,
                                             tcfg)
            mets["loss"] = loss
            return TrainState(params, opt), mets
        import torch.distributed as tdist
        # the global norm: each shard's sum of squares (a shard held on
        # several ranks -- replicated over batch or model axes -- counted
        # on one), one all-reduce over every rank, then ``_global_norm``'s
        # ordered sum
        sq = []
        for n in sorted(grads):
            s = grads[n].to(torch.float32, copy=True).square_().sum()
            rest = tuple(a for a in mesh.axis_names
                         if a not in opl[n].axes)
            sq.append(s if mesh.index(rest) == 0 else torch.zeros_like(s))
        sq = torch.stack(sq)
        tdist.all_reduce(sq, group=mesh.group(mesh.axis_names))
        tot = None
        for s in sq.unbind(0):
            tot = s if tot is None else tot + s
        # AdamW on the moments' shards of the parameters (the model
        # split is the same: only the batch split differs)
        own = {n: p if ppl[n] == opl[n]
               else opl[n].shard_batch(ppl[n].gather_batch(p))
               for n, p in state.params.items()}
        own, opt, mets = adamw_update(own, grads, state.opt, tcfg,
                                      gnorm=torch.sqrt(tot))
        del grads
        params = {n: own[n] if ppl[n] == opl[n]
                  else ppl[n].shard_batch(opl[n].gather_batch(own[n]))
                  for n in state.params}
        loss = loss.reshape(1).clone()
        tdist.all_reduce(loss, group=group)
        mets["loss"] = (loss / parts).reshape(())
        return TrainState(params, opt), mets

    step.gradients = grads_only
    return step


def init_state(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
               multi_pod: bool = False, device=None) -> TrainState:
    """Parameters drawn from a ``torch.Generator`` seeded with
    ``tcfg.seed`` and zero AdamW moments, on ``device`` (the card unless
    the caller passes one) or the mesh's; under a mesh each leaf is this
    rank's shard per ``state_pspecs``."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        tcfg.seed), dev)
    if mesh is None:
        return TrainState(params, adamw_init(params, dev))
    pl = named(mesh, state_pspecs(cfg, tcfg, multi_pod, mesh))
    params = {n: pl.params[n].shard(p) for n, p in params.items()}
    shard_shapes = {n: torch.empty(pl.opt.m[n].local_shape(p.shape),
                                   device="meta")
                    for n, p in param_specs(cfg).items()}
    return TrainState(params, adamw_init(shard_shapes, dev))


def _barrier(mesh):
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()


def _save(mgr: CheckpointManager, step: int, state: TrainState, mesh,
          places):
    """The full logical state to the checkpoint: gathered on every rank,
    written by rank 0 while the others wait at a barrier."""
    if mesh is None:
        mgr.save(step, {"state": state._asdict()})
        return
    full = TrainState(
        {n: places.params[n].gather(p) for n, p in state.params.items()},
        AdamWState(state.opt.step,
                   {n: places.opt.m[n].gather(t)
                    for n, t in state.opt.m.items()},
                   {n: places.opt.v[n].gather(t)
                    for n, t in state.opt.v.items()}))
    if mesh.rank == 0:
        mgr.save(step, {"state": full._asdict()})
    del full
    _barrier(mesh)


def _restore(mgr: CheckpointManager, cfg: ModelConfig, mesh, places,
             device) -> Tuple[int, TrainState]:
    """The latest checkpoint as fresh tensors, this rank's shards."""
    mgr.wait()
    _barrier(mesh)
    shardings = {"state": places._asdict()} if mesh is not None else None
    step, trees = mgr.restore(state_template(cfg), shardings,
                              device=device)
    st = trees["state"]
    return step, TrainState(st["params"], st["opt"])


@dataclass
class TrainReport:
    steps_run: int
    final_loss: float
    losses: list
    straggler_events: list
    restarts: int
    median_step_s: float
    # each checkpoint's host snapshot and file write, each restore (s)
    ckpt_snapshot_s: List[float] = field(default_factory=list)
    ckpt_write_s: List[float] = field(default_factory=list)
    restore_s: List[float] = field(default_factory=list)
    # the state after the last step (this rank's shards under a mesh)
    final_state: Optional[TrainState] = None


def train(cfg: ModelConfig, tcfg: TrainConfig, *, steps: int,
          batch_shape: Tuple[int, int], workdir: Optional[str] = None,
          mesh=None, multi_pod: bool = False, ckpt_every: int = 0,
          injector: Optional[FaultInjector] = None,
          data: Optional[SyntheticLM] = None, log_every: int = 10,
          verbose: bool = True, device=None) -> TrainReport:
    """The fault-tolerant loop.  On ``InjectedFault`` the loop restores the
    latest checkpoint (or, before the first, restarts cold from the seed)
    and replays the data deterministically; without checkpoints it
    raises.  Runs on ``device`` (the card unless the caller passes one)
    or the mesh's."""
    B, S = batch_shape
    dev = mesh.device if mesh is not None else resolve_device(device)
    data = data or SyntheticLM(cfg.vocab_size, S, B, seed=tcfg.seed)
    places = named(mesh, state_pspecs(cfg, tcfg, multi_pod, mesh)) \
        if mesh is not None else None
    say = verbose and (mesh is None or mesh.rank == 0)
    step_fn = make_train_step(cfg, tcfg, mesh, multi_pod)
    state = init_state(cfg, tcfg, mesh, multi_pod, device=dev)
    mgr = CheckpointManager(workdir) if (workdir and ckpt_every) else None
    monitor = StragglerMonitor()
    losses, restarts, restore_s, snaps = [], 0, [], []
    step = 0
    while step < steps:
        batch = data.batch(step, device=dev if mesh is None else "cpu")
        monitor.start()
        try:
            if injector is not None:
                injector.check(step)
            state, mets = step_fn(state, batch)
            loss = float(mets["loss"])
        except InjectedFault:
            if mgr is None:
                raise
            restarts += 1
            if say:
                print(f"[fault] step {step}: restoring latest checkpoint")
            state = None
            t0 = time.perf_counter()
            try:
                step, state = _restore(mgr, cfg, mesh, places, dev)
                restore_s.append(time.perf_counter() - t0)
            except FileNotFoundError:
                # failed before the first checkpoint: a cold restart, the
                # same seed and stateless data indexing replay the run
                state = init_state(cfg, tcfg, mesh, multi_pod, device=dev)
                step = 0
            step_fn = make_train_step(cfg, tcfg, mesh, multi_pod)
            continue
        monitor.stop(step)
        losses.append(loss)
        if say and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(mets['grad_norm']):.3f} "
                  f"lr {float(mets['lr']):.2e}")
        step += 1
        if mgr is not None and step % ckpt_every == 0:
            _save(mgr, step, state, mesh, places)
            snaps.append(mgr.last_snapshot_s)
    writes = []
    if mgr is not None:
        mgr.wait()
        writes = list(mgr.write_s)
        _barrier(mesh)
    return TrainReport(steps_run=len(losses),
                       final_loss=losses[-1] if losses else float("nan"),
                       losses=losses,
                       straggler_events=monitor.events,
                       restarts=restarts,
                       median_step_s=monitor.median_step_s,
                       ckpt_snapshot_s=snaps, ckpt_write_s=writes,
                       restore_s=restore_s, final_state=state)
