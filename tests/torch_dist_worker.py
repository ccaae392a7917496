"""Multi-rank cases of the port's training route, for ``test_torch_dist.py``,
``test_torch_ranks.py``, ``test_torch_train_fault.py`` and the
model-axis tests (``tests/torch_tp_cases.py``): run as a script, it
spawns one gloo rank a process on the CPU (a ``file://`` rendezvous in
the output directory, a 60 s collective timeout) and rank 0 saves its
results with ``torch.save``.

  python tests/torch_dist_worker.py CASE OUT_DIR JSON_ARGS

Cases: ``route`` (3 training steps on a mesh and the first step's
reduced gradients, gathered whole), ``variants`` (``route`` for each of
a list of (mesh, mode, microbatch, compression), those marked ``train``
also through ``train()``), ``int8`` (``int8_allreduce_mean`` of per-rank inputs),
``train`` (``train()`` with checkpoints, for an elastic restore),
``elastic`` (``train()`` with checkpoints on one (data, model) shape,
then restored onto another through an injected fault), ``model_axis``
(a (1, world) mesh: ``tp`` and ``dp_only`` one step each), ``ep`` (the
expert-parallel ``moe_layer`` forward), ``collectives`` (the autograd
collectives of ``distributed.tensor_parallel``), ``serve`` (serving
over a model axis, ``tests/torch_tp_serve_cases.py``) and ``seq_serve``
(the sequence split over the batch axes,
``tests/torch_seq_serve_cases.py``).  Imports no JAX.
"""
import datetime
import json
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def smoke(arch, overrides=None):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32", **(overrides or {}))


class StepData:
    """A training batch a step: ``SyntheticLM``'s tokens and labels, or for
    the vlm and encdec families ``model.make_batch``'s (patches or frames
    cast to float32) from a generator seeded with the step."""

    def __init__(self, cfg, seq, batch):
        from repro_torch.configs.base import ShapeCell
        from repro_torch.data.lm import SyntheticLM
        self.cfg, self.cell = cfg, ShapeCell("tp", seq, batch, "train")
        self.lm = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)

    def batch(self, step, device=None):
        from repro_torch.models.model import make_batch
        if self.cfg.family not in ("vlm", "encdec"):
            return self.lm.batch(step, device=device)
        b = make_batch(self.cfg, self.cell,
                       torch.Generator().manual_seed(1000 + step),
                       device=device)
        return {k: v.float() if v.is_floating_point() else v
                for k, v in b.items()}


def tcfg_of(a):
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12,
                       seed=0, sharding_mode=a["mode"],
                       microbatch=a.get("microbatch", 0),
                       grad_compression=a.get("compression", "none"))


def _run_route(world, a, with_train=False):
    """3 steps on ``a["mesh"]`` (and ``train()`` over as many with
    ``with_train``): the metrics, the first step's reduced gradients and
    the final parameters and first moments gathered whole, and whether
    every rank gathered the same parameters (each rank's copies of a
    leaf replicated over an axis included)."""
    from repro_torch.distributed.shardings import named
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import (init_state, make_train_step,
                                        state_pspecs, train)
    cfg, tcfg = smoke(a["arch"], a.get("overrides")), tcfg_of(a)
    mesh = make_train_mesh(tuple(a["mesh"]), device="cpu")
    data = StepData(cfg, a["seq"], a["batch"])
    state = init_state(cfg, tcfg, mesh, device="cpu")
    step = make_train_step(cfg, tcfg, mesh)
    pl = named(mesh, state_pspecs(cfg, tcfg, False, mesh))
    _, g = step.gradients(state, data.batch(0, device="cpu"))
    grads = {n: pl.opt.m[n].gather(v) for n, v in g.items()}
    mets = []
    for s in range(a["steps"]):
        state, m = step(state, data.batch(s, device="cpu"))
        mets.append({k: float(v) for k, v in m.items()})
    params = {n: pl.params[n].gather(v) for n, v in state.params.items()}
    m = {n: pl.opt.m[n].gather(v) for n, v in state.opt.m.items()}
    every = [None] * world
    dist.all_gather_object(every, params)
    same = all(torch.equal(every[0][n], e[n]) for e in every
               for n in params)
    res = {"mets": mets, "grads": grads, "params": params, "m": m,
           "ranks_equal": same,
           "split": {n: pl.opt.m[n].split for n in params},
           "model_split": {n: pl.params[n].model is not None
                           for n in params}}
    if with_train:
        rep = train(cfg, tcfg, steps=a["steps"],
                    batch_shape=(a["batch"], a["seq"]), mesh=mesh,
                    data=data, verbose=False)
        res["train_losses"] = rep.losses
    return res


def _route(rank, world, a, out):
    res = _run_route(world, a)
    if rank == 0:
        torch.save(res, out)


def _variants(rank, world, a, out):
    res = []
    for v in a["variants"]:
        res.append(_run_route(world, dict(a, **v),
                              with_train=v.get("train", False)))
    if rank == 0:
        torch.save(res, out)


def _int8(rank, world, a, out):
    from repro_torch.distributed.compression import int8_allreduce_mean
    inputs = torch.load(a["inputs"])
    got = int8_allreduce_mean({k: v[rank].clone() for k, v in
                               inputs.items()})
    if rank == 0:
        torch.save(got, out)


def _train(rank, world, a, out):
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import train
    cfg, tcfg = smoke(a["arch"]), tcfg_of(a)
    mesh = make_train_mesh(tuple(a["mesh"]), device="cpu")
    rep = train(cfg, tcfg, steps=a["steps"],
                batch_shape=(a["batch"], a["seq"]), mesh=mesh,
                workdir=a["workdir"], ckpt_every=a["ckpt_every"],
                verbose=False)
    if rank == 0:
        torch.save({"losses": rep.losses}, out)


def _elastic(rank, world, a, out):
    """``train()`` on ``a["save_mesh"]`` with checkpoints, then on
    ``a["load_mesh"]`` from the latest of them (a fault at its step 0),
    in ``a["load_mode"]``."""
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import train
    cfg, tcfg = smoke(a["arch"]), tcfg_of(a)
    kw = dict(batch_shape=(a["batch"], a["seq"]), workdir=a["workdir"],
              ckpt_every=a["ckpt_every"], verbose=False)
    first = train(cfg, tcfg, steps=a["steps"],
                  mesh=make_train_mesh(tuple(a["save_mesh"]), device="cpu"),
                  **kw)
    cont = train(cfg, tcfg_of(dict(a, mode=a["load_mode"])),
                 steps=a["total"],
                 mesh=make_train_mesh(tuple(a["load_mesh"]), device="cpu"),
                 injector=FaultInjector((0,)), **kw)
    if rank == 0:
        torch.save({"first": first.losses, "cont": cont.losses,
                    "restarts": cont.restarts}, out)


def _model_axis(rank, world, a, out):
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import init_state, make_train_step
    cfg = smoke(a["arch"])
    mesh = make_train_mesh((1, world), device="cpu")
    data = SyntheticLM(cfg.vocab_size, a["seq"], a["batch"], seed=0)
    loss = {}
    for mode in ("tp", "dp_only"):
        tcfg = tcfg_of(dict(a, mode=mode))
        state = init_state(cfg, tcfg, mesh, device="cpu")
        _, m = make_train_step(cfg, tcfg, mesh)(
            state, data.batch(0, device="cpu"))
        loss[mode] = float(m["loss"])
    if rank == 0:
        torch.save(loss, out)


def _ep(rank, world, a, out):
    """The expert-parallel ``moe_layer`` forward on each (data, model)
    mesh of ``a["meshes"]``: each rank takes its rows of x and its
    experts; y gathered whole over the batch ranks, the dropped share
    and the aux loss, per mesh."""
    from repro_torch.distributed.shardings import make_dist
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models.moe import moe_layer
    cfg = smoke(a["arch"], a.get("overrides"))
    inp = torch.load(a["inputs"])
    res = []
    for shape in a["meshes"]:
        mesh = make_train_mesh(tuple(shape), device="cpu")
        d = make_dist(mesh)
        dp, tp = mesh.size("data"), mesh.size("model")
        rows = inp["x"].shape[0] // dp
        x = inp["x"][mesh.index("data") * rows:][:rows]
        El = cfg.num_experts // tp
        e0 = mesh.index("model") * El
        wg, wu, wd = (inp[k][e0:e0 + El] for k in ("wg", "wu", "wd"))
        y, aux, dropped = moe_layer(x, inp["rw"], wg, wu, wd, cfg, dist=d)
        ys = [torch.empty_like(y) for _ in range(dp)]
        dist.all_gather(ys, y.contiguous(), group=d.batch_group())
        res.append({"y": torch.cat(ys), "aux": float(aux),
                    "dropped": float(dropped)})
    if rank == 0:
        torch.save(res, out)


def _collectives(rank, world, a, out):
    """Each autograd collective of ``distributed.tensor_parallel`` on a
    (1, world) mesh: forward and backward of rank-made inputs, every
    rank's results."""
    from repro_torch.distributed import tensor_parallel as T
    from repro_torch.distributed.shardings import make_dist
    from repro_torch.launch.mesh import make_train_mesh
    d = make_dist(make_train_mesh((1, world), device="cpu"))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(world, 3, 8, generator=gen)     # rank r's input: x[r]
    w = torch.randn(world, 3, 8 * world, generator=gen)
    res = {}
    for name in ("copy_to", "reduce_from", "gather_last", "scatter_last"):
        src = x[rank].clone() if name != "scatter_last" else \
            x[0].repeat(1, world).clone()
        src.requires_grad_(True)
        y = getattr(T, name)(src, d)
        # a rank-made weight on the output: the gradient differs by rank
        wr = w[rank][..., :y.shape[-1]]
        (y * wr).sum().backward()
        res[name] = {"y": y.detach(), "g": src.grad}
    every = [None] * world
    dist.all_gather_object(every, res)
    if rank == 0:
        torch.save(every, out)


def _serve(rank, world, a, out):
    """Serving over a model axis: ``torch_tp_serve_cases.serve_ranks``,
    every rank's results."""
    from torch_tp_serve_cases import serve_ranks
    every = [None] * world
    dist.all_gather_object(every, serve_ranks(rank, world, a))
    if rank == 0:
        torch.save(every, out)


def _seq_serve(rank, world, a, out):
    """The sequence split over the batch axes:
    ``torch_seq_serve_cases.seq_ranks``, every rank's results."""
    from torch_seq_serve_cases import seq_ranks
    every = [None] * world
    dist.all_gather_object(every, seq_ranks(rank, world, a))
    if rank == 0:
        torch.save(every, out)


CASES = {"route": _route, "variants": _variants, "int8": _int8,
         "train": _train, "elastic": _elastic, "model_axis": _model_axis,
         "ep": _ep, "collectives": _collectives, "serve": _serve,
         "seq_serve": _seq_serve}


def _rank(rank, world, case, out_dir, a):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        CASES[case](rank, world, a, os.path.join(out_dir, "result.pt"))
    except BaseException:
        import traceback
        print(f"[rank {rank}] " + traceback.format_exc(), file=sys.stderr,
              flush=True)
        raise
    finally:
        dist.destroy_process_group()


def main():
    case, out_dir, a = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    mp.spawn(_rank, args=(a["world"], case, out_dir, a), nprocs=a["world"],
             join=True)


if __name__ == "__main__":
    main()
