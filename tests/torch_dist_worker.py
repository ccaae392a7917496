"""Multi-rank cases of the port's data-axis route, for ``test_torch_dist.py``
and ``test_torch_train_fault.py``: run as a script, it spawns one gloo
rank a process on the CPU (a ``file://`` rendezvous in the output
directory, a 60 s collective timeout) and rank 0 saves its results with
``torch.save``.

  python tests/torch_dist_worker.py CASE OUT_DIR JSON_ARGS

Cases: ``route`` (3 training steps on a (world, 1) mesh and the first
step's reduced gradients, gathered whole), ``int8`` (``int8_allreduce_
mean`` of per-rank inputs), ``train`` (``train()`` with
checkpoints, for an elastic restore) and ``model_axis`` (a (1, world)
mesh: ``tp`` raises, ``dp_only`` runs).  Imports no JAX.
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


def smoke(arch):
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).replace(dtype="float32",
                                                kv_cache_dtype="float32")


def tcfg_of(a):
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=12,
                       seed=0, sharding_mode=a["mode"],
                       microbatch=a.get("microbatch", 0),
                       grad_compression=a.get("compression", "none"))


def _route(rank, world, a, out):
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.distributed.shardings import named
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import (init_state, make_train_step,
                                        state_pspecs)
    cfg, tcfg = smoke(a["arch"]), tcfg_of(a)
    mesh = make_train_mesh(tuple(a["mesh"]), device="cpu")
    data = SyntheticLM(cfg.vocab_size, a["seq"], a["batch"], seed=0)
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
    if rank == 0:
        torch.save({"mets": mets, "grads": grads, "params": params,
                    "m": m, "ranks_equal": same,
                    "split": {n: pl.opt.m[n].split for n in params}}, out)


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


def _model_axis(rank, world, a, out):
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import init_state, make_train_step
    cfg = smoke(a["arch"])
    mesh = make_train_mesh((1, world), device="cpu")
    try:
        make_train_step(cfg, tcfg_of(dict(a, mode="tp")), mesh)
        tp = "ran"
    except NotImplementedError as e:
        tp = str(e)
    tcfg = tcfg_of(dict(a, mode="dp_only"))
    state = init_state(cfg, tcfg, mesh, device="cpu")
    from repro_torch.data.lm import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, a["seq"], a["batch"], seed=0)
    _, m = make_train_step(cfg, tcfg, mesh)(state,
                                            data.batch(0, device="cpu"))
    if rank == 0:
        torch.save({"tp": tp, "dp_only_loss": float(m["loss"])}, out)


CASES = {"route": _route, "int8": _int8, "train": _train,
         "model_axis": _model_axis}


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
