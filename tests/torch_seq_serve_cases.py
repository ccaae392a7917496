"""Shared cases of the sequence split of a serving cache over the batch
axes (``kv_seq_shard``) on gloo ranks on the CPU, for
``test_torch_seq_serve.py``.

Each case at SMOKE in float32 runs on (2, 1) meshes (2 ranks) and on
(2, 2) and (4, 1) meshes (4 ranks) at a batch of 1 -- which the batch
axes do not divide -- and, on (2, 1), at a batch of 2 under
``kv_seq_shard=True``, through ``tests/torch_dist_worker.py``'s
``seq_serve`` case (one subprocess a world size): every rank cuts its
model shard of the same full parameters (``param_pspecs``' tp mode),
builds its cache shard with ``init_cache(dist)``, prefills all the
batch's rows and decodes ``STEPS`` teacher-forced tokens; on the first
mesh of each world it also serves ``REQUESTS`` through
``ServingEngine``.  Rank 0 saves every rank's results.

The test side holds them against the single-process path on the CPU on
the same parameters and inputs (``reference``): the logits of prefill
and of every decode step within ``BAR`` of the largest |logit|; after
prefill and after the last step each rank's cache shard within ``BAR``
of each leaf's largest value of the matching slice of the one-rank
cache (``cache_placements(kv_seq_shard=True)``), its shape equal to
that slice's; the engine's greedy tokens equal on every rank and to the
one-rank engine's.
"""
import numpy as np
import torch

STEPS, SEED, GREEDY = 3, 0, 4
BAR = 1e-5
# the meshes of each world size; the batches run on each
MESHES = {2: [[2, 1]], 4: [[2, 2], [4, 1]]}
BATCHES = {(2, 1): (1, 2), (2, 2): (1,), (4, 1): (1,)}
# each case: the arch, config overrides, the prompt's rows and the caches'
# max_seq (a multiple of 4); the windowed archs' prompts pass their
# window of 32, so their caches are rings, split over the batch ranks
CASES = {
    "h2o-danube3-4b": dict(prompt=40, max_seq=48),
    # one KV head: on (2, 2) the sequence over ("data", "model") joined
    "h2o-danube3-4b:kh1": dict(prompt=40, max_seq=48,
                               overrides={"num_kv_heads": 1}),
    "gemma3-27b": dict(prompt=40, max_seq=48),
    "zamba2-2.7b": dict(prompt=20, max_seq=32),
    "rwkv6-7b": dict(prompt=20, max_seq=32),
}


def arch_of(case: str) -> str:
    return case.split(":")[0]


def config(case: str):
    from torch_dist_worker import smoke
    return smoke(arch_of(case), CASES[case].get("overrides"))


def params_full(cfg):
    from repro_torch.models.params import init_params
    return init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")


def inputs(cfg, case: str, B: int):
    """The batch's tokens (B, prompt), the teacher-forced decode tokens
    (B, STEPS) and the engine's requests."""
    from repro_torch.serving.engine import Request
    S = CASES[case]["prompt"]
    g = torch.Generator().manual_seed(SEED + B)
    rng = np.random.default_rng(SEED + 2)
    V = cfg.vocab_size
    tokens = torch.randint(0, V, (B, S), generator=g)
    steps = torch.randint(0, V, (B, STEPS), generator=g)
    requests = [Request(i, tokens=rng.integers(0, V, S - 3 * i),
                        max_new_tokens=GREEDY - i) for i in range(2)]
    return tokens, steps, requests


def run(params, cfg, case, B, dist=None, engine=False, device="cpu"):
    """init_cache, prefill and STEPS teacher-forced decode steps of the
    whole batch of ``B`` on ``params`` (a rank's model shard under
    ``dist``), and with ``engine`` the engine's greedy tokens: {init
    shapes, prefill logits, each step's logits, the caches after
    prefill and after the last step, tokens}, on the host."""
    from repro_torch.configs import ServeConfig
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    tokens, steps, requests = inputs(cfg, case, B)
    caches = M.init_cache(cfg, B, CASES[case]["max_seq"], device, dist=dist)
    shapes = _leaves(caches, lambda t: tuple(t.shape))
    logits, caches = M.prefill(params, cfg, {"tokens": tokens.to(device)},
                               caches, dist=dist)
    out = {"shapes": shapes, "prefill": logits.cpu(),
           "cache_prefill": _leaves(caches, _host_copy)}
    step_logits = []
    start = tokens.shape[1]
    for i in range(STEPS):
        pos = torch.full((B,), start + i, dtype=torch.long, device=device)
        lg, caches = M.decode_step(params, cfg, steps[:, i:i + 1].to(device),
                                   caches, pos, dist=dist)
        step_logits.append(lg.cpu())
    out["steps"] = step_logits
    out["cache_final"] = _leaves(caches, _host_copy)
    if engine:
        eng = ServingEngine(cfg, ServeConfig(max_batch=2), params, dist=dist)
        out["tokens"] = {rid: torch.from_numpy(t) for rid, t in
                         eng.serve(requests, greedy_steps=GREEDY).items()}
    return out


def _host_copy(t):
    """A copy on the host: the caches are written in place later."""
    return t.to("cpu", copy=True)


def _leaves(tree, fn):
    """``fn`` of every tensor of a cache tree, in a flat list (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], fn)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t, fn)]
    return [fn(tree)]


# ---------------------------------------------------------------------------
# the rank side (imports no JAX)
# ---------------------------------------------------------------------------

def seq_ranks(rank, world, a):
    """Every case of ``a["cases"]`` on every mesh of ``world`` ranks and
    every batch of ``BATCHES``, under ``kv_seq_shard``: this rank's
    results, one a (case, mesh, batch)."""
    from repro_torch.distributed.shardings import (make_dist, named,
                                                   param_pspecs)
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models.params import param_specs
    res = []
    for case in a["cases"]:
        cfg = config(case)
        full = params_full(cfg)
        for m, shape in enumerate(MESHES[world]):
            mesh = make_train_mesh(tuple(shape), device="cpu")
            d = make_dist(mesh, kv_seq_shard=True)
            pl = named(mesh, param_pspecs(cfg, param_specs(cfg), "tp",
                                          mesh=mesh))
            params = {n: pl[n].shard(v) for n, v in full.items()}
            for i, B in enumerate(BATCHES[tuple(shape)]):
                with torch.no_grad():
                    out = run(params, cfg, case, B, d,
                              engine=m == 0 and i == 0)
                out.update(case=case, mesh=shape, B=B,
                           coords=dict(mesh.coords))
                res.append(out)
    return res


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

_REFS = {}


def reference(case, B):
    """The single-process path on the full parameters and the whole
    batch, and the one-rank engine (cached a (case, batch))."""
    if (case, B) not in _REFS:
        cfg = config(case)
        with torch.no_grad():
            _REFS[case, B] = cfg, run(params_full(cfg), cfg, case, B,
                                      engine=True)
    return _REFS[case, B]


def _close(got, want, what):
    scale = float(want.abs().max().clamp_min(1e-30))
    err = float((got - want).abs().max()) / scale
    assert err <= BAR, (what, err)


def check_logits(got, case):
    """Prefill's and every step's logits, every row on every rank."""
    cfg, want = reference(case, got["B"])
    assert got["prefill"].shape == want["prefill"].shape
    _close(got["prefill"], want["prefill"], "prefill")
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        _close(g, w, f"step {i}")


def check_caches(got, case):
    """``init_cache(dist)``'s shapes and the cache shards after prefill and
    after the last step against the one-rank caches' slices."""
    from repro_torch.models import model as M
    from torch_tp_serve_cases import StandIn, placements
    cfg, want = reference(case, got["B"])
    mesh = StandIn({"data": got["mesh"][0], "model": got["mesh"][1]},
                   got["coords"])
    whole = M.init_cache(cfg, got["B"], CASES[case]["max_seq"], "cpu")
    pls = placements(cfg, whole, mesh, kv_seq_shard=True)
    shapes = [pl.local_shape(t.shape) for pl, t in
              zip(pls, _leaves(whole, lambda t: t))]
    assert got["shapes"] == shapes
    for key in ("cache_prefill", "cache_final"):
        for j, (g, w, pl) in enumerate(zip(got[key], want[key], pls)):
            _close(g.float(), pl.shard(w).float(), f"{key} leaf {j}")


def check_tokens(every, case):
    """The engine's greedy tokens, equal on every rank that served and to
    the one-rank engine's."""
    _, want = reference(case, 1)
    served = [got for got in every if "tokens" in got]
    assert served
    for got in served:
        assert set(got["tokens"]) == set(want["tokens"])
        for rid, t in got["tokens"].items():
            assert torch.equal(t, want["tokens"][rid]), (rid, got["coords"])


def results_by_case(every_rank):
    """{(case, mesh, batch): [each rank's result]} from the worker's list
    of each rank's result lists."""
    out = {}
    for res in every_rank:
        for r in res:
            out.setdefault((r["case"], tuple(r["mesh"]), r["B"]),
                           []).append(r)
    return out


def run_cases(tmp_path, cases, world):
    from test_torch_dist import _run_worker
    every = _run_worker("seq_serve", tmp_path, timeout=300, world=world,
                        cases=list(cases))
    return results_by_case(every)


CHECKS = {"logits": check_logits, "caches": check_caches}


def check_case(results, case, world, what):
    """``what`` ("logits", "caches" or "tokens") of ``case`` on every mesh
    of ``world`` ranks and every batch, every rank."""
    for shape in MESHES[world]:
        for B in BATCHES[tuple(shape)]:
            ranks = results[(case, tuple(shape), B)]
            assert len(ranks) == world
            if what == "tokens":
                if B == 1 and shape == MESHES[world][0]:
                    check_tokens(ranks, case)
            else:
                for got in ranks:
                    CHECKS[what](got, case)
