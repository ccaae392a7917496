"""Shared cases of serving over a model axis on gloo ranks on the CPU, for
``test_torch_tp_serve_*.py``.

Each arch at SMOKE in float32 serves on (1, 2) meshes (2 ranks) and on
(1, 4) and (2, 2) meshes (4 ranks), through ``tests/torch_dist_worker.py``'s
``serve`` case (one subprocess a world size): every rank cuts its model
shard of the same full parameters (``param_pspecs``' tp mode), builds its
cache shard with ``init_cache(dist)``, prefills its batch rows and
decodes ``STEPS`` teacher-forced tokens, then serves ``requests``
through ``ServingEngine``.  Rank 0 saves every rank's results.

The test side holds them against the single-process path on the CPU on
the same parameters and inputs (``reference``; the configs are
``smoke``'s of ``tests/torch_dist_worker.py``, the same as
``tests/torch_tp_cases.py``'s), with the bars of
``tests/torch_tp_cases.py``: the logits of prefill and of every decode
step within 1e-5 of the largest |logit|; after prefill and after the
last step, each rank's cache shard within 1e-5 of each leaf's largest
value of the matching slice of the one-rank cache (``placements``);
the shard shapes equal to that slice's; the engine's greedy tokens equal
on every rank and to the one-rank engine's.
"""
import numpy as np
import torch

B, STEPS, SEED = 2, 6, 0
BAR = 1e-5
# the meshes of each world size
MESHES = {2: [[1, 2]], 4: [[1, 4], [2, 2]]}
# each case: the arch, config overrides, the prompt's rows and the caches'
# max_seq (a multiple of 4: every shard an exact slice of the one-rank
# cache); the windowed archs' prompts pass their window, so their caches
# are rings
CASES = {
    "h2o-danube3-4b": dict(prompt=40, max_seq=48),
    "h2o-danube3-4b:grouped": dict(prompt=40, max_seq=48,
                                   overrides={"decode_grouped_attn": True}),
    "gemma3-27b": dict(prompt=40, max_seq=48),
    # a window that 4 does not divide: at tp 4 every rank holds its rings
    # whole (the sequence split's one unsliced cache)
    "gemma3-27b:window30": dict(prompt=40, max_seq=48,
                                overrides={"window_size": 30}),
    "deepseek-moe-16b": dict(prompt=20, max_seq=32),
    "qwen3-moe-235b-a22b": dict(prompt=20, max_seq=32),
    "internvl2-26b": dict(prompt=56, max_seq=64),
    "rwkv6-7b": dict(prompt=20, max_seq=32),
    "zamba2-2.7b": dict(prompt=20, max_seq=32),
    "whisper-small": dict(prompt=8, max_seq=24),
    # one query head of 16: a model axis of 2 cuts it (whisper-small's
    # 12 heads over the production mesh's 16)
    "whisper-small:one_head": dict(
        prompt=8, max_seq=24, overrides={"num_heads": 1, "num_kv_heads": 1}),
}
PACK_BLOCK = 16          # the vlm prompt's RoI packing block


def arch_of(case: str) -> str:
    return case.split(":")[0]


def config(case: str):
    from torch_dist_worker import smoke
    return smoke(arch_of(case), CASES[case].get("overrides"))


def params_full(cfg):
    from repro_torch.models.params import init_params
    return init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")


def inputs(cfg, case: str):
    """The global batch, prefill's keyword arguments, the teacher-forced
    decode tokens (B, STEPS) and their start position, and the engine's
    requests (None for encdec, which the engine does not serve)."""
    from repro_torch.kernels.ops import pack_tokens
    from repro_torch.serving.engine import Request
    spec = CASES[case]
    S = spec["prompt"]
    g = torch.Generator().manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 2)
    V = cfg.vocab_size
    kw, start, requests = {}, S, None
    if cfg.family == "vlm":
        # one CrossRoI keep-list over B camera streams, packed
        x = torch.randn((B, S, cfg.frontend_dim), generator=g)
        keep = torch.from_numpy(rng.random(S) < 0.6)
        packed = [pack_tokens(x[b], keep, PACK_BLOCK) for b in range(B)]
        batch = {"tokens": torch.zeros((B, 0), dtype=torch.long),
                 "patches": torch.stack([p[0] for p in packed])}
        kw = {"positions": torch.stack([p[1] for p in packed]),
              "last_index": packed[0][2] - 1}
        start = packed[0][2]
        requests = [Request(i, tokens=rng.standard_normal(
            (S - 7 * i, cfg.frontend_dim)).astype(np.float32),
            keep=rng.random(S - 7 * i) < 0.6, max_new_tokens=STEPS - i)
            for i in range(3)]
    elif cfg.family == "encdec":
        T = S
        batch = {"frames": torch.randn((B, spec["max_seq"],
                                        cfg.frontend_dim), generator=g),
                 "tokens": torch.randint(0, V, (B, T), generator=g)}
        start = T
    else:
        batch = {"tokens": torch.randint(0, V, (B, S), generator=g)}
        requests = [Request(i, tokens=rng.integers(0, V, S - 3 * i),
                            max_new_tokens=STEPS - i) for i in range(3)]
    steps = torch.randint(0, V, (B, STEPS), generator=g)
    return batch, kw, steps, start, requests


def serve_config(cfg):
    from repro_torch.configs import ServeConfig
    return ServeConfig(max_batch=4, roi_sparsity=cfg.family == "vlm")


def run(params, cfg, case, dist=None, rows=slice(None), device="cpu"):
    """prefill, STEPS teacher-forced decode steps and the engine on
    ``params`` (a rank's model shard under ``dist``, on ``device``), the
    batch's ``rows``: {init shapes, prefill logits, each step's logits,
    the caches after prefill and after the last step, the engine's
    tokens}, on the host."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    batch, kw, steps, start, requests = inputs(cfg, case)
    batch = {k: v[rows].to(device) for k, v in batch.items()}
    kw = {k: v[rows].to(device) if torch.is_tensor(v) else v
          for k, v in kw.items()}
    steps = steps[rows].to(device)
    Bl = steps.shape[0]
    caches = M.init_cache(cfg, Bl * (dist.dp if dist else 1),
                          CASES[case]["max_seq"], device, dist=dist)
    shapes = _leaves(caches, lambda t: tuple(t.shape))
    logits, caches = M.prefill(params, cfg, batch, caches, dist=dist, **kw)
    out = {"shapes": shapes, "prefill": logits.cpu(),
           "cache_prefill": _leaves(caches, _host_copy)}
    step_logits = []
    for i in range(STEPS):
        pos = torch.full((Bl,), start + i, dtype=torch.long, device=device)
        lg, caches = M.decode_step(params, cfg, steps[:, i:i + 1], caches,
                                   pos, dist=dist)
        step_logits.append(lg.cpu())
    out["steps"] = step_logits
    out["cache_final"] = _leaves(caches, _host_copy)
    if requests is not None:
        eng = ServingEngine(cfg, serve_config(cfg), params, dist=dist)
        out["tokens"] = engine_tokens(eng, requests)
    else:               # encdec: greedy decode through the model API
        caches = M.init_cache(cfg, Bl * (dist.dp if dist else 1),
                              CASES[case]["max_seq"], device, dist=dist)
        lg, caches = M.prefill(params, cfg, batch, caches, dist=dist)
        tok, toks = torch.argmax(lg[:, -1], dim=-1)[:, None], []
        for i in range(STEPS):
            lg, caches = M.decode_step(params, cfg, tok, caches, start + i,
                                       dist=dist)
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            toks.append(tok)
        r0 = rows.start or 0
        out["tokens"] = {r0 + b: t for b, t in
                         enumerate(torch.cat(toks, dim=1).cpu())}
    return out


def engine_tokens(eng, requests):
    """The engine's greedy tokens through ``serve``, through
    ``serve_deadline`` (the requests in two camera groups, arriving 0.3 s
    apart, a 0.5 s deadline; its report's counts too) and through
    ``decode_tokens_group`` over per-request prefills (``roi_prefill``
    where a request has a keep-list), keyed by (route, request)."""
    import dataclasses
    out = {("serve", rid): torch.from_numpy(t) for rid, t in
           eng.serve(requests, greedy_steps=STEPS).items()}
    timed = [dataclasses.replace(r, group=r.rid % 2, arrival_s=0.3 * r.rid)
             for r in requests]
    res, rep = eng.serve_deadline(timed, group_sizes={0: 2, 1: 1},
                                  deadline_s=0.5, greedy_steps=STEPS)
    out.update({("deadline", rid): torch.from_numpy(t)
                for rid, t in res.items()})
    out[("deadline", "report")] = torch.tensor(
        [rep.complete_flushes, rep.deadline_flushes,
         rep.straggler_requests])
    max_seq = max(-(-len(r.tokens) // 128) * 128 for r in requests) + STEPS
    caches, firsts, starts = [], [], []
    for r in requests:
        if r.keep is not None:
            pre = eng.roi_prefill(r.tokens, r.keep, max_seq=max_seq)
            logits, c, start = pre.logits, pre.caches, pre.n_kept
        else:
            logits, c = eng.prefill({"tokens": np.asarray(r.tokens)[None]},
                                    max_seq=max_seq)
            start = len(r.tokens)
        caches.append(c)
        firsts.append(torch.argmax(logits[:, -1], dim=-1))
        starts.append(start)
    toks, _ = eng.decode_tokens_group(caches, firsts, starts, STEPS)
    out.update({("group", i): torch.from_numpy(t)
                for i, t in enumerate(toks)})
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

def serve_ranks(rank, world, a):
    """Every case of ``a["cases"]`` on every mesh of ``world`` ranks (of
    ``a["meshes"]`` where given), on ``a["device"]`` (the CPU unless
    given; every rank on the one card under ``"cuda"``): this rank's
    results, one a (case, mesh)."""
    from repro_torch.distributed.shardings import (make_dist, named,
                                                   param_pspecs)
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models.params import param_specs
    device = a.get("device", "cpu")
    res = []
    for case in a["cases"]:
        cfg = config(case)
        full = {n: v.to(device) for n, v in params_full(cfg).items()}
        for shape in a.get("meshes", MESHES[world]):
            mesh = make_train_mesh(tuple(shape), device=device)
            d = make_dist(mesh)
            pl = named(mesh, param_pspecs(cfg, param_specs(cfg), "tp",
                                          mesh=mesh))
            params = {n: pl[n].shard(v) for n, v in full.items()}
            bl = B // d.dp
            r0 = mesh.index("data") * bl
            with torch.no_grad():
                out = run(params, cfg, case, d, slice(r0, r0 + bl),
                          mesh.device)
            out.update(case=case, mesh=shape, coords=dict(mesh.coords))
            res.append(out)
    return res


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

class StandIn:
    """A ``TrainMesh`` stand-in at one rank's coordinates (no groups), for
    ``Placement``s in the test process."""

    def __init__(self, shape, coords):
        self.shape, self.coords = dict(shape), dict(coords)
        self.axis_names = tuple(shape)

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape.get(x, 1) for x in axes]))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for x in self.axis_names:
            if x in axes:
                i = i * self.shape[x] + self.coords[x]
        return i


def placements(cfg, cache, mesh, **kw):
    """Each leaf's ``Placement`` (flat, as ``_leaves``), from
    ``cache_placements`` (given ``kw``)."""
    from repro_torch.distributed.shardings import cache_placements
    return _leaves(cache_placements(cfg, cache, mesh, **kw), lambda p: p)


_REFS = {}


def reference(case):
    """The single-process path on the full parameters and the whole
    batch, and the one-rank engine (cached a case)."""
    if case not in _REFS:
        cfg = config(case)
        with torch.no_grad():
            _REFS[case] = cfg, run(params_full(cfg), cfg, case)
    return _REFS[case]


def _close(got, want, what):
    scale = float(want.abs().max().clamp_min(1e-30))
    err = float((got - want).abs().max()) / scale
    assert err <= BAR, (what, err)


def check_logits(got, case):
    """Prefill's and every step's logits, whole on every rank, against the
    one-rank path's rows of the rank."""
    cfg, want = reference(case)
    bl = B // got["mesh"][0]
    r0 = got["coords"]["data"] * bl
    assert got["prefill"].shape[-1] == cfg.vocab_size
    _close(got["prefill"], want["prefill"][r0:r0 + bl], "prefill")
    for i, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        _close(g, w[r0:r0 + bl], f"step {i}")


def check_caches(got, case):
    """``init_cache(dist)``'s shapes and the cache shards after prefill and
    after the last step against the one-rank caches' slices."""
    cfg, want = reference(case)
    from repro_torch.models import model as M
    mesh = StandIn({"data": got["mesh"][0], "model": got["mesh"][1]},
                   got["coords"])
    whole = M.init_cache(cfg, B, CASES[case]["max_seq"], "cpu")
    pls = placements(cfg, whole, mesh)
    shapes = [pl.local_shape(t.shape) for pl, t in
              zip(pls, _leaves(whole, lambda t: t))]
    assert got["shapes"] == shapes
    for key in ("cache_prefill", "cache_final"):
        for j, (g, w, pl) in enumerate(zip(got[key], want[key], pls)):
            _close(g.float(), pl.shard(w).float(), f"{key} leaf {j}")


def check_tokens(every, case):
    """The engine's greedy tokens by each route (``engine_tokens``;
    encdec's: each batch row's greedy decode through the model API):
    equal on every rank of a mesh and to the one-rank path's."""
    _, want = reference(case)
    seen = set()
    for got in every:
        assert set(got["tokens"]) <= set(want["tokens"])
        for rid, t in got["tokens"].items():
            assert torch.equal(t, want["tokens"][rid]), (rid, got["coords"])
        seen |= set(got["tokens"])
    assert seen == set(want["tokens"])


def results_by_case(every_rank):
    """{(case, mesh): [each rank's result]} from the worker's list of each
    rank's result lists."""
    out = {}
    for res in every_rank:
        for r in res:
            out.setdefault((r["case"], tuple(r["mesh"])), []).append(r)
    return out


def run_cases(tmp_path, cases, world):
    from test_torch_dist import _run_worker
    every = _run_worker("serve", tmp_path, timeout=300, world=world,
                        cases=list(cases))
    return results_by_case(every)


CHECKS = {"logits": check_logits, "caches": check_caches}


def check_case(results, case, world, what, meshes=None):
    """``what`` ("logits", "caches" or "tokens") of ``case`` on every mesh
    of ``world`` ranks (or of ``meshes``), every rank."""
    for shape in meshes or MESHES[world]:
        ranks = results[(case, tuple(shape))]
        assert len(ranks) == world
        if what == "tokens":
            check_tokens(ranks, case)
        else:
            for got in ranks:
                CHECKS[what](got, case)
