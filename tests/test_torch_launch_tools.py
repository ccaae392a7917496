"""The port's launch tools against the JAX package's on the CPU, no
process group: the pure functions of ``launch.roofline`` and
``launch.steps.auto_microbatch`` on all 40 (arch, shape) cells,
``launch.memory.estimate_cell``'s every component on every cell x
{tp, fsdp} x {(16, 16), (2, 16, 16)} (only ``fits`` differs: it is
total <= the H100's 80 GiB), ``perf``'s experiments, the H100's
constants, and the cache specs of the sequence split over the batch
axes: ``cache_pspecs`` and ``cache_placements``' KV leaves equal to
JAX's ``cache_pspecs`` on the trees and meshes of
``tests/test_torch_seq_serve.py`` and of the long-context cell on the
production meshes.  The JAX functions read only ``mesh.shape``; JAX's
``launch/perf.py`` forces 512 host devices on import, so its
experiments are read in a subprocess."""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import get_config as jget_config
from repro.distributed import shardings as JS
from repro.launch import memory as JMEM
from repro.launch import roofline as JR
from repro.launch import steps as JSTEPS
from repro.models import model as JM
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.registry import all_cells
from repro_torch.distributed import shardings as TS
from repro_torch.launch import memory as TMEM
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import perf as TPERF
from repro_torch.launch import roofline as TR
from repro_torch.launch import steps as TSTEPS
from repro_torch.models import model as TM
from torch_seq_serve_cases import BATCHES, CASES, arch_of, config
from torch_tp_serve_cases import StandIn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, c.name) for a, c, _ in all_cells(include_skips=True)]
PRODUCTION = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}


def _same_config(cfg, jcfg):
    """Every field the two packages' configs share, equal (the port's
    adds ``qk_norm``); ``jcfg`` a config or its fields through JSON."""
    a = dataclasses.asdict(cfg)
    if isinstance(jcfg, dict):
        a = json.loads(json.dumps(a))
        b = jcfg
    else:
        b = dataclasses.asdict(jcfg)
    assert set(b) <= set(a)
    assert {k: a[k] for k in b} == b


def test_forty_cells():
    assert len(CELLS) == 40


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_helpers_match_jax(arch, shape):
    """model_flops_for, calib_depths, with_depth at both depths,
    full_depth, extrapolate to the full depth and auto_microbatch on
    both production meshes, equal to the JAX package's."""
    cfg, jcfg, cell = get_config(arch), jget_config(arch), SHAPES[shape]
    assert TR.model_flops_for(cfg, cell) == JR.model_flops_for(jcfg, cell)
    depths = TR.calib_depths(cfg)
    assert depths == JR.calib_depths(jcfg)
    for L in depths:
        _same_config(TR.with_depth(cfg, L), JR.with_depth(jcfg, L))
    lf = TR.full_depth(cfg)
    assert lf == JR.full_depth(jcfg)
    c1, c2 = 3.25e12 * depths[0] + 7e9, 3.25e12 * depths[1] + 7e9
    assert TR.extrapolate(c1, c2, *depths, lf) == \
        JR.extrapolate(c1, c2, *depths, lf)
    assert TR.extrapolate(c2, c1, *depths, lf) == \
        JR.extrapolate(c2, c1, *depths, lf)
    for mp, shape_ in PRODUCTION.items():
        mesh = SimpleNamespace(shape=shape_)
        assert TSTEPS.auto_microbatch(cfg, cell, mesh, mp) == \
            JSTEPS.auto_microbatch(jcfg, cell, mesh, mp)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_estimate_cell_matches_jax(arch, shape):
    """Every component of ``estimate_cell`` equal to the JAX package's on
    tp and fsdp over both production meshes, at the microbatch
    ``auto_microbatch`` gives; ``fits`` is the total against 80 GiB."""
    cfg, jcfg, cell = get_config(arch), jget_config(arch), SHAPES[shape]
    for mode in ("tp", "fsdp"):
        for mp, shape_ in PRODUCTION.items():
            mesh = SimpleNamespace(shape=shape_)
            k = JSTEPS.auto_microbatch(jcfg, cell, mesh, mp) \
                if cell.kind == "train" else 1
            got = TMEM.estimate_cell(cfg, cell, mesh, mp, mode, k)
            want = JMEM.estimate_cell(jcfg, cell, mesh, mp, mode, k)
            assert set(got) == set(want)
            for key, v in want.items():
                if key != "fits":
                    assert got[key] == v, (mode, mp, key)
            assert got["fits"] == (got["total"] <= 80 * 2 ** 30)


def test_h100_constants():
    """The roofline's constants are the H100 SXM's."""
    assert TMESH.PEAK_FLOPS_BF16 == 989e12
    assert TMESH.HBM_BW == 3.35e12
    assert TMESH.HBM_PER_CHIP == 80 * 2 ** 30
    assert TMESH.CHIPS_PER_POD == 256
    assert TMESH.COLL_BW == 450e9
    t = TR.RooflineTerms("a", "c", "16x16", 989e12, 3.35e12, 450e9, {},
                         989e12 * 256, 256)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 1.0, 1.0)
    assert t.roofline_fraction == 1.0 and t.useful_ratio == 1.0


def test_perf_experiments_match_jax():
    """``perf.EXPERIMENTS``: the same experiments, cells, labels and
    variant settings as the JAX package's (its configs and cells after
    each variant's transforms compared field by field)."""
    code = (
        "import json, dataclasses\n"
        "from repro.configs.base import SHAPES\n"
        "from repro.configs.registry import get_config\n"
        "from repro.launch.perf import EXPERIMENTS\n"
        "out = {}\n"
        "for e, (a, s, vs) in EXPERIMENTS.items():\n"
        "    rows = []\n"
        "    for label, kw in vs:\n"
        "        cfg = get_config(a)\n"
        "        if 'cfg_transform' in kw:\n"
        "            cfg = kw['cfg_transform'](cfg)\n"
        "        cell = SHAPES[s]\n"
        "        if 'cell_transform' in kw:\n"
        "            cell = kw['cell_transform'](cell)\n"
        "        rows.append([label, kw.get('sharding_mode', 'auto'),\n"
        "                     kw.get('tcfg_kwargs'), dataclasses.asdict(cfg),\n"
        "                     dataclasses.astuple(cell)])\n"
        "    out[e] = [a, s, rows]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(TPERF.EXPERIMENTS) == list(want)
    for e, (arch, shape, variants) in TPERF.EXPERIMENTS.items():
        assert [arch, shape] == want[e][:2]
        assert len(variants) == len(want[e][2])
        for (label, kw), row in zip(variants, want[e][2]):
            cfg, cell = get_config(arch), SHAPES[shape]
            if "cfg_transform" in kw:
                cfg = kw["cfg_transform"](cfg)
            if "cell_transform" in kw:
                cell = kw["cell_transform"](cell)
            got = [label, kw.get("sharding_mode", "auto"),
                   kw.get("tcfg_kwargs"), list(dataclasses.astuple(cell))]
            assert got == row[:3] + row[4:], (e, label)
            _same_config(cfg, row[3])


# ---------------------------------------------------------------------------
# the cache specs of the sequence split over the batch axes
# ---------------------------------------------------------------------------

def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, JP))


def _tleaves(tree):
    if isinstance(tree, (TS.P, TS.Placement, torch.Tensor)):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tleaves(tree[k])]
    return [x for t in tree for x in _tleaves(t)]


def _check_specs(cfg, jcfg, B, S, shape, multi_pod, kv_seq):
    """The port's ``cache_pspecs`` on its own cache tree and
    ``cache_placements``' specs of its KV caches, equal to JAX's
    ``cache_pspecs`` on JAX's tree (the same shapes)."""
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, S))
    cache = TM.init_cache(cfg, B, S, device="meta")
    jl = jax.tree.leaves(jcache)
    tl = _tleaves(cache)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    mesh = StandIn(shape, {a: 0 for a in shape})
    want = [tuple(s) for s in _jleaves(
        JS.cache_pspecs(jcache, mesh, multi_pod, kv_seq))]
    got = [tuple(s) for s in _tleaves(
        TS.cache_pspecs(cache, mesh, multi_pod, kv_seq))]
    assert got == want
    pls = _tleaves(TS.cache_placements(cfg, cache, mesh, multi_pod, kv_seq))
    kv = [(tuple(p.spec), w) for p, w, is_kv in
          zip(pls, want, _tleaves(_kv_flags(cfg, cache))) if is_kv]
    assert all(g == w for g, w in kv), kv
    assert bool(kv) == (cfg.family != "ssm")


def _kv_flags(cfg, cache):
    """A tree of the cache's shape: True at its KV caches (not the
    recurrent states nor whisper's cross K/V)."""
    flag = lambda tree, v: TS.tree_map(lambda t: torch.tensor(v), tree)
    if cfg.family == "ssm":
        return flag(cache, False)
    if cfg.family == "hybrid":
        return {"states": flag(cache["states"], False),
                "attn": flag(cache["attn"], True)}
    return flag(cache, True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_split_specs_match_jax(case):
    """The SMOKE trees of ``test_torch_seq_serve.py`` at its batches and
    meshes, with and without ``kv_seq_shard``."""
    cfg = config(case)
    jcfg = jget_config(arch_of(case), smoke=True).replace(
        dtype="float32", kv_cache_dtype="float32",
        **CASES[case].get("overrides", {}))
    for (d, m), batches in BATCHES.items():
        for B in batches:
            for kv_seq in (False, True):
                _check_specs(cfg, jcfg, B, CASES[case]["max_seq"],
                             {"data": d, "model": m}, False, kv_seq)


@pytest.mark.parametrize("arch", ["gemma3-27b", "h2o-danube3-4b",
                                  "rwkv6-7b", "zamba2-2.7b"])
def test_long_context_specs_match_jax(arch):
    """The long_500k decode cell's FULL trees on both production meshes
    (the dry run's split: h2o-danube3-4b's 8 KV heads put its sequence
    over ("data", "model") and ("pod", "data", "model"))."""
    cell = SHAPES["long_500k"]
    for mp, shape in PRODUCTION.items():
        _check_specs(get_config(arch), jget_config(arch), 1, cell.seq_len,
                     shape, mp, True)
