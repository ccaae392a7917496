"""The port's host side against the JAX package: index and neighbour
tables, reuse sets, gate thresholding (all bit-exact), plus the port's
isolation from JAX and its refusal to pick a device it was not given."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.obs import metrics as jmetrics
from repro.serving import detector as jdet
from repro_torch.kernels import ops as tops
from repro_torch.serving import detector as tdet

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fleet(seed, shapes, density=0.5):
    rng = np.random.default_rng(seed)
    return [rng.random(s) < density for s in shapes]


FLEETS = [
    (0, [(4, 5), (3, 4), (5, 3)]),
    (1, [(4, 4), (2, 6), (1, 1), (6, 2)]),
    (2, [(3, 3)]),
]


@pytest.mark.parametrize("seed,shapes", FLEETS)
def test_index_and_neighbor_tables_bit_exact(seed, shapes):
    grids = _fleet(seed, shapes)
    for g in grids:
        idx = tops.mask_to_indices(g)
        np.testing.assert_array_equal(idx, jops.mask_to_indices(g))
        assert idx.dtype == np.int32
        nbr = tops.neighbor_table(idx, g.shape)
        np.testing.assert_array_equal(nbr, jops.neighbor_table(idx, g.shape))
    for a, b in zip(tops.fleet_indices(grids), jops.fleet_indices(grids)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(tops.fleet_neighbor_table(grids),
                                  jops.fleet_neighbor_table(grids))
    groups = [grids[:1], grids[1:]]
    for a, b in zip(tops.superlaunch_tables(groups),
                    jops.superlaunch_tables(groups)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("seed,shapes", FLEETS)
@pytest.mark.parametrize("n_layers", [1, 3])
def test_reuse_sets_and_compaction_bit_exact(seed, shapes, n_layers):
    grids = _fleet(seed, shapes)
    idx, _ = tops.fleet_indices(grids)
    nbr = tops.fleet_neighbor_table(grids)
    rng = np.random.default_rng(seed + 10)
    raw = rng.random(idx.shape[0]) < 0.2
    np.testing.assert_array_equal(tops.dilate_changed(raw, nbr),
                                  jops.dilate_changed(raw, nbr))
    ch, comp = tops.reuse_sets(raw, nbr, n_layers)
    jch, jcomp = jops.reuse_sets(raw, nbr, n_layers)
    np.testing.assert_array_equal(ch, jch)
    np.testing.assert_array_equal(comp, jcomp)
    for a, b in zip(tops.compact_tables(idx, nbr, comp),
                    jops.compact_tables(idx, nbr, comp)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


THRESHOLDS = ["scalar0", "scalar40", "per_camera", "per_class"]


@pytest.mark.parametrize("kind", THRESHOLDS)
def test_gate_thresholding_bit_exact(kind):
    grids = _fleet(3, [(4, 5), (3, 4), (5, 3)])
    idx, _ = tops.fleet_indices(grids)
    nbr = tops.fleet_neighbor_table(grids)
    rng = np.random.default_rng(4)
    n = idx.shape[0]
    stats = np.zeros((n, tops.STATS_WIDTH), np.int32)
    stats[:, tops.GATE_WIN_EXACT] = rng.integers(0, 3, n)
    stats[:, tops.GATE_WIN_BYTES] = rng.integers(0, 80, n)
    thr = {"scalar0": 0.0, "scalar40": 40.0,
           "per_camera": np.array([0.0, 30.0, 50.0]),
           "per_class": np.array([[0.0, 20.0], [40.0, 0.0],
                                  [10.0, 60.0]])}[kind]
    cls = tdet.tile_class_rows(nbr)
    np.testing.assert_array_equal(cls, jdet.tile_class_rows(nbr))
    cam = idx[:, 0]
    got = tdet.gate_changed_rows(stats, thr, cam, cls)
    np.testing.assert_array_equal(got,
                                  jdet.gate_changed_rows(stats, thr, cam, cls))
    a = tdet.ref_advance_rows(thr, cam, got, cls)
    b = jdet.ref_advance_rows(thr, cam, got, cls)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)


def test_kernel_names_match_reference():
    assert tops.KERNEL_NAMES == jmetrics.KERNEL_NAMES
    with pytest.raises(ValueError):
        tops.record_dispatch("rio_conv_entry")


def test_count_kernels_regions_nest():
    with tops.count_kernels() as outer:
        tops.record_dispatch("roi_conv_entry")
        with tops.count_kernels() as inner:
            tops.record_dispatch("tile_delta_gate", 2)
    assert inner == {"tile_delta_gate": 2}
    assert outer == {"roi_conv_entry": 1, "tile_delta_gate": 2}


def _port_modules():
    base = ROOT / "src" / "repro_torch"
    return sorted("repro_torch." + ".".join(p.relative_to(base)
                                            .with_suffix("").parts)
                  .replace(".__init__", "")
                  for p in base.rglob("*.py"))


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert {"repro_torch.kernels.ops", "repro_torch.net",
            "repro_torch.net.encoder", "repro_torch.obs",
            "repro_torch.core.pipeline", "repro_torch.net.batcher",
            "repro_torch.fleet.topology", "repro_torch.obs.sentinel",
            "repro_torch.obs.loadgen", "repro_torch.fleet.faults",
            "repro_torch.fleet.drift", "repro_torch.data",
            "repro_torch.data.streams", "repro_torch.fleet.sharded",
            "repro_torch.launch.mesh",
            "repro_torch.distributed.shardings",
            "repro_torch.models.moe", "repro_torch.launch.serve",
            "repro_torch.models.rwkv", "repro_torch.models.ssm",
            "repro_torch.models.dist", "repro_torch.models.cache_layout",
            "repro_torch.data.lm",
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
            "repro_torch.distributed.fault",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.tensor_parallel", "repro_torch.train",
            "repro_torch.train.loop", "repro_torch.launch.train"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'"
            " or m.startswith(('jax.', 'repro.'))]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["repro_torch", "repro_torch.obs",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.distributed.shardings"])
def test_importing_the_package_or_obs_loads_no_core_or_net(module):
    """``obs`` (its harnesses included) imports the rest of the port
    inside its functions only; the fleet mesh and its placement import
    none of it."""
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.startswith(("
            "'repro_torch.core', 'repro_torch.net', "
            "'repro_torch.serving', 'repro_torch.fleet'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_import_no_jax_or_reference():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    port = ROOT / "src" / "repro_torch"
    assert {port / "fleet" / "sharded.py", port / "launch" / "mesh.py",
            port / "distributed" / "shardings.py", port / "models" / "moe.py",
            port / "launch" / "serve.py", port / "models" / "rwkv.py",
            port / "models" / "ssm.py", port / "models" / "dist.py",
            port / "data" / "lm.py", port / "optim" / "adamw.py",
            port / "checkpoint" / "ckpt.py", port / "distributed" / "fault.py",
            port / "distributed" / "compression.py",
            port / "train" / "loop.py",
            port / "launch" / "train.py"} <= set(files)
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 4
    files += examples
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b(?!_torch)", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f


def test_no_hidden_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tdet.RoIDetector(tdet.DetectorConfig())
    det = tdet.RoIDetector(tdet.DetectorConfig(), device="cpu")
    assert det.head.device.type == "cpu"


def test_packed_reference_mode_builds():
    """The packed reference mode, refused until its gate kernel was
    ported, now builds with empty references; an unknown mode raises."""
    cache = tdet.PackedActivationCache(ref_mode="packed")
    assert cache.ref_mode == "packed" and cache.ref_win is None
    with pytest.raises(ValueError):
        tdet.PackedActivationCache(ref_mode="nope")
