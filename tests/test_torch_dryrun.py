"""The port's dry run (``launch.counter``, ``launch.steps``,
``launch.dryrun``) on the CPU.  PyTorch's fake process group is
process-wide, so every step runs in one subprocess,
``tests/torch_dryrun_worker.py``, and the tests read its results:

* every family at SMOKE (h2o-danube3-4b, internvl2-26b,
  deepseek-moe-16b, rwkv6-7b, zamba2-2.7b, whisper-small) builds and
  counts a train, a prefill, a decode and a batch-of-one decode cell
  (the sequence split over the batch axes) on the (2, 2), (2, 4) and
  (2, 2, 2) debug meshes -- the counterpart of the JAX package's
  ``test_debug_mesh_dryrun_decode``;
* FLOPs summed over every rank of (1, 2) and (2, 1) meshes equal the
  one-rank count exactly for a dense and an MoE step, the MoE's
  replicated work on a model axis (the router and the combine, on every
  rank of the model group) reckoned by hand;
* h2o-danube3-4b SMOKE decode's collective bytes on (2, 4), reckoned by
  hand op by op;
* ``--calibrate``'s extrapolation equals the full-depth count;
* ``dryrun.main`` counts a FULL long_500k cell on the production mesh.

The counter's peak of live bytes is held against a hand count in this
process (no process group)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.counter import count
from torch_dryrun_worker import (DEBUG_MESHES, FAMILIES, KINDS,
                                 RANK_SUM_ARCHS, RANK_SUM_CELL)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dryrun_worker.py")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "out.json"
    r = subprocess.run([sys.executable, WORKER, str(out)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def _ok(res):
    assert res["ok"], res.get("error")
    return res


@pytest.mark.parametrize("shape", ["x".join(map(str, s))
                                   for s in DEBUG_MESHES])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_debug_mesh_cells_count(results, family, kind, shape):
    """The cell ran to its end and did work: FLOPs, HBM bytes, collective
    bytes (every debug mesh has a model axis of 2 or 4) and a peak."""
    r = _ok(results["debug"][f"{family}:{kind}:{shape}"])
    assert r["flops"] > 0 and r["bytes"] > 0 and r["peak"] > 0
    assert r["coll"]["total"] > 0
    assert r["coll"]["total"] == sum(v for k, v in r["coll"].items()
                                     if k != "total")
    if kind == "long":
        assert r["kv_seq_shard"]


def _replicated(arch, kind):
    """FLOPs that every rank of a model group runs whole: the MoE
    router's (N, D) x (D, E) product and the combine's (N, K) x (N, K, D)
    weighting over all K choices, each MoE layer -- three products a
    pass in a train step without remat (forward, and the two gradients),
    one in prefill."""
    cfg = get_config(arch, smoke=True)
    if cfg.family != "moe":
        return 0
    S, B = RANK_SUM_CELL
    N, D = B * S, cfg.d_model
    per = 2 * N * D * cfg.num_experts + 2 * N * cfg.experts_per_token * D
    layers = cfg.num_layers - cfg.first_dense_layers
    return per * layers * (3 if kind == "train" else 1)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", RANK_SUM_ARCHS)
def test_rank_sum_of_flops_is_one_rank_count(results, arch, kind):
    flops = _ok(results["rank_sums"])["flops"]
    one = flops[f"{arch}:{kind}:1x1"]
    assert len(one) == 1 and one[0] > 0
    data = flops[f"{arch}:{kind}:2x1"]
    assert len(data) == 2 and sum(data) == one[0]
    model = flops[f"{arch}:{kind}:1x2"]
    assert len(model) == 2
    assert sum(model) == one[0] + (2 - 1) * _replicated(arch, kind)


def test_decode_collectives_by_hand(results):
    """h2o-danube3-4b SMOKE (2 layers, d 64, 4 heads of 16, 2 KV heads,
    d_ff 128, vocab 256, bfloat16) decoding 8 rows on (2, 4): 4 rows a
    rank; KH % 4 != 0, so the caches' sequence runs over the model axis.
    All-gathers (result bytes): each layer K and V (4 x 32 bf16 each)
    and q (4 x 64 bf16); the logits (4 x 256 bf16).  All-reduces (twice
    the result): the embedding's rows (4 x 64 bf16); each layer the
    flash-decoding max (4 x 4 f32) and sums (4 x 4 x 17 f32), wo's and
    the MLP's partial sums (4 x 64 bf16 each)."""
    bf, f32, rows, L = 2, 4, 4, 2
    gather = L * (2 * rows * 32 * bf + rows * 64 * bf) + rows * 256 * bf
    reduce = 2 * (rows * 64 * bf + L * (rows * 4 * f32 + rows * 4 * 17 * f32
                                        + 2 * rows * 64 * bf))
    coll = _ok(results["collectives"])["coll"]
    assert coll == {"all-gather": gather, "all-reduce": reduce,
                    "total": gather + reduce}


def test_calibrate_extrapolation_equals_full_count(results):
    """h2o-danube3-4b's 24 identical layers: the extrapolation from
    depths 1 and 2 is the full-depth count, exactly."""
    rec = _ok(results["calibrate"])
    cal = rec["calibrated"]
    assert cal["depths"] == [1, 2] and cal["full_depth"] == 24
    assert cal["flops"] == rec["flops_per_dev"]
    assert cal["bytes"] == rec["bytes_per_dev"]
    assert cal["coll"] == rec["coll_bytes"]["total"]
    assert cal["rel_err"] == {"flops": 0.0, "bytes": 0.0, "coll": 0.0}


def test_dryrun_main_counts_long_context_cell(results):
    """One record, on the 16 x 16 mesh, with nonzero counts, the
    sequence over ("data", "model") (8 KV heads over 16), and the keys
    of the JAX package's record."""
    (rec,) = _ok(results["main"])["records"]
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["rank"] == 3
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["coll_bytes"]["total"] > 0 and rec["mem_per_device"] > 0
    for key in ("lower_s", "compile_s", "microbatch", "mem_estimate",
                "fits", "mem_breakdown", "sharding"):
        assert key in rec
    assert rec["fits"]


def test_counter_peak_and_bytes_by_hand():
    """A three-op program on a 1,000-float ``meta`` tensor a (4,000 B):
    exp (a new 4,000 B), cat of a and it (8,000 B), then the sum after
    exp's result is released (4 B).  Peak: 4,000 + 4,000 + 8,000; bytes:
    each op's inputs and output; no FLOPs, no collectives."""
    def prog(a):
        b = a.exp()
        c = torch.cat([a, b])
        del b
        return c.sum()

    c = count(prog, torch.empty(1000, device="meta"))
    assert c.peak_bytes == 4000 + 4000 + 8000
    assert c.hbm_bytes == (4000 + 4000) + (8000 + 8000) + (8000 + 4)
    assert c.flops == 0 and c.coll == {"total": 0.0} and c.ops == 3


def test_counter_counts_matmul_flops():
    """(8, 16) @ (16, 32): 2 x 8 x 16 x 32 FLOPs, its operands read and
    its result written."""
    a = torch.empty(8, 16, device="meta")
    b = torch.empty(16, 32, device="meta")
    c = count(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * 8 * 16 * 32
    assert c.hbm_bytes == 4 * (8 * 16 + 16 * 32 + 8 * 32)


def test_counter_writes_by_hand():
    """A copy into a (64,) float32 slice of a (4, 64) cache writes the
    slice and reads the source; an indexed write of 2 rows of 64 reads
    its values and indices and writes 2 rows -- neither reads the
    destination."""
    def prog(cache, src, rows):
        cache[1].copy_(src)
        cache[rows] = src.expand(2, 64)

    c = count(prog, torch.empty(4, 64, device="meta"),
              torch.empty(64, device="meta"),
              torch.empty(2, dtype=torch.int64, device="meta"))
    assert c.hbm_bytes == (256 + 256) + (512 + 16 + 512)
