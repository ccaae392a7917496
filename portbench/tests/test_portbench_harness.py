"""The harness: the import guard, the spec against the contract, metric
selection, discovery of a configuration, mix and metric added as files,
and the result line."""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

import portbench_tiny as T
from portbench_tiny import one_thread  # noqa: F401
from portbench import harness

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.fleet.runtime", "reprox", "portbench"],
     []),
    (["repro", "repro.kernels.ops", "jax", "jax.numpy", "jaxlib", "flax.nn",
      "numpy"], ["flax.nn", "jax", "jax.numpy", "jaxlib", "repro",
                 "repro.kernels.ops"]),
])
def test_forbidden_modules_compare_top_level_names_whole(names, bad):
    assert harness.forbidden_modules(names) == bad


def test_spec_keeps_the_contract():
    spec = harness.load_spec(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        cfg = harness.load_json(ROOT, c["file"])
        assert (ROOT / "portbench" / "drivers" /
                f"{cfg['driver']}.py").exists()
        names.add(c["name"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (ROOT / harness.traffic_file(w["traffic"])).exists()
        assert len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"])
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
    for cell in cells:
        got = {m["name"] for m in harness.cell_metrics(spec, cell, False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(spec, cell, True)


def test_cell_metrics_selects_by_workloads():
    spec = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
            "per_layer": [{"name": "p", "moves": "a", "workloads": ["y"]},
                          {"name": "q", "moves": "b"},
                          {"name": "r", "moves": "a"}]}
    assert [m["name"] for m in harness.cell_metrics(spec, "x", False)] == \
        ["a", "b"]
    assert [m["name"] for m in harness.cell_metrics(spec, "y", False)] == \
        ["a"]
    assert [m["name"] for m in harness.cell_metrics(spec, "y", True)] == \
        ["p", "r"]
    assert [m["name"] for m in harness.cell_metrics(spec, "x", True)] == \
        ["q", "r"]


NEW_METRIC = '''
def read(run):
    return float(sum(s[0] for s in run.steps))
'''
SILENT_METRIC = '''
def read(run):
    return None
'''


def test_new_config_mix_and_metric_are_found_as_files(tmp_path):
    root = T.make_root(tmp_path, per_layer=[
        {"name": "tiny.rows", "unit": "tiles", "better": "higher",
         "source": "program_counter", "layer": "detector reuse planning",
         "moves": "frames_per_s", "workloads": ["tiny.h264"]},
        {"name": "tiny.silent", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device",
         "moves": "frames_per_s", "workloads": ["tiny.h264"]}])
    (root / "portbench" / "metrics" / "tiny.rows.py").write_text(NEW_METRIC)
    (root / "portbench" / "metrics" / "tiny.silent.py").write_text(
        SILENT_METRIC)
    out, metrics = harness.run_cell(root, "tiny.h264", 2 ** 31 + 11, 0.3,
                                    True, "cpu", time.perf_counter())
    steps = out.run.steps
    assert metrics["tiny.rows"]["value"] == sum(s[0] for s in steps)
    assert metrics["tiny.rows"]["unit"] == "tiles"
    assert "tiny.silent" not in metrics
    # no device on the CPU: the device trace's readers find nothing
    assert "device_idle" not in metrics and "gate_roofline" not in metrics
    assert {"reuse_share", "launch_padding"} <= set(metrics)
    assert out.correct and out.failed == 0
    line = json.loads(harness.result_line(out, metrics))
    assert list(line)[-1] == "checks"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["attempted"] == len(steps) * 2


def test_run_loads_no_jax_or_jax_package(tmp_path):
    """A whole run of the tiny cell in a fresh process loads no module
    whose top-level name is jax, jaxlib, flax or repro."""
    root = T.make_root(tmp_path)
    code = (
        "import sys, time; sys.path[:0] = [%r, %r, %r]\n"
        "import torch; torch.set_num_threads(1)\n"
        "import portbench_tiny\n"
        "from portbench import harness\n"
        "out, m = harness.run_cell(__import__('pathlib').Path(%r), "
        "'tiny.h264', 3, 0.2, False, 'cpu', time.perf_counter())\n"
        "assert out.correct\n"
        "print(harness.forbidden_modules(sys.modules))\n"
        % (str(ROOT / "src"), str(ROOT), str(Path(__file__).parent),
           str(root)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "crossroi_4x5.h264", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode != 0 and res.stdout == ""
