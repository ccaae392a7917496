"""The benchmark's data-driven parts: the spec, the cells, the metric
readers, the import guard and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

* a configuration: the ``file`` its entry names (``portbench/configs/
  <name>.json``); its ``driver`` key names ``portbench/drivers/
  <driver>.py``, whose ``run`` sets the program up, measures and checks;
* a traffic mix: ``portbench/traffic/<traffic>.json``, read by the
  driver's generator;
* a metric, end-to-end or per-layer: ``portbench/metrics/<name>.py``,
  whose ``read(run)`` returns its value from the run's records, or None
  when it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

# top-level module names no benchmark run may load: JAX and the JAX
# package the port was made from, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> List[str]:
    """The names whose top-level part (before the first dot) is
    forbidden: ``repro_torch`` passes, ``repro`` and ``jax.numpy`` do
    not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str):
    """(the cell's entry, its configuration's entry)."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return cell, configs[cell["config"]]


def load_json(root: Path, rel: str) -> dict:
    return json.loads((root / rel).read_text())


def traffic_file(traffic: str) -> str:
    return f"portbench/traffic/{traffic}.json"


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_driver(root: Path, driver: str):
    return _load_module(root / "portbench" / "drivers" / f"{driver}.py",
                        f"portbench_driver_{driver}")


def load_reader(root: Path, metric: str):
    return _load_module(root / "portbench" / "metrics" / f"{metric}.py",
                        "portbench_metric_" + metric.replace(".", "_"))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics (each listed for the cell, or,
    without a ``workloads`` key, moving an end-to-end metric the cell
    reports)."""
    e2e = [m for m in spec["end_to_end"] if applies(m, cell)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def read_metrics(root: Path, metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader found
    something; a reader that returns None is left out."""
    out = {}
    for m in metrics:
        value = load_reader(root, m["name"]).read(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"{m['name']} read {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@dataclass
class Check:
    """One number compared: its reading and its limit (higher fails)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver's run hands back."""
    run: object                     # the records the metric readers read
    attempted: int
    failed: int
    checks: List[Check]
    device: dict
    breakdown: Optional[dict] = None
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, **driver_args):
    """Run ``workload`` of ``root``'s ``BENCHMARK.json`` on ``device``:
    (the driver's ``Outcome``, the metrics its readers found)."""
    spec = load_spec(root)
    cell, cfg_entry = find_cell(spec, workload)
    config = load_json(root, cfg_entry["file"])
    traffic = load_json(root, traffic_file(cell["traffic"]))
    driver = load_driver(root, config["driver"])
    outcome = driver.run(cell, config, traffic, seed, seconds, trace, device,
                         t_start, root, **driver_args)
    metrics = read_metrics(root, cell_metrics(spec, workload, trace),
                           outcome.run)
    return outcome, metrics


def result_line(outcome: Outcome, metrics: Dict[str, dict]) -> str:
    """The run's last line of standard output; the compared numbers come
    last, under ``checks``."""
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics,
           "device": outcome.device}
    if outcome.breakdown is not None:
        out["breakdown"] = outcome.breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return json.dumps(out)


def check_lines(outcome: Outcome) -> List[str]:
    """The compared numbers beside their limits, for standard error."""
    return [f"check {c.name} {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}" for c in outcome.checks]
