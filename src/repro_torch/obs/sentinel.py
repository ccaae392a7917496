"""Perf regression sentinel over ``BENCH_history.jsonl`` -- the port's copy
of ``repro.obs.sentinel``.

A benchmark history holds one record per run -- git SHA, headline walls,
and (since schema v1) the SLO frontier metrics.  This module turns that
stream into a CI gate:

* **interleaved min-of-reps** — a SHA usually has several records (the
  smokes re-run per mode); the per-SHA value of each wall is the MIN
  across its records, the same noise treatment the benches apply to
  their own rep loops.  Absolute-only metrics (two-sided noise) use
  the per-SHA MEDIAN instead, so one contended-run outlier cannot
  latch into the baseline.
* **median-of-window baseline** — the head SHA (latest in file order)
  compares against the MEDIAN of the previous ``window`` SHAs' mins, so
  one noisy historical run cannot poison the baseline.
* **relative-threshold + absolute-floor rules** — a wall regresses only
  if it grew by both ``rel_threshold`` (default 30%, CI-runner noise is
  real) AND ``abs_floor`` seconds.  Fraction/rate metrics (e.g. the obs
  overhead_frac, which legitimately wobbles in a ±2% band around zero)
  use an ABSOLUTE-ONLY rule: relative deltas off a near-zero baseline
  are meaningless, so only an absolute move above the floor counts.

Records that predate the versioned schema (no ``"schema"`` key) are
skipped with a warning, never crashed on.  ``self_test`` fabricates a
temp history with an injected 2x wall slowdown and asserts the sentinel
flags it while passing the clean copy — the gate proves itself before
gating anything.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: minimum record schema version this sentinel understands
SCHEMA_VERSION = 1

#: metric-name suffixes priced with the absolute-only rule (near-zero
#: baselines make relative thresholds meaningless)
_ABSOLUTE_ONLY_SUFFIXES = ("_frac", "_fraction", "_rate", "_reduction",
                           "_floor")

#: named absolute rules, matched on the metric's LEAF name (after the
#: last "."): chaos-recovery bounds the suffix table cannot express.
#: ``mttr_steps`` is step-valued with a small-integer healthy baseline
#: (relative thresholds off "1 step" are meaningless; one extra step of
#: recovery IS the regression).  ``uncovered_frac_p99`` would match the
#: suffix table anyway, but its floor is tighter: any sustained coverage
#: hole above 5% is an incident, regardless of the baseline.
_ABSOLUTE_METRIC_RULES: Dict[str, "MetricRule"] = {}


@dataclass(frozen=True)
class MetricRule:
    """How one metric's head-vs-baseline delta is judged."""
    rel_threshold: float      # relative growth that counts (walls)
    abs_floor: float          # AND the absolute move must exceed this
    absolute_only: bool       # ignore rel_threshold (fractions/rates)
    lower_is_better: bool = True

    def describe(self) -> str:
        if self.absolute_only:
            return f"|delta| > {self.abs_floor:g} (absolute)"
        return (f"delta > {self.rel_threshold:.0%} rel "
                f"and > {self.abs_floor:g} abs")


def rule_for(metric: str) -> MetricRule:
    """Default rule table: named absolute rules first (matched on the
    leaf name, so ``chaos.mttr_steps`` finds ``mttr_steps``); then
    seconds-valued walls get relative + floor; fraction/rate metrics get
    absolute-only with a 0.05 floor — wide enough that the known ±2%
    obs-overhead noise band (worst in-band swing 0.04) can never trip
    it, tight enough that a real structural regression (overhead jumping
    to 10%) does."""
    named = _ABSOLUTE_METRIC_RULES.get(metric.rsplit(".", 1)[-1])
    if named is not None:
        return named
    if metric.endswith(_ABSOLUTE_ONLY_SUFFIXES):
        return MetricRule(rel_threshold=0.0, abs_floor=0.05,
                          absolute_only=True)
    return MetricRule(rel_threshold=0.30, abs_floor=0.010,
                      absolute_only=False)


_ABSOLUTE_METRIC_RULES.update({
    # recovery must stay within ~2 steps of the baseline; a 2x MTTR on
    # a 2-step baseline moves by 2.0 > 1.5 and is flagged
    "mttr_steps": MetricRule(rel_threshold=0.0, abs_floor=1.5,
                             absolute_only=True),
    "detect_latency_steps": MetricRule(rel_threshold=0.0, abs_floor=2.5,
                                       absolute_only=True),
    "freeze_detect_latency_steps": MetricRule(rel_threshold=0.0,
                                              abs_floor=2.5,
                                              absolute_only=True),
    "uncovered_frac_p99": MetricRule(rel_threshold=0.0, abs_floor=0.05,
                                     absolute_only=True),
    # higher-is-better recovery metrics: a DROP past the floor is the
    # regression (the suffix/wall tables would price these backwards)
    "coverage_restored_ratio": MetricRule(rel_threshold=0.0,
                                          abs_floor=0.05,
                                          absolute_only=True,
                                          lower_is_better=False),
    "degraded_accuracy_floor": MetricRule(rel_threshold=0.0,
                                          abs_floor=0.05,
                                          absolute_only=True,
                                          lower_is_better=False),
    # persistent-canvas contract: an all-static step writes ZERO canvas
    # bytes — any sustained nonzero value means a regression re-enabled
    # full-canvas (or any) writes on static steps, so the floor is half
    # a byte; and the mean per-step canvas traffic may not quietly grow
    # past a sustained 64 KiB/step (static tiles being rewritten) — a
    # byte count with two-sided run-to-run jitter, so absolute-only
    # with MEDIAN per-SHA reduction
    "static_canvas_bytes": MetricRule(rel_threshold=0.0, abs_floor=0.5,
                                      absolute_only=True),
    "canvas_bytes_per_step": MetricRule(rel_threshold=0.0,
                                        abs_floor=65536.0,
                                        absolute_only=True),
})


@dataclass
class Finding:
    metric: str
    baseline: float
    head: float
    classification: str       # regression | improvement | ok
    rule: MetricRule

    @property
    def delta(self) -> float:
        return self.head - self.baseline

    @property
    def rel(self) -> float:
        denom = abs(self.baseline)
        return self.delta / denom if denom > 1e-12 else float("inf")


@dataclass
class SentinelReport:
    head_sha: str = ""
    baseline_shas: List[str] = field(default_factory=list)
    findings: List[Finding] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)   # warnings
    status: str = "ok"        # ok | regression | no_baseline | no_data

    @property
    def has_regression(self) -> bool:
        return self.status == "regression"

    @property
    def regressions(self) -> List[Finding]:
        return [f for f in self.findings
                if f.classification == "regression"]

    def render(self) -> str:
        lines = []
        for w in self.skipped:
            lines.append(f"warning: {w}")
        if self.status == "no_data":
            lines.append("sentinel: no schema-valid history records — "
                         "nothing to gate")
            return "\n".join(lines)
        if self.status == "no_baseline":
            lines.append(f"sentinel: head {self.head_sha} has no prior "
                         f"SHA to compare against — pass (no baseline)")
            return "\n".join(lines)
        lines.append(f"sentinel: head {self.head_sha} vs median of "
                     f"{len(self.baseline_shas)} prior SHA(s) "
                     f"{self.baseline_shas}")
        rows = [("metric", "baseline", "head", "delta", "rel", "verdict")]
        order = {"regression": 0, "improvement": 1, "ok": 2}
        for f in sorted(self.findings,
                        key=lambda f: (order[f.classification], f.metric)):
            rel = ("-" if f.rule.absolute_only or not np.isfinite(f.rel)
                   else f"{f.rel:+.1%}")
            rows.append((f.metric, f"{f.baseline:.4g}", f"{f.head:.4g}",
                         f"{f.delta:+.4g}", rel, f.classification))
        widths = [max(len(r[i]) for r in rows) for i in range(6)]
        for r in rows:
            lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        n_reg = len(self.regressions)
        lines.append(f"sentinel verdict: "
                     f"{'REGRESSION' if n_reg else 'clean'}"
                     + (f" ({n_reg} metric(s))" if n_reg else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# history loading / per-SHA reduction
# ---------------------------------------------------------------------------

def load_history(path: str) -> Tuple[List[Dict], List[str]]:
    """Parse BENCH_history.jsonl into (schema-valid records, warnings).
    Pre-schema records and unparseable lines are skipped with a warning,
    never a crash — history files outlive schema changes."""
    records: List[Dict] = []
    warnings: List[str] = []
    if not os.path.exists(path):
        return records, [f"{path}: no history file"]
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                warnings.append(f"{path}:{i}: unparseable line skipped")
                continue
            if not isinstance(rec, dict) or "schema" not in rec:
                warnings.append(
                    f"{path}:{i}: pre-schema record "
                    f"(sha {rec.get('git_sha', '?')}) skipped")
                continue
            if not isinstance(rec.get("schema"), int) \
                    or rec["schema"] < 1 \
                    or not isinstance(rec.get("git_sha"), str) \
                    or not isinstance(rec.get("headline_walls"), dict):
                warnings.append(f"{path}:{i}: malformed record skipped")
                continue
            records.append(rec)
    return records, warnings


def _record_metrics(rec: Dict) -> Dict[str, float]:
    """Flat {metric: value} view of one record: headline walls plus the
    frontier block (already flat, prefixed for namespacing)."""
    out: Dict[str, float] = {}
    for k, v in rec.get("headline_walls", {}).items():
        if isinstance(v, (int, float)):
            out[k] = float(v)
    for k, v in rec.get("frontier", {}).items():
        if isinstance(v, (int, float)):
            out[f"frontier.{k}"] = float(v)
    for k, v in rec.get("chaos", {}).items():
        if isinstance(v, (int, float)):
            out[f"chaos.{k}"] = float(v)
    for k, v in rec.get("canvas", {}).items():
        if isinstance(v, (int, float)):
            out[f"canvas.{k}"] = float(v)
    return out


def reduce_by_sha(records: Sequence[Dict]
                  ) -> List[Tuple[str, Dict[str, float]]]:
    """File-ordered (sha, per-metric reduction over that SHA's records).

    Walls reduce by MIN — rep noise is one-sided slow, so the min is
    the achievable cost, the same treatment the benches apply to their
    own rep loops.  Absolute-only metrics (fractions, counts, signed
    overheads) reduce by MEDIAN instead: their noise is two-sided, and
    a min would latch the worst outlier (e.g. an ``overhead_frac`` of
    -0.2 from a CPU-contended run poisoning every later baseline).
    """
    order: List[str] = []
    reps: Dict[str, Dict[str, List[float]]] = {}
    for rec in records:
        sha = rec["git_sha"]
        if sha not in reps:
            order.append(sha)
            reps[sha] = {}
        for k, v in _record_metrics(rec).items():
            reps[sha].setdefault(k, []).append(v)
    out: List[Tuple[str, Dict[str, float]]] = []
    for sha in order:
        reduced = {}
        for k, vals in reps[sha].items():
            if rule_for(k).absolute_only:
                reduced[k] = float(np.median(vals))
            else:
                reduced[k] = min(vals)
        out.append((sha, reduced))
    return out


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def analyze(records: Sequence[Dict], window: int = 5,
            warnings: Sequence[str] = ()) -> SentinelReport:
    """Head (latest SHA) vs median-of-window baseline, rule per metric."""
    rep = SentinelReport(skipped=list(warnings))
    shas = reduce_by_sha(records)
    if not shas:
        rep.status = "no_data"
        return rep
    head_sha, head = shas[-1]
    rep.head_sha = head_sha
    base_window = shas[max(0, len(shas) - 1 - window):-1]
    if not base_window:
        rep.status = "no_baseline"
        return rep
    rep.baseline_shas = [s for s, _ in base_window]
    for metric in sorted(head):
        past = [m[metric] for _, m in base_window if metric in m]
        if not past:
            continue                      # metric is new at head: no gate
        baseline = float(np.median(past))
        rule = rule_for(metric)
        f = Finding(metric=metric, baseline=baseline, head=head[metric],
                    classification="ok", rule=rule)
        worse = f.delta if rule.lower_is_better else -f.delta
        if rule.absolute_only:
            if worse > rule.abs_floor:
                f.classification = "regression"
            elif worse < -rule.abs_floor:
                f.classification = "improvement"
        else:
            if worse > rule.abs_floor and \
                    worse > rule.rel_threshold * abs(baseline):
                f.classification = "regression"
            elif worse < -rule.abs_floor and \
                    worse < -rule.rel_threshold * abs(baseline):
                f.classification = "improvement"
        rep.findings.append(f)
    rep.status = "regression" if rep.regressions else "ok"
    return rep


def analyze_path(path: str, window: int = 5) -> SentinelReport:
    records, warnings = load_history(path)
    return analyze(records, window=window, warnings=warnings)


# ---------------------------------------------------------------------------
# self-test: the gate proves itself before gating anything
# ---------------------------------------------------------------------------

def _synthetic_head() -> Dict[str, float]:
    return {"stack.stack_kernel_wall_s": 0.065,
            "reuse.reuse_step_wall_s": 0.13,
            "obs.wall_enabled_s": 0.033,
            "obs.overhead_frac": 0.017}


def _mk_record(sha: str, walls: Dict[str, float]) -> Dict:
    return {"schema": SCHEMA_VERSION, "ts": "1970-01-01T00:00:00+0000",
            "git_sha": sha, "mode": "selftest", "panels": [],
            "headline_walls": dict(walls)}


def self_test(history_path: Optional[str] = None, window: int = 5
              ) -> Dict[str, bool]:
    """Build temp histories from the newest real record (synthetic
    fixture when the real history has no schema-valid records yet) and
    assert the three contractual behaviors:

    * a clean head (identical walls) passes,
    * an injected 2x slowdown on every wall is flagged as a regression
      with the metric named,
    * a head whose ``obs.overhead_frac`` moved by the known ±2%
      measurement band (0.04 absolute worst case) is NOT flagged,
    * an injected 2x MTTR (``chaos.mttr_steps`` 2 -> 4 while every wall
      holds) is flagged BY NAME — the chaos recovery bound proves
      itself before gating,
    * an injected static-step canvas write (``canvas.static_canvas_bytes``
      0 -> one full changed-step's bytes, i.e. a regression re-enabling
      canvas writes on all-static steps, while every wall holds) is
      flagged BY NAME — the zero-copy contract proves itself before
      gating.
    """
    walls: Dict[str, float] = {}
    if history_path:
        records, _ = load_history(history_path)
        shas = reduce_by_sha(records)
        if shas:
            walls = {k: v for k, v in shas[-1][1].items()
                     if not rule_for(k).absolute_only}
            walls["obs.overhead_frac"] = \
                shas[-1][1].get("obs.overhead_frac", 0.017)
    if not walls:
        walls = _synthetic_head()

    base = [_mk_record(f"base{i:04d}", walls) for i in range(3)]
    clean = base + [_mk_record("head-clean", walls)]
    slow = base + [_mk_record("head-slow", {
        k: (v * 2.0 if not rule_for(k).absolute_only else v)
        for k, v in walls.items()})]
    noisy = base + [_mk_record("head-noisy", {
        k: (v + 0.04 if k == "obs.overhead_frac" else v)
        for k, v in walls.items()})]
    chaos_walls = dict(walls, **{"chaos.mttr_steps": 2.0,
                                 "chaos.uncovered_frac_p99": 0.0})
    chaos_base = [_mk_record(f"cbase{i:04d}", chaos_walls)
                  for i in range(3)]
    mttr = chaos_base + [_mk_record("head-mttr", dict(
        chaos_walls, **{"chaos.mttr_steps": 4.0}))]
    canvas_walls = dict(walls, **{"canvas.canvas_bytes_per_step": 1.05e5,
                                  "canvas.static_canvas_bytes": 0.0})
    canvas_base = [_mk_record(f"vbase{i:04d}", canvas_walls)
                   for i in range(3)]
    canvas = canvas_base + [_mk_record("head-canvas", dict(
        canvas_walls, **{"canvas.static_canvas_bytes": 1.05e5}))]

    def run_case(recs: List[Dict]) -> SentinelReport:
        with tempfile.NamedTemporaryFile("w", suffix=".jsonl",
                                         delete=False) as f:
            tmp = f.name
            for r in recs:
                f.write(json.dumps(r) + "\n")
        try:
            return analyze_path(tmp, window=window)
        finally:
            os.unlink(tmp)

    rep_clean = run_case(clean)
    rep_slow = run_case(slow)
    rep_noisy = run_case(noisy)
    rep_mttr = run_case(mttr)
    rep_canvas = run_case(canvas)

    assert not rep_clean.has_regression, \
        f"sentinel self-test: clean history flagged\n{rep_clean.render()}"
    assert rep_slow.has_regression, \
        f"sentinel self-test: 2x slowdown NOT flagged\n{rep_slow.render()}"
    assert all("wall" in f.metric or f.metric.endswith("_s")
               for f in rep_slow.regressions) and rep_slow.regressions, \
        "sentinel self-test: regression must name the slowed metric"
    assert not rep_noisy.has_regression, \
        f"sentinel self-test: ±2% obs-overhead noise band flagged\n" \
        f"{rep_noisy.render()}"
    mttr_flagged = [f.metric for f in rep_mttr.regressions]
    assert mttr_flagged == ["chaos.mttr_steps"], \
        f"sentinel self-test: 2x MTTR must be flagged by name (and " \
        f"nothing else), got {mttr_flagged}\n{rep_mttr.render()}"
    canvas_flagged = [f.metric for f in rep_canvas.regressions]
    assert canvas_flagged == ["canvas.static_canvas_bytes"], \
        f"sentinel self-test: static-step canvas writes must be flagged " \
        f"by name (and nothing else), got {canvas_flagged}\n" \
        f"{rep_canvas.render()}"
    return {"clean_pass": not rep_clean.has_regression,
            "slowdown_flagged": rep_slow.has_regression,
            "noise_band_pass": not rep_noisy.has_regression,
            "mttr_flagged": rep_mttr.has_regression,
            "static_canvas_flagged": rep_canvas.has_regression,
            "flagged_metrics": [f.metric for f in rep_slow.regressions]}
