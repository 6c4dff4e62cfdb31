"""Declarative fleet scenarios: JSON suites that run as benchmarks AND
as tests.

A scenario file (``benchmarks/scenarios/*.json``, vLLM-nightly style)
declares one deterministic mixed serve+train fleet run — the
``FleetConfig``, training ``JobSpec``s, serve ``ServeJobSpec``s, a
horizon, an optional ``baseline`` arm (section overrides re-run on the
*same seed*, e.g. autoscaling vs fixed replicas on one request trace),
and ``expect`` assertions over the flattened metrics. The port reads
the repository's scenario files in place: its tests hold every file's
metrics and verdicts to the reference's, and ``chip_smoke.py`` runs them
all on the card's machine.

``validate_scenario`` is deliberately strict: unknown keys anywhere are
errors (a typo'd knob must not silently revert to a default), and the
seed must be a literal integer — wall-clock or "auto" seeds would break
the determinism contract every consumer of these files relies on.

Metric namespace (the ``expect`` targets): ``fleet/<key>`` from
``FleetSimulator.fleet_summary``, ``train/<job>/<key>`` from the job's
ledger summary plus ``steps_done``/``state_done``/``grammar_ok``, and
``serve/<job>/<key>`` from the serve ledger summary, ``slo_summary``,
``grammar_ok``, and the ``PowerModel.serve_summary`` joules-per-token
outputs. ``ref: "baseline:<metric>"`` compares against the baseline
arm's value of ``<metric>``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

from repro_torch.core import hwspec
from repro_torch.fleet.bridge import grammar_ok
from repro_torch.fleet.jobs import SCALE_POLICIES, JobSpec
from repro_torch.fleet.perf import ServiceTimeModel
from repro_torch.fleet.power import PowerModel
from repro_torch.fleet.serve_jobs import (SERVE_SCALE_POLICIES,
                                          SERVE_SHED_POLICIES, ArrivalProcess,
                                          ServeJobSpec, ServeSLO)
from repro_torch.fleet.sim import FleetConfig, FleetSimulator

SCENARIO_SCHEMA = "repro.fleet.scenario/v1"

_TOP_KEYS = {"schema", "name", "description", "fleet", "horizon_s",
             "train_jobs", "serve_jobs", "baseline", "expect"}
_BASELINE_KEYS = {"fleet", "horizon_s", "train_jobs", "serve_jobs"}
_FLEET_KEYS = {"tpu", "total_cubes", "host_mtbf_hours", "repair_hours",
               "detect_s", "restore_s", "reconfig_s", "ckpt_write_s",
               "contiguous", "seed"}
_TRAIN_KEYS = {"name", "chips", "total_steps", "step_time_s",
               "checkpoint_every_steps", "arrival_s", "failure_steps",
               "scale_policy", "min_cubes"}
_SERVE_KEYS = {"name", "chips", "replicas", "min_replicas",
               "max_replicas", "max_batch", "scale_policy",
               "shed_policy", "control_interval_s", "spinup_s",
               "arrival_s", "scale_up_queue_per_slot",
               "scale_down_util", "slo", "arrivals", "service"}
_SLO_KEYS = {f.name for f in dataclasses.fields(ServeSLO)}
_ARRIVAL_KEYS = {f.name for f in dataclasses.fields(ArrivalProcess)}
_SERVICE_KEYS = {f.name for f in dataclasses.fields(ServiceTimeModel)} \
    - {"source"}
_EXPECT_KEYS = {"metric", "op", "value", "ref"}
_OPS = (">", ">=", "<", "<=", "==", "between")


def _check_keys(d: Any, allowed: set, where: str,
                problems: List[str]) -> bool:
    if not isinstance(d, dict):
        problems.append(f"{where}: expected an object, got "
                        f"{type(d).__name__}")
        return False
    unknown = sorted(set(d) - allowed)
    if unknown:
        problems.append(f"{where}: unknown keys {unknown}")
    return True


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def validate_scenario(doc: Any) -> List[str]:
    """Structural validation; returns a list of problems (empty = ok).
    Semantic validation (positive rates, replica bounds, ...) happens in
    the dataclass constructors when the scenario actually runs."""
    problems: List[str] = []
    if not _check_keys(doc, _TOP_KEYS, "top level", problems):
        return problems
    if doc.get("schema") != SCENARIO_SCHEMA:
        problems.append(f"schema must be {SCENARIO_SCHEMA!r}, got "
                        f"{doc.get('schema')!r}")
    name = doc.get("name")
    if not isinstance(name, str) or \
            not re.fullmatch(r"[a-z0-9_]+", name or ""):
        problems.append("name must be a lowercase [a-z0-9_]+ string")
    if not isinstance(doc.get("description"), str) or \
            not doc.get("description"):
        problems.append("description is required (scenarios must be "
                        "self-documenting)")
    if not isinstance(doc.get("horizon_s"), (int, float)) or \
            isinstance(doc.get("horizon_s"), bool) or \
            not doc.get("horizon_s", 0) > 0:
        problems.append("horizon_s must be a positive number")
    fleet = doc.get("fleet")
    if fleet is None:
        problems.append("fleet section is required")
    elif _check_keys(fleet, _FLEET_KEYS, "fleet", problems):
        seed = fleet.get("seed", 0)
        if not _is_int(seed):
            # the determinism contract: no wall-clock / "auto" seeds
            problems.append(
                f"fleet.seed must be a literal integer, got {seed!r} "
                "(non-reproducible seeds are rejected)")
    names: List[str] = []
    train = doc.get("train_jobs", [])
    serve = doc.get("serve_jobs", [])
    for label, entries, keys in (("train_jobs", train, _TRAIN_KEYS),
                                 ("serve_jobs", serve, _SERVE_KEYS)):
        if not isinstance(entries, list):
            problems.append(f"{label} must be a list")
            continue
        for i, j in enumerate(entries):
            where = f"{label}[{i}]"
            if not _check_keys(j, keys, where, problems):
                continue
            if not isinstance(j.get("name"), str) or not j.get("name"):
                problems.append(f"{where}: name is required")
            else:
                names.append(j["name"])
            if label == "train_jobs" and "scale_policy" in j and \
                    j["scale_policy"] not in SCALE_POLICIES:
                problems.append(f"{where}: scale_policy must be one of "
                                f"{SCALE_POLICIES}")
            if label == "serve_jobs":
                if "scale_policy" in j and \
                        j["scale_policy"] not in SERVE_SCALE_POLICIES:
                    problems.append(
                        f"{where}: scale_policy must be one of "
                        f"{SERVE_SCALE_POLICIES}")
                if "shed_policy" in j and \
                        j["shed_policy"] not in SERVE_SHED_POLICIES:
                    problems.append(
                        f"{where}: shed_policy must be one of "
                        f"{SERVE_SHED_POLICIES}")
                for sub, allowed in (("slo", _SLO_KEYS),
                                     ("arrivals", _ARRIVAL_KEYS),
                                     ("service", _SERVICE_KEYS)):
                    if sub in j:
                        _check_keys(j[sub], allowed, f"{where}.{sub}",
                                    problems)
    if len(set(names)) != len(names):
        problems.append("duplicate job names across train_jobs/serve_jobs")
    if not train and not serve:
        problems.append("at least one train or serve job is required")
    baseline = doc.get("baseline")
    if baseline is not None:
        if _check_keys(baseline, _BASELINE_KEYS, "baseline", problems) \
                and not baseline:
            problems.append("baseline must override at least one section")
    for i, c in enumerate(doc.get("expect", [])):
        where = f"expect[{i}]"
        if not _check_keys(c, _EXPECT_KEYS, where, problems):
            continue
        if not isinstance(c.get("metric"), str):
            problems.append(f"{where}: metric is required")
        if c.get("op") not in _OPS:
            problems.append(f"{where}: op must be one of {_OPS}")
        has_value, has_ref = "value" in c, "ref" in c
        if has_value == has_ref:
            problems.append(f"{where}: exactly one of value/ref required")
        if has_ref:
            if not (isinstance(c["ref"], str) and
                    c["ref"].startswith("baseline:")):
                problems.append(f"{where}: ref must be 'baseline:<metric>'")
            elif baseline is None:
                problems.append(f"{where}: ref used without a baseline "
                                "section")
        if c.get("op") == "between" and has_value and not (
                isinstance(c["value"], list) and len(c["value"]) == 2):
            problems.append(f"{where}: 'between' takes value [lo, hi]")
    return problems


def load_scenario(path) -> Dict[str, Any]:
    """Read + validate one scenario file; raises on any problem."""
    doc = json.loads(Path(path).read_text())
    problems = validate_scenario(doc)
    if problems:
        raise ValueError(f"{path}: " + "; ".join(problems))
    return doc


def load_scenario_paths(directory) -> List[Path]:
    return sorted(Path(directory).glob("*.json"))


# ---------------------------------------------------------------- running


def _train_spec(d: Dict[str, Any]) -> JobSpec:
    kw = dict(d)
    if "failure_steps" in kw:
        kw["failure_steps"] = tuple(
            (int(s), int(c)) for s, c in kw["failure_steps"])
    return JobSpec(**kw)


def _serve_spec(d: Dict[str, Any],
                service: Optional[ServiceTimeModel]) -> ServeJobSpec:
    kw = dict(d)
    if "slo" in kw:
        kw["slo"] = ServeSLO(**kw["slo"])
    if "arrivals" in kw:
        kw["arrivals"] = ArrivalProcess(**kw["arrivals"])
    if service is not None:
        # a measured model (e.g. trace-calibrated by the tier-1 gate)
        # overrides whatever coefficients the file declares
        kw["service"] = service
    elif "service" in kw:
        kw["service"] = ServiceTimeModel(**kw["service"])
    return ServeJobSpec(**kw)


def _run_arm(doc: Dict[str, Any],
             service: Optional[ServiceTimeModel]) -> Dict[str, float]:
    cfg = FleetConfig(**doc.get("fleet", {}))
    sim = FleetSimulator(
        cfg, [_train_spec(d) for d in doc.get("train_jobs", [])],
        serve_jobs=[_serve_spec(d, service)
                    for d in doc.get("serve_jobs", [])])
    sim.run(float(doc["horizon_s"]))
    out: Dict[str, float] = {}
    for k, v in sim.fleet_summary().items():
        out[f"fleet/{k}"] = float(v)
    for name, job in sim.jobs.items():
        for k, v in job.ledger.summary().items():
            out[f"train/{name}/{k}"] = float(v)
        out[f"train/{name}/steps_done"] = float(job.base_step)
        out[f"train/{name}/state_done"] = float(job.state == "done")
        out[f"train/{name}/grammar_ok"] = float(grammar_ok(job.ledger))
    try:
        power: Optional[PowerModel] = PowerModel(hwspec.get(cfg.tpu))
        power.chip_tdp_w  # generations without a TDP anchor raise
    except ValueError:
        power = None
    for name, rt in sim.serve.items():
        for k, v in rt.ledger.summary().items():
            out[f"serve/{name}/{k}"] = float(v)
        for k, v in rt.slo_summary().items():
            out[f"serve/{name}/{k}"] = float(v)
        out[f"serve/{name}/grammar_ok"] = float(grammar_ok(rt.ledger))
        if power is not None:
            chips = rt.spec.chips * max(rt.peak_replicas, 1)
            ss = power.serve_summary(rt.ledger, chips,
                                     good_tokens=rt.good_tokens,
                                     total_tokens=rt.total_tokens)
            for k in ("energy_kwh", "joules_per_token",
                      "joules_per_good_token"):
                out[f"serve/{name}/{k}"] = float(ss[k])
    return out


def _eval(op: str, value: float, target: Any) -> bool:
    if op == ">":
        return value > target
    if op == ">=":
        return value >= target
    if op == "<":
        return value < target
    if op == "<=":
        return value <= target
    if op == "==":
        return value == target
    assert op == "between"
    lo, hi = target
    return lo <= value <= hi


def run_scenario(doc: Dict[str, Any], *,
                 service: Optional[ServiceTimeModel] = None
                 ) -> Dict[str, Any]:
    """Run one validated scenario (and its baseline arm, if declared)
    and evaluate the ``expect`` assertions. ``service`` optionally
    substitutes a measured ``ServiceTimeModel`` into every serve job of
    both arms. Deterministic: same doc + same model => identical
    result."""
    metrics = _run_arm(doc, service)
    baseline_metrics: Dict[str, float] = {}
    if doc.get("baseline"):
        arm = {k: v for k, v in doc.items()
               if k not in ("baseline", "expect")}
        arm.update(doc["baseline"])
        baseline_metrics = _run_arm(arm, service)
    checks: List[Dict[str, Any]] = []
    for c in doc.get("expect", []):
        metric, op = c["metric"], c["op"]
        value = metrics.get(metric)
        if "ref" in c:
            target: Any = baseline_metrics.get(
                c["ref"][len("baseline:"):])
        else:
            target = c["value"]
        ok = (value is not None and target is not None and
              _eval(op, value, target))
        checks.append({"metric": metric, "op": op, "value": value,
                       "target": target, "ok": ok})
    return {
        "name": doc["name"],
        "ok": all(c["ok"] for c in checks),
        "checks": checks,
        "metrics": metrics,
        "baseline_metrics": baseline_metrics,
    }
