"""Serve traffic through the port's fleet simulator against the JAX
package's: the five scenario files under ``benchmarks/scenarios`` (read in
place) with their metrics and verdicts, the strict validator's errors,
seeded-arrival determinism, grammar stability across autoscale policies,
the service-time fit and calibration gate on synthetic traces and on a
steptrace that the port's ``ServeEngine`` records, the port's trace gate
over the port's own smoke serve, the serve power pipeline and the port's
``fleet_week`` example. Every comparison is equality.

The reference's property tests draw random examples; their twins here run
fixed lists of cases, so every run counts the same tests."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest

import repro.fleet as ref_fleet
from repro.core import hwspec as ref_hw
from repro.obs.steptrace import StepTrace as RefStepTrace
import repro_torch.fleet as fleet
from repro_torch.core import hwspec
from repro_torch.examples import fleet_week
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import trace_gate
from repro_torch.obs.steptrace import StepTrace

ROOT = Path(__file__).resolve().parent.parent
SCENARIO_DIR = ROOT / "benchmarks" / "scenarios"
SCENARIO_PATHS = fleet.load_scenario_paths(SCENARIO_DIR)

_SERVICE = dict(prefill_s_per_token=0.001, chunk_base_s=0.08,
                chunk_per_slot_s=0.02, chunk_steps=8)


def _mixed_sim(F, *, seed=7, rate=2.0, policy="auto", horizon=600.0,
               mtbf_hours=None):
    """The reference tests' small mixed serve+train pod, built from one
    package's fleet module ``F``."""
    cfg = F.FleetConfig(tpu="tpu_v4", total_cubes=4,
                        host_mtbf_hours=mtbf_hours, repair_hours=1.0,
                        seed=seed)
    train = F.JobSpec(name="t0", chips=64, total_steps=10**9,
                      step_time_s=1.0, checkpoint_every_steps=300)
    svc = F.ServeJobSpec(
        name="chat", chips=64,
        arrivals=F.ArrivalProcess(rate_rps=rate, prompt_tokens=64,
                                  output_tokens=32),
        slo=F.ServeSLO(ttft_s=2.0, tpot_s=0.05),
        service=F.ServiceTimeModel(**_SERVICE),
        replicas=1, min_replicas=1, max_replicas=2, max_batch=4,
        scale_policy=policy, spinup_s=10.0, control_interval_s=30.0)
    sim = F.FleetSimulator(cfg, [train], serve_jobs=[svc])
    sim.run(horizon)
    return sim


def _serve_dump(sim):
    """The full determinism surface of a mixed run: the serve job's request
    log, ledger and summaries, the training job's ledger, the fleet
    summary and the Chrome trace, as one canonical string."""
    rt = sim.serve["chat"]
    return json.dumps({
        "log": rt.request_log,
        "ledger": [(e.kind, e.seconds, e.steps, e.note)
                   for e in rt.ledger.events],
        "slo": rt.slo_summary(),
        "summary": rt.ledger.summary(),
        "train": [(e.kind, e.seconds, e.steps, e.note)
                  for e in sim.jobs["t0"].ledger.events],
        "fleet": sim.fleet_summary(),
        "trace": sim.trace.chrome_trace(),
    }, sort_keys=True)


# ----------------------------------------------------- scenario suites


def test_scenario_paths_match_the_reference():
    assert SCENARIO_PATHS == ref_fleet.load_scenario_paths(SCENARIO_DIR)
    assert len(SCENARIO_PATHS) == 5
    assert fleet.SCENARIO_SCHEMA == ref_fleet.SCENARIO_SCHEMA


@pytest.mark.parametrize(
    "path", SCENARIO_PATHS, ids=[p.stem for p in SCENARIO_PATHS])
def test_scenario_matches_reference_and_passes(path):
    doc = json.loads(path.read_text())
    assert fleet.validate_scenario(doc) == []
    assert fleet.load_scenario(path) == ref_fleet.load_scenario(path)
    res = fleet.run_scenario(doc)
    assert res == ref_fleet.run_scenario(doc)
    failed = [c for c in res["checks"] if not c["ok"]]
    assert res["ok"], f"failed expect checks: {failed}"
    assert res["checks"], "scenario must assert something"


def test_scenario_suite_has_required_gates():
    docs = [json.loads(p.read_text()) for p in SCENARIO_PATHS]
    assert any(
        any("ref" in c and "slo_goodput" in c["metric"]
            for c in d.get("expect", []))
        for d in docs if d.get("baseline"))
    assert any(
        d.get("serve_jobs") and any(
            j.get("arrivals", {}).get("burst_x", 1.0) > 1.0
            for j in d["serve_jobs"])
        and any(c["metric"].endswith("ttft_viol")
                for c in d.get("expect", []))
        for d in docs)


@pytest.mark.parametrize("service", [
    _SERVICE, dict(prefill_s_per_token=2e-4, chunk_base_s=0.012,
                   chunk_per_slot_s=0.0015, chunk_steps=4)])
def test_run_scenario_with_measured_service_model(service):
    """run_scenario(service=...) substitutes a measured model into both
    arms — the path the calibration gate uses."""
    doc = json.loads(
        (SCENARIO_DIR / "serve_burst_slo_violation.json").read_text())
    res = fleet.run_scenario(doc, service=fleet.ServiceTimeModel(**service))
    assert res == ref_fleet.run_scenario(
        doc, service=ref_fleet.ServiceTimeModel(**service))
    if service is _SERVICE:  # the file's own coefficients
        assert res["metrics"] == fleet.run_scenario(doc)["metrics"]


# ------------------------------------------- validator negative space


def _valid_doc():
    return json.loads(
        (SCENARIO_DIR / "serve_autoscale_vs_static.json").read_text())


UNKNOWN_KEYS = [
    lambda d: d.update(extra_knob=1),
    lambda d: d["fleet"].update(cooling="liquid"),
    lambda d: d["serve_jobs"][0].update(turbo=True),
    lambda d: d["serve_jobs"][0]["arrivals"].update(ramp=2),
    lambda d: d["serve_jobs"][0]["slo"].update(p99_s=1.0),
    lambda d: d["serve_jobs"][0]["service"].update(source="x"),
    lambda d: d["expect"][0].update(tolerance=0.1),
]


@pytest.mark.parametrize("mutate", UNKNOWN_KEYS,
                         ids=[str(i) for i in range(len(UNKNOWN_KEYS))])
def test_validate_rejects_unknown_keys_everywhere(mutate):
    doc = _valid_doc()
    mutate(doc)
    problems = fleet.validate_scenario(doc)
    assert problems == ref_fleet.validate_scenario(doc)
    assert any("unknown keys" in p for p in problems)


@pytest.mark.parametrize("bad", ["time", None, 1.5, True])
def test_validate_rejects_non_reproducible_seeds(bad):
    doc = _valid_doc()
    doc["fleet"]["seed"] = bad
    problems = fleet.validate_scenario(doc)
    assert problems == ref_fleet.validate_scenario(doc)
    assert any("non-reproducible seeds are rejected" in p for p in problems)


def _bad_op(d):
    d["expect"][0]["op"] = "~="


def _value_and_ref(d):
    d["expect"][0] = {"metric": "serve/chat/slo_goodput", "op": ">",
                      "value": 0.5, "ref": "baseline:x"}


def _no_baseline(d):
    del d["baseline"]


def _old_schema(d):
    d["schema"] = "repro.fleet.scenario/v0"


def _no_description(d):
    d["description"] = ""


MALFORMED = [(_bad_op, "op must be one of"),
             (_value_and_ref, "exactly one of value/ref"),
             (_no_baseline, "ref used without a baseline"),
             (_old_schema, "schema must be"),
             (_no_description, "description")]


@pytest.mark.parametrize("mutate,words", MALFORMED,
                         ids=[m.__name__ for m, _ in MALFORMED])
def test_validate_rejects_malformed_expects_and_schema(mutate, words):
    doc = _valid_doc()
    mutate(doc)
    problems = fleet.validate_scenario(doc)
    assert problems == ref_fleet.validate_scenario(doc)
    assert any(words in p for p in problems)


def test_load_scenario_raises_on_invalid(tmp_path):
    p = tmp_path / "bad.json"
    doc = _valid_doc()
    doc["fleet"]["seed"] = "time"
    p.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="non-reproducible") as got:
        fleet.load_scenario(p)
    with pytest.raises(ValueError) as want:
        ref_fleet.load_scenario(p)
    assert str(got.value) == str(want.value)


# ------------------------------------------------ determinism properties
# fixed points over the reference properties' ranges


SAME_SEED_CASES = [(0.5, 0, "fixed"), (1.7, 123_456, "auto"),
                   (2.9, 2**31 - 1, "fixed"), (4.0, 98_765, "auto")]


@pytest.mark.parametrize("rate,seed,policy", SAME_SEED_CASES)
def test_serve_same_seed_byte_identical(rate, seed, policy):
    """Same config + same seed => byte-identical request log, ledger event
    stream, summaries and trace, run to run and package to package."""
    a = _serve_dump(_mixed_sim(fleet, seed=seed, rate=rate, policy=policy))
    b = _serve_dump(_mixed_sim(fleet, seed=seed, rate=rate, policy=policy))
    assert a == b
    assert a == _serve_dump(_mixed_sim(ref_fleet, seed=seed, rate=rate,
                                       policy=policy))


@pytest.mark.parametrize("rate,seed", [(0.5, 17), (2.2, 40_000),
                                       (4.0, 2**30)])
def test_serve_arrivals_invariant_across_policies(rate, seed):
    """The seeded request trace depends on (seed, job name, arrival
    process) alone: the autoscale policy moves no arrival."""
    fixed = _mixed_sim(fleet, seed=seed, rate=rate, policy="fixed")
    auto = _mixed_sim(fleet, seed=seed, rate=rate, policy="auto")
    rf, ra = fixed.serve["chat"], auto.serve["chat"]
    assert rf.arrived == ra.arrived
    arr_f = {(rid, turn): t for (rid, turn, t, *_) in rf.request_log}
    arr_a = {(rid, turn): t for (rid, turn, t, *_) in ra.request_log}
    shared = set(arr_f) & set(arr_a)
    assert shared
    assert all(arr_f[k] == arr_a[k] for k in shared)
    ref = _mixed_sim(ref_fleet, seed=seed, rate=rate, policy="auto")
    assert ref.serve["chat"].request_log == ra.request_log


@pytest.mark.parametrize("rate,seed,policy", [
    (0.5, 3, "fixed"), (1.5, 271_828, "auto"), (3.0, 10**6, "auto")])
def test_serve_grammar_stable_on_mixed_runs(rate, seed, policy):
    """Mixed serve+train runs with real failures stay inside the pinned
    five-kind ledger grammar for every job, as in the reference."""
    kw = dict(seed=seed, rate=rate, policy=policy, mtbf_hours=2.0,
              horizon=1800.0)
    sim = _mixed_sim(fleet, **kw)
    assert _serve_dump(sim) == _serve_dump(_mixed_sim(ref_fleet, **kw))
    assert all(fleet.grammar_ok(j.ledger) for j in sim.jobs.values())
    assert all(fleet.grammar_ok(rt.ledger) for rt in sim.serve.values())
    summ = sim.serve["chat"].slo_summary()
    assert summ["finished"] <= summ["arrived"]
    assert 0.0 <= summ["slo_goodput"] <= 1.0


# ------------------------------------------------- calibration + power


def _synthetic_trace(cls, slope=0.002, base=0.02, steps=8):
    tr = cls(source="serve")
    for _ in range(6):
        tr.record("prefill", 0.0128, tokens=128, cached=0, batch=1)
        for b in (1, 2, 3, 4):
            tr.record("decode", base + slope * (b - 1),
                      batch=b, steps=steps, tokens=b * steps)
    return tr


def test_service_model_from_trace_recovers_affine_law():
    m = fleet.service_model_from_trace(_synthetic_trace(StepTrace))
    assert dataclasses.asdict(m) == dataclasses.asdict(
        ref_fleet.service_model_from_trace(_synthetic_trace(RefStepTrace)))
    assert m.chunk_base_s == pytest.approx(0.02, rel=1e-6)
    assert m.chunk_per_slot_s == pytest.approx(0.002, rel=1e-6)
    assert m.chunk_steps == 8
    assert m.prefill_s_per_token == pytest.approx(1e-4, rel=1e-6)
    assert m.source == "serve"
    tr = StepTrace(source="serve")
    for _ in range(5):
        tr.record("decode", 0.03, batch=2, steps=4, tokens=8)
    m2 = fleet.service_model_from_trace(tr)
    assert m2.chunk_base_s == pytest.approx(0.03)
    assert m2.chunk_per_slot_s == 0.0


@pytest.mark.parametrize("tol,kw", [(0.25, {}), (0.01, {}),
                                    (0.25, {"base": 0.01, "slope": 0.001})])
def test_serve_calibration_check_matches_reference(tol, kw):
    got = fleet.serve_calibration_check(_synthetic_trace(StepTrace, **kw),
                                        tol=tol)
    assert got == ref_fleet.serve_calibration_check(
        _synthetic_trace(RefStepTrace, **kw), tol=tol)
    assert got["steady_admissions"] >= 8
    # the mixed-batch trace replays ~4% off the single-batch operating
    # point: the default tolerance holds, a 1% one fails
    assert got["ok"] == (1.0 if tol == 0.25 else 0.0)


@pytest.fixture(scope="module")
def smoke_serve(tmp_path_factory):
    """A smoke serve of the port's launcher on the CPU with telemetry on,
    as the reference's tier-1 script runs its own before its trace gate:
    returns the Chrome trace's and the steptrace's paths."""
    d = tmp_path_factory.mktemp("smoke_serve")
    trace, steps = d / "serve_trace.json", d / "serve_steptrace.json"
    with contextlib.redirect_stdout(io.StringIO()):
        launch_serve.main([
            "--arch", "qwen2_0_5b", "--smoke", "--trace", "6",
            "--max-batch", "2", "--chunk", "4", "--device", "cpu",
            "--trace-out", str(trace), "--steptrace-out", str(steps)])
    return trace, steps


def test_service_model_from_the_port_engine_trace_matches(smoke_serve):
    """One steptrace recorded by the port's ServeEngine, read by both
    packages: the fitted service model, the step model and the
    calibration gate's readings are equal."""
    path = str(smoke_serve[1])
    mine, ref = StepTrace.read(path), RefStepTrace.read(path)
    assert len(mine) > 0 and mine.source == ref.source
    assert dataclasses.asdict(fleet.service_model_from_trace(mine)) == \
        dataclasses.asdict(ref_fleet.service_model_from_trace(ref))
    sm, rm = (fleet.StepTimeModel.from_trace(mine),
              ref_fleet.StepTimeModel.from_trace(ref))
    assert (sm.durations, sm.mean_step_s) == (rm.durations, rm.mean_step_s)
    assert fleet.serve_calibration_check(mine) == \
        ref_fleet.serve_calibration_check(ref)
    spec = fleet.job_spec_from_trace("m", mine, chips=64, total_steps=24,
                                     checkpoint_every_steps=8)
    want = ref_fleet.job_spec_from_trace("m", ref, chips=64, total_steps=24,
                                         checkpoint_every_steps=8)
    assert spec.step_time_s == want.step_time_s
    assert [spec.step_time_for(c) for c in (1, 2, 4)] == \
        [want.step_time_for(c) for c in (1, 2, 4)]


def test_trace_gate_passes_on_the_port_smoke_serve(smoke_serve, capsys):
    rc = trace_gate.main([str(smoke_serve[0]), str(smoke_serve[1]),
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    for stage in ("serve trace", "steptrace-driven sim",
                  "merged serve+train+fleet timeline", "serve calibration"):
        assert f"ok [{stage}]" in out
    assert "trace gate: PASSED" in out


def test_trace_gate_counts_a_failing_stage(smoke_serve, tmp_path, capsys):
    """A serve trace without serve spans fails stages 1 and 4 and no
    other: the exit status is the number of failing stages."""
    doc = json.loads(Path(smoke_serve[0]).read_text())
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("cat") != "serve"]
    bad = tmp_path / "no_serve.json"
    bad.write_text(json.dumps(doc))
    rc = trace_gate.main([str(bad), str(smoke_serve[1]), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 2, out
    assert "FAILED [serve trace]" in out
    assert "FAILED [merged serve+train+fleet timeline]" in out


def test_power_serve_summary_joules_per_token():
    def run(F, hw):
        sim = _mixed_sim(F, seed=3, rate=2.0, policy="fixed", horizon=600.0)
        rt = sim.serve["chat"]
        pm = F.PowerModel(hw.get("tpu_v4"))
        return (pm.serve_summary(rt.ledger, rt.spec.chips,
                                 good_tokens=rt.good_tokens,
                                 total_tokens=rt.total_tokens),
                pm.serve_summary(rt.ledger, rt.spec.chips,
                                 good_tokens=0, total_tokens=0))
    ss, empty = run(fleet, hwspec)
    assert (ss, empty) == run(ref_fleet, ref_hw)
    assert ss["energy_j"] > 0 and ss["joules_per_token"] > 0
    assert ss["joules_per_good_token"] >= ss["joules_per_token"]
    assert ss["energy_kwh"] == pytest.approx(ss["energy_j"] / 3.6e6)
    assert empty["joules_per_token"] == float("inf")


# ------------------------------------------------------- arrival model


def test_arrival_process_diurnal_and_burst_envelope():
    def rates(F):
        ap = F.ArrivalProcess(rate_rps=2.0, diurnal_amplitude=0.5,
                              diurnal_period_s=1000.0, burst_x=3.0,
                              burst_every_s=500.0, burst_len_s=50.0)
        return ap, [ap.rate_at(t) for t in range(0, 1000, 7)]
    ap, got = rates(fleet)
    assert got == rates(ref_fleet)[1]
    assert all(0.0 < r <= ap.peak_rate + 1e-9 for r in got)
    assert max(got) > 2.0
    assert ap.rate_at(510.0) > ap.rate_at(400.0)


@pytest.mark.parametrize("kw", [dict(rate_rps=0.0),
                                dict(rate_rps=1.0, diurnal_amplitude=1.5),
                                dict(rate_rps=1.0, burst_x=0.5)])
def test_arrival_process_validation(kw):
    with pytest.raises(ValueError) as got:
        fleet.ArrivalProcess(**kw)
    with pytest.raises(ValueError) as want:
        ref_fleet.ArrivalProcess(**kw)
    assert str(got.value) == str(want.value)


def test_serve_job_spec_validation():
    with pytest.raises(ValueError):
        fleet.ServeJobSpec(name="x", chips=64,
                           arrivals=fleet.ArrivalProcess(rate_rps=1.0),
                           slo=fleet.ServeSLO(),
                           service=fleet.ServiceTimeModel(),
                           scale_policy="bananas")
    assert fleet.SERVE_SCALE_POLICIES == ref_fleet.SERVE_SCALE_POLICIES


# ------------------------------------------------------ fleet_week example


@pytest.mark.parametrize("flags", [
    ["--days", "1"],
    ["--days", "0.5", "--roofline", "--scale-policy", "queue",
     "--ckpt-write-s", "10", "--seed", "5"]])
def test_fleet_week_prints_the_reference_lines(flags, tmp_path, capsys,
                                               monkeypatch):
    """The port's example prints the reference example's lines; both write
    the same Chrome trace."""
    spec = importlib.util.spec_from_file_location(
        "ref_fleet_week", ROOT / "examples" / "fleet_week.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    mine, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    fleet_week.main(flags + ["--trace", str(mine)])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["fleet_week.py"] + flags
                        + ["--trace", str(theirs)])
    ref.main()
    want = capsys.readouterr().out
    assert got.replace(str(mine), "T") == want.replace(str(theirs), "T")
    assert got.startswith("=== ") and "goodput=" in got
    assert mine.read_bytes() == theirs.read_bytes()
