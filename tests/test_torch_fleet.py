"""The port's fleet simulator against the JAX package's.

Every fleet run here is built twice from the same ``FleetConfig`` /
``JobSpec`` / seed, once from ``repro.fleet`` and once from
``repro_torch.fleet``, and the two must be equal: ledger events
(kind, seconds, steps, note), job state, ``stats``, ``fleet_summary()`` and
``chrome_trace()``, byte for byte. The claims that ``tests/test_fleet.py``
makes of the reference are then checked on the port's run: events,
planned failures, SDC, elastic re-scale, checkpoint contention,
incremental install, roofline step times, power, the Chrome trace and the
bridge to the port's ``ResilientTrainer`` (on the CPU here).

The reference's property test draws random examples; its twin here runs
a fixed list of cases, so every run counts the same tests."""

import functools
import json
from types import SimpleNamespace

import pytest

import repro.fleet as ref_fleet
from repro.core import hwspec as ref_hw
from repro.core import ocs as ref_ocs
from repro.core.goodput import GoodputLedger as RefLedger
from repro.core.sdc import SDCRateModel as RefSDC
import repro_torch.fleet as fleet
from repro_torch.core import hwspec, ocs
from repro_torch.core.goodput import GoodputLedger, modeled_goodput
from repro_torch.core.sdc import SDCRateModel

REF = SimpleNamespace(F=ref_fleet, SDC=RefSDC, hw=ref_hw, Ledger=RefLedger)
PORT = SimpleNamespace(F=fleet, SDC=SDCRateModel, hw=hwspec,
                       Ledger=GoodputLedger)

JOB_FIELDS = ("state", "base_step", "last_ckpt_step", "segment_start",
              "epoch", "completed_at", "first_admitted_at", "cubes",
              "step_time_s", "rescales", "grow_backs", "ckpt_write_end",
              "ckpt_write_step")


def ledger_dump(led):
    return [(e.kind, e.seconds, e.steps, e.note) for e in led.events]


def sim_dump(sim):
    """Everything a fleet run reports, as one comparable structure."""
    return {
        "stats": dict(sim.stats),
        "fleet": sim.fleet_summary(),
        "reconfigs": sim.sched.reconfig_count,
        "failed_cubes": sorted(sim.sched.failed_cubes),
        "jobs": {n: {"ledger": ledger_dump(j.ledger),
                     "summary": j.ledger.summary(),
                     **{k: getattr(j, k) for k in JOB_FIELDS}}
                 for n, j in sim.jobs.items()},
        "trace": json.dumps(sim.trace.chrome_trace(), sort_keys=True),
    }


# ------------------------------------------------------------ the runs
# Each builder takes one package's namespace and returns its run.


def _determinism(p):
    cfg = p.F.FleetConfig(tpu="ironwood", total_cubes=40,
                          host_mtbf_hours=500.0, repair_hours=2.0,
                          sdc=p.SDC(rate_per_chip_hour=2e-5,
                                    screen_interval_s=300.0),
                          seed=7)
    jobs = [p.F.JobSpec(name=f"j{i}", chips=512, total_steps=10**9,
                        step_time_s=1.5, checkpoint_every_steps=200)
            for i in range(3)]
    return cfg, jobs, 86400.0


def _ironwood_spares(p):
    cfg = p.F.FleetConfig(tpu="ironwood", total_cubes=144,
                          host_mtbf_hours=2000.0, repair_hours=4.0, seed=3)
    jobs = [p.F.JobSpec(name=f"job{i}", chips=2048, total_steps=10**9,
                        step_time_s=1.0, checkpoint_every_steps=600)
            for i in range(4)]
    return cfg, jobs, 3 * 86400.0


def _starvation(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=2,
                          host_mtbf_hours=None, repair_hours=1.0)
    job = p.F.JobSpec(name="j", chips=128, total_steps=10_000,
                      step_time_s=1.0, checkpoint_every_steps=100,
                      failure_steps=((250, 0),))
    return cfg, [job], 20_000.0


def _sdc_starvation(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=2, host_mtbf_hours=None,
                          repair_hours=0.5,
                          sdc=p.SDC(rate_per_chip_hour=0.05,
                                    screen_interval_s=300.0,
                                    screen_coverage=1.0),
                          seed=4)
    job = p.F.JobSpec(name="j", chips=128, total_steps=30_000,
                      step_time_s=1.0, checkpoint_every_steps=100)
    return cfg, [job], 200_000.0


def _sdc_poisoned(p):
    cfg = p.F.FleetConfig(tpu="ironwood", total_cubes=4,
                          host_mtbf_hours=None,
                          sdc=p.SDC(rate_per_chip_hour=0.5,
                                    screen_interval_s=400.0,
                                    screen_coverage=0.5),
                          seed=11)
    job = p.F.JobSpec(name="j", chips=128, total_steps=100_000,
                      step_time_s=1.0, checkpoint_every_steps=100)
    return cfg, [job], 50_000.0


def _pod(contiguous):
    def build(p):
        cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=27,
                              host_mtbf_hours=300.0, repair_hours=2.0,
                              contiguous=contiguous, seed=5)
        jobs = [p.F.JobSpec(name=f"j{i}", chips=256, total_steps=10**9,
                            step_time_s=1.0, checkpoint_every_steps=300)
                for i in range(4)]
        return cfg, jobs, 2 * 86400.0
    return build


def _sdc_failstop(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=8, host_mtbf_hours=None,
                          detect_s=1.0, restore_s=1.0, reconfig_s=0.0,
                          sdc=p.SDC(rate_per_chip_hour=3600.0 / 64,
                                    screen_interval_s=5000.0,
                                    screen_coverage=1.0),
                          seed=0)
    job = p.F.JobSpec(name="j", chips=64, total_steps=20_000,
                      step_time_s=1.0, checkpoint_every_steps=200,
                      failure_steps=((300, -1),))
    return cfg, [job], 100_000.0


def _foreign_cube(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=8, host_mtbf_hours=None)
    jobs = [p.F.JobSpec(name="j0", chips=128, total_steps=1000,
                        step_time_s=1.0, checkpoint_every_steps=100,
                        failure_steps=((500, 2),)),
            p.F.JobSpec(name="j1", chips=128, total_steps=1000,
                        step_time_s=1.0, checkpoint_every_steps=100)]
    return cfg, jobs, 10_000.0


def _elastic(policy):
    def build(p):
        cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=4,
                              host_mtbf_hours=None, repair_hours=2.0)
        jobs = [p.F.JobSpec(name="j0", chips=3 * 64, total_steps=10**9,
                            step_time_s=1.0, checkpoint_every_steps=300,
                            scale_policy=policy,
                            min_cubes=1 if policy == "shrink" else 0,
                            failure_steps=((1000, -1),)),
                p.F.JobSpec(name="j1", chips=64, total_steps=10**9,
                            step_time_s=1.0, checkpoint_every_steps=300)]
        return cfg, jobs, 4 * 3600.0
    return build


def _elastic_stochastic(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=10,
                          host_mtbf_hours=100.0, repair_hours=6.0, seed=13)
    jobs = [p.F.JobSpec(name=f"j{i}", chips=3 * 64, total_steps=10**9,
                        step_time_s=1.0, checkpoint_every_steps=200,
                        scale_policy="shrink", min_cubes=1)
            for i in range(3)]
    return cfg, jobs, 2 * 86400.0


def _admission(min_cubes):
    def build(p):
        cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=2,
                              host_mtbf_hours=None)
        job = p.F.JobSpec(name="fits", chips=4 * 64, total_steps=1000,
                          step_time_s=1.0, scale_policy="shrink",
                          min_cubes=min_cubes)
        return cfg, [job], 10.0
    return build


def _roofline_elastic(p):
    wl = p.F.TrainWorkload(n_params=8e9, tokens_per_step=1024 * 1024)
    spec = p.F.job_spec_from_roofline(
        "r", "tpu_v4", wl, chips=3 * 64, total_steps=10**9,
        checkpoint_every_steps=500, scale_policy="shrink", min_cubes=1)
    m = p.F.StepTimeModel("tpu_v4", wl)
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=4, host_mtbf_hours=None,
                          repair_hours=50.0)
    spec = p.F.JobSpec(**{**spec.__dict__, "failure_steps": ((100, -1),)})
    filler = p.F.JobSpec(name="filler", chips=64, total_steps=10**9,
                         step_time_s=1.0)
    return cfg, [spec, filler], m(3) * 100 + 40_000.0


def _sync_write(every):
    def build(p):
        cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=2,
                              host_mtbf_hours=None, ckpt_write_s=30.0)
        job = p.F.JobSpec(name="j", chips=64, total_steps=10**9,
                          step_time_s=1.0, checkpoint_every_steps=every)
        return cfg, [job], 40_000.0
    return build


def _contention(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=4, host_mtbf_hours=None,
                          ckpt_write_s=20.0)
    jobs = [p.F.JobSpec(name=f"j{i}", chips=64, total_steps=10**9,
                        step_time_s=1.0, checkpoint_every_steps=100)
            for i in range(2)]
    return cfg, jobs, 150.0


def _mid_write(fail_step):
    def build(p):
        cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=3,
                              host_mtbf_hours=None, detect_s=1.0,
                              restore_s=1.0, reconfig_s=0.0,
                              ckpt_write_s=50.0)
        jobs = [p.F.JobSpec(name="j0", chips=64, total_steps=10**9,
                            step_time_s=1.0, checkpoint_every_steps=100),
                p.F.JobSpec(name="j1", chips=64, total_steps=10**9,
                            step_time_s=1.0, checkpoint_every_steps=10**8,
                            failure_steps=((fail_step, 0),))]
        return cfg, jobs, 500.0
    return build


def _aborted_write(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=4, host_mtbf_hours=None,
                          detect_s=1.0, restore_s=1.0, reconfig_s=0.0,
                          ckpt_write_s=50.0)
    jobs = [p.F.JobSpec(name="j0", chips=64, total_steps=10**9,
                        step_time_s=1.0, checkpoint_every_steps=100),
            p.F.JobSpec(name="j1", chips=64, total_steps=10**9,
                        step_time_s=1.0, checkpoint_every_steps=10**8,
                        failure_steps=((120, 0),)),
            p.F.JobSpec(name="j2", chips=64, total_steps=10**9,
                        step_time_s=1.0, checkpoint_every_steps=130)]
    return cfg, jobs, 140.0


def _pre_grow(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=3, host_mtbf_hours=None,
                          repair_hours=1.0, detect_s=1.0, restore_s=1.0,
                          reconfig_s=0.0, ckpt_write_s=40.0)
    job = p.F.JobSpec(name="j", chips=3 * 64, total_steps=10**9,
                      step_time_s=1.0, checkpoint_every_steps=10**8,
                      scale_policy="shrink", min_cubes=1,
                      failure_steps=((500, -1),))
    return cfg, [job], 6000.0


def _install(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=8, host_mtbf_hours=None,
                          install_schedule=((0.0, 4), (1000.0, 8)))
    jobs = [p.F.JobSpec(name=f"j{i}", chips=4 * 64, total_steps=10**9,
                        step_time_s=1.0, checkpoint_every_steps=500)
            for i in range(2)]
    return cfg, jobs, 2000.0


def _trace_export(p):
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=8, host_mtbf_hours=100.0,
                          seed=2)
    job = p.F.JobSpec(name="j", chips=256, total_steps=5000,
                      step_time_s=1.0, checkpoint_every_steps=500)
    return cfg, [job], 20_000.0


def _known_fault(p):
    # ROADMAP Queue C item 1: a second failure inside a recovery window
    cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=24, host_mtbf_hours=50.0,
                          repair_hours=1.0, seed=8046)
    job = p.F.JobSpec(name="j0", chips=256, total_steps=2000,
                      step_time_s=1.0, checkpoint_every_steps=100)
    return cfg, [job], 40_000.0


RUNS = {
    "determinism": _determinism,
    "ironwood_spares": _ironwood_spares,
    "starvation": _starvation,
    "sdc_starvation": _sdc_starvation,
    "sdc_poisoned": _sdc_poisoned,
    "pod_ocs": _pod(False),
    "pod_contiguous": _pod(True),
    "sdc_failstop": _sdc_failstop,
    "foreign_cube": _foreign_cube,
    "elastic_queue": _elastic("queue"),
    "elastic_shrink": _elastic("shrink"),
    "elastic_stochastic": _elastic_stochastic,
    "admission_fits": _admission(2),
    "admission_floor": _admission(3),
    "roofline_elastic": _roofline_elastic,
    "sync_write_200": _sync_write(200),
    "sync_write_400": _sync_write(400),
    "sync_write_800": _sync_write(800),
    "contention": _contention,
    "mid_write": _mid_write(120),
    "after_write": _mid_write(170),
    "aborted_write": _aborted_write,
    "pre_grow": _pre_grow,
    "install": _install,
    "trace_export": _trace_export,
    "known_fault": _known_fault,
}


def _simulate(p, build):
    cfg, jobs, horizon = build(p)
    sim = p.F.FleetSimulator(cfg, jobs)
    sim.run(horizon)
    return sim


@functools.lru_cache(maxsize=None)
def port_run(name):
    return _simulate(PORT, RUNS[name])


@functools.lru_cache(maxsize=None)
def ref_run(name):
    return _simulate(REF, RUNS[name])


@pytest.mark.parametrize("name", list(RUNS))
def test_run_matches_reference(name):
    assert sim_dump(port_run(name)) == sim_dump(ref_run(name))


# ------------------------------------------------------------ event engine


def test_event_engine_matches_and_orders_deterministically():
    def fill(eng):
        eng.schedule_at(5.0, "a")
        eng.schedule_at(1.0, "b")
        eng.schedule_at(5.0, "c")  # tie with "a": insertion order wins
        eng.schedule_at(3.0, "d", x=1)
        return [(e.time, e.kind, e.payload) for e in eng.drain_until(10.0)]

    got = fill(fleet.EventEngine(0))
    assert got == fill(fleet.EventEngine(0)) == fill(ref_fleet.EventEngine(0))
    assert [(t, k) for t, k, _ in got] == [
        (1.0, "b"), (3.0, "d"), (5.0, "a"), (5.0, "c")]


def test_event_engine_cancel_horizon_and_past():
    def run(F):
        eng = F.EventEngine(0)
        ev = eng.schedule_at(2.0, "x")
        eng.schedule_at(4.0, "y")
        eng.schedule_at(20.0, "z")
        eng.cancel(ev)
        first = [(e.time, e.kind) for e in eng.drain_until(10.0)]
        rest = [(e.time, e.kind) for e in eng.drain_until(30.0)]
        eng2 = F.EventEngine(0)
        eng2.schedule_at(5.0, "a")
        popped = eng2.pop().kind
        with pytest.raises(ValueError):
            eng2.schedule_at(1.0, "late")
        return first, rest, popped, [eng.draw_exponential(5.0)
                                     for _ in range(3)]

    assert run(fleet) == run(ref_fleet)
    assert run(fleet)[:3] == ([(4.0, "y")], [(20.0, "z")], "a")


# -------------------------------------------------- deterministic failure plan


@pytest.mark.parametrize("steps,every,failures", [
    (18, 6, {9: 0, 14: 1}), (18, 100, {15: 0, 16: 1, 17: 2}),
    (40, 5, {3: 0, 12: 2, 13: 0, 39: 1}), (10, 3, {})])
def test_trainer_plan_matches_reference(steps, every, failures):
    got = fleet.simulate_trainer_plan(total_steps=steps,
                                      checkpoint_every=every,
                                      failures=failures)
    want = ref_fleet.simulate_trainer_plan(total_steps=steps,
                                           checkpoint_every=every,
                                           failures=failures)
    assert ledger_dump(got) == ledger_dump(want)
    assert got.effective_steps == steps


def test_planned_failures_reproduce_trainer_grammar():
    led = fleet.simulate_trainer_plan(total_steps=18, checkpoint_every=6,
                                      failures={9: 0, 14: 1})
    assert led.structure() == [
        ("idle", 0), ("steps", 6), ("idle", 0), ("steps", 3),
        ("detect", 0), ("restore", 0), ("rework", 3),
        ("steps", 3), ("idle", 0), ("steps", 2),
        ("detect", 0), ("restore", 0), ("rework", 2),
        ("steps", 4), ("idle", 0)]
    dense = fleet.simulate_trainer_plan(total_steps=18, checkpoint_every=100,
                                        failures={15: 0, 16: 1, 17: 2})
    assert sum(s for k, s in dense.structure() if k == "rework") == \
        15 + 16 + 17


# -------------------------------------------- fleet runs: the reference claims


def test_sim_determinism_bitwise():
    again = _simulate(PORT, _determinism)
    assert sim_dump(again) == sim_dump(port_run("determinism"))
    assert port_run("determinism").stats["cube_failures"] > 0


# the reference's property test draws (seed, mtbf, njobs) at random; these
# are fixed points spread over the same ranges
PROPERTY_CASES = [(0, 50.0, 1), (1250, 90.0, 2), (2500, 160.0, 3),
                  (3750, 300.0, 4), (5000, 550.0, 5), (6250, 1000.0, 1),
                  (7500, 1800.0, 2), (8750, 3300.0, 3), (10_000, 5000.0, 4),
                  (4321, 75.0, 5)]


@pytest.mark.parametrize("seed,mtbf,njobs", PROPERTY_CASES)
def test_goodput_bounds_and_invariants_cases(seed, mtbf, njobs):
    """The reference property's invariants at fixed points: goodputs in
    [0, 1], effective steps at most the total, the scheduler's invariants
    after every event (checked inside run()), and both packages equal. The
    ledger of a finished job must cover its span; where a second failure
    lands in a recovery window it covers more (ROADMAP Queue C item 1),
    by the same seconds in both packages."""
    def build(p):
        cfg = p.F.FleetConfig(tpu="tpu_v4", total_cubes=24,
                              host_mtbf_hours=mtbf, repair_hours=1.0,
                              seed=seed)
        jobs = [p.F.JobSpec(name=f"j{i}", chips=256, total_steps=2000,
                            step_time_s=1.0, checkpoint_every_steps=100)
                for i in range(njobs)]
        return cfg, jobs, 40_000.0

    sim, ref = _simulate(PORT, build), _simulate(REF, build)
    assert sim_dump(sim) == sim_dump(ref)
    for job in sim.jobs.values():
        assert 0.0 <= job.ledger.goodput <= 1.0
        assert job.ledger.effective_steps <= job.spec.total_steps
        if job.state == "done":
            span = job.completed_at - job.spec.arrival_s
            assert job.ledger.total_seconds >= span - 1e-6
    fs = sim.fleet_summary()
    assert 0.0 <= fs["min_goodput"] <= 1.0


def test_known_fault_overshoots_by_the_same_seconds():
    """Pins the reference's fault (ROADMAP Queue C item 1):
    ``FleetSimulator._handle_job_failure`` never refunds the unelapsed part
    of a recovery window when a second failure lands inside it, so the
    job's ledger sums to more than its span. The port copies this on
    purpose, so that its ledgers equal the reference's: both finish the job
    and both ledgers exceed the span by the same 154.35 s."""
    over = []
    for sim in (port_run("known_fault"), ref_run("known_fault")):
        job = sim.jobs["j0"]
        assert job.state == "done"
        over.append(job.ledger.total_seconds
                    - (job.completed_at - job.spec.arrival_s))
    assert over[0] == pytest.approx(154.35281423857805, abs=1e-6)
    assert over[1] == pytest.approx(over[0], abs=1e-6)


def test_reconfigs_do_not_starve_with_spares():
    sim = port_run("ironwood_spares")
    assert sim.sched.reconfig_count > 0
    assert sim.stats["starvations"] == 0
    assert all(j.state == "running" for j in sim.jobs.values())
    assert sim.fleet_summary()["min_goodput"] > 0.9


def test_fail_host_maps_to_owning_cube():
    def run(o):
        sched = o.OCSPodScheduler(total_cubes=4)
        sched.allocate("j", 128)
        out = [sched.fail_host(20), sched.fail_host(3 * 16 + 5)]
        with pytest.raises(ValueError):
            sched.fail_host(4 * 16)
        return out
    assert run(ocs) == run(ref_ocs) == [(1, "j"), (3, None)]


def test_starvation_queues_and_resumes():
    sim = port_run("starvation")
    jr = sim.jobs["j"]
    assert sim.stats["starvations"] == 1
    assert jr.state == "done"
    kinds = [k for k, _ in jr.ledger.structure()]
    assert "detect" in kinds and "restore" in kinds and "idle" in kinds
    t = jr.ledger.totals()
    assert t["idle"] == pytest.approx(3600.0 - sim.cfg.detect_s)
    assert t["rework"] == pytest.approx(50.0)  # 250 - ckpt@200
    assert jr.ledger.total_seconds == pytest.approx(jr.completed_at)


def test_sdc_starvation_charges_restore_once():
    sim = port_run("sdc_starvation")
    jr = sim.jobs["j"]
    assert sim.stats["sdc_detections"] >= 1
    assert sim.stats["starvations"] == sim.stats["sdc_detections"]
    restores = [e for e in jr.ledger.events if e.kind == "restore"]
    assert len(restores) == sim.stats["sdc_detections"]
    if jr.state == "done":
        assert jr.ledger.total_seconds == pytest.approx(jr.completed_at)


def test_sdc_rolls_back_past_poisoned_checkpoints():
    sim = port_run("sdc_poisoned")
    assert sim.stats["sdc_detections"] >= 1
    reworks = [e for e in sim.jobs["j"].ledger.events if e.kind == "rework"]
    assert reworks and any(e.steps > 100 for e in reworks)


def test_contiguous_pod_fares_worse_than_ocs():
    o, c = port_run("pod_ocs"), port_run("pod_contiguous")
    assert o.fleet_summary()["mean_goodput"] > \
        c.fleet_summary()["mean_goodput"]
    assert c.stats["starvations"] > 0
    assert o.sched.reconfig_count > 0


def test_sdc_survives_failstop_restore_from_poisoned_ckpt():
    sim = port_run("sdc_failstop")
    jr = sim.jobs["j"]
    assert sim.stats["sdc_corruptions"] >= 1
    assert sim.stats["sdc_detections"] >= 1
    assert jr.state == "done"
    assert jr.ledger.total_seconds == pytest.approx(jr.completed_at)


def test_planned_failure_on_foreign_cube_interrupts_owner():
    sim = port_run("foreign_cube")
    for name in ("j0", "j1"):
        assert sim.jobs[name].state == "done"
        kinds = [k for k, _ in sim.jobs[name].ledger.structure()]
        assert "detect" in kinds and "restore" in kinds
    assert sim.sched.reconfig_count == 1
    assert 2 in sim.sched.failed_cubes


# ------------------------------------------------------ elastic re-scale


def test_elastic_shrink_beats_queue_same_trace():
    queue, shrink = port_run("elastic_queue"), port_run("elastic_shrink")
    qj, sj = queue.jobs["j0"], shrink.jobs["j0"]
    assert sj.ledger.goodput > qj.ledger.goodput
    assert sj.base_step > qj.base_step
    assert queue.stats["starvations"] == 1 and queue.stats["rescales"] == 0
    assert shrink.stats["starvations"] == 0 and \
        shrink.stats["rescales"] == 1


def test_grow_back_after_repair_and_grammar():
    sim = port_run("elastic_shrink")
    j0 = sim.jobs["j0"]
    assert j0.rescales == 1 and j0.grow_backs == 1
    assert j0.cubes == j0.spec.full_cubes == 3
    assert j0.step_time_s == pytest.approx(1.0)
    reworks = [e for e in j0.ledger.events if e.kind == "rework"]
    assert len(reworks) == 1
    assert reworks[0].seconds == pytest.approx(reworks[0].steps * 1.5)
    assert set(fleet.GRAMMAR_KINDS) == set(ref_fleet.GRAMMAR_KINDS) == {
        "steps", "rework", "detect", "restore", "idle"}
    for jr in sim.jobs.values():
        assert jr.ledger.total_seconds == pytest.approx(4 * 3600.0)
        assert fleet.grammar_ok(jr.ledger)


def test_elastic_rescale_deterministic():
    again = _simulate(PORT, _elastic_stochastic)
    assert sim_dump(again) == sim_dump(port_run("elastic_stochastic"))
    assert again.stats["rescales"] > 0


def test_elastic_admission_shrinks_and_respects_min_cubes():
    jr = port_run("admission_fits").jobs["fits"]
    assert jr.state == "running" and jr.cubes == 2
    assert jr.step_time_s == pytest.approx(2.0)
    assert jr.rescales == 1
    assert port_run("admission_floor").jobs["fits"].state == "queued"


def test_scale_policy_validation():
    for F in (fleet, ref_fleet):
        with pytest.raises(ValueError):
            F.JobSpec(name="j", chips=64, total_steps=10, scale_policy="grow")
        with pytest.raises(ValueError):
            F.JobSpec(name="j", chips=64, total_steps=10, min_cubes=5)
    kw = dict(name="j", chips=2 * 64, total_steps=10, scale_policy="shrink")
    j = fleet.JobSpec(**kw)
    assert j.min_cubes == 1
    assert j.__dict__ == ref_fleet.JobSpec(**kw).__dict__


def test_ocs_grow_and_max_slice_hooks():
    def run(o):
        sched = o.OCSPodScheduler(total_cubes=6)
        sched.allocate("j", 2 * 64)
        out = [sched.max_slice_cubes(10)]
        grown = sched.grow("j", 2)
        out += [len(grown.cubes), sched.spare_cubes()]
        sched.check_invariants()
        out.append(sched.grow("j", 3))
        with pytest.raises(KeyError):
            sched.grow("nope", 1)
        contig = o.OCSPodScheduler(total_cubes=8, contiguous=True)
        contig.allocate("j", 2 * 64)
        return out + [contig.grow("j", 1), contig.max_slice_cubes(8)]
    got = run(ocs)
    assert got == run(ref_ocs)
    assert got[:4] == [4, 4, 2, None] and got[4] is None and got[5] <= 6


# ------------------------------------------------- roofline-fed step times


def test_step_time_models_match_reference():
    def run(F):
        wl = F.TrainWorkload(n_params=70e9, tokens_per_step=4096 * 4096)
        return (F.generation_step_times(wl, cubes=8),
                [F.StepTimeModel(g, wl)(c) for g in ("tpu_v4", "ironwood")
                 for c in (1, 3, 4, 8, 32, 256)],
                F.StepTimeModel("tpu_v4", wl).report(256).row())
    assert run(fleet) == run(ref_fleet)


def test_step_time_model_tracks_table1_anchors():
    wl = fleet.TrainWorkload(n_params=70e9, tokens_per_step=4096 * 4096)
    times = fleet.generation_step_times(wl, cubes=8)
    vals = [times[s.name] for s in hwspec.GENERATIONS]
    assert vals == sorted(vals, reverse=True)
    ss = hwspec.scaling_summary()
    speedup = times["tpu_v2"] / times["ironwood"]
    assert ss["hbm_bandwidth_x"] <= speedup <= ss["node_peak_bf16_x"] * 1.02


def test_step_time_model_scaling_curve():
    wl = fleet.TrainWorkload(n_params=70e9, tokens_per_step=4096 * 4096)
    m = fleet.StepTimeModel("tpu_v4", wl)
    curve = [m(c) for c in (4, 8, 16, 32, 64, 128, 256)]
    assert all(a >= b * (1 - 1e-3) for a, b in zip(curve, curve[1:]))
    assert curve[0] / curve[1] == pytest.approx(2.0, rel=0.01)
    assert curve[-2] / curve[-1] < 1.5
    assert m.report(256).bound == "collective"
    assert m.report(4).bound == "compute"


def test_job_spec_from_roofline_drives_elastic_sim():
    wl = fleet.TrainWorkload(n_params=8e9, tokens_per_step=1024 * 1024)
    m = fleet.StepTimeModel("tpu_v4", wl)
    spec = fleet.job_spec_from_roofline(
        "r", "tpu_v4", wl, chips=3 * 64, total_steps=10**9,
        checkpoint_every_steps=500, scale_policy="shrink", min_cubes=1)
    assert spec.step_time_s == pytest.approx(m(3))
    assert spec.step_time_for(2) == pytest.approx(m(2))
    jr = port_run("roofline_elastic").jobs["r"]
    assert jr.cubes == 2 and jr.rescales == 1
    assert jr.step_time_s == pytest.approx(m(2))


# ------------------------------------- checkpoint writes: stalls, contention


def _stalls(job):
    return [e.seconds for e in job.ledger.events
            if e.kind == "idle" and e.note.startswith("ckpt write")]


def test_sync_ckpt_write_stalls_and_interval_tradeoff():
    goodputs = []
    for every in (200, 400, 800):
        jr = port_run(f"sync_write_{every}").jobs["j"]
        assert _stalls(jr) and all(s == pytest.approx(30.0)
                                   for s in _stalls(jr))
        assert 40_000.0 <= jr.ledger.total_seconds <= 40_000.0 + 30.0
        goodputs.append(jr.ledger.goodput)
    assert goodputs == sorted(goodputs) and len(set(goodputs)) == 3


def test_ckpt_write_contention_and_durability():
    sim = port_run("contention")
    assert _stalls(sim.jobs["j0"]) == [pytest.approx(20.0)]
    assert _stalls(sim.jobs["j1"]) == [pytest.approx(40.0)]
    lost = [e for e in port_run("mid_write").jobs["j0"].ledger.events
            if e.kind == "rework"]
    assert lost and lost[0].steps == 100
    kept = [e for e in port_run("after_write").jobs["j0"].ledger.events
            if e.kind == "rework"]
    assert kept and 0 < kept[0].steps <= 30
    assert _stalls(port_run("aborted_write").jobs["j2"]) == \
        [pytest.approx(50.0)]


def test_pre_grow_snapshot_contends_and_is_durable_on_completion():
    jr = port_run("pre_grow").jobs["j"]
    assert jr.rescales == 1 and jr.grow_backs == 1
    pre_grow = [e for e in jr.ledger.events
                if e.kind == "idle" and "(pre-grow)" in e.note]
    assert len(pre_grow) == 1 and pre_grow[0].seconds >= 40.0
    assert jr.last_ckpt_step > 0 or jr.ckpt_write_end is not None


def test_sim_interval_optimum_matches_model_search():
    out = fleet.sim_checkpoint_interval_sweep(points=7, mean_failures=20)
    assert out == ref_fleet.sim_checkpoint_interval_sweep(
        points=7, mean_failures=20)
    assert out["agree_within_one_bucket"], out
    best = out["sim_goodput"][out["sim_best_index"]]
    assert best > out["sim_goodput"][0]
    assert best > out["sim_goodput"][-1]


def test_incremental_install_admits_jobs_as_cubes_land():
    sim = port_run("install")
    assert sim.jobs["j0"].first_admitted_at == pytest.approx(0.0)
    assert sim.jobs["j1"].first_admitted_at == pytest.approx(1000.0)
    with pytest.raises(ValueError):
        fleet.FleetConfig(install_schedule=((0.0, 4), (10.0, 2)))
    with pytest.raises(ValueError):
        fleet.FleetConfig(total_cubes=4, install_schedule=((0.0, 8),))


@pytest.mark.parametrize("mtbf_h,write_s", [(6.0, 30.0), (2.0, 120.0),
                                            (48.0, 10.0)])
def test_checkpoint_interval_search_matches_young_daly(mtbf_h, write_s):
    kw = dict(mtbf_hours=mtbf_h, detect_s=0.0, restore_s=0.0,
              checkpoint_write_s=write_s)
    yd = fleet.optimal_checkpoint_interval_s(mtbf_h * 3600.0, write_s)
    assert yd == ref_fleet.optimal_checkpoint_interval_s(mtbf_h * 3600.0,
                                                         write_s)
    best_t, best_g = fleet.search_checkpoint_interval(**kw)
    assert (best_t, best_g) == ref_fleet.search_checkpoint_interval(**kw)
    assert best_t == pytest.approx(yd, rel=0.15)
    assert 0.0 < best_g < 1.0
    assert best_g > modeled_goodput(checkpoint_interval_s=yd * 20, **kw)


# ------------------------------------------------------------ power/carbon


def test_sustainability_ratio_matches_paper_and_reference():
    r = fleet.sustainability_ratios()
    assert r == ref_fleet.sustainability_ratios()
    assert r["joules_per_flop_improvement_x"] == \
        pytest.approx(r["paper_perf_per_watt_x"], rel=0.02)
    assert r["co2e_per_flop_improvement_x"] == \
        r["joules_per_flop_improvement_x"]
    table = fleet.generation_efficiency_table()
    assert table == ref_fleet.generation_efficiency_table()
    vals = [table[s.name] for s in hwspec.GENERATIONS]
    assert vals == sorted(vals, reverse=True)


@pytest.mark.parametrize("tpu", ["tpu_v4", "tpu_v5p", "ironwood", "tpu_v2"])
def test_power_model_integrates_ledger(tpu):
    def run(p):
        led = p.Ledger()
        led.record_steps(3600.0, steps=1800)
        led.record_restore(3600.0)
        pm = p.F.PowerModel(p.hw.get(tpu), mfu=0.5, idle_power_fraction=0.2)
        return pm.job_summary(led, chips=256)
    s = run(PORT)
    assert s == run(REF)
    chip_w = hwspec.chip_tdp_watts(hwspec.get(tpu))
    assert s["energy_j"] == pytest.approx(256 * chip_w * 3600.0 * 1.2)
    assert s["effective_eflops"] == pytest.approx(
        3600.0 * 256 * hwspec.get(tpu).peak_tflops * 1e12 * 0.5 / 1e18)


@pytest.mark.parametrize("name", ["determinism", "elastic_stochastic",
                                  "pod_ocs"])
def test_fleet_run_power_summaries_match(name):
    def run(sim, p):
        pm = p.F.PowerModel(p.hw.get(sim.cfg.tpu))
        return {n: pm.job_summary(j.ledger, j.spec.chips)
                for n, j in sim.jobs.items()}
    assert run(port_run(name), PORT) == run(ref_run(name), REF)


def test_tdp_anchor_reproduces_relative_row():
    v2 = hwspec.pod_tdp_watts(hwspec.TPU_V2)
    iw = hwspec.pod_tdp_watts(hwspec.IRONWOOD)
    assert v2 == pytest.approx(256 * 280.0)
    assert iw / v2 == pytest.approx(hwspec.IRONWOOD.rel_pod_tdp)
    assert hwspec.pod_tdp_watts(hwspec.TPU_V5E) is None


# ------------------------------------------------------------------- trace


def test_chrome_trace_export_is_byte_identical(tmp_path):
    mine, ref = tmp_path / "port.json", tmp_path / "ref.json"
    port_run("trace_export").trace.write(str(mine))
    ref_run("trace_export").trace.write(str(ref))
    assert mine.read_bytes() == ref.read_bytes()
    evs = json.loads(mine.read_text())["traceEvents"]
    assert all({"ph", "pid", "name"} <= set(e) for e in evs)
    assert "train" in {e["name"] for e in evs if e["ph"] == "X"}
    assert {"cube_fail", "ocs_reconfig"} & \
        {e["name"] for e in evs if e["ph"] == "i"}
    assert all(e["dur"] > 0 for e in evs if e["ph"] == "X")


# ------------------------------------------------------------------ bridge


def test_bridge_matches_reference_bridge():
    """The port's bridge drives the port's ResilientTrainer (on the CPU
    here) and the port's simulator; its structures must equal the
    reference bridge's, and match on both sides."""
    got = fleet.run_bridge(steps=18, checkpoint_every=6,
                           failures={9: 0, 14: 1}, device="cpu")
    want = ref_fleet.run_bridge(steps=18, checkpoint_every=6,
                                failures={9: 0, 14: 1})
    assert got["match"] and want["match"]
    for key in ("real_structure", "sim_structure", "effective_steps",
                "replay_summary", "sim_goodput"):
        assert got[key] == want[key], key
    assert got["replay_summary"]["replayed_steps"] == 5  # 3 + 2
    assert 0.0 < got["real_goodput"] <= 1.0
