"""Validate the fleet simulator against the real resilient trainer.

``run_bridge`` executes the same failure plan twice:

  * for real — a smoke-scale run of the port's ``ResilientTrainer``
    (actual model, actual checkpoints, actual OCS substitutions, measured
    seconds), on the card unless the caller asks for the CPU;
  * in the simulator — one fleet job with the identical plan
    (checkpoint cadence, failure steps, cube ids) and modeled seconds.

The two goodput ledgers must agree *event-for-event in structure*
(``GoodputLedger.structure()``: the merged (kind, steps) sequence —
bootstrap idle, step runs, checkpoint marks, detect/restore/rework
triplets with identical rework step counts). Durations differ by
construction (measured vs modeled); the grammar must not.

``GRAMMAR_KINDS`` is the pinned vocabulary both sides speak. Elastic
re-scale and synchronous checkpoint writes extend the *simulator's*
story, but every new charge stays inside this vocabulary (re-scale
markers are ``idle``, write stalls are ``idle``, re-scale restores are
``restore``/``rework``) — ``grammar_ok`` asserts exactly that, so the
bridge contract survives the elastic arm unchanged.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Dict, Optional

from repro_torch.core.goodput import GoodputLedger
from repro_torch.device import DeviceLike
from repro_torch.fleet.jobs import JobSpec
from repro_torch.fleet.sim import FleetConfig, FleetSimulator

# The pinned ledger vocabulary: every event either side ever records.
GRAMMAR_KINDS = ("steps", "rework", "detect", "restore", "idle")


def grammar_ok(ledger: GoodputLedger) -> bool:
    """True iff every ledger event speaks the pinned five-kind grammar."""
    return all(e.kind in GRAMMAR_KINDS for e in ledger.events)

# Mirrors launch.train.build_trainer's pod: Ironwood-scale cube count,
# one 8192-chip job (cubes 0..127), 16 spares.
_TOTAL_CUBES = 144
_JOB_CHIPS = 128 * 64


def simulate_trainer_plan(
    *,
    total_steps: int,
    checkpoint_every: int,
    failures: Dict[int, int],
    step_time_s: float = 1.0,
    detect_s: float = 0.05,
    restore_s: float = 0.05,
    tpu: str = "ironwood",
) -> GoodputLedger:
    """Run the fleet simulator over the exact failure plan a
    ResilientTrainer would be given, returning the simulated ledger."""
    spec = JobSpec(
        name="train", chips=_JOB_CHIPS, total_steps=total_steps,
        step_time_s=step_time_s,
        checkpoint_every_steps=checkpoint_every,
        failure_steps=tuple(sorted(failures.items())))
    cfg = FleetConfig(tpu=tpu, total_cubes=_TOTAL_CUBES,
                      host_mtbf_hours=None, detect_s=detect_s,
                      restore_s=restore_s, reconfig_s=0.0, sdc=None)
    sim = FleetSimulator(cfg, [spec])
    # horizon: each failure costs detect + restore + rework, and rework
    # is bounded by the full history (checkpoint_every > total_steps)
    sim.run((1 + len(failures)) * total_steps * step_time_s
            + len(failures) * (detect_s + restore_s) + 1.0)
    job = sim.jobs["train"]
    assert job.state == "done", f"sim job did not finish: {job.state}"
    return job.ledger


def serve_calibration_check(trace, *, tol: float = 0.25,
                            requests: int = 160) -> Dict[str, float]:
    """The serve-side bridge: pin the sim's per-chunk service times to a
    *measured* ``ServeEngine`` steptrace.

    Calibrates a ``ServiceTimeModel`` from the trace, then drives a
    one-replica serve sim to saturation at the trace's mean recorded
    batch and compares the realized per-chunk decode time
    (``tpot * chunk_steps`` of steady-state admissions) against the
    ``MeasuredStepTimeModel`` replay mean of the same trace. ``ok`` iff
    the relative error is within ``tol`` — the tier-1 calibration gate
    (``repro_torch.launch.trace_gate``) fails on a miss."""
    from repro_torch.fleet.perf import (StepTimeModel,
                                        service_model_from_trace)
    from repro_torch.fleet.serve_jobs import (ArrivalProcess, ServeJobSpec,
                                              ServeSLO)
    from repro_torch.obs.steptrace import EFFECTIVE_KINDS

    model = service_model_from_trace(trace)
    measured = StepTimeModel.from_trace(trace)
    batches = [float(e.features.get("batch", 1.0))
               for e in trace.events if e.kind in EFFECTIVE_KINDS]
    target_b = max(1, round(sum(batches) / len(batches)))
    out_tokens = model.chunk_steps * 4
    service_s = model.service_s(1, 0, out_tokens, target_b)
    # arrivals outpace the replica's saturated throughput (target_b
    # requests per service_s) 2x, so after warm-up every admission
    # happens at a full batch of target_b
    horizon = 2.0 * requests * service_s / target_b + 1.0
    arr = ArrivalProcess(rate_rps=2.0 * target_b / service_s,
                         prompt_tokens=2, output_tokens=out_tokens,
                         turns_mean=1.0)
    svc = ServeJobSpec(
        name="cal", chips=64, arrivals=arr,
        slo=ServeSLO(ttft_s=1e9, tpot_s=1e9), service=model,
        replicas=1, max_replicas=1, max_batch=target_b,
        scale_policy="fixed", spinup_s=0.0)
    sim = FleetSimulator(FleetConfig(tpu="ironwood", total_cubes=1),
                         [], serve_jobs=[svc])
    sim.run(horizon)
    log = sim.serve["cal"].request_log
    chunks = [tpot * model.chunk_steps
              for (_, _, _, _, _, _, batch, _, tpot, _) in log
              if batch == target_b]
    measured_mean = measured.mean_step_s
    sim_mean = (sum(chunks) / len(chunks)) if chunks else 0.0
    rel_err = (abs(sim_mean - measured_mean) / measured_mean
               if measured_mean else float("inf"))
    return {
        "target_batch": float(target_b),
        "steady_admissions": float(len(chunks)),
        "sim_chunk_s": sim_mean,
        "measured_chunk_s": measured_mean,
        "rel_err": rel_err,
        "ok": float(len(chunks) >= 8 and rel_err <= tol),
    }


def run_bridge(
    *,
    arch: str = "qwen2_0_5b",
    steps: int = 18,
    checkpoint_every: int = 6,
    failures: Optional[Dict[int, int]] = None,
    batch: int = 2,
    seq: int = 16,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """Real run vs simulated run of one failure plan; returns both
    structures, both goodputs, and whether the structures match. The real
    run trains on ``device``: the card unless the caller asks for the
    CPU."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.train import build_trainer
    from repro_torch.resilience.driver import StragglerPolicy

    failures = dict(failures if failures is not None else {9: 0, 14: 1})
    tmp = tempfile.mkdtemp(prefix="fleet_bridge_")
    try:
        trainer, state = build_trainer(
            get_smoke(arch), batch=batch, seq=seq, ckpt_dir=tmp,
            checkpoint_every=checkpoint_every, failures=dict(failures),
            device=device)
        # timing jitter must not inject straggler idle events into
        # the measured structure
        trainer.straggler = StragglerPolicy(threshold=float("inf"))
        _, real_ledger, losses = trainer.run(state, steps)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sim_ledger = simulate_trainer_plan(
        total_steps=steps, checkpoint_every=checkpoint_every,
        failures=failures)
    real_s, sim_s = real_ledger.structure(), sim_ledger.structure()
    return {
        "real_structure": real_s,
        "sim_structure": sim_s,
        "match": real_s == sim_s,
        "real_goodput": real_ledger.goodput,
        "sim_goodput": sim_ledger.goodput,
        "effective_steps": len(losses),
        "replay_summary": trainer.replay_summary(),
    }
