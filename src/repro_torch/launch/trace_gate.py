"""Trace-validation gate of the port (the twin of ``scripts/trace_gate.py``).

Takes the Chrome trace and steptrace that a serve run of the port's
launcher wrote, then closes the telemetry loop in-process:

  1. validate the serve trace (balanced B/E per lane, non-negative
     durations, ``serve`` spans present);
  2. run a tiny ``ResilientTrainer`` of the port on ``--device`` with an
     enabled tracer, so step / ckpt / replay spans land in the same
     schema;
  3. feed the *measured* serve steptrace through
     ``StepTimeModel.from_trace`` and drive a ``FleetSimulator`` off it,
     with the sim recording into the SAME tracer as the trainer;
  4. merge everything into one timeline and require the ``serve``,
     ``train`` and ``fleet`` categories to validate together;
  5. calibrate a ``ServiceTimeModel`` from the same measured steptrace
     and require ``serve_calibration_check`` to hold: a saturated
     one-replica serve sim must reproduce the engine's per-chunk decode
     time within tolerance (the serve-side bridge).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b \\
      --smoke --trace 8 --trace-out T.json --steptrace-out S.json \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.trace_gate T.json S.json \\
      --device cpu

The trainer runs on the card unless ``--device cpu``. The exit status is
the number of failing stages (0: the gate passes).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from typing import Optional, Sequence

from repro_torch.configs.registry import get_smoke
from repro_torch.device import resolve_device
from repro_torch.fleet.bridge import serve_calibration_check
from repro_torch.fleet.perf import StepTimeModel, job_spec_from_trace
from repro_torch.fleet.sim import FleetConfig, FleetSimulator
from repro_torch.launch.train import build_trainer
from repro_torch.obs.steptrace import StepTrace
from repro_torch.obs.trace import (SpanTracer, merge_chrome_traces,
                                   validate_chrome_trace)
from repro_torch.resilience.driver import StragglerPolicy


def check(label: str, problems: list) -> int:
    if problems:
        print(f"FAILED [{label}]:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(f"ok [{label}]")
    return 0


def run_gate(trace: str, steptrace: str, device=None) -> dict:
    """The five stages over a serve run's ``trace`` and ``steptrace``
    files, each printed as it ends. Returns ``{"stages": {label:
    problems}, "calibration": serve_calibration_check's result}``; a stage
    passed when its list of problems is empty."""
    device = resolve_device(device)
    stages = {}

    def stage(label: str, problems: list) -> None:
        check(label, problems)
        stages[label] = list(problems)

    # 1. the serve run's request-lifecycle trace ----------------------------
    with open(trace) as f:
        serve_doc = json.load(f)
    stage("serve trace", validate_chrome_trace(
        serve_doc, require_cats=["serve"]))

    # 2. tiny real trainer sharing one tracer with the sim ------------------
    shared = SpanTracer()
    tmp = tempfile.mkdtemp(prefix="trace_gate_")
    try:
        trainer, state = build_trainer(
            get_smoke("qwen2_0_5b"), batch=2, seq=16, ckpt_dir=tmp,
            checkpoint_every=4, failures={5: 0}, tracer=shared,
            device=device)
        trainer.straggler = StragglerPolicy(threshold=float("inf"))
        trainer.run(state, 8)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 3. fleet sim driven by the MEASURED serve steptrace -------------------
    st = StepTrace.read(steptrace)
    model = StepTimeModel.from_trace(st)
    spec = job_spec_from_trace("measured", st, chips=64,
                               total_steps=24, checkpoint_every_steps=8)
    sim = FleetSimulator(
        FleetConfig(tpu="ironwood", total_cubes=2, host_mtbf_hours=None),
        [spec], tracer=shared)
    sim.run(100.0 * max(model.mean_step_s, 1e-3) * spec.total_steps + 10.0)
    job = sim.jobs["measured"]
    stage("steptrace-driven sim", [] if job.state == "done"
          else [f"sim job state {job.state!r}, wanted 'done' "
                f"(model mean {model.mean_step_s:.4f}s over "
                f"{len(model.durations)} measured chunks)"])
    print(f"  measured step model: {model.mean_step_s * 1e3:.1f}ms mean "
          f"over {len(model.durations)} chunks -> sim goodput "
          f"{job.ledger.goodput:.4f}")

    # 4. one timeline: serve + train + fleet --------------------------------
    merged = merge_chrome_traces([serve_doc, shared.chrome_trace()])
    stage("merged serve+train+fleet timeline",
          validate_chrome_trace(
              merged, require_cats=["serve", "train", "fleet"]))

    # 5. serve-side bridge: sim service times vs the measured trace ---------
    cal = serve_calibration_check(st)
    stage("serve calibration", [] if cal["ok"] == 1.0 else [
        f"sim per-chunk {cal['sim_chunk_s'] * 1e3:.2f}ms vs measured "
        f"{cal['measured_chunk_s'] * 1e3:.2f}ms (rel_err "
        f"{cal['rel_err']:.3f}, {cal['steady_admissions']:.0f} steady "
        f"admissions at batch {cal['target_batch']:.0f})"])
    print(f"  calibrated service model: rel_err {cal['rel_err']:.2e} "
          f"over {cal['steady_admissions']:.0f} admissions at batch "
          f"{cal['target_batch']:.0f}")
    return {"stages": stages, "calibration": cal}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="validate a serve run's trace and steptrace together "
                    "with a trainer's and a fleet simulation's spans")
    ap.add_argument("trace", help="the serve run's Chrome trace")
    ap.add_argument("steptrace", help="the serve run's steptrace")
    ap.add_argument("--device", default=None,
                    help="torch device of the trainer (default: the GPU; "
                         "'cpu' on request)")
    args = ap.parse_args(argv)
    out = run_gate(args.trace, args.steptrace, args.device)
    failures = sum(1 for problems in out["stages"].values() if problems)
    print("trace gate:", "FAILED" if failures else "PASSED")
    return failures


if __name__ == "__main__":
    sys.exit(main())
