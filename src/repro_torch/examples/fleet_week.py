"""A week on an Ironwood pod (the port of ``examples/fleet_week.py``):
four 2K-chip jobs, 16 spare cubes, stochastic host failures, SDC screens,
OCS reconfigurations, elastic re-scale when spares run out, synchronous
checkpoint writes contending for the shared filer, and roofline-fed step
times — the paper's fleet story end to end, with a Chrome trace you can
load in chrome://tracing or ui.perfetto.dev.

    PYTHONPATH=src python -m repro_torch.examples.fleet_week \\
        [--days 7] [--trace /tmp/fleet_week_trace.json] \\
        [--scale-policy shrink|queue] [--ckpt-write-s 0] [--roofline]

The simulator is pure Python: it needs no device. Its figures are the
paper's TPU models (Table 1, Figure 6), not measurements of this machine.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List, Optional, Sequence

from repro_torch.core import hwspec
from repro_torch.core.sdc import SDCRateModel
from repro_torch.fleet import (FleetConfig, FleetSimulator, JobSpec,
                               PowerModel, TrainWorkload,
                               job_spec_from_roofline)


def pod_config(seed: int = 3, ckpt_write_s: float = 0.0) -> FleetConfig:
    """The week's pod: 144 Ironwood cubes, a 2000 h host MTBF, 4 h
    repairs, and an SDC screen every 600 s."""
    return FleetConfig(
        tpu="ironwood", total_cubes=144, host_mtbf_hours=2000.0,
        repair_hours=4.0, detect_s=30.0, restore_s=120.0,
        ckpt_write_s=ckpt_write_s,
        sdc=SDCRateModel(rate_per_chip_hour=2e-6, screen_interval_s=600.0,
                         screen_coverage=0.8),
        seed=seed)


def pod_jobs(scale_policy: str = "shrink",
             roofline: bool = False) -> List[JobSpec]:
    """The week's four 2048-chip jobs, ``job0`` to ``job3``: a 1 s step,
    or the roofline's step of a 70B dense model when ``roofline``."""
    if roofline:
        # a 70B dense model at a 16M-token global batch; the elastic arm
        # follows the Ironwood scaling curve when it shrinks
        wl = TrainWorkload(n_params=70e9, tokens_per_step=4096 * 4096)
        return [job_spec_from_roofline(
            f"job{i}", "ironwood", wl, chips=2048, total_steps=10**9,
            checkpoint_every_steps=600, scale_policy=scale_policy,
            min_cubes=8) for i in range(4)]
    return [JobSpec(name=f"job{i}", chips=2048, total_steps=10**9,
                    step_time_s=1.0, checkpoint_every_steps=600,
                    scale_policy=scale_policy, min_cubes=8)
            for i in range(4)]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=7.0)
    ap.add_argument("--trace", default=os.path.join(
        tempfile.gettempdir(), "fleet_week_trace.json"))
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--scale-policy", choices=("queue", "shrink"),
                    default="shrink",
                    help="what starvation does: queue for repairs, or "
                         "re-scale to a smaller slice (paper arm)")
    ap.add_argument("--ckpt-write-s", type=float, default=0.0,
                    help="synchronous checkpoint write stall; co-located "
                         "writers contend for shared bandwidth (0=async)")
    ap.add_argument("--roofline", action="store_true",
                    help="price step times from the roofline "
                         "(fleet.perf) instead of the 1 s constant")
    args = ap.parse_args(argv)

    cfg = pod_config(args.seed, args.ckpt_write_s)
    jobs = pod_jobs(args.scale_policy, args.roofline)
    sim = FleetSimulator(cfg, jobs)
    sim.run(args.days * 86400.0)

    print(f"=== {args.days:g} simulated days on an Ironwood pod "
          f"(144 cubes, 4 x 2048-chip jobs, 16 spares, "
          f"policy={args.scale_policy}) ===")
    fs = sim.fleet_summary()
    print("fleet:", {k: round(v, 4) for k, v in fs.items()})
    pm = PowerModel(hwspec.get(cfg.tpu))
    for name, job in sim.jobs.items():
        s = job.ledger.summary()
        p = pm.job_summary(job.ledger, job.spec.chips)
        # rework steps are the sim's replayed_steps: same reading as the
        # real trainer's replay ledger in launch/train.py output
        replayed = sum(e.steps for e in job.ledger.events
                       if e.kind == "rework")
        print(f"  {name}: goodput={s['goodput']:.4f} "
              f"steps={job.base_step} replayed_steps={replayed} "
              f"rescales={job.rescales} grow_backs={job.grow_backs} "
              f"cubes={job.cubes}/{job.spec.full_cubes} "
              f"step_time={job.step_time_s:.2f}s "
              f"energy={p['energy_kwh']:.0f}kWh "
              f"gCO2e/EFLOP={p.get('gco2e_per_eflop', float('nan')):.1f}")
    sim.trace.write(args.trace)
    print(f"chrome trace ({len(sim.trace.events)} events) -> {args.trace}")


if __name__ == "__main__":
    main()
