"""Resilient training driver: failure injection, OCS map-out, elastic
re-mesh, straggler mitigation, goodput accounting.

This is the paper's §Resilience as an executable loop:

  detect (health checks / SDC screens / injected faults)
    -> map out the failed cube via the OCS scheduler (spare substitution)
    -> restore from the last checkpoint (elastic: the new slice may be
       smaller or larger; arrays re-shard on load)
    -> replay the deterministic pipeline from the restored step
    -> goodput ledger charges detection + restore + rework.

The "cluster" is simulated (FailurePlan injects failures at chosen steps;
step time is measured wall time), but every state transition (checkpoint,
scheduler substitution, restore, replay) is the real code path. The same
metric, span and ledger names as ``repro.resilience.driver``; a port step
ends with the one ``float(loss)`` host sync, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.goodput import GoodputLedger
from repro_torch.core.ocs import OCSPodScheduler
from repro_torch.data.pipeline import DataPipeline
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.steptrace import StepTrace
from repro_torch.obs.trace import SpanTracer

PyTree = Any


@dataclasses.dataclass
class FailurePlan:
    """Deterministic injected failures: step -> cube id that dies there."""

    failures: Dict[int, int] = dataclasses.field(default_factory=dict)
    detect_s: float = 0.05
    restore_extra_s: float = 0.05

    def failure_at(self, step: int) -> Optional[int]:
        return self.failures.get(step)


@dataclasses.dataclass
class StragglerPolicy:
    """Detect slow steps; after ``patience`` consecutive slow steps the
    driver reports the node for map-out (the paper's modular-isolation
    response to gray failures)."""

    threshold: float = 3.0  # x median step time
    patience: int = 3

    def __post_init__(self) -> None:
        self._times: List[float] = []
        self._slow = 0

    def observe(self, dt: float) -> bool:
        self._times.append(dt)
        if len(self._times) < 8:
            return False
        median = float(np.median(self._times[-50:]))
        if dt > self.threshold * median:
            self._slow += 1
        else:
            self._slow = 0
        return self._slow >= self.patience


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """One train_step execution, replayed or not.

    ``losses`` (the per-step effective trace) intentionally excludes
    replays so an interrupted run compares 1:1 against an uninterrupted
    one; ``records`` keeps every execution with its provenance for the
    goodput/rework post-mortem."""

    step: int
    loss: float
    replayed: bool = False
    duration_s: float = 0.0


@dataclasses.dataclass
class ResilientTrainer:
    train_step: Callable[[PyTree, Dict[str, Any]], Tuple[PyTree, Dict]]
    pipeline: DataPipeline
    ckpt: CheckpointManager
    scheduler: OCSPodScheduler
    job: str
    checkpoint_every: int = 20
    failure_plan: FailurePlan = dataclasses.field(default_factory=FailurePlan)
    straggler: StragglerPolicy = dataclasses.field(
        default_factory=StragglerPolicy)
    metrics: Optional[MetricsRegistry] = None  # None -> fresh enabled one
    tracer: Optional[SpanTracer] = None  # None -> disabled

    def __post_init__(self) -> None:
        # Telemetry is host-side: counters/spans around the (unchanged)
        # train_step calls, same phase names as the fleet sim's trace
        # ("train"/"rework"/"restore"/"detect"/"ckpt") so both render
        # alike in one timeline.
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        if self.tracer is None:
            self.tracer = SpanTracer(enabled=False)
        m = self.metrics
        self._m = {
            "steps": m.counter("train_steps"),
            "replayed": m.counter("train_replayed_steps"),
            "ckpts": m.counter("train_ckpt_saves"),
            "failures": m.counter("train_failures"),
            "restores": m.counter("train_restores"),
            "step_hist": m.histogram("train_step_s"),
        }
        self._trace_pid = self.tracer.process("train")

    def run(self, state: PyTree, num_steps: int,
            ledger: Optional[GoodputLedger] = None
            ) -> Tuple[PyTree, GoodputLedger, List[float]]:
        ledger = ledger or GoodputLedger()
        losses: List[float] = []
        self.records: List[StepRecord] = []
        step = int(state["step"])
        last_ckpt_step = self.ckpt.latest_step()
        if last_ckpt_step is None:
            # Bootstrap: the resilience contract says recovery always
            # restores from a checkpoint. Before the first periodic
            # snapshot exists, a failure would otherwise have nothing to
            # restore — write the starting state synchronously.
            t0 = time.monotonic()
            self.ckpt.save(step, state, blocking=True)
            dt = time.monotonic() - t0
            ledger.record_idle(dt, note="bootstrap ckpt")
            self._m["ckpts"].inc()
            self.tracer.complete("ckpt", dt, pid=self._trace_pid,
                                 tid=0, cat="train",
                                 args={"step": step, "bootstrap": True})
            last_ckpt_step = step
        while step < num_steps:
            cube = self.failure_plan.failure_at(step)
            if cube is not None:
                # ---- failure path: detect -> map out -> restore -> replay
                self._m["failures"].inc()
                self.tracer.instant("cube_fail", pid=self._trace_pid,
                                    tid=0, cat="train",
                                    args={"cube": cube, "step": step})
                ledger.record_detection(self.failure_plan.detect_s,
                                        note=f"cube {cube} died")
                self.tracer.complete("detect", self.failure_plan.detect_s,
                                     pid=self._trace_pid, tid=0,
                                     cat="train", args={"cube": cube})
                impacted = self.scheduler.fail_cube(cube)
                patched = self.scheduler.substitute(self.job) \
                    if impacted == self.job else None
                if impacted == self.job and patched is None:
                    raise RuntimeError(
                        "no spare cubes: job cannot continue")
                t0 = time.monotonic()
                # Flush any in-flight async snapshot BEFORE asking what the
                # latest checkpoint is: querying first races the writer
                # thread, and losing that race silently "replays" from an
                # older step than the state actually holds.
                self.ckpt.wait()
                restore_step = self.ckpt.latest_step()
                assert restore_step is not None  # bootstrap guarantees one
                state = self.ckpt.restore(restore_step, state)
                # restore() may have quarantined a corrupt checkpoint and
                # fallen back to an older one — re-anchor the replay range
                # on the step actually loaded or it silently starts late.
                restore_step = self.ckpt.last_restored_step
                last_ckpt_step = restore_step
                restore_dt = (time.monotonic() - t0
                              + self.failure_plan.restore_extra_s)
                ledger.record_restore(restore_dt)
                self._m["restores"].inc()
                self.tracer.complete("restore", restore_dt,
                                     pid=self._trace_pid, tid=0,
                                     cat="train",
                                     args={"from_step": restore_step})
                # rework: re-run steps since the checkpoint
                t0 = time.monotonic()
                for replay in range(restore_step, step):
                    batch = self.pipeline.batch_for_step(replay)
                    t1 = time.monotonic()
                    state, metrics = self.train_step(state, batch)
                    loss_r = float(metrics["loss"])
                    dt_r = time.monotonic() - t1
                    self._m["replayed"].inc()
                    self.tracer.complete("replay", dt_r,
                                         pid=self._trace_pid, tid=0,
                                         cat="train",
                                         args={"step": replay})
                    self.records.append(StepRecord(
                        step=replay, loss=loss_r, replayed=True,
                        duration_s=dt_r))
                ledger.record_rework(time.monotonic() - t0,
                                     steps=step - restore_step)
                # the failure is handled; do not re-trigger
                del self.failure_plan.failures[step]
                continue

            batch = self.pipeline.batch_for_step(step)
            t0 = time.monotonic()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            ledger.record_steps(dt, steps=1)
            losses.append(loss)
            self._m["steps"].inc()
            self._m["step_hist"].observe(dt)
            self.tracer.complete("step", dt, pid=self._trace_pid, tid=0,
                                 cat="train", args={"step": step})
            self.records.append(StepRecord(step=step, loss=loss,
                                           duration_s=dt))
            if self.straggler.observe(dt):
                ledger.record_idle(0.0, note="straggler flagged for map-out")
            step += 1
            if step % self.checkpoint_every == 0:
                if state["step"].is_cuda:
                    torch.cuda.synchronize(state["step"].device)
                t0 = time.monotonic()
                self.ckpt.save(step, state)  # async
                dt = time.monotonic() - t0
                ledger.record_idle(dt, note="ckpt snapshot")
                self._m["ckpts"].inc()
                self.tracer.complete("ckpt", dt, pid=self._trace_pid,
                                     tid=0, cat="train",
                                     args={"step": step})
                last_ckpt_step = step
        self.ckpt.wait()
        return state, ledger, losses

    def replay_summary(self) -> Dict[str, int]:
        """Execution counts from the StepRecord ledger: how many
        train_step calls ran in total, how many were replays (rework
        after a restore), and the effective (non-replayed) count.

        ``rescales`` keeps the key set aligned with the fleet
        simulator's elastic ledger (``FleetSimulator.fleet_summary``):
        the real trainer always restores at full scale — OCS spare
        substitution, never a smaller slice — so it is constitutionally
        zero here, and nonzero only in the sim's elastic arm."""
        recs = getattr(self, "records", [])
        replayed = sum(1 for r in recs if r.replayed)
        return {
            "executions": len(recs),
            "replayed_steps": replayed,
            "effective_steps": len(recs) - replayed,
            "rescales": 0,
        }

    def steptrace(self) -> StepTrace:
        """The run's measured step-time trace: one "step" event per
        effective execution, one "replay" per rework execution, with
        wall durations — the artifact
        ``fleet.perf.StepTimeModel.from_trace`` replays through the
        simulator."""
        tr = StepTrace(source="train", meta={"job": self.job})
        for r in getattr(self, "records", []):
            tr.record("replay" if r.replayed else "step",
                      r.duration_s, step=r.step)
        return tr
