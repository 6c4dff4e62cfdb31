"""Discrete-event fleet simulator: many jobs, one pod, days of sim time.

The executable composition of the paper's resilience story:

  host/cube failures (Poisson per cube, scaled from per-host MTBF)
    -> detect -> OCS spare substitution via the *real* ``OCSPodScheduler``
    -> restore from the last checkpoint -> rework the lost steps
    -> per-job ``GoodputLedger`` charges, same event grammar as the real
       ``ResilientTrainer`` (fleet/bridge.py pins the agreement);

  silent data corruption (``core.sdc.SDCRateModel``)
    -> detected by a later sampled screen -> roll back to the last
       checkpoint *before the corruption* (later snapshots are poisoned)
    -> map out the offending cube;

  no spares -> the paper's two arms, selected per job by
  ``JobSpec.scale_policy``:

    * ``"queue"``  — the job releases its slice, queues, and is
      re-admitted (restore + rework) when a repair or completion frees
      cubes;
    * ``"shrink"`` — the job is *rescheduled at smaller scale*: it keeps
      running on the largest schedulable slice >= ``min_cubes``, its step
      time re-scaled by the job's slice-size curve (roofline-fed via
      ``fleet.perf``, or ideal-linear), and it grows back to full size
      opportunistically when repairs or completions free cubes. Every
      re-scale is ledgered inside the same five-kind grammar the bridge
      pins (an ``idle`` marker plus the usual restore/rework charges).

Checkpoint writes are free (asynchronous, the repo's
``CheckpointManager`` behavior) unless ``FleetConfig.ckpt_write_s`` is
set: then every snapshot stalls the job synchronously, concurrent
writers contend for the shared filer bandwidth (a write that starts
while k others are in flight takes (k+1)x the uncontended time), and a
snapshot only becomes durable when its write *completes* — a failure
mid-write rolls back to the previous checkpoint.

Serve jobs (``fleet.serve_jobs``) run alongside: open-loop request
arrivals (``serve_session``/``serve_req`` events) feed per-replica
queues whose service times come from a steptrace-calibrated
``ServiceTimeModel``; replicas are OCS allocations (``"job/rK"``) that
take cube failures like any training slice (substitution or teardown)
and autoscale against queue depth / SLO violations (``serve_ctl``),
contending with training jobs for cubes. Their ledgers speak the same
five-kind grammar — SLO-good busy time is ``steps``, violating busy
time is ``rework`` — so goodput and power/carbon pipelines need no new
vocabulary.

Progress is step-quantized but simulated analytically — between events a
job's step count is a closed-form function of time, so a week of
simulated pod time costs thousands of events, not billions of steps.
``contiguous=True`` runs the same fleet against pre-OCS (TPU v2/v3)
scheduling semantics: no substitution, rectangular-block allocation.
``install_schedule`` models incremental deployment (paper: each cube
enters production as soon as it is installed).

This is the port's copy of ``repro.fleet.sim``, behaviour unchanged:
the same seeds give the same ledgers, stats and Chrome trace, byte for
byte, including the reference's unrefunded recovery window when a second
failure lands inside the first one's (``_handle_job_failure``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import hwspec
from repro_torch.core.ocs import OCSPodScheduler
from repro_torch.core.sdc import SDCRateModel
from repro_torch.core.topology import CUBE
from repro_torch.fleet.events import Event, EventEngine
from repro_torch.fleet.jobs import JobRuntime, JobSpec
from repro_torch.fleet.serve_jobs import (ServeJobRuntime, ServeJobSpec,
                                          ServeReplica)
from repro_torch.fleet.trace import TraceRecorder


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    tpu: str = "tpu_v4"
    total_cubes: int = 64
    host_mtbf_hours: Optional[float] = None  # None: planned failures only
    repair_hours: float = 4.0
    detect_s: float = 30.0
    restore_s: float = 120.0
    reconfig_s: float = 10.0  # OCS substitution latency, folded into restore
    ckpt_write_s: float = 0.0  # synchronous write stall; 0 = async writes
    sdc: Optional[SDCRateModel] = None
    contiguous: bool = False  # pre-OCS (TPU v2/v3) scheduling semantics
    # incremental deployment: (sim time, installed cube count) waypoints;
    # empty = the whole pod is installed from t=0
    install_schedule: Tuple[Tuple[float, int], ...] = ()
    seed: int = 0

    def __post_init__(self) -> None:
        if self.ckpt_write_s < 0.0:
            raise ValueError("ckpt_write_s must be >= 0")
        last_t, last_n = -1.0, 0
        for t, n in self.install_schedule:
            if t < 0.0 or t <= last_t:
                raise ValueError("install_schedule times must increase")
            if n < last_n or n > self.total_cubes:
                raise ValueError("install_schedule counts must be "
                                 "nondecreasing and <= total_cubes")
            last_t, last_n = t, n


class FleetSimulator:
    def __init__(self, cfg: FleetConfig, jobs: Sequence[JobSpec],
                 *, serve_jobs: Sequence[ServeJobSpec] = (), tracer=None):
        names = [j.name for j in jobs] + [s.name for s in serve_jobs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate job names")
        self.cfg = cfg
        self.spec = hwspec.get(cfg.tpu)
        self.engine = EventEngine(cfg.seed)
        self.sched = OCSPodScheduler(cfg.total_cubes,
                                     contiguous=cfg.contiguous)
        # pass a shared obs.trace.SpanTracer to land sim events in the
        # same timeline as serve/train spans (launch/trace_gate.py)
        self.trace = TraceRecorder(tracer=tracer)
        self.jobs: Dict[str, JobRuntime] = {
            j.name: JobRuntime(spec=j) for j in jobs}
        self.serve: Dict[str, ServeJobRuntime] = {
            s.name: ServeJobRuntime(spec=s) for s in serve_jobs}
        self._replica_owner: Dict[str, str] = {}  # alloc name -> serve job
        self.stats = {"cube_failures": 0, "repairs": 0, "starvations": 0,
                      "rescales": 0, "grow_backs": 0,
                      "sdc_corruptions": 0, "sdc_detections": 0}
        self._fail_ev: Dict[int, Event] = {}
        self._writes: Dict[str, float] = {}  # job -> in-flight write end
        self._hosts_per_cube = max(1, CUBE.chips // self.spec.tpus_per_host)
        for j in jobs:
            self.engine.schedule_at(j.arrival_s, "arrival", job=j.name)
        for rt in self.serve.values():
            # a per-job RNG keyed on (fleet seed, job name) keeps the
            # request trace identical across autoscale policies and
            # independent of the failure draws below
            rt.seed_rng(cfg.seed)
            self.engine.schedule_at(rt.spec.arrival_s, "serve_live",
                                    job=rt.spec.name)
        if cfg.install_schedule:
            # nothing is installed until the first waypoint lands
            self.sched.set_installed(())
            for t, n in cfg.install_schedule:
                self.engine.schedule_at(t, "install", count=n)
        if cfg.host_mtbf_hours is not None:
            for cube in range(cfg.total_cubes):
                self._schedule_cube_failure(cube)

    # -------------------------------------------------------------- helpers

    @property
    def _cube_mtbf_s(self) -> float:
        assert self.cfg.host_mtbf_hours is not None
        return self.cfg.host_mtbf_hours * 3600.0 / self._hosts_per_cube

    def _schedule_cube_failure(self, cube: int) -> None:
        delay = self.engine.draw_exponential(self._cube_mtbf_s)
        self._fail_ev[cube] = self.engine.schedule(
            delay, "cube_fail", cube=cube)

    def _settle_ckpt(self, job: JobRuntime, t: float) -> None:
        """A synchronous snapshot becomes durable only once its write
        completes; settle the bookkeeping before anything reads
        ``last_ckpt_step`` at time ``t``."""
        if job.ckpt_write_end is not None and t >= job.ckpt_write_end:
            job.last_ckpt_step = job.ckpt_write_step
            job.ckpt_write_end = None

    def _start_write(self, job: JobRuntime, now: float) -> Tuple[float, int]:
        """Register a synchronous write against the shared filer: a write
        starting while k others are in flight takes (k+1)x the
        uncontended time (already-started writes keep their end times).
        Returns (stall seconds, concurrent writer count)."""
        name = job.spec.name
        self._writes = {j: t for j, t in self._writes.items()
                        if t > now and j != name}
        n = len(self._writes) + 1
        dur = self.cfg.ckpt_write_s * n
        self._writes[name] = now + dur
        return dur, n

    def _abort_write(self, job: JobRuntime) -> None:
        """An in-flight write dies with its slice (failure) or its
        snapshot (SDC poisoning): it must also stop occupying the shared
        filer bandwidth later writers contend for."""
        if job.ckpt_write_end is not None:
            self._writes.pop(job.spec.name, None)
            job.ckpt_write_end = None

    def _charge_progress(self, job: JobRuntime, target: int) -> None:
        """Record productive steps base_step..target on the ledger, with
        an idle checkpoint mark at every absolute boundary crossed —
        exactly the grammar the ResilientTrainer's main loop produces.
        Boundaries are strictly greater than base_step: a segment that
        starts at a restored step does not re-snapshot it.

        With synchronous writes (``ckpt_write_s > 0``) boundary marks are
        event-driven instead (``ckpt_write`` events re-segment the
        timeline at every boundary), so this only charges whole steps."""
        st = job.step_time_s
        every = job.spec.checkpoint_every_steps
        cur = job.base_step
        t0 = job.segment_start

        def run_steps(upto: int) -> None:
            nonlocal cur, t0
            k = upto - cur
            if k > 0:
                job.ledger.record_steps(k * st, steps=k)
                self.trace.duration(job.spec.name, "train", t0, k * st,
                                    args={"steps": f"{cur}..{upto}"})
                cur, t0 = upto, t0 + k * st

        if self.cfg.ckpt_write_s <= 0.0:
            next_b = (cur // every + 1) * every
            while next_b <= target:
                run_steps(next_b)
                job.ledger.record_idle(0.0, note=f"ckpt @{next_b}")
                self.trace.duration(job.spec.name, "ckpt", t0, 0.0,
                                    args={"step": next_b})
                job.last_ckpt_step = next_b
                next_b += every
        run_steps(target)
        job.base_step = cur
        job.segment_start = t0

    def _schedule_segment(self, job: JobRuntime) -> None:
        """(Re)issue the job's timeline events from the current segment.
        Bumps the epoch so events from the previous timeline are stale."""
        job.epoch += 1
        spec, e = job.spec, job.epoch
        st = job.step_time_s
        t_done = job.segment_start + (spec.total_steps - job.base_step) * st
        self.engine.schedule_at(t_done, "complete", job=spec.name, epoch=e)
        if self.cfg.ckpt_write_s > 0.0:
            every = spec.checkpoint_every_steps
            next_b = (job.base_step // every + 1) * every
            if next_b < spec.total_steps:
                t = job.segment_start + (next_b - job.base_step) * st
                self.engine.schedule_at(t, "ckpt_write", job=spec.name,
                                        step=next_b, epoch=e)
        planned = job.next_planned_failure()
        if planned is not None and planned[0] >= job.base_step:
            step, cube = planned
            t = job.segment_start + (step - job.base_step) * st
            self.engine.schedule_at(t, "plan_fail", job=spec.name,
                                    step=step, cube=cube, epoch=e)
        if self.cfg.sdc is not None:
            if job.sdc_corrupt_step is not None:
                # an undetected corruption survived a fail-stop restore
                # (the snapshot postdated it): re-arm its detection for
                # the new timeline
                delay = self.cfg.sdc.draw_detection_delay_s(
                    self.engine.rng)
                t = max(self.engine.now, job.segment_start) + delay
                self.engine.schedule_at(t, "sdc_detect", job=spec.name,
                                        epoch=e)
            else:
                dt = self.cfg.sdc.draw_time_to_corruption_s(
                    self.engine.rng, spec.chips)
                if dt != float("inf"):
                    t = max(self.engine.now, job.segment_start) + dt
                    self.engine.schedule_at(t, "sdc_corrupt",
                                            job=spec.name, epoch=e)

    # ------------------------------------------------------------ admission

    def _try_admit(self, job: JobRuntime) -> bool:
        now = self.engine.now
        spec = job.spec
        alloc = self.sched.allocate(spec.name, spec.chips)
        cubes = spec.full_cubes
        if alloc is None and spec.elastic:
            # elastic admission: take the largest schedulable slice at or
            # above the job's floor rather than waiting for full size
            n = self.sched.max_slice_cubes(spec.full_cubes - 1)
            if n >= spec.min_cubes:
                alloc = self.sched.allocate(spec.name, n * CUBE.chips)
                cubes = n
        if alloc is None:
            if job.state != "queued":
                job.state = "queued"
                job.queued_since = now
            return False
        job.alloc = alloc
        job.set_scale(cubes)
        if job.first_admitted_at is None:
            job.first_admitted_at = now
        wait = now - job.queued_since if job.state == "queued" else 0.0
        if wait > 0.0:
            job.ledger.record_idle(wait, note="queued for cubes")
            self.trace.duration(job.spec.name, "queued", now - wait, wait)
        if cubes < spec.full_cubes:
            job.rescales += 1
            self.stats["rescales"] += 1
            job.ledger.record_idle(
                0.0, note=f"re-scale to {cubes}/{spec.full_cubes} cubes")
            self.trace.instant("re-scale", now, {
                "job": spec.name, "cubes": f"{cubes}/{spec.full_cubes}"})
        st = job.step_time_s
        if job.pending_resume_step is None:
            # fresh start: the resilience contract's bootstrap snapshot
            job.ledger.record_idle(0.0, note="bootstrap ckpt")
            job.base_step = 0
            job.last_ckpt_step = 0
            job.segment_start = now
        else:
            rework = job.pending_resume_step - job.last_ckpt_step
            job.ledger.record_restore(self.cfg.restore_s,
                                      note="restore after starvation")
            job.ledger.record_rework(rework * st, steps=rework)
            self.trace.duration(job.spec.name, "restore", now,
                                self.cfg.restore_s)
            self.trace.duration(job.spec.name, "rework",
                                now + self.cfg.restore_s, rework * st)
            job.base_step = job.pending_resume_step
            job.segment_start = now + self.cfg.restore_s + rework * st
            job.pending_resume_step = None
        job.state = "running"
        self._schedule_segment(job)
        self.trace.counter("pod", now, {"spare_cubes":
                                        self.sched.spare_cubes()})
        return True

    def _admit_queued(self) -> None:
        queued = sorted((j for j in self.jobs.values()
                         if j.state == "queued"),
                        key=lambda j: (j.queued_since, j.spec.name))
        for job in queued:
            self._try_admit(job)

    def _try_grow(self) -> None:
        """Opportunistic grow-back (elastic jobs only): when capacity
        frees up — after queued jobs have had their chance — every job
        running shrunken tries to return to full size. Growth is
        all-or-nothing (partial regrows would pay the restart cost
        repeatedly) and graceful: snapshot the current step, re-shard
        across the grown slice (a restore charge), no rework."""
        shrunken = sorted((j for j in self.jobs.values() if j.shrunken),
                          key=lambda j: j.spec.name)
        for job in shrunken:
            now = self.engine.now
            spec = job.spec
            if job.ckpt_write_end is not None and job.ckpt_write_end > now:
                continue  # let the in-flight snapshot finish first
            grown = self.sched.grow(spec.name, spec.full_cubes - job.cubes)
            if grown is None:
                continue
            self._settle_ckpt(job, now)
            steps_now = job.steps_at(now)
            self._charge_progress(job, steps_now)
            # the in-flight step fraction is abandoned by the re-shard:
            # charge it with the snapshot (it is wall time already spent)
            # but only the write itself delays the new timeline
            partial = min(max(now - job.segment_start, 0.0),
                          job.step_time_s)
            prev = job.cubes
            job.alloc = grown
            job.set_scale(spec.full_cubes)
            job.grow_backs += 1
            self.stats["grow_backs"] += 1
            if self.cfg.ckpt_write_s > 0.0:
                # the pre-grow snapshot is a synchronous write like any
                # other: it contends for the filer and is durable only
                # once it completes
                write, _ = self._start_write(job, now)
                job.ckpt_write_end = now + write
                job.ckpt_write_step = steps_now
            else:
                write = 0.0
                job.last_ckpt_step = steps_now
            job.ledger.record_idle(write + partial,
                                   note=f"ckpt @{steps_now} (pre-grow)")
            restore = self.cfg.reconfig_s + self.cfg.restore_s
            job.ledger.record_idle(
                0.0, note=f"re-scale {prev}->{spec.full_cubes} cubes")
            job.ledger.record_restore(restore, note="grow-back restore")
            self.trace.instant("re-scale", now, {
                "job": spec.name,
                "cubes": f"{prev}->{spec.full_cubes}"})
            self.trace.duration(spec.name, "restore", now + write, restore)
            job.base_step = steps_now
            job.segment_start = now + write + restore
            self._schedule_segment(job)
            self.trace.counter("pod", now, {"spare_cubes":
                                            self.sched.spare_cubes()})

    # ------------------------------------------------------------- failures

    def _starve_or_shrink(self, job: JobRuntime, steps_now: int,
                          note: str) -> None:
        """No spares for a substitution. The queue arm releases the slice
        and waits; the elastic arm re-allocates the largest schedulable
        slice >= min_cubes right away and restores onto it (the paper's
        "rescheduled at smaller scale"). Both charge restore + rework
        exactly once — here for the shrink, at re-admission for the
        queue."""
        now = self.engine.now
        cfg = self.cfg
        spec = job.spec
        self.sched.release(spec.name)
        job.alloc = None
        if spec.elastic:
            n = self.sched.max_slice_cubes(spec.full_cubes)
            if n >= spec.min_cubes:
                prev = job.cubes
                alloc = self.sched.allocate(spec.name, n * CUBE.chips)
                assert alloc is not None and len(alloc.cubes) == n
                job.alloc = alloc
                job.set_scale(n)
                job.rescales += 1
                self.stats["rescales"] += 1
                st = job.step_time_s
                restore = cfg.reconfig_s + cfg.restore_s
                rework = steps_now - job.last_ckpt_step
                job.ledger.record_idle(
                    0.0, note=f"re-scale {prev}->{n} cubes")
                job.ledger.record_restore(restore,
                                          note=f"re-scale restore ({note})")
                job.ledger.record_rework(rework * st, steps=rework)
                t = now + cfg.detect_s
                self.trace.instant("re-scale", now, {
                    "job": spec.name, "cubes": f"{prev}->{n}"})
                self.trace.duration(spec.name, "restore", t, restore)
                self.trace.duration(spec.name, "rework", t + restore,
                                    rework * st)
                job.base_step = steps_now
                job.segment_start = t + restore + rework * st
                self._schedule_segment(job)
                self.trace.counter("pod", now, {"spare_cubes":
                                                self.sched.spare_cubes()})
                return
        # queue arm: only detection is on the books so far; restore +
        # rework are charged once, at re-admission. The queue clock
        # starts after the detection window so the charges never overlap.
        job.pending_resume_step = steps_now
        job.state = "queued"
        job.queued_since = now + cfg.detect_s
        job.epoch += 1  # timeline events are void
        self.stats["starvations"] += 1
        self.trace.instant("starved", now, {"job": spec.name})
        self._admit_queued()  # the freed cubes may fit a smaller job
        self._try_grow()  # ...or return a shrunken job to full size

    def _handle_job_failure(self, job: JobRuntime, cube: int,
                            note: str) -> None:
        now = self.engine.now
        cfg = self.cfg
        st = job.step_time_s
        self._settle_ckpt(job, now)
        steps_now = job.steps_at(now)
        self._charge_progress(job, steps_now)
        self._abort_write(job)  # a write in flight is lost with the slice
        # a stochastic failure lands mid-step: the aborted in-flight
        # fraction is wall time too, folded into the detection charge
        # (zero for planned failures, which fire on step boundaries)
        partial = min(max(now - job.segment_start, 0.0), st)
        job.ledger.record_detection(cfg.detect_s + partial, note=note)
        self.trace.duration(job.spec.name, "detect", now, cfg.detect_s)
        if job.sdc_corrupt_step is not None and \
                job.last_ckpt_step <= job.sdc_corrupt_step:
            # the fail-stop restore rolls back past the corruption point:
            # the corrupted state really is wiped. (A snapshot *after*
            # the corruption is poisoned — then the corruption survives
            # the restore and _schedule_segment re-arms its detection.)
            job.sdc_corrupt_step = None
        patched = self.sched.substitute(job.spec.name)
        if patched is None:
            # no spares (or pre-OCS pod): shrink or queue, per policy
            self._starve_or_shrink(job, steps_now, note)
            return
        job.alloc = patched
        restore = cfg.reconfig_s + cfg.restore_s
        rework = steps_now - job.last_ckpt_step
        job.ledger.record_restore(restore, note="ocs reconfig + restore")
        job.ledger.record_rework(rework * st, steps=rework)
        t = now + cfg.detect_s
        self.trace.duration(job.spec.name, "restore", t, restore)
        self.trace.duration(job.spec.name, "rework", t + restore,
                            rework * st)
        self.trace.instant("ocs_reconfig", now,
                           {"job": job.spec.name, "cube": cube})
        job.base_step = steps_now
        job.segment_start = t + restore + rework * st
        self._schedule_segment(job)

    # ------------------------------------------------------------ serve jobs

    def _serve_add_replica(self, rt: ServeJobRuntime) -> bool:
        """Allocate one more replica slice through the same OCS scheduler
        training jobs use — serve capacity *contends*. Returns False
        (and counts a blocked scale) when no slice fits."""
        now = self.engine.now
        spec = rt.spec
        idx = rt.next_replica
        name = f"{spec.name}/r{idx}"
        alloc = self.sched.allocate(name, spec.chips)
        if alloc is None:
            rt.scale_blocked += 1
            return False
        rt.next_replica += 1
        ready = now + spec.spinup_s
        rt.replicas[name] = ServeReplica(
            idx=idx, name=name, alloc=alloc, ready_at=ready, last_t=ready)
        self._replica_owner[name] = spec.name
        rt.peak_replicas = max(rt.peak_replicas, len(rt.replicas))
        if spec.spinup_s > 0:
            rt.ledger.record_restore(spec.spinup_s,
                                     note=f"{name} spin-up")
            self.trace.duration(name, "restore", now, spec.spinup_s)
        self.trace.instant("serve_scale", now, {
            "job": spec.name, "replica": name, "dir": "up"})
        self.engine.schedule_at(ready, "serve_ready", job=spec.name,
                                replica=name)
        return True

    def _serve_retire(self, rt: ServeJobRuntime, rep: ServeReplica) -> None:
        """Release a replica's slice back to the pod and give waiting
        training jobs their chance at the freed cubes."""
        rt.retire_replica(rep, self.engine.now)
        self.sched.release(rep.name)
        self._replica_owner.pop(rep.name, None)
        self._admit_queued()
        self._try_grow()

    def _serve_drain_queue(self, rt: ServeJobRuntime) -> None:
        now = self.engine.now
        while rt.queue:
            if rt.should_shed(rt.queue[0], now):
                req = rt.queue.pop(0)
                rt.shed_request(req)
                self.trace.instant("serve_shed", now, {
                    "job": rt.spec.name, "rid": req.rid})
                continue
            rep = rt.pick_replica(now)
            if rep is None:
                return
            self._serve_start(rt, rep, rt.queue.pop(0))

    def _serve_start(self, rt: ServeJobRuntime, rep: ServeReplica,
                     req) -> None:
        payload = rt.start_service(rep, req, self.engine.now)
        self.engine.schedule_at(float(payload["done"]), "serve_done",
                                **payload)

    def _handle_replica_failure(self, rt: ServeJobRuntime, repname: str,
                                cube: int, note: str) -> None:
        """A cube under a serve replica died. In-flight requests requeue
        (their arrival clocks keep running — the disruption lands in
        TTFT), then OCS substitution: a spare patches the slice and the
        replica reloads (detect + reconfig + restore, excluded from
        busy/idle); no spares tears the replica down — the control loop
        may re-add one later."""
        now = self.engine.now
        cfg = self.cfg
        rt.settle(now)
        rep = rt.replicas[repname]
        rt.requeue_inflight(rep)
        rt.ledger.record_detection(cfg.detect_s, note=note)
        self.trace.duration(repname, "detect", now, cfg.detect_s)
        patched = self.sched.substitute(repname)
        if patched is not None:
            restore = cfg.reconfig_s + cfg.restore_s
            rep.alloc = patched
            rep.ready_at = now + cfg.detect_s + restore
            rep.last_t = rep.ready_at
            rt.ledger.record_restore(restore,
                                     note="replica ocs reconfig + reload")
            self.trace.duration(repname, "restore", now + cfg.detect_s,
                                restore)
            self.engine.schedule_at(rep.ready_at, "serve_ready",
                                    job=rt.spec.name, replica=repname)
        else:
            rt.replicas_lost += 1
            self.trace.instant("serve_replica_lost", now, {
                "job": rt.spec.name, "replica": repname})
            self._serve_retire(rt, rep)
        self._serve_drain_queue(rt)

    def _route_failure(self, impacted: Optional[str], cube: int,
                       note: str) -> None:
        """Failures land on whoever owns the cube: a training job or a
        serve replica (allocation names ``job/rK``)."""
        if impacted is None:
            return
        owner = self._replica_owner.get(impacted)
        if owner is not None:
            self._handle_replica_failure(self.serve[owner], impacted,
                                         cube, note)
        else:
            self._handle_job_failure(self.jobs[impacted], cube, note=note)

    def _on_serve_live(self, ev: Event) -> None:
        rt = self.serve[ev["job"]]
        rt.state = "live"
        for _ in range(rt.spec.replicas):
            self._serve_add_replica(rt)
        self._schedule_next_session(rt, self.engine.now)
        self.engine.schedule(rt.spec.control_interval_s, "serve_ctl",
                             job=rt.spec.name)

    def _schedule_next_session(self, rt: ServeJobRuntime,
                               t: float) -> None:
        nxt = rt.draw_next_session_t(t)
        self.engine.schedule_at(nxt, "serve_session", job=rt.spec.name,
                                t=nxt)

    def _on_serve_session(self, ev: Event) -> None:
        rt = self.serve[ev["job"]]
        t0 = ev["t"]
        for req in rt.build_session(t0):
            self.engine.schedule_at(req.arrival_s, "serve_req",
                                    job=rt.spec.name, req=req)
        self._schedule_next_session(rt, t0)

    def _on_serve_req(self, ev: Event) -> None:
        rt = self.serve[ev["job"]]
        rt.arrived += 1
        rt.queue.append(ev["req"])  # FIFO through the central queue
        self._serve_drain_queue(rt)

    def _on_serve_done(self, ev: Event) -> None:
        rt = self.serve[ev["job"]]
        rep = rt.finish_service(ev.payload, self.engine.now)
        if rep is not None:
            self._serve_drain_queue(rt)

    def _on_serve_ready(self, ev: Event) -> None:
        rt = self.serve[ev["job"]]
        rep = rt.replicas.get(ev["replica"])
        if rep is None or rep.ready_at > self.engine.now:
            return  # torn down, or superseded by a failure re-arm
        self._serve_drain_queue(rt)

    def _on_serve_ctl(self, ev: Event) -> None:
        """Autoscale control tick: settle the ledger window, then act on
        queue depth / SLO violations (see ServeJobRuntime
        .scale_decision)."""
        rt = self.serve[ev["job"]]
        now = self.engine.now
        rt.settle(now)
        decision = rt.scale_decision(now)
        if decision == "up":
            if self._serve_add_replica(rt):
                rt.scale_ups += 1
        elif decision == "down":
            rep = rt.idle_replica(now)
            if rep is not None:
                rt.scale_downs += 1
                self.trace.instant("serve_scale", now, {
                    "job": rt.spec.name, "replica": rep.name,
                    "dir": "down"})
                self._serve_retire(rt, rep)
        rt.viol_since_tick = 0
        self.trace.counter(f"serve:{rt.spec.name}", now, {
            "replicas": float(len(rt.replicas)),
            "queue_depth": float(len(rt.queue))})
        self.engine.schedule(rt.spec.control_interval_s, "serve_ctl",
                             job=rt.spec.name)

    # -------------------------------------------------------------- handlers

    def _on_arrival(self, ev: Event) -> None:
        job = self.jobs[ev["job"]]
        job.queued_since = self.engine.now
        self._try_admit(job)

    def _on_complete(self, ev: Event) -> None:
        job = self.jobs[ev["job"]]
        if ev["epoch"] != job.epoch or job.state != "running":
            return
        self._charge_progress(job, job.spec.total_steps)
        job.state = "done"
        job.completed_at = self.engine.now
        self.sched.release(job.spec.name)
        job.alloc = None
        self.trace.instant("job_done", self.engine.now,
                           {"job": job.spec.name})
        self._admit_queued()
        self._try_grow()

    def _on_cube_fail(self, ev: Event) -> None:
        cube = ev["cube"]
        self._fail_ev.pop(cube, None)
        if cube in self.sched.failed_cubes:
            return  # already down (SDC map-out); repair will redraw
        self.stats["cube_failures"] += 1
        # the cube-level Poisson process aggregates its hosts' hazards;
        # pick which host actually died and map out through the
        # host-granular entry point (the paper's primary hazard)
        host = cube * self._hosts_per_cube + int(
            self.engine.rng.integers(self._hosts_per_cube))
        _, impacted = self.sched.fail_host(host, self.spec.tpus_per_host)
        self.trace.instant("cube_fail", self.engine.now,
                           {"cube": cube, "host": host})
        self.engine.schedule(self.cfg.repair_hours * 3600.0, "repair",
                             cube=cube)
        self._route_failure(impacted, cube, note=f"cube {cube} died")

    def _on_plan_fail(self, ev: Event) -> None:
        job = self.jobs[ev["job"]]
        if ev["epoch"] != job.epoch or job.state != "running":
            return
        step = ev["step"]
        job.plan.pop(step, None)
        cube = ev["cube"]
        if cube < 0:
            assert job.alloc is not None
            cube = job.alloc.cubes[0]
        self.stats["cube_failures"] += 1
        impacted = self.sched.fail_cube(cube)
        self.trace.instant("cube_fail", self.engine.now,
                           {"cube": cube, "planned_step": step})
        self.engine.schedule(self.cfg.repair_hours * 3600.0, "repair",
                             cube=cube)
        if impacted is not None and impacted != job.spec.name:
            # the planned cube belongs to another job (or a serve
            # replica): its owner takes a real failure; the planning job
            # still observes its planned interruption (driver semantics:
            # a planned failure always restores the planning job, owned
            # cube or not)
            self._route_failure(impacted, cube, note=f"cube {cube} died")
        self._handle_job_failure(job, cube, note=f"cube {cube} died")

    def _on_repair(self, ev: Event) -> None:
        cube = ev["cube"]
        self.sched.repair_cube(cube)
        self.stats["repairs"] += 1
        self.trace.instant("repair", self.engine.now, {"cube": cube})
        if self.cfg.host_mtbf_hours is not None and \
                cube not in self._fail_ev:
            self._schedule_cube_failure(cube)
        self._admit_queued()
        self._try_grow()

    def _on_install(self, ev: Event) -> None:
        """Incremental deployment waypoint: cubes 0..count-1 are now in
        production (paper: each cube is usable as soon as installed)."""
        count = ev["count"]
        self.sched.set_installed(range(count))
        self.trace.instant("install", self.engine.now, {"cubes": count})
        self.trace.counter("pod", self.engine.now,
                           {"installed_cubes": float(count)})
        self._admit_queued()
        self._try_grow()

    def _on_ckpt_write(self, ev: Event) -> None:
        """Synchronous checkpoint write at an absolute step boundary. The
        job stalls for the write; concurrent writers contend for the
        shared filer bandwidth (a write starting while k others are in
        flight takes (k+1)x the uncontended time — first-order fair
        share, already-started writes keep their end times). The snapshot
        becomes durable at write *completion* (see ``_settle_ckpt``)."""
        job = self.jobs[ev["job"]]
        if ev["epoch"] != job.epoch or job.state != "running":
            return
        now = self.engine.now
        self._settle_ckpt(job, now)
        step = ev["step"]
        self._charge_progress(job, step)
        dur, n = self._start_write(job, now)
        job.ledger.record_idle(
            dur, note=f"ckpt write @{step}"
            + (f" ({n} writers)" if n > 1 else ""))
        self.trace.duration(job.spec.name, "ckpt", now, dur,
                            args={"step": step, "writers": n})
        self.trace.counter("pod", now, {"ckpt_writers": float(n)})
        job.ckpt_write_end = now + dur
        job.ckpt_write_step = step
        job.segment_start = now + dur
        self._schedule_segment(job)

    def _on_sdc_corrupt(self, ev: Event) -> None:
        job = self.jobs[ev["job"]]
        if ev["epoch"] != job.epoch or job.state != "running":
            return
        assert self.cfg.sdc is not None
        corrupt_step = job.steps_at(self.engine.now)
        if corrupt_step >= job.spec.total_steps:
            return
        job.sdc_corrupt_step = corrupt_step
        self.stats["sdc_corruptions"] += 1
        delay = self.cfg.sdc.draw_detection_delay_s(self.engine.rng)
        self.engine.schedule(delay, "sdc_detect", job=job.spec.name,
                             epoch=job.epoch)
        self.trace.instant("sdc_corrupt", self.engine.now,
                           {"job": job.spec.name, "step": corrupt_step})

    def _on_sdc_detect(self, ev: Event) -> None:
        job = self.jobs[ev["job"]]
        if ev["epoch"] != job.epoch or job.state != "running" or \
                job.sdc_corrupt_step is None:
            # stale timeline: either a fail-stop restore wiped the
            # corrupted state (sdc_corrupt_step cleared) or the event was
            # superseded by a re-armed detection on a newer epoch
            return
        now = self.engine.now
        cfg = self.cfg
        st = job.step_time_s
        every = job.spec.checkpoint_every_steps
        self._settle_ckpt(job, now)
        steps_now = job.steps_at(now)
        self._charge_progress(job, steps_now)
        self._abort_write(job)  # an in-flight snapshot is poisoned too
        # every checkpoint since the corruption is poisoned: roll back to
        # the newest snapshot at or before the corruption step
        rollback = min(job.last_ckpt_step,
                       job.sdc_corrupt_step // every * every)
        partial = min(max(now - job.segment_start, 0.0), st)
        job.ledger.record_detection(cfg.detect_s + partial,
                                    note="sdc screen hit")
        self.stats["sdc_detections"] += 1
        self.trace.instant("sdc_detect", now, {
            "job": job.spec.name, "corrupt_step": job.sdc_corrupt_step,
            "rollback_to": rollback})
        self.trace.duration(job.spec.name, "detect", now, cfg.detect_s)
        job.sdc_corrupt_step = None
        job.last_ckpt_step = rollback
        # map out the defective cube, like FBIST screening would
        assert job.alloc is not None
        cube = job.alloc.cubes[0]
        pending = self._fail_ev.pop(cube, None)
        if pending is not None:
            self.engine.cancel(pending)
        self.sched.fail_cube(cube)
        self.engine.schedule(cfg.repair_hours * 3600.0, "repair", cube=cube)
        patched = self.sched.substitute(job.spec.name)
        if patched is None:
            # shrink or starve; restore + rework (from the rolled-back
            # snapshot) are charged by the shrink path now, or once at
            # re-admission for the queue arm
            self._starve_or_shrink(job, steps_now, note="sdc map-out")
            return
        job.alloc = patched
        restore = cfg.reconfig_s + cfg.restore_s
        rework = steps_now - rollback
        job.ledger.record_restore(restore, note="sdc rollback + map-out")
        job.ledger.record_rework(rework * st, steps=rework,
                                 note="sdc rework (poisoned ckpts)")
        self.trace.duration(job.spec.name, "restore", now + cfg.detect_s,
                            restore)
        self.trace.duration(job.spec.name, "rework",
                            now + cfg.detect_s + restore, rework * st)
        job.base_step = steps_now
        job.segment_start = now + cfg.detect_s + restore + rework * st
        self._schedule_segment(job)

    _HANDLERS = {
        "arrival": _on_arrival,
        "complete": _on_complete,
        "cube_fail": _on_cube_fail,
        "plan_fail": _on_plan_fail,
        "repair": _on_repair,
        "install": _on_install,
        "ckpt_write": _on_ckpt_write,
        "sdc_corrupt": _on_sdc_corrupt,
        "sdc_detect": _on_sdc_detect,
        "serve_live": _on_serve_live,
        "serve_session": _on_serve_session,
        "serve_req": _on_serve_req,
        "serve_done": _on_serve_done,
        "serve_ready": _on_serve_ready,
        "serve_ctl": _on_serve_ctl,
    }

    # ------------------------------------------------------------------ run

    def run(self, until_s: float, *, check_invariants: bool = True) -> None:
        """Advance simulated time to ``until_s``, then close the books:
        running jobs charge whole steps completed by the horizon so the
        per-job ledgers describe exactly the simulated window."""
        for ev in self.engine.drain_until(until_s):
            self._HANDLERS[ev.kind](self, ev)
            if check_invariants:
                self.sched.check_invariants()
        for job in self.jobs.values():
            if job.state == "running":
                self._charge_progress(job, job.steps_at(until_s))
            elif job.state == "queued":
                wait = until_s - job.queued_since
                if wait > 0.0:
                    job.ledger.record_idle(wait, note="queued for cubes")
                    job.queued_since = until_s
        for rt in self.serve.values():
            if rt.state == "live":
                rt.settle(until_s)

    # -------------------------------------------------------------- reports

    def summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, job in self.jobs.items():
            s = job.ledger.summary()
            s["state_done"] = float(job.state == "done")
            s["steps_done"] = float(job.base_step)
            s["cubes"] = float(job.cubes)
            s["rescales"] = float(job.rescales)
            s["grow_backs"] = float(job.grow_backs)
            out[name] = s
        for name, rt in self.serve.items():
            s = rt.ledger.summary()
            s.update(rt.slo_summary())  # key sets are disjoint
            out[name] = s
        return out

    def fleet_summary(self) -> Dict[str, float]:
        gp = [j.ledger.goodput for j in self.jobs.values()
              if j.ledger.total_seconds > 0]
        steps = sum(j.base_step for j in self.jobs.values())
        out = {
            **{k: float(v) for k, v in self.stats.items()},
            "ocs_reconfigs": float(self.sched.reconfig_count),
            "spare_cubes": float(self.sched.spare_cubes()),
            "events_processed": float(self.engine.processed),
            "jobs_done": float(sum(j.state == "done"
                                   for j in self.jobs.values())),
            "steps_done": float(steps),
            "min_goodput": min(gp) if gp else 1.0,
            "mean_goodput": sum(gp) / len(gp) if gp else 1.0,
        }
        if self.serve:
            good = sum(rt.good_tokens for rt in self.serve.values())
            total = sum(rt.total_tokens for rt in self.serve.values())
            out["serve_requests"] = float(sum(
                rt.arrived for rt in self.serve.values()))
            out["serve_finished"] = float(sum(
                rt.finished for rt in self.serve.values()))
            out["serve_slo_goodput"] = good / total if total else 1.0
            out["serve_scale_ups"] = float(sum(
                rt.scale_ups for rt in self.serve.values()))
            out["serve_scale_downs"] = float(sum(
                rt.scale_downs for rt in self.serve.values()))
            out["serve_scale_blocked"] = float(sum(
                rt.scale_blocked for rt in self.serve.values()))
            out["serve_replicas_lost"] = float(sum(
                rt.replicas_lost for rt in self.serve.values()))
        return out
