"""Job model for the fleet simulator.

A job is a synchronous training run on a slice of cubes: progress is
step-quantized (``step_time_s`` per step), checkpoints land at absolute
step multiples of ``checkpoint_every_steps`` (asynchronous writes — they
cost rework exposure, not step time, matching the repo's
``CheckpointManager`` — unless the fleet config prices synchronous
writes), and every interruption charges the job's ``GoodputLedger`` with
the same event grammar the real ``ResilientTrainer`` produces:
``detect -> restore -> rework`` after a failure, ``idle`` markers for
checkpoint snapshots and queue waits. The fleet bridge (fleet/bridge.py)
pins that grammar against a real run.

Elastic re-scale (the paper's "rescheduled at smaller scale" arm) is a
per-job policy: ``scale_policy="shrink"`` lets a starved job run on the
largest schedulable slice at or above ``min_cubes`` instead of queueing,
with ``step_time_for`` supplying the slice-size -> step-time curve
(roofline-fed via ``fleet.perf.StepTimeModel``, or ideal-linear when no
model is attached).

Also here: the checkpoint-interval policy math — the Young/Daly
closed form and a direct search over ``core.goodput.modeled_goodput``
(``fleet.perf.sim_checkpoint_interval_sweep`` validates the latter
against the simulator itself).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.goodput import GoodputLedger, modeled_goodput
from repro_torch.core.ocs import SliceAllocation
from repro_torch.core.topology import CUBE

SCALE_POLICIES = ("queue", "shrink")


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One training job submitted to the fleet.

    ``failure_steps`` is the deterministic failure plan (step -> cube id,
    the same shape ``resilience.driver.FailurePlan`` takes; cube -1 means
    "any cube the job owns") used by the sim-vs-trainer bridge and by
    reproducible scenarios. Stochastic failures come from the fleet
    config instead.

    ``scale_policy`` decides what starvation does: ``"queue"`` (default,
    the pre-elastic behavior — release the slice and wait for repairs)
    or ``"shrink"`` (run on the largest schedulable slice >= ``min_cubes``
    and grow back opportunistically). ``step_time_model`` maps a cube
    count to seconds per step (see ``fleet.perf``); without one, shrunken
    slices scale ideal-linearly from ``step_time_s``.
    """

    name: str
    chips: int
    total_steps: int
    step_time_s: float = 1.0
    checkpoint_every_steps: int = 100
    arrival_s: float = 0.0
    failure_steps: Tuple[Tuple[int, int], ...] = ()
    scale_policy: str = "queue"
    min_cubes: int = 0  # 0: full size only (with "shrink", defaults to 1)
    step_time_model: Optional[Callable[[int], float]] = None

    def __post_init__(self) -> None:
        if self.total_steps <= 0:
            raise ValueError("total_steps must be positive")
        if self.checkpoint_every_steps <= 0:
            raise ValueError("checkpoint_every_steps must be positive")
        if self.step_time_s <= 0:
            raise ValueError("step_time_s must be positive")
        if self.scale_policy not in SCALE_POLICIES:
            raise ValueError(f"scale_policy must be one of {SCALE_POLICIES}")
        if self.min_cubes < 0 or self.min_cubes > self.full_cubes:
            raise ValueError("min_cubes must be in [0, full_cubes]")
        if self.scale_policy == "shrink" and self.min_cubes == 0:
            object.__setattr__(self, "min_cubes", 1)

    @property
    def full_cubes(self) -> int:
        """Slice size, in cubes, of the job at its requested scale."""
        return CUBE.cubes_for(self.chips)

    @property
    def elastic(self) -> bool:
        return self.scale_policy == "shrink"

    def step_time_for(self, cubes: int) -> float:
        """Seconds per step on a slice of ``cubes`` cubes.

        With a roofline-fed model attached, the model answers (and also
        owns the full-size number); otherwise scale ideal-linearly from
        the declared full-size ``step_time_s`` — fixed global batch, so
        half the chips take twice as long."""
        if cubes <= 0:
            raise ValueError("cubes must be positive")
        if self.step_time_model is not None:
            return float(self.step_time_model(cubes))
        return self.step_time_s * self.full_cubes / cubes

    def plan(self) -> Dict[int, int]:
        return dict(self.failure_steps)


@dataclasses.dataclass
class JobRuntime:
    """Simulator-side mutable state of one job.

    ``cubes``/``step_time_s`` are the *current* slice size and speed —
    they diverge from the spec while an elastic job runs shrunken.
    ``ckpt_write_end``/``ckpt_write_step`` track an in-flight synchronous
    checkpoint write: the snapshot only becomes durable (and
    ``last_ckpt_step`` only advances) once the write completes, so a
    failure mid-write rolls back to the previous snapshot."""

    spec: JobSpec
    ledger: GoodputLedger = dataclasses.field(default_factory=GoodputLedger)
    state: str = "pending"  # pending|queued|running|starved|done
    alloc: Optional[SliceAllocation] = None
    base_step: int = 0  # progress at segment start
    last_ckpt_step: int = 0
    segment_start: float = 0.0  # sim time productive stepping (re)starts
    epoch: int = 0  # bumps whenever the timeline is rescheduled
    queued_since: float = 0.0
    pending_resume_step: Optional[int] = None  # progress before starvation
    sdc_corrupt_step: Optional[int] = None
    completed_at: Optional[float] = None
    first_admitted_at: Optional[float] = None
    plan: Dict[int, int] = dataclasses.field(default_factory=dict)
    cubes: int = 0  # current slice size (0 until first admitted)
    step_time_s: float = 0.0  # current seconds/step at the current size
    rescales: int = 0  # shrink events (starvation absorbed elastically)
    grow_backs: int = 0  # opportunistic re-expansions after repairs
    ckpt_write_end: Optional[float] = None  # sync write in flight until t
    ckpt_write_step: int = 0  # step the in-flight write snapshots

    def __post_init__(self) -> None:
        self.plan = self.spec.plan()
        self.step_time_s = self.spec.step_time_s

    @property
    def shrunken(self) -> bool:
        return self.state == "running" and 0 < self.cubes < \
            self.spec.full_cubes

    def set_scale(self, cubes: int) -> None:
        """Adopt a slice size: the step time follows the job's scaling
        curve (roofline-fed or ideal-linear)."""
        self.cubes = cubes
        self.step_time_s = self.spec.step_time_for(cubes)

    def steps_at(self, t: float) -> int:
        """Step count reached by sim time ``t`` in the current segment
        (clamped: restore/rework windows put segment_start in the
        future)."""
        if self.state != "running":
            return self.base_step
        done = int(max(0.0, t - self.segment_start) // self.step_time_s)
        return min(self.spec.total_steps, self.base_step + done)

    def next_planned_failure(self) -> Optional[Tuple[int, int]]:
        """(step, cube) of the earliest planned failure not yet fired."""
        if not self.plan:
            return None
        step = min(self.plan)
        return step, self.plan[step]

    @property
    def goodput(self) -> float:
        return self.ledger.goodput


# ---------------------------------------------------------------------------
# Checkpoint-interval policy.
# ---------------------------------------------------------------------------


def optimal_checkpoint_interval_s(mtbf_s: float,
                                  checkpoint_write_s: float) -> float:
    """Young/Daly first-order optimum: T* = sqrt(2 * delta * MTBF)."""
    if mtbf_s <= 0 or checkpoint_write_s <= 0:
        raise ValueError("mtbf and checkpoint write cost must be positive")
    return math.sqrt(2.0 * checkpoint_write_s * mtbf_s)


def search_checkpoint_interval(
    *,
    mtbf_hours: float,
    detect_s: float,
    restore_s: float,
    checkpoint_write_s: float,
    lo_s: float = 10.0,
    hi_s: float = 24 * 3600.0,
    points: int = 400,
) -> Tuple[float, float]:
    """Grid-search the interval maximizing ``modeled_goodput`` (log-spaced
    grid). Returns (best_interval_s, best_goodput). Agrees with Young/Daly
    to first order when detect/restore costs are small vs MTBF."""
    best_t, best_g = lo_s, -1.0
    for i in range(points):
        t = lo_s * (hi_s / lo_s) ** (i / (points - 1))
        g = modeled_goodput(mtbf_hours=mtbf_hours, detect_s=detect_s,
                            restore_s=restore_s, checkpoint_interval_s=t,
                            checkpoint_write_s=checkpoint_write_s)
        if g > best_g:
            best_t, best_g = t, g
    return best_t, best_g
