"""Roofline-fed step times for the fleet simulator.

The fleet's job model charges ``step_time_s`` seconds per training step.
Constants are fine for grammar tests, but the paper's goodput numbers
ride *measured* step times, and the elastic re-scale arm needs a real
slice-size -> step-time curve: half the chips is NOT simply twice the
step time once the per-device memory and collective terms stop scaling.

This adapter prices a training step from the repo's three-term roofline
(``core.roofline.build_report``) fed by a synthetic FSDP cost report
(``core.roofline.synthetic_train_cost``) and a per-generation
``RooflineTarget`` derived from Table 1 (``core.hwspec
.roofline_target_for``), instead of a compiled dry-run artifact:

  TrainWorkload (N params, tokens/step)
    -> synthetic_train_cost(chips)        per-device FLOPs/HBM/collective
    -> build_report(target=generation)    t_compute | t_memory | t_coll
    -> t_bound / efficiency               seconds per step at that slice

``StepTimeModel`` is the callable a ``JobSpec.step_time_model`` carries:
the simulator asks it for the step time at every re-scale, so shrinking
from 32 to 24 cubes follows the generation's actual scaling curve.
``generation_step_times`` prices the same workload across all five
generations — validated against the Table-1 scaling anchors (step-time
speedup must land between the HBM-bandwidth and peak-FLOPs ratios, and
improve monotonically v2 -> Ironwood).

Also here: ``sim_checkpoint_interval_sweep``, which closes the loop on
checkpoint policy — it runs the simulator itself (synchronous writes,
contention, real failure trace) across a grid of checkpoint intervals
and checks the sim-optimal interval lands within one grid bucket of the
``search_checkpoint_interval`` closed-form optimum.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import hwspec
from repro_torch.core.goodput import modeled_goodput
from repro_torch.core.roofline import (RooflineReport, build_report,
                                       synthetic_train_cost)
from repro_torch.core.topology import CUBE
from repro_torch.fleet.jobs import JobSpec
from repro_torch.obs.steptrace import EFFECTIVE_KINDS, StepTrace


@dataclasses.dataclass(frozen=True)
class TrainWorkload:
    """Analytic description of one training job's per-step work.

    ``n_params`` is *active* parameters (MoE: the routed subset) — the
    6*N*T napkin uses it; ``tokens_per_step`` is the global batch in
    tokens, fixed across re-scales (shrinking the slice divides the
    per-device batch, not the global one)."""

    n_params: float
    tokens_per_step: float
    param_bytes: float = 2.0
    grad_bytes: float = 4.0

    def __post_init__(self) -> None:
        if self.n_params <= 0 or self.tokens_per_step <= 0:
            raise ValueError("n_params and tokens_per_step must be positive")


@dataclasses.dataclass(frozen=True)
class StepTimeModel:
    """Callable slice-size (cubes) -> seconds per step, roofline-priced.

    ``efficiency`` discounts the perfect-overlap roofline bound to a
    realized step time (the paper-era MFU-style gap); it cancels in
    every cross-size and cross-generation *ratio*, so the scaling curves
    the elastic arm consumes are efficiency-independent."""

    tpu: str
    workload: TrainWorkload
    efficiency: float = 0.5
    pod_bw_fraction: float = 0.25

    def __post_init__(self) -> None:
        hwspec.get(self.tpu)  # fail fast on unknown generations
        if not 0.0 < self.efficiency <= 1.0:
            raise ValueError("efficiency must be in (0, 1]")

    def report(self, cubes: int) -> RooflineReport:
        """The full three-term report for a slice of ``cubes`` cubes."""
        if cubes <= 0:
            raise ValueError("cubes must be positive")
        spec = hwspec.get(self.tpu)
        target = hwspec.roofline_target_for(spec)
        chips = cubes * CUBE.chips
        wl = self.workload
        cost = synthetic_train_cost(
            n_params_active=wl.n_params,
            tokens_global=wl.tokens_per_step, chips=chips,
            param_bytes=wl.param_bytes, grad_bytes=wl.grad_bytes)
        return build_report(
            arch=f"fleet:{self.tpu}", shape="train",
            mesh_shape=[chips], axis_names=["data"], cost=cost,
            model_flops_global=6.0 * wl.n_params * wl.tokens_per_step,
            target=target, pod_bw_fraction=self.pod_bw_fraction,
            notes="synthetic FSDP cost (fleet.perf)")

    def __call__(self, cubes: int) -> float:
        return self.report(cubes).t_bound / self.efficiency

    @staticmethod
    def from_trace(trace: StepTrace,
                   kinds: Sequence[str] = EFFECTIVE_KINDS,
                   cubes_ref: int = 1) -> "MeasuredStepTimeModel":
        """Build a step-time model from a *measured* ``StepTrace``
        (real ``ServeEngine`` chunks or ``ResilientTrainer`` steps)
        instead of the analytic roofline — ROADMAP item 3's seam. The
        returned model prices a step at ``cubes_ref`` cubes as the
        measured mean and rescales ideal-linearly elsewhere; its
        ``replay()`` hands back the recorded per-step durations
        untouched for trace-replay consumers."""
        durations = tuple(trace.durations(kinds))
        if not durations:
            raise ValueError(
                f"trace from {trace.source!r} has no events of kinds "
                f"{tuple(kinds)} to model")
        return MeasuredStepTimeModel(
            durations=durations, cubes_ref=cubes_ref,
            source=trace.source)


@dataclasses.dataclass(frozen=True)
class MeasuredStepTimeModel:
    """Callable slice-size -> seconds per step, backed by measured
    durations: the mean of the recorded trace at ``cubes_ref`` cubes,
    ideal-linear rescale at other sizes (measurement fixes the anchor;
    the scaling curve stays the simulator's assumption)."""

    durations: Tuple[float, ...]
    cubes_ref: int = 1
    source: str = ""

    def __post_init__(self) -> None:
        if not self.durations:
            raise ValueError("need at least one measured duration")
        if self.cubes_ref <= 0:
            raise ValueError("cubes_ref must be positive")

    @property
    def mean_step_s(self) -> float:
        return sum(self.durations) / len(self.durations)

    def __call__(self, cubes: int) -> float:
        if cubes <= 0:
            raise ValueError("cubes must be positive")
        return self.mean_step_s * self.cubes_ref / cubes

    def replay(self) -> Tuple[float, ...]:
        """The recorded per-step durations, in execution order."""
        return self.durations


@dataclasses.dataclass(frozen=True)
class ServiceTimeModel:
    """Batch- and prefix-hit-conditioned serve service times.

    The serve-job analogue of ``MeasuredStepTimeModel``: prices a
    request's prefill from its *uncached* prompt tokens and its decode
    from a per-chunk cost that is affine in the live batch — exactly the
    two features the real ``ServeEngine`` records per steptrace event
    (``tokens``/``cached`` on prefill events, ``batch``/``steps`` on
    decode chunks), so ``from_steptrace`` can calibrate every
    coefficient from a recorded run. ``fleet.bridge
    .serve_calibration_check`` pins the round trip: a sim driven by this
    model must reproduce the measured per-chunk times."""

    prefill_s_per_token: float = 1e-4
    chunk_base_s: float = 0.02        # decode chunk at batch=1
    chunk_per_slot_s: float = 0.002   # marginal chunk cost per extra slot
    chunk_steps: int = 8              # tokens each request emits per chunk
    source: str = "analytic"

    def __post_init__(self) -> None:
        if self.prefill_s_per_token < 0 or self.chunk_per_slot_s < 0:
            raise ValueError("service-time coefficients must be >= 0")
        if self.chunk_base_s <= 0 or self.chunk_steps <= 0:
            raise ValueError("chunk_base_s and chunk_steps must be positive")

    def prefill_s(self, prompt_tokens: int, cached_tokens: int = 0) -> float:
        """Prefill wall time: only the uncached suffix costs compute
        (the engine's prefix-cache hit skips the shared prefix)."""
        return max(prompt_tokens - cached_tokens, 0) * \
            self.prefill_s_per_token

    def chunk_s(self, batch: int) -> float:
        """One decode chunk at ``batch`` live requests."""
        return self.chunk_base_s + \
            self.chunk_per_slot_s * max(batch - 1, 0)

    def tpot_s(self, batch: int) -> float:
        """Per-output-token time at ``batch`` live requests."""
        return self.chunk_s(batch) / self.chunk_steps

    def service_s(self, prompt_tokens: int, cached_tokens: int,
                  output_tokens: int, batch: int) -> float:
        return self.prefill_s(prompt_tokens, cached_tokens) + \
            output_tokens * self.tpot_s(batch)


def service_model_from_trace(
        trace: StepTrace,
        kinds: Sequence[str] = EFFECTIVE_KINDS) -> ServiceTimeModel:
    """Calibrate a ``ServiceTimeModel`` from a recorded ``ServeEngine``
    steptrace — the serve-side twin of ``StepTimeModel.from_trace``.

    Decode chunks: least-squares affine fit of chunk duration vs the
    recorded ``batch`` feature (falls back to the mean when the batch
    never varies). Prefill: through-origin per-token fit of prefill
    duration vs the recorded (already cache-discounted) ``tokens``
    feature. ``chunk_steps`` is the mean recorded ``steps`` per chunk."""
    kinds = tuple(kinds)
    batches = trace.feature_values("batch", kinds, default=1.0)
    chunk_ds = trace.durations(kinds)
    if not chunk_ds:
        raise ValueError(
            f"trace from {trace.source!r} has no decode events of kinds "
            f"{kinds} to calibrate from")
    n = len(chunk_ds)
    mean_b = sum(batches) / n
    mean_d = sum(chunk_ds) / n
    var_b = sum((b - mean_b) ** 2 for b in batches) / n
    if var_b > 1e-12:
        slope = sum((b - mean_b) * (d - mean_d)
                    for b, d in zip(batches, chunk_ds)) / n / var_b
        slope = max(slope, 0.0)
    else:
        slope = 0.0
    base = mean_d - slope * (mean_b - 1.0)  # value of the fit at batch=1
    if base <= 0.0:  # degenerate fit (tiny traces): keep the mean exact
        slope, base = 0.0, mean_d
    steps = [s for s in trace.feature_values("steps", kinds) if s > 0]
    chunk_steps = max(1, round(sum(steps) / len(steps))) if steps else 1
    tok = sum(trace.feature_values("tokens", ("prefill",)))
    per_tok = (sum(trace.durations(("prefill",))) / tok
               if tok > 0 else 0.0)
    return ServiceTimeModel(
        prefill_s_per_token=per_tok, chunk_base_s=base,
        chunk_per_slot_s=slope, chunk_steps=chunk_steps,
        source=trace.source)


def job_spec_from_trace(
    name: str,
    trace: StepTrace,
    *,
    chips: int,
    total_steps: int,
    checkpoint_every_steps: int = 100,
    arrival_s: float = 0.0,
    scale_policy: str = "queue",
    min_cubes: int = 0,
    kinds: Sequence[str] = EFFECTIVE_KINDS,
) -> JobSpec:
    """A ``JobSpec`` whose step time comes from a measured trace: the
    fleet sim runs on what the engine/trainer actually clocked."""
    cubes = max(1, CUBE.cubes_for(chips))
    model = StepTimeModel.from_trace(trace, kinds=kinds, cubes_ref=cubes)
    return JobSpec(
        name=name, chips=chips, total_steps=total_steps,
        step_time_s=model(cubes),
        checkpoint_every_steps=checkpoint_every_steps,
        arrival_s=arrival_s, scale_policy=scale_policy,
        min_cubes=min_cubes, step_time_model=model)


def generation_step_times(workload: TrainWorkload, cubes: int,
                          efficiency: float = 0.5) -> Dict[str, float]:
    """Seconds per step for the same workload on each Table-1 generation
    at a fixed slice size — the cross-generation validation surface
    (``bench_fleet`` checks the v2 -> Ironwood speedup lands between the
    Table-1 HBM-bandwidth and peak-FLOPs ratios)."""
    return {spec.name: StepTimeModel(spec.name, workload,
                                     efficiency=efficiency)(cubes)
            for spec in hwspec.GENERATIONS}


def job_spec_from_roofline(
    name: str,
    tpu: str,
    workload: TrainWorkload,
    *,
    chips: int,
    total_steps: int,
    checkpoint_every_steps: int = 100,
    arrival_s: float = 0.0,
    scale_policy: str = "queue",
    min_cubes: int = 0,
    efficiency: float = 0.5,
) -> JobSpec:
    """A ``JobSpec`` whose step time — at full size AND at every elastic
    re-scale — comes from the roofline instead of a constant."""
    model = StepTimeModel(tpu, workload, efficiency=efficiency)
    return JobSpec(
        name=name, chips=chips, total_steps=total_steps,
        step_time_s=model(CUBE.cubes_for(chips)),
        checkpoint_every_steps=checkpoint_every_steps,
        arrival_s=arrival_s, scale_policy=scale_policy,
        min_cubes=min_cubes, step_time_model=model)


# ---------------------------------------------------------------------------
# Checkpoint-interval policy: the simulator as ground truth.
# ---------------------------------------------------------------------------


def sim_checkpoint_interval_sweep(
    *,
    mtbf_hours: float = 2.0,
    detect_s: float = 15.0,
    restore_s: float = 60.0,
    checkpoint_write_s: float = 10.0,
    step_time_s: float = 1.0,
    points: int = 9,
    lo_s: float = 90.0,
    hi_s: float = 7200.0,
    mean_failures: float = 40.0,
    seed: int = 0,
    tpu: str = "tpu_v4",
) -> Dict[str, object]:
    """Validate ``search_checkpoint_interval`` against the simulator.

    Runs one single-cube job (plus one spare cube) under the *same*
    seeded failure trace for every interval on a log-spaced grid —
    failure/repair draws are independent of the job timeline, so every
    arm sees identical failures — with synchronous checkpoint writes, and
    compares the sim-optimal interval to the closed-form
    ``modeled_goodput`` optimum over the same grid. The two argmaxes
    should agree within one grid bucket (the Young/Daly first-order
    claim, now with detect/restore and write stalls priced by both
    sides)."""
    # a lazy import: fleet.sim imports fleet.jobs, which this module
    # shares; importing sim at module scope would be cycle-free today but
    # this keeps perf importable from jobs-level code too
    from repro_torch.fleet.sim import FleetConfig, FleetSimulator

    spec = hwspec.get(tpu)
    hosts_per_cube = max(1, CUBE.chips // spec.tpus_per_host)
    horizon_s = mean_failures * mtbf_hours * 3600.0
    intervals: List[float] = []
    sim_goodput: List[float] = []
    model_goodput: List[float] = []
    for i in range(points):
        t = lo_s * (hi_s / lo_s) ** (i / (points - 1))
        every = max(1, round(t / step_time_s))
        t_q = every * step_time_s  # the interval the sim actually runs
        intervals.append(t_q)
        cfg = FleetConfig(
            tpu=tpu, total_cubes=2,
            # cube-level MTBF == the target job MTBF (one-cube job)
            host_mtbf_hours=mtbf_hours * hosts_per_cube,
            repair_hours=0.25, detect_s=detect_s, restore_s=restore_s,
            reconfig_s=0.0, ckpt_write_s=checkpoint_write_s, seed=seed)
        job = JobSpec(name="probe", chips=CUBE.chips,
                      total_steps=10**9, step_time_s=step_time_s,
                      checkpoint_every_steps=every)
        sim = FleetSimulator(cfg, [job])
        sim.run(horizon_s, check_invariants=False)
        sim_goodput.append(sim.jobs["probe"].ledger.goodput)
        model_goodput.append(modeled_goodput(
            mtbf_hours=mtbf_hours, detect_s=detect_s, restore_s=restore_s,
            checkpoint_interval_s=t_q,
            checkpoint_write_s=checkpoint_write_s))
    sim_best = max(range(points), key=lambda i: sim_goodput[i])
    model_best = max(range(points), key=lambda i: model_goodput[i])
    return {
        "intervals_s": intervals,
        "sim_goodput": sim_goodput,
        "model_goodput": model_goodput,
        "sim_best_index": sim_best,
        "model_best_index": model_best,
        "sim_best_interval_s": intervals[sim_best],
        "model_best_interval_s": intervals[model_best],
        "bucket_delta": abs(sim_best - model_best),
        "agree_within_one_bucket": abs(sim_best - model_best) <= 1,
    }
