"""Serve jobs for the fleet simulator: inference replicas competing with
training jobs for cubes, failures, and the power budget.

The missing half of the paper's fleet story: production pods spend much
of their life *serving* (the original TPU was an inference chip with
hard latency targets), yet goodput/OCS/joules accounting is usually told
for training only. This module gives the deterministic fleet sim an
open-loop serve workload:

* **Arrivals** — a seeded non-homogeneous Poisson process
  (``ArrivalProcess``): base rate modulated by a diurnal sine and
  deterministic burst windows, drawn by Lewis-Shedler thinning from a
  per-job RNG (``np.random.default_rng([fleet_seed, crc32(job_name)])``)
  so the request trace is identical across autoscale policies and
  independent of the failure draws. Sessions are multi-turn: turn ``i``
  arrives ``i * think_time_s`` after the session start, its prompt folds
  the whole history (which the engine's prefix cache serves — later
  turns are cache hits by construction), and first turns hit a shared
  system-prefix with probability ``shared_prefix_frac``.

* **Service times** — ``fleet.perf.ServiceTimeModel``: prefill priced
  from *uncached* prompt tokens, decode from a per-chunk cost affine in
  the live batch — both calibratable from a real recorded ``ServeEngine``
  steptrace (``service_model_from_trace``), the same bridge pattern
  ``fleet/bridge.py`` uses to pin training ledgers.

* **SLO-goodput** — every request is checked against per-request
  TTFT/TPOT SLOs at admission; replica busy time splits into SLO-good
  ``steps`` (with good tokens as the step count) and SLO-violating
  ``rework`` charges on a standard ``GoodputLedger``, idle replica
  capacity charges ``idle``, spin-up/failure recovery charge
  ``restore``/``detect`` — the same five-kind grammar the bridge pins
  for training, so ``PowerModel`` prices joules-per-token with zero new
  plumbing (``PowerModel.serve_summary``).

* **Autoscaling** — replicas are OCS allocations (``"job/rK"``) that
  contend with training jobs; the ``"auto"`` policy scales up on queue
  depth or SLO violations and retires idle replicas, ``"fixed"`` only
  replaces lost replicas. Scale events ride the elastic machinery:
  freed cubes immediately go through ``_admit_queued``/``_try_grow``.

``fleet/sim.py`` owns the event loop (``serve_*`` event kinds); this
module owns the data model and all per-job state transitions so the
handlers stay thin. docs/fleet.md has the arrival model, ledger mapping,
and the autoscale state diagram.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.goodput import GoodputLedger
from repro_torch.core.topology import CUBE
from repro_torch.fleet.perf import ServiceTimeModel

SERVE_SCALE_POLICIES = ("fixed", "auto")
SERVE_SHED_POLICIES = ("none", "ttft")


@dataclasses.dataclass(frozen=True)
class ServeSLO:
    """Per-request latency targets: time-to-first-token and
    time-per-output-token. A request is SLO-good iff both hold."""

    ttft_s: float = 2.0
    tpot_s: float = 0.25

    def __post_init__(self) -> None:
        if self.ttft_s <= 0 or self.tpot_s <= 0:
            raise ValueError("SLO targets must be positive")


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Open-loop session arrivals. ``rate_rps`` is *session* starts per
    second; each session issues ``~turns_mean`` requests (geometric),
    one per turn. The rate is modulated by a diurnal sine
    (``(1 + amplitude*sin(2*pi*t/period))``) and by deterministic burst
    windows (every ``burst_every_s`` seconds the rate multiplies by
    ``burst_x`` for ``burst_len_s``)."""

    rate_rps: float = 1.0
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 86400.0
    burst_x: float = 1.0
    burst_every_s: float = 0.0  # 0 = no bursts
    burst_len_s: float = 0.0
    prompt_tokens: int = 256
    output_tokens: int = 64
    shared_prefix_frac: float = 0.0  # P(first-turn shared-prefix hit)
    prefix_frac: float = 0.5  # prompt fraction covered by such a hit
    turns_mean: float = 1.0
    think_time_s: float = 8.0

    def __post_init__(self) -> None:
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be positive")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if self.diurnal_period_s <= 0:
            raise ValueError("diurnal_period_s must be positive")
        if self.burst_x < 1.0:
            raise ValueError("burst_x must be >= 1")
        if self.burst_every_s < 0 or self.burst_len_s < 0:
            raise ValueError("burst windows must be >= 0")
        if self.burst_every_s > 0 and self.burst_len_s > self.burst_every_s:
            raise ValueError("burst_len_s must be <= burst_every_s")
        if self.prompt_tokens < 1 or self.output_tokens < 1:
            raise ValueError("prompt/output tokens must be >= 1")
        if not 0.0 <= self.shared_prefix_frac <= 1.0:
            raise ValueError("shared_prefix_frac must be in [0, 1]")
        if not 0.0 < self.prefix_frac <= 1.0:
            raise ValueError("prefix_frac must be in (0, 1]")
        if self.turns_mean < 1.0:
            raise ValueError("turns_mean must be >= 1")
        if self.think_time_s < 0:
            raise ValueError("think_time_s must be >= 0")

    def rate_at(self, t: float) -> float:
        r = self.rate_rps
        if self.diurnal_amplitude > 0:
            r *= 1.0 + self.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s)
        if self.burst_every_s > 0 and \
                t % self.burst_every_s < self.burst_len_s:
            r *= self.burst_x
        return r

    @property
    def peak_rate(self) -> float:
        """Upper bound on ``rate_at`` — the thinning envelope."""
        r = self.rate_rps * (1.0 + self.diurnal_amplitude)
        if self.burst_every_s > 0:
            r *= self.burst_x
        return r


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    rid: int
    turn: int
    arrival_s: float
    prompt_tokens: int
    output_tokens: int
    cached_tokens: int


@dataclasses.dataclass(frozen=True)
class ServeJobSpec:
    """One inference service: N replicas of ``chips`` chips each, fed
    from a single central queue. ``scale_policy="auto"`` targets
    ``[min_replicas, max_replicas]``; ``"fixed"`` holds ``replicas``
    (replacing lost ones) and never scales on load."""

    name: str
    chips: int
    arrivals: ArrivalProcess = ArrivalProcess()
    slo: ServeSLO = ServeSLO()
    service: ServiceTimeModel = ServiceTimeModel()
    replicas: int = 1
    min_replicas: int = 1
    max_replicas: int = 4
    max_batch: int = 8  # concurrent requests per replica
    scale_policy: str = "fixed"
    # "ttft": shed a queued request at dispatch when even its best-case
    # TTFT (wait already accrued + prefill + one chunk, batch of 1)
    # exceeds the SLO — serving it is guaranteed rework, and it
    # head-of-line-blocks requests that could still be good.
    shed_policy: str = "none"
    control_interval_s: float = 60.0
    spinup_s: float = 30.0
    arrival_s: float = 0.0  # service go-live time
    scale_up_queue_per_slot: float = 0.5
    scale_down_util: float = 0.3

    def __post_init__(self) -> None:
        if self.chips < 1:
            raise ValueError("chips must be >= 1")
        if self.scale_policy not in SERVE_SCALE_POLICIES:
            raise ValueError(
                f"scale_policy must be one of {SERVE_SCALE_POLICIES}")
        if self.shed_policy not in SERVE_SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SERVE_SHED_POLICIES}")
        if not 0 <= self.min_replicas <= self.replicas <= self.max_replicas:
            raise ValueError(
                "need 0 <= min_replicas <= replicas <= max_replicas")
        if self.max_replicas < 1 or self.max_batch < 1:
            raise ValueError("max_replicas and max_batch must be >= 1")
        if self.control_interval_s <= 0:
            raise ValueError("control_interval_s must be positive")
        if self.spinup_s < 0 or self.arrival_s < 0:
            raise ValueError("spinup_s and arrival_s must be >= 0")
        if self.scale_up_queue_per_slot < 0 or \
                not 0.0 <= self.scale_down_util <= 1.0:
            raise ValueError("bad autoscale thresholds")

    @property
    def cubes_per_replica(self) -> int:
        return max(1, CUBE.cubes_for(self.chips))


@dataclasses.dataclass
class ServeReplica:
    """One live replica: an OCS allocation plus exact busy/idle wall-time
    accounting (busy = at least one request in service). Time before
    ``ready_at`` (spin-up / failure recovery) is charged as ``restore``
    by the runtime and excluded here via ``last_t = ready_at``."""

    idx: int
    name: str  # OCS allocation name, "<job>/r<idx>"
    alloc: object
    ready_at: float
    last_t: float
    busy: int = 0
    busy_s: float = 0.0
    idle_s: float = 0.0
    inflight: Dict[int, ServeRequest] = dataclasses.field(
        default_factory=dict)

    def touch(self, now: float) -> None:
        dt = now - self.last_t
        if dt > 0:
            if self.busy > 0:
                self.busy_s += dt
            else:
                self.idle_s += dt
            self.last_t = now


def _pctl(vals: List[float], q: float) -> float:
    """Deterministic nearest-rank percentile (no interpolation)."""
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, int(q * len(s)))]


@dataclasses.dataclass
class ServeJobRuntime:
    """Mutable per-service state. The sim's ``serve_*`` handlers call the
    transition methods; everything here is deterministic given the
    fleet seed (the RNG is derived from ``[seed, crc32(name)]``)."""

    spec: ServeJobSpec
    ledger: GoodputLedger = dataclasses.field(default_factory=GoodputLedger)
    rng: Optional[np.random.Generator] = None
    state: str = "pending"  # pending -> live
    replicas: Dict[str, ServeReplica] = dataclasses.field(
        default_factory=dict)
    queue: List[ServeRequest] = dataclasses.field(default_factory=list)
    next_rid: int = 0
    next_replica: int = 0
    # counters
    arrived: int = 0
    finished: int = 0
    good: int = 0
    ttft_viol: int = 0
    tpot_viol: int = 0
    preempted: int = 0
    shed: int = 0
    good_tokens: int = 0
    total_tokens: int = 0
    viol_since_tick: int = 0
    scale_ups: int = 0
    scale_downs: int = 0
    scale_blocked: int = 0
    replicas_lost: int = 0
    peak_replicas: int = 0
    # latency samples (per started request)
    ttfts: List[float] = dataclasses.field(default_factory=list)
    tpots: List[float] = dataclasses.field(default_factory=list)
    waits: List[float] = dataclasses.field(default_factory=list)
    # completed-request log: the byte-identical determinism surface
    request_log: List[Tuple] = dataclasses.field(default_factory=list)
    # accounting already folded into the ledger (window settlement)
    closed_busy_s: float = 0.0
    closed_idle_s: float = 0.0
    _settled_busy: float = 0.0
    _settled_idle: float = 0.0
    _settled_good: int = 0
    _settled_total: int = 0

    def seed_rng(self, fleet_seed: int) -> None:
        self.rng = np.random.default_rng(
            [fleet_seed, zlib.crc32(self.spec.name.encode())])

    # ------------------------------------------------------------- arrivals

    def draw_next_session_t(self, t: float) -> float:
        """Next session start after ``t`` by Lewis-Shedler thinning
        against the process's peak-rate envelope."""
        assert self.rng is not None
        arr = self.spec.arrivals
        peak = arr.peak_rate
        while True:
            t += float(self.rng.exponential(1.0 / peak))
            if float(self.rng.uniform()) * peak <= arr.rate_at(t):
                return t

    def build_session(self, t0: float) -> List[ServeRequest]:
        """Draw one session's requests: geometric turn count, +-50%
        size jitter on the first turn, history folded into later prompts
        (fully prefix-cached — the engine's multi-turn behavior)."""
        assert self.rng is not None
        arr = self.spec.arrivals
        turns = 1 if arr.turns_mean <= 1.0 else int(
            self.rng.geometric(1.0 / arr.turns_mean))
        p = int(self.rng.integers(max(1, arr.prompt_tokens // 2),
                                  arr.prompt_tokens * 3 // 2 + 1))
        cached = 0
        if arr.shared_prefix_frac > 0 and \
                float(self.rng.uniform()) < arr.shared_prefix_frac:
            cached = int(arr.prefix_frac * p)
        tail = max(8, arr.prompt_tokens // 4)  # new user text per turn
        out: List[ServeRequest] = []
        for turn in range(turns):
            o = int(self.rng.integers(max(1, arr.output_tokens // 2),
                                      arr.output_tokens * 3 // 2 + 1))
            out.append(ServeRequest(
                rid=self.next_rid, turn=turn,
                arrival_s=t0 + turn * arr.think_time_s,
                prompt_tokens=p, output_tokens=o, cached_tokens=cached))
            self.next_rid += 1
            cached = p + o  # next turn: full history is a cache hit
            p = p + o + tail
        return out

    # -------------------------------------------------------------- routing

    def pick_replica(self, now: float) -> Optional[ServeReplica]:
        """Least-loaded ready replica with a free slot (ties by index)."""
        best = None
        for rep in self.replicas.values():
            if rep.ready_at > now or rep.busy >= self.spec.max_batch:
                continue
            if best is None or (rep.busy, rep.idx) < (best.busy, best.idx):
                best = rep
        return best

    def should_shed(self, req: ServeRequest, now: float) -> bool:
        """Admission control at dispatch: under ``shed_policy="ttft"``, a
        queued request whose *best-case* TTFT (accrued wait + prefill +
        one decode chunk at batch 1) already violates the SLO is dropped
        instead of served — it is guaranteed rework and head-of-line
        blocks requests that could still meet their deadline."""
        if self.spec.shed_policy != "ttft":
            return False
        m = self.spec.service
        best_ttft = (now - req.arrival_s
                     + m.prefill_s(req.prompt_tokens, req.cached_tokens)
                     + m.chunk_s(1))
        return best_ttft > self.spec.slo.ttft_s

    def shed_request(self, req: ServeRequest) -> None:
        self.shed += 1

    def start_service(self, rep: ServeReplica, req: ServeRequest,
                      now: float) -> Dict[str, object]:
        """Admit ``req`` into ``rep``: price the request from the service
        model at the post-admission batch, check SLOs, and return the
        ``serve_done`` payload (the sim schedules it)."""
        m = self.spec.service
        slo = self.spec.slo
        rep.touch(now)
        rep.busy += 1
        batch = rep.busy
        wait = now - req.arrival_s
        pf = m.prefill_s(req.prompt_tokens, req.cached_tokens)
        tpot = m.tpot_s(batch)
        ttft = wait + pf + m.chunk_s(batch)
        done_t = now + pf + req.output_tokens * tpot
        ok = ttft <= slo.ttft_s and tpot <= slo.tpot_s
        if ttft > slo.ttft_s:
            self.ttft_viol += 1
        if tpot > slo.tpot_s:
            self.tpot_viol += 1
        if not ok:
            self.viol_since_tick += 1
        self.ttfts.append(ttft)
        self.tpots.append(tpot)
        self.waits.append(wait)
        rep.inflight[req.rid] = req
        return {"job": self.spec.name, "replica": rep.name,
                "rid": req.rid, "start": now, "done": done_t,
                "batch": batch, "ttft": ttft, "tpot": tpot, "ok": ok}

    def finish_service(self, payload: Dict[str, object],
                       now: float) -> Optional[ServeReplica]:
        """Complete a request if its replica (and the request itself)
        still exists — stale ``serve_done`` events from replicas lost to
        failures no-op. Returns the replica so the sim can backfill from
        the queue."""
        rep = self.replicas.get(str(payload["replica"]))
        if rep is None:
            return None
        req = rep.inflight.pop(int(payload["rid"]), None)  # type: ignore
        if req is None:
            return None  # requeued after a failure; this timeline is void
        rep.touch(now)
        rep.busy -= 1
        self.finished += 1
        self.total_tokens += req.output_tokens
        if payload["ok"]:
            self.good += 1
            self.good_tokens += req.output_tokens
        self.request_log.append(
            (req.rid, req.turn, round(req.arrival_s, 9),
             round(float(payload["start"]), 9), round(now, 9),
             rep.name, int(payload["batch"]),  # type: ignore
             round(float(payload["ttft"]), 9),
             round(float(payload["tpot"]), 9), bool(payload["ok"])))
        return rep

    # ------------------------------------------------------------- scaling

    def scale_decision(self, now: float) -> Optional[str]:
        """"up"/"down"/None. ``fixed`` only tops back up to the declared
        replica count; ``auto`` scales on queue depth or SLO violations
        and retires idle capacity."""
        spec = self.spec
        live = len(self.replicas)
        if spec.scale_policy == "fixed":
            return "up" if live < spec.replicas else None
        if live < spec.min_replicas:
            return "up"
        cap = live * spec.max_batch
        qlen = len(self.queue)
        if live < spec.max_replicas and (
                qlen > spec.scale_up_queue_per_slot * cap or
                self.viol_since_tick > 0):
            return "up"
        busy = sum(r.busy for r in self.replicas.values())
        if live > max(spec.min_replicas, 1) and qlen == 0 and \
                self.viol_since_tick == 0 and \
                busy < spec.scale_down_util * cap:
            return "down"
        return None

    def idle_replica(self, now: float) -> Optional[ServeReplica]:
        """Newest fully-idle ready replica, if any (scale-down victim)."""
        best = None
        for rep in self.replicas.values():
            if rep.busy == 0 and rep.ready_at <= now:
                if best is None or rep.idx > best.idx:
                    best = rep
        return best

    def retire_replica(self, rep: ServeReplica, now: float) -> None:
        """Fold a departing replica's accounting into the closed books
        (scale-down or failure teardown)."""
        rep.touch(now)
        self.closed_busy_s += rep.busy_s
        self.closed_idle_s += rep.idle_s
        del self.replicas[rep.name]

    def requeue_inflight(self, rep: ServeReplica) -> int:
        """Push a dead replica's in-flight requests back to the front of
        the central queue (their arrival times are unchanged, so their
        eventual TTFT reflects the disruption)."""
        lost = sorted(rep.inflight.values(), key=lambda r: r.rid)
        rep.inflight.clear()
        rep.busy = 0
        self.preempted += len(lost)
        self.queue[:0] = lost
        return len(lost)

    # ----------------------------------------------------------- settlement

    def settle(self, now: float) -> None:
        """Fold the busy/idle window since the last settlement into the
        ledger, split by the window's SLO-good token fraction: good busy
        time is ``steps`` (with good tokens as the step count),
        violating busy time is ``rework``, idle capacity is ``idle`` —
        the training five-kind grammar, so the bridge and the power
        pipeline need nothing new."""
        b, i = self.closed_busy_s, self.closed_idle_s
        for rep in self.replicas.values():
            rep.touch(now)
            b += rep.busy_s
            i += rep.idle_s
        busy_w = max(b - self._settled_busy, 0.0)
        idle_w = max(i - self._settled_idle, 0.0)
        good_w = self.good_tokens - self._settled_good
        total_w = self.total_tokens - self._settled_total
        f = good_w / total_w if total_w > 0 else 1.0
        good_s = busy_w * f
        if good_s > 0 or good_w > 0:
            self.ledger.record_steps(good_s, steps=good_w,
                                     note="serve: slo-good tokens")
        if busy_w - good_s > 0 or total_w - good_w > 0:
            self.ledger.record_rework(max(busy_w - good_s, 0.0),
                                      steps=total_w - good_w,
                                      note="serve: slo-violating tokens")
        if idle_w > 0:
            self.ledger.record_idle(idle_w, note="serve: idle capacity")
        self._settled_busy, self._settled_idle = b, i
        self._settled_good = self.good_tokens
        self._settled_total = self.total_tokens

    # -------------------------------------------------------------- reports

    def slo_summary(self) -> Dict[str, float]:
        pending = len(self.queue) + sum(
            len(r.inflight) for r in self.replicas.values())
        return {
            "arrived": float(self.arrived),
            "finished": float(self.finished),
            "good_requests": float(self.good),
            "slo_goodput": (self.good_tokens / self.total_tokens
                            if self.total_tokens else 1.0),
            "good_tokens": float(self.good_tokens),
            "total_tokens": float(self.total_tokens),
            "ttft_viol": float(self.ttft_viol),
            "tpot_viol": float(self.tpot_viol),
            "preempted": float(self.preempted),
            "shed": float(self.shed),
            "pending": float(pending),
            "ttft_p50_s": _pctl(self.ttfts, 0.50),
            "ttft_p95_s": _pctl(self.ttfts, 0.95),
            "tpot_p50_s": _pctl(self.tpots, 0.50),
            "tpot_p95_s": _pctl(self.tpots, 0.95),
            "queue_wait_p50_s": _pctl(self.waits, 0.50),
            "queue_wait_p95_s": _pctl(self.waits, 0.95),
            "replicas": float(len(self.replicas)),
            "peak_replicas": float(self.peak_replicas),
            "scale_ups": float(self.scale_ups),
            "scale_downs": float(self.scale_downs),
            "scale_blocked": float(self.scale_blocked),
            "replicas_lost": float(self.replicas_lost),
        }
