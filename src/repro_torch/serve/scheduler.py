"""Request-level continuous-batching scheduler.

The serving engine decodes in fixed device-resident chunks; between
chunks this scheduler owns every request-level decision:

  * **admission** — arrived requests claim free batch slots (and pages,
    in paged mode) in arrival order;
  * **completion** — finished slots (EOS or token budget) are drained and
    freed mid-stream, so the batch refills without draining;
  * **preemption** — under page pressure the youngest running request is
    evicted: its page references are dropped and it re-queues with its
    generated prefix folded into the prompt. Resumption is *not* a full
    recompute anymore: the victim's prompt pages were published to the
    prefix index at admission, so (while they stay cached) re-admission
    adopts them and prefills only the generated suffix — with greedy
    sampling the resumed request reproduces the same tokens, which is
    what the parity test pins.

The scheduler is pure host-side bookkeeping — everything it decides is
reflected to the device as page-table/pos updates before the next chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is in engine-step units (the
    benchmark's synthetic trace clock); 0 = available immediately."""

    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    arrival: int = 0

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        self.generated: List[int] = []
        # waiting | prefilling | running | finished | failed | shed
        self.state = "waiting"
        self.slot: int = -1
        self.preemptions = 0
        # fault-replay bookkeeping: ``retries`` counts re-admissions
        # after an injected/detected fault; ``not_before`` is the
        # exponential-backoff floor (engine-step clock) before the next
        # admission attempt.
        self.retries = 0
        self.not_before = 0
        # disaggregated mode: True once a prefill worker finished this
        # request's prompt (it may enter decode admission); reset on
        # preemption — the released pages must be re-prefilled.
        self.prefill_done = False
        # tokens served from the prefix cache at the latest admission
        # (set by the engine; the prefill computed only the suffix)
        self.cached_prefix_len = 0
        self.extras: Dict[str, np.ndarray] = {}  # e.g. enc_feats (1, S, D)

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.generated)

    def resume_prompt(self) -> np.ndarray:
        """Prompt for (re-)prefill: original + everything generated."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])


class ContinuousBatchingScheduler:
    def __init__(self, max_slots: int, aged_priority_after: int = 2):
        self.max_slots = max_slots
        # a request preempted/replayed this many times jumps ahead of
        # fresh arrivals at admission (starvation guard: under sustained
        # pressure the youngest-first eviction policy would otherwise
        # keep evicting the same re-queued request forever)
        self.aged_priority_after = aged_priority_after
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}  # slot -> request
        self.finished: List[Request] = []
        self.failed: List[Request] = []
        self.shed: List[Request] = []
        self.stats = {"admissions": 0, "preemptions": 0, "completions": 0,
                      "replays": 0, "failures": 0, "shed": 0}
        self._occupancy: List[float] = []

    # ------------------------------------------------------------- queues

    def add(self, req: Request) -> None:
        self.waiting.append(req)
        self.waiting.sort(key=lambda r: (r.arrival, r.rid))

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.max_slots) if s not in self.running]

    def _aged(self, req: Request) -> bool:
        return (req.preemptions + req.retries) >= self.aged_priority_after

    def next_admittable(self, clock: int) -> Optional[Request]:
        """Oldest eligible request, except that *aged* requests (over
        the preemption/retry threshold) outrank fresh arrivals — the
        deterministic anti-starvation rule. ``not_before`` (fault-replay
        backoff) gates eligibility exactly like ``arrival``."""
        best: Optional[Request] = None
        for req in self.waiting:
            if req.arrival > clock or req.not_before > clock:
                continue
            if best is None or ((not self._aged(best), best.arrival,
                                 best.rid) >
                                (not self._aged(req), req.arrival,
                                 req.rid)):
                best = req
        return best

    def admit(self, req: Request, slot: int) -> None:
        self.waiting.remove(req)
        req.state, req.slot = "running", slot
        self.running[slot] = req
        self.stats["admissions"] += 1

    def complete(self, slot: int) -> Request:
        req = self.running.pop(slot)
        req.state, req.slot = "finished", -1
        self.finished.append(req)
        self.stats["completions"] += 1
        return req

    def preempt_victim(self) -> Optional[Request]:
        """Youngest running request (latest arrival, then highest rid) —
        the classic recompute-preemption policy: the oldest requests keep
        their progress."""
        if not self.running:
            return None
        return max(self.running.values(), key=lambda r: (r.arrival, r.rid))

    def preempt(self, req: Request) -> None:
        assert req.state == "running"
        del self.running[req.slot]
        req.state, req.slot = "waiting", -1
        req.preemptions += 1
        req.prefill_done = False  # pages dropped: must re-prefill
        self.stats["preemptions"] += 1
        self.add(req)

    def requeue(self, req: Request, *, not_before: int = 0) -> None:
        """Fault replay: like ``preempt`` but accounted separately and
        gated by an exponential-backoff floor. The generated prefix is
        kept — re-admission re-prefills ``resume_prompt()`` (adopting
        any surviving cached pages) and continues token-identically."""
        assert req.state == "running"
        del self.running[req.slot]
        req.state, req.slot = "waiting", -1
        req.retries += 1
        req.prefill_done = False
        req.not_before = not_before
        self.stats["replays"] += 1
        self.add(req)

    def fail(self, req: Request) -> None:
        """Deterministic terminal failure (retry budget exhausted): the
        request leaves the system with ``state="failed"`` instead of
        looping through replay forever."""
        if req.state == "running":
            del self.running[req.slot]
        elif req in self.waiting:
            self.waiting.remove(req)
        req.state, req.slot = "failed", -1
        self.failed.append(req)
        self.stats["failures"] += 1

    def shed_request(self, req: Request) -> None:
        """Admission-control shed: dropped from the waiting queue before
        consuming any decode resources (state="shed")."""
        self.waiting.remove(req)
        req.state, req.slot = "shed", -1
        self.shed.append(req)
        self.stats["shed"] += 1

    # -------------------------------------------------------------- stats

    def record_occupancy(self, live: int) -> None:
        self._occupancy.append(live / max(self.max_slots, 1))

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self._occupancy)) if self._occupancy else 0.0


class PrefillWorkerPool:
    """Dedicated prefill workers for prefill/decode disaggregation.

    Cold prompts are placed on the shallowest worker queue; each worker
    chunk-prefills its queue in FIFO order at one span per engine chunk
    (the same chunked-prefill cadence the co-located engine uses), so a
    prompt of S tokens occupies its worker for ``ceil(S / span_len)``
    chunk boundaries. ``pop_ready`` releases finished prompts back to
    the decode scheduler; the engine then models the page transfer
    (ICI/DCN) before the decode slot goes live.

    Purely host-side queueing — the actual prefill compute still runs
    through the engine's span-prefill program at admission; this pool
    models *when* that work happened on the prefill workers and keeps
    per-role queue-depth statistics.
    """

    def __init__(self, n_workers: int, span_len: int, chunk: int):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = n_workers
        self.span_len = max(span_len, 1)
        self.chunk = max(chunk, 1)
        # per-worker FIFO of (ready_at_clock, request)
        self.queues: List[List[tuple]] = [[] for _ in range(n_workers)]
        self.free_at = [0] * n_workers
        self.stats = {"placed": 0, "prefilled_tokens": 0,
                      "worker_failures": 0, "failover_replacements": 0}

    def _place_on(self, w: int, req: Request, clock: int) -> int:
        n_tok = len(req.resume_prompt())
        dur = -(-n_tok // self.span_len) * self.chunk  # ceil spans * chunk
        start = max(clock, self.free_at[w])
        ready = start + dur
        self.free_at[w] = ready
        self.queues[w].append((ready, req))
        req.state = "prefilling"
        self.stats["placed"] += 1
        self.stats["prefilled_tokens"] += n_tok
        return ready

    def place(self, req: Request, clock: int) -> int:
        """Queue ``req`` on the least-loaded worker; returns ready time."""
        w = min(range(self.n_workers),
                key=lambda i: (len(self.queues[i]), self.free_at[i], i))
        return self._place_on(w, req, clock)

    def fail_worker(self, w: int, clock: int, *,
                    respawn_boundaries: int = 4) -> List[Request]:
        """Kill worker ``w`` mid-flight: its queued prompts (including
        the one being prefilled) are re-placed on the least-loaded
        *survivor* — the OCS spare-substitution analogue: route around
        the failed component and replay the lost work. The dead worker
        respawns (becomes placeable again) after ``respawn_boundaries``
        chunks; with one worker total, the replays simply wait for the
        respawn. Returns the re-placed requests."""
        lost = [req for _, req in self.queues[w]]
        self.queues[w] = []
        self.free_at[w] = clock + respawn_boundaries * self.chunk
        self.stats["worker_failures"] += 1
        survivors = [i for i in range(self.n_workers) if i != w]
        for req in lost:
            if survivors:
                tgt = min(survivors,
                          key=lambda i: (len(self.queues[i]),
                                         self.free_at[i], i))
            else:
                tgt = w  # sole worker: replay lands after the respawn
            self._place_on(tgt, req, clock)
            self.stats["failover_replacements"] += 1
        return lost

    def pop_ready(self, clock: int) -> List[Request]:
        """Prompts whose prefill completed by ``clock`` (FIFO per worker)."""
        out: List[Request] = []
        for q in self.queues:
            while q and q[0][0] <= clock:
                _, req = q.pop(0)
                req.prefill_done = True
                req.state = "waiting"
                out.append(req)
        return out

    def pending(self) -> bool:
        return any(self.queues)

    def depths(self) -> List[int]:
        return [len(q) for q in self.queues]
