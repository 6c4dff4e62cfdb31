"""SLO-aware admission control for the serving engine (a copy of
``repro.serve.admission``; no framework code).

Graceful degradation instead of queue collapse: when the engine cannot
meet a request's TTFT deadline even under best-case scheduling, serving
it anyway burns decode slots on guaranteed SLO violations and pushes the
*next* request over its deadline too. The controller sheds such requests
at enqueue time (deterministically — the decision is a pure function of
the engine clock and the request, so runs are replayable) and drops
speculative decoding under queue pressure (speculation trades decode
FLOPs for latency; under a deep queue the FLOPs are better spent on
plain chunks — and dropping speculation is token-identical by
construction, so the policy is purely a latency/throughput trade).

The reference runs the same two policies at fleet scale in its
``fleet/serve_jobs.py`` (``shed_policy="ttft"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs for enqueue-time shedding and pressure degradation.

    ``ttft_deadline_steps``: shed a request when its best-case first
    token would land more than this many engine steps after arrival
    (None disables shedding). ``spec_off_queue_depth``: run plain decode
    chunks instead of speculative ones while more than this many
    requests wait (None keeps speculation unconditionally)."""

    ttft_deadline_steps: Optional[int] = None
    spec_off_queue_depth: Optional[int] = None

    def __post_init__(self) -> None:
        if self.ttft_deadline_steps is not None \
                and self.ttft_deadline_steps < 1:
            raise ValueError("ttft_deadline_steps must be >= 1")
        if self.spec_off_queue_depth is not None \
                and self.spec_off_queue_depth < 0:
            raise ValueError("spec_off_queue_depth must be >= 0")


@dataclasses.dataclass
class AdmissionController:
    """Stateless policy evaluator (counters live in the engine's
    ``fault_stats`` so they flow through the obs CATALOG)."""

    policy: AdmissionPolicy = dataclasses.field(
        default_factory=AdmissionPolicy)

    def predicted_ttft_steps(self, req, clock: int, *, chunk: int,
                             span_len: int, disaggregated: bool) -> int:
        """Best-case TTFT in engine steps: the wait already accrued,
        plus the prefill spans still owed (disaggregated prefill pays
        one chunk of boundaries per span; co-located prefill completes
        within the admitting boundary), plus the chunk that drains the
        first decode token."""
        wait = max(0, clock - req.arrival)
        owed = len(req.prompt) - req.cached_prefix_len
        if req.prefill_done or owed <= 0:
            prefill = 0
        elif disaggregated:
            prefill = -(-owed // span_len) * chunk
        else:
            prefill = chunk
        return wait + prefill + chunk

    def should_shed(self, req, clock: int, *, chunk: int, span_len: int,
                    disaggregated: bool) -> bool:
        """True when even the best-case first token misses the deadline.
        Requests with sunk work are never shed: past prefill, already
        generating (preemption/fault replay), or in retry backoff —
        shedding those would discard completed compute, and a replayed
        request's accrued wait says nothing about its viability."""
        ddl = self.policy.ttft_deadline_steps
        if ddl is None or req.prefill_done or req.generated \
                or req.retries or req.preemptions:
            return False
        est = self.predicted_ttft_steps(
            req, clock, chunk=chunk, span_len=span_len,
            disaggregated=disaggregated)
        return est > ddl

    def drop_speculation(self, queue_depth: int) -> bool:
        """True when queue pressure says to spend decode FLOPs on plain
        chunks this boundary (token-identical degradation)."""
        depth = self.policy.spec_off_queue_depth
        return depth is not None and queue_depth > depth
