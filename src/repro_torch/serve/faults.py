"""Deterministic fault injection for the serving engine (the port's
``repro.serve.faults``: the schedule is numpy and the same as the
reference's for the same plan; the startup self-test runs the port's
kernels).

The paper's resilience machinery (§Resilience: OCS spare substitution,
FBIST screens, hardware replay) is only testable if faults are
*reproducible*: the chaos harness here draws every fault from a seeded
schedule that is a pure function of the plan — keyed exactly like the
fleet sim's arrival processes (``np.random.default_rng([seed,
crc32(kind)])``), so the fault schedule is byte-identical across
scheduling policies and completely independent of the request traffic.

Four fault kinds, mirroring the production failure modes the engine must
survive:

  * ``worker_fail`` — a prefill worker dies mid-flight; its queued
    prompts re-place onto the least-loaded survivor (the OCS
    spare-substitution analogue, ``PrefillWorkerPool.fail_worker``);
  * ``page_flip`` — silent corruption of a resident KV page (the SDC
    story at serving granularity); detected by per-page CRC32 stamps in
    ``PagedKVCache`` and recovered by quarantine + request replay;
  * ``transfer_drop`` — a disaggregated prefill->decode page handoff is
    lost and retransmitted (the parked slot re-parks);
  * ``straggler`` — a decode chunk takes extra boundaries of wall time
    (work of one chunk, clock of several).

Every recovery path is token-preserving by construction (append-only
pages + position rewind + greedy per-request determinism), which is what
the tier-1 fault-parity gate pins: survivors of an injected schedule
emit byte-identical token streams to the fault-free run.

``startup_bist`` is the serving half of ``core/sdc.FBIST``: golden
patterns through the real matmul and paged-decode kernels before a
server admits traffic (``launch/serve.py --bist``).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sdc import FBIST, FBISTReport
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops

_PICK_RANGE = 1 << 31  # uniform pick draws, reduced mod len() at use


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-boundary fault probabilities over a fixed horizon.

    ``seed`` fully determines the schedule; rates are per chunk
    boundary. ``straggler_extra_boundaries`` is the walltime penalty of
    one straggling chunk; ``transfer_retry_boundaries`` is the
    retransmit delay of a dropped page handoff."""

    seed: int = 0
    horizon_boundaries: int = 4096
    worker_fail_rate: float = 0.0
    page_flip_rate: float = 0.0
    transfer_drop_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_extra_boundaries: int = 1
    transfer_retry_boundaries: int = 2

    def __post_init__(self) -> None:
        for f in ("worker_fail_rate", "page_flip_rate",
                  "transfer_drop_rate", "straggler_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.horizon_boundaries < 1:
            raise ValueError("horizon_boundaries must be >= 1")
        if self.straggler_extra_boundaries < 1 or \
                self.transfer_retry_boundaries < 1:
            raise ValueError("fault delays must be >= 1 boundary")


class FaultInjector:
    """Materialized fault schedule: one (hit mask, pick stream) pair per
    fault kind, drawn eagerly over the plan's horizon from a per-kind
    RNG ``default_rng([seed, crc32(kind)])``.

    Queries are pure reads indexed by boundary number — no internal
    state advances, so the answers cannot depend on traffic, scheduling
    policy, or query order. Past the horizon the schedule is silent."""

    KINDS = ("worker_fail", "page_flip", "transfer_drop", "straggler")

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        h = plan.horizon_boundaries
        self._hit: Dict[str, np.ndarray] = {}
        self._pick: Dict[str, np.ndarray] = {}
        for kind in self.KINDS:
            rng = np.random.default_rng(
                [plan.seed, zlib.crc32(kind.encode())])
            rate = getattr(plan, f"{kind}_rate")
            self._hit[kind] = rng.random(h) < rate
            self._pick[kind] = rng.integers(0, _PICK_RANGE, h)

    def _event(self, kind: str, boundary: int) -> Optional[int]:
        if not 0 <= boundary < self.plan.horizon_boundaries:
            return None
        if not self._hit[kind][boundary]:
            return None
        return int(self._pick[kind][boundary])

    def worker_failure(self, boundary: int) -> Optional[int]:
        """Uniform pick (reduce mod n_workers) or None."""
        return self._event("worker_fail", boundary)

    def page_flip(self, boundary: int) -> Optional[int]:
        """Uniform pick (reduce mod len(corruptible pages)) or None."""
        return self._event("page_flip", boundary)

    def transfer_drop(self, boundary: int) -> Optional[int]:
        """Uniform pick (reduce mod len(in-flight transfers)) or None."""
        return self._event("transfer_drop", boundary)

    def straggler(self, boundary: int) -> int:
        """Extra boundaries of walltime this chunk pays (0 = on time)."""
        if self._event("straggler", boundary) is None:
            return 0
        return self.plan.straggler_extra_boundaries

    def schedule_digest(self) -> int:
        """CRC32 over the full materialized schedule — the byte-identity
        surface the determinism property tests pin."""
        crc = 0
        for kind in self.KINDS:
            crc = zlib.crc32(self._hit[kind].tobytes(), crc)
            crc = zlib.crc32(self._pick[kind].tobytes(), crc)
        return crc


# ---------------------------------------------------------------------------
# Startup built-in self test (launch/serve.py --bist).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BISTResult:
    passed: bool
    matmul_report: FBISTReport
    paged_decode_ok: bool
    paged_decode_max_err: float


def _paged_decode_check(impl: str, device: torch.device, tol: float,
                        decode_fn: Optional[Callable] = None
                        ) -> Tuple[bool, float]:
    """One golden pattern through the paged-decode kernel vs a float64
    numpy oracle (same independence discipline as FBIST goldens)."""
    rng = np.random.default_rng(0xB157)
    b, h, kv, d, n, p, m = 2, 4, 2, 16, 9, 8, 4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k_pages = rng.standard_normal((n, p, kv, d)).astype(np.float32)
    v_pages = rng.standard_normal((n, p, kv, d)).astype(np.float32)
    table = np.zeros((b, m), np.int32)
    table[0, :3] = (1, 2, 3)
    table[1, :2] = (4, 5)
    pos = np.array([19, 13], np.int32)
    # float64 oracle: gather the pages, masked softmax attention
    groups = h // kv
    golden = np.zeros((b, h, d))
    for bi in range(b):
        keys = k_pages[table[bi]].reshape(m * p, kv, d).astype(np.float64)
        vals = v_pages[table[bi]].reshape(m * p, kv, d).astype(np.float64)
        mask = np.arange(m * p) < pos[bi]
        for hi in range(h):
            g = hi // groups
            s = (keys[:, g] @ q[bi, hi].astype(np.float64)) * d ** -0.5
            s = np.where(mask, s, -np.inf)
            w = np.exp(s - s.max())
            w /= w.sum()
            golden[bi, hi] = w @ vals[:, g]
    fn = decode_fn or (lambda *a: kops.paged_decode_attention(*a,
                                                              impl=impl))
    out = fn(*(torch.from_numpy(x).to(device)
               for x in (q, k_pages, v_pages, table, pos)))
    got = out.detach().double().cpu().numpy()
    err = float(np.max(np.abs(got - golden)))
    return bool(np.isfinite(err) and err <= tol), err


def startup_bist(*, impl: str = "cuda", device: DeviceLike = None,
                 tol: float = 5e-2, matmul_fn: Optional[Callable] = None,
                 decode_fn: Optional[Callable] = None) -> BISTResult:
    """Serving startup self-test: the FBIST golden patterns (128^3, f32)
    through the matmul kernel, plus one golden paged-decode pattern
    through the paged-attention kernel, both against independent float64
    numpy oracles, on ``device`` (default: the card). ``impl="ref"`` runs
    the plain versions instead (CPU hosts). ``matmul_fn``/``decode_fn``
    stand in for the kernels in fault-injection checks
    (``core.sdc.faulty_wrap``)."""
    dev = resolve_device(device)
    mm = matmul_fn or (lambda a, b: kops.matmul(a, b, impl=impl))
    report = FBIST(m=128, k=128, n=128, tol=tol).run(mm, device=dev)
    pd_ok, pd_err = _paged_decode_check(impl, dev, tol, decode_fn)
    return BISTResult(passed=report.passed and pd_ok,
                      matmul_report=report,
                      paged_decode_ok=pd_ok,
                      paged_decode_max_err=pd_err)
