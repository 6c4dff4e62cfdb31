"""Metrics registry: named counters, gauges, fixed-bucket histograms.

Design constraints, in order:

  * **Zero overhead when disabled.** A disabled registry hands every
    caller the same ``NULL_METRIC`` singleton whose mutators are
    no-ops; no per-metric state is ever allocated, ``snapshot()`` is
    ``{}``, and ``to_jsonl()`` writes nothing. Instrumented hot loops
    pay one attribute call on a do-nothing object.
  * **Legacy dict call sites keep working.** ``CounterDict`` is a
    mapping facade over registry counters with a fixed key set, so
    ``engine.counters["chunks"] += 1`` and bench-style
    ``engine.counters[k] = 0`` resets route into the registry without
    touching the ~40 existing call sites.
  * **Plain-data snapshots.** ``snapshot()`` returns JSON-ready dicts;
    ``to_jsonl(path)`` appends one timestamped snapshot per line.

``CATALOG`` below is the pinned metric vocabulary; docs_check verifies
every name in the docs/observability.md catalog table resolves here.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Iterator, List, Mapping, MutableMapping, \
    Optional, Sequence, Tuple

Number = float

# Default histogram edges for wall-clock latencies (seconds): log-ish
# spacing from 1ms to 60s, the TTFT/TPOT range a serve SLO cares about.
DEFAULT_TIME_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# Queue-wait is measured in engine boundary steps, not seconds.
QUEUE_WAIT_BUCKETS_STEPS: Tuple[float, ...] = (
    0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

# The pinned metric vocabulary: name -> (kind, unit, description).
# docs/observability.md's catalog table is generated from this set and
# scripts/docs_check.py greps doc-listed names back against this file.
CATALOG: Dict[str, Tuple[str, str, str]] = {
    # serve: engine work counters (the legacy ServeEngine.counters keys,
    # "serve_"-prefixed on the registry)
    "serve_prefills": ("counter", "requests", "prefill admissions"),
    "serve_chunks": ("counter", "chunks", "device decode chunks launched"),
    "serve_decode_steps": ("counter", "steps", "decode steps executed"),
    "serve_host_syncs": ("counter", "syncs", "host blocking device reads"),
    "serve_pertoken_steps": ("counter", "steps",
                             "legacy per-token loop steps"),
    "serve_pages_trimmed": ("counter", "pages", "KV pages trimmed"),
    "serve_suffix_prefills": ("counter", "requests",
                              "prefix-cache suffix prefills"),
    "serve_prompt_tokens": ("counter", "tokens", "prompt tokens submitted"),
    "serve_cached_prompt_tokens": ("counter", "tokens",
                                   "prompt tokens served from prefix cache"),
    "serve_spec_steps": ("counter", "steps", "speculative verify steps"),
    "serve_spec_tokens": ("counter", "tokens",
                          "tokens emitted by speculative steps"),
    "serve_prefill_span_calls": ("counter", "calls",
                                 "span-prefill invocations"),
    "serve_span_prefill_compiles": ("counter", "compiles",
                                    "paged span-prefill trace events"),
    "serve_span_prefill_dense_compiles": ("counter", "compiles",
                                          "dense span-prefill trace events"),
    # serve: disaggregation (the legacy disagg_stats keys)
    "serve_transfers": ("counter", "transfers", "prefill->decode handoffs"),
    "serve_transfer_pages": ("counter", "pages", "KV pages transferred"),
    "serve_transfer_bytes": ("counter", "bytes", "KV bytes transferred"),
    "serve_transfer_stall_boundaries": ("counter", "boundaries",
                                        "boundaries stalled on transfer"),
    "serve_decode_idle_boundaries": ("counter", "boundaries",
                                     "decode boundaries with no live slot"),
    "serve_boundaries": ("counter", "boundaries",
                         "scheduler boundaries observed"),
    "serve_prefill_depth_sum": ("counter", "depth",
                                "prefill queue depth, summed per boundary"),
    "serve_prefill_depth_peak": ("gauge-as-counter", "depth",
                                 "peak prefill queue depth"),
    "serve_decode_depth_sum": ("counter", "depth",
                               "decode occupancy, summed per boundary"),
    "serve_decode_depth_peak": ("gauge-as-counter", "depth",
                                "peak decode occupancy"),
    # serve: request SLO metrics
    "serve_requests_admitted": ("counter", "requests", "admissions"),
    "serve_requests_finished": ("counter", "requests", "completions"),
    "serve_requests_preempted": ("counter", "requests", "preemptions"),
    "serve_ttft_s": ("histogram", "s", "time to first token per request"),
    "serve_tpot_s": ("histogram", "s",
                     "time per output token per request (post-first)"),
    "serve_e2e_s": ("histogram", "s", "request ready->finish wall time"),
    "serve_queue_wait_steps": ("histogram", "steps",
                               "arrival->admission wait in boundary steps"),
    "serve_prefill_s": ("histogram", "s", "per-admission prefill wall time"),
    "serve_chunk_s": ("histogram", "s",
                      "per-chunk dispatch+sync wall time"),
    # serve: role time/token split (prefill vs decode)
    "serve_prefill_time_s": ("counter", "s", "total prefill wall time"),
    "serve_decode_time_s": ("counter", "s", "total decode wall time"),
    "serve_prefill_tokens": ("counter", "tokens",
                             "non-cached prompt tokens prefilled"),
    "serve_decode_tokens": ("counter", "tokens",
                            "tokens drained from decode chunks"),
    "serve_generated_tokens": ("counter", "tokens",
                               "tokens delivered to finished requests"),
    # serve: fault injection / detection / recovery (engine fault_stats)
    "serve_fault_worker_failures": ("counter", "failures",
                                    "injected prefill-worker failures"),
    "serve_fault_page_corruptions": ("counter", "pages",
                                     "injected KV page corruptions"),
    "serve_fault_pages_quarantined": ("counter", "pages",
                                      "corrupt pages CRC-detected and "
                                      "quarantined"),
    "serve_fault_transfer_drops": ("counter", "drops",
                                   "dropped prefill->decode transfers"),
    "serve_fault_stragglers": ("counter", "chunks",
                               "decode chunks hit by straggler delay"),
    "serve_fault_detections": ("counter", "events",
                               "fault events detected by the engine"),
    # serve: request replay + terminal failure
    "serve_retry_requeues": ("counter", "requests",
                             "fault replays re-queued with backoff"),
    "serve_retry_failures": ("counter", "requests",
                             "requests terminally failed (budget spent)"),
    # serve: SLO-aware admission shedding
    "serve_shed_requests": ("counter", "requests",
                            "requests shed at enqueue (TTFT unmeetable)"),
    "serve_shed_spec_chunks": ("counter", "chunks",
                               "chunks demoted from speculative decode "
                               "under queue pressure"),
    # train: resilient-trainer lifecycle
    "train_steps": ("counter", "steps", "effective (non-replay) steps"),
    "train_replayed_steps": ("counter", "steps",
                             "steps re-run after a restore"),
    "train_ckpt_saves": ("counter", "saves", "checkpoint snapshots issued"),
    "train_failures": ("counter", "failures", "injected cube failures"),
    "train_restores": ("counter", "restores", "checkpoint restores"),
    "train_step_s": ("histogram", "s", "per-step wall time"),
}


class Counter:
    """Monotonic-by-convention accumulator (bench code may reset it)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Number = 0

    def inc(self, v: Number = 1) -> None:
        self.value += v

    add = inc

    def set(self, v: Number) -> None:
        self.value = v


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def inc(self, v: Number = 1) -> None:
        self.value += v

    add = inc


class Histogram:
    """Fixed-bucket histogram: ``edges`` are upper bounds of the first
    ``len(edges)`` buckets plus an implicit overflow bucket; quantiles
    interpolate linearly inside the bucket, clamped to observed
    min/max."""

    __slots__ = ("name", "edges", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str,
                 edges: Sequence[float] = DEFAULT_TIME_BUCKETS_S) -> None:
        if list(edges) != sorted(edges) or len(set(edges)) != len(edges):
            raise ValueError(f"histogram {name}: edges must be strictly "
                             f"increasing, got {edges!r}")
        self.name = name
        self.edges: Tuple[float, ...] = tuple(float(e) for e in edges)
        self.counts: List[int] = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: Number) -> None:
        v = float(v)
        i = 0
        for e in self.edges:
            if v <= e:
                break
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) from bucket counts."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.edges[i - 1] if i > 0 else self.min
                hi = self.edges[i] if i < len(self.edges) else self.max
                lo, hi = max(lo, self.min), min(hi, self.max)
                frac = (rank - seen) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            seen += c
        return self.max

    def to_dict(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "edges": list(self.edges),
            "buckets": list(self.counts),
        }


class _NullMetric:
    """Shared do-nothing metric handed out by a disabled registry: every
    mutator is a no-op, every reader returns zero."""

    __slots__ = ()
    name = "<null>"
    value: Number = 0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, v: Number = 1) -> None:
        pass

    add = inc
    set = inc
    observe = inc

    def quantile(self, q: float) -> float:
        return 0.0

    def to_dict(self) -> Dict[str, object]:
        return {}


NULL_METRIC = _NullMetric()


def _key(name: str, labels: Optional[Mapping[str, str]]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Registry of named metrics with optional label sets.

    ``counter()``/``gauge()``/``histogram()`` are get-or-create and
    return the live metric object — instrument construction once, then
    mutate the returned handle in hot loops (one dict lookup saved per
    event)."""

    def __init__(self, enabled: bool = True,
                 clock=time.time) -> None:
        self.enabled = enabled
        self.clock = clock
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, labels, factory):
        if not self.enabled:
            return NULL_METRIC
        key = _key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = factory(key)
        return m

    def counter(self, name: str,
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str,
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  edges: Sequence[float] = DEFAULT_TIME_BUCKETS_S,
                  labels: Optional[Mapping[str, str]] = None) -> Histogram:
        return self._get(name, labels, lambda k: Histogram(k, edges))

    def compile_event(self, name: str) -> None:
        """Record one *compilation* of a traced function.

        Trace-time semantics, pinned: call this ONLY from Python code
        that executes while jax traces the function (e.g. inside a
        jitted body). jax runs that Python once per compiled program
        variant, so the counter counts compilations — program-family
        cache hits do NOT re-execute the tracer and must not bump it.
        A retrace (new shape bucket, new donation pattern) legitimately
        counts again; calling this from regular eager code would
        double-count and is a bug at the call site."""
        self.counter(f"{name}_compiles").inc()

    def snapshot(self) -> Dict[str, object]:
        """Plain JSON-ready dict: scalars for counters/gauges, nested
        dicts for histograms. Disabled registry -> ``{}``."""
        out: Dict[str, object] = {}
        for key, m in sorted(self._metrics.items()):
            out[key] = m.to_dict() if isinstance(m, Histogram) else m.value
        return out

    def to_jsonl(self, path: str) -> None:
        """Append one timestamped snapshot line; no-op when disabled."""
        if not self.enabled:
            return
        with open(path, "a") as f:
            f.write(json.dumps({"t": float(self.clock()),
                                "metrics": self.snapshot()}) + "\n")

    def reset(self) -> None:
        self._metrics.clear()


class CounterDict(MutableMapping):
    """Mapping facade over registry counters with a fixed key set.

    Keeps legacy ``engine.counters["chunks"] += 1`` and bench-style
    ``engine.counters[k] = 0`` call sites working while the registry
    owns the numbers (under ``prefix + key`` names). Unknown keys raise
    — the key set is the pinned vocabulary, not an open dict."""

    def __init__(self, registry: MetricsRegistry, keys: Sequence[str],
                 prefix: str = "") -> None:
        self._c: Dict[str, object] = {
            k: registry.counter(prefix + k) for k in keys}

    def __getitem__(self, k: str) -> Number:
        return self._c[k].value

    def __setitem__(self, k: str, v: Number) -> None:
        self._c[k].set(v)

    def __delitem__(self, k: str) -> None:
        raise TypeError("CounterDict keys are fixed")

    def __iter__(self) -> Iterator[str]:
        return iter(self._c)

    def __len__(self) -> int:
        return len(self._c)

    def __repr__(self) -> str:
        return repr({k: m.value for k, m in self._c.items()})
