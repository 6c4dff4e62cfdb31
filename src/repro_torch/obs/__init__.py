"""Unified telemetry: one metrics/tracing/steptrace vocabulary shared
by the serve engine, the resilient trainer, and the fleet simulator.

Three layers, all host-side (device programs are never touched, so an
instrumented engine stays token-identical to a bare one):

  * ``obs.metrics``   — named counters / gauges / fixed-bucket
    histograms behind a registry; zero-overhead when disabled;
    JSONL snapshots.
  * ``obs.trace``     — begin/end spans with pid/tid lanes and an
    injectable clock, serialized as Chrome-trace JSON. The fleet sim's
    ``TraceRecorder`` is a thin shim over ``SpanTracer``, so sim
    events, serve request lifecycles, and trainer step/replay events
    all merge into one timeline.
  * ``obs.steptrace`` — measured per-step/per-chunk durations with
    features (batch size, prefix hit, chunk kind); replayable through
    ``fleet.perf.StepTimeModel.from_trace``.
"""

from repro_torch.obs.metrics import (CATALOG, CounterDict, MetricsRegistry,
                               NULL_METRIC)
from repro_torch.obs.steptrace import StepEvent, StepTrace
from repro_torch.obs.trace import (SpanTracer, merge_chrome_traces,
                             validate_chrome_trace)

__all__ = [
    "CATALOG",
    "CounterDict",
    "MetricsRegistry",
    "NULL_METRIC",
    "SpanTracer",
    "StepEvent",
    "StepTrace",
    "merge_chrome_traces",
    "validate_chrome_trace",
]
