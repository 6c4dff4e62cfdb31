"""Chrome-trace export of fleet simulations — thin re-export.

The recorder lives in ``repro_torch.obs.trace`` as a shim over the shared
``SpanTracer``, so fleet-sim events, serve-engine request spans, and
trainer step/replay spans serialize through one schema and can merge
into one timeline. This module keeps the import path
``repro_torch.fleet.trace.TraceRecorder`` and its constants.
"""

from __future__ import annotations

from repro_torch.obs.trace import (_COLORS, _PHASE_TID, _POD_PID,
                                   SpanTracer, TraceRecorder)

__all__ = ["TraceRecorder", "SpanTracer",
           "_COLORS", "_PHASE_TID", "_POD_PID"]
