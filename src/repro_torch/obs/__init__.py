"""Serving observability of the port: tracing, metrics, trace-replay
audit. All of it defaults off (``Tracer.disabled`` is the falsy no-op).

  * ``trace.Tracer`` — span tracer on the injected serving clock, with a
    deterministic Chrome trace-event (Perfetto-loadable) export;
    ``trace.StreamingTracer`` spills a bounded ring to JSON Lines.
  * ``metrics.Metrics`` — counters, gauges and quantile-sketch
    histograms; ``Metrics.merged`` (exact sketch merge) and
    ``to_prometheus``.
  * ``audit`` — re-verifies the serving invariants from a trace file
    alone (``python -m repro_torch.obs.audit PATH``); reads both export
    formats.

Imports nothing of ``core`` or ``serving``, so any layer may depend on
it.
"""
from .audit import (AuditReport, audit_doc, audit_file,  # noqa: F401
                    audit_tracer, jsonl_to_chrome, validate_chrome)
from .metrics import Metrics, QuantileSketch  # noqa: F401
from .trace import StreamingTracer, Tracer, TraceEvent  # noqa: F401
