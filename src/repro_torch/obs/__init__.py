"""Serving observability of the port: the metrics registry and the
in-memory span tracer (``Tracer.disabled`` is the falsy no-op default).
Imports nothing of ``core``, so any layer may depend on it."""
from .metrics import Metrics, QuantileSketch  # noqa: F401
from .trace import Tracer, TraceEvent  # noqa: F401
