"""The serving layer of the port: the unified ``EMSServeEngine``
(``api``), its legacy constructor shims (``batch_engine``,
``stream_engine``), the wall-clock event loop (``event_loop``) and the
byte-accounted link fabric (``transport``).

``build_engine(models, params, "batch+stream", share_encoders=True)``
coalesces many sessions' arrivals into bucketed (or, with
``ragged=True``, packed) batched encoder calls and grouped fusion tails,
one host sync per flush, with progressive partial->final predictions,
deadlines and eviction. ``build_engine(models, params, "tiered",
profile=..., trace=..., tiers=("glass", "ph1", "edge64x"),
precision={"ph1": "int8"})`` places each arrival's encoder and fusion
tail on simulated glass/phone/edge clocks, ships real payload and
feature bytes over per-link in-order channels, fails over from a crashed
tier through the versioned feature cache, and — with a precision map —
runs int8 flights through the hand-written quantize / int8 GEMM kernels
and ships packed features; ``stream+tiered`` adds on-glass provisional
partials.
"""
from .api import (Arrival, BatchPolicy, EMSServeEngine,  # noqa: F401
                  EngineSpec, FlushReport, PlacementPolicy, Prediction,
                  SessionView, StreamPolicy, TieredRecord, TierHost,
                  build_engine, parse_spec, spec_tokens)
from .batch_engine import BatchedEMSServe, SessionState  # noqa: F401
from .event_loop import LoopStats, WallClockDriver  # noqa: F401
from .stream_engine import (StreamFlushReport,  # noqa: F401
                            StreamingEMSServe, StreamSession)
from .transport import (Delivery, MinTrace, TierFabric,  # noqa: F401
                        TransportChannel, payload_nbytes)
