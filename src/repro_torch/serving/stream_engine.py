"""StreamingEMSServe: the batch+stream construction of the unified
engine.

Progressive partial->final predictions over asynchronously arriving
modalities, deadline-driven coalesced flushes, cached re-fusion with no
encoder re-runs, and cross-incident session eviction live in
:class:`repro_torch.serving.api.EMSServeEngine` behind
:class:`~repro_torch.serving.api.BatchPolicy` +
:class:`~repro_torch.serving.api.StreamPolicy`. This module is the thin
constructor shim that keeps the historical surface; new code says::

    from repro_torch.serving.api import build_engine
    eng = build_engine(models, params, "batch+stream",
                       share_encoders=True, deadline_s=0.05)

``deadline_s`` sets the flush cadence: ``0`` flushes on every submit,
``> 0`` buffers arrivals until the oldest pending one is that many
wall-seconds old (checked on every submit and by ``poll()``), ``None``
leaves flushing to the caller. ``idle_timeout_s``/``max_sessions``
drive cross-incident eviction; ``time_fn`` is injectable so tests can
drive a fake clock.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..core.bucketing import Bucketer
from ..core.splitter import SplitModel
from .api import (_AUTO, BatchPolicy, EMSServeEngine,  # noqa: F401
                  FlushReport, Prediction, SessionView, StreamPolicy)

# historical names, now the canonical unified types
StreamFlushReport = FlushReport
StreamSession = SessionView


class StreamingEMSServe(EMSServeEngine):
    """Event-driven multi-session runtime with progressive re-fusion —
    see the module and ``api.EMSServeEngine`` docstrings."""

    def __init__(self, models: Dict[str, SplitModel],
                 params: Dict[str, dict], *,
                 bucketer: Optional[Bucketer] = None,
                 deadline_s: Optional[float] = 0.0,
                 max_coalesce: int = 64, batch_bucket_min: int = 1,
                 share_encoders: bool = False,
                 max_history: Optional[int] = 256,
                 idle_timeout_s: Optional[float] = None,
                 max_sessions: Optional[int] = None,
                 time_fn: Callable[[], float] = time.perf_counter,
                 device="cuda"):
        super().__init__(
            models, params,
            batch=BatchPolicy(
                bucketer=bucketer if bucketer is not None else _AUTO,
                max_coalesce=max_coalesce,
                batch_bucket_min=batch_bucket_min),
            stream=StreamPolicy(deadline_s=deadline_s,
                                idle_timeout_s=idle_timeout_s,
                                max_sessions=max_sessions),
            placement=None,
            share_encoders=share_encoders,
            max_history=max_history, time_fn=time_fn, device=device)
