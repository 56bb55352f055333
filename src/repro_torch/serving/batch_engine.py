"""BatchedEMSServe: the batch-only construction of the unified engine.

Cross-session coalescing into one batched call per (modality, bucketed
shape) per consuming model, power-of-two batch rows and one host sync
per flush live in :class:`repro_torch.serving.api.EMSServeEngine` behind
:class:`~repro_torch.serving.api.BatchPolicy`. This module is the thin
constructor shim that keeps the historical surface
(``submit``/``flush``/``run_episodes``, ``FlushReport.recommendations``,
per-model cache keys, unbounded flush history); new code says::

    from repro_torch.serving.api import build_engine
    eng = build_engine(models, params, "batch")

The cache keys (``"{sid}:{model}"``), staleness invariants and model
selection rule are shared with the per-event ``core.engine.EMSServe``,
so a single-session BatchedEMSServe flushed once per event produces the
same recommendations.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..core.bucketing import Bucketer
from ..core.splitter import SplitModel
from .api import (_AUTO, BatchPolicy, EMSServeEngine,  # noqa: F401
                  FlushReport, SessionView)

# historical name, now the one canonical session type
SessionState = SessionView


class BatchedEMSServe(EMSServeEngine):
    """Coalescing multi-session engine over one ``SplitModel`` zoo.

    ``max_coalesce`` caps a single batched call's row count; bigger
    pending groups split into chunks of that size. Flushing is entirely
    caller-driven: ``submit`` never computes, ``flush`` drains everything
    pending.
    """

    def __init__(self, models: Dict[str, SplitModel], params: Dict[str, dict],
                 *, bucketer: Optional[Bucketer] = None,
                 max_coalesce: int = 64, batch_bucket_min: int = 1,
                 device="cuda"):
        super().__init__(
            models, params,
            batch=BatchPolicy(
                bucketer=bucketer if bucketer is not None else _AUTO,
                max_coalesce=max_coalesce,
                batch_bucket_min=batch_bucket_min),
            stream=None, placement=None,
            share_encoders=False,       # per-model cache keys, like EMSServe
            max_history=None,           # callers sum over all flushes
            device=device)
