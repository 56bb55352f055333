"""TieredEMSServe: the tiered-placement construction of the unified
engine.

Glass<->edge split serving on simulated-clock tiers — live per-arrival
offload decisions through the heartbeat-quantized monitor, byte-accounted
in-order feature transport with an edge cache replica synced by feature
VERSION, and heartbeat-detected edge-crash failover to on-glass with the
<=1-step cache-staleness invariant asserted on every re-fusion — all live
in :class:`serving.api.EMSServeEngine` behind
:class:`~serving.api.PlacementPolicy`. This module is the constructor
shim that keeps the historical surface; new code says::

    from repro_torch.serving.api import build_engine
    eng = build_engine(models, params, "tiered",
                       profile=table, trace=trace, share_encoders=True)

and can compose streaming on top (``"stream+tiered"``).

The numerics always run through the real ``SplitModel`` pieces on the
engine's device (``cuda`` unless the caller asks for the CPU): placement
changes the clock, never the math.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..core.bucketing import Bucketer
from ..core.offload import BandwidthTrace, ProfileTable
from ..core.splitter import SplitModel
from .api import (BatchPolicy, EMSServeEngine,  # noqa: F401
                  PlacementPolicy, SessionView, TieredRecord, TierHost)

# historical name, now the canonical unified session type
TierSession = SessionView


class TieredEMSServe(EMSServeEngine):
    """Split-serving runtime over (glass, edge) simulated-clock tiers.

    ``profile`` is the one-time offline profiling result (seconds per
    submodule on this host, scaled to tiers through its factor table);
    ``trace`` drives both the heartbeat monitor (decisions) and the
    transport links (true wire bandwidth). ``force='glass'|'edge'`` pins
    placement for ablations; ``adaptive=False`` always offloads.

    ``tiers=("glass", "ph1", "edge64x")`` generalises to N hosts (first
    entry local, per-host link traces through ``tier_traces``) and turns
    on contention-aware decisions and per-submodule tail placement by
    default; without it, the historical 2-tier contention-blind
    co-located behaviour is kept.

    ``glass_tier``/``edge_tier`` name the legacy pair's profile keys;
    ``hb_period`` is the heartbeat period (1 s) and ``link_latency_s``
    the links' one-way latency (5 ms). ``speculation`` (a
    :class:`~core.offload.SpeculationPolicy`) arms speculative dual
    placement; ``redispatch=True`` re-aims a flight lost to a tier crash
    at the next-best surviving remote instead of always re-running it on
    glass. Both default off.
    """

    def __init__(self, models: Dict[str, SplitModel],
                 params: Dict[str, dict], *,
                 profile: ProfileTable, trace: BandwidthTrace,
                 tiers=None, tier_traces=None,
                 glass_tier: str = "glass", edge_tier: str = "edge4c",
                 hb_period: float = 1.0, link_latency_s: float = 0.005,
                 adaptive: bool = True, force=None,
                 contention_aware: Optional[bool] = None,
                 tail_placement: Optional[bool] = None,
                 speculation=None, redispatch: bool = False,
                 share_encoders: bool = False,
                 bucketer: Optional[Bucketer] = None,
                 max_history: Optional[int] = 256,
                 tracer=None, device="cuda"):
        super().__init__(
            models, params,
            batch=BatchPolicy(bucketer=bucketer),   # None: unbucketed
            stream=None,                            # no glass partials
            placement=PlacementPolicy(
                profile=profile, trace=trace, tiers=tiers,
                tier_traces=tier_traces, glass_tier=glass_tier,
                edge_tier=edge_tier, hb_period=hb_period,
                link_latency_s=link_latency_s, adaptive=adaptive, force=force,
                contention_aware=contention_aware,
                tail_placement=tail_placement, speculation=speculation,
                redispatch=redispatch),
            share_encoders=share_encoders,
            max_history=max_history, tracer=tracer, device=device)
