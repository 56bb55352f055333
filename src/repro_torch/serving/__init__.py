"""The serving layer of the port: the tiered half of the unified
``EMSServeEngine`` (``api``) and its byte-accounted link fabric
(``transport``).

``build_engine(models, params, "tiered", profile=..., trace=...,
tiers=("glass", "ph1", "edge64x"), precision={"ph1": "int8"})`` places
each arrival's encoder and fusion tail on simulated glass/phone/edge
clocks, ships real payload and feature bytes over per-link in-order
channels, fails over from a crashed tier through the versioned feature
cache, and — with a precision map — runs int8 flights through the
hand-written quantize / int8 GEMM kernels and ships packed features.
The batch/stream flush path joins in a later slice.
"""
from .api import (EMSServeEngine, EngineSpec,  # noqa: F401
                  PlacementPolicy, SessionView, TieredRecord, TierHost,
                  build_engine, parse_spec, spec_tokens)
from .transport import (Delivery, MinTrace, TierFabric,  # noqa: F401
                        TransportChannel, payload_nbytes)
