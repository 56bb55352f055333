"""The paper's primary contribution: EMSServe — modality-aware model
splitting, per-modality feature caching, and adaptive edge offloading
for asynchronously-arriving multimodal EMS data."""
from .bucketing import (Bucketer, RaggedBatch, bucket_length,  # noqa: F401
                        next_pow2, stack_bucketed)
from .engine import EMSServe, EventRecord  # noqa: F401
from .episodes import (Event, LAG_SCENARIOS, async_episode,  # noqa: F401
                       horizon, merge_arrivals, random_episode, table6)
from .feature_cache import FeatureCache, StalenessError  # noqa: F401
from .modular import (MultimodalModule, emsnet_module,  # noqa: F401
                      emsnet_subset_module, emsnet_zoo)
from .offload import (TIER_FACTORS, AdaptiveOffloadPolicy,  # noqa: F401
                      BandwidthTrace, Decision, HeartbeatMonitor,
                      MultiTierPolicy, ProfileTable, SpeculationPolicy,
                      TierDecision, TierEstimate, nlos_bandwidth)
from .splitter import (SplitModel, feature_sizes,  # noqa: F401
                       payload_nbytes, profile, select_model, split)
