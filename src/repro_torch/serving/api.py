"""One EMSServe: the unified session-engine API.

:class:`EMSServeEngine` serves many concurrent sessions over a
``SplitModel`` zoo. Its behaviour is assembled from composable policy
objects:

  * :class:`BatchPolicy` — cross-session coalescing: shape-bucketed
    inputs (``core.bucketing.Bucketer``) stacked into power-of-two batch
    rows, or with ``ragged=True`` every pending row of a modality packed
    into one buffer (``core.bucketing.RaggedBatch``) and every pending
    fusion in one grouped tail call; one host sync per flush;
  * :class:`StreamPolicy` — progressive partial->final predictions,
    flush deadlines, cross-incident session eviction (idle timeout + LRU
    cap), and, under tiered placement, on-glass provisional partials
    while a remote tier computes the refreshed result;
  * :class:`PlacementPolicy` — N tier hosts on simulated busy-clocks
    (the legacy glass<->edge pair, or an ordered ``tiers`` list like
    ``("glass", "ph1", "edge64x")``), live per-arrival decisions through
    per-link heartbeat-quantized monitors with each host's queueing
    delay in the estimate, per-submodule placement (the fusion tail may
    run on another tier than its encoder), byte-accounted in-order
    per-link transport, heartbeat-detected crash failover from the
    versioned feature cache, tier restart/rejoin with replica re-warm,
    and the int8 precision rung: with ``precision={host: "int8"}`` the
    placement argmin enumerates (tier, precision) jointly, int8 flights
    run the encoders over the int8 sidecar parameters (through the
    hand-written quantize / int8 GEMM kernels) and ship the packed
    ``{"q", "scale"}`` feature, which the consuming tier dequantizes at
    gather time. Two robustness rungs, both off by default:
    ``speculation`` (a ``core.offload.SpeculationPolicy``) races a
    deadline-pressured arrival on glass AND the best remote, commits
    whichever result lands first exactly once and cancels the loser
    (cancel-on-commit); ``redispatch`` re-aims a flight lost to a tier
    crash at the next-best surviving remote instead of glass.
    ``inject_schedule`` replays seeded crash/rejoin cycles
    (``serving.chaos``).

Engines are built from a spec by :func:`build_engine`::

    eng = build_engine(models, params, "batch+stream", share_encoders=True,
                       deadline_s=0.05)
    eng = build_engine(models, params, "tiered", profile=table,
                       trace=trace, tiers=("glass", "ph1", "edge64x"),
                       precision={"ph1": "int8", "edge64x": "int8"},
                       share_encoders=True)

Semantics of composition:

  * ``batch`` alone — caller-driven flushes, one batched encoder call per
    (modality, bucket) per consuming model, one batched tail per
    selected model, ``FlushReport.recommendations`` per touched session;
  * ``stream`` adds deadline-driven flushing, ``partial``/``final``
    tagging on every emitted :class:`Prediction`, and eviction;
  * ``tiered`` switches intake to per-arrival placement on the simulated
    tier clocks (the bucketer, when one is given, still bounds the
    encoder shapes);
  * ``stream+tiered`` — when an arrival offloads, the glasses re-fuse the
    cached (<=1-step stale, asserted live) features into an on-glass
    provisional partial while the remote tier computes the refresh.

A flush-mode engine keeps the sessions' inputs on the host and stages
each stacked or packed batch on the engine's device with one copy per
key; the tensors are computed on that device (``cuda`` unless the caller
asks for the CPU), and a flush waits for the card once, at its end. The
simulated clock decides placement in tiered mode; the tensors are
computed for real there too, once per arrival whatever its placement: a
race's two racers, and a re-dispatched or failed-over flight, share the
tensors computed when the arrival was dispatched.
"""
from __future__ import annotations

import math
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from .. import device as _device
from ..core.bucketing import (Bucketer, RaggedBatch, next_pow2,
                              stack_bucketed, to_device)
from ..core.episodes import Event, merge_arrivals
from ..core.feature_cache import FeatureCache
from ..core.offload import (INT8_COMPUTE_SCALE, BandwidthTrace,
                            HeartbeatMonitor, MultiTierPolicy, ProfileTable,
                            SpeculationPolicy, TierDecision)
from ..core.splitter import SplitModel, select_model
from ..models.quantized import dequantize_feature, quantize_feature
from ..obs import Metrics, Tracer
from .transport import TierFabric, payload_nbytes

__all__ = [
    "Arrival", "Prediction", "FlushReport", "SessionView", "TieredRecord",
    "TierHost", "BatchPolicy", "StreamPolicy", "PlacementPolicy",
    "SpeculationPolicy", "EngineSpec", "EMSServeEngine", "build_engine",
    "parse_spec", "spec_tokens",
]

# the legacy two-tier pair's ProfileTable keys, the heartbeat period the
# monitors quantize bandwidth to (the paper samples every second), and
# each link's one-way latency
LEGACY_TIERS = ("glass", "edge4c")
HB_PERIOD_S = 1.0
LINK_LATENCY_S = 0.005
# the variable-length modalities a RaggedBatch packs
RAGGED_MODALITIES = ("text", "vitals")


def _numel(tree) -> int:
    """Elements in a parameter dict/list tree (shapes only)."""
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return tree.numel() if isinstance(tree, torch.Tensor) else 0


# ======================================================================
# Exchange types
# ======================================================================

@dataclass(frozen=True)
class Arrival:
    """One datum entering the engine: which session, which event, what
    payload. ``EMSServeEngine.ingest`` consumes these; ``submit`` is the
    unpacked form the drivers use."""
    sid: str
    event: Event
    payload: Any = None

    @property
    def modality(self) -> str:
        return self.event.modality

    @property
    def arrival_time(self) -> float:
        return self.event.arrival_time

    @property
    def index(self) -> int:
        return self.event.index


@dataclass
class Prediction:
    """One progressive prediction emitted for a session.

    Flush-mode predictions carry the flush that produced them in
    ``flush_id``; tiered-mode (per-arrival) predictions carry ``-1``
    there and stamp ``t_emit`` on the simulated tier clock instead of
    the engine's ``time_fn``."""
    sid: str
    step: int                       # session step it reflects
    model: str                      # selected model name
    modalities: Tuple[str, ...]     # fused subset, canonical order
    kind: str                       # "partial" | "final"
    outputs: dict                   # head outputs (batch row for sid)
    flush_id: int
    t_emit: float


@dataclass
class FlushReport:
    """What one flush did: arrivals drained, encoder and tail calls, the
    wall time up to and including its one host sync, per-arrival
    latencies, and the emissions — ``predictions`` (tagged
    partial/final) and the last fused head outputs per touched session
    in ``recommendations`` (the same rows, indexed by session)."""
    flush_id: int
    n_events: int
    n_encoder_calls: int
    n_tail_calls: int
    wall_s: float
    latencies: Dict[Tuple[str, int], float]     # (sid, event idx) -> s
    predictions: List[Prediction] = field(default_factory=list)
    recommendations: Dict[str, dict] = field(default_factory=dict)
    # padding-tax accounting: weighted position counts this flush's calls
    # spent on real data vs bucket/batch padding (weights are each
    # submodule's parameter count — a MAC-proportional estimate, not a
    # hardware FLOP counter)
    flops_useful: float = 0.0
    flops_padded: float = 0.0

    @property
    def padded_flop_frac(self) -> float:
        total = self.flops_useful + self.flops_padded
        return self.flops_padded / total if total else 0.0


@dataclass
class SessionView:
    """Per-session state, one shape for every composition. Flush-mode
    engines use the intake/prediction fields; tiered placement adds the
    simulated-clock fields (``ready_at``, ``records``, ``t_*_emit``)."""
    sid: str
    inputs: Dict[str, object] = field(default_factory=dict)
    input_step: Dict[str, int] = field(default_factory=dict)
    step: int = 0
    dirty: set = field(default_factory=set)   # modalities changed since flush
    events_seen: int = 0
    last_recommendation: Optional[dict] = None
    predictions: List["Prediction"] = field(default_factory=list)
    finalized: bool = False                   # has emitted a final prediction
    t_first_submit: Optional[float] = None    # time_fn clock
    t_first_prediction: Optional[float] = None
    t_final_prediction: Optional[float] = None
    t_last_activity: Optional[float] = None   # last submit or emission
    # ---- tiered placement (simulated episode clock)
    ready_at: float = 0.0                     # per-session in-order processing
    records: List["TieredRecord"] = field(default_factory=list)
    t_first_arrival: Optional[float] = None   # survives record trimming
    t_first_emit: Optional[float] = None
    t_final_emit: Optional[float] = None


@dataclass
class TierHost:
    """One hardware tier with its own busy-until simulated clock."""
    name: str                   # display name ('glass' | 'edge' | 'ph1' ...)
    tier: str                   # key into ProfileTable.factors
    profile: ProfileTable
    free_at: float = 0.0
    busy_s: float = 0.0
    calls: int = 0
    tracer: Optional[Tracer] = None

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer.disabled

    def time(self, submodule: str) -> float:
        return self.profile.time(submodule, self.tier)

    def occupy(self, duration: float, t_start: float,
               label: Optional[str] = None) -> Tuple[float, float]:
        """Book ``duration`` seconds of compute no earlier than
        ``t_start``; returns (start, done) on the simulated clock."""
        start = max(t_start, self.free_at)
        done = start + duration
        self.free_at = done
        self.busy_s += duration
        self.calls += 1
        if self.tracer:
            self.tracer.span(label or f"compute@{self.name}", "compute",
                             start, done, track=f"host:{self.name}",
                             host=self.name, queued_s=start - t_start)
        return start, done

    def release(self, start: float, done: float, t: float):
        """Unwind the un-run tail of the MOST RECENT booking: a
        speculative racer cancelled at commit instant ``t`` frees the
        host from ``max(start, t)`` on (cancel-on-commit — the loser
        stops computing the moment the winner's result lands). A no-op
        if something was booked after, so only the latest racer may be
        released."""
        if self.free_at != done:
            return
        cut = max(start, min(t, done))
        self.busy_s -= done - cut
        self.free_at = cut
        if self.tracer:
            self.tracer.instant("host.release", "speculation", t,
                                track=f"host:{self.name}", host=self.name,
                                freed_s=done - cut)


@dataclass
class _TierFault:
    """Crash / detection / restart state of one remote tier."""
    crash_at: Optional[float] = None     # when the box actually dies
    detect_at: Optional[float] = None    # first missed heartbeat after it
    rejoin_at: Optional[float] = None    # when a restarted box comes back
    dead: bool = False                   # the glasses KNOW it is gone


@dataclass
class TieredRecord:
    """Timeline of one arrival through tiered placement. ``tier`` names
    whichever host ran the encoder; per-submodule placement is broken out
    in ``enc_tier``/``tail_tier`` (the tail may run on a third host, or
    nowhere while the modality subset is incomplete)."""
    sid: str
    index: int
    modality: str
    model: Optional[str]
    tier: str                   # host that ran the encoder (bulk compute)
    kind: str                   # 'partial' | 'final'
    t_arrival: float
    t_start: float              # when the glasses picked the event up
    t_emit: float               # when the prediction reached the glasses
    uplink_s: float = 0.0       # payload + cache-sync transfer time
    downlink_s: float = 0.0     # feature + outputs return transfer time
    compute_s: float = 0.0
    fallback: bool = False      # a tier crashed mid-flight; re-ran on glass
    detect_s: float = 0.0       # stall waiting on missed-heartbeat detection
    decision: Optional[TierDecision] = None
    outputs: Optional[dict] = None
    enc_tier: Optional[str] = None
    tail_tier: Optional[str] = None             # None: no fusion ran
    tail_decision: Optional[TierDecision] = None
    # stream x tiered composition: the on-glass provisional prediction
    # emitted from cached features while this arrival's refresh was away
    glass_partial: Optional[Prediction] = None
    # speculative dual placement: this arrival raced glass against the
    # best remote; the winner's timeline is the record's, the loser's
    # would-have-emitted instant is kept for the win-margin analysis
    speculative: bool = False
    race_winner: Optional[str] = None
    race_loser_emit: Optional[float] = None
    # numeric precision the encoder flight ran at ("fp32" | "int8"): int8
    # means the sidecar-quantized encoder computed the feature and the
    # cache/wire carry its packed {"q", "scale"} form
    precision: str = "fp32"

    @property
    def latency_s(self) -> float:
        return self.t_emit - self.t_arrival


# ======================================================================
# Composable policies
# ======================================================================

_AUTO = "auto"      # BatchPolicy.bucketer sentinel: derive from the models


@dataclass
class BatchPolicy:
    """Cross-session coalescing knobs.

    ``bucketer="auto"`` derives per-modality length caps from the
    models' declared ``max_lengths`` (so padding never exceeds e.g. a
    positional table); pass an explicit :class:`Bucketer` to control the
    grid, or ``None`` to disable shape bucketing (tiered default).
    ``batch_bucket_min`` floors the coalesced batch axis so a steady
    session count serves ONE batch shape.

    ``ragged=True`` switches variable-length modalities (text, vitals)
    from per-bucket stacked calls to the concatenated ragged layout
    (``core.bucketing.RaggedBatch``): ONE encoder call per modality per
    flush however many length buckets are live, and ONE grouped fusion
    tail across all pending sessions and modality subsets (when the zoo
    shares one parameter dict — ``share_encoders`` zoos; engines with
    per-model parameters keep the per-model tail loop). ``ragged_align``
    must equal the model's text ``flash_block``: packed rows start on
    the segment kernel's block boundaries. Packed rows agree with the
    bucketed ones to float32 rounding, not bit for bit: the kernel and
    the GEMMs sum a row in another order inside a longer buffer. Defaults
    OFF: the bucketed path stays the default."""
    bucketer: Union[Bucketer, None, str] = _AUTO
    max_coalesce: int = 64
    batch_bucket_min: int = 1
    ragged: bool = False
    ragged_align: int = 8


@dataclass
class StreamPolicy:
    """Progressive-prediction and liveness knobs.

    ``deadline_s``: 0 flushes on every submit, > 0 buffers arrivals until
    the oldest pending one is that old, None leaves flushing entirely to
    the caller. ``idle_timeout_s``/``max_sessions`` drive cross-incident
    eviction — swept after every flush and ``poll()`` (wall clock), or
    after every arrival under tiered placement (simulated clock, where
    the wall-clock ``poll()`` must not sweep). ``glass_partials``
    (tiered composition only): emit an on-glass provisional partial
    from cached features while an offloaded arrival is in flight."""
    deadline_s: Optional[float] = 0.0
    idle_timeout_s: Optional[float] = None
    max_sessions: Optional[int] = None
    glass_partials: bool = True


@dataclass
class PlacementPolicy:
    """Tier placement knobs — two named tiers by default (the historical
    glass<->edge pair), or an ordered N-tier list.

    ``profile`` is the one-time offline profiling result; ``trace``
    drives both the heartbeat monitors (decisions) and the transport
    links (true wire bandwidth). ``tiers`` is an ordered list of
    ``ProfileTable.factors`` keys whose FIRST entry is the local host
    (the glasses); each remote's link defaults to ``trace`` and can be
    overridden per host via ``tier_traces``. With ``tiers`` set,
    ``contention_aware`` (each host's work-queue delay enters its
    estimate) and ``tail_placement`` (the fusion tail is placed apart
    from its encoder) default on; without, both default off. ``force``
    pins placement (a host name, or ``{submodule: host}``);
    ``adaptive=False`` always offloads to the cheapest remote.

    The two robustness rungs, both off by default so every historical
    timeline stays the same: ``speculation`` (a
    :class:`SpeculationPolicy`) races an arrival whose estimated
    completion leaves less than the margin before its deadline on glass
    AND the best remote, commits whichever returns first and cancels the
    loser (cancel-on-commit); ``redispatch`` re-aims a flight lost to a
    tier crash at the next-best SURVIVING remote (glass only when none
    survives) instead of always re-running it on glass.

    ``precision`` (``{host: "int8"}``) arms the quantized rung: an int8
    candidate scales a tier's encoder compute by ``INT8_COMPUTE_SCALE``
    and its feature-return bytes by ``INT8_BYTES_SCALE`` in the estimate
    (``core.offload``); real flights ship the real packed bytes. ``None``
    or an all-fp32 map keeps the engine bit-identical to the
    precision-less one. Every model must declare a ``quantize_fn`` or the
    engine refuses to build."""
    profile: ProfileTable
    trace: BandwidthTrace
    tiers: Optional[Tuple[str, ...]] = None
    tier_traces: Optional[Dict[str, BandwidthTrace]] = None
    adaptive: bool = True
    force: Optional[Union[str, Dict[str, str]]] = None
    contention_aware: Optional[bool] = None     # None = on iff N-tier
    tail_placement: Optional[bool] = None       # None = on iff N-tier
    speculation: Optional[SpeculationPolicy] = None
    redispatch: bool = False
    precision: Optional[Dict[str, str]] = None  # host -> "fp32" | "int8"


@dataclass
class EngineSpec:
    """A typed engine recipe — which policies are on, plus the
    engine-wide options — produced by :func:`parse_spec`."""
    batch: Optional[BatchPolicy] = None
    stream: Optional[StreamPolicy] = None
    placement: Optional[PlacementPolicy] = None
    share_encoders: bool = False
    max_history: Optional[int] = 256

    def enabled(self) -> Tuple[str, ...]:
        return tuple(name for name, pol in (("batch", self.batch),
                                            ("stream", self.stream),
                                            ("tiered", self.placement))
                     if pol is not None)


# ======================================================================
# The engine
# ======================================================================

class EMSServeEngine:
    """The multi-session serving runtime over a ``SplitModel`` zoo.

    ``models``/``params`` are shared across sessions (one weight copy);
    params must already live on ``device``. Behaviour composes from the
    policy objects (module docstring). ``share_encoders=True`` is for
    zoos built by ``core.modular.emsnet_zoo`` whose subset models share
    one parameter dict: a feature is encoded once in total (cache keys
    are session-level) instead of once per consuming model
    (``"{sid}:{model}"`` keys). ``time_fn`` is injectable so tests drive
    a fake wall clock; tiered placement runs on the simulated episode
    clock instead.
    """

    def __init__(self, models: Dict[str, SplitModel],
                 params: Dict[str, dict], *,
                 batch: Optional[BatchPolicy] = None,
                 stream: Optional[StreamPolicy] = None,
                 placement: Optional[PlacementPolicy] = None,
                 share_encoders: bool = False,
                 max_history: Optional[int] = 256,
                 time_fn: Callable[[], float] = time.perf_counter,
                 tracer: Optional[Tracer] = None, device="cuda"):
        self.device = _device.resolve(device)
        self.models = models
        self.params = params
        self.batch_policy = batch or BatchPolicy()
        self.stream_policy = stream
        self.placement_policy = placement
        self.share_encoders = share_encoders
        self.max_history = max_history
        self.time_fn = time_fn

        # ---- observability: one metrics registry for the whole stack
        # (engine + cache + transport), and a span tracer defaulting to
        # the falsy no-op
        self.metrics = Metrics()
        self.tracer = tracer if tracer is not None else Tracer.disabled
        if self.tracer and placement is None and self.tracer.clock is None:
            # flush-mode engines run on the injected wall clock; tiered
            # engines call set_time() at each simulated-clock arrival
            self.tracer.clock = self.time_fn
        self.metrics.gauge_fn("engine.sessions_live",
                              lambda: len(self.sessions))
        self.metrics.gauge_fn("cache.entries", lambda: len(self.cache))
        # source-step metadata of the most recent _gather, consumed by
        # the fuse trace point (tracer-gated; {} when tracing is off)
        self._last_consumed: dict = {}

        # ---- batch policy -> coalescing state
        bucketer = self.batch_policy.bucketer
        if bucketer == _AUTO:
            # a default grid only for flush-mode engines; tiered placement
            # runs unbucketed unless a bucketer is given
            bucketer = (self._derive_bucketer(models)
                        if placement is None else None)
        self.bucketer: Optional[Bucketer] = bucketer
        self.max_coalesce = self.batch_policy.max_coalesce
        self.batch_bucket_min = self.batch_policy.batch_bucket_min
        self.ragged: Optional[RaggedBatch] = None
        if self.batch_policy.ragged:
            self.ragged = RaggedBatch(
                align=self.batch_policy.ragged_align,
                min_rows=self.batch_policy.batch_bucket_min,
                max_lengths=self._length_caps(models))
        # per-(model, subtree) parameter counts, the flop-estimate weights
        # of FlushReport's padding-tax accounting; and the zero feature
        # rows a grouped tail fuses for modalities outside a row's subset
        self._flop_w: Dict[Tuple[str, str], float] = {}
        self._zero_rows: Dict[str, torch.Tensor] = {}

        # ---- stream policy -> deadline / eviction state
        sp = stream
        self.deadline_s = sp.deadline_s if sp is not None else None
        self.idle_timeout_s = sp.idle_timeout_s if sp is not None else None
        self.max_sessions = sp.max_sessions if sp is not None else None
        self.glass_partials = bool(sp is not None and sp.glass_partials
                                   and placement is not None)

        # ---- shared session/cache state
        self.cache = FeatureCache(max_staleness=1, metrics=self.metrics,
                                  tracer=self.tracer)
        self.sessions: Dict[str, SessionView] = {}
        # every modality ANY model consumes: a prediction fusing all of
        # them cannot be refined further -> tagged "final"
        self.full_set = frozenset(m for sm in models.values()
                                  for m in sm.modalities())
        self._pending: List[Tuple[str, int, float]] = []  # (sid, idx, t_submit)
        self.flushes: List[FlushReport] = []              # bounded window
        self.events_total = 0
        self.flushes_total = 0
        self._enc_calls_total = 0
        self._tail_calls_total = 0

        self.records: List[TieredRecord] = []
        if placement is not None:
            self._init_placement(placement)

    def _init_placement(self, pp: PlacementPolicy):
        """Placement policy -> tier hosts, link fabric, fault state."""
        models = self.models
        self.profile = pp.profile
        multi = pp.tiers is not None
        # host names double as ProfileTable factor keys in N-tier mode;
        # the legacy pair keeps its historical display names
        names = list(pp.tiers) if multi else ["glass", "edge"]
        keys = names if multi else list(LEGACY_TIERS)
        if len(names) < 2:
            raise ValueError("tiered placement needs the local host plus "
                             "at least one remote tier")
        self.local_name = names[0]
        self.hosts: Dict[str, TierHost] = {
            n: TierHost(n, k, pp.profile, tracer=self.tracer)
            for n, k in zip(names, keys)}
        self.remote_names = names[1:]
        traces = {n: (pp.tier_traces or {}).get(n, pp.trace)
                  for n in self.remote_names}
        self.monitors = {n: HeartbeatMonitor(traces[n], period=HB_PERIOD_S)
                         for n in self.remote_names}
        self.fabric = TierFabric(self.local_name, traces,
                                 latency_s=LINK_LATENCY_S,
                                 metrics=self.metrics, tracer=self.tracer)
        # ---- quantized rung: validate the precision map up front (a bad
        # host name or a zoo without quantize_fn is a configuration error,
        # not a first-decision surprise), then arm the joint (tier,
        # precision) enumeration only when some host serves int8 — an
        # all-fp32 map is the legacy bit-identical rule
        prec_cfg = dict(pp.precision or {})
        for h, p in prec_cfg.items():
            if h not in names or p not in ("fp32", "int8"):
                raise ValueError(
                    f"precision[{h!r}]={p!r}: unknown host or precision "
                    f"(hosts {sorted(names)}, precisions fp32/int8)")
        int8_hosts = sorted(h for h, p in prec_cfg.items() if p == "int8")
        if int8_hosts:
            for mname, sm in models.items():
                if sm.module.quantize_fn is None:
                    raise ValueError(
                        f"precision={prec_cfg} needs an int8 variant of "
                        f"every model; {mname!r} declares no quantize_fn")
        # float32 dict id() -> derived int8 sidecar dict: derived ONCE per
        # distinct parameter dict, so share_encoders zoos (one dict for
        # the whole zoo) quantize exactly once
        self._qparams_cache: Dict[int, dict] = {}
        self.policy = MultiTierPolicy(
            pp.profile, self.monitors, local=self.local_name,
            tier_of={n: h.tier for n, h in self.hosts.items()},
            adaptive=pp.adaptive, force=pp.force,
            speculation=pp.speculation,
            precisions=({h: ("fp32", "int8") for h in int8_hosts}
                        if int8_hosts else None))
        self.redispatch = pp.redispatch
        # the fastest remote is the legacy 'edge' of the 2-tier surface
        self._primary = min(
            self.remote_names,
            key=lambda n: pp.profile.factors[self.hosts[n].tier])
        self.contention_aware = (multi if pp.contention_aware is None
                                 else pp.contention_aware)
        self.tail_placement = (multi if pp.tail_placement is None
                               else pp.tail_placement)
        # per-tier replica freshness: (cache key, modality) -> feature
        # VERSION that host holds (versions bump only on real re-encodes;
        # steps get re-stamped by every touch)
        self._replica_versions: Dict[str, Dict[Tuple[str, str], int]] = {
            n: {} for n in self.remote_names}
        # fault injection / detection / restart, per remote tier;
        # _schedule holds the not-yet-armed chaos cycles per tier
        self._faults: Dict[str, _TierFault] = {
            n: _TierFault() for n in self.remote_names}
        self._schedule: Dict[str, deque] = {}
        self._host_names = list(names)
        self._total_latency = 0.0

    # ---- counters (read-through to the registry)
    @property
    def evicted_count(self) -> int:
        return int(self.metrics.get("engine.evicted_sessions"))

    @property
    def fallback_count(self) -> int:
        return int(self.metrics.get("placement.fallbacks"))

    @property
    def rejoin_count(self) -> int:
        return int(self.metrics.get("placement.rejoins"))

    @property
    def place_counts(self) -> Dict[str, int]:
        return {n: int(self.metrics.get(f"placement.enc.{n}"))
                for n in self._host_names}

    @property
    def tail_counts(self) -> Dict[str, int]:
        return {n: int(self.metrics.get(f"placement.tail.{n}"))
                for n in self._host_names}

    @property
    def spec_count(self) -> int:
        return int(self.metrics.get("speculation.races"))

    @property
    def spec_wins(self) -> Dict[str, int]:
        return {n: int(self.metrics.get(f"speculation.wins.{n}"))
                for n in self._host_names}

    @property
    def spec_crash_saves(self) -> int:
        return int(self.metrics.get("speculation.crash_saves"))

    @property
    def redispatch_count(self) -> int:
        return int(self.metrics.get("placement.redispatches"))

    def metrics_snapshot(self) -> dict:
        """One JSON-serialisable snapshot of every counter, gauge, and
        latency histogram (p50/p95/p99) the stack accumulated."""
        return self.metrics.snapshot()

    # ------------------------------------------------------------ setup

    @staticmethod
    def _length_caps(models: Dict[str, SplitModel]) -> Dict[str, int]:
        """Hard length caps from the models (e.g. the text positional
        table), the tightest over the zoo."""
        limits: Dict[str, int] = {}
        for sm in models.values():
            for m, n in sm.module.max_lengths.items():
                limits[m] = min(limits.get(m, n), n)
        return limits

    @classmethod
    def _derive_bucketer(cls, models: Dict[str, SplitModel]) -> Bucketer:
        """A bucket grid that never pads past what the models accept."""
        return Bucketer(max_buckets=cls._length_caps(models))

    @property
    def tiered(self) -> bool:
        return self.placement_policy is not None

    # ------------------------------------------------------------ intake

    def session(self, sid: str) -> SessionView:
        st = self.sessions.get(sid)
        if st is None:
            st = self.sessions[sid] = SessionView(sid)
        return st

    def ingest(self, arrival: Arrival, *, aggregate=None):
        """Canonical-typed intake: unpacks an :class:`Arrival`."""
        return self.submit(arrival.sid, arrival.event, arrival.payload,
                           aggregate=aggregate)

    def submit(self, sid: str, event: Event, payload, *, aggregate=None):
        """Record one arriving datum (a tensor or numpy array).
        ``aggregate(old, new) -> input`` merges it into the modality's
        aggregated input (default: replace).

        Flush mode (no placement): buffers the arrival on the host and
        flushes if the deadline policy says so — returns the
        :class:`FlushReport` when one ran, else None. Tiered placement:
        moves the payload to the engine's device, processes the arrival
        end to end on the decided tiers and returns its
        :class:`TieredRecord`."""
        if self.tiered:
            return self._submit_tiered(sid, event, payload,
                                       aggregate=aggregate)
        now = self.time_fn()
        st = self._intake(sid, event, payload, aggregate)
        st.t_last_activity = now
        if st.t_first_submit is None:
            st.t_first_submit = now
        if self.tracer:
            self.tracer.instant("arrival", "arrival", now,
                                track=f"session:{sid}", sid=sid,
                                index=event.index,
                                modality=event.modality, step=st.step)
        self._pending.append((sid, event.index, now))
        if self.deadline_s is None:
            return None
        if self.deadline_s <= 0.0:
            return self.flush()
        if now - self._pending[0][2] >= self.deadline_s:
            return self.flush()
        return None

    def _intake(self, sid: str, event: Event, payload,
                aggregate) -> SessionView:
        """Input-aggregation bookkeeping shared by both modes. Tiered
        intake computes on the arrival, so its payload goes to the
        device; flush-mode intake keeps it on the host, where a flush
        stacks or packs it with the other sessions' rows."""
        st = self.session(sid)
        st.step += 1
        m = event.modality
        payload = torch.as_tensor(
            payload, device=self.device if self.tiered else "cpu")
        old = st.inputs.get(m)
        st.inputs[m] = aggregate(old, payload) if aggregate else payload
        st.input_step[m] = st.step
        st.dirty.add(m)
        st.events_seen += 1
        self.events_total += 1
        return st

    def poll(self, now: Optional[float] = None) -> Optional[FlushReport]:
        """Flush if the oldest pending arrival has exceeded the deadline;
        also the idle hook where session eviction runs. A no-op under
        tiered placement (nothing buffers there)."""
        if self.tiered:
            return None
        now = self.time_fn() if now is None else now
        if self._pending and self.deadline_s is not None \
                and now - self._pending[0][2] >= self.deadline_s:
            return self.flush()
        self.evict_sessions(now)
        return None

    def drain(self) -> Optional[FlushReport]:
        """Flush whatever is pending, deadline or not."""
        if self.tiered:
            return None
        return self.flush() if self._pending else None

    def pending_count(self) -> int:
        """Arrivals buffered but not yet flushed (the event-loop driver
        pumps poll() until this reaches zero)."""
        return len(self._pending)

    # ------------------------------------------------------------- flush

    def _cache_key(self, sid: str, model_name: str) -> str:
        return sid if self.share_encoders else f"{sid}:{model_name}"

    def _bucket_rows(self, n: int) -> int:
        return max(self.batch_bucket_min, next_pow2(n))

    def _consumers(self, m: str):
        return [(n, sm) for n, sm in self.models.items()
                if m in sm.modalities()]

    def _bucketed(self, m: str, x):
        return self.bucketer.fit(m, x) if self.bucketer else x

    def _encode_groups(self, sids):
        """Dirty (session, modality) work grouped by identical post-bucket
        shape: each group is one stacked encoder call. Modalities no model
        consumes are skipped BEFORE the bucketer sees them, so the bucket
        histogram counts served groups only."""
        groups = defaultdict(list)  # (modality, shape) -> [(sid, payload, nat)]
        for sid in sids:
            st = self.sessions[sid]
            for m in sorted(st.dirty):
                if not self._consumers(m):
                    continue
                p = self._bucketed(m, st.inputs[m])
                shape = (tuple(p["x"].shape) if isinstance(p, dict)
                         else tuple(p.shape))
                groups[(m, shape)].append(
                    (st.sid, p, self._nat_len(st.inputs[m])))
        return groups

    @staticmethod
    def _nat_len(x) -> int:
        """Real (pre-padding) sequence length of a raw modality input:
        axis 1 for (B, S, ...) payloads, 1 for fixed-size vectors."""
        return int(x.shape[1]) if x.dim() >= 2 else 1

    def _weight(self, name: str, key: str) -> float:
        """Parameter count of ``params[name][key]`` — the per-position
        weight of the padding-tax estimate in :class:`FlushReport` (1.0
        when the subtree is not addressable). Counted once per (model,
        subtree): shapes only, no device read."""
        k = (name, key)
        w = self._flop_w.get(k)
        if w is None:
            p = self.params.get(name)
            sub = p.get(key) if isinstance(p, dict) else None
            w = float(_numel(sub)) or 1.0
            self._flop_w[k] = w
        return w

    def _run_encoder_chunk(self, m, sids, batch, upos, total_pos):
        """Run every consuming model's encoder over one prepared batch
        (stacked or packed, on the device), scatter rows into the feature
        cache, and account the padding tax. Returns (n_calls, useful,
        padded)."""
        runners = (self._consumers(m)[:1] if self.share_encoders
                   else self._consumers(m))
        n, useful, padded = 0, 0.0, 0.0
        for name, sm in runners:
            feats = sm.encoders[m](self.params[name], batch)
            n += 1
            w = self._weight(name, m)
            useful += w * upos
            padded += w * (total_pos - upos)
            for i, sid in enumerate(sids):
                st = self.sessions[sid]
                self.cache.put(self._cache_key(sid, name), m,
                               feats[i:i + 1], step=st.step, tier="glass")
        return n, useful, padded

    def _flush_encode(self, touched):
        """Bucketed encode: one stacked call per (modality, bucket[,
        chunk]) per consuming model."""
        n_enc, useful, padded = 0, 0.0, 0.0
        for (m, _shape), items in self._encode_groups(touched).items():
            for c0 in range(0, len(items), self.max_coalesce):
                chunk = items[c0:c0 + self.max_coalesce]
                stacked = stack_bucketed([p for _, p, _ in chunk],
                                         self._bucket_rows(len(chunk)))
                lead = stacked["x"] if isinstance(stacked, dict) else stacked
                plen = lead.shape[1] if lead.dim() >= 2 else 1
                upos = sum(min(nat, plen) for _, _, nat in chunk)
                c, u, pd = self._run_encoder_chunk(
                    m, [sid for sid, _, _ in chunk],
                    to_device(stacked, self.device), upos,
                    lead.shape[0] * plen)
                n_enc += c
                useful += u
                padded += pd
        return n_enc, useful, padded

    def _flush_encode_ragged(self, touched):
        """Ragged encode: ONE packed call per variable-length modality
        (per chunk, per consuming model) however many length buckets are
        live; fixed-size modalities keep the stacked path."""
        n_enc, useful, padded = 0, 0.0, 0.0
        ragged_mods = defaultdict(list)      # m -> [(sid, raw, nat)]
        fixed = defaultdict(list)            # (m, shape) -> [(sid, raw, nat)]
        for sid in touched:
            st = self.sessions[sid]
            for m in sorted(st.dirty):
                if not self._consumers(m):
                    continue
                x = st.inputs[m]
                if m in RAGGED_MODALITIES:
                    ragged_mods[m].append((st.sid, x, self._nat_len(x)))
                else:
                    fixed[(m, tuple(x.shape))].append(
                        (st.sid, x, self._nat_len(x)))
        for m, items in sorted(ragged_mods.items()):
            cap = self.ragged.max_lengths.get(m)
            for c0 in range(0, len(items), self.max_coalesce):
                chunk = items[c0:c0 + self.max_coalesce]
                packed = self.ragged.pack(m, [x for _, x, _ in chunk],
                                          device=self.device)
                total = (packed["tokens"] if m == "text"
                         else packed["x"]).shape[1]
                upos = sum(nat if cap is None else min(nat, cap)
                           for _, _, nat in chunk)
                c, u, pd = self._run_encoder_chunk(
                    m, [sid for sid, _, _ in chunk], packed, upos, total)
                n_enc += c
                useful += u
                padded += pd
        for (m, _shape), items in sorted(fixed.items()):
            for c0 in range(0, len(items), self.max_coalesce):
                chunk = items[c0:c0 + self.max_coalesce]
                stacked = stack_bucketed([x for _, x, _ in chunk],
                                         self._bucket_rows(len(chunk)))
                rows = (stacked["x"] if isinstance(stacked, dict)
                        else stacked).shape[0]
                c, u, pd = self._run_encoder_chunk(
                    m, [sid for sid, _, _ in chunk],
                    to_device(stacked, self.device), len(chunk), rows)
                n_enc += c
                useful += u
                padded += pd
        return n_enc, useful, padded

    def _flush_tails(self, tail_groups):
        """One batched tail call per selected model (per chunk)."""
        n_tail, useful, padded = 0, 0.0, 0.0
        emitted = []      # (sid, name, modalities, outputs, step)
        for name, items in tail_groups.items():
            sm = self.models[name]
            mods = sm.modalities()
            w = self._weight(name, "heads")
            for c0 in range(0, len(items), self.max_coalesce):
                chunk = items[c0:c0 + self.max_coalesce]
                sids = [sid for sid, _ in chunk]
                stacked = {mm: stack_bucketed([f[mm] for _, f in chunk],
                                              self._bucket_rows(len(chunk)))
                           for mm in mods}
                outs = sm.tail(self.params[name], stacked)
                n_tail += 1
                rows = next(iter(stacked.values())).shape[0]
                useful += w * len(chunk)
                padded += w * (rows - len(chunk))
                for i, sid in enumerate(sids):
                    st = self.sessions[sid]
                    row = {k: v[i:i + 1] for k, v in outs.items()}
                    emitted.append((sid, name, tuple(mods), row, st.step))
                    for mm in mods:   # the result carries the cache back
                        self.cache.touch(self._cache_key(sid, name), mm,
                                         st.step)
        return n_tail, emitted, useful, padded

    def _grouped_tail_target(self, tail_groups) -> Optional[str]:
        """The ONE grouped tail is legal when a full-fusion model exists,
        declares its feature widths, and every pending model shares its
        parameter dict (``share_encoders`` zoos): subset heads are then
        row-slices of the full heads, so a zero-filled slice for a missing
        modality contributes exactly zero to the fusion GEMM and the full
        tail computes every subset tail. Returns the full model's name,
        or None to keep the per-model loop."""
        full_name = next((n for n, sm in self.models.items()
                          if frozenset(sm.modalities()) == self.full_set),
                         None)
        if full_name is None:
            return None
        dims = self.models[full_name].module.feature_dims
        if not all(m in dims for m in self.full_set):
            return None
        if not all(self.params[n] is self.params[full_name]
                   for n in tail_groups):
            return None
        return full_name

    def _zero_row(self, m: str, width: int) -> torch.Tensor:
        z = self._zero_rows.get(m)
        if z is None:
            z = self._zero_rows[m] = torch.zeros(
                (1, width), dtype=torch.float32, device=self.device)
        return z

    def _flush_tails_grouped(self, tail_groups, full_name):
        """ONE stacked tail call for every pending (session, subset): a
        flush then issues O(modalities) + 1 calls instead of
        O(modalities x buckets) + O(subsets). Each row is the full-width
        F_C with zeros in the slices of modalities outside that row's
        subset; the padding-tax account charges those zero slices as
        padding."""
        full_sm = self.models[full_name]
        full_mods = full_sm.modalities()
        dims = full_sm.module.feature_dims
        fullw = float(sum(dims[m] for m in full_mods))
        w = self._weight(full_name, "heads")
        rows = [(sid, name, f)
                for name, items in tail_groups.items()
                for sid, f in items]
        n_tail, useful, padded = 0, 0.0, 0.0
        emitted = []
        for c0 in range(0, len(rows), self.max_coalesce):
            chunk = rows[c0:c0 + self.max_coalesce]
            nb = self._bucket_rows(len(chunk))
            stacked = {
                m: stack_bucketed(
                    [f.get(m, self._zero_row(m, dims[m]))
                     for _, _, f in chunk], nb)
                for m in full_mods}
            outs = full_sm.tail(self.params[full_name], stacked)
            n_tail += 1
            subw = sum(sum(dims[m] for m in self.models[name].modalities())
                       for _, name, _ in chunk) / fullw
            useful += w * subw
            padded += w * (nb - subw)
            for i, (sid, name, _f) in enumerate(chunk):
                st = self.sessions[sid]
                row = {k: v[i:i + 1] for k, v in outs.items()}
                mods = self.models[name].modalities()
                emitted.append((sid, name, tuple(mods), row, st.step))
                for mm in mods:
                    self.cache.touch(self._cache_key(sid, name), mm, st.step)
        return n_tail, emitted, useful, padded

    def _flush_compute(self, touched):
        """The device work of a flush, queued without waiting: the
        batched encodes (bucketed or ragged), then the re-fusion of every
        dirty session whose selected model's features are all cached."""
        # ---- batched encode + scatter rows into the feature cache
        if self.ragged is not None:
            n_enc, enc_u, enc_p = self._flush_encode_ragged(touched)
        else:
            n_enc, enc_u, enc_p = self._flush_encode(touched)

        # ---- progressive re-fusion: batched tails per selected model
        tail_groups = defaultdict(list)    # model name -> [(sid, feats)]
        consumed_meta: Dict[Tuple[str, str], dict] = {}
        for sid in touched:
            st = self.sessions[sid]
            if not st.dirty:
                continue
            st.dirty.clear()
            name = select_model(self.models, st.inputs)
            if name is None:
                continue
            sm = self.models[name]
            feats = self.cache.features(self._cache_key(st.sid, name),
                                        sm.modalities(),
                                        input_steps=st.input_step)
            if feats is not None:
                tail_groups[name].append((st.sid, feats))
                if self.tracer:
                    # snapshot source steps BEFORE the tail path re-stamps
                    # them via cache.touch
                    key = self._cache_key(st.sid, name)
                    consumed_meta[(st.sid, name)] = {
                        m: [self.cache.peek(key, m).step,
                            st.input_step.get(m, 0)]
                        for m in sm.modalities()}

        full_name = (self._grouped_tail_target(tail_groups)
                     if self.ragged is not None and tail_groups else None)
        if full_name is not None:
            n_tail, emitted, tail_u, tail_p = self._flush_tails_grouped(
                tail_groups, full_name)
        else:
            n_tail, emitted, tail_u, tail_p = self._flush_tails(tail_groups)

        return (n_enc, enc_u, enc_p, n_tail, emitted, tail_u, tail_p,
                consumed_meta)

    def flush(self) -> FlushReport:
        """Run all pending work: one batched encoder call per (modality,
        bucket[, chunk]) per consuming model (ONE in total with
        ``share_encoders``), scatter rows into the feature cache, one
        batched tail per selected model, emit progressive predictions,
        and wait for the card ONCE. Nothing before that wait reads a
        device value; ``wall_s`` includes it."""
        if self.tiered:
            raise RuntimeError(
                "flush() is a flush-mode operation; tiered placement "
                "processes each arrival in submit()")
        t0 = self.time_fn()
        # every dirty marking comes with a _pending entry, so only the
        # pending sessions can have work
        touched = sorted({sid for sid, _, _ in self._pending})

        with torch.inference_mode():
            (n_enc, enc_u, enc_p, n_tail, emitted, tail_u, tail_p,
             consumed_meta) = self._flush_compute(touched)

        # ---- the ONE host sync of this flush
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = self.time_fn()

        flush_id = self.flushes_total
        predictions, recommendations = [], {}
        for sid, name, mods, row, step in emitted:
            kind = "final" if frozenset(mods) == self.full_set else "partial"
            pred = Prediction(sid=sid, step=step, model=name,
                              modalities=mods, kind=kind, outputs=row,
                              flush_id=flush_id, t_emit=t1)
            st = self.sessions[sid]
            self._record_prediction(st, pred)
            predictions.append(pred)
            recommendations[sid] = row
            if self.tracer:
                key = self._cache_key(sid, name)
                self.tracer.instant(
                    "fuse", "fusion", t1, track=f"session:{sid}",
                    sid=sid, key=key, model=name, step=step,
                    consumed=consumed_meta.get((sid, name), {}))
                self.tracer.instant(
                    "emit", "predict", t1, track=f"session:{sid}",
                    sid=sid, key=key, model=name, step=step, kind=kind,
                    modalities=sorted(mods))

        # keyed by arrival with the EARLIEST submit kept: a duplicate
        # submission of the same (sid, idx) counts once
        arrived: Dict[Tuple[str, int], float] = {}
        for sid, idx, ts in self._pending:
            arrived.setdefault((sid, idx), ts)
        latencies = {key: t1 - ts for key, ts in arrived.items()}
        report = FlushReport(
            flush_id=flush_id, n_events=len(arrived),
            n_encoder_calls=n_enc, n_tail_calls=n_tail, wall_s=t1 - t0,
            latencies=latencies, predictions=predictions,
            recommendations=recommendations,
            flops_useful=enc_u + tail_u, flops_padded=enc_p + tail_p)
        if self.tracer:
            for (sid, idx), ts in arrived.items():
                self.tracer.span("queue.wait", "queue", ts, t0,
                                 track=f"session:{sid}", sid=sid,
                                 index=idx)
            self.tracer.span("flush", "flush", t0, t1, track="engine",
                             flush_id=flush_id, n_events=len(arrived),
                             n_encoder_calls=n_enc, n_tail_calls=n_tail)
        self.metrics.inc("engine.flushes")
        self.metrics.inc("engine.flush_events", len(arrived))
        self.metrics.observe("flush.wall_s", t1 - t0)
        for lat in latencies.values():
            self.metrics.observe("serve.latency_s", lat)
        self._pending.clear()
        self.flushes.append(report)
        if self.max_history is not None:
            del self.flushes[:-self.max_history]
        self.flushes_total += 1
        self._enc_calls_total += n_enc
        self._tail_calls_total += n_tail
        self.evict_sessions(t1)
        return report

    def _record_prediction(self, st: SessionView, pred: Prediction):
        """Session-side bookkeeping shared by flush- and tiered-mode
        emissions."""
        st.predictions.append(pred)
        if self.max_history is not None:
            del st.predictions[:-self.max_history]
        st.last_recommendation = pred.outputs
        st.t_last_activity = pred.t_emit if self.tiered else self.time_fn()
        if pred.kind == "final":
            st.finalized = True
            if st.t_final_prediction is None:
                st.t_final_prediction = pred.t_emit
        if st.t_first_prediction is None:
            st.t_first_prediction = pred.t_emit
            if not self.tiered and st.t_first_submit is not None:
                self.metrics.observe("serve.ttfp_s",
                                     pred.t_emit - st.t_first_submit)

    # ---------------------------------------------------------- eviction

    def _evict(self, sid: str):
        keys = ([sid] if self.share_encoders
                else [f"{sid}:{n}" for n in self.models])
        for key in keys:
            self.cache.drop_session(key)
        if self.tiered:
            # forget every tier replica's versions too: a re-created
            # session restarts its version counters at 0, and a stale
            # high-water mark would wrongly skip re-shipping features
            dropped = set(keys)
            for versions in self._replica_versions.values():
                for k in [k for k in versions if k[0] in dropped]:
                    del versions[k]
        del self.sessions[sid]
        self.metrics.inc("engine.evicted_sessions")
        if self.tracer:
            self.tracer.instant("evict", "session", track="engine",
                                sid=sid, keys=keys)

    def evict_sessions(self, now: Optional[float] = None) -> int:
        """Cross-incident eviction sweep; returns how many sessions left.
        A session is evictable only when it has no pending arrivals and
        no un-flushed dirty modalities — eviction never drops work. Idle
        timeout first, then LRU down to ``max_sessions``:
        least-recently-active leaves first, so a finalized incident that
        is still streaming updates outlives an abandoned partial one
        (finalized only breaks activity ties). ``now`` is the engine's
        ``time_fn`` clock in flush mode, the simulated clock in tiered
        mode."""
        if self.idle_timeout_s is None and self.max_sessions is None:
            return 0
        now = self.time_fn() if now is None else now
        pending_sids = {sid for sid, _, _ in self._pending}
        evictable = [st for sid, st in self.sessions.items()
                     if sid not in pending_sids and not st.dirty]
        n0 = self.evicted_count
        if self.idle_timeout_s is not None:
            for st in list(evictable):
                last = (st.t_last_activity if st.t_last_activity is not None
                        else st.t_first_submit)
                if last is not None and now - last >= self.idle_timeout_s:
                    self._evict(st.sid)
                    evictable.remove(st)
        if self.max_sessions is not None \
                and len(self.sessions) > self.max_sessions:
            evictable.sort(key=lambda st: (st.t_last_activity or 0.0,
                                           not st.finalized))
            excess = len(self.sessions) - self.max_sessions
            for st in evictable[:excess]:
                self._evict(st.sid)
        return self.evicted_count - n0


    # ==================================================================
    # Tiered placement path (per-arrival on the simulated tier clocks)
    # ==================================================================

    # ----- the legacy 2-tier accessor surface (the fastest remote)

    @property
    def glass(self) -> TierHost:
        return self.hosts[self.local_name]

    @property
    def edge(self) -> TierHost:
        return self.hosts[self._primary]

    @property
    def uplink(self):
        return self.fabric.channel(self.local_name, self._primary)

    @property
    def downlink(self):
        return self.fabric.channel(self._primary, self.local_name)

    @property
    def crash_at(self) -> Optional[float]:
        return self._faults[self._primary].crash_at

    @property
    def detect_at(self) -> Optional[float]:
        return self._faults[self._primary].detect_at

    @property
    def edge_known_dead(self) -> bool:
        return self._faults[self._primary].dead

    # ----- fault injection / detection / rejoin

    def inject_crash(self, t: float, tier: Optional[str] = None, *,
                     rejoin_at: Optional[float] = None):
        """Tier ``tier`` (default: the fastest remote) dies at simulated
        time ``t``. The glasses learn of it at the first missed heartbeat
        strictly after ``t``. With ``rejoin_at``, a restarted box comes
        back then: it re-warms its feature-cache replica from the
        glass-side versioned cache and is placement-eligible again."""
        tier = self._primary if tier is None else tier
        f = self._faults[tier]
        f.crash_at = t
        period = self.monitors[tier].period
        f.detect_at = (math.floor(t / period) + 1) * period
        if self.tracer:
            self.tracer.instant("crash.inject", "fault", t,
                                track=f"host:{tier}", tier=tier,
                                detect_at=f.detect_at, rejoin_at=rejoin_at)
        if rejoin_at is not None:
            self.schedule_rejoin(rejoin_at, tier)

    def inject_edge_crash(self, t: float):
        self.inject_crash(t)

    def inject_schedule(self, schedule):
        """Install a multi-cycle crash/rejoin schedule (an iterable of
        :class:`serving.chaos.FaultEvent`, e.g. from ``chaos_schedule``).
        The first cycle of each tier arms at once; each later cycle arms
        when the previous one's rejoin completes, so repeated crash ->
        re-dispatch/fallback -> rejoin -> re-warm rounds replay on the
        simulated clock."""
        from .chaos import validate_schedule
        entries = validate_schedule(list(schedule))
        unknown = {e.tier for e in entries} - set(self.remote_names)
        if unknown:
            raise ValueError(f"schedule names unknown tier(s) "
                             f"{sorted(unknown)}; remotes are "
                             f"{self.remote_names}")
        for e in entries:
            self._schedule.setdefault(e.tier, deque()).append(e)
        for n in list(self._schedule):
            if self._faults[n].crash_at is None:
                self._install_next_fault(n)

    def _install_next_fault(self, tier: str):
        q = self._schedule.get(tier)
        if q:
            e = q.popleft()
            self.inject_crash(e.crash_at, tier, rejoin_at=e.rejoin_at)

    def schedule_rejoin(self, t: float, tier: Optional[str] = None):
        tier = self._primary if tier is None else tier
        f = self._faults[tier]
        if f.crash_at is not None and t <= f.crash_at:
            raise ValueError(f"rejoin at {t} precedes the crash at "
                             f"{f.crash_at}")
        f.rejoin_at = t

    def _mark_dead(self, tier: str):
        self._faults[tier].dead = True
        self._replica_versions[tier].clear()   # that replica is gone
        self.metrics.inc("fault.crashes_detected")
        if self.tracer:
            f = self._faults[tier]
            self.tracer.instant(
                "crash.detect", "fault",
                f.detect_at if f.detect_at is not None else self.tracer.now(),
                track=f"host:{tier}", tier=tier, crash_at=f.crash_at)

    def _rejoin(self, tier: str, t: float):
        """A restarted tier comes back: fresh fault state, a fresh busy
        clock, and a replica re-warm shipped from the glass-side
        versioned cache (one bulk message on its link at the rejoin
        instant), after which it is placement-eligible again."""
        self._faults[tier] = _TierFault()
        # a restarted box boots idle: anything still on its clock is
        # phantom occupancy from flights the crash already lost
        self.hosts[tier].free_at = t
        versions = self._replica_versions[tier]
        warm_b = 0
        for (key, m), e in self.cache.entries():
            if versions.get((key, m), -1) < e.version:
                warm_b += payload_nbytes(e.feature)
                versions[(key, m)] = e.version
        if warm_b:
            self.fabric.channel(self.local_name, tier).send(warm_b, t)
        self.metrics.inc("placement.rejoins")
        if self.tracer:
            self.tracer.instant("rejoin", "fault", t, track=f"host:{tier}",
                                tier=tier, warm_bytes=warm_b)

    def _usable_remotes(self, now: float) -> List[str]:
        """Remote tiers a decision made at ``now`` may target, applying
        any heartbeat detection or restart the clock has crossed. Under
        a chaos schedule a rejoin arms the tier's NEXT cycle and the loop
        checks again: several crash/rejoin rounds may have passed between
        two arrivals."""
        out = []
        for n in self.remote_names:
            while True:
                f = self._faults[n]
                if not f.dead and f.detect_at is not None \
                        and now >= f.detect_at:
                    self._mark_dead(n)
                if f.dead and f.rejoin_at is not None and now >= f.rejoin_at:
                    self._rejoin(n, f.rejoin_at)
                    self._install_next_fault(n)
                    continue
                break
            if not self._faults[n].dead:
                out.append(n)
        return out

    def _dies_before(self, tier: str, t: float) -> bool:
        """Does ``tier`` crash before simulated time ``t``? (A sender
        must survive through the END of its own transmission.)"""
        f = self._faults.get(tier)
        return f is not None and f.crash_at is not None and f.crash_at < t

    def _queues(self, now: float) -> Optional[Dict[str, float]]:
        """Per-host queueing delay feeding contention-aware decisions
        (None = the contention-blind paper rule)."""
        if not self.contention_aware:
            return None
        return {n: max(0.0, h.free_at - now) for n, h in self.hosts.items()}

    def _payload_bytes(self, m: str, payload) -> int:
        """Raw sensor bytes for the uplink: the module's declared size
        (audio clip / camera frame, not the tokenized tensor) when
        available, else the actual array bytes."""
        for _n, sm in self._consumers(m):
            b = sm.module.payload_bytes.get(m)
            if b:
                return b
        return payload_nbytes(payload)

    def _enc_duration(self, m: str, n_runners: int, host: TierHost,
                      precision: str = "fp32") -> float:
        """Simulated seconds the tier spends encoding modality ``m`` for
        ``n_runners`` consuming models: expensive text encoders run in
        parallel, cheap ones serially (paper Fig. 8-right). int8 flights
        scale by the SAME ``INT8_COMPUTE_SCALE`` the placement estimate
        used, so the decision and the booking agree."""
        per = host.time(f"enc:{m}")
        if precision == "int8":
            per *= INT8_COMPUTE_SCALE
        return per if m == "text" else per * n_runners

    def _feat_bytes_est(self, m: str) -> int:
        """A-priori float32 size of modality ``m``'s encoded feature (the
        declared feature width x 4 bytes): what the joint precision
        enumeration scales by ``INT8_BYTES_SCALE`` before the encoder has
        run. Real flights then ship the real packed bytes."""
        for _n, sm in self._consumers(m):
            d = sm.module.feature_dims.get(m)
            if d:
                return 4 * int(d)
        return 0

    # ----------------------------------------------------- real numerics
    #
    # Numerics are split into run / commit phases so the fault path can
    # execute the real calls (placement never changes the math) yet leave
    # the glass-side cache untouched when a tier dies before its result
    # makes it back.

    def _quantized_params(self, name: str) -> dict:
        """The int8 sidecar dict for model ``name``, derived lazily and
        cached per DISTINCT float32 dict (id()-keyed): a share_encoders
        zoo whose subsets all alias one dict quantizes once in total."""
        src = self.params[name]
        qp = self._qparams_cache.get(id(src))
        if qp is None:
            with torch.inference_mode():
                qp = self._qparams_cache[id(src)] = \
                    self.models[name].quantize_params(src)
        return qp

    def _run_encoders(self, st: SessionView, m: str,
                      precision: str = "fp32") -> Dict[str, object]:
        """Real encoder run(s) for the arriving modality; returns
        ``{model_name: feature}`` WITHOUT touching the cache. An int8
        flight runs the SAME encoder over the sidecar dict
        (``layers.dense`` dispatches on the leaf form) and returns the
        packed ``{"q", "scale"}`` wire form — what the cache commits and
        the downlink sizes."""
        consumers = self._consumers(m)
        if not consumers:
            return {}
        runners = consumers[:1] if self.share_encoders else consumers
        enc_in = self._bucketed(m, st.inputs[m])
        with torch.inference_mode():
            if precision == "int8":
                return {name: quantize_feature(sm.encoders[m](
                            self._quantized_params(name), enc_in))
                        for name, sm in runners}
            return {name: sm.encoders[m](self.params[name], enc_in)
                    for name, sm in runners}

    def _tail(self, model_name: str, gathered):
        with torch.inference_mode():
            return self.models[model_name].tail(self.params[model_name],
                                                gathered)

    def _commit_features(self, st: SessionView, m: str, feats, tier: str):
        for name, feat in feats.items():
            self.cache.put(self._cache_key(st.sid, name), m, feat,
                           step=st.step, tier=tier)

    def _gather(self, st: SessionView, model_name: str, m: str, feats):
        """The selected model's input features — the arriving modality
        from the fresh (possibly uncommitted) ``feats``, everything else
        from the glass cache with the <=1-step staleness invariant
        asserted on every read. Packed int8 features (fresh or cached)
        unpack here, at the consuming tier. None while the subset is
        incomplete."""
        sm = self.models[model_name]
        key = self._cache_key(st.sid, model_name)
        fresh = (next(iter(feats.values()), None) if self.share_encoders
                 else feats.get(model_name))
        out, consumed = {}, {}
        with torch.inference_mode():
            for mm in sm.modalities():
                if mm == m and fresh is not None:
                    out[mm] = dequantize_feature(fresh)
                    # the fresh feature carries this very step; its
                    # commit lands before the fuse is recorded
                    consumed[mm] = [st.step, st.input_step.get(mm, st.step)]
                    continue
                e = self.cache.get(key, mm, input_step=st.input_step.get(mm))
                if e is None:
                    return None
                out[mm] = dequantize_feature(e.feature)
                consumed[mm] = [e.step, st.input_step.get(mm, e.step)]
        if self.tracer:
            self._last_consumed = consumed
        return out

    def _touch_consumed(self, st: SessionView, model_name: str):
        """The result carries the cache back (paper fault tolerance):
        re-stamp every consumed entry at this step."""
        key = self._cache_key(st.sid, model_name)
        for mm in self.models[model_name].modalities():
            self.cache.touch(key, mm, st.step)

    # ------------------------------------------------------------- event

    def _submit_tiered(self, sid: str, event: Event, payload, *,
                       aggregate=None) -> TieredRecord:
        """Process one arriving datum end to end: decide a tier per
        submodule, encode there, transport, re-fuse, emit on glass. With
        the stream policy's ``glass_partials``, an offloaded arrival also
        yields an immediate on-glass provisional partial from cached
        features."""
        prev_observed = set(self.session(sid).inputs)
        st = self._intake(sid, event, payload, aggregate)
        st.dirty.clear()        # per-arrival mode: nothing buffers
        t_a = event.arrival_time
        if st.t_first_arrival is None:
            st.t_first_arrival = t_a
        now = max(t_a, st.ready_at)
        sess = f"session:{sid}"
        if self.tracer:
            self.tracer.set_time(now)
            self.tracer.instant("arrival", "arrival", t_a, track=sess,
                                sid=sid, index=event.index,
                                modality=event.modality, step=st.step)
            if now > t_a:
                # per-session in-order processing: this arrival waits for
                # the previous record's emit
                self.tracer.span("queue.wait", "queue", t_a, now,
                                 track=sess, sid=sid, index=event.index)
        model_name = select_model(self.models, st.inputs)
        payload_b = self._payload_bytes(event.modality,
                                        st.inputs[event.modality])
        avail = self._usable_remotes(now)
        queues = self._queues(now)
        dec = self.policy.decide(f"enc:{event.modality}", payload_b, now,
                                 queues=queues, available=avail,
                                 lateness_s=max(0.0, now - t_a),
                                 feat_bytes=self._feat_bytes_est(
                                     event.modality))
        if self.tracer:
            # the precision attr only appears when the joint rung is
            # armed, so precision-less traces stay byte-identical
            extra = ({"precision": dec.precision}
                     if self.policy.precisions is not None else {})
            self.tracer.instant("decide", "placement", now, track=sess,
                                sid=sid, submodule=f"enc:{event.modality}",
                                tier=dec.tier, speculate=dec.speculate,
                                best_remote=dec.best_remote, **extra)

        partial = None
        if dec.speculate and dec.best_remote is not None:
            # deadline margin too thin to trust the estimate: race glass
            # against the best remote, commit the first result, cancel
            # the loser. The glass racer IS the immediate answer, so no
            # separate provisional partial; the race also supersedes tail
            # splitting (both racers run encoder+tail co-located).
            rec = self._race_event(st, event, model_name, payload_b, now,
                                   dec, dec.best_remote)
        else:
            if dec.tier != self.local_name and self.glass_partials:
                partial = self._glass_provisional(st, prev_observed, now)
            if self.tail_placement:
                rec = self._placed_event(st, event, model_name, payload_b,
                                         now, dec, avail, queues,
                                         prev_observed)
            elif dec.tier != self.local_name:
                rec = self._remote_event(st, event, model_name, payload_b,
                                         now, dec, dec.tier)
            else:
                rec = self._glass_event(st, event, model_name, now, dec)
        if partial is not None:
            rec.glass_partial = partial

        st.ready_at = rec.t_emit
        st.t_last_activity = rec.t_emit        # simulated clock
        st.records.append(rec)
        self.records.append(rec)
        if self.max_history is not None:
            del st.records[:-self.max_history]
            del self.records[:-self.max_history]
        self._total_latency += rec.latency_s
        self.metrics.observe("serve.latency_s", rec.latency_s)
        if self.tracer:
            self.tracer.span(
                f"{rec.modality}#{rec.index}", "lifecycle", rec.t_arrival,
                rec.t_emit, track=sess, sid=sid, index=rec.index,
                modality=rec.modality, enc_tier=rec.enc_tier,
                tail_tier=rec.tail_tier, kind=rec.kind,
                fallback=rec.fallback, speculative=rec.speculative,
                detect_s=rec.detect_s)
        if rec.outputs is not None:
            if st.t_first_emit is None:
                st.t_first_emit = rec.t_emit
                if st.t_first_arrival is not None:
                    self.metrics.observe("serve.ttfp_s",
                                         rec.t_emit - st.t_first_arrival)
            if rec.kind == "final" and st.t_final_emit is None:
                st.t_final_emit = rec.t_emit
            if self.tracer:
                key = self._cache_key(sid, rec.model)
                self.tracer.instant(
                    "fuse", "fusion", rec.t_emit, track=sess, sid=sid,
                    key=key, model=rec.model, step=st.step,
                    consumed=self._last_consumed)
                self.tracer.instant(
                    "emit", "predict", rec.t_emit, track=sess, sid=sid,
                    key=key, model=rec.model, step=st.step, kind=rec.kind,
                    modalities=sorted(self.models[rec.model].modalities()))
            if self.stream_policy is not None:
                self._record_prediction(st, Prediction(
                    sid=st.sid, step=st.step, model=rec.model,
                    modalities=tuple(self.models[rec.model].modalities()),
                    kind=rec.kind, outputs=rec.outputs, flush_id=-1,
                    t_emit=rec.t_emit))
        # cross-incident eviction on the SIMULATED clock (every activity
        # timestamp in this mode is a t_emit, so the wall-clock poll()
        # must not sweep here)
        self.evict_sessions(rec.t_emit)
        return rec

    def _glass_provisional(self, st: SessionView, prev_observed: set,
                           now: float) -> Optional[Prediction]:
        """Stream x tiered composition: while a remote tier refreshes the
        arriving modality, the glasses immediately re-fuse what they
        already hold — every feature read from the cache with the
        <=1-step staleness invariant asserted (the arriving modality's
        cached feature is exactly one step behind its input now, the
        paper's tolerated bound). Tagged ``partial`` always: it never
        reflects the newest datum. No cache touch — provisional serving
        must not mask real staleness from later reads."""
        name = select_model(self.models, prev_observed)
        if name is None:
            return None
        sm = self.models[name]
        feats = self.cache.features(self._cache_key(st.sid, name),
                                    sm.modalities(),
                                    input_steps=st.input_step)
        if feats is None:
            return None
        with torch.inference_mode():
            feats = {mm: dequantize_feature(f) for mm, f in feats.items()}
            outputs = sm.tail(self.params[name], feats)
        _start, done = self.glass.occupy(self.glass.time("tail"), now,
                                         label="tail@glass:provisional")
        pred = Prediction(sid=st.sid, step=st.step, model=name,
                          modalities=tuple(sm.modalities()), kind="partial",
                          outputs=outputs, flush_id=-1, t_emit=done)
        self._record_prediction(st, pred)
        if self.tracer:
            key = self._cache_key(st.sid, name)
            sess = f"session:{st.sid}"
            consumed = {mm: [self.cache.peek(key, mm).step,
                             st.input_step.get(mm, 0)]
                        for mm in sm.modalities()}
            self.tracer.instant("fuse", "fusion", done, track=sess,
                                sid=st.sid, key=key, model=name,
                                step=st.step, consumed=consumed,
                                provisional=True)
            self.tracer.instant("emit", "predict", done, track=sess,
                                sid=st.sid, key=key, model=name,
                                step=st.step, kind="partial",
                                modalities=sorted(sm.modalities()),
                                provisional=True)
        if st.t_first_emit is None or done < st.t_first_emit:
            if st.t_first_emit is None and st.t_first_arrival is not None:
                self.metrics.observe("serve.ttfp_s",
                                     done - st.t_first_arrival)
            st.t_first_emit = done
        return pred

    def _kind(self, model_name: Optional[str]) -> str:
        if model_name is None:
            return "partial"
        mods = frozenset(self.models[model_name].modalities())
        return "final" if mods == self.full_set else "partial"

    def _sync_bytes(self, tier: str, st: SessionView,
                    model_name: Optional[str], *, skip: str):
        """Bytes needed to bring ``tier``'s replica up to date on every
        cached feature the selected model consumes (except ``skip``, the
        freshly arriving modality), plus the (replica key, version) pairs
        to stamp once the path succeeds."""
        sync_b, synced = 0, []
        if model_name is not None:
            versions = self._replica_versions[tier]
            key = self._cache_key(st.sid, model_name)
            for mm in self.models[model_name].modalities():
                if mm == skip:
                    continue
                e = self.cache.peek(key, mm)
                if e is not None and versions.get((key, mm), -1) < e.version:
                    sync_b += payload_nbytes(e.feature)
                    synced.append(((key, mm), e.version))
        return sync_b, synced

    def _stamp_fresh(self, tier: str, st: SessionView, m: str):
        """``tier``'s replica now holds the fresh feature(s) of ``m``."""
        versions = self._replica_versions[tier]
        for name in self.models:
            key = self._cache_key(st.sid, name)
            e = self.cache.peek(key, m)
            if e is not None:
                versions[(key, m)] = e.version

    def _crash_fallback(self, tier: str, st: SessionView, event: Event,
                        model_name: Optional[str], now: float,
                        dec: TierDecision, *, payload_b: Optional[int] = None,
                        feats=None, outputs=None) -> TieredRecord:
        """A remote participant died before its transmission completed:
        mark it dead at the first missed heartbeat, then re-dispatch the
        lost flight. With ``redispatch`` on and a surviving remote, the
        flight goes to the next-best surviving remote (a fresh placement
        decision at the detection instant, restricted to survivors);
        otherwise it re-runs on glass. Either way the already-computed
        numerics are reused: placement never changes the math, so the
        re-run's tensors are the in-flight ones (and keep the flight's
        precision). A re-dispatch target that also dies falls through
        again, until a survivor (at last the glass) emits."""
        t_detect = max(now, self._faults[tier].detect_at)
        self._mark_dead(tier)
        detect_s = max(0.0, t_detect - now)
        if self.redispatch and payload_b is not None:
            survivors = self._usable_remotes(t_detect)
            if survivors:
                dec2 = self.policy.decide(
                    f"enc:{event.modality}", payload_b, t_detect,
                    queues=self._queues(t_detect), available=survivors)
                B = dec2.best_remote
                if B is not None:
                    dec2 = replace(dec2, precision=dec.precision)
                    self.metrics.inc("placement.redispatches")
                    if self.tracer:
                        self.tracer.instant(
                            "redispatch", "fault", t_detect,
                            track=f"session:{st.sid}", sid=st.sid,
                            from_tier=tier, to_tier=B)
                    return self._remote_event(
                        st, event, model_name, payload_b, t_detect, dec2,
                        B, feats=feats, outputs=outputs, fallback=True,
                        detect_s=detect_s)
        return self._glass_event(st, event, model_name, t_detect, dec,
                                 fallback=True, detect_s=detect_s,
                                 feats=feats, outputs=outputs)

    def _race_event(self, st: SessionView, event: Event,
                    model_name: Optional[str], payload_b: int,
                    now: float, dec: TierDecision, A: str) -> TieredRecord:
        """Speculative dual placement (cancel-on-commit): dispatch the
        arriving submodule on glass AND remote ``A`` at once, commit
        whichever result reaches the glasses first, and cancel the loser
        at the commit instant — its in-flight transfer never delivers,
        its un-run compute is released, and nothing of it commits (the
        cache would refuse the late duplicate anyway). The numerics run
        ONCE: both racers share the same tensors, so the committed result
        is the same whichever side wins. A remote crash mid-race is
        absorbed with NO detection stall: the glass racer is already
        running, so the EMT pays the glass latency instead of the
        missed-heartbeat timeout (a crash save, not a fallback)."""
        m = event.modality
        local = self.local_name
        host = self.hosts[A]
        up_ch = self.fabric.channel(local, A)
        down_ch = self.fabric.channel(A, local)

        # ---- real numerics once, at the decision's precision (a
        # property of the flight, not of either host)
        feats = self._run_encoders(st, m, dec.precision)
        outputs = None
        if model_name is not None:
            gathered = self._gather(st, model_name, m, feats)
            if gathered is not None:
                outputs = self._tail(model_name, gathered)

        # ---- glass racer: always booked (the hedge that cannot crash)
        g_dur = (self._enc_duration(m, len(feats), self.glass, dec.precision)
                 if feats else 0.0)
        if outputs is not None:
            g_dur += self.glass.time("tail")
        g_start, g_done = self.glass.occupy(g_dur, now)

        # ---- remote racer: the uplink truly dispatches; compute and
        # downlink are PLANNED through eta() so a loss unwinds cleanly
        sync_b, synced = self._sync_bytes(A, st, model_name, skip=m)
        up = up_ch.send(payload_b + sync_b, now)
        r_dur = (self._enc_duration(m, len(feats), host, dec.precision)
                 if feats else 0.0)
        if outputs is not None:
            r_dur += host.time("tail")
        down_b = sum(payload_nbytes(f) for f in feats.values())
        if outputs is not None:
            down_b += payload_nbytes(outputs)
        r_done = max(up.t_deliver, host.free_at) + r_dur
        r_emit = down_ch.eta(down_b, r_done)
        crashed = self._dies_before(A, r_emit)

        # tie -> local: offloading must strictly win (the legacy rule)
        glass_wins = crashed or g_done <= r_emit
        self.metrics.inc("speculation.races")
        if self.tracer:
            self.tracer.instant("race.start", "speculation", now,
                                track=f"session:{st.sid}", sid=st.sid,
                                remote=A, glass_done=g_done,
                                remote_emit=r_emit, crashed=crashed)
        stamp_fresh_remote = False

        if glass_wins:
            stop = g_done                        # the commit instant
            if up.t_deliver > stop:
                # payload still in flight at commit: the wire frees now
                # and the remote never computes
                up_ch.cancel(up.flight, t=stop)
            else:
                rs, rd = host.occupy(r_dur, up.t_deliver)
                cut = (min(stop, self._faults[A].crash_at) if crashed
                       else stop)
                host.release(rs, rd, cut)        # un-run compute freed
                if not self._dies_before(A, up.t_deliver):
                    versions = self._replica_versions[A]
                    for k, version in synced:
                        versions[k] = version
                if rd <= stop and not self._dies_before(A, rd):
                    # the loser finished computing; its result transfer
                    # is recalled at commit (a sender dead on the wire is
                    # recalled at its crash instant instead)
                    stamp_fresh_remote = True
                    down = down_ch.send(down_b, rd)
                    down_ch.cancel(down.flight, t=cut)
            winner, t_start, t_emit = local, g_start, g_done
            uplink_s = downlink_s = 0.0
            compute_s, loser_emit = g_dur, r_emit
            self.metrics.inc("placement.on_glass")
            if crashed:
                self.metrics.inc("speculation.crash_saves")
        else:
            _rs, rd = host.occupy(r_dur, up.t_deliver)
            down = down_ch.send(down_b, rd)
            # cancel the glass racer: free the un-run tail of its booking
            self.glass.release(g_start, g_done, down.t_deliver)
            versions = self._replica_versions[A]
            for k, version in synced:
                versions[k] = version
            stamp_fresh_remote = True
            winner, t_start, t_emit = A, up.t_send, down.t_deliver
            uplink_s = up.t_deliver - up.t_send
            downlink_s = down.t_deliver - rd
            compute_s, loser_emit = r_dur, g_done
            self.metrics.inc("placement.offloaded")

        if self.tracer:
            self.tracer.instant("race.win", "speculation", t_emit,
                                track=f"session:{st.sid}", sid=st.sid,
                                winner=winner, loser_emit=loser_emit,
                                crashed=crashed)
        # ---- commit ONCE, for the winner only
        self._commit_features(st, m, feats, tier=winner)
        if outputs is not None:
            self._touch_consumed(st, model_name)
            self.metrics.inc(f"placement.tail.{winner}")
        if stamp_fresh_remote:
            # the loser computed (or received) the same fresh feature;
            # its replica holds the committed version
            self._stamp_fresh(A, st, m)
        self.metrics.inc(f"placement.enc.{winner}")
        self.metrics.inc(f"speculation.wins.{winner}")
        return TieredRecord(
            sid=st.sid, index=event.index, modality=m, model=model_name,
            tier=winner, kind=self._kind(model_name),
            t_arrival=event.arrival_time, t_start=t_start, t_emit=t_emit,
            uplink_s=uplink_s, downlink_s=downlink_s, compute_s=compute_s,
            decision=dec, outputs=outputs, enc_tier=winner,
            tail_tier=winner if outputs is not None else None,
            speculative=True, race_winner=winner,
            race_loser_emit=loser_emit, precision=dec.precision)

    def _glass_event(self, st: SessionView, event: Event,
                     model_name: Optional[str], now: float,
                     dec: TierDecision, *, fallback: bool = False,
                     detect_s: float = 0.0, feats=None,
                     outputs=None) -> TieredRecord:
        m = event.modality
        local = self.local_name
        if feats is None:
            feats = self._run_encoders(st, m, dec.precision)
        self._commit_features(st, m, feats, tier=local)
        if outputs is None and model_name is not None:
            gathered = self._gather(st, model_name, m, feats)
            if gathered is not None:
                outputs = self._tail(model_name, gathered)
        if outputs is not None:
            self._touch_consumed(st, model_name)
        dur = (self._enc_duration(m, len(feats), self.glass, dec.precision)
               if feats else 0.0)
        if outputs is not None:
            dur += self.glass.time("tail")
        start, done = self.glass.occupy(dur, now)
        self.metrics.inc("placement.on_glass")
        self.metrics.inc(f"placement.enc.{local}")
        if outputs is not None:
            self.metrics.inc(f"placement.tail.{local}")
        if fallback:
            self.metrics.inc("placement.fallbacks")
        return TieredRecord(
            sid=st.sid, index=event.index, modality=m, model=model_name,
            tier=local, kind=self._kind(model_name),
            t_arrival=event.arrival_time, t_start=start, t_emit=done,
            compute_s=dur, fallback=fallback, detect_s=detect_s,
            decision=dec, outputs=outputs, enc_tier=local,
            tail_tier=local if outputs is not None else None,
            precision=dec.precision)

    def _remote_event(self, st: SessionView, event: Event,
                      model_name: Optional[str], payload_b: int,
                      now: float, dec: TierDecision, A: str, *,
                      feats=None, outputs=None, fallback: bool = False,
                      detect_s: float = 0.0) -> TieredRecord:
        """Encoder AND tail on remote tier ``A`` (the co-located path —
        with ``tail_placement`` off this is the only remote shape).
        ``fallback``/``detect_s`` mark a mid-flight re-dispatch: the
        flight already died once on another tier and was re-aimed here
        at the detection instant."""
        m = event.modality
        host = self.hosts[A]
        up_ch = self.fabric.channel(self.local_name, A)
        down_ch = self.fabric.channel(A, self.local_name)
        # ---- uplink: raw payload + any features this replica lacks
        sync_b, synced = self._sync_bytes(A, st, model_name, skip=m)
        up = up_ch.send(payload_b + sync_b, now)

        # ---- real numerics (uncommitted) + simulated remote compute
        if feats is None:
            feats = self._run_encoders(st, m, dec.precision)
            if model_name is not None:
                gathered = self._gather(st, model_name, m, feats)
                if gathered is not None:
                    outputs = self._tail(model_name, gathered)
        dur = (self._enc_duration(m, len(feats), host, dec.precision)
               if feats else 0.0)
        if outputs is not None:
            dur += host.time("tail")
        _start, t_done = host.occupy(dur, up.t_deliver)

        # ---- downlink payload: fresh feature(s) + head outputs
        down_b = sum(payload_nbytes(f) for f in feats.values())
        if outputs is not None:
            down_b += payload_nbytes(outputs)

        # ---- crash window: the tier must survive through the END of its
        # downlink transmission, not just its compute
        if self._dies_before(A, down_ch.eta(down_b, t_done)):
            return self._crash_fallback(A, st, event, model_name, now, dec,
                                        payload_b=payload_b, feats=feats,
                                        outputs=outputs)

        # ---- success: commit to the glass cache, ship the bytes
        self._commit_features(st, m, feats, tier=A)
        if outputs is not None:
            self._touch_consumed(st, model_name)
        down = down_ch.send(down_b, t_done)
        # the replica now holds everything it consumed or produced
        versions = self._replica_versions[A]
        for k, version in synced:
            versions[k] = version
        self._stamp_fresh(A, st, m)
        self.metrics.inc("placement.offloaded")
        self.metrics.inc(f"placement.enc.{A}")
        if outputs is not None:
            self.metrics.inc(f"placement.tail.{A}")
        if fallback:
            self.metrics.inc("placement.fallbacks")
        return TieredRecord(
            sid=st.sid, index=event.index, modality=m, model=model_name,
            tier=A, kind=self._kind(model_name),
            t_arrival=event.arrival_time, t_start=up.t_send,
            t_emit=down.t_deliver, uplink_s=up.t_deliver - up.t_send,
            downlink_s=down.t_deliver - t_done, compute_s=dur,
            fallback=fallback, detect_s=detect_s,
            decision=dec, outputs=outputs, enc_tier=A,
            tail_tier=A if outputs is not None else None,
            precision=dec.precision)

    # ------------------------------------------- per-submodule placement

    def _placed_event(self, st: SessionView, event: Event,
                      model_name: Optional[str], payload_b: int,
                      now: float, dec: TierDecision, avail, queues,
                      prev_observed: set) -> TieredRecord:
        """Per-submodule placement: the encoder goes to ``dec.tier``;
        when a fusion will run, the tail gets its OWN argmin placement
        (possibly a third host), paying the feature hop between the two
        and the head-output return to the glasses."""
        m = event.modality
        A = dec.tier
        # will a fusion actually run? (fresh feature for m, every other
        # consumed modality already cached)
        fusible = False
        if model_name is not None:
            have_fresh = bool(self._consumers(m))
            key = self._cache_key(st.sid, model_name)
            fusible = all((mm == m and have_fresh)
                          or self.cache.peek(key, mm) is not None
                          for mm in self.models[model_name].modalities())
        if not fusible:
            if A == self.local_name:
                return self._glass_event(st, event, model_name, now, dec)
            return self._remote_event(st, event, model_name, payload_b,
                                      now, dec, A)
        # real numerics first: the tail decision weighs the ACTUAL
        # feature/output byte sizes — for an int8 flight the PACKED form
        feats = self._run_encoders(st, m, dec.precision)
        gathered = self._gather(st, model_name, m, feats)
        if gathered is None:
            if A == self.local_name:
                return self._glass_event(st, event, model_name, now, dec,
                                         feats=feats)
            return self._remote_event(st, event, model_name, payload_b,
                                      now, dec, A, feats=feats)
        outputs = self._tail(model_name, gathered)
        feat_b = sum(payload_nbytes(f) for f in feats.values())
        out_b = payload_nbytes(outputs)
        dtail = self.policy.decide_tail(feat_b, out_b, A, now,
                                        queues=queues, available=avail)
        T = dtail.tier
        partial = None
        if A == self.local_name and T != A and self.glass_partials:
            # the split shape pays a remote round trip even though the
            # encoder stayed home: the EMT still gets an immediate
            # provisional from cached features while the tail travels
            partial = self._glass_provisional(st, prev_observed, now)
        if T == A:
            if A == self.local_name:
                rec = self._glass_event(st, event, model_name, now, dec,
                                        feats=feats, outputs=outputs)
            else:
                rec = self._remote_event(st, event, model_name, payload_b,
                                         now, dec, A, feats=feats,
                                         outputs=outputs)
        else:
            rec = self._split_event(st, event, model_name, payload_b, now,
                                    dec, A, T, feats, outputs, feat_b, out_b)
        rec.tail_decision = dtail
        if partial is not None:
            rec.glass_partial = partial
        return rec

    def _split_event(self, st: SessionView, event: Event, model_name: str,
                     payload_b: int, now: float, dec: TierDecision,
                     A: str, T: str, feats, outputs, feat_b: int,
                     out_b: int) -> TieredRecord:
        """Encoder on ``A``, tail on a different tier ``T``. The fresh
        features always flow home to the glasses with the result (the
        paper's cache-carrying discipline), whichever tier computed them;
        commit stays on-success so a mid-flight death loses the in-flight
        work, never corrupts the cache."""
        m = event.modality
        local = self.local_name

        if A == local:
            # encoder at home; only the tail travels
            enc_dur = (self._enc_duration(m, len(feats), self.glass,
                                          dec.precision) if feats else 0.0)
            start, t_enc_done = self.glass.occupy(enc_dur, now)
            # glass-computed features are already safe at home
            self._commit_features(st, m, feats, tier=local)
            sync_b, synced = self._sync_bytes(T, st, model_name, skip=m)
            up = self.fabric.channel(local, T).send(feat_b + sync_b,
                                                    t_enc_done)
            tail_host = self.hosts[T]
            _s, t_tail_done = tail_host.occupy(tail_host.time("tail"),
                                               up.t_deliver)
            down_ch = self.fabric.channel(T, local)
            if self._dies_before(T, down_ch.eta(out_b, t_tail_done)):
                # tail-only fallback: features survived on glass
                t_detect = max(t_enc_done, self._faults[T].detect_at)
                self._mark_dead(T)
                _s2, done = self.glass.occupy(self.glass.time("tail"),
                                              t_detect)
                self._touch_consumed(st, model_name)
                self.metrics.inc("placement.on_glass")
                self.metrics.inc("placement.fallbacks")
                self.metrics.inc(f"placement.enc.{local}")
                self.metrics.inc(f"placement.tail.{local}")
                return TieredRecord(
                    sid=st.sid, index=event.index, modality=m,
                    model=model_name, tier=local,
                    kind=self._kind(model_name),
                    t_arrival=event.arrival_time, t_start=start,
                    t_emit=done, uplink_s=up.t_deliver - up.t_send,
                    compute_s=enc_dur + self.glass.time("tail"),
                    fallback=True,
                    detect_s=max(0.0, t_detect - t_enc_done),
                    decision=dec, outputs=outputs, enc_tier=local,
                    tail_tier=local, precision=dec.precision)
            down = down_ch.send(out_b, t_tail_done)
            self._touch_consumed(st, model_name)
            versions = self._replica_versions[T]
            for k, version in synced:
                versions[k] = version
            self._stamp_fresh(T, st, m)
            self.metrics.inc("placement.on_glass")
            self.metrics.inc(f"placement.enc.{local}")
            self.metrics.inc(f"placement.tail.{T}")
            return TieredRecord(
                sid=st.sid, index=event.index, modality=m,
                model=model_name, tier=local, kind=self._kind(model_name),
                t_arrival=event.arrival_time, t_start=start,
                t_emit=down.t_deliver, uplink_s=up.t_deliver - up.t_send,
                downlink_s=down.t_deliver - t_tail_done,
                compute_s=enc_dur + tail_host.time("tail"),
                decision=dec, outputs=outputs, enc_tier=local,
                tail_tier=T, precision=dec.precision)

        host = self.hosts[A]
        up = self.fabric.channel(local, A).send(payload_b, now)
        enc_dur = (self._enc_duration(m, len(feats), host, dec.precision)
                   if feats else 0.0)
        _s, t_enc_done = host.occupy(enc_dur, up.t_deliver)

        if T == local:
            # features come home, fusion runs on the glasses
            down_ch = self.fabric.channel(A, local)
            if self._dies_before(A, down_ch.eta(feat_b, t_enc_done)):
                return self._crash_fallback(A, st, event, model_name, now,
                                            dec, payload_b=payload_b,
                                            feats=feats, outputs=outputs)
            down = down_ch.send(feat_b, t_enc_done)
            self._commit_features(st, m, feats, tier=A)
            self._stamp_fresh(A, st, m)
            _s2, done = self.glass.occupy(self.glass.time("tail"),
                                          down.t_deliver)
            self._touch_consumed(st, model_name)
            self.metrics.inc("placement.offloaded")
            self.metrics.inc(f"placement.enc.{A}")
            self.metrics.inc(f"placement.tail.{local}")
            return TieredRecord(
                sid=st.sid, index=event.index, modality=m,
                model=model_name, tier=A, kind=self._kind(model_name),
                t_arrival=event.arrival_time, t_start=up.t_send,
                t_emit=done, uplink_s=up.t_deliver - up.t_send,
                downlink_s=down.t_deliver - t_enc_done,
                compute_s=enc_dur + self.glass.time("tail"),
                decision=dec, outputs=outputs, enc_tier=A,
                tail_tier=local, precision=dec.precision)

        # encoder on A, tail on another remote B: the feature hops A->B on
        # the direct link while the glasses warm B's replica in parallel;
        # B returns features + outputs home
        B = T
        sync_b, synced = self._sync_bytes(B, st, model_name, skip=m)
        sync_d = (self.fabric.channel(local, B).send(sync_b, now)
                  if sync_b else None)
        hop_ch = self.fabric.channel(A, B)
        if self._dies_before(A, hop_ch.eta(feat_b, t_enc_done)):
            return self._crash_fallback(A, st, event, model_name, now, dec,
                                        payload_b=payload_b, feats=feats,
                                        outputs=outputs)
        hop = hop_ch.send(feat_b, t_enc_done)
        ready = max(hop.t_deliver,
                    sync_d.t_deliver if sync_d is not None else 0.0)
        tail_host = self.hosts[B]
        _s2, t_tail_done = tail_host.occupy(tail_host.time("tail"), ready)
        down_ch = self.fabric.channel(B, local)
        down_b = feat_b + out_b         # the result carries the cache home
        if self._dies_before(B, down_ch.eta(down_b, t_tail_done)):
            return self._crash_fallback(B, st, event, model_name, now, dec,
                                        payload_b=payload_b, feats=feats,
                                        outputs=outputs)
        down = down_ch.send(down_b, t_tail_done)
        self._commit_features(st, m, feats, tier=A)
        self._touch_consumed(st, model_name)
        versions = self._replica_versions[B]
        for k, version in synced:
            versions[k] = version
        self._stamp_fresh(A, st, m)
        self._stamp_fresh(B, st, m)
        self.metrics.inc("placement.offloaded")
        self.metrics.inc(f"placement.enc.{A}")
        self.metrics.inc(f"placement.tail.{B}")
        return TieredRecord(
            sid=st.sid, index=event.index, modality=m, model=model_name,
            tier=A, kind=self._kind(model_name),
            t_arrival=event.arrival_time, t_start=up.t_send,
            t_emit=down.t_deliver, uplink_s=up.t_deliver - up.t_send,
            downlink_s=down.t_deliver - t_tail_done,
            compute_s=enc_dur + tail_host.time("tail"),
            decision=dec, outputs=outputs, enc_tier=A, tail_tier=B,
            precision=dec.precision)

    # --------------------------------------------------------- episodes

    def run_arrivals(self, episodes: Dict[str, List[Event]], payload_fn,
                     *, aggregate=None, sim_window: Optional[float] = None,
                     crash_at: Optional[float] = None,
                     rejoin_at: Optional[float] = None, schedule=None):
        """Drive sessions through their episodes in GLOBAL arrival-time
        order (``core.episodes.merge_arrivals``). ``payload_fn(sid, event)
        -> payload``.

        Tiered placement: per arrival, optionally killing the fastest
        remote at simulated time ``crash_at`` (restarted at
        ``rejoin_at``) and replaying a chaos ``schedule``; returns the
        records. Flush mode: with
        ``sim_window=None`` the engine's wall-clock deadline policy
        applies; with ``sim_window`` set, the deadline rule runs on
        EPISODE time instead: after each submit, flush iff the oldest
        pending arrival's episode time is >= ``sim_window`` seconds
        behind the current one (``sim_window=0`` flushes per arrival). A
        final ``drain`` runs either way; returns the flush reports."""
        arrivals = merge_arrivals(episodes)
        if self.tiered:
            if crash_at is not None:
                self.inject_crash(crash_at, rejoin_at=rejoin_at)
            elif rejoin_at is not None:
                raise ValueError("rejoin_at requires crash_at")
            if schedule is not None:
                self.inject_schedule(schedule)
            for _t, sid, ev in arrivals:
                self.submit(sid, ev, payload_fn(sid, ev),
                            aggregate=aggregate)
            return self.records
        if crash_at is not None or rejoin_at is not None \
                or schedule is not None:
            raise ValueError("crash_at/rejoin_at/schedule require tiered "
                             "placement")
        if sim_window is None:
            for _t, sid, ev in arrivals:
                self.submit(sid, ev, payload_fn(sid, ev),
                            aggregate=aggregate)
        else:
            saved, self.deadline_s = self.deadline_s, None
            try:
                oldest = None
                for t, sid, ev in arrivals:
                    self.submit(sid, ev, payload_fn(sid, ev),
                                aggregate=aggregate)
                    oldest = t if oldest is None else oldest
                    if t - oldest >= sim_window:
                        self.flush()
                        oldest = None
            finally:
                self.deadline_s = saved
        self.drain()
        return self.flushes

    def run_episodes(self, episodes: Dict[str, List[Event]], payload_fn,
                     *, aggregate=None, events_per_flush: int = 1):
        """Tick-driven batch serving: at tick t every session submits its
        t-th event; flush every ``events_per_flush`` ticks.
        ``payload_fn(sid, event) -> payload``."""
        if self.tiered:
            raise RuntimeError("run_episodes is a flush-mode driver; "
                               "tiered placement uses run_arrivals")
        horizon = max((len(ev) for ev in episodes.values()), default=0)
        for t in range(horizon):
            for sid, evs in episodes.items():
                if t < len(evs):
                    self.submit(sid, evs[t], payload_fn(sid, evs[t]),
                                aggregate=aggregate)
            if (t + 1) % events_per_flush == 0:
                self.flush()
        if self._pending:
            self.flush()
        return self.flushes

    # ------------------------------------------------------------- stats

    def compile_count(self) -> int:
        return sum(sm.compile_count() for sm in self.models.values())

    def encoder_calls_total(self) -> int:
        return self._enc_calls_total

    def tail_calls_total(self) -> int:
        return self._tail_calls_total

    def event_latencies(self) -> List[float]:
        return [lat for f in self.flushes for lat in f.latencies.values()]

    def total_wall_s(self) -> float:
        return sum(f.wall_s for f in self.flushes)

    def time_to_first_prediction(self, sid: str) -> Optional[float]:
        """Flush mode: wall seconds from first submit to first emitted
        prediction. Tiered: simulated seconds from first arrival to the
        first emission (a glass provisional counts — it IS the first
        thing the EMT sees)."""
        st = self.sessions[sid]
        if self.tiered:
            if st.t_first_emit is None or st.t_first_arrival is None:
                return None
            return st.t_first_emit - st.t_first_arrival
        if st.t_first_prediction is None or st.t_first_submit is None:
            return None
        return st.t_first_prediction - st.t_first_submit

    def time_to_final_prediction(self, sid: str) -> Optional[float]:
        st = self.sessions[sid]
        if self.tiered:
            if st.t_final_emit is None or st.t_first_arrival is None:
                return None
            return st.t_final_emit - st.t_first_arrival
        if st.t_final_prediction is None or st.t_first_submit is None:
            return None
        return st.t_final_prediction - st.t_first_submit

    # ----- tiered stats (meaningful only with placement enabled)

    def total_latency_s(self) -> float:
        """Cumulative serving latency (sum of per-arrival t_emit -
        t_arrival) — the Fig. 15 comparison metric."""
        return self._total_latency

    def makespan_s(self) -> float:
        return max((r.t_emit for r in self.records), default=0.0)

    def transport_stats(self) -> dict:
        """Per-link byte accounting: ``uplink``/``downlink`` for the
        glass<->fastest-remote pair, ``links`` for every (src, dst)
        channel the fabric used."""
        return {"uplink": self.uplink.stats(),
                "downlink": self.downlink.stats(),
                "links": self.fabric.stats()}

    def placement_counts(self) -> dict:
        """Events placed per host (by ENCODER tier), plus crash
        fallbacks."""
        return {**self.place_counts, "fallbacks": self.fallback_count}

    def tail_placement_counts(self) -> dict:
        """Fusions run per host."""
        return dict(self.tail_counts)

    def speculation_stats(self) -> dict:
        """Speculative-dual-placement and re-dispatch accounting: how many
        arrivals raced, which host won each race, how many remote crashes
        a race absorbed without a detection stall, how many lost flights
        re-aimed at a surviving remote, and the commit protocol's audit
        trail (cancelled transfers, refused duplicate/stale cache
        commits — both must stay refusals, never visible state)."""
        return {"races": self.spec_count,
                "wins": dict(self.spec_wins),
                "crash_saves": self.spec_crash_saves,
                "redispatches": self.redispatch_count,
                "cancelled_msgs": self.fabric.cancelled_msgs(),
                "duplicate_commits": self.cache.duplicate_commits,
                "stale_commits": self.cache.stale_commits}


# ======================================================================
# Spec parsing + factory
# ======================================================================

_SPEC_TOKENS = {
    "batch": "batch", "batched": "batch",
    "stream": "stream", "streaming": "stream",
    "tiered": "tiered", "tier": "tiered", "placement": "tiered",
}
_ENGINE_KEYS = ("share_encoders", "max_history")
# canonical sections -> (policy class, EngineSpec field)
_SECTIONS = {
    "batch": (BatchPolicy, "batch"),
    "stream": (StreamPolicy, "stream"),
    "tiered": (PlacementPolicy, "placement"),
}


def spec_tokens(spec: str) -> Tuple[str, ...]:
    """The canonical policy tokens of a '+'-joined spec string, in order
    and without repeats; an unknown token raises ``ValueError``."""
    toks: List[str] = []
    for tok in filter(None, (t.strip() for t in spec.split("+"))):
        canon = _SPEC_TOKENS.get(tok.lower())
        if canon is None:
            raise ValueError(f"unknown engine spec token {tok!r}; expected "
                             f"'+'-joined subset of batch/stream/tiered")
        if canon not in toks:
            toks.append(canon)
    return tuple(toks)


def parse_spec(spec, **overrides) -> EngineSpec:
    """Normalise an engine spec into a typed :class:`EngineSpec`.

    ``spec`` is a string of '+'-joined policy tokens (``"batch"``,
    ``"batch+stream"``, ``"stream+tiered"``, ...; aliases
    batched/streaming/tier/placement), a dict with sections ``batch`` /
    ``stream`` / ``tiered`` (each True or a kwargs dict) plus the
    engine-wide keys ``share_encoders``/``max_history``, or an
    :class:`EngineSpec` (returned as-is). ``overrides`` are routed by
    name: policy fields go to their policy (``deadline_s`` ->
    StreamPolicy, ``profile``/``trace`` -> PlacementPolicy, ``bucketer``
    -> BatchPolicy, which every flush-mode engine has, so its knobs need
    no ``batch`` token), engine keys to the engine; an override beats the
    same key in a dict section. Tiered specs REQUIRE ``profile`` and
    ``trace``."""
    if isinstance(spec, EngineSpec):
        if overrides:
            raise ValueError("overrides are not applied to a pre-built "
                             "EngineSpec; pass tokens or a dict instead")
        return spec
    sections: Dict[str, dict] = {}
    engine_kw: Dict[str, Any] = {}
    if isinstance(spec, str):
        sections = {canon: {} for canon in spec_tokens(spec)}
    elif isinstance(spec, dict):
        for key, val in spec.items():
            if key in _ENGINE_KEYS:
                engine_kw[key] = val
                continue
            canon = _SPEC_TOKENS.get(str(key).lower())
            if canon is None:
                raise ValueError(f"unknown engine spec section {key!r}")
            if val is False or val is None:
                continue
            sections[canon] = {} if val is True else dict(val)
    else:
        raise TypeError(f"engine spec must be str, dict, or EngineSpec; "
                        f"got {type(spec).__name__}")
    if not sections:
        raise ValueError("empty engine spec: enable at least one of "
                         "batch/stream/tiered")

    fields_of = {sec: set(cls.__dataclass_fields__)
                 for sec, (cls, _) in _SECTIONS.items()}
    for k, v in overrides.items():
        if k in _ENGINE_KEYS:
            engine_kw[k] = v
            continue
        owner = next((sec for sec in sections if k in fields_of[sec]), None)
        if owner is None and k in fields_of["batch"]:
            owner = "batch"
            sections.setdefault("batch", {})
        if owner is None:
            raise ValueError(f"override {k!r} does not match any enabled "
                             f"policy ({'+'.join(sections)})")
        sections[owner][k] = v        # overrides WIN over dict-spec values
    policies: Dict[str, Any] = {}
    for sec, kw in sections.items():
        cls, target = _SECTIONS[sec]
        unknown = set(kw) - fields_of[sec]
        if unknown:
            raise ValueError(f"unknown {sec} policy option(s): "
                             f"{sorted(unknown)}")
        if cls is PlacementPolicy and not {"profile", "trace"} <= set(kw):
            raise ValueError("tiered placement requires 'profile' "
                             "(ProfileTable) and 'trace' (BandwidthTrace)")
        policies[target] = cls(**kw)
    return EngineSpec(**policies, **engine_kw)


def build_engine(models: Dict[str, SplitModel], params: Dict[str, dict],
                 spec, *, time_fn: Callable[[], float] = time.perf_counter,
                 tracer: Optional[Tracer] = None, device="cuda",
                 **overrides) -> EMSServeEngine:
    """THE factory: assemble an :class:`EMSServeEngine` from a spec (see
    :func:`parse_spec`). ``time_fn`` is the flush-mode wall clock,
    ``tracer`` turns on full-lifecycle span tracing, and ``device`` is
    where the params live and the tensors are computed."""
    es = parse_spec(spec, **overrides)
    return EMSServeEngine(models, params, batch=es.batch, stream=es.stream,
                          placement=es.placement,
                          share_encoders=es.share_encoders,
                          max_history=es.max_history, time_fn=time_fn,
                          tracer=tracer, device=device)
