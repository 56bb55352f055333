"""EMSServe engine: event-driven multimodal serving with feature caching
and adaptive offloading (paper §4.2).

The engine consumes an *episode* — a stream of asynchronously arriving
modality payloads (speech/text, vitals, scene images) — and maintains,
per session:
  * the latest aggregated input per modality;
  * the feature cache: per-(model, modality) encoder outputs.

Two serving disciplines, matching the paper's comparison:
  * ``cached=True`` (EMSServe): on each event, encode ONLY the arriving
    modality (per model that consumes it — in parallel for expensive
    text modules, serially for cheap vitals, per Fig. 8-right), reuse
    cached features for everything else, run the fused tail.
  * ``cached=False`` (direct PyTorch-style): on each event, re-run the
    full selected multimodal model over all data observed so far.

Placement of every encoder run goes through the AdaptiveOffloadPolicy
(Δt + t^e < t^g). A simulated clock accumulates transfer + tier-scaled
compute; ``real_time=True`` instead measures the wall clock of the
actual calls, with the card synchronised before each reading.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from .. import device as _device
from .bucketing import Bucketer
from .episodes import Event
from .feature_cache import FeatureCache
from .offload import AdaptiveOffloadPolicy
from .splitter import SplitModel, select_model


@dataclass
class EventRecord:
    index: int
    modality: str
    model: Optional[str]
    tier: str
    delta_t: float
    compute_s: float
    total_s: float
    cumulative_s: float
    recommendation: Optional[dict] = None
    cache_hits: int = 0


class EMSServe:
    def __init__(self, models: Dict[str, SplitModel], params: Dict[str, dict],
                 *, policy: Optional[AdaptiveOffloadPolicy] = None,
                 cached: bool = True, real_time: bool = False,
                 session: str = "s0", bucketer: Optional[Bucketer] = None,
                 device="cuda"):
        # models keyed by name, e.g. {"m1": text-only, "m2": text+vitals, ...};
        # params must already live on ``device``
        self.device = _device.resolve(device)
        self.models = models
        self.params = params
        self.policy = policy
        self.cached = cached
        self.real_time = real_time
        self.session = session
        # bucketer: pad variable-length inputs to power-of-two shapes
        self.bucketer = bucketer
        self.cache = FeatureCache(max_staleness=1)
        self.inputs: Dict[str, object] = {}
        self.input_step: Dict[str, int] = {}
        self.step = 0
        self.clock = 0.0
        self.records: List[EventRecord] = []
        self._cum_total = 0.0            # running sum of record.total_s
        self.edge_alive = True

    # ------------------------------------------------------------ utils

    def crash_edge(self):
        """Manpack battery died: all subsequent work runs on-glass. Cached
        features survive (the edge returned them with every result)."""
        self.edge_alive = False
        if self.policy is not None:
            self.policy.force = "glass"

    def _select_model(self, observed):
        return select_model(self.models, observed)

    def _enc_input(self, modality: str):
        """Aggregated input for an encoder call, bucketed when enabled."""
        x = self.inputs[modality]
        return self.bucketer.fit(modality, x) if self.bucketer else x

    def compile_count(self) -> int:
        return sum(sm.compile_count() for sm in self.models.values())

    def _decide(self, submodule: str, payload_bytes: int):
        if self.policy is None:
            return "glass", 0.0
        d = self.policy.decide(submodule, payload_bytes, self.clock)
        tier = d.tier if (self.edge_alive or d.tier == "glass") else "glass"
        return tier, (d.delta_t if tier == "edge" else 0.0)

    def _run(self, fn, *args, submodule: str, tier: str):
        """Execute a submodule; return (result, seconds-for-clock)."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if self.real_time or self.policy is None:
            return out, wall
        tname = self.policy.glass_tier if tier == "glass" else self.policy.edge_tier
        return out, self.policy.profile.time(submodule, tname)

    # ------------------------------------------------------------ event

    def on_event(self, event: Event, payload, *, aggregate=None):
        """Process one arriving datum (a tensor or numpy array, moved to
        the engine's device). ``aggregate(old, new) -> input`` merges it
        into the modality's aggregated input (default: replace)."""
        self.step += 1
        m = event.modality
        payload = torch.as_tensor(payload, device=self.device)
        old = self.inputs.get(m)
        self.inputs[m] = aggregate(old, payload) if aggregate else payload
        self.input_step[m] = self.step
        observed = set(self.inputs)
        model_name = self._select_model(observed)

        compute_s = 0.0
        dt_total = 0.0
        tier_used = "glass"
        rec_out = None
        hits0 = self.cache.hits

        if self.cached:
            # --- EMSServe path: encode only modality m, per consuming model.
            consumers = [(n, sm) for n, sm in self.models.items()
                         if m in sm.modalities()]
            enc_times = []
            payload_b = (consumers[0][1].module.payload_bytes.get(m, 1 << 16)
                         if consumers else 1 << 16)
            tier_used, dt = self._decide(f"enc:{m}", payload_b)
            dt_total += dt
            enc_in = self._enc_input(m)
            for name, sm in consumers:
                feat, secs = self._run(sm.encoders[m], self.params[name],
                                       enc_in,
                                       submodule=f"enc:{m}", tier=tier_used)
                self.cache.put(f"{self.session}:{name}", m, feat,
                               step=self.step, tier=tier_used)
                enc_times.append(secs)
            if enc_times:
                # parallel cache computation for expensive modules (text),
                # serial for cheap ones (paper Fig. 8-right)
                compute_s += max(enc_times) if m == "text" else sum(enc_times)
            if model_name is not None:
                sm = self.models[model_name]
                feats = self.cache.features(f"{self.session}:{model_name}",
                                            sm.modalities(),
                                            input_steps=self.input_step)
                if feats is not None:
                    rec_out, secs = self._run(sm.tail, self.params[model_name],
                                              feats, submodule="tail",
                                              tier=tier_used)
                    compute_s += secs
                    for mm in sm.modalities():   # edge returns cache w/ result
                        self.cache.touch(f"{self.session}:{model_name}", mm,
                                         self.step)
        else:
            # --- direct path: re-run the full model over everything.
            if model_name is not None:
                sm = self.models[model_name]
                payload_b = sum(sm.module.payload_bytes.get(mm, 1 << 16)
                                for mm in sm.modalities())
                tier_used, dt = self._decide("full", payload_b)
                dt_total += dt
                batch = {mm: self._enc_input(mm) for mm in sm.modalities()}
                rec_out, secs = self._run(sm.full, self.params[model_name],
                                          batch, submodule="full",
                                          tier=tier_used)
                compute_s += secs
            else:
                # conventional framework still pays the arriving modality's
                # encode to display *something* (perception cost)
                for name, sm in self.models.items():
                    if m in sm.modalities():
                        _, secs = self._run(sm.encoders[m], self.params[name],
                                            self._enc_input(m),
                                            submodule=f"enc:{m}", tier="glass")
                        compute_s += secs
                        break

        total = dt_total + compute_s
        self.clock = max(self.clock, event.arrival_time) + total
        self._cum_total += total
        rec = EventRecord(
            index=event.index, modality=m, model=model_name, tier=tier_used,
            delta_t=dt_total, compute_s=compute_s, total_s=total,
            cumulative_s=self._cum_total,
            recommendation=dict(rec_out) if rec_out is not None else None,
            cache_hits=self.cache.hits - hits0)
        self.records.append(rec)
        return rec

    def run_episode(self, events, payload_fn, *, aggregate=None):
        for ev in events:
            self.on_event(ev, payload_fn(ev), aggregate=aggregate)
        return self.records

    def cumulative_time(self):
        return self.records[-1].cumulative_s if self.records else 0.0
