"""Versioned per-(session, modality) feature cache (EMSServe's key idea).

Invariants (paper §4.2.3, fault tolerance):
  * an entry is stamped with the engine step that produced it; the
    engine asserts entries it consumes are never staler than one step
    ("the cache on the smart glasses is never outdated by more than one
    step" — the edge returns the cache with every result);
  * entries carry the tier that computed them, so the fault-tolerance
    path can tell which features survive an edge crash;
  * commits are idempotent and monotone in the step clock: a second
    commit of the same (session, modality, step) is a structural no-op
    (the version does NOT bump — a duplicate is the same feature, since
    placement never changes the math), and a commit at an OLDER step
    than the stored entry is refused outright. Speculative dual
    placement races two tiers on the same submodule and commits
    whichever returns first; these two rules are what make a losing
    flight's late commit harmless — it can never clobber a newer
    version or regress staleness.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..obs import Metrics, Tracer


@dataclass
class CacheEntry:
    feature: Any               # tensor (B, d_m)
    step: int                  # engine step that produced it
    tier: str                  # 'glass' | 'edge'
    modality: str
    version: int = 0


class StalenessError(RuntimeError):
    pass


class FeatureCache:
    def __init__(self, max_staleness: int = 1, *,
                 metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None):
        self.max_staleness = max_staleness
        self._store: Dict[Tuple[str, str], CacheEntry] = {}
        # counters live on the (possibly shared) metrics registry; the
        # historical attributes survive as read-through properties
        self.metrics = metrics if metrics is not None else Metrics()
        self.tracer = tracer if tracer is not None else Tracer.disabled

    # ---- legacy counter attributes (read-through to the registry)
    @property
    def hits(self) -> int:
        return int(self.metrics.get("cache.hits"))

    @property
    def misses(self) -> int:
        return int(self.metrics.get("cache.misses"))

    @property
    def duplicate_commits(self) -> int:
        """Same-step re-commits (no-ops)."""
        return int(self.metrics.get("cache.duplicate_commits"))

    @property
    def stale_commits(self) -> int:
        """Older-step late commits (refused)."""
        return int(self.metrics.get("cache.stale_commits"))

    def put(self, session: str, modality: str, feature, *, step: int,
            tier: str = "glass") -> bool:
        """Commit a feature; returns True iff the entry changed.

        Commits are idempotent and monotone: re-committing the step the
        entry already holds is a structural no-op (same step = same
        input = same feature — the version does NOT bump, so tier
        replicas never re-ship), and committing an older step than the
        stored entry is refused — a losing speculative flight or a
        crash-delayed straggler can never regress staleness."""
        key = (session, modality)
        prev = self._store.get(key)
        if prev is not None:
            if step < prev.step:
                self.metrics.inc("cache.stale_commits")
                if self.tracer:
                    self.tracer.instant(
                        "cache.commit", "cache", track="cache",
                        key=session, modality=modality, step=step,
                        tier=tier, accepted=False, reason="stale")
                return False
            if step == prev.step:
                self.metrics.inc("cache.duplicate_commits")
                if self.tracer:
                    self.tracer.instant(
                        "cache.commit", "cache", track="cache",
                        key=session, modality=modality, step=step,
                        tier=tier, accepted=False, reason="duplicate")
                return False
        version = (prev.version + 1) if prev else 0
        self._store[key] = CacheEntry(
            feature=feature, step=step, tier=tier, modality=modality,
            version=version)
        self.metrics.inc("cache.commits")
        if self.tracer:
            self.tracer.instant(
                "cache.commit", "cache", track="cache", key=session,
                modality=modality, step=step, tier=tier, accepted=True,
                version=version)
        return True

    def get(self, session: str, modality: str, *,
            input_step: Optional[int] = None):
        """``input_step``: the engine step at which this modality's
        aggregated input last changed. A cache entry must have been
        computed no more than ``max_staleness`` steps before that —
        the paper's "never outdated by more than one step" invariant
        (the slack covers an edge crash mid-recompute)."""
        entry = self._store.get((session, modality))
        if entry is None:
            self.metrics.inc("cache.misses")
            return None
        if input_step is not None and input_step - entry.step > self.max_staleness:
            raise StalenessError(
                f"cache for {modality} lags its input by "
                f"{input_step - entry.step} steps (max {self.max_staleness}) "
                "— fault-tolerance invariant broken")
        self.metrics.inc("cache.hits")
        return entry

    def features(self, session: str, modalities, *, input_steps=None):
        """Dict of cached features for the given modalities (None if any missing)."""
        out = {}
        for m in modalities:
            e = self.get(session, m,
                         input_step=(input_steps or {}).get(m))
            if e is None:
                return None
            out[m] = e.feature
        return out

    def peek(self, session: str, modality: str):
        """Non-counting, non-asserting read — for replica bookkeeping
        (byte accounting, eviction scans), not the serving fuse path."""
        return self._store.get((session, modality))

    def entries(self):
        """Iterate ((session, modality), entry) pairs — replica re-warm
        scans after a tier restart read the whole live cache."""
        return self._store.items()

    def touch(self, session: str, modality: str, step: int):
        """Re-stamp an entry (edge returned it alongside a result)."""
        e = self._store.get((session, modality))
        if e is not None:
            e.step = step
            if self.tracer:
                self.tracer.instant("cache.touch", "cache", track="cache",
                                    key=session, modality=modality,
                                    step=step)

    def drop_tier(self, tier: str):
        """Invalidate entries held only by a crashed tier."""
        dropped = [list(k) for k, v in self._store.items()
                   if v.tier == tier]
        self._store = {k: v for k, v in self._store.items() if v.tier != tier}
        if self.tracer and dropped:
            self.tracer.instant("cache.drop", "cache", track="cache",
                                scope="tier", tier=tier, dropped=dropped)

    def drop_session(self, session: str) -> int:
        """Evict every modality entry of one session key (cross-incident
        session eviction); returns how many entries were dropped."""
        keys = [k for k in self._store if k[0] == session]
        for k in keys:
            del self._store[k]
        if self.tracer and keys:
            self.tracer.instant("cache.drop", "cache", track="cache",
                                scope="session", key=session,
                                dropped=[list(k) for k in keys])
        return len(keys)

    def __contains__(self, key):
        return key in self._store

    def __len__(self):
        return len(self._store)
