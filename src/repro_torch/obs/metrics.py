"""Metrics registry: counters, gauges, and streaming quantile sketches.

One ``Metrics`` object is the accounting surface of a serving stack:
the engine's ``FeatureCache`` keeps its hit/miss/commit counters in it.
``QuantileSketch`` is a DDSketch-style log-bucketed quantile sketch:
deterministic (bucket index ``ceil(log_gamma(v))``, insertion-order
independent) and relative-error bounded (any reported quantile ``q̂``
satisfies ``|q̂ - q| <= rel_err * q`` against the true sample quantile).

A copy of the part of ``repro.obs.metrics`` that the per-event engine
uses; merging and Prometheus export join with the observability slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

__all__ = ["QuantileSketch", "Metrics"]

# values below this land in the exact zero bucket (log would diverge)
_ZERO_EPS = 1e-12

# log_gamma ratios within this of an integer snap to it before ceil: a
# value that far inside a bucket boundary is within a relative
# gamma^1e-9 - 1 (~1e-11 at rel_err=0.01) of the boundary itself, far
# below any rel_err the sketch accepts
_BOUNDARY_EPS = 1e-9


class QuantileSketch:
    """DDSketch-style streaming quantile sketch for non-negative values."""

    __slots__ = ("rel_err", "_gamma", "_log_gamma", "_buckets", "_zero",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, rel_err: float = 0.01):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = rel_err
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self._gamma)
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def add(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v) or v < 0.0:
            raise ValueError(f"QuantileSketch.add: need finite v >= 0, got {value}")
        if v < _ZERO_EPS:
            self._zero += 1
        else:
            # bucket i covers (gamma^(i-1), gamma^i]; float slop in the
            # log can push a value sitting on a boundary just above the
            # integer, so near-integer ratios snap before ceil
            ratio = math.log(v) / self._log_gamma
            nearest = round(ratio)
            i = int(nearest) if abs(ratio - nearest) < _BOUNDARY_EPS \
                else math.ceil(ratio)
            self._buckets[i] = self._buckets.get(i, 0) + 1
        self._count += 1
        self._sum += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Value within ``rel_err`` (relative) of the true q-quantile,
        ``sorted(samples)[floor(q*(n-1))]``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self._count == 0:
            return None
        rank = int(math.floor(q * (self._count - 1)))
        cum = self._zero
        if cum > rank:
            return 0.0
        for i in sorted(self._buckets):
            cum += self._buckets[i]
            if cum > rank:
                mid = 2.0 * self._gamma ** i / (self._gamma + 1.0)
                # the true quantile lies inside [min, max]
                return min(max(mid, self._min), self._max)
        return self._max

    def summary(self) -> dict:
        if self._count == 0:
            return {"count": 0}
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": self._sum / self._count,
            "min": self._min,
            "max": self._max,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class Metrics:
    """Registry of named counters, gauges, and quantile histograms.

    * counters — accumulated floats (``inc``); read with ``get`` (0 when
      never incremented).
    * gauges — last-write-wins values (``set_gauge``).
    * histograms — a ``QuantileSketch`` per name (``observe``).

    ``snapshot()`` returns one JSON-serialisable dict with sorted keys;
    ``reset()`` clears all three.
    """

    def __init__(self, *, rel_err: float = 0.01):
        self.rel_err = rel_err
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, QuantileSketch] = {}

    def inc(self, name: str, value: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        return self._counters.get(name, default)

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = QuantileSketch(self.rel_err)
        h.add(value)

    def snapshot(self) -> dict:
        return {
            "counters": {k: self._counters[k] for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k] for k in sorted(self._gauges)},
            "histograms": {k: self._hists[k].summary()
                           for k in sorted(self._hists)},
        }

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
