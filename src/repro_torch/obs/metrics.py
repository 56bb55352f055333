"""Metrics registry: counters, gauges, and streaming quantile sketches.

One ``Metrics`` object is the accounting surface of a serving stack:
the engine's ``FeatureCache`` keeps its hit/miss/commit counters in it.
``QuantileSketch`` is a DDSketch-style log-bucketed quantile sketch:
deterministic (bucket index ``ceil(log_gamma(v))``, insertion-order
independent), relative-error bounded (any reported quantile ``q̂``
satisfies ``|q̂ - q| <= rel_err * q`` against the true sample quantile)
and exactly mergeable (``a.merge(b)`` adds bucket counts, so merging is
associative and commutative on the bucket state; the float running
``sum`` is the only approximately associative field).

``Metrics.merged`` folds many registries into one (a fleet's replicas),
and ``Metrics.to_prometheus`` writes the Prometheus text exposition
format. A copy of ``repro.obs.metrics``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

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

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Return a NEW sketch holding both inputs' samples."""
        if not isinstance(other, QuantileSketch):
            raise TypeError("can only merge QuantileSketch with QuantileSketch")
        if other.rel_err != self.rel_err:
            raise ValueError("cannot merge sketches with different rel_err")
        out = QuantileSketch(self.rel_err)
        out._buckets = dict(self._buckets)
        for i, n in other._buckets.items():
            out._buckets[i] = out._buckets.get(i, 0) + n
        out._zero = self._zero + other._zero
        out._count = self._count + other._count
        out._sum = self._sum + other._sum
        out._min = min(self._min, other._min)
        out._max = max(self._max, other._max)
        return out

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> Optional[float]:
        return None if self._count == 0 else self._min

    @property
    def max(self) -> Optional[float]:
        return None if self._count == 0 else self._max

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

    def state(self):
        """Exact mergeable state (for associativity checks and equality)."""
        return (tuple(sorted(self._buckets.items())), self._zero,
                self._count, self._min, self._max)

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
    * gauges — last-write-wins values (``set_gauge``), or callables
      (``gauge_fn``) sampled at ``snapshot()`` time.
    * histograms — a ``QuantileSketch`` per name (``observe``).

    ``snapshot()`` returns one JSON-serialisable dict with sorted keys;
    ``reset()`` clears counters, gauge values and histograms but keeps
    gauge registrations (callable gauges describe live state).
    """

    def __init__(self, *, rel_err: float = 0.01):
        self.rel_err = rel_err
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._gauge_fns: Dict[str, Callable[[], float]] = {}
        self._hists: Dict[str, QuantileSketch] = {}

    def inc(self, name: str, value: float = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str, default: float = 0) -> float:
        return self._counters.get(name, default)

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        self._gauge_fns[name] = fn

    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = QuantileSketch(self.rel_err)
        h.add(value)

    def histogram(self, name: str) -> Optional[QuantileSketch]:
        return self._hists.get(name)

    def snapshot(self) -> dict:
        gauges = dict(self._gauges)
        for name, fn in self._gauge_fns.items():
            gauges[name] = fn()
        return {
            "counters": {k: self._counters[k] for k in sorted(self._counters)},
            "gauges": {k: gauges[k] for k in sorted(gauges)},
            "histograms": {k: self._hists[k].summary()
                           for k in sorted(self._hists)},
        }

    @classmethod
    def merged(cls, registries) -> "Metrics":
        """Exact union of registries: counters and gauges sum (callable
        gauges are sampled), histograms merge through
        ``QuantileSketch.merge``, so N replicas' sketches fold into the
        same quantiles whatever the merge order."""
        regs = list(registries)
        if not regs:
            return cls()
        rel_err = regs[0].rel_err
        if any(r.rel_err != rel_err for r in regs):
            raise ValueError("cannot merge registries with different "
                             "rel_err")
        out = cls(rel_err=rel_err)
        for r in regs:
            for k, v in r._counters.items():
                out._counters[k] = out._counters.get(k, 0) + v
            gauges = dict(r._gauges)
            for k, fn in r._gauge_fns.items():
                gauges[k] = fn()
            for k, v in gauges.items():
                out._gauges[k] = out._gauges.get(k, 0) + v
            for k, h in r._hists.items():
                cur = out._hists.get(k)
                out._hists[k] = h.merge(cur if cur is not None
                                        else QuantileSketch(rel_err))
        return out

    def to_prometheus(self, *, prefix: str = "emsserve") -> str:
        """Prometheus text exposition format (version 0.0.4).

        Counters export as ``counter``, gauges as ``gauge``, and each
        quantile sketch as a ``summary`` (p50/p95/p99 + ``_sum`` /
        ``_count``). Names are sanitised (every character but letters,
        digits and ``_`` becomes ``_``) and prefixed; the output is
        sorted and deterministic. Sanitising is lossy (``cache.hits`` and
        ``cache_hits`` both map to ``cache_hits``), so colliding names
        take a numeric suffix (``_2``, ``_3``, ...) in sorted-key order
        and every exported name carries exactly one ``# TYPE`` line
        (scrapers reject a page with duplicate ones)."""
        gauges = dict(self._gauges)
        for k, fn in self._gauge_fns.items():
            gauges[k] = fn()

        def sanitise(k):
            base = "".join(c if (c.isalnum() or c == "_") else "_"
                           for c in k)
            return f"{prefix}_{base}" if prefix else base

        names: Dict[tuple, str] = {}
        used = set()
        for kind, keys in (("counter", sorted(self._counters)),
                           ("gauge", sorted(gauges)),
                           ("summary", sorted(self._hists))):
            for k in keys:
                n = sanitise(k)
                cand, suffix = n, 2
                while cand in used:
                    cand = f"{n}_{suffix}"
                    suffix += 1
                used.add(cand)
                names[(kind, k)] = cand

        def num(v):
            return repr(float(v))

        lines = []
        for k in sorted(self._counters):
            n = names[("counter", k)]
            lines += [f"# TYPE {n} counter", f"{n} {num(self._counters[k])}"]
        for k in sorted(gauges):
            n = names[("gauge", k)]
            lines += [f"# TYPE {n} gauge", f"{n} {num(gauges[k])}"]
        for k in sorted(self._hists):
            h = self._hists[k]
            n = names[("summary", k)]
            lines.append(f"# TYPE {n} summary")
            if h.count:
                for q in (0.5, 0.95, 0.99):
                    lines.append(f'{n}{{quantile="{q}"}} '
                                 f"{num(h.quantile(q))}")
            lines += [f"{n}_sum {num(h.sum)}", f"{n}_count {h.count}"]
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
