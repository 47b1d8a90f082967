"""In-process metrics registry: named counters + log2-bucket histograms.

A copy of the JAX package's registry (racon_tpu/obs/metrics.py).

Names are dotted, lowest-cardinality-first (``served.consensus.ls``,
``poa.windows.d8.c512``) so prefix sums give per-phase / per-tier
rollups without a query language.  Everything is integer-or-float plain
data; ``snapshot()`` is JSON-ready for embedding in ``RunReport["obs"]``
and in the trace file.
"""

from __future__ import annotations

import math
import threading
from typing import Dict


class Histogram:
    """Count/sum/min/max plus log2 buckets keyed by upper bound.

    Log2 bucketing keeps the bucket count tiny over the value ranges we
    observe (window counts 1..10^5, walls 10µs..10^3s) while still
    separating "one straggler cohort" from "everything is slow"."""

    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.buckets: Dict[str, int] = {}

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v <= 0:
            key = "0"
        else:
            key = f"{2 ** max(0, math.ceil(math.log2(v))):g}"
        self.buckets[key] = self.buckets.get(key, 0) + 1

    def as_dict(self) -> dict:
        return {"count": self.count, "sum": round(self.sum, 6),
                "min": self.min, "max": self.max,
                "buckets": dict(self.buckets)}


def hist_quantile(hist: dict, q: float):
    """Quantile estimate from a snapshotted log2 histogram dict
    (``Histogram.as_dict()`` shape), with linear interpolation inside
    the winning bucket.

    The cumulative count crosses ``q`` somewhere inside one log2 bucket
    ``(lo, hi]`` (``lo = hi/2`` for ``hi >= 2``; the "1" bucket covers
    ``(0, 1]``).  The old estimator returned ``hi``, so a p99 gate
    jumped in 2x steps; interpolating the crossing fraction into the
    bucket keeps the estimate inside the same bucket (so the error is
    still bounded by the bucket width) while moving smoothly with the
    data.  The result is clamped to the observed ``[min, max]``.
    Returns None for an empty/malformed histogram."""
    try:
        total = int(hist["count"])
        buckets = hist["buckets"]
    except (KeyError, TypeError, ValueError):
        return None
    if total <= 0 or not isinstance(buckets, dict) or not buckets:
        return None
    need = max(1, math.ceil(q * total))
    seen = 0
    for bound in sorted(buckets, key=float):
        n = int(buckets[bound])
        if seen + n >= need:
            hi = float(bound)
            if not hi:
                return 0.0          # the "0" bucket holds only <=0 values
            lo = hi / 2.0 if hi >= 2.0 else 0.0
            frac = (need - seen) / n
            v = lo + frac * (hi - lo)
            hmin, hmax = hist.get("min"), hist.get("max")
            if hmax is not None:
                v = min(v, float(hmax))
            if hmin is not None:
                v = max(v, float(hmin))
            return v
        seen += n
    return hist.get("max")


class Metrics:
    """Thread-safe registry.  Counter and histogram namespaces are
    disjoint by convention (a name is one or the other)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._hists: Dict[str, Histogram] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def prefix_sum(self, prefix: str) -> int:
        """Sum of every counter whose name starts with ``prefix`` —
        the rollup behind the served-sum invariant."""
        with self._lock:
            return sum(v for k, v in self._counters.items()
                       if k.startswith(prefix))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(sorted(self._counters.items())),
                "histograms": {k: h.as_dict()
                               for k, h in sorted(self._hists.items())},
            }
