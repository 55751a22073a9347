"""Typed serving metrics: counters, fixed-bucket histograms, and the
registry that names them (the port's own copy of ``repro.obs.metrics``;
host-side Python, no tensors).

* ``Counter`` — monotone event count (``inc``).
* ``Histogram`` — fixed-bucket distribution for latencies; ``observe`` is
  one ``bisect`` plus two scalar adds, and quantiles interpolate inside the
  winning bucket (the Prometheus ``histogram_quantile`` estimate).
* ``MetricsRegistry`` — dotted-name -> metric map with a nested-dict
  ``snapshot()`` (the substrate of ``Server.stats()``).

The reference's gauges and Prometheus exposition come with the telemetry
slice of the port.
"""

from __future__ import annotations

from bisect import bisect_right

__all__ = ["Counter", "Histogram", "MetricsRegistry", "LATENCY_BUCKETS_S"]

# Default latency edges: log-spaced 100us .. ~2min, the span between one
# cached decode dispatch on accelerator and a cold multi-minute prefill on
# the CPU CI leg.  22 finite buckets + overflow keeps quantile resolution
# ~1.8x per step while the per-observe cost stays a short bisect.
LATENCY_BUCKETS_S = tuple(1e-4 * (1.9 ** i) for i in range(22))


class Counter:
    """Monotonically increasing event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket distribution; allocation-free ``observe``.

    ``edges`` are the finite upper bounds; ``counts`` has one extra slot
    for the overflow (+inf) bucket.  ``quantile`` interpolates linearly
    inside the bucket that crosses the target rank — exact at the recorded
    resolution, never allocating or sorting samples.
    """

    __slots__ = ("edges", "counts", "count", "sum", "min", "max")

    def __init__(self, edges=LATENCY_BUCKETS_S):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_right(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0..1) from the bucket counts; 0.0 when
        empty.  The min/max trackers clamp the interpolation so a p99 can
        never exceed the largest value actually observed."""
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if seen + c >= rank:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self.max
                lo = max(lo, self.min) if i == 0 or seen == 0 else lo
                frac = (rank - seen) / c
                v = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return min(max(v, self.min), self.max)
            seen += c
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Dotted-name -> metric map that ``Server.stats()`` is a view over."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    # -- factories / adoption -------------------------------------------------
    def register(self, name: str, metric):
        """Adopt a metric object under ``name`` (re-registering a name
        replaces the binding)."""
        self._metrics[str(name)] = metric
        return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str, edges=LATENCY_BUCKETS_S) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self.register(name, Histogram(edges))
        if not isinstance(m, Histogram):
            raise TypeError(f"{name!r} is registered as {type(m).__name__}")
        return m

    def _get(self, name, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self.register(name, cls())
        if not isinstance(m, cls):
            raise TypeError(f"{name!r} is registered as {type(m).__name__}")
        return m

    # -- views ----------------------------------------------------------------
    def snapshot(self) -> dict:
        """Nested dict keyed by the dotted-name segments: counters become
        leaves, histograms their summary dicts."""
        out: dict = {}
        for name in sorted(self._metrics):
            node = out
            parts = name.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = self._metrics[name].snapshot()
        return out
