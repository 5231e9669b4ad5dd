"""Metrics registry: counters, gauges, log-bucketed histograms.

The port's copy of ``repro/obs/metrics.py`` (standard library only): the
same metrics, buckets and exposition, so a registry fed the same calls
exports the same bytes in both packages. Design constraints:

* **Dependency-free** — stdlib only, importable before torch/numpy init.
* **Mergeable** — every metric supports ``merge(other)`` by pure addition
  (gauges take the latest write), so folding per-shard or per-subprocess
  registries together is associative and commutative: any merge order
  produces the same aggregate, which is what lets the benchmark sweeps
  and the logical-shard serving path aggregate without coordination.
* **Injectable clock** — ``MetricsRegistry(clock=...)`` drives every
  ``timer()`` measurement, so tests pin exact durations (and therefore
  exact histogram buckets) with a simulated clock.

Histograms are log2-bucketed: an observation ``v`` lands in the bucket
whose upper bound is the smallest power of two ``>= v`` (computed exactly
via ``math.frexp`` — no float-log drift at bucket boundaries). Bucket
counts, not samples, are what merge — a histogram is O(#distinct
magnitudes), never O(#observations).
"""
from __future__ import annotations

import math
import threading
import time

# log2 bucket exponent clamp: 2^-40 s ≈ 1 ps under any latency of
# interest, 2^64 covers any byte/int size metric
MIN_EXP = -40
MAX_EXP = 64


def bucket_exp(v: float) -> int:
    """Exponent ``e`` of the smallest power of two ``2**e >= v`` (clamped).

    Exact at boundaries: ``bucket_exp(0.25) == -2``, ``bucket_exp(8) == 3``,
    ``bucket_exp(9) == 4``. Non-positive observations land in ``MIN_EXP``.
    """
    if v <= 0:
        return MIN_EXP
    m, e = math.frexp(v)  # v = m * 2**e with 0.5 <= m < 1
    e = e - 1 if m == 0.5 else e
    return max(MIN_EXP, min(MAX_EXP, e))


class Counter:
    """Monotonic counter. ``inc`` only; merge is addition."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1):
        self.value += n

    def merge(self, other: "Counter"):
        self.value += other.value

    def snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar (queue depth, epoch, delta size)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v):
        self.value = v

    def inc(self, n=1):
        self.value += n

    def merge(self, other: "Gauge"):
        self.value = other.value  # latest write wins across merges

    def snapshot(self):
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Log2-bucketed histogram of latencies / sizes.

    ``buckets[e]`` counts observations in ``(2**(e-1), 2**e]`` (``MIN_EXP``
    also absorbs everything at or below its lower edge). Merging adds
    bucket counts — associative, so shard order never changes the result.
    """

    __slots__ = ("buckets", "count", "total", "vmin", "vmax")

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float):
        e = bucket_exp(v)
        self.buckets[e] = self.buckets.get(e, 0) + 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def merge(self, other: "Histogram"):
        for e, n in other.buckets.items():
            self.buckets[e] = self.buckets.get(e, 0) + n
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile: the upper bound of the bucket the
        q-quantile observation falls in (0 for an empty histogram)."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for e in sorted(self.buckets):
            seen += self.buckets[e]
            if seen >= rank:
                return float(2.0 ** e)
        return float(2.0 ** max(self.buckets))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self):
        return {"type": "histogram", "count": self.count,
                "sum": self.total,
                "min": None if self.count == 0 else self.vmin,
                "max": None if self.count == 0 else self.vmax,
                "buckets": {str(e): n for e, n in sorted(self.buckets.items())}}


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Timer:
    """Context manager observing its own wall time into a histogram."""

    __slots__ = ("_hist", "_clock", "_t0", "elapsed")

    def __init__(self, hist: Histogram, clock):
        self._hist = hist
        self._clock = clock
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self.elapsed = self._clock() - self._t0
        self._hist.observe(self.elapsed)
        return False


class MetricsRegistry:
    """Named, labeled metrics + structured event records.

    ``counter/gauge/histogram(name, **labels)`` create-or-return the metric
    for that (name, label-set) — label values stringify, so
    ``reg.counter("decode_calls_total", plan=p.label)`` is one series per
    plan. ``merge(other)`` folds a whole registry in (shard/subprocess
    aggregation). ``record_event`` appends a timestamped structured record
    (e.g. one crash-recovery summary per reopen); events concatenate on
    merge. All mutation is lock-protected — serving engines observe from
    request threads while a background merge records phase durations.
    """

    def __init__(self, *, clock=None):
        self.clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}
        # per-call-site fast path: raw (kind, name, labels) -> metric, so
        # the hot instrumentation helpers skip label stringification and
        # the lock after a series' first touch (dict reads are GIL-atomic)
        self._fast: dict[tuple, Counter | Gauge | Histogram] = {}
        self.events: list[dict] = []
        # callables that add pending counts before the registry is read
        # (a Telemetry's tracer: its counted_trace spans)
        self._sources: list = []

    def _sync(self):
        for add in self._sources:
            add(self)

    def _get(self, kind, name: str, labels: dict):
        # the fast key keeps the call site's label order (no sort): a site
        # passes its labels in one order, and two orders of one label set
        # resolve to the same metric through the canonical key below
        fkey = (kind, name, *labels.items())
        m = self._fast.get(fkey)
        if m is not None:
            return m
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = kind()
                self._metrics[key] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r}{labels} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}")
            self._fast[fkey] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        self._sync()
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def timer(self, name: str, **labels) -> _Timer:
        """``with reg.timer("wal_append_seconds"): ...`` — observes the
        block's duration (by the registry's clock) into the histogram."""
        return _Timer(self.histogram(name, **labels), self.clock)

    def record_event(self, name: str, **fields):
        evt = {"event": name, "ts": self.clock(), **fields}
        with self._lock:
            self.events.append(evt)
        return evt

    def merge(self, other: "MetricsRegistry"):
        """Fold ``other`` in. Addition for counters/histograms (associative
        across any merge order), last-write for gauges, concatenation for
        events."""
        other._sync()
        self._sync()
        with other._lock:
            items = list(other._metrics.items())
            events = list(other.events)
        for key, m in items:
            name, lkey = key
            mine = self._get(type(m), name, dict(lkey))
            mine.merge(m)
        with self._lock:
            self.events.extend(events)

    # -- export --------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-ready dump: ``{name{labels}: metric snapshot}`` + events."""
        self._sync()
        with self._lock:
            items = list(self._metrics.items())
            events = list(self.events)
        out = {}
        for (name, lkey), m in sorted(items):
            label_s = ",".join(f"{k}={v}" for k, v in lkey)
            out[f"{name}{{{label_s}}}" if label_s else name] = m.snapshot()
        return {"metrics": out, "events": events}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (histograms as cumulative ``le``
        buckets, the standard ``_bucket/_sum/_count`` triplet)."""
        from .exporters import prometheus_text

        return prometheus_text(self)
