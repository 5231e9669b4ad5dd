"""Percentile / latency-summary math (the reference's definitions).

Linear interpolation between closest ranks, matching ``numpy.percentile``'s
default, so the port's p50/p99 mean what the reference's do.
"""
from __future__ import annotations


def percentile(samples, q: float) -> float:
    """q-th percentile (``q`` in [0, 100]) with linear interpolation.
    Raises on an empty sample set."""
    xs = sorted(float(v) for v in samples)
    if not xs:
        raise ValueError("percentile() of empty sample set")
    if len(xs) == 1:
        return xs[0]
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def latency_summary(lat_s, wall_s: float, n_requests: int) -> dict:
    """QPS + percentile block for workload reports: per-request latencies in
    seconds in, ``{"qps", "p50_ms", "p99_ms", "mean_ms"}`` out."""
    lat_ms = [float(v) * 1e3 for v in lat_s]
    return {
        "qps": round(n_requests / wall_s, 1),
        "p50_ms": round(percentile(lat_ms, 50), 3),
        "p99_ms": round(percentile(lat_ms, 99), 3),
        "mean_ms": round(sum(lat_ms) / len(lat_ms), 3),
    }
