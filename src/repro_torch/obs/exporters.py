"""Exporters: JSONL event log, Prometheus text exposition, Chrome trace.

The port's copy of ``repro/obs/exporters.py``: the same records and keys,
so a capture written by either package reads in the other. Formats:

* **JSONL** — one record per line; ``{"type": "span", ...}`` rows carry
  ``ts``/``dur`` (seconds, tracer clock), ``span_id``/``parent_id``/
  ``trace_id`` and the attribute dict, ``{"type": "event", ...}`` rows are
  zero-duration markers. Lossless — ``read_jsonl`` round-trips exactly,
  and ``python -m repro_torch.obs.report`` consumes it.
* **Prometheus** — standard text exposition. Histograms emit the cumulative
  ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet with power-of-two
  ``le`` bounds matching the log2 buckets.
* **Chrome trace** — ``{"traceEvents": [...]}`` complete (``"ph": "X"``)
  events in microseconds, one ``tid`` row per request trace so Perfetto /
  ``chrome://tracing`` renders each span tree as its own nested track.
  ``span_id``/``parent_id`` ride along in ``args`` so nesting survives a
  round-trip exactly instead of being inferred from time containment.
"""
from __future__ import annotations

import json

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
def _fmt_labels(lkey: tuple, extra: tuple = ()) -> str:
    pairs = list(lkey) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


def prometheus_text(registry: MetricsRegistry) -> str:
    lines: list[str] = []
    with registry._lock:
        items = sorted(registry._metrics.items())
    seen_help = set()
    for (name, lkey), m in items:
        if isinstance(m, Counter):
            if name not in seen_help:
                lines.append(f"# TYPE {name} counter")
                seen_help.add(name)
            lines.append(f"{name}{_fmt_labels(lkey)} {m.value}")
        elif isinstance(m, Gauge):
            if name not in seen_help:
                lines.append(f"# TYPE {name} gauge")
                seen_help.add(name)
            lines.append(f"{name}{_fmt_labels(lkey)} {m.value}")
        elif isinstance(m, Histogram):
            if name not in seen_help:
                lines.append(f"# TYPE {name} histogram")
                seen_help.add(name)
            cum = 0
            for e in sorted(m.buckets):
                cum += m.buckets[e]
                le = repr(float(2.0 ** e))
                lines.append(
                    f"{name}_bucket{_fmt_labels(lkey, (('le', le),))} {cum}")
            lines.append(
                f"{name}_bucket{_fmt_labels(lkey, (('le', '+Inf'),))} "
                f"{m.count}")
            lines.append(f"{name}_sum{_fmt_labels(lkey)} {m.total}")
            lines.append(f"{name}_count{_fmt_labels(lkey)} {m.count}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, float]:
    """Minimal exposition parser (CI smoke): ``{series: value}``. Raises on
    any malformed sample line, which is the point."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        if not series:
            raise ValueError(f"malformed exposition line: {line!r}")
        out[series] = float(value)
    return out


# ---------------------------------------------------------------------------
# JSONL span log
# ---------------------------------------------------------------------------
def write_jsonl(tracer: Tracer, path):
    with tracer._lock:
        recs = list(tracer.spans)
    with open(path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def read_jsonl(path) -> list[dict]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


# ---------------------------------------------------------------------------
# Chrome trace / Perfetto
# ---------------------------------------------------------------------------
def chrome_trace_events(tracer: Tracer) -> list[dict]:
    with tracer._lock:
        recs = list(tracer.spans)
    events = []
    for rec in recs:
        args = dict(rec["attrs"])
        args["span_id"] = rec["span_id"]
        if rec["type"] == "span":
            args["parent_id"] = rec["parent_id"]
            events.append({"name": rec["name"], "ph": "X", "pid": 0,
                           "tid": rec["trace_id"],
                           "ts": rec["ts"] * 1e6,
                           "dur": rec["dur"] * 1e6,
                           "args": args})
        else:
            events.append({"name": rec["name"], "ph": "i", "pid": 0,
                           "tid": rec["trace_id"], "ts": rec["ts"] * 1e6,
                           "s": "t", "args": args})
    return events


def write_chrome_trace(tracer: Tracer, path):
    doc = {"traceEvents": chrome_trace_events(tracer),
           "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)


def read_chrome_trace(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]
