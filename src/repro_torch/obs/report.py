"""CLI over a JSONL trace capture: ``python -m repro_torch.obs.report trace.jsonl``.

Renders (stdout, plain text):

* a per-stage latency table — one row per span name with count and
  p50/p99/mean milliseconds plus total time, sorted hottest-first;
* a top-N hottest terms table — spans carrying a ``term`` attribute are
  aggregated by blocks decoded / ints decoded / time spent;
* a top-N hottest blocks table — per-(term, block) decode attribution when
  spans carry ``blocks`` lists.

The capture comes from ``Tracer.write_jsonl`` (e.g. ``repro_torch.launch.serve
--metrics-out DIR`` writes ``DIR/trace.jsonl``). The port's copy of
``repro/obs/report.py``: the records are the same in both packages, so it
renders a capture written by either.
"""
from __future__ import annotations

import argparse
from collections import defaultdict

from .exporters import read_jsonl
from .stats import percentile


def _table(headers: list[str], rows: list[list]) -> str:
    cells = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(headers))]
    lines = []
    for j, r in enumerate(cells):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def stage_rows(recs: list[dict]) -> list[list]:
    """Per-stage latency rows: [stage, count, p50_ms, p99_ms, mean_ms, total_ms]."""
    by_name: dict[str, list[float]] = defaultdict(list)
    for r in recs:
        if r.get("type") == "span":
            by_name[r["name"]].append(r["dur"] * 1e3)
    rows = []
    for name, ds in by_name.items():
        rows.append([name, len(ds),
                     round(percentile(ds, 50), 3),
                     round(percentile(ds, 99), 3),
                     round(sum(ds) / len(ds), 3),
                     round(sum(ds), 3)])
    rows.sort(key=lambda r: -r[5])
    return rows


def hottest_terms(recs: list[dict], top: int = 10) -> list[list]:
    """Top terms by ints decoded: [term, spans, blocks_decoded, ints, ms]."""
    agg: dict[str, list[float]] = defaultdict(lambda: [0, 0, 0, 0.0])
    for r in recs:
        if r.get("type") != "span":
            continue
        term = r["attrs"].get("term")
        if term is None:
            continue
        a = agg[str(term)]
        a[0] += 1
        a[1] += int(r["attrs"].get("blocks_decoded", 0))
        a[2] += int(r["attrs"].get("ints_decoded", 0))
        a[3] += r["dur"] * 1e3
    rows = [[t, a[0], a[1], a[2], round(a[3], 3)] for t, a in agg.items()]
    rows.sort(key=lambda r: (-r[3], -r[2], r[0]))
    return rows[:top]


def hottest_blocks(recs: list[dict], top: int = 10) -> list[list]:
    """Top (term, block) pairs by decode count from span ``blocks`` attrs."""
    counts: dict[tuple, int] = defaultdict(int)
    for r in recs:
        if r.get("type") != "span":
            continue
        term = r["attrs"].get("term")
        blocks = r["attrs"].get("blocks")
        if term is None or not isinstance(blocks, (list, tuple)):
            continue
        for b in blocks:
            counts[(str(term), int(b))] += 1
    rows = [[t, b, n] for (t, b), n in counts.items()]
    rows.sort(key=lambda r: (-r[2], r[0], r[1]))
    return rows[:top]


def render(recs: list[dict], top: int = 10) -> str:
    n_traces = len({r["trace_id"] for r in recs if r.get("type") == "span"})
    out = [f"{sum(1 for r in recs if r.get('type') == 'span')} spans "
           f"across {n_traces} traces", ""]
    out.append("per-stage latency:")
    out.append(_table(["stage", "count", "p50_ms", "p99_ms", "mean_ms",
                       "total_ms"], stage_rows(recs)))
    terms = hottest_terms(recs, top)
    if terms:
        out += ["", f"hottest terms (top {top}):",
                _table(["term", "spans", "blocks_decoded", "ints_decoded",
                        "ms"], terms)]
    blocks = hottest_blocks(recs, top)
    if blocks:
        out += ["", f"hottest blocks (top {top}):",
                _table(["term", "block", "decodes"], blocks)]
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render per-stage latency + hottest terms/blocks "
                    "from a JSONL trace capture.")
    ap.add_argument("capture", help="trace.jsonl written by Tracer.write_jsonl")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the hottest-terms/blocks tables")
    args = ap.parse_args(argv)
    try:
        recs = read_jsonl(args.capture)
    except OSError as e:
        print(f"{args.capture}: {e.strerror or e}")
        return 1
    if not recs:
        print(f"{args.capture}: empty capture")
        return 1
    try:
        print(render(recs, args.top))
    except BrokenPipeError:  # e.g. piped into `head`
        import os
        import sys
        sys.stdout = None  # suppress the flush-on-exit error
        os.close(1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
