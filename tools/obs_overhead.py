#!/usr/bin/env python3
"""The telemetry overhead gates of ``chip_smoke.py`` (phase
``telemetry_overhead``: the reference's ``_obs_overhead`` configuration,
``null_path_overhead_pct`` < 3 and ``overhead_pct`` < 15), measured
``--runs`` times on the card, each in a fresh spawned process as the smoke
measures it once: the spread its single reading is drawn from.

    python3 tools/obs_overhead.py --runs 10

One JSON line per run (the card's name and power limit with it), then a
summary line. Each run also gives the paired estimate (the median over
the 12 pairs of capture p50 / null p50 − 1, ``paired_pct``), the garbage
collector's passes during the null and the capture passes (``gc``), and
the captured sites' own host cost in that process (``site_us``: one
``decode``-like span nested in a ``request`` span, a counter with three
labels) and ``expected_pct``, the sites a query hits at a span's cost
each over the null p50; against that, ``in_place``: each query's best
captured latency less its best null one, fitted to the sites it hits
(``us_per_site``, ``us_per_query``); and the control schedules of
``chip_smoke.obs_overhead(detail=True)`` (``aa``: null against null,
``swapped``: capture first, ``gc_off``: the collector off).
"""
import argparse
import json
import multiprocessing as mp
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SITE_ITERS = 20_000


def _site_costs() -> dict:
    """Host microseconds of one captured span (nested in another, as a
    ``decode`` span is) and of one labelled counter bump, best of 5."""
    from repro_torch import obs

    def spans():
        for _ in range(SITE_ITERS // 2):
            with obs.trace("request", mode="and"):
                with obs.trace("decode", format="vbyte", plan="cuda_fused",
                               epilogue="membership", blocks=4, chunk=None,
                               sharded=False):
                    pass

    def counters():
        for _ in range(SITE_ITERS):
            obs.counter_inc("decode_calls_total", plan="cuda_fused",
                            format="vbyte", epilogue="membership")

    out = {}
    for name, fn in (("span", spans), ("counter", counters)):
        best = float("inf")
        for _ in range(5):
            with obs.install(obs.Telemetry()):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
        out[name] = round(best / SITE_ITERS * 1e6, 3)
    return out


def _worker() -> dict:
    import numpy as np

    got = chip_smoke._overhead_worker(detail=True)
    pairs = [c / n - 1 for n, c in zip(got["null_p50s_ms"],
                                       got["instrumented_p50s_ms"])]
    site = _site_costs()
    d = got["detail"]
    # each query's added time against the sites it hits: the slope is a
    # site's cost in place, the intercept what the capture costs a query
    # besides its sites
    added = np.subtract(d["capture_best_us"], d["null_best_us"])
    slope, icept = np.polyfit(np.asarray(d["sites"], float), added, 1)
    return {**got, "paired_pct": round(statistics.median(pairs) * 100, 2),
            "site_us": site, "expected_pct": round(
                got["sites_per_query"] * site["span"] * 1e-3
                / got["null_p50_ms"] * 100, 2),
            "in_place": {"us_per_site": round(float(slope), 3),
                         "us_per_query": round(float(icept), 2),
                         "median_added_us": round(float(np.median(added)),
                                                  2)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels.vbyte_decode import _build

    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    runs = []
    for i in range(args.runs):
        with ProcessPoolExecutor(max_workers=1,
                                 mp_context=mp.get_context("spawn")) as pool:
            got = pool.submit(_worker).result()
        runs.append(got)
        print(json.dumps({"run": i, "card": card, **got}), flush=True)
    ovh = [r["overhead_pct"] for r in runs]
    print(json.dumps({
        "summary": True, "card": card, "runs": len(runs),
        "overhead_pct": {"min": min(ovh), "median": statistics.median(ovh),
                         "max": max(ovh)},
        "over_gate": sum(o >= chip_smoke.CAPTURE_GATE_PCT for o in ovh),
        "null_path_over_gate": sum(
            r["null_path_overhead_pct"] >= chip_smoke.NULL_PATH_GATE_PCT
            for r in runs),
        "paired_pct_median": statistics.median(r["paired_pct"]
                                               for r in runs),
        "gc_capture_collections": [sum(r["gc"]["capture"]["collections"][g]
                                       for r in runs) for g in range(3)],
        "gc_null_collections": [sum(r["gc"]["null"]["collections"][g]
                                    for r in runs) for g in range(3)],
        "controls_overhead_pct_median": {
            k: statistics.median(r["detail"][k]["overhead_pct"]
                                 for r in runs)
            for k in ("aa", "swapped", "gc_off")},
        "in_place_median": {
            k: statistics.median(r["in_place"][k] for r in runs)
            for k in ("us_per_site", "us_per_query", "median_added_us")}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
