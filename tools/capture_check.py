#!/usr/bin/env python3
"""Does a ``torch.profiler`` capture hold every kernel the port launched?

``chip_smoke.py``'s phase ``telemetry_capture`` requires the trace to hold
and attribute every kernel of the port that the capture launched (the
launch counters). This tool repeats that capture on the card in one
process, after the smoke's kind of history (several ``torch.profiler``
sessions in the same process, ``_profile``), in three modes: ``cold``
(the profiler started just before the first query's first launch, as
the smoke captured through PR 19), ``sync`` (a device synchronisation
inside the window first: ``chip_smoke.capture(warmup=False)``) and
``warmup`` (the profiler's warm-up window over one query first:
``chip_smoke.capture()``); and for each kernel the trace lacks, tells
whether the trace lost its record (a launch call under a ``decode``
range whose correlation id has no kernel record) or the counter counted
a launch that never reached the runtime (more launches counted than
launch calls traced).

    python3 tools/capture_check.py --trials 5

One JSON line per capture (the card's name and power limit with it), then
a summary line per mode.
"""
MODES = ("cold", "sync", "warmup")
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def capture_cold(torch, engine, qs, tele, counters):
    """The capture as ``chip_smoke.py`` ran it through PR 19: counters set
    to 0 and ``dispatch.decode`` counted before the profiler starts, the
    first query's launches right after its start. Returns what
    ``chip_smoke.capture`` returns."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels.vbyte_decode import dispatch

    calls = [0]
    real = dispatch.decode

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    chip_smoke._reset(torch, counters)
    dispatch.decode = counted
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with obs.install(tele):
                for mode, terms in qs:
                    engine.search(terms, mode)
            torch.cuda.synchronize()
    finally:
        dispatch.decode = real
    return None, prof, 0.0, calls[0], chip_smoke._read(torch, counters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--queries", type=int, default=3,
                    help="queries per capture (the short smoke's: 3)")
    ap.add_argument("--sessions", type=int, default=3,
                    help="profiler sessions before each capture")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import obs
    from repro_torch.data.synthetic import (CLUEWEB_DOCS, posting_list_group,
                                            posting_tfs)
    from repro_torch.index import build_index
    from repro_torch.kernels.vbyte_decode import _build
    from repro_torch.launch.serve import SearchEngine, search_queries
    from repro_torch.obs.attribution import attribute_kernels

    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    lists = dict(enumerate(posting_list_group(rng, 12, 8)
                           + posting_list_group(rng, 16, 4)))
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    index = build_index(lists, tfs=tfs, n_docs=CLUEWEB_DOCS, format="vbyte")
    engine = SearchEngine(index, top_k=10, plan="auto", probe_width=512)
    qs = search_queries(rng, index, args.queries)
    engine.warmup(qs)
    summary = {m: [] for m in MODES}
    for trial in range(args.trials):
        for mode in MODES:
            for _ in range(args.sessions):
                chip_smoke._profile(torch, "history",
                                    lambda: engine.warmup(qs[:2]), 2)
            tele = obs.Telemetry(torch_annotations=True)
            counters = chip_smoke._launch_counters()
            if mode == "cold":
                _, prof, _, calls, launches = capture_cold(
                    torch, engine, qs, tele, counters)
            else:
                _, prof, _, calls, launches = chip_smoke.capture(
                    torch, engine, qs, tele, counters,
                    warmup=mode == "warmup")
            path = ROOT / "chiprun_out" / "capture_check.json"
            path.parent.mkdir(exist_ok=True)
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
            attr = attribute_kernels(events, tele.tracer.spans)
            counted = sum(launches[k] for k in chip_smoke.PORT_KERNELS)
            row = {"trial": trial, "mode": mode, "card": card,
                   "decode_calls": calls, "launches_counted": counted,
                   **{k: v for k, v in attr.items() if k != "examples"}}
            summary[mode].append(row)
            print(json.dumps(row), flush=True)
    for mode, rows in summary.items():
        print(json.dumps({
            "summary": True, "mode": mode, "card": card,
            "captures": len(rows),
            "held": sum(r["kernels"] == r["attributed"]
                        == r["launches_counted"] for r in rows),
            "kernel_records_lost": sum(r["launches_without_kernel"]
                                       for r in rows),
            "launches_never_traced": sum(
                max(r["launches_counted"] - r["range_launches"], 0)
                for r in rows),
            "lost_at": [r["lost_at"] for r in rows if r["lost_at"]]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
