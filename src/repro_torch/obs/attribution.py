"""Kernel attribution: each of the port's CUDA kernels in a ``torch.profiler``
trace, matched to the ``decode`` span that launched it.

Under ``Telemetry(torch_annotations=True)`` every span is also a
``record_function`` range, so the profiler's trace holds one ``decode``
range per ``dispatch.decode`` call, in the order the tracer recorded the
spans. A kernel's launch (the runtime or driver call sharing its
``correlation`` id) lies inside the innermost such range on its thread;
the range's span carries the ``format`` and ``epilogue`` the kernel must
have been built for. Standard library only: it reads the trace's JSON
events (``prof.export_chrome_trace``) and the tracer's span records.
"""
from __future__ import annotations

import bisect
import re

FORMATS = ("vbyte", "streamvbyte", "binpack")  # the kernels' format ids
EPILOGUES = ("stream", "checksum", "membership", "membership_rows",
             "bm25_accum", "bm25_accum_rows", "bm25_weighted",
             "bm25_weighted_rows", "bag_sum", "dot_score",
             "adjacency_rebase")  # kernel 2's epilogue ids
_DECODERS = {"vbyte_decode_kernel": "vbyte",
             "stream_decode_kernel": "streamvbyte",
             "binpack_decode_kernel": "binpack"}
_TEMPLATED = re.compile(r"\b(fused_decode_kernel|probe_kernel|dot_kernel)"
                        r"<\(?\w*\)?(\d+),\s*\(?\w*\)?(\d+)")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver", "runtime", "driver")


def kernel_ids(name: str):
    """``(format, epilogue)`` a kernel of the port was instantiated for,
    from its (demangled) name; ``None`` for any other kernel."""
    for fn, fmt in _DECODERS.items():
        if re.search(rf"\b{fn}\b", name):
            return fmt, "stream"
    m = _TEMPLATED.search(name)
    if m is None:
        return None
    fmt = FORMATS[int(m.group(2))]
    if m.group(1) == "dot_kernel":  # its second parameter is a table mode
        return fmt, "dot_score"
    return fmt, EPILOGUES[int(m.group(3))]


def attribute_kernels(events: list, spans: list, *, range_name="decode"):
    """Match every port kernel in ``events`` (a chrome trace's
    ``traceEvents``) to the ``range_name`` span that launched it.

    ``spans`` are the tracer's records of the same run. Returns a dict:
    ``kernels`` (port kernels seen), ``attributed`` (inside a range whose
    span's format and epilogue match the kernel), ``outside`` (launched
    outside every range), ``mismatched`` (inside a range whose span names
    another format or epilogue; up to 10 examples under ``examples``),
    ``other_kernels`` (kernels that are not the port's: PyTorch's own),
    ``ranges`` and ``spans`` (the two counts, which must agree).
    """
    ranges = sorted((e for e in events if e.get("ph") == "X"
                     and e.get("name") == range_name
                     and e.get("cat") in ("user_annotation", "cpu_op")),
                    key=lambda e: e["ts"])
    recs = sorted((s for s in spans if s.get("type") == "span"
                   and s["name"] == range_name), key=lambda s: s["ts"])
    launches = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS and "Launch" in e.get("name", ""):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    by_tid: dict = {}  # tid -> (range indices, their start times)
    for i, r in enumerate(ranges):
        idx, starts = by_tid.setdefault(r.get("tid"), ([], []))
        idx.append(i)
        starts.append(r["ts"])
    out = {"kernels": 0, "attributed": 0, "outside": 0, "mismatched": 0,
           "other_kernels": 0, "ranges": len(ranges), "spans": len(recs),
           "by_kernel": {}, "examples": []}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ids = kernel_ids(e.get("name", ""))
        if ids is None:
            out["other_kernels"] += 1
            continue
        out["kernels"] += 1
        key = f"{ids[0]}/{ids[1]}"
        out["by_kernel"][key] = out["by_kernel"].get(key, 0) + 1
        launch = launches.get((e.get("args") or {}).get("correlation"))
        owner = None
        if launch is not None:
            idx, starts = by_tid.get(launch.get("tid"), ([], []))
            j = bisect.bisect_right(starts, launch["ts"]) - 1
            # the innermost range holding the launch: the latest-starting
            # one that has not ended yet
            while j >= 0:
                r = ranges[idx[j]]
                if r["ts"] <= launch["ts"] <= r["ts"] + r.get("dur", 0):
                    owner = idx[j]
                    break
                j -= 1
        if owner is None:
            out["outside"] += 1
            continue
        attrs = recs[owner]["attrs"] if owner < len(recs) else {}
        if (attrs.get("format"), attrs.get("epilogue")) == ids:
            out["attributed"] += 1
        else:
            out["mismatched"] += 1
            if len(out["examples"]) < 10:
                out["examples"].append({"kernel": e.get("name", "")[:120],
                                        "span": {k: attrs.get(k) for k in
                                                 ("format", "epilogue",
                                                  "plan", "blocks")}})
    return out
