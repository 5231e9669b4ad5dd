"""Unified telemetry: metrics registry, per-request trace spans, exporters.

The port of ``repro/obs`` (standard library only, like the reference's):

* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges and
  log2-bucketed histograms; mergeable and clock-injectable.
* :class:`~repro_torch.obs.trace.Span` / :func:`~repro_torch.obs.trace.trace`
  — context-manager spans forming one tree per request (admission →
  execute → gallop/merge/score → decode → top-k), each with structured
  attributes (format, plan label, chunk width, blocks decoded, epilogue).
  ``Telemetry(torch_annotations=True)`` mirrors every span into
  ``torch.profiler.record_function``, so a profiler trace shows each CUDA
  kernel launch under its ``decode`` range.
* exporters (:mod:`repro_torch.obs.exporters`) — JSONL span log,
  Prometheus text, Chrome/Perfetto trace — and the
  ``python -m repro_torch.obs.report`` CLI over a JSONL capture.

Nothing is recorded by default: every instrumentation site costs one
global read and a ``None`` check until :func:`install`::

    from repro_torch import obs

    tele = obs.Telemetry()
    with obs.install(tele):
        engine.run_workload(qs)
    print(tele.registry.to_prometheus())
    tele.tracer.write_chrome_trace("trace.json")
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
from .stats import latency_summary, percentile  # noqa: F401
from .trace import (  # noqa: F401
    NULL_SPAN,
    Span,
    Telemetry,
    Tracer,
    counter_inc,
    current,
    gauge_set,
    histogram_observe,
    install,
    installed,
    trace,
    uninstall,
)
