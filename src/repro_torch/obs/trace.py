"""Per-request trace spans + the module-level telemetry switch.

A request produces one *span tree*: a root span (``request``) whose
descendants are the pipeline stages (admission → validate → plan-resolve →
decode dispatch → kernel/epilogue → skip-gallop/merge → score → top-k).
Spans carry structured attributes — format, plan label, chunk width, blocks
decoded/skipped/pruned, epilogue name — set at open time or via
``span.set(...)`` as counts become known.

**Null fast path.** The hot decode/serving code calls :func:`trace` and the
``counter_inc``/``gauge_set``/``histogram_observe`` helpers unconditionally.
With nothing installed these cost one module-global read and a ``None``
check; :func:`trace` returns the shared :data:`NULL_SPAN` singleton, so the
clean path allocates no span objects and stays bit-exact. Everything
activates only under :func:`install`, which flips the single module global::

    tele = Telemetry()
    with install(tele):
        engine.search(...)
    tele.tracer.write_chrome_trace("trace.json")

Spans can optionally mirror into ``torch.profiler.record_function`` so the
same stage names show up as ranges in a ``torch.profiler`` trace, each
CUDA kernel launch under the ``decode`` range that issued it
(``Telemetry(torch_annotations=True)``; the reference's
``jax_annotations``).

No span synchronises the card: a span times the host, as the reference's
does under JAX's asynchronous dispatch. Attributes that need host values
are computed by the call sites only under ``if span:``.

The port's copy of ``repro/obs/trace.py``: the same records, so a span
tree captured in either package compares field by field.
"""
from __future__ import annotations

import itertools
import threading
import time

from .metrics import Counter, Gauge, Histogram, MetricsRegistry


class _NullSpan:
    """Shared no-op recorder: every method returns cheaply, ``set``/``event``
    drop their arguments, and re-entering the same singleton is safe."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def event(self, name, **attrs):
        return self

    def __bool__(self):  # `if span:` guards expensive attribute computation
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One timed stage. Context manager; closing pops it off the thread's
    stack and hands the tracer its record as a tuple (see
    :meth:`Tracer.spans`), so the tracer keeps no span object alive."""

    __slots__ = ("tracer", "name", "attrs", "count", "span_id",
                 "parent_id", "trace_id", "t0", "_stack")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 count=None):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.count = count  # (counter, label attrs, ...): counted_trace

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs):
        """Zero-duration marker inside this span (e.g. a crash point hit)."""
        self.tracer._record_event(self, name, attrs)
        return self

    # truthy as every object is (``if span:`` costs no call); only
    # NULL_SPAN is falsy

    def __enter__(self):
        # open/close are inlined here (not Tracer methods): spans are the
        # instrumented hot path and every avoided step shows up in the
        # serving overhead gate
        tr = self.tracer
        try:
            st = tr._tls.stack
        except AttributeError:
            st = tr._tls.stack = []
        self._stack = st
        sid = self.span_id = next(tr._ids)
        if st:
            top = st[-1]
            self.parent_id = top.span_id
            self.trace_id = top.trace_id
        else:
            self.parent_id = None
            self.trace_id = sid  # root: trace keyed by its own id
        st.append(self)
        self.t0 = tr.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self.tracer
        t0 = self.t0
        dur = tr.clock() - t0
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        st = self._stack
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # unwound out of order (exception paths): drop tail
            del st[st.index(self):]
        # list.append is atomic under the GIL, so the close path takes no
        # lock. The record dict is built when the tracer's records are
        # read; until then a tuple stands for it, and the span object is
        # freed as its block ends (a capture holds one small object per
        # span for the garbage collector to walk, not a span with a stack)
        tr._log.append((self.name, t0, dur, self.span_id, self.parent_id,
                        self.trace_id, self.attrs, self.count))
        return False


class _AnnotatedSpan(Span):
    """A span mirrored into ``torch.profiler.record_function(name)``: the
    range opens before the span's clock starts and closes after it
    stops, so each kernel launched inside lies under the range."""

    __slots__ = ("_ann",)

    def __enter__(self):
        from torch.profiler import record_function

        self._ann = record_function(self.name)
        self._ann.__enter__()
        return Span.__enter__(self)

    def __exit__(self, exc_type, exc, tb):
        Span.__exit__(self, exc_type, exc, tb)
        self._ann.__exit__(exc_type, exc, tb)
        self._ann = None
        return False


def _span_record(r: tuple) -> dict:
    name, ts, dur, span_id, parent_id, trace_id, attrs, _ = r
    return {"type": "span", "name": name, "ts": ts, "dur": dur,
            "span_id": span_id, "parent_id": parent_id,
            "trace_id": trace_id, "attrs": attrs}


class Tracer:
    """Collects finished spans as plain dict records (JSON-ready).

    Parentage comes from a thread-local open-span stack: a span opened while
    another is open on the same thread becomes its child; a span opened on
    an empty stack roots a new trace (one per request). Finished spans
    append without a lock, so concurrent request threads can share one
    tracer; :attr:`spans` turns them into records, in order, when read.
    """

    def __init__(self, *, clock=None, torch_annotations: bool = False):
        self.clock = clock or time.perf_counter
        self.torch_annotations = torch_annotations
        self._log: list = []  # finished spans (tuples) and events, in order
        self._records: list[dict] = []  # _log's prefix as dict records
        self._counted = 0  # _log's prefix added to counters (counted_trace)
        self._lock = threading.RLock()
        self._tls = threading.local()
        # itertools.count: thread-safe id allocation without taking a lock
        # on the span-open hot path
        self._ids = itertools.count(1)

    @property
    def spans(self) -> list[dict]:
        """Every finished span and event as a JSON-ready record, in the
        order they closed (the reference's records)."""
        with self._lock:
            log, out = self._log, self._records
            n = len(log)
            out.extend(r if type(r) is dict else _span_record(r)
                       for r in log[len(out):n])
            return out

    @property
    def torch_annotations(self) -> bool:
        return self._span is _AnnotatedSpan

    @torch_annotations.setter
    def torch_annotations(self, on: bool):
        self._span = _AnnotatedSpan if on else Span  # the class trace() opens

    def span(self, name: str, **attrs) -> Span:
        return self._span(self, name, attrs)

    # -- span lifecycle ------------------------------------------------------
    def _record_event(self, span: Span, name: str, attrs: dict):
        # a span not yet opened has no ids: 0 names it
        self._log.append(
            {"type": "event", "name": name, "ts": self.clock(),
             "span_id": getattr(span, "span_id", 0),
             "trace_id": getattr(span, "trace_id", 0), "attrs": attrs})

    def _count_into(self, registry: MetricsRegistry):
        """Add the :func:`counted_trace` spans closed since the last call to
        ``registry``'s counters, one increment each."""
        with self._lock:
            log, start = self._log, self._counted
            end = self._counted = len(log)
        for r in log[start:end]:
            if type(r) is tuple and r[7] is not None:
                (counter, labels, *more), attrs = r[7], r[6]
                registry._get(Counter, counter,
                              {k: attrs[k] for k in labels}).inc(1)
                for name, fixed in more:
                    registry._get(Counter, name, fixed).inc(1)

    def current(self) -> Span | _NullSpan:
        st = getattr(self._tls, "stack", None)
        return st[-1] if st else NULL_SPAN

    # -- queries -------------------------------------------------------------
    def durations(self, name: str) -> list[float]:
        """Durations (seconds) of every finished span with this name."""
        with self._lock:
            return [s["dur"] for s in self.spans
                    if s["type"] == "span" and s["name"] == name]

    def trees(self) -> dict[int, list[dict]]:
        """Finished spans grouped per trace (one entry per request)."""
        out: dict[int, list[dict]] = {}
        with self._lock:
            for s in self.spans:
                if s["type"] == "span":
                    out.setdefault(s["trace_id"], []).append(s)
        return out

    # -- export --------------------------------------------------------------
    def write_jsonl(self, path):
        from .exporters import write_jsonl

        write_jsonl(self, path)

    def write_chrome_trace(self, path):
        from .exporters import write_chrome_trace

        write_chrome_trace(self, path)


class Telemetry:
    """Registry + tracer bundle sharing one clock — the unit of install.
    The registry takes the counts of :func:`counted_trace`'s spans from
    the tracer whenever it is read."""

    def __init__(self, *, clock=None, torch_annotations: bool = False):
        self.registry = MetricsRegistry(clock=clock)
        self.tracer = Tracer(clock=clock,
                             torch_annotations=torch_annotations)
        self.registry._sources.append(self.tracer._count_into)


# ---------------------------------------------------------------------------
# the module-level switch: one global, read on every instrumentation site
# ---------------------------------------------------------------------------
_ACTIVE: Telemetry | None = None


class _Installed:
    """Handle returned by :func:`install`: usable as a context manager that
    restores whatever was installed before (supports nesting in tests)."""

    __slots__ = ("_prev",)

    def __init__(self, prev):
        self._prev = prev

    def __enter__(self):
        return _ACTIVE

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def install(tele: Telemetry) -> _Installed:
    """Activate telemetry. Plain-call (`install(t)` … `uninstall()`) or
    ``with install(t):`` both work; the ``with`` form restores the previous
    telemetry on exit."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tele
    return _Installed(prev)


def uninstall():
    global _ACTIVE
    _ACTIVE = None


def installed() -> Telemetry | None:
    return _ACTIVE


_new = object.__new__


def trace(name: str, **attrs):
    """Open a stage span — or return :data:`NULL_SPAN` when telemetry is off.

    The off path is the contract: no allocation, no branching beyond one
    global read, identical control flow for the instrumented code.
    """
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    tr = t.tracer
    s = _new(tr._span)  # Span.__init__'s work without its call
    s.tracer = tr
    s.name = name
    s.attrs = attrs
    s.count = None
    return s


def counted_trace(name: str, count: tuple[str, tuple[str, ...]], **attrs):
    """:func:`trace`, for a span that is also one increment of a counter on
    every call: ``count`` is ``(counter, label attribute names, *more)``,
    each of ``more`` a ``(counter, labels dict)`` pair counted with fixed
    labels. The span is the call's one record; its counters (the first
    labelled by those of the span's attributes) are added to the registry
    when the registry is read (snapshot, exposition, merge, lookup): the
    same counts as ``counter_inc`` calls beside the span, for one site
    instead of several (``dispatch.decode``: ``decode_calls_total`` by
    plan, format and epilogue, and with ``plan="auto"`` the cache's
    ``plan_cache_total{result}``)."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    tr = t.tracer
    s = _new(tr._span)
    s.tracer = tr
    s.name = name
    s.attrs = attrs
    s.count = count
    return s


def current():
    """The innermost open span on this thread (NULL_SPAN when off/idle)."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.tracer.current()


# the helpers below reach the registry's lookup directly: one call, the
# labels dict passed as it is (they are the instrumented hot path); a
# counter already touched is bumped in place, without a call
def counter_inc(name: str, n=1, **labels):
    t = _ACTIVE
    if t is not None:
        reg = t.registry
        m = reg._fast.get((Counter, name, *labels.items()))
        if m is None:
            m = reg._get(Counter, name, labels)
        m.value += n


def gauge_set(name: str, v, **labels):
    t = _ACTIVE
    if t is not None:
        t.registry._get(Gauge, name, labels).set(v)


def histogram_observe(name: str, v, **labels):
    t = _ACTIVE
    if t is not None:
        t.registry._get(Histogram, name, labels).observe(v)
