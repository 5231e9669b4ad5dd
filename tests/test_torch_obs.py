"""The port's telemetry against the reference's, on the CPU.

Every case of the reference's ``tests/test_obs.py`` runs against
``repro_torch.obs``; then the two packages are driven by the same calls
under the same injected clock and their exports compared byte for byte
(Prometheus text, JSONL span log, Chrome trace), histograms compared
bucket for bucket across shard orders, the span trees of every query mode
compared record for record on the same index (the reference with
``plan="jnp"``, the port on its plain ``plan="torch"``; the plan label
maps ``jnp_*`` to ``torch_*``), and the port's report CLI held to the
reference's on a reference capture. No test here asserts a wall-clock
overhead: the timing gates run on the card (``chip_smoke.py``).
"""
import dataclasses
import json

import numpy as np
import pytest

import jax  # noqa: F401  (the reference runs on the CPU backend)

from torch_parity import CPU

from repro import obs as robs
from repro.index import build_index as r_build
from repro.launch.serve import SearchEngine as RSearchEngine
from repro.obs import report as rreport
from repro_torch import obs
from repro_torch.index import build_index as t_build
from repro_torch.launch.serve import SearchEngine as TSearchEngine
from repro_torch.obs import report as treport
from repro_torch.obs.exporters import (parse_prometheus, read_chrome_trace,
                                       read_jsonl)

SEARCH_MODES = ("and", "or", "topk", "topk_driver", "topk_maxscore")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Every test starts and ends with no telemetry installed, in either
    package."""
    obs.uninstall()
    robs.uninstall()
    yield
    obs.uninstall()
    robs.uninstall()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# null fast path
# ---------------------------------------------------------------------------
def test_null_recorder_is_identity_singleton():
    s1 = obs.trace("decode", format="vbyte")
    s2 = obs.trace("anything")
    assert s1 is obs.NULL_SPAN and s2 is obs.NULL_SPAN  # no allocation
    assert not s1  # falsy: `if span:` guards attr computation
    with s1 as sp:
        sp.set(a=1).event("x", b=2)  # all no-ops, chainable, re-entrant
    assert obs.current() is obs.NULL_SPAN
    obs.counter_inc("c", 5, lbl="x")
    obs.gauge_set("g", 3)
    obs.histogram_observe("h", 0.5)
    assert obs.installed() is None


def test_install_uninstall_and_nesting():
    t1, t2 = obs.Telemetry(), obs.Telemetry()
    with obs.install(t1):
        assert obs.installed() is t1
        with obs.install(t2):
            assert obs.installed() is t2
            with obs.trace("inner"):
                pass
        assert obs.installed() is t1
        with obs.trace("outer"):
            pass
    assert obs.installed() is None
    assert [s["name"] for s in t1.tracer.spans] == ["outer"]
    assert [s["name"] for s in t2.tracer.spans] == ["inner"]


def test_null_path_allocates_no_span_records():
    tele = obs.Telemetry()
    with obs.install(tele):
        with obs.trace("on"):
            pass
    before = len(tele.tracer.spans)
    for _ in range(100):
        with obs.trace("off"):
            obs.counter_inc("c")
    assert len(tele.tracer.spans) == before == 1
    assert not tele.registry.snapshot()["metrics"]


def test_port_obs_exports_every_reference_name():
    names = [n for n in dir(robs) if not n.startswith("_")
             and not isinstance(getattr(robs, n), type(robs))]
    assert names and all(hasattr(obs, n) for n in names), names


# ---------------------------------------------------------------------------
# metrics algebra
# ---------------------------------------------------------------------------
def test_histogram_buckets_exact_boundaries():
    from repro.obs.metrics import bucket_exp as r_bucket_exp
    from repro_torch.obs.metrics import MIN_EXP, bucket_exp

    assert bucket_exp(0.25) == -2
    assert bucket_exp(8) == 3
    assert bucket_exp(8.0001) == 4
    assert bucket_exp(9) == 4
    assert bucket_exp(0) == MIN_EXP
    assert bucket_exp(-5) == MIN_EXP
    vals = [2.0 ** e for e in range(-45, 70)]
    vals += [np.nextafter(v, np.inf) for v in vals]
    vals += list(np.random.default_rng(3).exponential(1.0, 500))
    assert [bucket_exp(float(v)) for v in vals] == \
        [r_bucket_exp(float(v)) for v in vals]


def test_injected_clock_pins_exact_histogram_buckets():
    now = [0.0]
    reg = obs.MetricsRegistry(clock=lambda: now[0])
    for dt in (0.25, 0.25, 0.1, 3.0):
        with reg.timer("stage_seconds"):
            now[0] += dt
    snap = reg.snapshot()["metrics"]["stage_seconds"]
    assert snap["buckets"] == {"-3": 1, "-2": 2, "2": 1}
    assert snap["count"] == 4 and snap["max"] == 3.0
    assert snap["min"] == pytest.approx(0.1)
    assert reg.histogram("stage_seconds").quantile(0.5) == 0.25


@pytest.mark.parametrize("order,grouping", [([0, 1, 2, 3], "left"),
                                            ([3, 1, 0, 2], "left"),
                                            ([2, 0, 3, 1], "pairs")])
def test_histogram_merge_associative_and_same_as_reference(rng, order,
                                                           grouping):
    """Folding per-shard histograms gives one aggregate regardless of merge
    order/grouping — and the reference's aggregate, bucket for bucket."""
    from repro.obs.metrics import Histogram as RHist
    from repro_torch.obs.metrics import Histogram as THist

    shard_samples = [rng.exponential(0.01, size=50) for _ in range(4)]

    def fold(cls, order, grouping):
        hs = []
        for i in order:
            h = cls()
            for v in shard_samples[i]:
                h.observe(float(v))
            hs.append(h)
        if grouping == "left":
            acc = hs[0]
            for h in hs[1:]:
                acc.merge(h)
        else:
            hs[0].merge(hs[1])
            hs[2].merge(hs[3])
            hs[0].merge(hs[2])
            acc = hs[0]
        return acc.snapshot()

    got = fold(THist, order, grouping)
    assert got == fold(THist, [0, 1, 2, 3], "left")
    assert got == fold(RHist, order, grouping)
    assert got["count"] == 200


def test_registry_merge_counters_gauges_events():
    a, b = obs.MetricsRegistry(), obs.MetricsRegistry()
    a.counter("reqs", engine="search").inc(3)
    b.counter("reqs", engine="search").inc(4)
    b.counter("reqs", engine="live").inc(1)
    a.gauge("epoch").set(1)
    b.gauge("epoch").set(7)
    a.record_event("recovery", replayed=2)
    b.record_event("recovery", replayed=5)
    a.merge(b)
    m = a.snapshot()
    assert m["metrics"]["reqs{engine=search}"]["value"] == 7
    assert m["metrics"]["reqs{engine=live}"]["value"] == 1
    assert m["metrics"]["epoch"]["value"] == 7
    assert [e["replayed"] for e in m["events"]] == [2, 5]


def test_metric_kind_conflict_raises():
    reg = obs.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x")


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def test_prometheus_exposition_parses():
    reg = obs.MetricsRegistry()
    reg.counter("decode_calls_total", plan="fused", format="vbyte").inc(9)
    reg.gauge("delta_docs").set(4)
    reg.histogram("wal_append_seconds", fsync=True).observe(0.25)
    parsed = parse_prometheus(reg.to_prometheus())
    assert parsed['decode_calls_total{format="vbyte",plan="fused"}'] == 9.0
    assert parsed["delta_docs"] == 4.0
    assert parsed['wal_append_seconds_bucket{fsync="True",le="0.25"}'] == 1.0
    assert parsed['wal_append_seconds_bucket{fsync="True",le="+Inf"}'] == 1.0
    assert parsed['wal_append_seconds_count{fsync="True"}'] == 1.0


def test_chrome_trace_roundtrips_parent_child_nesting(tmp_path):
    now = [0.0]
    tele = obs.Telemetry(clock=lambda: now[0])
    with obs.install(tele):
        with obs.trace("request") as root:
            now[0] += 0.001
            with obs.trace("admission"):
                now[0] += 0.002
            with obs.trace("execute"):
                with obs.trace("decode", format="vbyte"):
                    now[0] += 0.004
            root.event("crash_point", phase="after_rotate")
    p = tmp_path / "trace.json"
    tele.tracer.write_chrome_trace(str(p))
    spans = {e["name"]: e for e in read_chrome_trace(str(p))
             if e["ph"] == "X"}
    assert set(spans) == {"request", "admission", "execute", "decode"}
    req = spans["request"]
    assert spans["admission"]["args"]["parent_id"] == req["args"]["span_id"]
    assert spans["execute"]["args"]["parent_id"] == req["args"]["span_id"]
    assert (spans["decode"]["args"]["parent_id"]
            == spans["execute"]["args"]["span_id"])
    assert spans["decode"]["args"]["format"] == "vbyte"
    assert req["dur"] == pytest.approx(7000.0)
    assert spans["decode"]["dur"] == pytest.approx(4000.0)
    assert len({e["tid"] for e in spans.values()}) == 1
    assert any(e["ph"] == "i" and e["name"] == "crash_point"
               for e in read_chrome_trace(str(p)))


def test_jsonl_roundtrip_and_trees(tmp_path):
    tele = obs.Telemetry()
    with obs.install(tele):
        for _ in range(3):
            with obs.trace("request"):
                with obs.trace("execute"):
                    pass
    p = tmp_path / "trace.jsonl"
    tele.tracer.write_jsonl(str(p))
    assert len(read_jsonl(str(p))) == 6
    trees = tele.tracer.trees()
    assert len(trees) == 3
    for tid, spans in trees.items():
        assert {s["name"] for s in spans} == {"request", "execute"}
        root = next(s for s in spans if s["parent_id"] is None)
        assert root["span_id"] == tid


def test_span_exception_tags_error_and_unwinds():
    tele = obs.Telemetry()
    with obs.install(tele):
        with pytest.raises(ValueError):
            with obs.trace("request"):
                with obs.trace("execute"):
                    raise ValueError("boom")
        with obs.trace("next"):
            pass
    by_name = {s["name"]: s for s in tele.tracer.spans}
    assert by_name["execute"]["attrs"]["error"] == "ValueError"
    assert by_name["request"]["attrs"]["error"] == "ValueError"
    assert by_name["next"]["parent_id"] is None


def _script(pkg, clock):
    """One fixed sequence of telemetry calls (spans, events, counters,
    gauges, histograms, a timer, a merged shard registry) under ``clock``,
    through package ``pkg``'s ``obs``."""
    tele = pkg.Telemetry(clock=clock)
    with pkg.install(tele):
        for q in range(3):
            with pkg.trace("request", mode="or", terms=2) as root:
                clock.step(0.0005)
                with pkg.trace("admission"):
                    clock.step(0.00125)
                with pkg.trace("execute", mode="or"):
                    for b in range(2):
                        pkg.counter_inc("decode_calls_total", plan="x_fused",
                                        format="vbyte", epilogue="stream")
                        with pkg.trace("decode", format="vbyte", plan="x",
                                       epilogue="stream", blocks=4 + b,
                                       chunk=None, sharded=False):
                            clock.step(0.003 * (q + 1))
                root.event("crash_point", phase="after_rotate", q=q)
                root.set(n_results=q * 7, degraded=bool(q % 2))
            pkg.histogram_observe("wal_append_seconds", 0.0001 * (q + 1),
                                  fsync=True)
            pkg.histogram_observe("wal_record_bytes", 37 + q)
        pkg.gauge_set("delta_docs", 11)
        with tele.registry.timer("ingest_merge_phase_seconds",
                                 phase="after_build"):
            clock.step(0.75)
        tele.registry.record_event("ingest_recovery", epoch=1,
                                   replayed_ops=3)
        shard = pkg.MetricsRegistry(clock=clock)
        shard.counter("serve_requests_total", engine="search",
                      mode="or").inc(5)
        shard.histogram("wal_record_bytes").observe(4096)
        tele.registry.merge(shard)
    return tele


class _StepClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def step(self, dt):
        self.t += dt


def test_exports_byte_identical_to_reference(tmp_path):
    """The same calls under the same clock export the same bytes."""
    r = _script(robs, _StepClock())
    t = _script(obs, _StepClock())
    assert t.registry.to_prometheus() == r.registry.to_prometheus()
    assert json.dumps(t.registry.snapshot(), sort_keys=True) == \
        json.dumps(r.registry.snapshot(), sort_keys=True)
    r.tracer.write_jsonl(str(tmp_path / "r.jsonl"))
    t.tracer.write_jsonl(str(tmp_path / "t.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "r.jsonl").read_bytes()
    r.tracer.write_chrome_trace(str(tmp_path / "r.json"))
    t.tracer.write_chrome_trace(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()
    # each package reads the other's capture
    from repro.obs.exporters import read_jsonl as r_read_jsonl
    assert read_jsonl(str(tmp_path / "r.jsonl")) == \
        r_read_jsonl(str(tmp_path / "t.jsonl"))


# ---------------------------------------------------------------------------
# shared percentile/latency helpers
# ---------------------------------------------------------------------------
def test_percentile_matches_numpy(rng):
    from repro_torch.obs.stats import latency_summary, percentile

    xs = rng.exponential(1.0, size=137).tolist()
    for q in (0, 13.7, 50, 90, 99, 100):
        assert percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), abs=1e-12)
    with pytest.raises(ValueError):
        percentile([], 50)
    s = latency_summary([0.001, 0.002, 0.004], 0.01, 3)
    assert s["qps"] == 300.0 and s["p50_ms"] == 2.0


# ---------------------------------------------------------------------------
# QueryStats merge-by-fields contract
# ---------------------------------------------------------------------------
def test_querystats_merge_new_field_fails_loudly():
    from repro_torch.index import QueryStats

    @dataclasses.dataclass
    class Extended(QueryStats):
        mystery: object = None

    a, b = Extended(), Extended()
    with pytest.raises(TypeError, match="mystery"):
        a.merge(b)


def test_querystats_merge_covers_every_current_field():
    from repro.index import QueryStats as RStats
    from repro_torch.index import QueryStats

    assert [f.name for f in dataclasses.fields(QueryStats)] == \
        [f.name for f in dataclasses.fields(RStats)]
    a, b = QueryStats(), QueryStats()
    a.blocks_decoded, b.blocks_decoded = 3, 4
    b.delta_postings, b.delta_hits, b.tombstones_applied = 5, 2, 1
    b.degraded = True
    b.degraded_reasons.append("deadline:gallop")
    a.merge(b)
    assert a.blocks_decoded == 7
    assert (a.delta_postings, a.delta_hits, a.tombstones_applied) == (5, 2, 1)
    assert a.degraded is True
    assert a.degraded_reasons == ["deadline:gallop"]
    a.merge(b)
    assert a.degraded_reasons == ["deadline:gallop"]
    assert a.span_attrs() == RStats(**{
        f.name: getattr(a, f.name)
        for f in dataclasses.fields(RStats)}).span_attrs()


# ---------------------------------------------------------------------------
# end-to-end wiring: query spans, decode attribution, bit-exactness
# ---------------------------------------------------------------------------
def _lists(rng, n_terms=6, universe=50_000):
    from repro_torch.data.synthetic import posting_tfs

    lists = {t: np.sort(rng.choice(universe, size=int(s), replace=False))
             .astype(np.uint32)
             for t, s in enumerate(rng.integers(200, 800, size=n_terms))}
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    return lists, tfs


@pytest.fixture(scope="module")
def indexes():
    lists, tfs = _lists(np.random.default_rng(0))
    kw = dict(tfs=tfs, block_size=32, n_docs=50_000)
    return r_build(lists, **kw), t_build(lists, device=CPU, **kw)


def test_maxscore_span_tree_sums_to_request_wall_time(indexes):
    """One span tree per maxscore query whose stage durations sum to the
    root's, decode spans attributed to (format, plan, epilogue)."""
    _, index = indexes
    engine = TSearchEngine(index, top_k=10, device=CPU)
    terms = [0, 2, 4]
    engine.search(terms, "topk_maxscore")

    tele = obs.Telemetry()
    with obs.install(tele):
        ids, scores = engine.search(terms, "topk_maxscore")
    off_ids, off_scores = engine.search(terms, "topk_maxscore")
    np.testing.assert_array_equal(ids, off_ids)
    np.testing.assert_array_equal(scores, off_scores)

    trees = tele.tracer.trees()
    assert len(trees) == 1
    spans = next(iter(trees.values()))
    root = next(s for s in spans if s["parent_id"] is None)
    assert root["name"] == "request"
    children = [s for s in spans if s["parent_id"] == root["span_id"]]
    assert {c["name"] for c in children} == {"admission", "execute",
                                            "finalize"}
    child_sum = sum(c["dur"] for c in children)
    assert child_sum <= root["dur"] + 1e-9
    assert child_sum >= 0.90 * root["dur"]
    decode_spans = [s for s in spans if s["name"] == "decode"]
    assert decode_spans
    for d in decode_spans:
        assert d["attrs"]["format"] == index.terms[0].arr.format
        assert d["attrs"]["plan"] == "torch_fused"
        assert "epilogue" in d["attrs"]
        assert d["attrs"]["blocks"] >= 1
    tk = next(s for s in spans if s["name"] == "topk")
    assert tk["attrs"]["mode"] == "maxscore"
    assert tk["attrs"]["blocks_decoded"] >= 1
    engine.search(terms, "topk_maxscore")
    assert len(tele.tracer.trees()) == 1


def test_topk_bit_identical_with_and_without_telemetry(indexes):
    from repro_torch.index import topk

    _, index = indexes
    cases = [([0, 1], "or"), ([0, 2, 4], "maxscore"), ([1, 3], "and"),
             ([2, 0, 5], "driver")]
    base = [topk(index, t, 10, mode=m) for t, m in cases]
    tele = obs.Telemetry(torch_annotations=True)
    with obs.install(tele):
        on = [topk(index, t, 10, mode=m) for t, m in cases]
    after = [topk(index, t, 10, mode=m) for t, m in cases]
    for (bi, bs), (oi, os_), (ai, as_) in zip(base, on, after):
        np.testing.assert_array_equal(bi, oi)
        np.testing.assert_array_equal(bs, os_)
        np.testing.assert_array_equal(bi, ai)
        np.testing.assert_array_equal(bs, as_)
    assert len(tele.tracer.trees()) == len(cases)


def _tree(tele, plan_from=None):
    """A capture's span and event records without their times, the plan
    label's path renamed (``jnp_`` → ``torch_``)."""
    out = []
    for rec in tele.tracer.spans:
        rec = {k: v for k, v in rec.items() if k not in ("ts", "dur")}
        attrs = dict(rec["attrs"])
        if plan_from and isinstance(attrs.get("plan"), str):
            attrs["plan"] = attrs["plan"].replace(plan_from, "torch_", 1)
        rec["attrs"] = attrs
        out.append(rec)
    return out


@pytest.mark.parametrize("mode", SEARCH_MODES)
def test_span_tree_equals_reference(indexes, mode):
    """Every query mode opens the reference's spans, in the reference's
    order and nesting, with the reference's attributes."""
    ri, ti = indexes
    reng = RSearchEngine(ri, top_k=10, plan="jnp")
    teng = TSearchEngine(ti, top_k=10, plan="torch", device=CPU)
    queries = [[0, 2, 4], [1], [3, 5], [0, 1, 2, 3, 4, 5]]
    r_tele, t_tele = robs.Telemetry(), obs.Telemetry()
    for terms in queries:
        with robs.install(r_tele):
            r_out = reng.search(terms, mode)
        with obs.install(t_tele):
            t_out = teng.search(terms, mode)
        for a, b in zip(r_out if isinstance(r_out, tuple) else (r_out,),
                        t_out if isinstance(t_out, tuple) else (t_out,)):
            np.testing.assert_array_equal(np.asarray(a), b)
    r_tree, t_tree = _tree(r_tele, "jnp_"), _tree(t_tele)
    assert [s["name"] for s in t_tree] == [s["name"] for s in r_tree]
    for r, t in zip(r_tree, t_tree):
        assert t == r, (r["name"], r, t)
    r_m = {k: v for k, v in r_tele.registry.snapshot()["metrics"].items()
           if not k.startswith("plan_cache_total")}
    t_m = t_tele.registry.snapshot()["metrics"]
    assert {k.replace("jnp_", "torch_"): v for k, v in r_m.items()} == t_m


def test_serve_counters_mirror_serve_stats(indexes):
    """SearchEngine keeps the serve_stats dict and mirrors increments into
    labeled registry counters. (The reference's ``plan_cache_total`` comes
    with the port's measured autotune cache.)"""
    _, index = indexes
    engine = TSearchEngine(index, top_k=5, device=CPU)
    tele = obs.Telemetry()
    with obs.install(tele):
        engine.search([0, 1], "or")
        engine.search([2], "topk")
        engine._bump("retries", 2)
    m = tele.registry.snapshot()["metrics"]
    assert m["serve_requests_total{engine=search,mode=or}"]["value"] == 1
    assert m["serve_requests_total{engine=search,mode=topk}"]["value"] == 1
    assert m["serve_retries_total{engine=search}"]["value"] == 2 == \
        engine.serve_stats["retries"]
    assert any(k.startswith("decode_calls_total") for k in m)


def test_serving_engine_microbatch_spans():
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.core import CompressedIntArray
    from repro_torch.models import recsys, registry

    cfg = registry.reduced_config("two-tower-retrieval")
    params = recsys.init_params(cfg, seed=0, device=CPU)
    rng = np.random.default_rng(0)
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items), 300,
                               replace=False)).astype(np.uint64)
    corpus = CompressedIntArray.encode(cands, differential=True, device=CPU)
    engine = ServingEngine(params, cfg, corpus, top_k=5, device=CPU)
    reqs = [(int(rng.integers(1, cfg.n_users)),
             rng.integers(1, cfg.n_items, cfg.seq_len).astype(np.int32))
            for _ in range(11)]
    tele = obs.Telemetry()
    with obs.install(tele):
        engine.run_workload(reqs)
    mbs = [s for s in tele.tracer.spans if s["name"] == "microbatch"]
    assert [s["attrs"]["requests"] for s in mbs] == [8, 3]
    assert [s["attrs"]["bucket"] for s in mbs] == [8, 4]
    m = tele.registry.snapshot()["metrics"]
    assert m["serve_requests_total{engine=serving}"]["value"] == 11
    assert all(any(d["parent_id"] == mb["span_id"] for d in tele.tracer.spans
                   if d["name"] == "decode") for mb in mbs)


def test_wal_and_recovery_metrics(tmp_path, rng):
    from repro_torch.index.ingest import LiveIndex

    tele = obs.Telemetry()
    with obs.install(tele):
        d = str(tmp_path / "live")
        li = LiveIndex(d, n_docs=1 << 12, device=CPU)
        for doc in range(40):
            li.add(doc, {int(t): 1 for t in rng.choice(8, 2, replace=False)})
        li.merge()
        li.close()
        li = LiveIndex(d, device=CPU)
        li.add(50, {0: 1})
        li.close()
        LiveIndex(d, device=CPU).close()
    snap = tele.registry.snapshot()
    m = snap["metrics"]
    assert m["wal_append_seconds{fsync=True}"]["count"] == 41
    assert m["wal_record_bytes"]["count"] == 41
    phases = [k for k in m if k.startswith("ingest_merge_phase_seconds")]
    assert len(phases) == 8
    assert m["ingest_merges_total"]["value"] == 1
    recov = [e for e in snap["events"] if e["event"] == "ingest_recovery"]
    assert len(recov) == 3
    assert recov[-1]["replayed_ops"] == 1


def test_metrics_out_writes_three_exports(tmp_path):
    from repro_torch.launch.serve import serve_search

    out = tmp_path / "m"
    stats = serve_search(queries=6, group_k=8, n_lists=4, device=CPU,
                         metrics_out=str(out))
    assert sorted(p.name for p in out.iterdir()) == [
        "metrics.prom", "trace-chrome.json", "trace.jsonl"]
    assert stats["observability"]["n_traces"] == 6
    assert "request" in stats["observability"]["stages"]
    parsed = parse_prometheus((out / "metrics.prom").read_text())
    assert sum(v for k, v in parsed.items()
               if k.startswith("serve_requests_total")) == 6
    assert len(read_jsonl(str(out / "trace.jsonl"))) == \
        len(read_chrome_trace(str(out / "trace-chrome.json")))


# ---------------------------------------------------------------------------
# report CLI
# ---------------------------------------------------------------------------
def _report_capture(pkg, path):
    now = [0.0]
    tele = pkg.Telemetry(clock=lambda: now[0])
    with pkg.install(tele):
        for term in (3, 5, 3):
            with pkg.trace("topk", term=term):
                with pkg.trace("decode", term=term, blocks_decoded=4,
                               ints_decoded=512, blocks=[0, term]):
                    now[0] += 0.004
                with pkg.trace("score", term=term):
                    now[0] += 0.001
    tele.tracer.write_jsonl(str(path))


def test_report_cli_renders_stage_table(tmp_path, capsys):
    p = tmp_path / "cap.jsonl"
    _report_capture(obs, p)
    assert treport.main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "decode" in out and "p50" in out
    assert "hottest" in out.lower()
    assert treport.main([str(tmp_path / "missing.jsonl")]) == 1


def test_report_cli_prints_the_reference_table(tmp_path, capsys):
    """The port's CLI renders a reference capture exactly as the
    reference's CLI does, and the reverse."""
    rp, tp = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    _report_capture(robs, rp)
    _report_capture(obs, tp)
    assert rp.read_bytes() == tp.read_bytes()
    for p in (rp, tp):
        assert rreport.main([str(p), "--top", "3"]) == 0
        ref_out = capsys.readouterr().out
        assert treport.main([str(p), "--top", "3"]) == 0
        assert capsys.readouterr().out == ref_out


# ---------------------------------------------------------------------------
# kernel attribution (the port's: profiler kernels under decode spans)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,ids", [
    ("void (anonymous namespace)::vbyte_decode_kernel<16>(unsigned char "
     "const*, int const*, int const*, int*, long long, int, int, int)",
     ("vbyte", "stream")),
    ("void (anonymous namespace)::stream_decode_kernel<8>(unsigned char "
     "const*)", ("streamvbyte", "stream")),
    ("void (anonymous namespace)::binpack_decode_kernel(unsigned char "
     "const*)", ("binpack", "stream")),
    ("void (anonymous namespace)::probe_kernel<0, 6>((anonymous namespace)"
     "::FusedParams, int, int, int)", ("vbyte", "bm25_weighted")),
    ("void (anonymous namespace)::fused_decode_kernel<2, 3, true>((anonymous"
     " namespace)::FusedParams, (anonymous namespace)::RowLayout)",
     ("binpack", "membership_rows")),
    ("void (anonymous namespace)::dot_kernel<1, 2>((anonymous namespace)::"
     "FusedParams, (anonymous namespace)::DotLayout)",
     ("streamvbyte", "dot_score")),
    ("void at::native::(anonymous namespace)::indexSelectSmallIndex<int, "
     "long, unsigned int, 1, 1, -2>(...)", None),
])
def test_kernel_ids_from_names(name, ids):
    from repro_torch.kernels.vbyte_decode import epilogues
    from repro_torch.obs.attribution import EPILOGUES, FORMATS, kernel_ids

    assert kernel_ids(name) == ids
    assert FORMATS == tuple(sorted(epilogues.FORMAT_IDS,
                                   key=epilogues.FORMAT_IDS.get))
    assert EPILOGUES == tuple(sorted(epilogues.EPILOGUES, key=lambda e:
                                     epilogues.EPILOGUES[e].cuda_id))


def test_attribute_kernels_on_a_synthetic_trace():
    """Two decode spans and their profiler ranges; kernels launched inside
    the first (matching), inside the second (another epilogue), outside
    both, and a PyTorch kernel."""
    from repro_torch.obs.attribution import attribute_kernels

    spans = [{"type": "span", "name": "decode", "ts": 1.0,
              "attrs": {"format": "vbyte", "epilogue": "stream"}},
             {"type": "span", "name": "decode", "ts": 2.0,
              "attrs": {"format": "vbyte", "epilogue": "membership"}},
             {"type": "span", "name": "request", "ts": 0.5, "attrs": {}}]
    rng = lambda ts, dur, name="decode": {  # noqa: E731
        "ph": "X", "cat": "user_annotation", "name": name, "tid": 1,
        "ts": ts, "dur": dur}
    launch = lambda ts, c: {"ph": "X", "cat": "cuda_runtime",  # noqa: E731
                            "name": "cudaLaunchKernel", "tid": 1, "ts": ts,
                            "dur": 1, "args": {"correlation": c}}
    kern = lambda name, c: {"ph": "X", "cat": "kernel",  # noqa: E731
                            "name": name, "tid": 7, "ts": 999,
                            "args": {"correlation": c}}
    events = [rng(0, 100, "request"), rng(10, 20), rng(40, 20),
              launch(15, 1), launch(45, 2), launch(80, 3), launch(50, 4),
              kern("void vbyte_decode_kernel<16>(int)", 1),
              kern("void probe_kernel<0, 4>(int)", 2),
              kern("void vbyte_decode_kernel<16>(int)", 3),
              kern("void at::native::fill_kernel(int)", 4)]
    got = attribute_kernels(events, spans)
    assert (got["kernels"], got["attributed"], got["mismatched"],
            got["outside"], got["other_kernels"]) == (3, 1, 1, 1, 1)
    assert got["ranges"] == got["spans"] == 2
    assert got["by_kernel"] == {"vbyte/stream": 2, "vbyte/bm25_accum": 1}
    assert got["examples"][0]["span"]["epilogue"] == "membership"
