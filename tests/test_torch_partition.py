"""The block partition and the mixed-codec index against the reference:
``choose_partition`` picks the same bounds and codec, ``encode_partitioned``
and ``build_index(format="auto" | "streamvbyte" | "binpack")`` give
identical bytes, skip tables, ``max_impact`` and bits/int, and every query
mode over an ``auto`` and a ``streamvbyte`` index gives identical results
and ``QueryStats`` — including MaxScore's pruned accounting, which on the
``auto`` index's variable-count blocks is where a wrong skip table would
show."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from functools import partial

import numpy as np
import pytest

import jax  # noqa: F401  (the reference runs on the CPU backend)

from repro.index import QueryStats as RStats
from repro.index import build_index as r_build
from repro.index import partition as Rpart
from repro.index import topk as r_topk
from repro.launch.serve import SearchEngine as RSearchEngine
from repro_torch.convert import index_from_numpy
from repro_torch.index import QueryStats as TStats
from repro_torch.index import build_index as t_build
from repro_torch.index import partition as Tpart
from repro_torch.index import topk as t_topk
from repro_torch.launch.serve import SearchEngine, search_queries

from test_torch_index_query import (TERM_SETS, assert_same_index,
                                    assert_stats_equal, make_lists, make_tfs,
                                    run_all)

B = 32
U = 100_000


def _gap_lists(rng):
    """Lists whose partitions pick each codec: random docids and a dense
    run with outliers (binpack), mixed power-of-two gaps (vbyte), gaps
    alternating below 2^7 and above 2^14 (streamvbyte)."""
    lists = make_lists(rng, (45, 300, 701, 1150, 37))
    g = rng.integers(1, 9, 900)
    g[rng.random(900) < 0.02] += 40_000
    lists[5] = np.cumsum(g).astype(np.uint32)
    g = 2 ** rng.integers(0, 17, 600) + rng.integers(0, 7, 600)
    lists[6] = np.cumsum(g).astype(np.uint32)
    g = np.where(np.arange(600) % 2 == 0, rng.integers(1, 100, 600),
                 rng.integers(20_000, 65_000, 600))
    lists[7] = np.cumsum(g).astype(np.uint32)
    return lists


@pytest.fixture(scope="module")
def auto_indexes():
    rng = np.random.default_rng(40)
    lists = _gap_lists(rng)
    tfs = make_tfs(rng, lists)
    n_docs = int(max(v.max() for v in lists.values())) + 1
    out = {"lists": lists, "tfs": tfs}
    for fmt in ("auto", "streamvbyte", "binpack"):
        ri = r_build(lists, tfs=tfs, format=fmt, block_size=B, n_docs=n_docs)
        ti = t_build(lists, tfs=tfs, format=fmt, block_size=B, n_docs=n_docs,
                     device="cpu")
        out[fmt] = (ri, ti)
    return out


def test_choose_partition_same_bounds_and_codec():
    """The seeded lists of test_format_parity.py's partition test, one per
    candidate-format set, plus dense and skewed lists and the empty one."""
    for seed in range(4):
        rng = np.random.default_rng(seed)
        gaps = rng.integers(1, 9, 4000).astype(np.uint64)
        gaps[rng.random(4000) < 0.01] += 500_000
        vals = np.cumsum(gaps).astype(np.uint64)
        for formats in (Tpart.PARTITION_FORMATS, ("vbyte",),
                        ("streamvbyte",), ("binpack",)):
            for bs in (32, 128):
                r = Rpart.choose_partition(vals, block_size=bs,
                                           formats=formats)
                t = Tpart.choose_partition(vals, block_size=bs,
                                           formats=formats)
                np.testing.assert_array_equal(r.bounds, t.bounds)
                assert (r.format, r.payload_bits, r.cost) == \
                    (t.format, t.payload_bits, t.cost), (seed, formats, bs)
    for vals in (np.zeros(0, np.uint64), np.array([7], np.uint64)):
        r, t = Rpart.choose_partition(vals), Tpart.choose_partition(vals)
        np.testing.assert_array_equal(r.bounds, t.bounds)
        assert (r.format, r.cost) == (t.format, t.cost)


@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
@pytest.mark.parametrize("differential", [False, True])
def test_encode_partitioned_identical(fmt, differential):
    rng = np.random.default_rng(41)
    vals = np.cumsum(rng.integers(1, 3000, 700)).astype(np.uint64)
    if not differential:
        rng.shuffle(vals)
    bounds = Rpart.choose_partition(np.sort(vals), block_size=B).bounds
    r = Rpart.encode_partitioned(vals, bounds, format=fmt, block_size=B,
                                 differential=differential, checksum=True)
    t = Tpart.encode_partitioned(vals, bounds, format=fmt, block_size=B,
                                 differential=differential, checksum=True,
                                 device="cpu")
    assert (t.format, t.n, t.n_blocks) == (r.format, r.n, r.n_blocks)
    for name, leaf in t.leaves_numpy().items():
        np.testing.assert_array_equal(leaf, np.asarray(getattr(r, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t.checksums, np.asarray(r.checksums))
    assert t.bits_per_int == r.bits_per_int
    np.testing.assert_array_equal(t.decode(), vals.astype(np.uint32))
    np.testing.assert_array_equal(t.decode(plan="cuda"), r.decode(plan="jnp"))
    with pytest.raises(ValueError, match="exceeds block_size"):
        Tpart.encode_partitioned(vals, [0, 700], format=fmt, block_size=B,
                                 device="cpu")


@pytest.mark.parametrize("fmt", ["auto", "streamvbyte", "binpack"])
def test_build_index_identical(auto_indexes, fmt):
    ri, ti = auto_indexes[fmt]
    assert_same_index(ri, ti)
    if fmt == "auto":
        # the partition mixes codecs per term and cuts variable-count blocks
        assert {tp.arr.format for tp in ti.terms.values()} == {
            "vbyte", "streamvbyte", "binpack"}
        counts = np.concatenate([tp.arr.counts_host
                                 for tp in ti.terms.values()])
        assert len(np.unique(counts)) > 3


def test_build_index_auto_in_worker_processes(auto_indexes):
    """``build_index(format="auto")`` over shards of the terms, each in a
    spawned process, gives every term the reference's streams: a term's
    partition, codec and impacts depend only on its own list and
    ``n_docs``, so a large build can spread its per-list DPs over
    processes (as ``chip_smoke.py`` does)."""
    ri, _ = auto_indexes["auto"]
    lists, tfs = auto_indexes["lists"], auto_indexes["tfs"]
    build = partial(t_build, format="auto", block_size=B, n_docs=ri.n_docs,
                    device="cpu")
    shards = [(0, 5), (6, 7)]
    with ProcessPoolExecutor(max_workers=2,
                             mp_context=mp.get_context("spawn")) as pool:
        built = [f.result() for f in [
            pool.submit(build, {t: lists[t] for t in s},
                        tfs={t: tfs[t] for t in s}) for s in shards]]
    terms = {t: tp for ti in built for t, tp in ti.terms.items()}
    assert sorted(terms) == [0, 5, 6, 7]
    for t, tp in terms.items():
        rp = ri.terms[t]
        assert (tp.arr.format, tp.impacts.format) == (rp.arr.format,
                                                      rp.impacts.format)
        for mine, ref in ((tp.arr, rp.arr), (tp.impacts, rp.impacts)):
            for name, leaf in mine.leaves_numpy().items():
                np.testing.assert_array_equal(
                    leaf, np.asarray(getattr(ref, name)), err_msg=name)
        np.testing.assert_array_equal(tp.first_doc, rp.first_doc)
        np.testing.assert_array_equal(tp.last_doc, rp.last_doc)
        np.testing.assert_array_equal(tp.max_impact, rp.max_impact)


@pytest.mark.parametrize("plan", ["torch", "cuda", "unfused"])
@pytest.mark.parametrize("fmt", ["auto", "streamvbyte"])
def test_queries_match_reference(auto_indexes, fmt, plan):
    ri, ti = auto_indexes[fmt]
    for terms in TERM_SETS + ([5, 6, 7], [7, 1, 6]):
        run_all(ri, ti, terms, plan=plan)
    for terms in ([0, 3, 5], [5, 6, 7, 2]):
        run_all(ri, ti, terms, k=3, probe_width=64,
                modes=("topk-maxscore", "topk-driver", "and"))


@pytest.mark.parametrize("fmt", ["auto", "streamvbyte"])
def test_maxscore_pruned_accounting(auto_indexes, fmt):
    """Per term, decoded + pruned blocks partition the term's blocks, and
    the index-wide sums agree — on variable-count blocks too."""
    ri, ti = auto_indexes[fmt]
    for terms in ([0, 1, 2], [5, 6, 7], [4, 3, 5, 7]):
        st = TStats()
        ids, scores = t_topk(ti, terms, 10, mode="maxscore", plan="cuda",
                             probe_width=64, stats=st)
        oids, oscores = t_topk(ti, terms, 10, mode="or", plan="torch")
        np.testing.assert_array_equal(ids, oids)
        np.testing.assert_array_equal(scores, oscores)
        total = 0
        for t in dict.fromkeys(terms):
            tp = ti.terms[t]
            got = len(st.per_term_blocks.get(t, ()))
            assert st.per_term_pruned.get(t, 0) + got == tp.n_blocks
            total += tp.n_blocks
        uniq = sum(len(s) for s in st.per_term_blocks.values())
        assert st.blocks_pruned + uniq == total
        rs = RStats()  # the reference's pruned counts are the same
        r_topk(ri, terms, 10, mode="maxscore", plan="jnp", probe_width=64,
               stats=rs)
        assert_stats_equal(rs, st, f"{fmt} {terms}")


def test_search_engine_workload_on_auto_index(auto_indexes):
    """``SearchEngine.run_workload`` over the ``auto`` index: the
    reference engine's accounting, and per-query results and stats."""
    ri, ti = auto_indexes["auto"]
    qs = search_queries(np.random.default_rng(42), ti, 20)
    r_eng = RSearchEngine(ri, top_k=10, plan="jnp")
    t_eng = SearchEngine(ti, top_k=10, device="cpu")
    record = []
    r_stats, t_stats = r_eng.run_workload(qs), t_eng.run_workload(
        qs, record=record)
    for key in ("n_results", "blocks_decoded", "block_skip_rate",
                "pruned_block_rate", "probes_pruned", "rows_gathered",
                "ints_decoded", "impact_ints_decoded", "index"):
        assert r_stats[key] == t_stats[key], key
    assert len(record) == len(qs)
    for (mode, terms), (out, st, seconds) in zip(qs, record):
        assert seconds > 0
        rs = RStats()
        ref = r_eng.search(terms, mode, stats=rs)
        for a, b in zip(ref if isinstance(ref, tuple) else (ref,),
                        out if isinstance(out, tuple) else (out,)):
            np.testing.assert_array_equal(a, b, err_msg=f"{mode} {terms}")
        assert_stats_equal(rs, st, f"{mode} {terms}")


def test_convert_auto_index(auto_indexes):
    """A reference ``auto`` index handed over as numpy, each stream naming
    its own codec, serves identically."""
    ri, ti = auto_indexes["auto"]

    def stream(a):
        return {**{k: np.asarray(v) for k, v in a.device_operands().items()},
                "n": a.n, "payload_bytes": a.enc.payload_bytes,
                "format": a.format}

    terms = {t: {"df": tp.df, "first_doc": tp.first_doc,
                 "last_doc": tp.last_doc, "max_impact": tp.max_impact,
                 "arr": stream(tp.arr), "impacts": stream(tp.impacts)}
             for t, tp in ri.terms.items()}
    ci = index_from_numpy(terms, n_docs=ri.n_docs, block_size=ri.block_size,
                          format=ri.format, impact_bits=ri.impact_bits,
                          has_tf=ri.has_tf, device="cpu")
    assert_same_index(ri, ci)
    assert ci.stats() == ti.stats()
    for terms_ in ([5, 6, 7], [0, 1, 2]):
        run_all(ri, ci, terms_, plan="cuda")
