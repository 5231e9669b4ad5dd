"""The port's index and query engine against the reference: identical index
bytes and ``stats()``, identical results and ``QueryStats`` for AND, OR and
top-k in modes or/and/driver/maxscore, and the ``convert.py`` round trip."""
import dataclasses

import numpy as np
import pytest

import jax  # noqa: F401  (the reference runs on the CPU backend)

from repro.index import QueryStats as RStats
from repro.index import build_index as r_build
from repro.index import conjunctive as r_and
from repro.index import disjunctive as r_or
from repro.index import topk as r_topk
from repro_torch.convert import index_from_numpy
from repro_torch.core.compressed_array import FORMAT_LEAVES
from repro_torch.index import QueryStats as TStats
from repro_torch.index import build_index as t_build
from repro_torch.index import conjunctive as t_and
from repro_torch.index import disjunctive as t_or
from repro_torch.index import topk as t_topk
from repro_torch.robustness import Deadline

B = 32
U = 100_000
TERM_SETS = ([1], [0, 3], [4, 1], [0, 1, 2], [0, 1, 2, 3, 4], [0, 0, 1, 99])
# the decode accounting both engines keep (the port drops the hardened
# mode's error/retry/quarantine and the live index's delta counters)
STAT_FIELDS = [f.name for f in dataclasses.fields(TStats)]


def make_lists(rng, sizes, universe=U):
    return {t: np.sort(rng.choice(universe, size=s, replace=False))
            .astype(np.uint32) for t, s in enumerate(sizes)}


def make_tfs(rng, lists):
    from repro.data.synthetic import posting_tfs

    return {t: posting_tfs(rng, len(v)) for t, v in lists.items()}


def assert_stats_equal(rs, ts, msg):
    for name in STAT_FIELDS:
        assert getattr(rs, name) == getattr(ts, name), f"{msg}: {name}"


def assert_same_index(ri, ti):
    assert ri.stats() == ti.stats()
    assert ri.bits_per_int == ti.bits_per_int
    assert (ri.n_docs, ri.block_size, ri.impact_bits, ri.has_tf) == \
        (ti.n_docs, ti.block_size, ti.impact_bits, ti.has_tf)
    assert sorted(ri.terms) == sorted(ti.terms)
    for t, rtp in ri.terms.items():
        ttp = ti.terms[t]
        assert rtp.df == ttp.df and rtp.ub == ttp.ub
        for name in ("first_doc", "last_doc", "max_impact"):
            np.testing.assert_array_equal(getattr(rtp, name),
                                          getattr(ttp, name))
        for rs, ts in ((rtp.arr, ttp.arr), (rtp.impacts, ttp.impacts)):
            assert rs.format == ts.format
            leaves = ts.leaves_numpy()
            assert sorted(leaves) == sorted(FORMAT_LEAVES[rs.format])
            for name, leaf in leaves.items():
                np.testing.assert_array_equal(np.asarray(getattr(rs, name)),
                                              leaf, err_msg=name)
            assert (rs.n, rs.differential) == (ts.n, ts.differential)
            assert rs.bits_per_int == ts.bits_per_int


def run_all(r_index, t_index, terms, *, k=10, plan="torch", rplan="jnp",
            modes=("and", "or", "topk-or", "topk-and", "topk-driver",
                   "topk-maxscore"), **kw):
    """Every query mode on both engines: identical results and stats."""
    for mode in modes:
        rs, ts = RStats(), TStats()
        if mode == "and":
            r = r_and(r_index, terms, plan=rplan, stats=rs, **kw)
            t = t_and(t_index, terms, plan=plan, stats=ts, **kw)
        elif mode == "or":
            kw2 = {k_: v for k_, v in kw.items() if k_ != "probe_width"}
            r = r_or(r_index, terms, plan=rplan, stats=rs, **kw2)
            t = t_or(t_index, terms, plan=plan, stats=ts, **kw2)
        else:
            sub = mode.split("-")[1]
            r = r_topk(r_index, terms, k, mode=sub, plan=rplan, stats=rs, **kw)
            t = t_topk(t_index, terms, k, mode=sub, plan=plan, stats=ts, **kw)
        msg = f"{mode} {terms} {plan}"
        for a, b in zip(r if isinstance(r, tuple) else (r,),
                        t if isinstance(t, tuple) else (t,)):
            np.testing.assert_array_equal(a, b, err_msg=msg)
            assert a.dtype == b.dtype, msg
        assert_stats_equal(rs, ts, msg)


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(0)
    lists = make_lists(rng, (45, 300, 701, 1150, 37))
    tfs = make_tfs(rng, lists)
    out = {}
    for name, kw in (("tf", {"tfs": tfs}), ("plain", {})):
        ri = r_build(lists, block_size=B, n_docs=U, **kw)
        ti = t_build(lists, block_size=B, n_docs=U, device="cpu", **kw)
        out[name] = (ri, ti)
    return out


@pytest.mark.parametrize("kind", ["tf", "plain"])
def test_build_index_identical(indexes, kind):
    assert_same_index(*indexes[kind])


@pytest.mark.parametrize("kind", ["tf", "plain"])
@pytest.mark.parametrize("plan", ["torch", "cuda", "unfused"])
def test_queries_match_reference(indexes, kind, plan):
    ri, ti = indexes[kind]
    for terms in TERM_SETS:
        run_all(ri, ti, terms, plan=plan)


@pytest.mark.parametrize("use_skip", [True, False])
def test_queries_probe_width_and_use_skip(indexes, use_skip):
    ri, ti = indexes["tf"]
    for terms in ([0, 3], [0, 1, 2, 3, 4]):
        for k in (1, 3, 100):
            run_all(ri, ti, terms, k=k, probe_width=64, use_skip=use_skip,
                    modes=("topk-maxscore", "topk-driver", "and"))


def test_ties_and_seed_path():
    """Equal dfs ⇒ exact score ties broken by docid; a tiny saturated term
    next to long tf=1 lists runs MaxScore's seed phase and prunes blocks."""
    rng = np.random.default_rng(1)
    a = np.sort(rng.choice(U, size=64, replace=False)).astype(np.uint32)
    b = np.sort(rng.choice(U, size=64, replace=False)).astype(np.uint32)
    lists = {0: a, 1: b}
    ri = r_build(lists, block_size=B, n_docs=U)
    ti = t_build(lists, block_size=B, n_docs=U, device="cpu")
    for k in (3, 10, 500):
        run_all(ri, ti, [0, 1], k=k, modes=("topk-or", "topk-maxscore"))
    lists = {0: np.sort(rng.choice(U, 40, replace=False)).astype(np.uint32),
             1: np.sort(rng.choice(U, 1500, replace=False)).astype(np.uint32),
             2: np.sort(rng.choice(U, 2000, replace=False)).astype(np.uint32)}
    tfs = {0: np.full(40, 50, np.int64), 1: np.ones(1500, np.int64),
           2: np.ones(2000, np.int64)}
    ri = r_build(lists, tfs=tfs, block_size=B, n_docs=U)
    ti = t_build(lists, tfs=tfs, block_size=B, n_docs=U, device="cpu")
    rs, ts = RStats(), TStats()
    r = r_topk(ri, [0, 1, 2], 10, mode="maxscore", plan="jnp",
               probe_width=64, stats=rs)
    t = t_topk(ti, [0, 1, 2], 10, mode="maxscore", plan="cuda",
               probe_width=64, stats=ts)
    for x, y in zip(r, t):
        np.testing.assert_array_equal(x, y)
    assert ts.blocks_pruned > 0 and ts.impact_ints_decoded > 0
    assert_stats_equal(rs, ts, "seed path")


def test_deadline_degrades_like_reference(indexes):
    ri, ti = indexes["tf"]

    def expired_clock():
        t = {"now": 0.0}

        def clock():
            t["now"] += 1.0
            return t["now"]
        return clock

    from repro.robustness.validate import Deadline as RDeadline

    rs, ts = RStats(), TStats()
    r = r_topk(ri, [0, 1, 2], 5, mode="maxscore", plan="jnp", stats=rs,
               deadline=RDeadline(2.5, clock=expired_clock()))
    t = t_topk(ti, [0, 1, 2], 5, mode="maxscore", plan="torch", stats=ts,
               deadline=Deadline(2.5, clock=expired_clock()))
    for x, y in zip(r, t):
        np.testing.assert_array_equal(x, y)
    assert ts.degraded and ts.degraded_reasons == rs.degraded_reasons


def test_convert_round_trip(indexes):
    """A reference-built index handed over as numpy serves identically."""
    ri, ti = indexes["tf"]

    def stream(a):
        return {**{k: np.asarray(v) for k, v in a.device_operands().items()},
                "n": a.n, "payload_bytes": a.enc.payload_bytes}

    terms = {t: {"df": tp.df, "first_doc": tp.first_doc,
                 "last_doc": tp.last_doc, "max_impact": tp.max_impact,
                 "arr": stream(tp.arr), "impacts": stream(tp.impacts)}
             for t, tp in ri.terms.items()}
    ci = index_from_numpy(terms, n_docs=ri.n_docs, block_size=ri.block_size,
                          format=ri.format, impact_bits=ri.impact_bits,
                          has_tf=ri.has_tf, device="cpu")
    assert_same_index(ri, ci)
    assert ci.stats() == ti.stats()
    for terms_ in TERM_SETS[:4]:
        run_all(ri, ci, terms_, plan="cuda")


def test_builder_validation():
    for bad, match in (({0: np.array([1.0, 2.0])}, "integer dtype"),
                       ({0: np.array([-3, 5])}, "non-negative"),
                       ({0: np.array([5, 5])}, "strictly increasing"),
                       ({0: np.array([2**31])}, "2\\^31")):
        with pytest.raises(ValueError, match=match):
            t_build(bad, device="cpu")
    with pytest.raises(ValueError, match="≥ 1"):
        t_build({0: np.array([1, 2])}, tfs={0: np.array([0, 2])}, device="cpu")
    # format="auto" is ported: a tiny list builds the reference's index
    tiny = {0: np.array([1, 2]), 1: np.array([], np.int64)}
    assert_same_index(r_build(tiny, format="auto"),
                      t_build(tiny, format="auto", device="cpu"))
    with pytest.raises(ValueError, match="unknown format"):
        t_build({0: np.array([1, 2])}, format="zip", device="cpu")
    with pytest.raises(ValueError, match="positive integer"):
        t_topk(t_build({0: np.array([1, 2])}, device="cpu"), [0], 0)


# ---------------------------------------------------------------------------
# SearchEngine over a mesh of 8 logical cpu shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["tf", "plain"])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_sharded_vs_single_parity(kind, fmt):
    """The sharded engine (whole lists decoded once per shard, no skip
    slicing) answers every mode bit-identically to the single-device
    skip-pruned engine, and both equal the numpy oracle on AND / OR."""
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.serve import SearchEngine

    rng = np.random.default_rng(2)
    lists = make_lists(rng, (45, 300, 700))
    tfs = make_tfs(rng, lists) if kind == "tf" else None
    idx = t_build(lists, tfs=tfs, format=fmt, block_size=B, n_docs=U,
                  device="cpu")
    mesh = make_mesh((8,), ("data",), devices=["cpu"] * 8)
    single = SearchEngine(idx, top_k=8, device="cpu")
    sharded = SearchEngine(idx, mesh=mesh, top_k=8)
    assert single.use_skip and not sharded.use_skip
    for tp in sharded.index.terms.values():
        assert tp.arr.sharding[0] == mesh and tp.arr.n_blocks % 8 == 0
        assert tp.impacts.sharding[0] == mesh
    for terms in ([0, 1], [0, 1, 2], [2]):
        for mode in ("and", "or", "topk", "topk_driver", "topk_maxscore"):
            a, b = sharded.search(terms, mode), single.search(terms, mode)
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=f"{mode}")
        want = lists[terms[0]]
        for t in terms[1:]:
            want = np.intersect1d(want, lists[t])
        np.testing.assert_array_equal(sharded.search(terms, "and"), want)
    stats = sharded.run_workload([("and", [0, 1]), ("topk", [0, 2])])
    assert stats["n_devices"] == 8 and stats["block_skip_rate"] == 0.0
    assert single.run_workload([("and", [0, 1])])["n_devices"] == 1
