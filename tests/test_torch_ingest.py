"""The port's crash-safe ingestion against the reference's, on the CPU.

The reference's ``tests/test_ingest.py`` cases (but its checkpoint cases,
which wait for the port of the training stack), held to the reference's
own outcomes on the same inputs:

* the WAL: the same record bytes, and a WAL written by either package
  (torn, sheared, bit-flipped, misframed) reads in the other to the same
  ops and valid prefix, or the same ``WalError``;
* segments and manifests: a directory written by either package opens in
  the other with the same leaves and answers;
* the live index: the same op streams drive a reference ``LiveIndex``
  (``plan="jnp"``) and a port one (``device="cpu"``); every AND / OR /
  top-k answer is bit-identical across the packages and to an index
  rebuilt from scratch from the acknowledged state, through merges, at
  every one of the 8 crash points, double crashes, rollbacks and racing
  writers;
* the durability classes × 3 seeds: the port's ``corrupt_dir`` corrupts
  the same bytes of the same file as the reference's, and both packages
  recover to the same state or raise the same typed error.
"""
from __future__ import annotations

import os
import shutil
import sys
import threading

import numpy as np
import pytest

import jax  # noqa: F401  (the reference runs on the CPU backend)

from torch_parity import CPU

from repro.index import LiveIndex as RLive
from repro.index import QueryStats as RStats
from repro.index import ingest as ringest
from repro.index import wal as rwal
from repro.robustness import SegmentError as RSegmentError
from repro.robustness import WalError as RWalError
from repro.robustness import faultgen as rfg
from repro_torch.index import (CRASH_POINTS, CrashPoint, LiveIndex, QueryStats,
                               Snapshot, build_index, conjunctive,
                               disjunctive, topk)
from repro_torch.index import ingest as tingest
from repro_torch.index import wal as twal
from repro_torch.robustness import SegmentError, WalError
from repro_torch.robustness import faultgen as tfg

ORACLE_SEEDS = 12
UNIVERSE = 5000
N_TERMS = 8
QUERY_SETS = ([0, 3], [1], [2, 5, 7], [4, 6], [0, 1, 2])
ERRORS = {RWalError: WalError, RSegmentError: SegmentError}


# ---------------------------------------------------------------------------
# helpers: op streams, both packages side by side, the rebuilt oracle
# ---------------------------------------------------------------------------
def rand_terms(rng):
    k = int(rng.integers(1, 4))
    return {int(t): int(rng.integers(1, 5))
            for t in rng.choice(N_TERMS, size=k, replace=False)}


def apply_stream(rng, lives, state, n_ops, *, p_del=0.3):
    """Drive random acked ops into every index of ``lives``, mirroring
    them in ``state`` (the reference test's draws)."""
    for _ in range(n_ops):
        if state and rng.random() < p_del:
            doc = int(rng.choice(sorted(state)))
            for live in lives:
                live.delete(doc)
            del state[doc]
        else:
            doc = int(rng.integers(UNIVERSE))
            if doc in state:
                continue
            terms = rand_terms(rng)
            for live in lives:
                live.add(doc, terms)
            state[doc] = terms


def t_live(path, **kw):
    kw.setdefault("fsync", False)
    return LiveIndex(str(path), device=CPU, **kw)


def r_live(path, **kw):
    kw.setdefault("fsync", False)
    return RLive(str(path), plan="jnp", **kw)


def fresh_pair(tmp_path, tag="ix"):
    return (r_live(tmp_path / f"r_{tag}", n_docs=UNIVERSE),
            t_live(tmp_path / f"t_{tag}", n_docs=UNIVERSE))


def oracle_index(state):
    lists, tfs = {}, {}
    for doc in sorted(state):
        for t, tf in state[doc].items():
            lists.setdefault(t, []).append(doc)
            tfs.setdefault(t, []).append(tf)
    return build_index(
        {t: np.asarray(v, np.int64) for t, v in lists.items()},
        tfs={t: np.asarray(v, np.int64) for t, v in tfs.items()},
        format="auto", n_docs=UNIVERSE, checksum=True, device=CPU)


def _eq(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def answers(live, queries=QUERY_SETS, k=5):
    out = []
    for q in queries:
        out.append(live.search(q, mode="and"))
        out.append(live.search(q, mode="or"))
        out.append(live.search(q, mode="topk", k=k))
    return out


def assert_parity(live, state, *, tag="", queries=QUERY_SETS, k=5, ref=None):
    """The port's answers == rebuilt-from-scratch answers, bit for bit,
    and == the reference live index ``ref``'s (when given)."""
    idx = oracle_index(state)
    want = []
    for q in queries:
        want += [conjunctive(idx, q), disjunctive(idx, q),
                 topk(idx, q, k, mode="or")]
    got = answers(live, queries, k)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _eq(a, b), (tag, queries[i // 3], ("and", "or", "topk")[i % 3])
    if ref is not None:
        for i, (a, b) in enumerate(zip(got, answers(ref, queries, k))):
            assert _eq(a, b), (tag, "vs reference", queries[i // 3], i % 3)
    assert live.doc_count() == len(state)


def same_state(r, t):
    """The two packages' live indexes agree on everything observable."""
    assert t.counters == r.counters
    assert (t.epoch, t.state, t.wal_id) == (r.epoch, r.state, r.wal_id)
    assert (t.n_delta_docs, t.n_pending, t.doc_count()) == \
        (r.n_delta_docs, r.n_pending, r.doc_count())
    assert t.manifest == r.manifest


def listing(d):
    out = []
    for root, dirs, files in os.walk(d):
        rel = os.path.relpath(root, d)
        out += [os.path.join(rel, f) for f in files]
        out += [os.path.join(rel, x) + "/" for x in dirs]
    return sorted(out)


# ---------------------------------------------------------------------------
# WAL framing, both ways
# ---------------------------------------------------------------------------
OPS = [{"op": "add", "doc": i, "terms": {"0": 1, str(i % 5): 2}}
       for i in range(7)] + [{"op": "del", "doc": 3}]
WAL_PACKAGES = [(rwal, twal), (twal, rwal)]  # (writer, reader)


def test_index_exports_the_reference_names():
    import repro.index as rindex
    import repro_torch.index as tindex

    for name in ("LiveIndex", "Snapshot", "CRASH_POINTS", "CrashPoint",
                 "WalWriter", "open_wal", "read_wal"):
        assert hasattr(rindex, name) and hasattr(tindex, name), name
    assert tindex.CRASH_POINTS == rindex.CRASH_POINTS
    assert tindex.read_wal is twal.read_wal
    assert tindex.open_wal is twal.open_wal
    assert tindex.WalWriter is twal.WalWriter


def test_record_bytes_identical():
    for op in OPS + [{"op": "add", "doc": 2**31 - 1,
                      "terms": {str(t): t + 1 for t in range(40)}}]:
        assert twal.encode_record(op) == rwal.encode_record(op)
    assert twal.wal_name(3) == rwal.wal_name(3) == "wal_00000003.log"
    for nm in ("wal_00000003.log", "wal_x.log", "seg_1", "wal_0.log"):
        assert twal.parse_wal_name(nm) == rwal.parse_wal_name(nm)


def _read_both(p, writer_mod, reader_mod):
    """Read ``p`` with both packages: the same ``(ops, valid)`` or the same
    error class."""
    outs = []
    for mod in (writer_mod, reader_mod):
        try:
            outs.append(mod.read_wal(p))
        except (RWalError, WalError) as e:
            outs.append(("error", type(e).__name__, e.block))
    assert outs[0] == outs[1]
    return outs[1]


@pytest.mark.parametrize("writer,reader", WAL_PACKAGES,
                         ids=["ref_writes", "port_writes"])
class TestWal:
    def test_roundtrip(self, tmp_path, writer, reader):
        p = str(tmp_path / "w.log")
        w = writer.WalWriter(p, fsync=False)
        for op in OPS:
            w.append(op)
        w.close()
        got, valid = _read_both(p, writer, reader)
        assert got == OPS and valid == os.path.getsize(p)

    def test_torn_tail_truncated_on_open(self, tmp_path, writer, reader):
        p = str(tmp_path / "w.log")
        w = writer.WalWriter(p, fsync=False)
        w.append(OPS[0])
        w.append(OPS[1])
        w.close()
        size = os.path.getsize(p)
        with open(p, "ab") as f:
            f.write(b"\x99\x01")
        ops, valid = _read_both(p, writer, reader)
        assert len(ops) == 2 and valid == size
        ops2, w2 = reader.open_wal(p, fsync=False)
        w2.close()
        assert ops2 == ops and os.path.getsize(p) == size

    def test_tail_cut_inside_final_record_recovers_prefix(self, tmp_path,
                                                          writer, reader):
        p = str(tmp_path / "w.log")
        w = writer.WalWriter(p, fsync=False)
        w.append(OPS[1])
        end1 = w.append(OPS[2])
        w.close()
        with open(p, "r+b") as f:
            f.truncate(end1 - 3)
        ops, valid = _read_both(p, writer, reader)
        assert [op["doc"] for op in ops] == [1]
        assert valid < end1 - 3

    def test_midlog_corruption_detected(self, tmp_path, writer, reader):
        p = str(tmp_path / "w.log")
        w = writer.WalWriter(p, fsync=False)
        w.append(OPS[1])
        w.append(OPS[2])
        w.close()
        with open(p, "r+b") as f:
            f.seek(10)
            b = f.read(1)[0]
            f.seek(10)
            f.write(bytes([b ^ 0x40]))
        assert _read_both(p, writer, reader)[:2] == ("error", "WalError")
        with pytest.raises(WalError):
            twal.read_wal(p)

    def test_final_record_crc_garbage_is_torn(self, tmp_path, writer, reader):
        p = str(tmp_path / "w.log")
        w = writer.WalWriter(p, fsync=False)
        w.append(OPS[1])
        w.append(OPS[2])
        w.close()
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.seek(size - 1)
            b = f.read(1)[0]
            f.seek(size - 1)
            f.write(bytes([b ^ 1]))
        ops, valid = _read_both(p, writer, reader)
        assert [op["doc"] for op in ops] == [1] and valid < size

    def test_bad_length_midlog_detected(self, tmp_path, writer, reader):
        p = str(tmp_path / "w.log")
        w = writer.WalWriter(p, fsync=False)
        for i in range(40):
            w.append({"op": "add", "doc": i,
                      "terms": {str(j): 1 for j in range(8)}})
        w.close()
        with open(p, "r+b") as f:
            f.write((2000).to_bytes(4, "little"))
        assert _read_both(p, writer, reader)[:2] == ("error", "WalError")

    def test_oversize_length_past_eof_is_torn(self, tmp_path, writer, reader):
        p = str(tmp_path / "w.log")
        w = writer.WalWriter(p, fsync=False)
        w.append(OPS[1])
        end1 = w.tell()
        w.append(OPS[2])
        w.close()
        with open(p, "r+b") as f:
            f.seek(end1)
            f.write((1 << 24).to_bytes(4, "little"))
        ops, valid = _read_both(p, writer, reader)
        assert [op["doc"] for op in ops] == [1] and valid == end1

    def test_files_byte_identical(self, tmp_path, writer, reader):
        pa, pb = str(tmp_path / "a.log"), str(tmp_path / "b.log")
        for mod, p in ((writer, pa), (reader, pb)):
            w = mod.WalWriter(p, fsync=False)
            for op in OPS:
                w.append(op)
            w.close()
        assert open(pa, "rb").read() == open(pb, "rb").read()


# ---------------------------------------------------------------------------
# segments and manifests, both ways
# ---------------------------------------------------------------------------
def _same_segment(r_seg, t_seg):
    """A reference-loaded and a port-loaded segment hold the same leaves."""
    (ri, rtf, rdocs), (ti, ttf, tdocs) = r_seg, t_seg
    assert (ti.n_docs, ti.block_size, ti.format, ti.impact_bits,
            ti.has_tf) == (ri.n_docs, ri.block_size, ri.format,
                           ri.impact_bits, ri.has_tf)
    assert list(ti.terms) == list(ri.terms)
    for t, rtp in ri.terms.items():
        ttp = ti.terms[t]
        for ra, ta in ((rtp.arr, ttp.arr), (rtp.impacts, ttp.impacts)):
            assert (ta.format, ta.n, ta.differential, ta.block_size) == \
                (ra.format, ra.n, ra.differential, ra.block_size)
            lv = ta.leaves_numpy()
            for leaf, a in lv.items():
                r = np.asarray(getattr(ra, leaf))
                assert a.dtype == r.dtype and np.array_equal(a, r), leaf
            assert np.array_equal(ta.checksums, np.asarray(ra.checksums))
        for f in ("first_doc", "last_doc", "max_impact"):
            a, r = getattr(ttp, f), np.asarray(getattr(rtp, f))
            assert a.dtype == r.dtype and np.array_equal(a, r), f
        assert ttp.df == rtp.df
        assert np.array_equal(ttf[t], rtf[t])
    assert np.array_equal(tdocs, rdocs)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_segment_and_manifest_interchange(tmp_path, writer):
    """A directory written by either package (a committed merge, then an
    unmerged WAL suffix) opens in the other with the same leaves, state
    and answers."""
    rng = np.random.default_rng(31)
    d = tmp_path / "ix"
    live = (r_live if writer == "ref" else t_live)(d, n_docs=UNIVERSE)
    state = {}
    apply_stream(rng, [live], state, 60)
    live.merge()
    apply_stream(rng, [live], state, 25)
    live.close()
    seg = os.path.join(d, "segments", "seg_00000001")
    _same_segment(ringest.load_segment(seg), tingest.load_segment(seg,
                                                                  device=CPU))
    shutil.copytree(d, tmp_path / "copy")
    r, t = r_live(d), t_live(tmp_path / "copy")
    same_state(r, t)
    assert_parity(t, state, tag=f"{writer}-written", ref=r)
    # the other package merges on: the directory still opens in both
    t.merge()
    r.merge()
    t.close()
    r.close()
    _same_segment(
        ringest.load_segment(os.path.join(tmp_path / "copy", "segments",
                                          "seg_00000002")),
        tingest.load_segment(os.path.join(d, "segments", "seg_00000002"),
                             device=CPU))
    assert listing(d) == listing(tmp_path / "copy")


def test_write_epoch_starts_a_live_index(tmp_path):
    """``write_epoch`` (merge's commit) over an index built elsewhere gives
    a directory that opens in both packages at that epoch with the index's
    leaves, and serves, takes ops and merges on as a merged one does."""
    rng = np.random.default_rng(37)
    state = {}
    apply_stream(rng, [], state, 80, p_del=0.0)
    idx = oracle_index(state)
    lists, tfs = {}, {}
    for doc in sorted(state):
        for t, tf in state[doc].items():
            lists.setdefault(t, []).append(doc)
            tfs.setdefault(t, []).append(tf)
    d = tmp_path / "ix"
    os.makedirs(d)
    man = tingest.write_epoch(
        str(d), idx, {t: np.asarray(v, np.int64) for t, v in tfs.items()},
        np.asarray(sorted(state), np.int64), epoch=1, fsync=False)
    assert man == {"version": 1, "epoch": 1, "segments": ["seg_00000001"],
                   "merged_wal": 0, "n_docs": UNIVERSE, "block_size": 128,
                   "format": "auto", "impact_bits": 8, "checksum": True}
    assert listing(d) == ["./MANIFEST.json", "./segments/",
                          "segments/seg_00000001/",
                          "segments/seg_00000001/postings.npz",
                          "segments/seg_00000001/segment.json"]
    seg = os.path.join(d, "segments", "seg_00000001")
    r_seg = ringest.load_segment(seg)
    _same_segment(r_seg, tingest.load_segment(seg, device=CPU))
    assert list(r_seg[0].terms) == list(idx.terms)
    shutil.copytree(d, tmp_path / "copy")
    r, t = r_live(d), t_live(tmp_path / "copy")
    same_state(r, t)
    assert t.epoch == 1 and t.manifest == man
    assert_parity(t, state, tag="write_epoch", ref=r)
    apply_stream(rng, [r, t], state, 30)
    t.merge()
    r.merge()
    same_state(r, t)
    assert_parity(t, state, tag="write_epoch, merged on", ref=r)
    t.close()
    r.close()


# ---------------------------------------------------------------------------
# LiveIndex basics, against the reference
# ---------------------------------------------------------------------------
class TestLiveIndexBasics:
    def test_ops_and_query_parity(self, tmp_path):
        rng = np.random.default_rng(0)
        r, t = fresh_pair(tmp_path)
        state = {}
        apply_stream(rng, [r, t], state, 80)
        assert_parity(t, state, tag="pre-merge", ref=r)
        assert t.merge() == r.merge()
        assert_parity(t, state, tag="post-merge", ref=r)
        apply_stream(rng, [r, t], state, 40)
        assert_parity(t, state, tag="delta-over-segment", ref=r)
        same_state(r, t)
        r.close()
        t.close()

    def test_wal_before_ack_add_validation(self, tmp_path):
        for mk, err_cls in ((r_live, RWalError), (t_live, WalError)):
            d = tmp_path / mk.__name__
            live = mk(d, n_docs=UNIVERSE)
            live.add(5, {0: 2})
            with pytest.raises(ValueError):
                live.add(5, {1: 1})
            with pytest.raises(ValueError):
                live.add(UNIVERSE + 1, {0: 1})
            with pytest.raises(ValueError):
                live.add(7, {})
            with pytest.raises(ValueError):
                live.add(7, {0: 0})
            with pytest.raises(KeyError):
                live.delete(999)
            live.close()
            live2 = mk(d)
            assert live2.counters["replayed_ops"] == 1 and 5 in live2
            live2.close()
        assert open(tmp_path / "r_live" / "wal_00000001.log", "rb").read() \
            == open(tmp_path / "t_live" / "wal_00000001.log", "rb").read()

    def test_delete_then_readd(self, tmp_path):
        r, t = fresh_pair(tmp_path)
        for live in (r, t):
            live.add(10, {0: 1})
            live.merge()
            live.delete(10)
            assert 10 not in live
            live.add(10, {1: 3})
            assert 10 in live
        assert_parity(t, {10: {1: 3}}, tag="readd", ref=r)
        r.merge()
        t.merge()
        assert_parity(t, {10: {1: 3}}, tag="readd-merged", ref=r)
        r.close()
        t.close()

    def test_restart_replays_to_identical_results(self, tmp_path):
        rng = np.random.default_rng(1)
        r, t = fresh_pair(tmp_path)
        state = {}
        apply_stream(rng, [r, t], state, 60)
        r.close()
        t.close()
        r2, t2 = r_live(tmp_path / "r_ix"), t_live(tmp_path / "t_ix")
        assert t2.counters["replayed_ops"] == t.counters["acked_ops"]
        same_state(r2, t2)
        assert_parity(t2, state, tag="restart", ref=r2)
        r2.close()
        t2.close()

    def test_replaying_state_flags_queries_degraded(self, tmp_path):
        seen = {}
        for mk, stats_cls in ((r_live, RStats), (t_live, QueryStats)):
            d = tmp_path / mk.__name__
            live = mk(d, n_docs=UNIVERSE)
            for i in range(5):
                live.add(i, {0: 1})
            live.close()
            got = seen[mk] = []

            def hook(ix, i, op, got=got, stats_cls=stats_cls):
                st = stats_cls()
                out = ix.search([0], mode="or", stats=st)
                got.append((ix.state, st.degraded,
                            tuple(st.degraded_reasons), tuple(out)))

            live2 = mk(d, replay_hook=hook)
            st = stats_cls()
            live2.search([0], mode="or", stats=st)
            assert live2.state == "serving" and not st.degraded
            live2.close()
        assert len(seen[t_live]) == 5
        assert all(s[:3] == ("replaying", True, ("replaying",))
                   for s in seen[t_live])
        assert seen[t_live] == seen[r_live]

    def test_delta_stats_accounting(self, tmp_path):
        stats = []
        for mk, stats_cls in ((r_live, RStats), (t_live, QueryStats)):
            live = mk(tmp_path / mk.__name__, n_docs=UNIVERSE)
            for i in range(20):
                live.add(i, {0: 1})
            live.merge()
            live.delete(3)
            live.add(1000, {0: 2})
            st = stats_cls()
            out = live.search([0], mode="or", stats=st)
            assert 3 not in out and 1000 in out
            assert st.tombstones_applied == 1
            assert st.delta_postings == 1 and st.delta_hits == 1
            assert st.blocks_decoded > 0
            stats.append(st.span_attrs())
            live.close()
        assert stats[1] == stats[0]

    def test_snapshot_isolation_across_merge(self, tmp_path):
        live = t_live(tmp_path / "ix", n_docs=UNIVERSE)
        for i in range(10):
            live.add(i, {0: i % 3 + 1})
        snap = live.snapshot()
        assert isinstance(snap, Snapshot)
        assert live.readers() == {0: 1}
        live.merge()
        assert live.epoch == 1
        docs, tfs, _ = live._term_merged(snap, 0, None)
        assert list(docs) == list(range(10))
        assert list(tfs) == [i % 3 + 1 for i in range(10)]
        live.add(2000, {0: 1})
        docs2, _, _ = live._term_merged(snap, 0, None)
        assert 2000 not in docs2
        live.release(snap)
        assert 0 not in live.readers()
        live.close()

    def test_writes_during_merge_stay_live(self, tmp_path):
        r, t = fresh_pair(tmp_path)
        state = {}
        for i in range(30):
            for live in (r, t):
                live.add(i, {int(i % N_TERMS): 1})
            state[i] = {int(i % N_TERMS): 1}

        def hook(live, name):
            if name == "after_build":
                live.add(4000, {0: 9})
                live.delete(7)

        r.merge(step_hook=lambda name: hook(r, name))
        t.merge(step_hook=lambda name: hook(t, name))
        state[4000] = {0: 9}
        del state[7]
        assert_parity(t, state, tag="post-merge-writes", ref=r)
        r.close()
        t.close()
        r2, t2 = r_live(tmp_path / "r_ix"), t_live(tmp_path / "t_ix")
        assert t2.counters["replayed_ops"] == 2
        same_state(r2, t2)
        assert_parity(t2, state, tag="post-merge-writes-restart", ref=r2)
        r2.close()
        t2.close()

    def test_merge_during_merge_rejected(self, tmp_path):
        live = t_live(tmp_path / "ix", n_docs=UNIVERSE)
        live.add(1, {0: 1})

        def hook(name):
            if name == "after_rotate":
                with pytest.raises(RuntimeError):
                    live.merge()

        live.merge(step_hook=hook)
        live.close()

    def test_merge_decodes_on_the_index_device(self, tmp_path):
        from repro_torch import obs

        live = t_live(tmp_path / "ix", n_docs=UNIVERSE)
        for i in range(300):
            live.add(i * 7, {i % 3: 1 + i % 4})
        live.merge()
        assert live.main.device == CPU
        live.add(5000 - 1, {0: 1})
        tele = obs.Telemetry()
        with obs.install(tele):
            live.merge()
        decodes = [s for s in tele.tracer.spans if s["name"] == "decode"]
        # one whole-list decode per main term, nothing else
        assert len(decodes) == 3
        assert all(s["attrs"]["epilogue"] == "stream" for s in decodes)
        live.close()


# ---------------------------------------------------------------------------
# crash-point recovery + the randomized interleaving oracle
# ---------------------------------------------------------------------------
def crash_and_recover(r_dir, t_dir, tmp_path, cp, state, *, tag):
    """Copy both closed dirs, crash each package's merge at ``cp``, reopen
    both, check parity (to the oracle and across packages) and the same
    recovery, then complete the merges and check again."""
    dirs = []
    for mk, src in ((r_live, r_dir), (t_live, t_dir)):
        dd = str(tmp_path / f"crash_{tag}_{cp}_{mk.__name__}")
        shutil.copytree(src, dd)
        lc = mk(dd)
        with pytest.raises((CrashPoint, ringest.CrashPoint)):
            lc.merge(crash_at=cp)
        assert lc.state == "merge_in_progress"
        lc.close()
        dirs.append(dd)
    assert listing(dirs[0]) == listing(dirs[1]), cp
    lr, lt = r_live(dirs[0]), t_live(dirs[1])
    same_state(lr, lt)
    assert_parity(lt, state, tag=f"{tag}:{cp}:recovered", ref=lr)
    assert lt.merge() == lr.merge()
    assert_parity(lt, state, tag=f"{tag}:{cp}:post-retry-merge", ref=lr)
    same_state(lr, lt)
    lr.close()
    lt.close()
    assert listing(dirs[0]) == listing(dirs[1]), cp
    for dd in dirs:
        shutil.rmtree(dd)


@pytest.mark.parametrize("seed", range(ORACLE_SEEDS))
def test_interleaving_oracle(seed, tmp_path):
    """Seeded add/delete/query interleavings on both packages, checked
    against the rebuilt oracle and each other at every query step, then
    crashed at EVERY named crash point and recovered to bit-identical
    results — including interleavings that already hold a committed
    merge."""
    rng = np.random.default_rng(1000 + seed)
    r, t = fresh_pair(tmp_path)
    state = {}
    n_rounds = int(rng.integers(3, 6))
    for rd in range(n_rounds):
        apply_stream(rng, [r, t], state, int(rng.integers(8, 20)))
        qs = [sorted(int(x) for x in
                     rng.choice(N_TERMS, size=rng.integers(1, 4),
                                replace=False))]
        assert_parity(t, state, tag=f"seed{seed}:round{rd}", queries=qs,
                      ref=r)
        if rd == 1 and rng.random() < 0.5:
            assert t.merge() == r.merge()
            assert_parity(t, state, tag=f"seed{seed}:merged{rd}", queries=qs,
                          ref=r)
    r.close()
    t.close()
    for cp in CRASH_POINTS:
        crash_and_recover(tmp_path / "r_ix", tmp_path / "t_ix", tmp_path, cp,
                          state, tag=f"seed{seed}")


@pytest.mark.parametrize("cp", CRASH_POINTS)
def test_mid_merge_queries_bit_identical(cp, tmp_path):
    """Queries served at every point of an in-flight merge equal the
    quiescent results (and the reference's) bit for bit."""
    rng = np.random.default_rng(7)
    r, t = fresh_pair(tmp_path)
    state = {}
    apply_stream(rng, [r, t], state, 50)
    r.merge()
    t.merge()
    apply_stream(rng, [r, t], state, 30)
    quiescent = answers(r)
    ran = []

    def hook(name):
        if name == cp:
            assert_parity(t, state, tag=f"at:{name}")
            assert all(_eq(a, b) for a, b in zip(answers(t), quiescent))
            ran.append(name)

    t.merge(step_hook=hook)
    assert ran == [cp]
    r.merge()
    assert_parity(t, state, tag="quiescent-after", ref=r)
    r.close()
    t.close()


def test_double_crash_then_recover(tmp_path):
    rng = np.random.default_rng(11)
    r, t = fresh_pair(tmp_path)
    state = {}
    apply_stream(rng, [r, t], state, 40)
    for cp in ("after_rotate", "manifest_tmp_written"):
        for live in (r, t):
            with pytest.raises((CrashPoint, ringest.CrashPoint)):
                live.merge(crash_at=cp)
            live.close()
        r, t = r_live(tmp_path / "r_ix"), t_live(tmp_path / "t_ix")
        same_state(r, t)
    assert listing(tmp_path / "r_ix") == listing(tmp_path / "t_ix")
    assert_parity(t, state, tag="double-crash", ref=r)
    assert t.merge() == r.merge()
    assert_parity(t, state, tag="double-crash-merged", ref=r)
    r.close()
    t.close()


# ---------------------------------------------------------------------------
# writer/rotation atomicity and merge-failure rollback
# ---------------------------------------------------------------------------
def test_merge_precommit_failure_rolls_back_to_serving(tmp_path):
    class Boom(RuntimeError):
        pass

    rng = np.random.default_rng(23)
    r, t = fresh_pair(tmp_path)
    state = {}
    apply_stream(rng, [r, t], state, 40)
    victim = next(d for d in sorted(state))

    def hook(live):
        def fn(name):
            if name == "segment_tmp_written":
                live.add(4100, {0: 3})
                live.delete(victim)
                raise Boom("transient disk error")
        return fn

    for live in (r, t):
        with pytest.raises(Boom):
            live.merge(step_hook=hook(live))
        assert live.state == "serving"
    state[4100] = {0: 3}
    del state[victim]
    same_state(r, t)
    assert listing(tmp_path / "r_ix") == listing(tmp_path / "t_ix")
    assert_parity(t, state, tag="post-failed-merge", ref=r)
    assert t.merge() == r.merge()
    assert t.state == "serving" and t.epoch == 1
    assert_parity(t, state, tag="post-retried-merge", ref=r)

    def hook2(name):
        if name == "before_rotate":
            raise Boom("hook failure")

    for live in (r, t):
        with pytest.raises(Boom):
            live.merge(step_hook=hook2)
        assert live.state == "serving"
        live.merge()
    assert_parity(t, state, tag="post-unrotated-failure", ref=r)
    r.close()
    t.close()
    r2, t2 = r_live(tmp_path / "r_ix"), t_live(tmp_path / "t_ix")
    same_state(r2, t2)
    assert_parity(t2, state, tag="post-failure-restart", ref=r2)
    r2.close()
    t2.close()


def test_concurrent_writers_during_merge(tmp_path):
    """Writer threads racing merges on the port: every acked op lands on
    the same side of the WAL rotation as its delta placement, so a restart
    (in either package) replays exactly the acked state."""
    live = t_live(tmp_path / "ix", n_docs=UNIVERSE)
    state = {}
    for i in range(40):
        live.add(i, {int(i % N_TERMS): 1})
        state[i] = {int(i % N_TERMS): 1}
    acked, errs = [], []

    def writer(base):
        rng = np.random.default_rng(base)
        try:
            for doc in range(1000 * (base + 1), 1000 * (base + 1) + 200):
                terms = {int(rng.integers(N_TERMS)): int(rng.integers(1, 4))}
                live.add(doc, terms)
                acked.append((doc, terms))
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(b,)) for b in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for th in threads:
            th.start()
        for _ in range(3):
            live.merge()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert errs == []
    for doc, terms in acked:
        state[doc] = terms
    assert_parity(live, state, tag="concurrent-writers-quiescent")
    live.close()
    shutil.copytree(tmp_path / "ix", tmp_path / "ix_ref")
    live2, ref2 = t_live(tmp_path / "ix"), r_live(tmp_path / "ix_ref")
    same_state(ref2, live2)
    assert_parity(live2, state, tag="concurrent-writers-restart", ref=ref2)
    live2.close()
    ref2.close()


def test_concurrent_duplicate_adds_one_wins(tmp_path):
    live = t_live(tmp_path / "ix", n_docs=UNIVERSE)
    for doc in range(50):
        barrier = threading.Barrier(2)
        outcomes = []

        def attempt(d=doc):
            barrier.wait()
            try:
                live.add(d, {0: 1})
                outcomes.append("ok")
            except ValueError:
                outcomes.append("dup")

        ts = [threading.Thread(target=attempt) for _ in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=300)
            assert not th.is_alive()
        assert sorted(outcomes) == ["dup", "ok"], (doc, outcomes)
    live.close()
    live2 = r_live(tmp_path / "ix")  # the reference replays the port's WAL
    assert live2.counters["replayed_ops"] == 50
    live2.close()


def test_reopen_conflicting_args_rejected(tmp_path):
    d = tmp_path / "ix"
    live = t_live(d, n_docs=UNIVERSE)
    live.add(1, {0: 1})
    live.close()
    for kw in ({"n_docs": UNIVERSE + 1}, {"block_size": 64},
               {"impact_bits": 4}, {"format": "vbyte"},
               {"checksum": False}):
        for mk in (t_live, r_live):
            with pytest.raises(ValueError, match="conflict"):
                mk(d, **kw)
    live = t_live(d, n_docs=UNIVERSE, block_size=128, format="auto",
                  impact_bits=8, checksum=True)
    assert 1 in live
    live.close()
    live = t_live(d)
    assert 1 in live
    live.close()


# ---------------------------------------------------------------------------
# durability fault classes: the same bytes, the same detect-or-recover
# ---------------------------------------------------------------------------
def _prepped_dir(tmp_path, seed, *, merged: bool):
    """A closed port LiveIndex dir with a committed segment + unmerged
    WAL, and its logical state."""
    rng = np.random.default_rng(seed)
    d = str(tmp_path / f"ix{seed}{int(merged)}")
    live = t_live(d, n_docs=UNIVERSE)
    state = {}
    apply_stream(rng, [live], state, 40)
    if merged:
        live.merge()
        apply_stream(rng, [live], state, 25)
    live.close()
    return d, state


def _corrupt_both(tmp_path, d, cls, seed):
    """Corrupt two copies of ``d``, one per package, with the same seed:
    the same fault and the same bytes in every file."""
    rd, td = str(tmp_path / "r_copy"), str(tmp_path / "t_copy")
    shutil.copytree(d, rd)
    shutil.copytree(d, td)
    rf, tf = rfg.corrupt_dir(rd, cls, seed=seed), tfg.corrupt_dir(td, cls,
                                                                  seed=seed)
    assert (rf is None) == (tf is None)
    if tf is not None:
        assert (tf.cls, os.path.relpath(tf.path, td), tf.detail, tf.expect,
                tf.ops_lost) == (rf.cls, os.path.relpath(rf.path, rd),
                                 rf.detail, rf.expect, rf.ops_lost)
    assert listing(rd) == listing(td)
    for f in listing(td):
        if not f.endswith("/"):
            assert open(os.path.join(rd, f), "rb").read() == \
                open(os.path.join(td, f), "rb").read(), f
    return rd, td, tf


def _open_both(rd, td):
    """Open each copy with its package: both recover or both raise the
    same typed error."""
    outs = []
    for mk, d in ((r_live, rd), (t_live, td)):
        try:
            outs.append(mk(d))
        except (RWalError, RSegmentError, WalError, SegmentError) as e:
            outs.append(e)
    r, t = outs
    if isinstance(r, Exception) or isinstance(t, Exception):
        assert isinstance(r, tuple(ERRORS)) and isinstance(t, tuple(
            ERRORS.values())), (r, t)
        assert ERRORS[type(r)] is type(t), (r, t)
        return None, None, t
    return r, t, None


@pytest.mark.parametrize("cls", sorted(tfg.DURABILITY_CLASSES))
@pytest.mark.parametrize("seed", range(3))
def test_durability_class_detect_or_recover(cls, seed, tmp_path):
    assert sorted(tfg.DURABILITY_CLASSES) == sorted(rfg.DURABILITY_CLASSES)
    d, state = _prepped_dir(tmp_path, seed, merged=True)
    rd, td, fault = _corrupt_both(tmp_path, d, cls, seed * 7 + 1)
    assert fault is not None, (cls, "did not apply to a merged dir")
    r, t, err = _open_both(rd, td)
    if fault.expect == "detect":
        assert isinstance(err, (WalError, SegmentError)), err
        return
    assert err is None
    same_state(r, t)
    if fault.ops_lost:
        assert abs(t.doc_count() - len(state)) <= fault.ops_lost
        assert t.counters["wal_bytes_truncated"] > 0
        for a, b in zip(answers(t), answers(r)):
            assert _eq(a, b)
    else:
        assert_parity(t, state, tag=cls, ref=r)
    if cls in ("manifest_stale", "manifest_missing"):
        assert t.counters["rolled_forward"] == 1
    r.close()
    t.close()


def test_unknown_durability_class_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown durability class"):
        tfg.corrupt_dir(str(tmp_path), "nope", seed=0)


def test_wal_faults_apply_premerge(tmp_path):
    d, _ = _prepped_dir(tmp_path, 5, merged=False)
    rd, td, fault = _corrupt_both(tmp_path, d, "wal_record_flip", 3)
    assert fault is not None and fault.expect == "detect"
    assert isinstance(_open_both(rd, td)[2], WalError)
    for cls in ("segment_truncate", "manifest_stale", "manifest_missing"):
        assert tfg.corrupt_dir(td, cls, seed=0) is None  # nothing committed


def test_torn_tail_recovers_acked_prefix_exactly(tmp_path):
    d = str(tmp_path / "ix")
    live = t_live(d, n_docs=UNIVERSE)
    state = {}
    rng = np.random.default_rng(21)
    apply_stream(rng, [live], state, 30, p_del=0.0)
    last_doc = sorted(state)[-1]
    probe = next(D for D in range(4900, UNIVERSE) if D not in state)
    live.add(probe, {0: 1})
    live.close()
    rd, td, fault = _corrupt_both(tmp_path, d, "wal_tail_shear", 1)
    assert fault is not None and fault.ops_lost == 1
    r, t, _ = _open_both(rd, td)
    assert probe not in t and last_doc in t
    assert_parity(t, state, tag="shear-prefix", ref=r)
    r.close()
    t.close()


def test_stale_manifest_rolls_forward(tmp_path):
    d, state = _prepped_dir(tmp_path, 9, merged=True)
    rd, td, fault = _corrupt_both(tmp_path, d, "manifest_stale", 2)
    assert fault is not None and fault.expect == "recover"
    r, t, _ = _open_both(rd, td)
    assert t.counters["rolled_forward"] == 1
    same_state(r, t)
    assert_parity(t, state, tag="rolled-forward", ref=r)
    r.close()
    t.close()
    t2 = t_live(td)
    assert t2.counters["rolled_forward"] == 0
    assert_parity(t2, state, tag="rolled-forward-reopen")
    t2.close()


def test_uncommitted_segment_discarded_when_wals_present(tmp_path):
    rng = np.random.default_rng(13)
    r, t = fresh_pair(tmp_path)
    state = {}
    apply_stream(rng, [r, t], state, 30)
    for live in (r, t):
        with pytest.raises((CrashPoint, ringest.CrashPoint)):
            live.merge(crash_at="after_segment_rename")
        live.close()
    for side in ("r_ix", "t_ix"):
        seg_dirs = os.listdir(tmp_path / side / "segments")
        assert any(nm.startswith("seg_") for nm in seg_dirs)
    r2, t2 = r_live(tmp_path / "r_ix"), t_live(tmp_path / "t_ix")
    assert t2.epoch == 0 and t2.counters["rolled_forward"] == 0
    assert not os.listdir(tmp_path / "t_ix" / "segments")
    same_state(r2, t2)
    assert_parity(t2, state, tag="orphan-discarded", ref=r2)
    r2.close()
    t2.close()


def test_corrupt_orphan_with_wals_present_still_recovers(tmp_path):
    rng = np.random.default_rng(17)
    r, t = fresh_pair(tmp_path)
    state = {}
    apply_stream(rng, [r, t], state, 25)
    for side, live in (("r_ix", r), ("t_ix", t)):
        with pytest.raises((CrashPoint, ringest.CrashPoint)):
            live.merge(crash_at="after_segment_rename")
        live.close()
        seg = os.path.join(tmp_path / side, "segments", os.listdir(
            tmp_path / side / "segments")[0])
        with open(os.path.join(seg, "segment.json"), "w") as f:
            f.write("garbage{")
    r2, t2 = r_live(tmp_path / "r_ix"), t_live(tmp_path / "t_ix")
    same_state(r2, t2)
    assert_parity(t2, state, tag="corrupt-orphan", ref=r2)
    r2.close()
    t2.close()


def test_corrupt_orphan_with_wals_gone_detects(tmp_path):
    d, _ = _prepped_dir(tmp_path, 19, merged=True)
    rd, td, _ = _corrupt_both(tmp_path, d, "manifest_stale", 4)
    for dd in (rd, td):
        seg = os.path.join(dd, "segments", sorted(os.listdir(
            os.path.join(dd, "segments")))[-1])
        with open(os.path.join(seg, "segment.json"), "w") as f:
            f.write("not json")
    assert isinstance(_open_both(rd, td)[2], SegmentError)


# ---------------------------------------------------------------------------
# the serving facade and its smoke
# ---------------------------------------------------------------------------
def test_live_search_engine_workload_matches_reference(tmp_path):
    from repro.launch.serve import LiveSearchEngine as RLiveEngine
    from repro_torch.launch.serve import LiveSearchEngine

    rng = np.random.default_rng(3)
    r, t = fresh_pair(tmp_path)
    state = {}
    apply_stream(rng, [r, t], state, 60)
    r.merge()
    t.merge()
    apply_stream(rng, [r, t], state, 30)
    qs = [(m, q) for q in QUERY_SETS for m in ("and", "or", "topk")]
    re, te = RLiveEngine(r, top_k=5), LiveSearchEngine(t, top_k=5)
    rw, record = re.run_workload(qs), []
    tw = te.run_workload(qs, record=record)
    timing = ("qps", "p50_ms", "p99_ms", "mean_ms")
    assert {k: v for k, v in tw.items() if k not in timing} == \
        {k: v for k, v in rw.items() if k not in timing}
    for (mode, terms), (out, _, _) in zip(qs, record):
        assert _eq(out, re.search(terms, mode))
    r.close()
    t.close()


def test_ingest_smoke_matches_reference():
    from repro.launch.serve import serve_ingest_smoke as r_smoke
    from repro_torch.launch.serve import serve_ingest_smoke as t_smoke

    kw = dict(ops=60, queries=8, top_k=5, seed=1)
    r, t = r_smoke(record=False, **kw), t_smoke(device=CPU, **kw)
    timing = ("qps", "p50_ms", "p99_ms")
    assert t.pop("device") == "cpu"
    assert {k: v for k, v in t.items() if k not in timing} == \
        {k: v for k, v in r.items() if k not in timing}
