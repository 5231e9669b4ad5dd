"""The port's robustness layer against the reference's, on the CPU.

For every stream corruption class × format × seed, with and without the
checksum column, on the same numpy values: the port's ``faultgen`` breaks
the same bytes as the reference's, the port's detection stack (host
validators, then the checked decode through the plain torch plan) raises
the reference's class at the reference's block and term (the reference
with ``plan="jnp"``), and a corruption neither detects decodes to the
reference's grid bit for bit. Then the index classes, the checksum
column, the vectorised validators against the reference's block-by-block
walk, the rows past a block's limits (``ROADMAP.md`` queue 3 items 2 and
3), and every case of the reference's hardened-engine tests against the
reference engine's own answers on the same index.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference runs on the CPU backend)

from conftest import make_valid_stream
from torch_parity import CPU, np_u32

from repro.core import CompressedIntArray as RArray
from repro.index import QueryStats as RStats
from repro.index import build_index as r_build
from repro.index.partition import choose_partition as r_choose
from repro.index.partition import encode_partitioned as r_encode_part
from repro.launch.serve import SearchEngine as RSearchEngine
from repro.launch.serve import serve_search_degraded as r_degraded
from repro.robustness import ChecksumError as RChecksumError
from repro.robustness import DecodeError as RDecodeError
from repro.robustness import decode_checked as r_decode_checked
from repro.robustness import faultgen as rfg
from repro.robustness import validate as rval
from repro_torch.core import CompressedIntArray as TArray
from repro_torch.core.compressed_array import FORMAT_LEAVES, block_checksums
from repro_torch.index import QueryStats as TStats
from repro_torch.index import build_index as t_build
from repro_torch.index.partition import choose_partition as t_choose
from repro_torch.index.partition import encode_partitioned as t_encode_part
from repro_torch.kernels.vbyte_decode import dispatch
from repro_torch.launch.serve import SearchEngine as TSearchEngine
from repro_torch.launch.serve import serve_search_degraded as t_degraded
from repro_torch.robustness import ChecksumError as TChecksumError
from repro_torch.robustness import DecodeError as TDecodeError
from repro_torch.robustness import decode_checked as t_decode_checked
from repro_torch.robustness import faultgen as tfg
from repro_torch.robustness import validate as tval

FORMATS = ("vbyte", "streamvbyte", "binpack")
SEEDS = (0, 1, 2)
STREAM_CLASSES = sorted(rfg.STREAM_CLASSES)


def _values(fmt, *, n=200, differential=False, seed=0):
    """The reference test's ``_clean_array`` values."""
    rng = np.random.default_rng(seed)
    vals = make_valid_stream(rng, n,
                             max_bits=30 if fmt == "streamvbyte" else 32)
    if differential:
        vals = np.cumsum(vals % 997).astype(np.uint64)  # sorted, in-range
    return vals


def _pair(fmt, *, n=200, block_size=64, differential=False, checksum=True,
          seed=0):
    vals = _values(fmt, n=n, differential=differential, seed=seed)
    kw = dict(format=fmt, block_size=block_size, differential=differential,
              checksum=checksum)
    return (RArray.encode(vals, **kw),
            TArray.encode(vals, device=CPU, **kw))


def _r_detect(arr, term=None):
    try:
        rval.validate_array(arr, term=term)
        if arr.checksums is not None:
            r_decode_checked(arr, plan="jnp", term=term)
        return None
    except RDecodeError as e:
        return e


def _t_detect(arr, term=None, plan="torch"):
    try:
        tval.validate_array(arr, term=term)
        if arr.checksums is not None:
            t_decode_checked(arr, plan=plan, term=term)
        return None
    except TDecodeError as e:
        return e


def _same_error(r, t, what=""):
    """Both raised the same class at the same coordinates, or neither."""
    if r is None or t is None:
        assert r is None and t is None, (what, r, t)
        return
    assert type(r).__name__ == type(t).__name__, (what, r, t)
    assert (r.format, r.block, r.term) == (t.format, t.block, t.term), \
        (what, r, t)
    assert str(r) == str(t), what


def _same_leaves(r, t):
    assert r.format == t.format and r.n == t.n
    lv = t.leaves_numpy()
    for k in FORMAT_LEAVES[t.format]:
        np.testing.assert_array_equal(np_u32(getattr(r, k)), np_u32(lv[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(np.asarray(r.counts), t.counts_host)
    if r.checksums is None:
        assert t.checksums is None
    else:
        np.testing.assert_array_equal(np_u32(r.checksums),
                                      np_u32(t.checksums))


def _corrupt_pair(fmt, cls, seed, checksum):
    ra, ta = _pair(fmt, differential=cls == "base_corrupt",
                   checksum=checksum, seed=seed)
    rc, tc = rfg.corrupt(ra, cls, seed), tfg.corrupt(ta, cls, seed)
    assert (rc is None) == (tc is None)
    return ra, ta, rc, tc


# ---------------------------------------------------------------------------
# the fuzz contract, class by class against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("checksum", (True, False))
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("cls", STREAM_CLASSES)
@pytest.mark.parametrize("seed", SEEDS)
def test_faultgen_breaks_the_same_bytes(fmt, cls, seed, checksum):
    _, ta, rc, tc = _corrupt_pair(fmt, cls, seed, checksum)
    if rc is None:  # the class does not apply, in both packages
        return
    assert (rc.cls, rc.block, rc.detail) == (tc.cls, tc.block, tc.detail)
    _same_leaves(rc.arr, tc.arr)
    assert tc.arr.device == ta.device and tc.arr.n == ta.n
    np.testing.assert_array_equal(tc.arr.counts.numpy(), tc.arr.counts_host)


@pytest.mark.parametrize("checksum", (True, False))
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("cls", STREAM_CLASSES)
@pytest.mark.parametrize("seed", SEEDS)
def test_detection_matches_reference(fmt, cls, seed, checksum):
    ra, ta, rc, tc = _corrupt_pair(fmt, cls, seed, checksum)
    _same_error(_r_detect(ra, term=42), _t_detect(ta, term=42), "clean")
    assert _t_detect(ta, term=42) is None
    if rc is None:
        return
    r_err, t_err = _r_detect(rc.arr, term=42), _t_detect(tc.arr, term=42)
    _same_error(r_err, t_err, f"{cls} {rc.detail}")
    if checksum:  # with the column every class is detected
        assert isinstance(t_err, TDecodeError), (cls, rc.detail)
    if t_err is None:  # defined garbage: the same grid as the reference's
        ref = np.asarray(rc.arr.decode_blocked(plan="jnp"))
        np.testing.assert_array_equal(
            np_u32(ref), np_u32(tc.arr.decode_blocked(plan="torch")))
        np.testing.assert_array_equal(rc.arr.decode(plan="jnp"),
                                      tc.arr.decode(plan="torch"))


def test_unknown_class_raises():
    _, ta = _pair("vbyte")
    with pytest.raises(ValueError, match="unknown corruption class"):
        tfg.corrupt(ta, "nope", 0)


@pytest.mark.parametrize("cls", sorted(rfg.INDEX_CLASSES))
def test_index_corruption_matches_reference(cls):
    rng = np.random.default_rng(0)
    docs = np.unique(rng.integers(0, 1 << 20, 600))
    tfs = {7: 1 + (np.arange(docs.size) % 7)}
    ri = r_build({7: docs}, tfs=tfs, n_docs=1 << 20, checksum=True)
    ti = t_build({7: docs}, tfs=tfs, n_docs=1 << 20, checksum=True,
                 device=CPU)
    rtp = rfg.INDEX_CLASSES[cls](ri.terms[7], seed=3)
    ttp = tfg.INDEX_CLASSES[cls](ti.terms[7], seed=3)
    for k in ("first_doc", "last_doc", "max_impact"):
        np.testing.assert_array_equal(np.asarray(getattr(rtp, k)),
                                      getattr(ttp, k), err_msg=k)
    _same_leaves(rtp.impacts, ttp.impacts)
    errs = []
    for tp, val, checked, err in ((rtp, rval, r_decode_checked, RDecodeError),
                                  (ttp, tval, t_decode_checked, TDecodeError)):
        with pytest.raises(err) as ei:
            val.validate_meta(tp, deep=True)
            checked(tp.impacts, plan="jnp" if val is rval else "torch",
                    term=7)
        errs.append(ei.value)
    _same_error(*errs, cls)
    if cls == "max_impact_under":
        assert type(errs[1]).__name__ == "BoundViolationError"
    assert errs[1].term == 7 or errs[1].block is not None


def test_single_value_corruption_always_caught():
    """The odd positional weights are invertible mod 2^32: any single-slot
    delta shifts the checksum. Exhaustively perturb every slot."""
    ra, ta = _pair("vbyte", n=16, block_size=8)
    grid = np_u32(ta.decode_blocked(plan="torch")).astype(np.uint64)
    counts = ta.counts_host
    clean = block_checksums(grid, counts)
    np.testing.assert_array_equal(np_u32(clean), np_u32(ra.checksums))
    rng = np.random.default_rng(0)
    for b in range(grid.shape[0]):
        for j in range(int(counts[b])):
            g = grid.copy()
            g[b, j] ^= np.uint64(1) << np.uint64(rng.integers(32))
            assert block_checksums(g, counts)[b] != clean[b]


def test_partitioned_array_detect_or_defined():
    """DP-partitioned (variable-count) arrays pass the validators clean and
    keep the detect contract under corruption, as in the reference."""
    rng = np.random.default_rng(3)
    gaps = rng.integers(1, 9, 900).astype(np.uint64)
    gaps[rng.random(900) < 0.02] += 100_000
    vals = np.cumsum(gaps).astype(np.uint64)
    rp, tp = r_choose(vals, block_size=64), t_choose(vals, block_size=64)
    assert rp.format == tp.format
    np.testing.assert_array_equal(np.asarray(rp.bounds), tp.bounds)
    kw = dict(block_size=64, differential=True, checksum=True)
    ra = r_encode_part(vals, rp.bounds, format=rp.format, **kw)
    ta = t_encode_part(vals, tp.bounds, format=tp.format, device=CPU, **kw)
    assert _t_detect(ta) is None and _r_detect(ra) is None
    for cls in ("bit_flip", "count_under", "width_deflate"):
        rc, tc = rfg.corrupt(ra, cls, 0), tfg.corrupt(ta, cls, 0)
        assert (rc is None) == (tc is None)
        if tc is None:
            continue
        _same_leaves(rc.arr, tc.arr)
        t_err = _t_detect(tc.arr)
        _same_error(_r_detect(rc.arr), t_err, cls)
        assert isinstance(t_err, TDecodeError), cls


# ---------------------------------------------------------------------------
# the vectorised validators against the reference's block-by-block walk
# ---------------------------------------------------------------------------
def _sparse_damage(t_arr, r_arr, rng, n_hits):
    """Random bits flipped (and binpack widths and Stream-VByte control
    bytes rewritten) in random rows, used bytes and padding, mirrored onto
    both packages' arrays."""
    name = "payload" if t_arr.format == "vbyte" else "data"
    extra = {"streamvbyte": "control", "binpack": "widths"}.get(t_arr.format)
    lv = t_arr.leaves_numpy()
    leaves = {name: lv[name].copy()}
    if extra:
        leaves[extra] = lv[extra].copy()
    for _ in range(n_hits):
        key = extra if (extra and rng.random() < 0.3) else name
        leaf = leaves[key]
        b = int(rng.integers(leaf.shape[0]))
        # mostly the front of the row, where the used bytes are
        i = int(rng.integers(max(1, leaf.shape[1] // (
            4 if rng.random() < 0.7 else 1))))
        if key == "widths":
            leaf[b, i] = int(rng.integers(0, 40))
        else:
            leaf[b, i] ^= np.uint8(1 << int(rng.integers(8)))
    return (dataclasses.replace(r_arr, host_enc=None, **leaves),
            tfg._rebuild(t_arr, **leaves))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("seed", range(6))
def test_vectorised_validators_match_the_block_walk(fmt, seed):
    rng = np.random.default_rng(100 + seed)
    bits = (6, 14, 30)[seed % 3]  # narrow values leave room to overrun S
    vals = rng.integers(0, 1 << bits, 3000).astype(np.uint64)
    kw = dict(format=fmt, block_size=64)
    ra, ta = RArray.encode(vals, **kw), TArray.encode(vals, device=CPU, **kw)
    rd, td = _sparse_damage(ta, ra, rng, n_hits=int(rng.integers(5, 40)))
    _same_error(_r_detect(rd, term=5), _t_detect(td, term=5), "whole")
    order = rng.permutation(ta.n_blocks)
    for blocks in ([int(b)] for b in range(ta.n_blocks)):
        r = t = None
        try:
            rval.validate_stream(rd, term=5, blocks=blocks)
        except RDecodeError as e:
            r = e
        try:
            tval.validate_stream(td, term=5, blocks=blocks)
        except TDecodeError as e:
            t = e
        _same_error(r, t, f"block {blocks}")
    errs = []
    for val, arr, err in ((rval, rd, RDecodeError), (tval, td, TDecodeError)):
        try:
            val.validate_stream(arr, blocks=order)
            errs.append(None)
        except err as e:
            errs.append(e)
    _same_error(*errs, "permuted order")


# ---------------------------------------------------------------------------
# rows past a block's limits (ROADMAP queue 3 items 2 and 3): rejected with
# the same typed error by both packages before any decode
# ---------------------------------------------------------------------------
def _out_of_contract(kind):
    fmt = {"count": "vbyte", "svb": "streamvbyte", "binpack": "binpack"}[kind]
    vals = np.random.default_rng(7).integers(0, 200, 256).astype(np.uint64)
    kw = dict(format=fmt, block_size=128)
    ra, ta = RArray.encode(vals, **kw), TArray.encode(vals, device=CPU, **kw)
    b = 1
    if kind == "count":  # a count past block_size
        c = ta.counts_host.copy()
        c[b] = 129
        return (dataclasses.replace(ra, host_enc=None, counts=c),
                tfg._rebuild(ta, counts=c))
    if kind == "svb":  # every code claims 4 bytes: 4 · 128 > S
        ctrl = ta.leaves_numpy()["control"].copy()
        ctrl[b] = 0xFF
        assert 4 * 128 > ta.stride
        return (dataclasses.replace(ra, host_enc=None, control=ctrl),
                tfg._rebuild(ta, control=ctrl))
    widths = ta.leaves_numpy()["widths"].copy()  # 32 bits × 128 > S bytes
    widths[b, 0] = 32
    assert 32 * 128 // 8 > ta.stride
    return (dataclasses.replace(ra, host_enc=None, widths=widths),
            tfg._rebuild(ta, widths=widths))


@pytest.mark.parametrize("kind,cls", [("count", "BlockMetaError"),
                                      ("svb", "ControlMismatchError"),
                                      ("binpack", "TruncatedPayloadError")])
def test_out_of_contract_rows_rejected_before_decode(kind, cls):
    ra, ta = _out_of_contract(kind)
    r_err, t_err = _r_detect(ra, term=1), _t_detect(ta, term=1)
    _same_error(r_err, t_err, kind)
    assert type(t_err).__name__ == cls and t_err.block == 1


# ---------------------------------------------------------------------------
# a base flip the checksum cannot see: the reference serves it, the port's
# startup gate holds the checked grid against the skip table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", FORMATS)
def test_base_flip_past_the_checksum_is_quarantined(fmt):
    rng = np.random.default_rng(4)
    lists = {t: np.unique(rng.integers(0, 1 << 24, 1500)) for t in range(3)}
    kw = dict(n_docs=1 << 24, format=fmt, checksum=True)
    ri, ti = r_build(lists, **kw), t_build(lists, device=CPU, **kw)
    bases = ti.terms[1].arr.leaves_numpy()["bases"].copy()
    assert ti.terms[1].arr.counts_host[2] == 128
    bases[2] ^= np.uint32(1 << 20)  # 2^20 · 128² ≡ 0 mod 2^32
    r_arr = dataclasses.replace(ri.terms[1].arr, host_enc=None, bases=bases)
    t_arr = tfg._rebuild(ti.terms[1].arr, bases=bases)
    _same_error(_r_detect(r_arr, term=1), _t_detect(t_arr, term=1), "flip")
    assert _t_detect(t_arr, term=1) is None  # no checksum sees it
    r_bad = dataclasses.replace(ri, terms={
        **ri.terms, 1: dataclasses.replace(ri.terms[1], arr=r_arr)})
    t_bad = dataclasses.replace(ti, terms={
        **ti.terms, 1: dataclasses.replace(ti.terms[1], arr=t_arr)})
    reng, teng = _engines(r_bad, t_bad, validate=True)
    clean = TSearchEngine(ti, device=CPU).search([1, 2], "or")
    assert not reng.quarantined  # the reference serves shifted docids
    assert not np.array_equal(np.asarray(reng.search([1, 2], "or")), clean)
    with pytest.raises(RDecodeError) as ei:
        rval.validate_meta(r_bad.terms[1], deep=True)
    assert list(teng.quarantined) == [1]
    assert teng.quarantined[1] == str(ei.value)  # deep validate's error
    out, st = teng.search([1, 2], "or"), TStats()
    teng.search([1, 2], "or", stats=st)
    _same_answer(TSearchEngine(ti, device=CPU).search([2], "or"), out)
    assert st.degraded


# ---------------------------------------------------------------------------
# the checksum column
# ---------------------------------------------------------------------------
class TestChecksum:
    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("differential", (False, True))
    def test_column_matches_scalar_recompute_and_reference(self, fmt,
                                                           differential):
        ra, ta = _pair(fmt, differential=differential)
        np.testing.assert_array_equal(ta.checksums,
                                      tval.expected_checksums(ta))
        np.testing.assert_array_equal(np_u32(ta.checksums),
                                      np_u32(rval.expected_checksums(ra)))

    @pytest.mark.parametrize("fmt", FORMATS)
    @pytest.mark.parametrize("plan", ("torch", "cuda", "unfused"))
    def test_checked_decode_bit_exact_with_unchecked(self, fmt, plan):
        ra, ta = _pair(fmt)
        grid = t_decode_checked(ta, plan=plan)
        assert isinstance(grid, torch.Tensor) and grid.device == ta.device
        assert torch.equal(grid, ta.decode_blocked(plan=plan))
        np.testing.assert_array_equal(
            np_u32(grid), np_u32(r_decode_checked(ra, plan="jnp")))

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_checksum_epilogue_fused_unfused_parity(self, fmt):
        _, ta = _pair(fmt)
        _, cs_f = dispatch.decode(ta, epilogue="checksum", plan="fused")
        _, cs_u = dispatch.decode(ta, epilogue="checksum", plan="unfused")
        assert torch.equal(cs_f, cs_u)
        np.testing.assert_array_equal(cs_f.reshape(-1).numpy(), ta.checksums)

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_take_and_slice_blocks_carry_checksums(self, fmt):
        _, ta = _pair(fmt, n=500, block_size=64)
        sub = ta.take_blocks(np.array([5, 1, 3]))
        np.testing.assert_array_equal(sub.checksums, ta.checksums[[5, 1, 3]])
        t_decode_checked(sub, plan="torch")  # still verifies
        sl = ta.slice_blocks(2, 6, pad_to=8)
        assert sl.checksums.shape[0] == 8
        assert not sl.checksums[4:].any()  # pad blocks -> 0
        t_decode_checked(sl, plan="torch")

    def test_decode_checked_requires_column(self):
        _, ta = _pair("vbyte", checksum=False)
        with pytest.raises(ValueError, match="checksum=True"):
            t_decode_checked(ta)

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_decode_check_true(self, fmt):
        ra, ta = _pair(fmt)
        np.testing.assert_array_equal(ta.decode(check=True), ta.decode())
        np.testing.assert_array_equal(ta.decode(check=True),
                                      ra.decode(check=True, plan="jnp"))
        bad = tfg.corrupt(ta, "checksum_corrupt", 0)
        rbad = rfg.corrupt(ra, "checksum_corrupt", 0)
        with pytest.raises(TChecksumError) as te:
            bad.arr.decode(check=True)
        with pytest.raises(RChecksumError) as re_:
            rbad.arr.decode(check=True, plan="jnp")
        _same_error(re_.value, te.value)

    def test_builder_threads_checksum_to_both_streams(self):
        rng = np.random.default_rng(0)
        docs = np.unique(rng.integers(0, 1 << 20, 400))
        tfs = {0: 1 + (np.arange(docs.size) % 5)}
        ri = r_build({0: docs}, tfs=tfs, n_docs=1 << 20, checksum=True)
        ti = t_build({0: docs}, tfs=tfs, n_docs=1 << 20, checksum=True,
                     device=CPU)
        for r, t in ((ri.terms[0].arr, ti.terms[0].arr),
                     (ri.terms[0].impacts, ti.terms[0].impacts)):
            assert t.checksums is not None
            np.testing.assert_array_equal(np_u32(r.checksums),
                                          np_u32(t.checksums))
            t_decode_checked(t, plan="torch")


# ---------------------------------------------------------------------------
# the hardened SearchEngine against the reference engine's answers
# ---------------------------------------------------------------------------
SERVE_KEYS = ("errors", "retries", "quarantined_terms", "quarantined_blocks",
              "bound_fallbacks", "degraded_responses")
STAT_KEYS = ("errors", "retries", "quarantined_blocks", "bound_fallbacks",
             "degraded", "degraded_reasons", "blocks_decoded",
             "blocks_skipped", "blocks_pruned", "ints_decoded")


@pytest.fixture(scope="module")
def engine_indexes():
    rng = np.random.default_rng(1)
    lists = {t: np.unique(rng.integers(0, 1 << 18, 400)) for t in range(8)}
    tfs = {t: 1 + (np.arange(len(v)) % 5) for t, v in lists.items()}
    return (r_build(lists, tfs=tfs, n_docs=1 << 18, checksum=True),
            t_build(lists, tfs=tfs, n_docs=1 << 18, checksum=True,
                    device=CPU))


def _engines(ri, ti, **kw):
    return (RSearchEngine(ri, plan="jnp", **kw),
            TSearchEngine(ti, device=CPU, **kw))


def _same_answer(r, t, what=""):
    r = r if isinstance(r, tuple) else (r,)
    t = t if isinstance(t, tuple) else (t,)
    assert len(r) == len(t), what
    for x, y in zip(r, t):
        x = np.asarray(x)
        assert x.dtype == y.dtype, what
        np.testing.assert_array_equal(x, y, err_msg=what)


def _search_both(reng, teng, terms, mode):
    rst, tst = RStats(), TStats()
    r = reng.search(terms, mode, stats=rst)
    t = teng.search(terms, mode, stats=tst)
    _same_answer(r, t, f"{mode} {terms}")
    for k in STAT_KEYS:
        assert getattr(rst, k) == getattr(tst, k), k
    return t, tst


def _same_engine_state(reng, teng):
    assert {k: reng.serve_stats[k] for k in SERVE_KEYS} == \
        {k: teng.serve_stats[k] for k in SERVE_KEYS}
    assert set(reng.quarantined) == set(teng.quarantined)
    assert reng.bound_unsafe == teng.bound_unsafe
    assert reng.dead_shards == teng.dead_shards


class TestHardenedEngine:
    def test_transient_fault_retried_to_exact_result(self, engine_indexes):
        def hook(err):
            def fn(attempt, terms, mode):
                if attempt == 0:
                    raise err("injected", format="vbyte", block=0)
            return fn

        ri, ti = engine_indexes
        reng = RSearchEngine(ri, plan="jnp", fault_hook=hook(RChecksumError),
                             max_retries=2)
        teng = TSearchEngine(ti, device=CPU, fault_hook=hook(TChecksumError),
                             max_retries=2)
        out, st = _search_both(reng, teng, [0, 1], "topk_maxscore")
        _same_answer(out, TSearchEngine(ti, device=CPU).search(
            [0, 1], "topk_maxscore"))
        assert st.retries == 1 and st.errors == 1 and not st.degraded
        _same_engine_state(reng, teng)

    def test_retries_exhausted_degrades_never_hangs(self, engine_indexes):
        def hook(err):
            def fn(attempt, terms, mode):
                raise err("persistent")
            return fn

        ri, ti = engine_indexes
        reng = RSearchEngine(ri, plan="jnp", fault_hook=hook(RChecksumError),
                             max_retries=2)
        teng = TSearchEngine(ti, device=CPU, fault_hook=hook(TChecksumError),
                             max_retries=2)
        out, st = _search_both(reng, teng, [0, 1], "or")
        assert out.size == 0
        assert st.degraded and "retries-exhausted" in st.degraded_reasons
        assert st.errors == 3 and st.retries == 2
        assert teng.serve_stats["degraded_responses"] == 1
        _same_engine_state(reng, teng)

    def test_term_coordinate_fault_quarantines_segment(self, engine_indexes):
        def hook(err):
            def fn(attempt, terms, mode):
                if 1 in terms:
                    raise err("bad segment", block=2, term=1)
            return fn

        ri, ti = engine_indexes
        reng = RSearchEngine(ri, plan="jnp", fault_hook=hook(RChecksumError))
        teng = TSearchEngine(ti, device=CPU, fault_hook=hook(TChecksumError))
        out, st = _search_both(reng, teng, [0, 1], "or")
        _same_answer(out, TSearchEngine(ti, device=CPU).search([0], "or"))
        assert 1 in teng.quarantined and st.degraded
        assert st.quarantined_blocks == 0  # charged at fault time, not twice
        _, st2 = _search_both(reng, teng, [1], "or")
        assert st2.degraded and st2.quarantined_blocks > 0
        _same_engine_state(reng, teng)

    def test_startup_validation_quarantines_corrupt_stream(self,
                                                           engine_indexes):
        ri, ti = engine_indexes
        indexes = []
        for index, fg in ((ri, rfg), (ti, tfg)):
            terms = dict(index.terms)
            bad = fg.corrupt(terms[2].arr, "bit_flip", 5)
            terms[2] = dataclasses.replace(terms[2], arr=bad.arr)
            indexes.append(dataclasses.replace(index, terms=terms))
        reng, teng = _engines(*indexes, validate=True)
        assert 2 in teng.quarantined and list(teng.quarantined) == [2]
        assert teng.quarantined[2] == reng.quarantined[2]
        assert teng.serve_stats["quarantined_blocks"] == \
            indexes[1].terms[2].n_blocks
        out, st = _search_both(reng, teng, [2, 3], "or")
        _same_answer(out, TSearchEngine(ti, device=CPU).search([3], "or"))
        assert st.degraded
        _same_engine_state(reng, teng)

    def test_unsafe_bound_forces_exact_taat_fallback(self, engine_indexes):
        ri, ti = engine_indexes
        indexes = []
        for index, fg in ((ri, rfg), (ti, tfg)):
            terms = dict(index.terms)
            terms[3] = fg.corrupt_max_impact(terms[3], 7)
            indexes.append(dataclasses.replace(index, terms=terms))
        reng, teng = _engines(*indexes, validate=True, deep_validate=True)
        assert 3 in teng.bound_unsafe and 3 not in teng.quarantined
        out, st = _search_both(reng, teng, [3, 4], "topk_maxscore")
        # the fallback answers from the SAME (bound-corrupt) index — exact
        # because TAAT never consults max_impact — matching the clean index
        _same_answer(out, TSearchEngine(ti, device=CPU).search([3, 4],
                                                                "topk"))
        assert st.bound_fallbacks == 1 and not st.degraded
        _same_engine_state(reng, teng)

    def test_dead_shard_partial_results_then_heal(self, engine_indexes):
        ri, ti = engine_indexes
        reng, teng = _engines(ri, ti, n_shards=4)
        assert reng.shards == teng.shards and reng.shard_of == teng.shard_of
        victim_terms = teng.term_order[slice(*teng.shards[1])]
        all_terms = list(ti.terms)
        clean, _ = _search_both(reng, teng, all_terms, "or")
        reng.kill_shard(1)
        teng.kill_shard(1)
        out, st = _search_both(reng, teng, all_terms, "or")
        assert st.degraded and any(r.startswith("dead-shard:")
                                   for r in st.degraded_reasons)
        assert np.isin(out, clean).all() and out.size < clean.size
        rplan, plan = reng.heal(), teng.heal()
        assert plan == rplan and len(plan) == 3 and not teng.dead_shards
        assert all(teng.shard_of[t] < 3 for t in victim_terms)
        assert teng.shard_of == reng.shard_of
        healed, st2 = _search_both(reng, teng, all_terms, "or")
        _same_answer(clean, healed)
        assert not st2.degraded
        _same_engine_state(reng, teng)

    def test_engine_deadline_budget_flags_response(self, engine_indexes):
        def ticking():
            t = {"v": 0.0}

            def clock():
                t["v"] += 0.3
                return t["v"]
            return clock

        ri, ti = engine_indexes
        reng = RSearchEngine(ri, plan="jnp", deadline_s=0.1, clock=ticking())
        teng = TSearchEngine(ti, device=CPU, deadline_s=0.1, clock=ticking())
        _, st = _search_both(reng, teng, [0, 1, 2], "or")
        assert st.degraded
        assert teng.serve_stats["degraded_responses"] == 1
        _same_engine_state(reng, teng)

    def test_stats_merge_aggregates_per_query(self):
        agg, one = TStats(), TStats()
        one.count(3, decoded=2, skipped=1, ints=10)
        one.mark_degraded("deadline:test")
        one.retries = 2
        agg.merge(one)
        agg.merge(one)
        assert agg.blocks_decoded == 4 and agg.retries == 4
        assert agg.degraded and agg.degraded_reasons == ["deadline:test"]

    def test_run_workload_robustness_fields_and_heartbeats(self,
                                                           engine_indexes):
        ri, ti = engine_indexes
        reng, teng = _engines(ri, ti, n_shards=4)
        teng.kill_shard(2)
        reng.kill_shard(2)
        qs = [("or", [0, 5]), ("topk", [1, 6]), ("and", [2, 3])]
        rs, ts = reng.run_workload(qs), teng.run_workload(qs)
        for k in ("errors", "retries", "degraded_responses",
                  "quarantined_terms", "quarantined_blocks",
                  "bound_fallbacks", "dead_shards", "n_results"):
            assert rs[k] == ts[k], k
        assert sorted(teng.detector.hosts) == ["shard0", "shard1", "shard3"]
        assert teng.detector.hosts["shard0"].step == 2


def test_degraded_smoke_matches_reference():
    rs = r_degraded(queries=12, group_k=6, n_lists=16, record=False)
    ts = t_degraded(queries=12, group_k=6, n_lists=16, device=CPU)
    for k in ("n_queries", "n_shards", "degraded_responses",
              "healed_shards") + SERVE_KEYS:
        assert rs[k] == ts[k], k


# ---------------------------------------------------------------------------
# SearchEngine over a LiveIndex-merged segment (format="auto"), both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def merged_segments(tmp_path_factory):
    """The index the ingestion path produces: the reference test's docs
    streamed into a LiveIndex of each package, merged into a
    ``format="auto"`` segment and reloaded from disk — ``(reference's,
    port's)``."""
    import os

    from repro.index import LiveIndex as RLive
    from repro.index.ingest import load_segment as r_load
    from repro_torch.index import LiveIndex as TLive
    from repro_torch.index.ingest import load_segment as t_load

    out = []
    for tag, mk, load in (("r", lambda d: RLive(d, n_docs=1 << 16,
                                                fsync=False, plan="jnp"),
                           r_load),
                          ("t", lambda d: TLive(d, n_docs=1 << 16,
                                                fsync=False, device=CPU),
                           lambda seg: t_load(seg, device=CPU))):
        d = str(tmp_path_factory.mktemp("live") / tag)
        rng = np.random.default_rng(4)
        live = mk(d)
        for doc in np.unique(rng.integers(0, 1 << 16, 500)):
            live.add(int(doc), {int(t): int(rng.integers(1, 5))
                                for t in rng.choice(8, rng.integers(1, 4),
                                                    replace=False)})
        live.merge()
        seg = os.path.join(d, "segments", sorted(os.listdir(
            os.path.join(d, "segments")))[0])
        index, _tfs, _docs = load(seg)
        live.close()
        out.append(index)
    return tuple(out)


class TestEngineOnMergedSegment:
    def test_startup_validation_passes_clean_merged_segment(
            self, merged_segments):
        ri, ti = merged_segments
        assert ti.format == "auto"
        fmts = {tp.arr.format for tp in ti.terms.values()}
        assert fmts and fmts <= set(FORMATS)
        assert fmts == {tp.arr.format for tp in ri.terms.values()}
        reng, teng = _engines(ri, ti, validate=True, deep_validate=True)
        assert not teng.quarantined and not teng.bound_unsafe
        _same_engine_state(reng, teng)
        out, st = _search_both(reng, teng, [0, 1, 2], "topk_maxscore")
        from repro_torch.index import topk as t_topk
        for a, b in zip(out, t_topk(ti, [0, 1, 2], 10, mode="or")):
            np.testing.assert_array_equal(a, b)
        assert not st.degraded

    def test_startup_quarantine_on_corrupt_merged_term(self,
                                                       merged_segments):
        ri, ti = merged_segments
        rterms, tterms = dict(ri.terms), dict(ti.terms)
        rbad = rfg.corrupt(rterms[5].arr, "bit_flip", 11)
        tbad = tfg.corrupt(tterms[5].arr, "bit_flip", 11)
        _same_leaves(rbad.arr, tbad.arr)
        rterms[5] = dataclasses.replace(rterms[5], arr=rbad.arr)
        tterms[5] = dataclasses.replace(tterms[5], arr=tbad.arr)
        reng, teng = _engines(dataclasses.replace(ri, terms=rterms),
                              dataclasses.replace(ti, terms=tterms),
                              validate=True)
        assert 5 in teng.quarantined
        _same_engine_state(reng, teng)
        out, st = _search_both(reng, teng, [5, 6], "or")
        np.testing.assert_array_equal(
            out, TSearchEngine(ti, device=CPU).search([6], "or"))
        assert st.degraded

    def test_heal_after_shard_loss_on_merged_segment(self, merged_segments):
        ri, ti = merged_segments
        reng, teng = _engines(ri, ti, n_shards=3)
        all_terms = list(ti.terms)
        clean, _ = _search_both(reng, teng, all_terms, "or")
        reng.kill_shard(0)
        teng.kill_shard(0)
        partial, st = _search_both(reng, teng, all_terms, "or")
        assert st.degraded and partial.size < clean.size
        reng.heal()
        teng.heal()
        assert not teng.dead_shards
        healed, _ = _search_both(reng, teng, all_terms, "or")
        np.testing.assert_array_equal(healed, clean)
