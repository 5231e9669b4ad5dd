"""Card-only tests: each hand-written CUDA kernel against its plain torch
version on the same device tensors — bit for bit for every integer
output; within one bf16 ulp (bf16 tables) or 1e-5 (f32 tables) for
kernel 2's float epilogues ``bag_sum`` and ``dot_score``, whose sums run
in another order than the plain version's — plus the launch counters,
the wrappers' refusals and the serving paths. Marked ``cuda``; they skip
where no card is present. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import CompressedIntArray
from repro_torch.core.vbyte import binpack as bpk
from repro_torch.core.vbyte import binpack_masked
from repro_torch.core.vbyte import encode as venc
from repro_torch.core.vbyte import stream_masked
from repro_torch.core.vbyte import stream_vbyte as svb
from repro_torch.core.vbyte.masked import decode_blocked as decode_plain
from repro_torch.index import build_index
from repro_torch.kernels.vbyte_decode import (binpack_kernel, epilogues,
                                              kernel, stream_kernel)
from repro_torch.kernels.vbyte_decode.ops import normalize_probe
from repro_torch.launch.serve import SearchEngine, search_queries

from torch_parity import (bf16_ulps, float_close, probe_rows, probe_set,
                          probe_weights)

pytestmark = pytest.mark.cuda

EPILOGUES = ("stream", "checksum", "membership", "membership_rows",
             "bm25_accum", "bm25_accum_rows", "bm25_weighted",
             "bm25_weighted_rows")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ragged(rng, n_blocks, B, max_bits):
    """Ragged blocks (count-0 and partial ones), every byte length up to
    ``max_bits``, random bases."""
    lists = []
    for i in range(n_blocks):
        n = 0 if i % 7 == 0 else int(rng.integers(1, B + 1))
        bits = int(rng.integers(1, max_bits + 1))
        lists.append(rng.integers(0, 2**bits, size=n, dtype=np.uint64))
    enc = venc.encode_ragged_blocked(lists, block_size=B)
    bases = rng.integers(0, 2**32, size=n_blocks, dtype=np.uint64)
    return enc, bases.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("B,max_bits", [(128, 7), (128, 32), (32, 32)])
@pytest.mark.parametrize("differential", [False, True])
def test_kernel1_matches_plain(dev, B, max_bits, differential):
    rng = np.random.default_rng(B + max_bits)
    enc, bases = _ragged(rng, 1001, B, max_bits)
    p = torch.as_tensor(enc.payload, device=dev)
    c = torch.as_tensor(enc.counts, device=dev)
    b = torch.as_tensor(bases, device=dev)
    before = kernel.launches.count
    out = kernel.vbyte_decode_blocked_cuda(p, c, b, block_size=B,
                                           differential=differential)
    assert kernel.launches.count == before + 1
    ref = decode_plain(p, c, b, block_size=B, differential=differential)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_kernel1_garbage_bytes_match_plain(dev):
    rng = np.random.default_rng(3)
    p = torch.as_tensor(rng.integers(0, 256, (513, 256), dtype=np.uint8),
                        device=dev)
    c = torch.as_tensor(rng.integers(-2, 140, 513).astype(np.int32), device=dev)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, 513).astype(np.int32),
                        device=dev)
    for differential in (False, True):
        out = kernel.vbyte_decode_blocked_cuda(p, c, b, block_size=128,
                                               differential=differential)
        assert torch.equal(out, decode_plain(p, c, b, block_size=128,
                                             differential=differential))


@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_kernel2_matches_plain(dev, epilogue, differential):
    rng = np.random.default_rng(11)
    B = 128
    enc, bases = _ragged(rng, 777, B, 21)
    w_enc = venc.encode_ragged_blocked(
        [rng.integers(1, 2**12, size=int(c), dtype=np.uint64)
         for c in enc.counts], block_size=B)
    ops = {"payload": torch.as_tensor(enc.payload, device=dev),
           "counts": torch.as_tensor(enc.counts, device=dev),
           "bases": torch.as_tensor(bases, device=dev)}
    grid = decode_plain(ops["payload"], ops["counts"], ops["bases"],
                        block_size=B, differential=differential).cpu().numpy()
    valid = grid[np.arange(B)[None, :] < enc.counts[:, None]]
    probe = normalize_probe(np.unique(np.concatenate(
        [rng.choice(valid[valid >= 0], 200), rng.integers(0, 2**21, 56)])), 512)
    rows = np.where(rng.random((777, 1)) < 0.3, -1,
                    grid[np.arange(777), rng.integers(0, B, 777)][:, None])
    extras = {"probe": probe, "rows": rows.astype(np.int32),
              "impact": np.array([[9]], np.int32), "w_payload": w_enc.payload}
    ep = epilogues.EPILOGUES[epilogue]
    ex = {}
    for k in ep.extras + (("w_payload",) if "weighted" in epilogue else ()):
        src = extras["rows"] if (k == "probe" and "probe" in ep.tiled_extras) \
            else extras[k]
        ex[k] = torch.as_tensor(src, device=dev)
    _kernel2_matches_plain(ops, ex, "vbyte", epilogue, B, differential)


def _kernel2_matches_plain(ops, ex, fmt, epilogue, B, differential):
    before = epilogues.launches.count
    out = epilogues.fused_decode(ops, ex, format=fmt, epilogue=epilogue,
                                 block_size=B, differential=differential)
    assert epilogues.launches.count == before + 1
    assert epilogues.launches.by.get(f"{fmt}/{epilogue}", 0) > 0
    ref = epilogues.fused_decode_plain(ops, ex, format=fmt, epilogue=epilogue,
                                       block_size=B, differential=differential)
    torch.cuda.synchronize()
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert o.shape == r.shape and torch.equal(o, r), (fmt, epilogue)


def _format_stream(rng, fmt, n_blocks, B, max_bits, dev):
    """Ragged blocks of ``fmt`` on the card, count-0 blocks included, every
    svb byte length / binpack width up to ``max_bits``, random bases."""
    lists = []
    for i in range(n_blocks):
        n = 0 if i % 7 == 0 else int(rng.integers(1, B + 1))
        bits = int(rng.integers(0, max_bits + 1))
        lists.append(rng.integers(0, 2**bits, size=n, dtype=np.uint64))
    enc = {"streamvbyte": svb, "binpack": bpk}[fmt].encode_ragged_blocked(
        lists, block_size=B)
    ops = {k: torch.as_tensor(np.ascontiguousarray(getattr(enc, k)),
                              device=dev)
           for k in epilogues.FORMAT_OPERANDS[fmt] + ("counts",)}
    ops["bases"] = torch.as_tensor(
        rng.integers(-2**31, 2**31, n_blocks).astype(np.int32), device=dev)
    return ops, lists


KERNELS = {"streamvbyte": (stream_kernel, stream_kernel.stream_decode_blocked_cuda,
                           stream_masked.decode_blocked),
           "binpack": (binpack_kernel, binpack_kernel.binpack_decode_blocked_cuda,
                       binpack_masked.decode_blocked)}


@pytest.mark.parametrize("fmt", ["streamvbyte", "binpack"])
@pytest.mark.parametrize("B", [32, 128, 1024])
@pytest.mark.parametrize("differential", [False, True])
def test_kernels3_4_match_plain(dev, fmt, B, differential):
    rng = np.random.default_rng(B + len(fmt))
    ops, _ = _format_stream(rng, fmt, 1001, B, 32, dev)
    mod, launch, plain = KERNELS[fmt]
    leaves = [ops[k] for k in epilogues.FORMAT_OPERANDS[fmt]]
    before = mod.launches.count
    out = launch(*leaves, ops["counts"], ops["bases"], block_size=B,
                 differential=differential)
    assert mod.launches.count == before + 1
    ref = plain(*leaves, ops["counts"], ops["bases"], block_size=B,
                differential=differential)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("fmt", ["streamvbyte", "binpack"])
def test_kernels3_4_garbage_match_plain(dev, fmt):
    """Garbage control bytes whose lengths run past the row, garbage widths
    up to 255, counts below 0 and past B: the kernels give their plain
    versions' (the reference Pallas kernels') values."""
    rng = np.random.default_rng(5)
    nb, B = 513, 128
    data = torch.as_tensor(rng.integers(0, 256, (nb, 96), dtype=np.uint8),
                           device=dev)
    meta = (rng.integers(0, 256, (nb, B // 4), dtype=np.uint8)
            if fmt == "streamvbyte"
            else rng.integers(0, 256, (nb, 1), dtype=np.uint8))
    meta[:8] = 0xFF if fmt == "streamvbyte" else 32
    meta = torch.as_tensor(meta, device=dev)
    c = torch.as_tensor(rng.integers(-2, 140, nb).astype(np.int32), device=dev)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, nb).astype(np.int32),
                        device=dev)
    _, launch, plain = KERNELS[fmt]
    for differential in (False, True):
        out = launch(meta, data, c, b, block_size=B,
                     differential=differential)
        assert torch.equal(out, plain(meta, data, c, b, block_size=B,
                                      differential=differential))


@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("fmt", ["streamvbyte", "binpack"])
def test_kernel2_new_cores_match_plain(dev, fmt, epilogue, differential):
    """Kernel 2's streamvbyte and binpack cores, with a weight stream in
    each of the three formats for the weighted epilogues."""
    rng = np.random.default_rng(13)
    B = 128
    ops, lists = _format_stream(rng, fmt, 777, B, 21, dev)
    grid = epilogues.fused_decode_plain(
        ops, {}, format=fmt, epilogue="stream", block_size=B,
        differential=differential).cpu().numpy()
    counts = ops["counts"].cpu().numpy()
    valid = grid[np.arange(B)[None, :] < counts[:, None]]
    probe = normalize_probe(np.unique(np.concatenate(
        [rng.choice(valid[valid >= 0], 200), rng.integers(0, 2**21, 56)])), 512)
    rows = np.where(rng.random((777, 1)) < 0.3, -1,
                    grid[np.arange(777), rng.integers(0, B, 777)][:, None])
    ep = epilogues.EPILOGUES[epilogue]
    ex = {}
    if "probe" in ep.extras:
        ex["probe"] = torch.as_tensor(
            rows.astype(np.int32) if "probe" in ep.tiled_extras else probe,
            device=dev)
    if "impact" in ep.extras:
        ex["impact"] = torch.tensor([[9]], dtype=torch.int32, device=dev)
    w_formats = ("vbyte", "streamvbyte", "binpack") if "weighted" in epilogue \
        else (None,)
    for w_fmt in w_formats:
        w_ex = {}
        if w_fmt is not None:
            w_arr = CompressedIntArray.encode_ragged(
                [rng.integers(1, 2**12, size=len(l), dtype=np.uint64)
                 for l in lists], format=w_fmt, block_size=B, device=dev)
            w_ex = {f"w_{k}": v for k, v in w_arr.device_operands().items()
                    if k not in ("counts", "bases")}
        _kernel2_matches_plain(ops, {**ex, **w_ex}, fmt, epilogue, B,
                               differential)


@pytest.mark.parametrize("fmt", ["streamvbyte", "binpack"])
def test_kernel2_new_cores_garbage_match_plain(dev, fmt):
    rng = np.random.default_rng(6)
    nb, B = 257, 128
    data = torch.as_tensor(rng.integers(0, 256, (nb, 64), dtype=np.uint8),
                           device=dev)
    meta = torch.as_tensor(
        rng.integers(0, 256, (nb, B // 4 if fmt == "streamvbyte" else 1),
                     dtype=np.uint8), device=dev)
    ops = {epilogues.FORMAT_OPERANDS[fmt][0]: meta, "data": data,
           "counts": torch.as_tensor(rng.integers(-2, 140, nb).astype(np.int32),
                                     device=dev),
           "bases": torch.as_tensor(rng.integers(-2**31, 2**31, nb).astype(
               np.int32), device=dev)}
    w_ex = {"w_widths": torch.as_tensor(rng.integers(0, 256, (nb, 1),
                                                     dtype=np.uint8), device=dev),
            "w_data": data.flip(0).contiguous()}
    probe = torch.as_tensor(rng.integers(-1, 2**31, (nb, 1)).astype(np.int32),
                            device=dev)
    for epilogue, ex in (("checksum", {}),
                         ("bm25_weighted_rows", {"probe": probe, **w_ex})):
        for differential in (False, True):
            _kernel2_matches_plain(ops, ex, fmt, epilogue, B, differential)


# (blocks, probe width P, probe set): 1 and 5 blocks take a CTA of 4 warps
# each, 777 a warp each; P % 4 == 0 stores 4 outputs at a time
BROADCAST_CASES = [(1, 1, "sorted"), (5, 3, "sorted"), (777, 33, "neg_middle"),
                   (5, 512, "sorted"), (777, 512, "sorted"),
                   (1, 4096, "sorted"), (777, 4096, "unsorted"),
                   (5, 33, "all_neg")]
ENCODERS = {"vbyte": venc, "streamvbyte": svb, "binpack": bpk}


@pytest.mark.parametrize("nb,P,probe_kind", BROADCAST_CASES)
@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("epilogue", ["membership", "bm25_accum",
                                      "bm25_weighted"])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernel2_broadcast_branches_match_plain(dev, fmt, epilogue,
                                                differential, nb, P,
                                                probe_kind):
    """Kernel 2's broadcast epilogues on both of their branches: blocks of
    ascending docids with repeats (gap 0) take the sorted search where the
    probe set is sorted; blocks that wrap mod 2^32 partway, garbage blocks
    and every block under an unsorted probe set compare slot by slot.
    Values >= 2^31 and count-0 blocks in every case; the same values
    decode from d-gaps (differential) and as stored."""
    rng = np.random.default_rng(nb * 31 + P + 7 * len(fmt + epilogue))
    B = 128
    bases, gaps, vals = probe_rows(rng, nb, B)
    enc = ENCODERS[fmt].encode_ragged_blocked(gaps if differential else vals,
                                              block_size=B)
    ops = {k: torch.as_tensor(np.ascontiguousarray(getattr(enc, k)),
                              device=dev)
           for k in epilogues.FORMAT_OPERANDS[fmt] + ("counts",)}
    ops["bases"] = torch.as_tensor(bases.astype(np.uint32).view(np.int32),
                                   device=dev)
    grid = epilogues.fused_decode_plain(
        ops, {}, format=fmt, epilogue="stream", block_size=B,
        differential=differential).cpu().numpy()
    for t, v in enumerate(vals):  # the plain decode gives the rows' values
        assert np.array_equal(grid[t, :v.size].view(np.uint32), v)
    ex = {"probe": torch.as_tensor(probe_set(rng, probe_kind, grid,
                                             enc.counts, P), device=dev)}
    if epilogue == "bm25_accum":
        ex["impact"] = torch.tensor([[9]], dtype=torch.int32, device=dev)
    if epilogue == "bm25_weighted":
        w_fmt = ("vbyte", "streamvbyte", "binpack")[nb % 3]
        w_arr = CompressedIntArray.encode_ragged(
            probe_weights(rng, enc.counts), format=w_fmt, block_size=B,
            device=dev)
        ex.update({f"w_{k}": v for k, v in w_arr.device_operands().items()
                   if k not in ("counts", "bases")})
    _kernel2_matches_plain(ops, ex, fmt, epilogue, B, differential)


@pytest.mark.parametrize("pad", [3, 99_999])
@pytest.mark.parametrize("nb", [5, 777])
def test_kernel2_broadcast_odd_and_wide_strides_match_plain(dev, nb, pad):
    """Rows ``pad`` bytes wider than encoded: a stride that is not a
    multiple of 4 (copied to shared memory a byte at a time), or rows too
    wide to copy there at all (read from device memory). The same values
    as the plain version."""
    rng = np.random.default_rng(nb + pad)
    B = 128
    bases, gaps, vals = probe_rows(rng, nb, B)
    enc = venc.encode_ragged_blocked(gaps, block_size=B)
    w_enc = venc.encode_ragged_blocked(probe_weights(rng, enc.counts),
                                       block_size=B)

    def widen(payload):
        return torch.as_tensor(np.pad(payload, ((0, 0), (0, pad))),
                               device=dev)

    ops = {"payload": widen(enc.payload),
           "counts": torch.as_tensor(enc.counts, device=dev),
           "bases": torch.as_tensor(bases.astype(np.uint32).view(np.int32),
                                    device=dev)}
    grid = epilogues.fused_decode_plain(
        ops, {}, format="vbyte", epilogue="stream", block_size=B,
        differential=True).cpu().numpy()
    probe = torch.as_tensor(probe_set(rng, "sorted", grid, enc.counts, 512),
                            device=dev)
    for epilogue, ex in (("membership", {"probe": probe}),
                         ("bm25_weighted", {"probe": probe,
                                            "w_payload": widen(w_enc.payload)})):
        _kernel2_matches_plain(ops, ex, "vbyte", epilogue, B, True)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    arr = CompressedIntArray.encode(np.arange(300, dtype=np.uint64) * 7,
                                    differential=True, device=dev)
    ops = arr.device_operands()
    with pytest.raises(ValueError, match="contiguous"):
        kernel.vbyte_decode_blocked_cuda(
            ops["payload"].t().contiguous().t(), ops["counts"], ops["bases"],
            block_size=128, differential=True)
    with pytest.raises(ValueError, match="one device"):
        kernel.vbyte_decode_blocked_cuda(ops["payload"], ops["counts"].cpu(),
                                         ops["bases"], block_size=128,
                                         differential=True)
    with pytest.raises(ValueError, match="probe"):
        epilogues.fused_decode(ops, {"probe": torch.zeros(1, 8)},
                               format="vbyte", epilogue="membership",
                               block_size=128, differential=True)


@pytest.mark.parametrize("fmt", ["vbyte", "auto", "streamvbyte"])
def test_search_engine_kernels_match_torch_plan(dev, fmt):
    from repro_torch.data.synthetic import posting_list_group, posting_tfs

    rng = np.random.default_rng(0)
    lists = dict(enumerate(posting_list_group(rng, 10, 8, universe=1 << 20)))
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    index = build_index(lists, tfs=tfs, n_docs=1 << 20, format=fmt)
    qs = search_queries(rng, index, 20)
    cuda_eng = SearchEngine(index)
    torch_eng = SearchEngine(index, plan="torch")
    decode_mod = {"vbyte": kernel, "auto": binpack_kernel,
                  "streamvbyte": stream_kernel}[fmt]
    k0, f0 = decode_mod.launches.count, epilogues.launches.count
    for mode, terms in qs:
        a, b = cuda_eng.search(terms, mode), torch_eng.search(terms, mode)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    assert decode_mod.launches.count > k0 and epilogues.launches.count > f0


# ---------------------------------------------------------------------------
# kernel 2's gather and rebase epilogues
# ---------------------------------------------------------------------------
def _assert_float_close(out, ref, dtype, what, *, ops, extras, kw):
    """Within one bf16 ulp (bf16) or 1e-5 (f32) of the plain version, or,
    where a sum cancels towards 0, within the f32 sums' rounding bound
    (``torch_parity.float_close``)."""
    assert out.shape == ref.shape and out.dtype == ref.dtype, what
    name = kw["epilogue"]
    s_abs = epilogues.fused_decode_plain(
        ops, {k: v.abs() for k, v in extras.items()}, **kw)
    s_abs = s_abs[1] if name == "dot_score" else s_abs
    terms = extras["table"].shape[1] if name == "dot_score" else kw[
        "block_size"]
    assert float_close(out, ref, bf16=dtype == torch.bfloat16, terms=terms,
                       s_abs=s_abs), what


def _gather_case(dev, fmt, B, *, garbage, seed):
    """Ragged blocks of ``fmt`` (count-0 blocks, partial tails); with
    ``garbage`` the values span all of uint32, so ids run past V and below
    0 as int32 and must be clamped."""
    rng = np.random.default_rng(seed)
    ops, _ = _format_stream(rng, fmt, 777, B, 32 if garbage else 12, dev)
    return rng, ops


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 256), (torch.float32, 128),
                                     (torch.bfloat16, 36), (torch.float32, 100)])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernel2_gather_epilogues_match_plain(dev, fmt, dtype, d):
    """bag_sum and dot_score (one and eight query rows) on every core, both
    table types, vector (d·size % 16 == 0) and scalar row loads, with
    garbage ids, against their plain versions."""
    for garbage, differential in ((False, True), (True, False)):
        rng, ops = (_gather_case(dev, fmt, 128, garbage=garbage, seed=17)
                    if fmt != "vbyte" else (None, None))
        if fmt == "vbyte":
            rng = np.random.default_rng(17)
            enc, bases = _ragged(rng, 777, 128, 32 if garbage else 12)
            ops = {"payload": torch.as_tensor(enc.payload, device=dev),
                   "counts": torch.as_tensor(enc.counts, device=dev),
                   "bases": torch.as_tensor(bases, device=dev)}
        V = 5000
        table = (torch.randn(V, d, generator=torch.Generator().manual_seed(3))
                 .to(dtype).to(dev))
        q = torch.randn(8, d, generator=torch.Generator().manual_seed(4))
        for epilogue, ex in (("bag_sum", {"table": table}),
                             ("dot_score", {"table": table,
                                            "query": q[:1].to(dtype).to(dev)}),
                             ("dot_score", {"table": table,
                                            "query": q.to(dtype).to(dev)})):
            kw = dict(format=fmt, epilogue=epilogue, block_size=128,
                      differential=differential)
            before = epilogues.launches.count
            out = epilogues.fused_decode(ops, ex, **kw)
            assert epilogues.launches.count == before + 1
            ref = epilogues.fused_decode_plain(ops, ex, **kw)
            torch.cuda.synchronize()
            what = (fmt, epilogue, dtype, d, garbage)
            close = dict(ops=ops, extras=ex, kw=kw)
            if epilogue == "dot_score":
                assert torch.equal(out[0], ref[0]), what
                _assert_float_close(out[1], ref[1], dtype, what, **close)
            else:
                _assert_float_close(out, ref, dtype, what, **close)


def test_kernel2_dot_score_mixed_types_and_many_queries(dev):
    """An f32 query against a bf16 table scores in f32 (no bf16 rounding);
    20 query rows run in three register groups."""
    rng = np.random.default_rng(9)
    enc, bases = _ragged(rng, 300, 128, 14)
    ops = {"payload": torch.as_tensor(enc.payload, device=dev),
           "counts": torch.as_tensor(enc.counts, device=dev),
           "bases": torch.as_tensor(bases, device=dev)}
    table = torch.randn(20000, 64, device=dev).to(torch.bfloat16)
    for q in (torch.randn(3, 64, device=dev),
              torch.randn(20, 64, device=dev).to(torch.bfloat16)):
        kw = dict(format="vbyte", epilogue="dot_score", block_size=128,
                  differential=True)
        out = epilogues.fused_decode(ops, {"table": table, "query": q}, **kw)
        ref = epilogues.fused_decode_plain(ops, {"table": table, "query": q},
                                           **kw)
        torch.cuda.synchronize()
        assert torch.equal(out[0], ref[0])
        _assert_float_close(out[1], ref[1], q.dtype, q.dtype, ops=ops,
                            extras={"table": table, "query": q}, kw=kw)


# dot_score's kernel (dot_kernel): the tensor-core path (bf16 table and
# query), the f32 path (any other pair), every copy width of its ring
DOT_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16))
DOT_D = (16, 36, 64, 100, 128, 256, 264)
DOT_NQ = (1, 2, 3, 5, 8, 9, 16, 20)
DOT_V = 5000


def _dot_operands(dev, fmt, nb, B, *, seed, differential):
    """Ragged blocks of ``fmt`` (every 7th count 0). Not differential: ids
    drawn from [-40, V + 40) as uint32, so some lie below 0 and at or past
    V; differential: sorted ids in [0, V) plus a base per block in
    [-100, 100), so a few are clamped."""
    rng = np.random.default_rng(seed)
    lists = []
    for i in range(nb):
        n = 0 if i % 7 == 0 else int(rng.integers(1, B + 1))
        if differential:
            lists.append(np.sort(rng.integers(0, DOT_V, n)).astype(np.uint64))
        else:
            lists.append(rng.integers(-40, DOT_V + 40, n).astype(np.int64)
                         .astype(np.uint32).astype(np.uint64))
    enc = {"vbyte": venc, "streamvbyte": svb, "binpack": bpk}[fmt] \
        .encode_ragged_blocked(lists, block_size=B, differential=differential)
    ops = {k: torch.as_tensor(np.ascontiguousarray(getattr(enc, k)),
                              device=dev)
           for k in epilogues.FORMAT_OPERANDS[fmt] + ("counts",)}
    bases = (rng.integers(-100, 100, nb) if differential
             else np.zeros(nb)).astype(np.int32)
    ops["bases"] = torch.as_tensor(bases, device=dev)
    return ops


def _dot_table(dev, dtype, d, *, seed, offset=0, cancel=False):
    """``[V, d]`` on the card; ``offset`` elements into a larger buffer (so
    the rows are not 16-byte aligned); ``cancel``: the second half of each
    row is minus the first."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn(DOT_V * d + offset, generator=g)
    t = flat[offset:].view(DOT_V, d)
    if cancel:
        t[:, d - d // 2:] = -t[:, :d // 2]
    buf = flat.to(dtype).to(dev)
    return buf[offset:].view(DOT_V, d)


def _dot_query(dev, dtype, nq, d, *, seed, cancel=False):
    q = torch.randn(nq, d, generator=torch.Generator().manual_seed(seed))
    if cancel:  # halves equal: Σ x·q − Σ x·q
        q[:, d - d // 2:] = q[:, :d // 2]
    return q.to(dtype).to(dev)


def _dot_matches_plain(ops, table, query, fmt, B, differential, what):
    ex = {"table": table, "query": query}
    kw = dict(format=fmt, epilogue="dot_score", block_size=B,
              differential=differential)
    before = epilogues.launches.count
    ids, sc = epilogues.fused_decode(ops, ex, **kw)
    assert epilogues.launches.count == before + 1, what
    r_ids, r_sc = epilogues.fused_decode_plain(ops, ex, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ids, r_ids), what
    both_bf16 = table.dtype == query.dtype == torch.bfloat16
    _assert_float_close(sc, r_sc, torch.bfloat16 if both_bf16
                        else torch.float32, what, ops=ops, extras=ex, kw=kw)


@pytest.mark.parametrize("d", DOT_D)
@pytest.mark.parametrize("pair", DOT_PAIRS, ids=lambda p: "{}-{}".format(
    *(str(t).split(".")[-1] for t in p)))
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernel2_dot_score_types_widths_and_query_rows(dev, fmt, pair, d):
    """Every core, every pair of table and query types, widths that are and
    are not whole 16-byte chunks or 32-byte mma k-steps (264: two staged
    chunks), 1-20 query rows (several n-tiles and query groups), ids below
    0 and at or past V, count-0 blocks."""
    table_dt, query_dt = pair
    ops = _dot_operands(dev, fmt, 777, 128, seed=d, differential=False)
    table = _dot_table(dev, table_dt, d, seed=d)
    for nq in DOT_NQ:
        if nq * d > epilogues.MAX_QUERY_ELEMS:
            continue
        q = _dot_query(dev, query_dt, nq, d, seed=nq)
        _dot_matches_plain(ops, table, q, fmt, 128, False,
                           (fmt, pair, d, nq))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 36, 100, 256, 264])
def test_kernel2_dot_score_unaligned_table(dev, dtype, d):
    """A table view one element into its buffer: rows are not 16-byte
    aligned, so the ring is filled by 4-byte copies (f32) or 2-byte loads
    (bf16)."""
    ops = _dot_operands(dev, "vbyte", 300, 128, seed=5, differential=True)
    table = _dot_table(dev, dtype, d, seed=d, offset=1)
    assert table.is_contiguous() and table.data_ptr() % 16
    for nq in (1, 8, 9):
        q = _dot_query(dev, dtype, nq, d, seed=nq)
        _dot_matches_plain(ops, table, q, "vbyte", 128, True,
                           (dtype, d, nq))


@pytest.mark.parametrize("nb", [1, 7, 777, 8192])
@pytest.mark.parametrize("fmt,B", [("vbyte", 50), ("vbyte", 128),
                                   ("streamvbyte", 52), ("streamvbyte", 128),
                                   ("binpack", 50), ("binpack", 128)])
def test_kernel2_dot_score_blocks_and_block_sizes(dev, fmt, B, nb):
    """1 to 8192 blocks of B = 50 (a part tile; 52 for Stream VByte, whose
    blocks hold a multiple of 4) and 128, differential, both paths at the
    serving widths."""
    ops = _dot_operands(dev, fmt, nb, B, seed=nb + B, differential=True)
    for dtype, d in ((torch.bfloat16, 256), (torch.float32, 128)):
        table = _dot_table(dev, dtype, d, seed=1)
        for nq in (1, 8):
            q = _dot_query(dev, dtype, nq, d, seed=2)
            _dot_matches_plain(ops, table, q, fmt, B, True,
                               (fmt, B, nb, dtype, nq))


@pytest.mark.parametrize("pair", DOT_PAIRS, ids=lambda p: "{}-{}".format(
    *(str(t).split(".")[-1] for t in p)))
def test_kernel2_dot_score_cancelling_sums(dev, pair):
    """Rows and queries whose products sum to about 0: held by the f32
    sums' rounding bound, as the plain version's own order differs."""
    table_dt, query_dt = pair
    ops = _dot_operands(dev, "vbyte", 300, 128, seed=11, differential=False)
    for d in (64, 256, 264):
        table = _dot_table(dev, table_dt, d, seed=d, cancel=True)
        for nq in (1, 8, 9):
            q = _dot_query(dev, query_dt, nq, d, seed=nq, cancel=True)
            _dot_matches_plain(ops, table, q, "vbyte", 128, False,
                               (pair, d, nq))


def test_kernel2_bag_sum_block_50(dev):
    """The embedding-bag endpoint's layout: one bag per block of seq_len =
    50 slots (not a multiple of 32), ragged, vbyte, not differential."""
    rng = np.random.default_rng(50)
    bags = [np.sort(rng.choice(np.arange(1, 100000), int(n), replace=False))
            for n in rng.integers(0, 51, 333)]
    arr = CompressedIntArray.encode_ragged(bags, block_size=50, device=dev)
    table = torch.randn(100000, 128, device=dev).to(torch.bfloat16)
    kw = dict(format="vbyte", epilogue="bag_sum", block_size=50,
              differential=False)
    out = epilogues.fused_decode(arr.device_operands(), {"table": table}, **kw)
    ref = epilogues.fused_decode_plain(arr.device_operands(),
                                       {"table": table}, **kw)
    torch.cuda.synchronize()
    close = dict(ops=arr.device_operands(), extras={"table": table},
                 kw=kw)
    _assert_float_close(out, ref, torch.bfloat16, "B=50", **close)
    want = torch.stack([table[torch.as_tensor(b, device=dev)].float().sum(0)
                        if len(b) else torch.zeros(128, device=dev)
                        for b in bags]).to(torch.bfloat16)
    _assert_float_close(out, want, torch.bfloat16, "B=50 direct", **close)


@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernel2_adjacency_rebase_matches_plain(dev, fmt):
    rng = np.random.default_rng(19)
    if fmt == "vbyte":
        enc, bases = _ragged(rng, 777, 128, 32)
        ops = {"payload": torch.as_tensor(enc.payload, device=dev),
               "counts": torch.as_tensor(enc.counts, device=dev),
               "bases": torch.as_tensor(bases, device=dev)}
    else:
        _, ops = _gather_case(dev, fmt, 128, garbage=True, seed=19)
    eb = torch.as_tensor(rng.integers(-2**31, 2**31, (777, 128)).astype(
        np.int32), device=dev)
    kw = dict(format=fmt, epilogue="adjacency_rebase", block_size=128,
              differential=True)
    out = epilogues.fused_decode(ops, {"edge_base": eb}, **kw)
    ref = epilogues.fused_decode_plain(ops, {"edge_base": eb}, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_gather_wrappers_refuse_what_the_kernel_does_not_take(dev):
    arr = CompressedIntArray.encode(np.arange(300, dtype=np.uint64) * 7,
                                    differential=True, device=dev)
    ops = arr.device_operands()
    kw = dict(format="vbyte", block_size=128, differential=True)
    t16 = torch.zeros(10, 8, dtype=torch.float16, device=dev)
    with pytest.raises(ValueError, match="table"):
        epilogues.fused_decode(ops, {"table": t16}, epilogue="bag_sum", **kw)
    table = torch.zeros(10, 256, device=dev)
    with pytest.raises(ValueError, match="query rows"):
        epilogues.fused_decode(ops, {"table": table,
                                     "query": torch.zeros(33, 256, device=dev)},
                               epilogue="dot_score", **kw)
    with pytest.raises(ValueError, match="edge_base"):
        epilogues.fused_decode(ops, {"edge_base": torch.zeros(
            2, 128, dtype=torch.int32, device=dev)},
            epilogue="adjacency_rebase", **kw)


def test_serving_engine_kernels_match_torch_plan(dev):
    """The two-tower engine at a small config: every request's top-k and
    every bag through the kernels equal the plain torch plan's on the card
    (ids exactly where no score lies within one bf16 ulp of the k-th)."""
    import dataclasses

    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import recsys, registry

    cfg = dataclasses.replace(registry.reduced_config("two-tower-retrieval"),
                              n_items=50000, n_users=1000,
                              mlp_dims=(64, 32), seq_len=50)
    rng = np.random.default_rng(1)
    params = recsys.init_params(cfg, seed=1, device=dev)
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items), 20000,
                               replace=False)).astype(np.uint64)
    corpus = CompressedIntArray.encode(cands, differential=True, device=dev)
    eng = ServingEngine(params, cfg, corpus, device=dev)
    plain = ServingEngine(params, cfg, corpus, plan="torch", device=dev)
    reqs = [(int(rng.integers(1, 1000)),
             rng.integers(1, cfg.n_items, cfg.seq_len).astype(np.int32))
            for _ in range(21)]
    before = epilogues.launches.by.get("vbyte/dot_score", 0)
    a, b = [], []
    eng.run_workload(reqs, record=a)
    plain.run_workload(reqs, record=b)
    assert epilogues.launches.by["vbyte/dot_score"] - before == 3
    for (sa, ia), (sb, ib) in zip(a, b):
        assert bf16_ulps(sa, sb) <= 1  # rank by rank
        # an id of the plain top-k whose score is not within one ulp of the
        # k-th is in the kernels' top-k too
        near = (sb - sb[:, -1:]).abs() <= sb.abs() * 2.0**-7
        for r in range(ib.shape[0]):
            assert set(ib[r][~near[r]].tolist()) <= set(ia[r].tolist())
    bags = [np.sort(rng.choice(np.arange(1, cfg.n_items), int(n),
                               replace=False)) for n in (1, 50, 7, 0, 23)]
    # the mean rounds twice: the bf16 sum, then the division by the count
    s_abs = torch.stack([
        eng.bag_table[torch.as_tensor(bg.astype(np.int64), device=dev)]
        .float().abs().sum(0) / max(len(bg), 1) for bg in bags])
    assert float_close(eng.embed_bags(bags), plain.embed_bags(bags),
                       bf16=True, terms=cfg.seq_len, s_abs=s_abs, ulps=2)


def test_gin_compressed_edges_kernels_match_plain(dev):
    """decode_compressed_edges, fused (adjacency_rebase) and legacy, through
    the kernels equals the plain plan and the raw CSR bit for bit."""
    from repro_torch.data.graph import compress_adjacency
    from repro_torch.data.sampler import CSRGraph
    from repro_torch.data.synthetic import random_graph
    from repro_torch.nn.gnn import decode_compressed_edges

    rng = np.random.default_rng(2)
    g = random_graph(rng, 5000, 80000, 4, 3)
    csr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], 5000)
    comp = compress_adjacency(csr, device=dev)
    own = np.repeat(np.arange(5000), np.diff(csr.indptr))
    f0 = epilogues.launches.by.get("vbyte/adjacency_rebase", 0)
    for rgb in (comp["row_gap_bases"], None):
        outs = [decode_compressed_edges(comp["gaps"], comp["row_offsets"],
                                        csr.n_edges, row_gap_bases=rgb,
                                        plan=plan)
                for plan in ("auto", "torch")]
        for nbr, owner in outs:
            np.testing.assert_array_equal(nbr.cpu().numpy(), csr.indices)
            np.testing.assert_array_equal(owner.cpu().numpy(), own)
    assert epilogues.launches.by["vbyte/adjacency_rebase"] == f0 + 1


# ---------------------------------------------------------------------------
# dispatch.decode past kernel 2's shared-memory limits: split launches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", [4097, 8192])
@pytest.mark.parametrize("epilogue", ["membership", "bm25_accum",
                                      "bm25_weighted"])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_dispatch_serves_probe_sets_past_the_width(dev, fmt, epilogue, P):
    """Probe widths of 4,097 and 8,192 (``SearchEngine(probe_width=
    8192)``): two launches of kernel 2, equal bit for bit to the plain
    version on the whole probe set."""
    from repro_torch.kernels.vbyte_decode import dispatch

    rng = np.random.default_rng(P)
    docs = np.sort(rng.choice(2**24, 20000, replace=False)).astype(np.uint64)
    arr = CompressedIntArray.encode(docs, format=fmt, differential=True,
                                    device=dev)
    probe = np.unique(np.concatenate([rng.choice(docs, P // 2),
                                      rng.integers(0, 2**24, P // 3)]))
    ex = {"probe": torch.as_tensor(normalize_probe(probe[:P], P), device=dev)}
    if epilogue == "bm25_accum":
        ex["impact"] = torch.tensor([[3]], dtype=torch.int32, device=dev)
    if epilogue == "bm25_weighted":
        imp = CompressedIntArray.encode(
            rng.integers(1, 256, docs.size).astype(np.uint64), format=fmt,
            device=dev)
        ex.update({f"w_{k}": v for k, v in imp.device_operands().items()
                   if k not in ("counts", "bases")})
    before = epilogues.launches.by.get(f"{fmt}/{epilogue}", 0)
    out = dispatch.decode(arr, epilogue=epilogue, epilogue_operands=ex)
    assert epilogues.launches.by[f"{fmt}/{epilogue}"] == before + 2
    ref = epilogues.fused_decode_plain(
        arr.device_operands(), ex, format=fmt, epilogue=epilogue,
        block_size=arr.block_size, differential=True)
    torch.cuda.synchronize()
    assert out.shape == (arr.n_blocks, P) and torch.equal(out, ref)


@pytest.mark.parametrize("nq,d,fused,decodes", [(9, 1024, 2, 0),
                                                (1, 9000, 0, 1)])
def test_dispatch_serves_query_rows_past_the_limit(dev, nq, d, fused,
                                                   decodes):
    """9 bf16 query rows of d = 1,024: two launches of kernel 2 (8 rows
    fit); one row of d = 9,000: kernel 1, then the torch body (the
    unfused plan). Ids bit for bit, scores within one bf16 ulp."""
    from repro_torch.kernels.vbyte_decode import dispatch

    ops = _dot_operands(dev, "vbyte", 300, 128, seed=d, differential=True)
    table = _dot_table(dev, torch.bfloat16, d, seed=1)
    query = _dot_query(dev, torch.bfloat16, nq, d, seed=2)
    ex = {"table": table, "query": query}
    kw = dict(format="vbyte", block_size=128, differential=True)
    f0, k0 = epilogues.launches.by.get("vbyte/dot_score", 0), \
        kernel.launches.count
    ids, sc = dispatch.decode(ops, epilogue="dot_score",
                              epilogue_operands=ex, **kw)
    assert epilogues.launches.by.get("vbyte/dot_score", 0) == f0 + fused
    assert kernel.launches.count == k0 + decodes
    r_ids, r_sc = epilogues.fused_decode_plain(ops, ex, epilogue="dot_score",
                                               **kw)
    torch.cuda.synchronize()
    assert torch.equal(ids, r_ids)
    _assert_float_close(sc, r_sc, torch.bfloat16, (nq, d), ops=ops,
                        extras=ex, kw=dict(kw, epilogue="dot_score"))


# ---------------------------------------------------------------------------
# owner_sum (GIN's aggregation): bit for bit against its plain version
# ---------------------------------------------------------------------------
def _owner_case(rng, n_owners, degrees, n_rows, d, dtype, *, masked=False,
                offset=0):
    """CSR edges (``degrees`` per owner), rows of normals scaled by e^±8 at
    ``offset`` rows into a buffer, on the CPU."""
    ro = torch.tensor(np.concatenate([[0], np.cumsum(degrees)]),
                      dtype=torch.int32)
    E = int(ro[-1])
    buf = torch.tensor((rng.standard_normal((n_rows + offset, d))
                        * np.exp(rng.uniform(-8, 8, (n_rows + offset, 1))))
                       .astype(np.float32)).to(dtype)
    src = torch.tensor(rng.integers(0, n_rows, E).astype(np.int32))
    valid = torch.tensor(rng.random(E) < 0.8) if masked else None
    return buf[offset:], src, ro, valid


def _owner_sum_matches_plain(dev, h, src, ro, valid, acc):
    from repro_torch.kernels.segment_sum import (launches, owner_sum,
                                                 owner_sum_plain, segments)

    before = launches.count
    out = owner_sum(h.to(dev), src.to(dev), segments(ro.to(dev)),
                    None if valid is None else valid.to(dev), accumulate=acc)
    assert launches.count > before
    ref = owner_sum_plain(h, src, ro, valid, accumulate=acc)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(out.cpu().view(torch.int16 if acc == torch.bfloat16
                                      else torch.int32),
                       ref.view(torch.int16 if acc == torch.bfloat16
                                else torch.int32))
    return out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [1, 7, 8, 64, 100, 130])
@pytest.mark.parametrize("h_dtype,acc", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
def test_owner_sum_matches_plain(dev, h_dtype, acc, d, masked):
    """Skewed degrees (owners without edges, short ones, and some past
    LONG_ROW that take a CTA each), every row width's unit size."""
    rng = np.random.default_rng(d + 7 * masked)
    deg = np.minimum((3000 * np.arange(1, 301, dtype=np.float64) ** -1.1)
                     .astype(np.int64), 3000)
    deg[rng.random(300) < 0.2] = 0
    h, src, ro, valid = _owner_case(rng, 300, rng.permutation(deg), 500, d,
                                    h_dtype, masked=masked)
    _owner_sum_matches_plain(dev, h, src, ro, valid, acc)


@pytest.mark.parametrize("acc", [torch.float32, torch.bfloat16])
def test_owner_sum_one_owner_of_1e5_edges(dev, acc):
    rng = np.random.default_rng(5)
    deg = np.array([3, 0, 100_000, 7, 600, 1])
    h, src, ro, valid = _owner_case(rng, 6, deg, 4000, 64, torch.bfloat16,
                                    masked=True)
    _owner_sum_matches_plain(dev, h, src, ro, valid, acc)


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 100, 1100])
def test_owner_sum_h_at_odd_row_offset(dev, h_dtype, d):
    """h a view one row into its buffer (rows off their 16-byte alignment
    where d·size is not a multiple of 16), and d = 1,100 (more than 256
    units: two launches over column slices)."""
    rng = np.random.default_rng(d)
    deg = rng.integers(0, 900, 40)
    h, src, ro, valid = _owner_case(rng, 40, deg, 300, d, h_dtype, offset=1)
    _owner_sum_matches_plain(dev, h, src, ro, valid, torch.float32)


def test_owner_sum_is_the_same_on_every_run(dev):
    from repro_torch.kernels.segment_sum import owner_sum, segments

    rng = np.random.default_rng(6)
    deg = (20000 * np.arange(1, 2001, dtype=np.float64) ** -0.8).astype(int)
    h, src, ro, valid = _owner_case(rng, 2000, deg, 3000, 100,
                                    torch.bfloat16)
    seg = segments(ro.to(dev))
    outs = [owner_sum(h.to(dev), src.to(dev), seg) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_gin_forward_on_the_card_is_reproducible_and_exact(dev):
    """Two forwards give the same bits (owner_sum: no atomics), and the
    compressed adjacency gives the same logits as raw edges in CSR order
    (the same edges summed in the same order). Raw edges in another order
    sum each owner's messages in that order: within 2^-4 of each node's
    largest logit."""
    import dataclasses

    from repro_torch.data.graph import compress_adjacency
    from repro_torch.data.sampler import CSRGraph
    from repro_torch.data.synthetic import random_graph
    from repro_torch.kernels import segment_sum
    from repro_torch.models import gnn, registry

    rng = np.random.default_rng(3)
    n, e = 4000, 60000
    g = random_graph(rng, n, e, 100, 7)
    csr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n)
    cfg = dataclasses.replace(registry.reduced_config("gin-tu"), d_feat=100,
                              n_classes=7, compressed_adjacency=True)
    params = gnn.init_params(cfg, seed=0, device=dev)
    comp = compress_adjacency(csr, device=dev)
    feats = torch.as_tensor(g["feats"], device=dev)
    labels = torch.as_tensor(g["labels"], device=dev)
    batch = {"feats": feats, "labels": labels,
             **{k: v for k, v in comp.items() if not k.startswith("_")}}
    before = segment_sum.launches.count
    with torch.inference_mode():
        a = gnn.forward(params, batch, cfg)
        b = gnn.forward(params, batch, cfg)
    assert segment_sum.launches.count - before == 2 * cfg.n_layers
    assert torch.equal(a, b)
    perm = rng.permutation(e)  # raw edges in another order
    raw = {"feats": feats, "labels": labels,
           "edge_src": torch.as_tensor(g["edge_src"][perm], device=dev),
           "edge_dst": torch.as_tensor(g["edge_dst"][perm], device=dev)}
    with torch.inference_mode():
        c = gnn.forward(params, raw, dataclasses.replace(
            cfg, compressed_adjacency=False))
    order = np.lexsort((g["edge_src"], g["edge_dst"]))
    raw_csr = {**raw, "edge_src": torch.as_tensor(g["edge_src"][order],
                                                  device=dev),
               "edge_dst": torch.as_tensor(g["edge_dst"][order], device=dev)}
    with torch.inference_mode():
        r = gnn.forward(params, raw_csr, dataclasses.replace(
            cfg, compressed_adjacency=False))
    assert torch.equal(a, r)
    scale = r.abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    assert float(((c - r).abs() / scale).max()) <= 2.0**-4


# ---------------------------------------------------------------------------
# kernels 1, 3 and 4 and kernel 2's row-aligned kernel: staged rows, every
# layout, bit for bit
# ---------------------------------------------------------------------------
STAGED_ENCODERS = {"vbyte": venc, "streamvbyte": svb, "binpack": bpk}


def _ragged_fmt(rng, fmt, nb, B, max_bits):
    lists = []
    for i in range(nb):
        n = 0 if i % 7 == 0 else int(rng.integers(1, B + 1))
        bits = int(rng.integers(0 if fmt == "binpack" else 1, max_bits + 1))
        lists.append(rng.integers(0, 2**bits, size=n, dtype=np.uint64))
    enc = STAGED_ENCODERS[fmt].encode_ragged_blocked(lists, block_size=B)
    if fmt == "vbyte":
        return enc.payload, None, enc.counts
    meta = enc.control if fmt == "streamvbyte" else enc.widths.reshape(nb, 1)
    return enc.data, meta, enc.counts


DECODERS = {"vbyte": (kernel, kernel.vbyte_decode_blocked_cuda, decode_plain),
            "streamvbyte": (stream_kernel,
                            stream_kernel.stream_decode_blocked_cuda,
                            stream_masked.decode_blocked),
            "binpack": (binpack_kernel,
                        binpack_kernel.binpack_decode_blocked_cuda,
                        binpack_masked.decode_blocked)}


def _decode_matches_plain(dev, fmt, data, meta, counts, bases, B):
    mod, launch, plain = DECODERS[fmt]
    c = torch.as_tensor(counts, device=dev)
    b = torch.as_tensor(bases, device=dev)
    leaves = [data] if meta is None else [meta, data]
    for differential in (False, True):
        before = mod.launches.count
        out = launch(*leaves, c, b, block_size=B, differential=differential)
        assert mod.launches.count == before + 1
        ref = plain(*leaves, c, b, block_size=B, differential=differential)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (fmt, B, differential)


def _layout(dev, data, S, offset):
    """``data`` padded with zero bytes to stride ``S``, then placed
    ``offset`` rows into a buffer (a contiguous view whose base is off its
    16-byte alignment when S is)."""
    nb, s0 = data.shape
    full = np.zeros((nb + offset, S), np.uint8)
    full[offset:, :s0] = data
    return torch.as_tensor(full, device=dev)[offset:]


def _garbage_meta(dev, rng, fmt, nb, B, offset):
    """Random control bytes (every 8th row all length 4, running past any
    row end) or widths up to 255 (32 and more among them), ``offset`` rows
    into their buffer (off their 4-byte alignment with offset 1)."""
    if fmt == "vbyte":
        return None
    if fmt == "streamvbyte":
        c = rng.integers(0, 256, (nb + offset, B // 4), dtype=np.uint8)
        c[::8] = 0xFF
        return torch.as_tensor(c, device=dev)[offset:]
    w = rng.integers(0, 256, (nb + offset, 1), dtype=np.uint8)
    w[:40] = 32
    w[40:80] = rng.integers(0, 33, (40, 1))
    return torch.as_tensor(w, device=dev)[offset:]


# (format, B): Stream VByte takes multiples of 4 only
STAGED_FORMATS_B = ([(f, B) for f in ("vbyte", "binpack")
                     for B in (50, 52, 128, 1024)]
                    + [("streamvbyte", B) for B in (52, 128, 1024)])
STAGED_LAYOUTS = [(0, 0), (3, 0), (2, 1), (17, 1), (9000, 0)]
GARBAGE_LAYOUTS = [(96, 0), (97, 1), (256, 1), (9001, 0)]
STAGED_NB = [1, 2, 5, 4097, 2**18]


@pytest.mark.parametrize("pad,offset", STAGED_LAYOUTS)
@pytest.mark.parametrize("fmt,B", STAGED_FORMATS_B)
def test_kernels1_3_4_staged_layouts_match_plain(dev, fmt, B, pad, offset):
    """B of 50, 52, 128 and 1,024 (52 up for Stream VByte); strides that are
    not multiples of 16 (pad 3, 17), rows off their alignment (offset 1:
    1-, 4- and 16-byte copies all taken), and a stride past the staging
    limit (read in place)."""
    rng = np.random.default_rng(B + pad)
    data, meta, counts = _ragged_fmt(rng, fmt, 301, B, 32)
    S = data.shape[1] + pad
    bases = rng.integers(-2**31, 2**31, 301).astype(np.int32)
    m = None if meta is None else torch.as_tensor(meta, device=dev)
    _decode_matches_plain(dev, fmt, _layout(dev, data, S, offset), m, counts,
                          bases, B)


@pytest.mark.parametrize("nb", STAGED_NB)
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernels1_3_4_block_counts_match_plain(dev, fmt, nb):
    """1 to 2^18 blocks: fewer rows than warps, and many rows per warp
    (the grid-stride walk with the next row in flight)."""
    rng = np.random.default_rng(nb)
    data, meta, counts = _ragged_fmt(rng, fmt, nb, 128, 21)
    bases = rng.integers(-2**31, 2**31, nb).astype(np.int32)
    m = None if meta is None else torch.as_tensor(meta, device=dev)
    _decode_matches_plain(dev, fmt, torch.as_tensor(data, device=dev), m,
                          counts, bases, 128)


@pytest.mark.parametrize("S,offset", GARBAGE_LAYOUTS)
@pytest.mark.parametrize("B", [52, 128])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernels1_3_4_garbage_in_every_layout_match_plain(dev, fmt, B, S,
                                                          offset):
    """Random bytes, counts below 0 and past B, Stream-VByte lengths that
    run past the row end, widths up to 255 (32 and more among them), in
    every staging layout."""
    rng = np.random.default_rng(S + B)
    nb = 513
    data = rng.integers(0, 256, (nb, S), dtype=np.uint8)
    meta = _garbage_meta(dev, rng, fmt, nb, B, offset)
    counts = rng.integers(-2, B + 12, nb).astype(np.int32)
    bases = rng.integers(-2**31, 2**31, nb).astype(np.int32)
    _decode_matches_plain(dev, fmt, _layout(dev, data, S, offset), meta,
                          counts, bases, B)


ROW_EPILOGUES = ("stream", "checksum", "membership_rows", "bm25_accum_rows",
                 "bm25_weighted_rows", "adjacency_rebase")


def _row_ops(dev, fmt, data, meta, counts, bases):
    ops = {"counts": torch.as_tensor(np.asarray(counts, np.int32), device=dev),
           "bases": torch.as_tensor(np.asarray(bases, np.int32), device=dev)}
    names = epilogues.FORMAT_OPERANDS[fmt]
    ops[names[-1]] = data
    if meta is not None:
        ops[names[0]] = (meta if isinstance(meta, torch.Tensor)
                         else torch.as_tensor(meta, device=dev))
    return ops


def _weight_streams(dev, rng, fmt, nb, B, *, pad=0, offset=0, garbage_S=0):
    """One weight stream in each of the other formats than ``fmt`` (the
    weighted epilogue's impact stream may differ from the main one): valid
    rows at the given layout, or garbage rows of stride ``garbage_S``."""
    streams = []
    for w_fmt in ("vbyte", "streamvbyte", "binpack"):
        if w_fmt == fmt or (w_fmt == "streamvbyte" and B % 4):
            continue
        if garbage_S:
            data = rng.integers(0, 256, (nb, garbage_S), dtype=np.uint8)
            meta = _garbage_meta(dev, rng, w_fmt, nb, B, offset)
            data = _layout(dev, data, garbage_S, offset)
        else:
            data, meta, _ = _ragged_fmt(rng, w_fmt, nb, B, 12)
            data = _layout(dev, data, data.shape[1] + pad, offset)
            meta = None if meta is None else torch.as_tensor(meta,
                                                             device=dev)
        names = epilogues.FORMAT_OPERANDS[w_fmt]
        w = {f"w_{names[-1]}": data}
        if meta is not None:
            w[f"w_{names[0]}"] = meta
        streams.append(w)
    return streams


def _rows_match_plain(dev, rng, fmt, ops, B, weights):
    """Every row-aligned epilogue of kernel 2 on ``ops`` against its plain
    version (differential; stream and checksum both ways), the weighted one
    with each weight stream."""
    nb = ops["counts"].shape[0]
    grid = epilogues.fused_decode_plain(
        ops, {}, format=fmt, epilogue="stream", block_size=B,
        differential=True).cpu().numpy()
    pick = grid[np.arange(nb), rng.integers(0, B, nb)]
    probe = torch.as_tensor(np.where(rng.random(nb) < 0.3, -1, pick)
                            .astype(np.int32)[:, None], device=dev)
    eb = torch.as_tensor(rng.integers(-2**31, 2**31, (nb, B))
                         .astype(np.int32), device=dev)
    extras = {"stream": [{}], "checksum": [{}],
              "membership_rows": [{"probe": probe}],
              "bm25_accum_rows": [{"probe": probe, "impact": torch.tensor(
                  [[9]], dtype=torch.int32, device=dev)}],
              "bm25_weighted_rows": [{"probe": probe, **w} for w in weights],
              "adjacency_rebase": [{"edge_base": eb}]}
    for name in ROW_EPILOGUES:
        for ex in extras[name]:
            for differential in ((False, True) if name in ("stream",
                                                           "checksum")
                                 else (True,)):
                _kernel2_matches_plain(ops, ex, fmt, name, B, differential)


@pytest.mark.parametrize("pad,offset", STAGED_LAYOUTS)
@pytest.mark.parametrize("fmt,B", STAGED_FORMATS_B)
def test_kernel2_rows_staged_layouts_match_plain(dev, fmt, B, pad, offset):
    """Kernel 2's row-aligned epilogues at every staging layout of kernels
    1, 3 and 4 (the weight stream at the same layout, in each other
    format)."""
    rng = np.random.default_rng(B + pad + 1)
    data, meta, counts = _ragged_fmt(rng, fmt, 301, B, 32)
    bases = rng.integers(-2**31, 2**31, 301).astype(np.int32)
    ops = _row_ops(dev, fmt, _layout(dev, data, data.shape[1] + pad, offset),
                   meta, counts, bases)
    _rows_match_plain(dev, rng, fmt, ops, B, _weight_streams(
        dev, rng, fmt, 301, B, pad=pad, offset=offset))


@pytest.mark.parametrize("nb", STAGED_NB)
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernel2_rows_block_counts_match_plain(dev, fmt, nb):
    """1 to 2^18 blocks: the weighted epilogue's CTA per row (up to one row
    per SM) and the grid-stride walk with many rows per warp."""
    rng = np.random.default_rng(nb + 3)
    data, meta, counts = _ragged_fmt(rng, fmt, nb, 128, 21)
    bases = rng.integers(-2**31, 2**31, nb).astype(np.int32)
    ops = _row_ops(dev, fmt, torch.as_tensor(data, device=dev), meta, counts,
                   bases)
    _rows_match_plain(dev, rng, fmt, ops, 128,
                      _weight_streams(dev, rng, fmt, nb, 128))


@pytest.mark.parametrize("S,offset", GARBAGE_LAYOUTS)
@pytest.mark.parametrize("B", [52, 128])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernel2_rows_garbage_in_every_layout_match_plain(dev, fmt, B, S,
                                                          offset):
    """Kernel 2's row-aligned epilogues on random bytes, counts below 0 and
    past B, Stream-VByte lengths past the row end and widths up to 255, in
    every staging layout (stride 9,001 read in place), with garbage weight
    streams of the other formats."""
    rng = np.random.default_rng(S + B + 5)
    nb = 513
    data = rng.integers(0, 256, (nb, S), dtype=np.uint8)
    meta = _garbage_meta(dev, rng, fmt, nb, B, offset)
    counts = rng.integers(-2, B + 12, nb).astype(np.int32)
    bases = rng.integers(-2**31, 2**31, nb).astype(np.int32)
    ops = _row_ops(dev, fmt, _layout(dev, data, S, offset), meta, counts,
                   bases)
    _rows_match_plain(dev, rng, fmt, ops, B, _weight_streams(
        dev, rng, fmt, nb, B, offset=offset, garbage_S=S))


@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_kernel2_adjacency_rebase_past_the_grid_matches_plain(dev, fmt):
    """More rows than the persistent grid has warps (each warp walks many),
    every third row empty."""
    rng = np.random.default_rng(29)
    nb = 1 << 16
    data, meta, counts = _ragged_fmt(rng, fmt, nb, 128, 26)
    counts = np.asarray(counts).copy()
    counts[::3] = 0
    bases = rng.integers(-2**31, 2**31, nb).astype(np.int32)
    ops = _row_ops(dev, fmt, torch.as_tensor(data, device=dev), meta, counts,
                   bases)
    eb = torch.as_tensor(rng.integers(-2**31, 2**31, (nb, 128))
                         .astype(np.int32), device=dev)
    _kernel2_matches_plain(ops, {"edge_base": eb}, fmt, "adjacency_rebase",
                           128, True)


# ---------------------------------------------------------------------------
# checked decode (kernel 2's checksum epilogue) and the hardened engine
# ---------------------------------------------------------------------------
def _checked_array(dev, fmt, *, differential, seed, n=4000):
    """Every byte length of ``fmt``, 32 blocks of 128 with a ragged tail,
    with the checksum column."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, (30 if fmt == "streamvbyte" else 32) + 1, n)
    vals = (rng.integers(0, 2**63, n, dtype=np.uint64)
            % (np.uint64(1) << bits.astype(np.uint64)))
    if differential:
        vals = np.cumsum(vals % 997).astype(np.uint64)
    return CompressedIntArray.encode(vals, format=fmt, block_size=128,
                                     differential=differential,
                                     checksum=True, device=dev)


def _detect(arr, plan):
    from repro_torch.robustness import (DecodeError, decode_checked,
                                        validate_array)

    try:
        validate_array(arr, term=9)
        return decode_checked(arr, plan=plan, term=9)
    except DecodeError as e:
        return e


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("cls", ["bit_flip", "byte_drop", "payload_truncate",
                                 "continuation_flip", "control_corrupt",
                                 "width_inflate", "width_deflate",
                                 "width_range", "count_over", "count_under",
                                 "base_corrupt", "checksum_corrupt"])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_checked_decode_on_the_card_matches_plain(dev, fmt, cls, seed):
    """``validate_array`` then ``decode_checked`` through kernel 2 on the
    card raises what the plain torch plan on the card raises — class,
    block, term, message — and, where neither raises (the clean array, or
    a flipped base bit that the position-weighted sum cannot see in a full
    block), returns the plain plan's grid on the card."""
    from repro_torch.robustness import DecodeError, faultgen

    arr = _checked_array(dev, fmt, differential=cls == "base_corrupt",
                         seed=seed)
    before = epilogues.launches.by.get(f"{fmt}/checksum", 0)
    grid = _detect(arr, "cuda")
    assert epilogues.launches.by[f"{fmt}/checksum"] == before + 1
    assert isinstance(grid, torch.Tensor) and grid.device == arr.device
    assert torch.equal(grid, _detect(arr, "torch"))
    c = faultgen.corrupt(arr, cls, seed)
    if c is None:  # the class does not apply to this format
        assert cls in faultgen.STREAM_CLASSES
        return
    assert c.arr.device == arr.device
    got, want = _detect(c.arr, "cuda"), _detect(c.arr, "torch")
    assert type(got) is type(want), (cls, c.detail, got, want)
    if isinstance(want, DecodeError):
        assert (got.block, got.term, str(got)) == (want.block, want.term,
                                                   str(want))
    else:  # a change the checksum cannot see (a base bit times c² ≡ 0)
        assert torch.equal(got, want)


@pytest.mark.parametrize("fmt", ["vbyte", "auto", "streamvbyte"])
def test_hardened_engine_on_the_card(dev, fmt):
    """Startup gate, quarantine and shard loss / heal on the card give the
    plain plan's answers."""
    from repro_torch.data.synthetic import posting_list_group, posting_tfs
    from repro_torch.launch.serve import SimClock, shard_loss_drill
    from repro_torch.robustness import faultgen

    rng = np.random.default_rng(2)
    lists = dict(enumerate(posting_list_group(rng, 10, 16, universe=1 << 20)))
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    index = build_index(lists, tfs=tfs, n_docs=1 << 20, format=fmt,
                        checksum=True)
    f0 = epilogues.launches.count
    clock = SimClock()
    eng = SearchEngine(index, validate=True, n_shards=8, clock=clock)
    assert not eng.quarantined and not eng.bound_unsafe
    assert epilogues.launches.count - f0 == 2 * index.n_terms  # checksum
    qs = search_queries(rng, index, 12)
    qs.append(("or", [eng.term_order[eng.shards[3][0]]]))
    drill = shard_loss_drill(eng, qs, clock, victim=3)
    plain = SearchEngine(index, plan="torch")
    for (mode, terms), out in zip(qs, drill["healthy"]):
        want = plain.search(terms, mode)
        for x, y in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(x, y)
    terms = dict(index.terms)
    bad = faultgen.corrupt(terms[4].arr, "bit_flip", 1)
    terms[4] = dataclasses.replace(terms[4], arr=bad.arr)
    eng2 = SearchEngine(dataclasses.replace(index, terms=terms),
                        validate=True)
    assert list(eng2.quarantined) == [4]
    np.testing.assert_array_equal(eng2.search([4, 5], "or"),
                                  plain.search([5], "or"))


# ---------------------------------------------------------------------------
# telemetry and the live index on the card
# ---------------------------------------------------------------------------
LIVE_TERMS = 8
LIVE_UNIVERSE = 1 << 16
LIVE_QUERIES = ([0, 3], [1], [2, 5, 7], [4, 6], [0, 1, 2])


def _live_ops(rng, live, state, n_ops, *, p_del=0.25):
    for _ in range(n_ops):
        if state and rng.random() < p_del:
            doc = int(rng.choice(sorted(state)))
            live.delete(doc)
            del state[doc]
        else:
            doc = int(rng.integers(LIVE_UNIVERSE))
            if doc in state:
                continue
            terms = {int(t): int(rng.integers(1, 5)) for t in rng.choice(
                LIVE_TERMS, size=int(rng.integers(1, 4)), replace=False)}
            live.add(doc, terms)
            state[doc] = terms


def _live_answers(live):
    out = []
    for q in LIVE_QUERIES:
        out += [live.search(q, mode="and"), live.search(q, mode="or"),
                live.search(q, mode="topk", k=10)]
    return out


def _same_answers(a, b):
    return len(a) == len(b) and all(
        all(x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(p if isinstance(p, tuple) else (p,),
                            q if isinstance(q, tuple) else (q,)))
        for p, q in zip(a, b))


def _live_on_card(path, rng, state, *, n_ops=400, merge=True):
    from repro_torch.index import LiveIndex

    live = LiveIndex(str(path), n_docs=LIVE_UNIVERSE, fsync=False)
    assert live.device.type == "cuda"
    _live_ops(rng, live, state, n_ops)
    if merge:
        live.merge()
        _live_ops(rng, live, state, n_ops // 2)  # delta over the segment
    return live


def test_live_index_on_the_card_equals_torch_plan(dev, tmp_path):
    """A LiveIndex on the card answers as the same directory opened on
    plan='torch' (the plain decoders on the card), and its queries and
    merges launch the decode kernels."""
    import shutil

    from repro_torch.index import LiveIndex

    rng = np.random.default_rng(5)
    state = {}
    counts = lambda: (kernel.launches.count + stream_kernel.launches.count
                      + binpack_kernel.launches.count)
    live = _live_on_card(tmp_path / "ix", rng, state)
    k0 = counts()
    live.merge()
    k1 = counts()
    assert k1 > k0  # the merge decoded the main lists on the card
    _live_ops(rng, live, state, 100)
    live.close()
    shutil.copytree(tmp_path / "ix", tmp_path / "plain")
    live = LiveIndex(str(tmp_path / "ix"), fsync=False)
    plain = LiveIndex(str(tmp_path / "plain"), fsync=False, plan="torch")
    assert all(tp.arr.device.type == "cuda"
               for tp in plain.main.terms.values())
    got = _live_answers(live)
    assert counts() > k1
    k2 = counts()
    assert _same_answers(got, _live_answers(plain))
    assert counts() == k2  # the plain plan launches none of them
    assert live.doc_count() == plain.doc_count() == len(state)
    live.close()
    plain.close()


def test_merge_while_querying_on_the_card(dev, tmp_path):
    """A merge in one thread while another queries: every answer the
    reader sees mid-merge equals the quiescent one."""
    import threading

    rng = np.random.default_rng(6)
    live = _live_on_card(tmp_path / "ix", rng, {})
    quiescent = _live_answers(live)
    stop, seen, bad = threading.Event(), [], []

    def reader():
        while not stop.is_set():
            state = live.state
            if not _same_answers(_live_answers(live), quiescent):
                bad.append(state)
            seen.append(state)

    th = threading.Thread(target=reader)
    th.start()
    try:
        for _ in range(2):
            live.merge()
    finally:
        stop.set()
        th.join(timeout=300)
    assert not th.is_alive()
    assert not bad and seen
    assert _same_answers(_live_answers(live), quiescent)
    live.close()


def test_concurrent_writers_during_merge_on_the_card(dev, tmp_path):
    """The reference's concurrent-writers case on the card: writer threads
    racing merges, then parity with a rebuilt index and after a restart."""
    import threading

    from repro_torch.index import LiveIndex, conjunctive, disjunctive, topk

    live = LiveIndex(str(tmp_path / "ix"), n_docs=LIVE_UNIVERSE, fsync=False)
    state = {}
    for i in range(40):
        live.add(i, {i % LIVE_TERMS: 1})
        state[i] = {i % LIVE_TERMS: 1}
    acked, errs = [], []

    def writer(base):
        rng = np.random.default_rng(base)
        try:
            for doc in range(1000 * (base + 1), 1000 * (base + 1) + 200):
                terms = {int(rng.integers(LIVE_TERMS)): int(rng.integers(1, 4))}
                live.add(doc, terms)
                acked.append((doc, terms))
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(b,)) for b in range(3)]
    for th in threads:
        th.start()
    for _ in range(3):
        live.merge()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    assert errs == []
    for doc, terms in acked:
        state[doc] = terms
    lists, tfs = {}, {}
    for doc in sorted(state):
        for t, tf in state[doc].items():
            lists.setdefault(t, []).append(doc)
            tfs.setdefault(t, []).append(tf)
    oracle = build_index({t: np.asarray(v) for t, v in lists.items()},
                         tfs={t: np.asarray(v) for t, v in tfs.items()},
                         format="auto", n_docs=LIVE_UNIVERSE, checksum=True)
    want = []
    for q in LIVE_QUERIES:
        want += [conjunctive(oracle, q), disjunctive(oracle, q),
                 topk(oracle, q, 10, mode="or")]
    assert _same_answers(_live_answers(live), want)
    live.close()
    live = LiveIndex(str(tmp_path / "ix"), fsync=False)
    assert _same_answers(_live_answers(live), want)
    live.close()


def test_decode_span_encloses_each_kernel_launch(dev, tmp_path):
    """Under Telemetry(torch_annotations=True) every kernel of the port in
    a torch.profiler trace lies under a ``decode`` range whose span names
    the kernel's format and epilogue."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.data.synthetic import posting_list_group, posting_tfs
    from repro_torch.obs.attribution import attribute_kernels

    rng = np.random.default_rng(8)
    lists = dict(enumerate(posting_list_group(rng, 10, 8, universe=1 << 20)))
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    for fmt in ("vbyte", "auto", "streamvbyte"):
        index = build_index(lists, tfs=tfs, n_docs=1 << 20, format=fmt)
        engine = SearchEngine(index)
        qs = search_queries(rng, index, 10)
        engine.warmup(qs)
        tele = obs.Telemetry(torch_annotations=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with obs.install(tele):
                for mode, terms in qs:
                    engine.search(terms, mode)
            torch.cuda.synchronize()
        path = tmp_path / f"{fmt}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        got = attribute_kernels(events, tele.tracer.spans)
        assert got["kernels"] > 0, (fmt, got)
        assert got["attributed"] == got["kernels"], (fmt, got)
        assert got["outside"] == got["mismatched"] == 0, (fmt, got)
        assert got["ranges"] == got["spans"] == len(
            tele.tracer.durations("decode")), (fmt, got)
