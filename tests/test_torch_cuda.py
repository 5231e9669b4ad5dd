"""Card-only tests: each hand-written CUDA kernel against its plain torch
version on the same device tensors — bit for bit for every integer
output; within one bf16 ulp (bf16 tables) or 1e-5 (f32 tables) for
kernel 2's float epilogues ``bag_sum`` and ``dot_score``, whose sums run
in another order than the plain version's — plus the launch counters,
the wrappers' refusals and the serving paths. Marked ``cuda``; they skip
where no card is present. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
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

from torch_parity import bf16_ulps, float_close

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
