"""Card-only tests: each hand-written CUDA kernel against its plain torch
version on the same device tensors, bit for bit, plus the launch counters
and the wrappers' refusals. Marked ``cuda``; they skip where no card is
present. Run on a GPU machine with

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
