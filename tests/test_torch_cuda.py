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
from repro_torch.core.vbyte import encode as venc
from repro_torch.core.vbyte.masked import decode_blocked as decode_plain
from repro_torch.index import build_index
from repro_torch.kernels.vbyte_decode import epilogues, kernel
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
    before = epilogues.launches.count
    out = epilogues.fused_decode(ops, ex, format="vbyte", epilogue=epilogue,
                                 block_size=B, differential=differential)
    assert epilogues.launches.count == before + 1
    ref = epilogues.fused_decode_plain(ops["payload"], ops["counts"],
                                       ops["bases"], ex, epilogue=epilogue,
                                       block_size=B, differential=differential)
    torch.cuda.synchronize()
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert o.shape == r.shape and torch.equal(o, r), epilogue


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


def test_search_engine_kernels_match_torch_plan(dev):
    from repro_torch.data.synthetic import posting_list_group, posting_tfs

    rng = np.random.default_rng(0)
    lists = dict(enumerate(posting_list_group(rng, 10, 8, universe=1 << 20)))
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    index = build_index(lists, tfs=tfs, n_docs=1 << 20)
    qs = search_queries(rng, index, 20)
    cuda_eng = SearchEngine(index)
    torch_eng = SearchEngine(index, plan="torch")
    k0, f0 = kernel.launches.count, epilogues.launches.count
    for mode, terms in qs:
        a, b = cuda_eng.search(terms, mode), torch_eng.search(terms, mode)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    assert kernel.launches.count > k0 and epilogues.launches.count > f0
