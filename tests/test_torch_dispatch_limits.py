"""``dispatch.decode`` on the kernel plan serves every probe width and
``dot_score`` query that the reference serves: past kernel 2's shared
memory limits (``MAX_PROBE_WIDTH`` probes, ``MAX_QUERY_ELEMS`` query
elements) it splits the work across launches — probe columns, or query
rows — and takes the unfused plan where one query row alone is too wide.

Run here with ``plan="cuda"`` on CPU tensors, where each kernel wrapper
computes its plain version, with the limits lowered by ``monkeypatch`` so
that small inputs cross them, and at the real limits (P = 4,097 and
8,192; 9 bf16 query rows of d = 1,024; one row of d = 9,000). Integer
outputs are held bit for bit against the plain version of kernel 2 on the
whole input, and the broadcast case also against the reference; scores
within the float tolerance of ``torch_parity.float_close`` (one bf16 ulp,
or 1e-5 for f32), since each launch's product is its own matmul."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import CompressedIntArray as RArr
from repro.kernels.vbyte_decode import dispatch as Rdispatch
from repro_torch.core import CompressedIntArray
from repro_torch.kernels.vbyte_decode import dispatch, epilogues
from repro_torch.kernels.vbyte_decode.dispatch import DecodePlan
from repro_torch.kernels.vbyte_decode.ops import normalize_probe

from torch_parity import float_close

B = 32
FORMATS = ("vbyte", "streamvbyte", "binpack")


def _docs(seed, n=400):
    rng = np.random.default_rng(seed)
    return rng, np.sort(rng.choice(20000, n, replace=False)).astype(np.uint64)


def _count_fused(monkeypatch):
    """Count kernel 2's wrapper calls made through dispatch."""
    calls = []
    real = epilogues.fused_decode

    def counted(*a, **k):
        calls.append(k["epilogue"])
        return real(*a, **k)

    monkeypatch.setattr(epilogues, "fused_decode", counted)
    return calls


def _probe_extras(rng, arr, docs, epilogue, P):
    probe = np.unique(np.concatenate([rng.choice(docs, P // 3),
                                      rng.integers(0, 20000, P // 3)]))
    ex = {"probe": torch.as_tensor(normalize_probe(probe[:P], P))}
    if epilogue == "bm25_accum":
        ex["impact"] = torch.tensor([[5]], dtype=torch.int32)
    if epilogue == "bm25_weighted":
        imp = CompressedIntArray.encode(
            rng.integers(1, 300, docs.size).astype(np.uint64),
            format=arr.format, block_size=B, device="cpu")
        ex.update({f"w_{k}": v for k, v in imp.device_operands().items()
                   if k not in ("counts", "bases")})
    return ex


def _plain(arr, extras, epilogue):
    ops = arr.device_operands()
    return epilogues.fused_decode_plain(
        ops, extras, format=arr.format, epilogue=epilogue,
        block_size=arr.block_size, differential=arr.differential)


@pytest.mark.parametrize("P", [65, 128, 200])
@pytest.mark.parametrize("epilogue", ["membership", "bm25_accum",
                                      "bm25_weighted"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_broadcast_probes_split_past_the_width(monkeypatch, fmt, epilogue,
                                               P):
    monkeypatch.setattr(epilogues, "MAX_PROBE_WIDTH", 64)
    calls = _count_fused(monkeypatch)
    rng, docs = _docs(P)
    arr = CompressedIntArray.encode(docs, format=fmt, block_size=B,
                                    differential=True, device="cpu")
    ex = _probe_extras(rng, arr, docs, epilogue, P)
    out = dispatch.decode(arr, epilogue=epilogue, epilogue_operands=ex,
                          plan="cuda")
    assert len(calls) == -(-P // 64)
    assert out.shape == (arr.n_blocks, P)
    assert torch.equal(out, _plain(arr, ex, epilogue))


@pytest.mark.parametrize("P", [4097, 8192])
@pytest.mark.parametrize("epilogue", ["membership", "bm25_weighted"])
def test_broadcast_probes_at_the_real_width(monkeypatch, epilogue, P):
    """P = 4,097 and 8,192 (a ``SearchEngine(probe_width=8192)``): two
    launches, equal to the plain version and, for membership, to the
    reference's jnp plan."""
    calls = _count_fused(monkeypatch)
    rng, docs = _docs(P, n=300)
    arr = CompressedIntArray.encode(docs, block_size=B, differential=True,
                                    device="cpu")
    ex = _probe_extras(rng, arr, docs, epilogue, P)
    out = dispatch.decode(arr, epilogue=epilogue, epilogue_operands=ex,
                          plan="cuda")
    assert len(calls) == 2
    assert torch.equal(out, _plain(arr, ex, epilogue))
    if epilogue == "membership":
        ref = Rdispatch.decode(RArr.encode(docs, block_size=B,
                                           differential=True),
                               epilogue="membership", plan="jnp",
                               epilogue_operands={
                                   "probe": jnp.asarray(ex["probe"].numpy())})
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _dot_case(seed, fmt, dtype, d, nq):
    rng, docs = _docs(seed, n=150)
    arr = CompressedIntArray.encode(docs % 64, format=fmt, block_size=B,
                                    device="cpu")
    table = torch.tensor(rng.standard_normal((64, d)).astype(np.float32))
    query = torch.tensor(rng.standard_normal((nq, d)).astype(np.float32))
    return arr, table.to(dtype), query.to(dtype)


def _hold_scores(arr, ex, out):
    ids, scores = out
    ref_ids, ref = _plain(arr, ex, "dot_score")
    assert torch.equal(ids, ref_ids)
    assert scores.shape == ref.shape and scores.dtype == torch.float32
    s_abs = _plain(arr, {k: v.abs() for k, v in ex.items()}, "dot_score")[1]
    assert float_close(scores, ref, bf16=ex["table"].dtype == torch.bfloat16,
                       terms=ex["table"].shape[1], s_abs=s_abs)


@pytest.mark.parametrize("nq", [2, 5, 9])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fmt", FORMATS)
def test_dot_score_splits_query_rows(monkeypatch, fmt, dtype, nq):
    """With 64 query elements a launch: d = 20 is 24 elements a row in
    bf16 (2 rows a launch) and 20 in f32 (3 rows a launch)."""
    monkeypatch.setattr(epilogues, "MAX_QUERY_ELEMS", 64)
    calls = _count_fused(monkeypatch)
    arr, table, query = _dot_case(nq, fmt, dtype, 20, nq)
    ex = {"table": table, "query": query}
    out = dispatch.decode(arr, epilogue="dot_score", epilogue_operands=ex,
                          plan="cuda")
    fit = 2 if dtype == torch.bfloat16 else 3
    assert len(calls) == -(-nq // fit)
    _hold_scores(arr, ex, out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dot_score_row_too_wide_takes_the_unfused_plan(monkeypatch, dtype):
    monkeypatch.setattr(epilogues, "MAX_QUERY_ELEMS", 16)
    calls = _count_fused(monkeypatch)
    arr, table, query = _dot_case(3, "vbyte", dtype, 20, 3)
    ex = {"table": table, "query": query}
    out = dispatch.decode(arr, epilogue="dot_score", epilogue_operands=ex,
                          plan="cuda")
    assert calls == []
    _hold_scores(arr, ex, out)


@pytest.mark.parametrize("nq,d,launches", [(9, 1024, 2), (1, 9000, 0),
                                           (8, 1024, 1)])
def test_dot_score_at_the_real_limit(monkeypatch, nq, d, launches):
    """9 bf16 query rows of d = 1,024 take two launches (8 rows fit); one
    row of d = 9,000 fits none and takes the unfused plan."""
    calls = _count_fused(monkeypatch)
    arr, table, query = _dot_case(d + nq, "vbyte", torch.bfloat16, d, nq)
    ex = {"table": table, "query": query}
    out = dispatch.decode(arr, epilogue="dot_score", epilogue_operands=ex,
                          plan=DecodePlan("cuda"))
    assert len(calls) == launches
    _hold_scores(arr, ex, out)
