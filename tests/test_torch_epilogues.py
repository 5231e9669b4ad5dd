"""Every epilogue through the port's ``dispatch.decode`` — torch fused and
unfused, the kernel plan on CPU tensors (its plain version), and the
``ref`` path — against the reference's ``apply_grid`` and
``dispatch.decode(plan="unfused")``, for the main stream in each of the
three formats: the integer epilogues bit for bit (probe padding, count-0
blocks, the weighted stream in each format, adjacency_rebase's wrap); the
float ones (bag_sum, dot_score) within 1e-5 for f32 tables and one bf16
ulp for bf16 tables — both packages round one f32 sum, in different
orders."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import CompressedIntArray as RArr
from repro.kernels.vbyte_decode import dispatch as Rdispatch
from repro.kernels.vbyte_decode import epilogues as Repi
from repro.kernels.vbyte_decode.ops import normalize_probe as R_normalize_probe
from repro_torch.kernels.vbyte_decode import dispatch as Tdispatch
from repro_torch.kernels.vbyte_decode import epilogues as Tepi
from repro_torch.kernels.vbyte_decode.dispatch import DecodePlan
from repro_torch.kernels.vbyte_decode.ops import (normalize_block_meta,
                                                  normalize_probe)

from torch_parity import assert_same, bf16_ulps

B = 32
PORTED = ("stream", "checksum", "membership", "membership_rows", "bm25_accum",
          "bm25_accum_rows", "bm25_weighted", "bm25_weighted_rows")
PORT_PLANS = ("auto", "torch", DecodePlan("torch", fused=False), "cuda",
              DecodePlan("cuda", fused=False), "ref")
GATHER = ("bag_sum", "dot_score", "adjacency_rebase")
FORMATS = ("vbyte", "streamvbyte", "binpack")
VOCAB, D = 512, 16


def _workload(seed, differential, *, n=700, zero_blocks=3, fmt="vbyte",
              w_fmt=None):
    """Host operands (docid stream in ``fmt`` + aligned impact stream in
    ``w_fmt``, count-0 blocks appended) and host extras for every
    epilogue."""
    rng = np.random.default_rng(seed)
    if differential:
        vals = np.sort(rng.choice(5000, size=n, replace=False)).astype(np.uint64)
    else:
        vals = rng.integers(0, 5000, size=n).astype(np.uint64)
    arr = RArr.encode(vals, format=fmt, block_size=B,
                      differential=differential)
    imp = RArr.encode(rng.integers(1, 300, size=n).astype(np.uint64),
                      format=w_fmt or fmt, block_size=B)

    def pad(a):
        a = np.asarray(a)
        return np.pad(a, ((0, zero_blocks),) + ((0, 0),) * (a.ndim - 1))

    ops = {k: pad(v) for k, v in arr.device_operands().items()}
    nb = ops["counts"].shape[0]
    w_ops = {f"w_{k}": pad(v) for k, v in imp.device_operands().items()
             if k not in ("counts", "bases")}
    # broadcast probes: half present in the list, half random; padded with -1
    probe = np.unique(np.concatenate([rng.choice(vals, 20), rng.integers(0, 5000, 20)]))
    probe = normalize_probe(probe, 64)
    rows_probe = np.where(rng.random((nb, 1)) < 0.2, -1,
                          rng.choice(vals, (nb, 1))).astype(np.int32)
    impact = np.array([[7]], np.int32)
    extras = {
        "stream": {}, "checksum": {},
        "membership": {"probe": probe},
        "membership_rows": {"probe": rows_probe},
        "bm25_accum": {"probe": probe, "impact": impact},
        "bm25_accum_rows": {"probe": rows_probe, "impact": impact},
        "bm25_weighted": {"probe": probe, **w_ops},
        "bm25_weighted_rows": {"probe": rows_probe, **w_ops},
    }
    return ops, extras


def _port(ops, extras):
    t_ops = {k: torch.tensor(v) for k, v in ops.items()}
    t_ops["bases"] = torch.tensor(ops["bases"].view(np.int32))
    return t_ops, {k: torch.tensor(v) for k, v in extras.items()}


def _check_parity(ops, ex, *, fmt, epilogue, differential, plans=PORT_PLANS):
    """The port's dispatch plans, apply_grid and plain kernel 2 against the
    reference's unfused decode and its apply_grid."""
    r_ops = {k: jnp.asarray(v) for k, v in ops.items()}
    r_ex = {k: jnp.asarray(v) for k, v in ex.items()}
    kw = dict(format=fmt, block_size=B, differential=differential)
    ref = Rdispatch.decode(r_ops, epilogue_operands=r_ex, plan="unfused",
                           epilogue=epilogue, **kw)
    grid = Rdispatch.decode(r_ops, plan="jnp", **kw)
    assert_same(ref, Repi.apply_grid(epilogue, grid, r_ops["counts"], r_ex))
    t_ops, t_ex = _port(ops, ex)
    for plan in plans:
        out = Tdispatch.decode(t_ops, epilogue_operands=t_ex, plan=plan,
                               epilogue=epilogue, **kw)
        assert_same(ref, out, f"{fmt} {epilogue} {plan}")
    # the port's apply_grid on the port's decoded grid, and the plain version
    t_grid = Tdispatch.decode(t_ops, plan="torch", **kw)
    assert_same(ref, Tepi.apply_grid(epilogue, t_grid, t_ops["counts"], t_ex))
    assert_same(ref, Tepi.fused_decode_plain(
        t_ops, t_ex, format=fmt, epilogue=epilogue, block_size=B,
        differential=differential))
    return ref


@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("epilogue", PORTED)
def test_epilogue_parity(epilogue, differential):
    ops, extras = _workload(21, differential)
    _check_parity(ops, extras[epilogue], fmt="vbyte", epilogue=epilogue,
                  differential=differential)


@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("epilogue", PORTED)
@pytest.mark.parametrize("fmt", ["streamvbyte", "binpack"])
def test_epilogue_parity_formats(fmt, epilogue, differential):
    """Kernel 2's streamvbyte and binpack cores (their plain versions), with
    the weight stream in the main stream's format."""
    ops, extras = _workload(25, differential, fmt=fmt)
    _check_parity(ops, extras[epilogue], fmt=fmt, epilogue=epilogue,
                  differential=differential,
                  plans=("auto", DecodePlan("torch", fused=False), "cuda"))


@pytest.mark.parametrize("w_fmt", ["vbyte", "streamvbyte", "binpack"])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_weight_stream_in_every_format(fmt, w_fmt):
    """``bm25_weighted[_rows]`` with the impact stream in each of the three
    formats under each main format."""
    ops, extras = _workload(26, True, fmt=fmt, w_fmt=w_fmt)
    for epilogue in ("bm25_weighted", "bm25_weighted_rows"):
        _check_parity(ops, extras[epilogue], fmt=fmt, epilogue=epilogue,
                      differential=True, plans=("auto", "cuda"))


@pytest.mark.parametrize("epilogue", ["membership_rows", "bm25_weighted"])
def test_pallas_fused_kernel_parity_tiny(epilogue):
    """Against the Pallas fused kernel itself (interpret mode), tiny, with
    the main stream in each format."""
    for fmt in ("vbyte", "streamvbyte", "binpack"):
        ops, extras = _workload(22, True, n=90, zero_blocks=1, fmt=fmt)
        r_ops = {k: jnp.asarray(v) for k, v in ops.items()}
        r_ex = {k: jnp.asarray(v) for k, v in extras[epilogue].items()}
        ref = Rdispatch.decode(r_ops, format=fmt, block_size=B,
                               differential=True, epilogue=epilogue,
                               epilogue_operands=r_ex, plan="kernel")
        t_ops, t_ex = _port(ops, extras[epilogue])
        out = Tepi.fused_decode(t_ops, t_ex, format=fmt, epilogue=epilogue,
                                block_size=B, differential=True)
        assert_same(ref, out, f"{fmt} {epilogue}")


def test_weighted_stream_long_weights_and_empty_probe_set():
    """Weights of every byte length (the weight tile decodes with the main
    tile's counts), and an all-padding probe set that matches nothing."""
    rng = np.random.default_rng(23)
    vals = np.sort(rng.choice(10**6, size=150, replace=False)).astype(np.uint64)
    w = rng.integers(0, 2**32, size=150, dtype=np.uint64)
    arr = RArr.encode(vals, block_size=B, differential=True)
    imp = RArr.encode(w, block_size=B)
    ops = {k: np.asarray(v) for k, v in arr.device_operands().items()}
    probe = R_normalize_probe(np.sort(rng.choice(vals, 30, replace=False)), 32)
    for ex in ({"probe": probe, "w_payload": np.asarray(imp.payload)},
               {"probe": np.full((1, 8), -1, np.int32),
                "w_payload": np.asarray(imp.payload)}):
        r_ops = {k: jnp.asarray(v) for k, v in ops.items()}
        ref = Rdispatch.decode(r_ops, format="vbyte", block_size=B,
                               differential=True, epilogue="bm25_weighted",
                               epilogue_operands={k: jnp.asarray(v)
                                                  for k, v in ex.items()},
                               plan="unfused")
        t_ops, t_ex = _port(ops, ex)
        for plan in ("torch", "cuda", "ref"):
            out = Tdispatch.decode(t_ops, format="vbyte", block_size=B,
                                   differential=True, epilogue="bm25_weighted",
                                   epilogue_operands=t_ex, plan=plan)
            assert_same(ref, out, plan)


def test_normalize_probe_and_block_meta_errors():
    for bad, match in ((np.array([5, 3]), "sorted"),
                       (np.array([-1, 3]), r"\[0, 2\^31\)"),
                       (np.array([2**31]), r"\[0, 2\^31\)"),
                       (np.arange(10), "width")):
        with pytest.raises(ValueError, match=match):
            normalize_probe(bad, 8)
        with pytest.raises(ValueError, match=match):
            R_normalize_probe(bad, 8)
    np.testing.assert_array_equal(normalize_probe([1, 4, 4, 9], 8),
                                  R_normalize_probe([1, 4, 4, 9], 8))
    x = torch.arange(6, dtype=torch.int32)
    assert normalize_block_meta("counts", x[:, None], 6).shape == (6,)
    for bad in (x[:5], x.reshape(2, 3), x[None, :]):
        with pytest.raises(ValueError, match="counts must have shape"):
            normalize_block_meta("counts", bad, 6)


def test_epilogue_registry_errors():
    ops, extras = _workload(24, True, n=64, zero_blocks=0)
    t_ops, _ = _port(ops, {})
    kw = dict(format="vbyte", block_size=B, differential=True)
    with pytest.raises(ValueError, match="missing"):
        Tdispatch.decode(t_ops, epilogue="membership", **kw)
    with pytest.raises(ValueError, match="unexpected"):
        Tdispatch.decode(t_ops, epilogue="stream",
                         epilogue_operands={"probe": torch.zeros(1, 4)}, **kw)
    with pytest.raises(ValueError, match="unknown epilogue"):
        Tdispatch.decode(t_ops, epilogue="nope", **kw)
    # the gather and rebase epilogues dispatch (their parity is held in
    # test_gather_epilogue_parity / test_adjacency_rebase_parity)
    table = torch.ones(5000, 4)
    assert Tdispatch.decode(t_ops, epilogue="bag_sum",
                            epilogue_operands={"table": table},
                            **kw).shape == (2, 4)
    ids, scores = Tdispatch.decode(
        t_ops, epilogue="dot_score",
        epilogue_operands={"table": table, "query": torch.ones(1, 4)}, **kw)
    assert ids.shape == scores.shape == (2, B)
    assert Tdispatch.decode(
        t_ops, epilogue="adjacency_rebase",
        epilogue_operands={"edge_base": torch.zeros(2, B, dtype=torch.int32)},
        **kw).shape == (2, B)
    with pytest.raises(ValueError, match="differential=True"):
        Tdispatch.decode(t_ops, format="vbyte", block_size=B,
                         differential=False, epilogue="adjacency_rebase",
                         epilogue_operands={"edge_base": torch.zeros(
                             2, B, dtype=torch.int32)})
    # the other two formats are ported: a streamvbyte main stream, and a
    # streamvbyte weight stream under a vbyte main stream, match the
    # reference
    s_ops, s_ex = _workload(24, True, n=64, zero_blocks=0, fmt="streamvbyte")
    _check_parity(s_ops, {}, fmt="streamvbyte", epilogue="stream",
                  differential=True, plans=("cuda",))
    _, w_ex = _workload(24, True, n=64, zero_blocks=0, w_fmt="streamvbyte")
    assert {"w_control", "w_data"} <= set(w_ex["bm25_weighted"])
    _check_parity(ops, w_ex["bm25_weighted"], fmt="vbyte",
                  epilogue="bm25_weighted", differential=True,
                  plans=("cuda",))
    with pytest.raises(ValueError, match="needs w_payload"):
        Tdispatch.decode(t_ops, epilogue="bm25_weighted",
                         epilogue_operands={
                             "probe": torch.as_tensor(extras["membership"]["probe"]),
                             "w_control": torch.as_tensor(s_ops["control"])},
                         **kw)
    assert set(PORTED + GATHER) == set(Tepi.EPILOGUES)


# ---------------------------------------------------------------------------
# the gather and rebase epilogues (bag_sum, dot_score, adjacency_rebase), on
# the reference's cases (tests/test_fused_epilogues.py): sorted ids, count-0
# blocks, ragged tails, one- and multi-row queries — plus binpack
# ---------------------------------------------------------------------------
def _id_operands(rng, fmt, n, zero_blocks):
    vals = np.sort(rng.integers(0, VOCAB, size=n)).astype(np.uint64)
    arr = RArr.encode(vals, format=fmt, block_size=B, differential=True)
    ops = {k: np.asarray(v) for k, v in arr.device_operands().items()}
    for k in ops:
        ops[k] = np.pad(ops[k], ((0, zero_blocks),) + ((0, 0),) * (ops[k].ndim - 1))
    return ops, vals


def _port_plans(fmt):
    return PORT_PLANS if fmt == "vbyte" else (
        "auto", DecodePlan("torch", fused=False), "cuda",
        DecodePlan("cuda", fused=False))


def _assert_float_parity(ref, out, dtype, msg):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    out = out.float().numpy()
    assert ref.shape == out.shape, msg
    if dtype == "bf16":  # one rounding to bf16 of an f32 sum, either order
        assert bf16_ulps(torch.tensor(ref), torch.tensor(out)) <= 1, msg
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=msg)


def _tables(dtype):
    rng = np.random.default_rng(42)
    table = rng.standard_normal((VOCAB, D)).astype(np.float32)
    query = rng.standard_normal((3, D)).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.tensor(table)
    jq, tq = jnp.asarray(query), torch.tensor(query)
    if dtype == "bf16":
        jt, jq = jt.astype(jnp.bfloat16), jq.astype(jnp.bfloat16)
        tt, tq = tt.to(torch.bfloat16), tq.to(torch.bfloat16)
    return (jt, jq), (tt, tq)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,zero_blocks", [(4 * B, 0), (2 * B + 7, 0), (B, 2)])
def test_bag_sum_parity(fmt, n, zero_blocks, dtype):
    """Every port plan against the reference's ``plan="unfused"``: f32
    within 1e-5, bf16 within one bf16 ulp (both round one f32 sum)."""
    ops, vals = _id_operands(np.random.default_rng(n + zero_blocks), fmt, n,
                             zero_blocks)
    (jt, _), (tt, _) = _tables(dtype)
    kw = dict(format=fmt, block_size=B, differential=True)
    ref = Rdispatch.decode({k: jnp.asarray(v) for k, v in ops.items()},
                           epilogue="bag_sum", epilogue_operands={"table": jt},
                           plan="unfused", **kw)
    t_ops, _ = _port(ops, {})
    for plan in _port_plans(fmt):
        out = Tdispatch.decode(t_ops, epilogue="bag_sum",
                               epilogue_operands={"table": tt}, plan=plan, **kw)
        assert out.dtype == tt.dtype
        _assert_float_parity(ref, out, dtype, f"{fmt} {plan}")


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,zero_blocks", [(2 * B + 7, 0), (B, 2)])
def test_dot_score_parity(fmt, n, zero_blocks, dtype, nq):
    """ids bit for bit (0 in pad slots); scores f32 within 1e-5 or bf16
    within one ulp; ``[nb, B]`` for a one-row query, ``[nb, B, nq]``
    otherwise."""
    ops, vals = _id_operands(np.random.default_rng(n + zero_blocks), fmt, n,
                             zero_blocks)
    (jt, jq), (tt, tq) = _tables(dtype)
    kw = dict(format=fmt, block_size=B, differential=True)
    ref_ids, ref_s = Rdispatch.decode(
        {k: jnp.asarray(v) for k, v in ops.items()}, epilogue="dot_score",
        epilogue_operands={"table": jt, "query": jq[:nq]}, plan="unfused",
        **kw)
    t_ops, _ = _port(ops, {})
    for plan in _port_plans(fmt):
        ids, scores = Tdispatch.decode(
            t_ops, epilogue="dot_score",
            epilogue_operands={"table": tt, "query": tq[:nq]}, plan=plan, **kw)
        assert_same(ref_ids, ids, f"{fmt} {plan}")
        assert scores.dtype == torch.float32
        _assert_float_parity(ref_s, scores, dtype, f"{fmt} {plan}")
    flat = ids.numpy().reshape(-1)
    np.testing.assert_array_equal(flat[:len(vals)], vals.astype(np.int32))
    assert not flat[len(vals):].any()  # pad slots are id 0


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n,zero_blocks", [(2 * B + 7, 0), (B, 2)])
def test_adjacency_rebase_parity(fmt, n, zero_blocks):
    """Bit for bit, including the mod-2^32 wrap of ``vals − edge_base``."""
    rng = np.random.default_rng(n + zero_blocks)
    ops, vals = _id_operands(rng, fmt, n, zero_blocks)
    nb = ops["counts"].shape[0]
    eb = rng.integers(-2**31, 2**31, (nb, B)).astype(np.int32)
    ref = _check_parity(ops, {"edge_base": eb}, fmt=fmt,
                        epilogue="adjacency_rebase", differential=True,
                        plans=_port_plans(fmt))
    expect = (vals.astype(np.int64) - eb.reshape(-1)[:len(vals)]).astype(
        np.uint32).view(np.int32)
    np.testing.assert_array_equal(np.asarray(ref).reshape(-1)[:len(vals)],
                                  expect)


def test_gather_ids_clip_like_the_reference():
    """Ids past the table and negative as int32 (values ≥ 2^31) gather the
    last and the first row, as ``take(..., mode="clip")`` does."""
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 2**32, size=70, dtype=np.uint64)
    arr = RArr.encode(vals, block_size=B)
    ops = {k: np.asarray(v) for k, v in arr.device_operands().items()}
    (jt, jq), (tt, tq) = _tables("f32")
    kw = dict(format="vbyte", block_size=B, differential=False)
    r_ops = {k: jnp.asarray(v) for k, v in ops.items()}
    t_ops, _ = _port(ops, {})
    for name, rex, tex in (("bag_sum", {"table": jt}, {"table": tt}),
                           ("dot_score", {"table": jt, "query": jq},
                            {"table": tt, "query": tq})):
        ref = Rdispatch.decode(r_ops, epilogue=name, epilogue_operands=rex,
                               plan="unfused", **kw)
        out = Tdispatch.decode(t_ops, epilogue=name, epilogue_operands=tex,
                               **kw)
        if name == "dot_score":
            assert_same(ref[0], out[0])
            ref, out = ref[1], out[1]
        _assert_float_parity(ref, out, "f32", name)


def test_fused_kernel_gather_parity_tiny():
    """Against the reference's Pallas fused kernel itself (interpret mode),
    tiny: dot_score with three query rows and adjacency_rebase."""
    ops, _ = _id_operands(np.random.default_rng(3), "vbyte", B + 9, 1)
    (jt, jq), (tt, tq) = _tables("f32")
    nb = ops["counts"].shape[0]
    eb = np.arange(nb * B, dtype=np.int32).reshape(nb, B)
    r_ops = {k: jnp.asarray(v) for k, v in ops.items()}
    t_ops, _ = _port(ops, {})
    kw = dict(format="vbyte", block_size=B, differential=True)
    ids, sc = Rdispatch.decode(r_ops, epilogue="dot_score", plan="kernel",
                               epilogue_operands={"table": jt, "query": jq},
                               **kw)
    t_ids, t_sc = Tepi.fused_decode(t_ops, {"table": tt, "query": tq},
                                    epilogue="dot_score", **kw)
    assert_same(ids, t_ids)
    _assert_float_parity(sc, t_sc, "f32", "dot_score")
    ref = Rdispatch.decode(r_ops, epilogue="adjacency_rebase", plan="kernel",
                           epilogue_operands={"edge_base": jnp.asarray(eb)},
                           **kw)
    assert_same(ref, Tepi.fused_decode(t_ops, {"edge_base": torch.tensor(eb)},
                                       epilogue="adjacency_rebase", **kw))
