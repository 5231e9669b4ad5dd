"""Block-sharded decode in the port, on a mesh of 8 logical ``cpu`` shards
(the counterpart of the reference's 8 forced host devices), mirroring
``tests/test_sharded_decode.py``: stream parity for 3 formats, ragged
arrays with empty bags, ``plan="sharded"`` on unsharded operands, every
fused epilogue the serving and search paths use, multi-query
``dot_score``. Integers are held bit for bit against the reference's
single-device decode, floats within ``torch_parity.float_close``; the
port's sharded output against its own single-device output bit for bit.
In place of the reference's HLO check for collectives, each per-shard
``_execute`` call is recorded: one a shard, each on its own block range
and device.

The module fixture ``reference`` runs the reference's own sharded path
once, in a subprocess under ``--xla_force_host_platform_device_count=8``
(``tests/torch_sharded_reference.py``, ~30 s), and the port's 8-shard
decodes, ``SearchEngine`` answers and ``QueryStats`` and ``ServingEngine``
top-k are held against it bit for bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import CompressedIntArray as RArr
from repro.kernels.vbyte_decode import dispatch as Rdispatch
from repro_torch.core import CompressedIntArray as TArr
from repro_torch.distributed import (BlockSharded, activate_mesh,
                                     compressed_block_specs, current_mesh,
                                     make_mesh, replicate)
from repro_torch.distributed.api import _resolve_axes
from repro_torch.kernels.vbyte_decode import dispatch
from repro_torch.launch.mesh import dp_degree, make_host_mesh

from torch_parity import CPU, assert_same, float_close

import torch_sharded_reference as refrun

ROOT = Path(__file__).resolve().parents[1]
FMTS = ("vbyte", "streamvbyte", "binpack")
B = refrun.B
N_SHARDS = refrun.N_DEVICES
PLANS = ("torch", "cuda")  # "cuda" on CPU tensors: kernel 2's plain twin


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((N_SHARDS,), ("data",), devices=["cpu"] * N_SHARDS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 8-device sharded run, once per module."""
    out = tmp_path_factory.mktemp("sharded_reference") / "reference.npz"
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(f"{flags} --xla_force_host_platform_device_count="
                          f"{N_SHARDS}").strip())
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_reference.py"),
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


def _values(rng, n, differential):
    if differential:
        return np.sort(rng.integers(0, 2**20, n)).astype(np.uint64)
    return rng.integers(0, 2**32, n).astype(np.uint64)


def _pair(vals, fmt, differential, mesh):
    """(reference array, port array, port array sharded over ``mesh``)."""
    kw = dict(format=fmt, block_size=B, differential=differential)
    arr = TArr.encode(vals, device=CPU, **kw)
    return RArr.encode(vals, **kw), arr, arr.shard(mesh)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _gathered(out):
    return tuple(o.gather() for o in _tuple(out))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_mesh_api():
    m = make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2} and m.devices.size == 8
    assert m.devices.shape == (4, 2) and m.devices[3, 1] == CPU
    assert m == make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    assert dp_degree(m) == 4
    assert _resolve_axes(("data", "pod", ("pod", "data"), ("pod",), None),
                         m) == ("data", None, ("data",), None, None)
    assert current_mesh() is None
    with activate_mesh(m) as active:
        assert active is m and current_mesh() is m
    assert current_mesh() is None
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1, "model": 1} and dp_degree(host) == 1
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((8,), ("data",), devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh((8,), ("data",))
    assert compressed_block_specs("binpack", "data") == {
        "widths": ("data", None), "data": ("data", None),
        "counts": ("data",), "bases": ("data",)}


def test_shard_layout_and_single_device_methods_refuse(mesh):
    vals = _values(np.random.default_rng(1), 10 * B + 3, True)
    _, arr, sh = _pair(vals, "vbyte", True, mesh)
    assert arr.n_blocks == 11 and sh.n_blocks == 16  # padded to divide 8
    assert sh.sharding == (mesh, ("data",)) and arr.sharding is None
    assert isinstance(sh.payload, BlockSharded)
    assert [s.shape[0] for s in sh.payload.shards] == [2] * N_SHARDS
    assert sh.stride == arr.stride and sh.n == arr.n
    assert sh.counts_host.tolist() == arr.counts_host.tolist() + [0] * 5
    assert torch.equal(sh.payload.gather()[:11], arr.payload)
    assert not sh.payload.gather()[11:].any()
    assert sh.resident_bytes > arr.resident_bytes  # the padding blocks
    assert sh.bits_per_int == arr.bits_per_int
    for call in (lambda: sh.to("cpu"), sh.leaves_numpy,
                 lambda: sh.take_blocks([0, 1]),
                 lambda: sh.slice_blocks(0, 2), sh.decode_scalar_oracle):
        with pytest.raises(TypeError, match="shard"):
            call()
    with pytest.raises(TypeError, match="already sharded"):
        sh.shard(mesh)
    # a mesh of one shard leaves the array as it is
    one = arr.shard(make_mesh((1,), ("data",), devices=["cpu"]))
    assert one.sharding is None and one.n_blocks == arr.n_blocks
    # an axis absent from the mesh is dropped: one shard again
    assert arr.shard(mesh, axis="model").sharding is None
    ones = torch.ones(3)
    rep = replicate(ones, mesh)  # one copy a distinct device: the tensor
    assert len(rep.copies) == 1 and rep.on("cpu") is ones


# ---------------------------------------------------------------------------
# stream decode parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("n", [B - 1, 2 * B + 7, 40 * B + 3])
def test_sharded_stream_parity(mesh, fmt, differential, n):
    vals = _values(np.random.default_rng(n), n, differential)
    ref_arr, arr, sh = _pair(vals, fmt, differential, mesh)
    ref = np.asarray(ref_arr.decode_blocked(plan="jnp"))
    assert sh.n_blocks % N_SHARDS == 0
    for plan in ("sharded",) + PLANS:
        out = dispatch.decode(sh, plan=plan)
        assert isinstance(out, BlockSharded) and out.shape == (sh.n_blocks, B)
        grid = out.gather()
        assert_same(ref, grid[:arr.n_blocks], f"{fmt} {plan}")
        assert not grid[arr.n_blocks:].any()  # padding decodes to nothing
        assert torch.equal(grid[:arr.n_blocks], dispatch.decode(
            arr, plan="auto" if plan == "sharded" else plan))
    np.testing.assert_array_equal(sh.decode(), vals.astype(np.uint32))


@pytest.mark.parametrize("fmt", FMTS)
def test_sharded_ragged_with_empty_bags(mesh, fmt):
    rng = np.random.default_rng(3)
    lists = [np.sort(rng.choice(np.arange(1, 500), size=k, replace=False))
             .astype(np.uint64) for k in rng.integers(0, B + 1, size=11)]
    lists[2] = np.zeros(0, np.uint64)
    lists[10] = np.zeros(0, np.uint64)
    kw = dict(format=fmt, block_size=B, differential=True)
    arr = TArr.encode_ragged(lists, device=CPU, **kw)
    sh = arr.shard(mesh)
    np.testing.assert_array_equal(sh.decode(), arr.decode())
    np.testing.assert_array_equal(
        sh.decode(), RArr.encode_ragged(lists, **kw).decode(plan="jnp"))
    grid = sh.decode_blocked().gather()
    assert torch.equal(grid[:arr.n_blocks], arr.decode_blocked())


def test_plan_sharded_requires_sharded_operands(mesh):
    arr = TArr.encode(np.arange(100, dtype=np.uint64), device=CPU)
    with pytest.raises(ValueError, match="requires operands"):
        dispatch.decode(arr, plan="sharded")
    one = arr.shard(make_mesh((1,), ("data",), devices=["cpu"]))
    with pytest.raises(ValueError, match="requires operands"):
        dispatch.decode(one, plan="sharded")
    # operands sharded over two different meshes are refused, not gathered
    sh = arr.shard(mesh)
    other = arr.shard(make_mesh((2,), ("data",), devices=["cpu"] * 2))
    ops = dict(sh.device_operands(), bases=other.bases)
    with pytest.raises(ValueError, match="inconsistently"):
        dispatch.decode(ops, format="vbyte", block_size=128,
                        differential=False)


# ---------------------------------------------------------------------------
# fused epilogue parity
# ---------------------------------------------------------------------------
def _epilogue_cases(rng, fmt, sh, arr, table, query):
    """(name, epilogue, port extras (padded rows), reference extras (the
    array's own rows), float?) for every epilogue the paths launch."""
    nb, nbp = arr.n_blocks, sh.n_blocks
    eb = rng.integers(0, 512, (nbp, B)).astype(np.int32)
    probe = np.sort(rng.choice(512, 64, replace=False)).astype(np.int32)[None]
    rows = rng.integers(0, 512, (nbp, 1)).astype(np.int32)
    imps = rng.integers(1, 256, arr.n).astype(np.uint64)
    w_t = TArr.encode(imps, format=fmt, block_size=B, device=CPU).shard(
        sh.sharding[0])
    w_r = RArr.encode(imps, format=fmt, block_size=B)
    w_t = {f"w_{k}": v for k, v in w_t.device_operands().items()
           if k not in ("counts", "bases")}
    w_r = {f"w_{k}": jnp.asarray(v) for k, v in w_r.device_operands().items()
           if k not in ("counts", "bases")}
    t = torch.as_tensor
    imp = np.array([[7]], np.int32)
    return [
        ("bag_sum", "bag_sum", {"table": t(table)},
         {"table": jnp.asarray(table)}, True),
        ("dot_score1", "dot_score", {"table": t(table), "query": t(query[:1])},
         {"table": jnp.asarray(table), "query": jnp.asarray(query[:1])},
         True),
        ("dot_score4", "dot_score", {"table": t(table), "query": t(query)},
         {"table": jnp.asarray(table), "query": jnp.asarray(query)}, True),
        ("adjacency_rebase", "adjacency_rebase", {"edge_base": t(eb)},
         {"edge_base": jnp.asarray(eb[:nb])}, False),
        ("checksum", "checksum", {}, {}, False),
        ("membership", "membership", {"probe": t(probe)},
         {"probe": jnp.asarray(probe)}, False),
        ("bm25_accum", "bm25_accum", {"probe": t(probe), "impact": t(imp)},
         {"probe": jnp.asarray(probe), "impact": jnp.asarray(imp)}, False),
        ("bm25_weighted", "bm25_weighted", {"probe": t(probe), **w_t},
         {"probe": jnp.asarray(probe), **w_r}, False),
        ("membership_rows", "membership_rows", {"probe": t(rows)},
         {"probe": jnp.asarray(rows[:nb])}, False),
        ("bm25_accum_rows", "bm25_accum_rows",
         {"probe": t(rows), "impact": t(imp)},
         {"probe": jnp.asarray(rows[:nb]), "impact": jnp.asarray(imp)},
         False),
        ("bm25_weighted_rows", "bm25_weighted_rows",
         {"probe": t(rows), **w_t}, {"probe": jnp.asarray(rows[:nb]), **w_r},
         False),
    ]


def _single_extras(extras, nb, nbp):
    """The single-device twin of sharded extras (tiled ones with ``nbp``
    rows, padding included): the array's own ``nb`` rows."""
    out = {}
    for k, v in extras.items():
        v = v.gather() if isinstance(v, BlockSharded) else v
        out[k] = v[:nb] if v.shape[0] == nbp else v
    return out


def _abs_sum(ep, arr, extras, plan):
    """Σ|product| of a float epilogue (for ``float_close``)."""
    ex = {k: v.abs() for k, v in extras.items()}
    out = dispatch.decode(arr, epilogue=ep, epilogue_operands=ex, plan=plan)
    return _tuple(out)[-1]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("plan", PLANS)
def test_sharded_fused_epilogues_parity(mesh, fmt, plan):
    rng = np.random.default_rng(5)
    vals = np.sort(rng.integers(0, 512, 10 * B + 9)).astype(np.uint64)
    table = rng.standard_normal((512, 16)).astype(np.float32)
    query = rng.standard_normal((4, 16)).astype(np.float32)
    ref_arr, arr, sh = _pair(vals, fmt, True, mesh)
    nb = arr.n_blocks
    for name, ep, ex, rex, is_float in _epilogue_cases(rng, fmt, sh, arr,
                                                       table, query):
        out = _gathered(dispatch.decode(sh, epilogue=ep,
                                        epilogue_operands=ex, plan=plan))
        single_ex = _single_extras(ex, nb, sh.n_blocks)
        single = _tuple(dispatch.decode(arr, epilogue=ep,
                                        epilogue_operands=single_ex,
                                        plan=plan))
        ref = _tuple(Rdispatch.decode(ref_arr, epilogue=ep,
                                      epilogue_operands=rex, plan="jnp"))
        for o, s, r in zip(out, single, ref):
            msg = f"{fmt}/{name}/{plan}"
            assert torch.equal(o[:nb], s), msg  # sharded == single, bits
            if ep != "dot_score" or not o.is_floating_point():
                # padding blocks: zeros (dot_score's pad slots score row 0)
                assert not o[nb:].any(), msg
            if is_float and o.is_floating_point():
                s_abs = _abs_sum(ep, arr, single_ex, plan)
                assert float_close(o[:nb], torch.as_tensor(np.asarray(r)),
                                   bf16=False, terms=16, s_abs=s_abs), msg
            else:
                assert_same(r, o[:nb], msg)


@pytest.mark.parametrize("plan", PLANS)
def test_multi_query_dot_score_equals_per_query(mesh, plan):
    """The ``[b, d]`` query microbatch against ``b`` one-row passes: ids
    bit for bit, scores within ``float_close`` (the f32 products are summed
    in another order; the reference's bit-exact form of this test fails by
    one f32 ulp under jax 0.9)."""
    rng = np.random.default_rng(9)
    vals = np.sort(rng.integers(0, 256, 4 * B)).astype(np.uint64)
    table = torch.as_tensor(rng.standard_normal((256, 8)).astype(np.float32))
    qs = torch.as_tensor(rng.standard_normal((3, 8)).astype(np.float32))
    sh = TArr.encode(vals, block_size=B, differential=True,
                     device=CPU).shard(mesh)
    ids_b, scores_b = _gathered(dispatch.decode(
        sh, epilogue="dot_score", epilogue_operands={"table": table,
                                                     "query": qs},
        plan=plan))
    assert scores_b.shape == (sh.n_blocks, B, 3)
    for j in range(3):
        ex = {"table": table, "query": qs[j:j + 1]}
        ids_1, scores_1 = _gathered(dispatch.decode(
            sh, epilogue="dot_score", epilogue_operands=ex, plan=plan))
        s_abs = _gathered(dispatch.decode(
            sh, epilogue="dot_score",
            epilogue_operands={k: v.abs() for k, v in ex.items()},
            plan=plan))[1]
        assert torch.equal(ids_b, ids_1)
        assert float_close(scores_b[..., j], scores_1, bf16=False, terms=8,
                           s_abs=s_abs)


# ---------------------------------------------------------------------------
# one _execute a shard, each on its own block range (the reference checks
# that its compiled decode holds no collective)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", FMTS)
def test_execute_runs_once_per_shard_on_its_blocks(mesh, fmt, monkeypatch):
    vals = _values(np.random.default_rng(4), 16 * B + 5, True)
    _, arr, sh = _pair(vals, fmt, True, mesh)
    calls = []
    real = dispatch._execute

    def record(operands, extras, **kw):
        calls.append((operands, extras))
        return real(operands, extras, **kw)

    monkeypatch.setattr(dispatch, "_execute", record)
    table = torch.randn(1 << 20, 4)
    for ep, ex in (("stream", {}), ("checksum", {}),
                   ("dot_score", {"table": table,
                                  "query": torch.randn(2, 4)})):
        calls.clear()
        dispatch.decode(sh, epilogue=ep, epilogue_operands=ex)
        assert len(calls) == N_SHARDS, ep
        per = sh.n_blocks // N_SHARDS
        main = "payload" if fmt == "vbyte" else "data"
        full = getattr(sh, main).gather()
        for i, (ops, extras) in enumerate(calls):
            assert ops["counts"].shape == (per,)
            assert ops[main].device == mesh.devices[i]
            assert torch.equal(ops[main], full[i * per:(i + 1) * per])
            # a replicated operand is the caller's tensor, not a copy
            for k, v in extras.items():
                assert v.data_ptr() == ex[k].data_ptr(), k
    # a 1-shard mesh takes the single-device body once, on the whole array
    calls.clear()
    one = arr.shard(make_mesh((1,), ("data",), devices=["cpu"]))
    out = dispatch.decode(one)
    assert len(calls) == 1 and isinstance(out, torch.Tensor)
    assert calls[0][0]["counts"].shape == (arr.n_blocks,)


# ---------------------------------------------------------------------------
# against the reference's own sharded run (8 forced host devices)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", FMTS)
def test_sharded_decode_matches_reference_mesh(mesh, reference, fmt):
    z = reference
    for diff in (0, 1):
        for tag in refrun.DECODE_N:
            key = f"dec/{fmt}/{diff}/{tag}"
            arr = TArr.encode(z[key + "/vals"], format=fmt, block_size=B,
                              differential=bool(diff), device=CPU)
            out = dispatch.decode(arr.shard(mesh), plan="sharded").gather()
            assert_same(z[key + "/stream"], out, key)
    key = f"fused/{fmt}"
    sh = TArr.encode(z[key + "/vals"], format=fmt, block_size=B,
                     differential=True, device=CPU).shard(mesh)
    t, q4 = torch.as_tensor(z[key + "/table"]), torch.as_tensor(z[key + "/q4"])
    cases = {"bag_sum": {"table": t},
             "dot_score1": {"table": t, "query": q4[:1]},
             "dot_score4": {"table": t, "query": q4},
             "adjacency_rebase": {"edge_base": torch.as_tensor(
                 z[key + "/edge_base"])}}
    for name, ex in cases.items():
        ep = name.rstrip("14")
        out = _gathered(dispatch.decode(sh, epilogue=ep,
                                        epilogue_operands=ex))
        for i, o in enumerate(out):
            r = z[f"{key}/{name}/{i}"]
            if o.is_floating_point():
                s_abs = _gathered(dispatch.decode(
                    sh, epilogue=ep,
                    epilogue_operands={k: v.abs() for k, v in ex.items()}))
                assert float_close(o, torch.as_tensor(r), bf16=False,
                                   terms=B if ep == "bag_sum" else 16,
                                   s_abs=s_abs[-1]), name
            else:
                assert_same(r, o, f"{key}/{name}")


def _stats_json(st) -> dict:
    return json.loads(refrun.stats_json(st))


@pytest.mark.parametrize("fmt", FMTS)
def test_sharded_search_matches_reference_mesh(mesh, reference, fmt):
    from repro_torch.index import QueryStats, build_index
    from repro_torch.launch.serve import SearchEngine

    z = reference
    lists = {t: z[f"search/{fmt}/list{t}"]
             for t in range(len(refrun.SEARCH_SIZES))}
    idx = build_index(lists, format=fmt, block_size=B, n_docs=refrun.U,
                      device=CPU)
    engine = SearchEngine(idx, mesh=mesh, top_k=8)
    assert not engine.use_skip and engine.device == CPU
    assert json.loads(str(z[f"search/{fmt}/index_stats"])) == \
        engine.index.stats()  # n_blocks counts the padding blocks
    for terms in refrun.SEARCH_TERMS:
        for mode in refrun.SEARCH_MODES:
            key = f"search/{fmt}/{'-'.join(map(str, terms))}/{mode}"
            st = QueryStats()
            out = _tuple(engine.search(terms, mode, stats=st))
            for i, o in enumerate(out):
                r = z[f"{key}/{i}"]
                assert o.dtype == r.dtype, key
                np.testing.assert_array_equal(o, r, err_msg=key)
            assert _stats_json(st) == json.loads(str(z[key + "/stats"])), key


def test_sharded_serving_matches_reference_mesh(mesh, reference):
    from repro.models import recsys as R
    from repro.models import registry as Rreg
    from repro_torch.convert import recsys_params_from_numpy
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import registry as Treg

    z = reference
    arch = "two-tower-retrieval"
    cfg = Rreg.reduced_config(arch)
    params = R.init_params(jax.random.PRNGKey(0), cfg)
    tp = recsys_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  Treg.reduced_config(arch), device=CPU)
    corpus = TArr.encode(z["serve/cands"], differential=True, device=CPU)
    engine = ServingEngine(tp, Treg.reduced_config(arch), corpus, mesh=mesh,
                           top_k=5)
    assert engine.corpus.n_blocks == int(z["serve/n_blocks"])
    for b in (1, 2, 4):
        s, i = engine.retrieve(torch.as_tensor(z[f"serve/{b}/uid"]),
                               torch.as_tensor(z[f"serve/{b}/hist"]))
        assert_same(z[f"serve/{b}/ids"], i, f"bucket {b}")
        np.testing.assert_array_equal(s.float().numpy(),
                                      z[f"serve/{b}/scores"],
                                      err_msg=f"bucket {b}")
