"""The recsys serving cells over a ``(data, model)`` mesh through
``registry.run_cell`` on the CPU, and the pieces of the recsys rule's
``model`` splits (``tensor_parallel.lookup`` and ``tensor_parallel.mlp``,
``embedding_bag.bag_from_padded`` over a split table).

The module fixture ``reference`` runs
``tests/torch_recsys_model_parallel_reference.py`` once a case, the cases
in parallel subprocesses under 8 forced host devices: ``serve_scores``
and ``retrieval_scores_compressed`` under ``jax.jit(fn,
in_shardings=...)`` over ``(1, 4)`` and ``(2, 2)`` meshes of ``Auto``
axes, at float32 compute (the candidates' stream padded with count-0
blocks to a multiple of the positions, as the port pads it). The
reduced configs' tables have 2^16 rows (600,000 for retrieval), so the
serving rule splits them over ``model`` (by rows; by columns in
``serve_table_mode="column"``), and the MLPs alternate column and row
splits. Retrieval reads 4,093 candidate blocks (BST's ranker: 61), which
do not split evenly over 4 positions.

Bounds: ids bit for bit; scores within ``RTOL = 1e-5`` of the largest
``|score|`` (float32; BST's and the towers' row-parallel sums
re-associate). Against the port's own single device: SASRec and BERT4Rec
(no sum re-associates: a row-split lookup adds one non-zero row) scores
and ids bit for bit, serving and retrieval; BST and two-tower within
``RTOL``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import recsys_params_from_numpy
from repro_torch.core import CompressedIntArray
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.vbyte_decode import dispatch
from repro_torch.models import recsys, registry
from repro_torch.nn import layers as nnl
from repro_torch.nn.embedding_bag import bag_from_padded
from repro_torch.tree import nest

sys.path.insert(0, str(Path(__file__).parent))
from torch_data_parallel_reference import XLA_FAST_COMPILE  # noqa: E402
from torch_recsys_model_parallel_reference import (  # noqa: E402
    CASES, MESHES, N_DEVICES, RETRIEVAL_ITEMS)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
EXACT = ("sasrec", "bert4rec")  # kinds whose outputs are bit for bit
SERVE = [(case, shape, mesh) for case in CASES
         for shape in ("serve_p99", "serve_bulk") for mesh in MESHES]
RETRIEVAL = [(case, mesh) for case, (_, _, nb) in CASES.items() if nb
             for mesh in MESHES]


# the reference's cases, a group a subprocess (jax imported once a group)
GROUPS = (("sasrec", "sasrec_col"), ("bert4rec", "two_tower"), ("bst",))


def _reference_cases(out: Path, cases: tuple) -> dict:
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(f"{flags} {XLA_FAST_COMPILE} "
                          f"--xla_force_host_platform_device_count="
                          f"{N_DEVICES}").strip())
    path = out / f"{cases[0]}.npz"
    proc = subprocess.run(
        [sys.executable,
         str(ROOT / "tests" / "torch_recsys_model_parallel_reference.py"),
         str(path), *cases], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this module runs (its tensors are small;
    the reference's subprocesses run beside it), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs, a group of cases a subprocess, in parallel."""
    assert sorted(c for g in GROUPS for c in g) == sorted(CASES)
    out = tmp_path_factory.mktemp("recsys_model_parallel_reference")
    with ThreadPoolExecutor(len(GROUPS)) as pool:
        parts = pool.map(functools.partial(_reference_cases, out), GROUPS)
    return {k: v for p in parts for k, v in p.items()}


def _mesh(name):
    return make_mesh(MESHES[name], ("data", "model"), devices=["cpu"] * 4)


def _close(got, want, what):
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), (what, err)


def _params(reference, case, cfg, prefix="init"):
    init = nest({k[len(case) + len(prefix) + 2:]: v
                 for k, v in reference.items()
                 if k.startswith(f"{case}/{prefix}/")})
    return recsys_params_from_numpy(init, cfg, device="cpu")


def _serve_cell(case, shape, mesh_name):
    arch, over, _ = CASES[case]
    cell = registry.build_cell(arch, shape, mesh_dp=MESHES[mesh_name][0],
                               overrides=dict(over))
    return dataclasses.replace(cell, fn=functools.partial(
        recsys.serve_scores, cfg=cell.cfg, dtype=torch.float32))


@pytest.mark.parametrize("case,shape,mesh_name", SERVE)
def test_serving_cell_over_the_mesh(reference, case, shape, mesh_name):
    """``serve_p99`` / ``serve_bulk`` (the same function) through
    ``run_cell``: the rows split over the data positions, the tables and
    MLPs over ``model`` as the serving rule says."""
    cell = _serve_cell(case, shape, mesh_name)
    params = _params(reference, case, cell.cfg)
    batch = {k[len(case) + 17:]: torch.as_tensor(v)
             for k, v in reference.items()
             if k.startswith(f"{case}/serve_p99/batch/")}
    with torch.no_grad():
        got, placed = registry.run_cell(cell, _mesh(mesh_name), params,
                                        batch)
        want = cell.fn(params, batch)
    got = shd.whole(got)
    split = [k for k, v in placed.leaves.items()
             if isinstance(v, shd.BlockSharded)]
    assert any(k.endswith("_emb/emb") for k in split), split
    _close(got, reference[f"{case}/serve_p99/{mesh_name}/scores"], case)
    if cell.cfg.kind in EXACT:
        assert torch.equal(got, want)
    else:
        _close(got, want, case)


@pytest.mark.parametrize("case,mesh_name", RETRIEVAL)
def test_retrieval_cell_over_the_mesh(reference, case, mesh_name,
                                      monkeypatch):
    """``retrieval_cand`` through ``run_cell``: the candidates' 4,093
    blocks (BST's 61; count-0 blocks padding them to a multiple of 4)
    decoded a shard at a
    time, one decode call a shard (kernel 2's ``dot_score``, or kernel 1
    then the ranker or the towers); ids and scores gathered, one top-k. A
    second request on the placed parameters ``run_cell`` returned reuses
    them whole, ``dot_score``'s whole table included (made once), and
    gives the same answer bit for bit."""
    arch, over, _ = CASES[case]
    cell = registry.build_cell(arch, "retrieval_cand",
                               mesh_dp=MESHES[mesh_name][0],
                               overrides=dict(over, n_items=RETRIEVAL_ITEMS))
    cfg = cell.cfg
    cell = dataclasses.replace(cell, fn=functools.partial(
        recsys.retrieval_scores_compressed, cfg=cfg, dtype=torch.float32))
    params = _params(reference, case, cfg, "retrieval_init")
    req = {k[len(case) + 22:]: v for k, v in reference.items()
           if k.startswith(f"{case}/retrieval_cand/batch/")}
    batch = {k: torch.as_tensor(v) for k, v in req.items() if k != "ids"}
    batch["cands"] = CompressedIntArray.encode(
        req["ids"].astype(np.uint64), differential=True,
        stride_multiple=256, device="cpu")
    calls = []
    real = dispatch._execute
    monkeypatch.setattr(dispatch, "_execute", lambda *a, **kw: calls.append(
        kw["epilogue"]) or real(*a, **kw))
    mesh = _mesh(mesh_name)
    with torch.no_grad():
        (scores, (top_s, top_ids)), placed = registry.run_cell(
            cell, mesh, params, batch)
    assert calls == ["dot_score" if cfg.kind in EXACT else "stream"] * 4
    monkeypatch.setattr(dispatch, "_execute", real)
    tables = dict(placed.derived)
    assert list(tables) == ([("item_emb/emb", torch.float32)]
                            if cfg.kind in EXACT else [])
    with torch.no_grad():
        (again, (again_s, again_ids)), placed2 = registry.run_cell(
            cell, mesh, placed, batch)
    assert placed2 is placed and all(placed.derived[k] is v
                                     for k, v in tables.items())
    assert torch.equal(again, scores) and torch.equal(again_ids, top_ids)
    with torch.no_grad():
        w_scores, (w_top_s, w_top_ids) = cell.fn(params, batch)
    ref = f"{case}/retrieval_cand/{mesh_name}"
    n = scores.shape[0]  # the request's own slots (the mesh's pad cut)
    np.testing.assert_array_equal(top_ids.numpy(), reference[f"{ref}/top_ids"])
    _close(scores, reference[f"{ref}/scores"][:n], case)
    _close(top_s, reference[f"{ref}/top_s"], case)
    assert torch.equal(top_ids, w_top_ids)
    if cfg.kind in EXACT:
        assert torch.equal(scores, w_scores) and torch.equal(top_s, w_top_s)
    else:
        _close(scores, w_scores, case)


# -- the pieces ---------------------------------------------------------------
def _slices(w, dim, k=4):
    return tp.Slices(tuple(torch.chunk(w, k, dim=dim)), dim)


@pytest.mark.parametrize("dim", [0, 1])
def test_a_split_table_looks_up_the_single_devices_rows(dim):
    """A lookup over a table split by rows or columns, and the mean-bag
    over it, equal the whole table's bit for bit (one non-zero row a sum;
    columns joined); the gradient of each slice is its range of the whole
    table's."""
    g = torch.Generator().manual_seed(0)
    emb = torch.randn(64, 16, generator=g)
    ids = torch.randint(0, 64, (5, 7), generator=g)
    ids[0, :3] = 0  # padding
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            tp.lookup(_slices(emb, dim), ids, home="cpu", dtype=dtype),
            nnl.embedding_lookup(emb, ids, dtype=dtype))
        assert torch.equal(
            bag_from_padded(_slices(emb, dim), ids, mode="mean", dtype=dtype),
            bag_from_padded(emb, ids, mode="mean", dtype=dtype))
    parts = [p.clone().requires_grad_(True)
             for p in torch.chunk(emb, 4, dim=dim)]
    w = torch.randn(5, 7, 16, generator=g)
    (tp.lookup(tp.Slices(tuple(parts), dim), ids, home="cpu",
               dtype=torch.float32) * w).sum().backward()
    whole = emb.clone().requires_grad_(True)
    (torch.nn.functional.embedding(ids, whole) * w).sum().backward()
    assert torch.equal(torch.cat([p.grad for p in parts], dim), whole.grad)


def test_a_split_mlp_matches_the_whole_one():
    """The recsys rule's MLP splits (layer 0 by columns with its bias,
    layer 1 by rows, layer 2 by columns, a last layer too narrow to split
    whole) against ``nn.layers.mlp``: the column layers bit for bit, the
    row layer's float32 partials within ``RTOL``."""
    g = torch.Generator().manual_seed(1)
    mlp = nnl.mlp_init((24, 32, 16, 32, 1), generator=g)
    for b in mlp.b:
        b.data.normal_(generator=g)
    x = torch.randn(6, 24, generator=g)
    rule = shd.recsys_param_spec(None)
    split = type("V", (), {"w": [], "b": []})
    for i, (w, b) in enumerate(zip(mlp.w, mlp.b)):
        for leaf, name, out in ((w, "w", split.w), (b, "b", split.b)):
            spec = rule(f"mlp/layer_{i}/{name}", leaf)
            dim = next((d for d, a in enumerate(spec) if a == tp.MODEL), None)
            out.append(leaf if dim is None else _slices(leaf.detach(), dim))
    assert [type(w).__name__ for w in split.w] == ["Slices"] * 3 + ["Parameter"]
    want = nnl.mlp(mlp, x, dtype=torch.float32)
    got = tp.mlp(split, x, home="cpu", dtype=torch.float32)
    _close(got.detach(), want.detach(), "mlp")
    first = type("V", (), {"w": split.w[:1], "b": split.b[:1]})
    one = type("V", (), {"w": list(mlp.w[:1]), "b": list(mlp.b[:1])})
    assert torch.equal(tp.mlp(first, x, home="cpu", dtype=torch.float32),
                       nnl.mlp(one, x, dtype=torch.float32))
