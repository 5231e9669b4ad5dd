"""A microbatch split by rows over a mesh's positions, its loss reduced
across them (``distributed/data_parallel.py``), on the CPU: every recsys
and GIN train cell and an LM step whose microbatch count the data
positions do not divide, through ``train.jit_train_step`` over logical
``cpu`` shards.

The module fixture ``reference`` runs ``tests/torch_data_parallel_reference.py``
once a case, the cases in parallel subprocesses under 8 forced host
devices: the reference's train cell at float32 compute under
``jax.jit(step, in_shardings=cell.in_shardings(mesh))`` over ``(2, 1)``,
``(4, 1)`` and ``(2, 2)`` meshes of ``Auto`` axes, the recsys cells also
with ZeRO-1 over ``(2, 2)``, the LM at microbatch 2 over ``(4, 1)``. The
reduced configs make every rule bite: the recsys tables have 2^16 items
(split by rows over ``model``, ZeRO-1 splits them over ``data``), the MLPs
alternate column and row splits, the GIN graph's 1,000 edges fill 8 gap
blocks unevenly (the positions' block ranges do not meet their
``edge_valid`` ranges, and owners straddle positions).

Bounds (float32 on both sides; the sums across positions re-associate,
as XLA's and torch's CPU kernels do):

* each step's loss and grad norm within ``RTOL = 1e-5`` relative of the
  reference's and of the port's single-device step;
* every leaf's change over the steps within relative L2 ``STEP_RL2`` of
  theirs: 2^-14 over ``(n, 1)`` and 2^-5 over ``(2, 2)`` (where an AdamW
  step moves an element whose gradient near 0 changed sign by ``lr``
  either way); the LM's within ``LM_STEP_RL2 = 2^-10`` (its attention
  output projection reads 3.8e-4 with no split at all: the port's
  single-device step against the reference);
* ZeRO-1 rounds the compute copy and every gradient to bf16 (the hooks).
  The positions read a float32 copy of the bf16 compute copy (exact), so
  a gradient stays float32 until the positions' sum is rounded once; one
  device adds a table's three lookups' gradients in bf16 (SASRec's table
  gradient reads 2.4e-3 from the single device's in the first step, every
  other leaf bit for bit). So its losses are held within ``Z1_RTOL =
  2^-12`` (read at most 1.0e-4), its first grad norm within 2^-7 (PR 25's
  ZeRO-1 bound; BERT4Rec reads 9.5e-4 against the single device), its
  later ones within ``Z1_NORM_RTOL = 2^-5`` (SASRec reads 1.0e-2: one
  AdamW step at lr 1e-2 moves a table element, of scale 0.02, by lr
  either way where its bf16 gradient was near 0), its leaves' change
  within 2^-5.

Bit for bit against the port's own single-device step: a one-position
mesh, the ``molecule`` cell (its batch replicated: the first position
computes it) and a split whose ``per_shard`` is whole (``n | mb``, the
dealing ``tests/test_torch_sharded_train.py`` holds).
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

from repro_torch import convert
from repro_torch.distributed import data_parallel as dp
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.models import gnn, lm, recsys, registry
from repro_torch.train import (OptimizerConfig, jit_train_step,
                               make_train_step, param_leaves)
from repro_torch.tree import flatten, nest

sys.path.insert(0, str(Path(__file__).parent))
from torch_data_parallel_reference import (CASES, MESHES,  # noqa: E402
                                           N_DEVICES, PEAK_LR, STEPS,
                                           XLA_FAST_COMPILE,
                                           compressed_graph)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
Z1_RTOL = 2.0**-12
Z1_NORM_RTOL = 2.0**-5  # after the first step
STEP_RL2 = {1: 2.0**-14, 2: 2.0**-5}  # by the mesh's model axis
LM_STEP_RL2 = 2.0**-10
OPT = OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)
RUNS = [(case, mesh, z) for case, (_, _, _, runs) in CASES.items()
        for mesh, z in runs]
MODULES = {"lm": lm, "gnn": gnn, "recsys": recsys}
FROM_TREE = {"lm": convert.lm_train_state_from_tree,
             "gnn": convert.gnn_train_state_from_tree,
             "recsys": convert.recsys_train_state_from_tree}


# the reference's cases, a group a subprocess: a recsys or LM cell beside
# a GIN one, so that each pays jax's import once for two
GROUPS = (("sasrec", "gin_molecule"), ("bert4rec", "gin_raw"),
          ("bst", "gin_full"), ("two_tower", "lm"))


def _reference_cases(out: Path, cases: tuple) -> dict:
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(f"{flags} {XLA_FAST_COMPILE} "
                          f"--xla_force_host_platform_device_count="
                          f"{N_DEVICES}").strip())
    path = out / f"{cases[0]}.npz"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_data_parallel_reference.py"),
         str(path), *cases], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=240)
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
    out = tmp_path_factory.mktemp("data_parallel_reference")
    with ThreadPoolExecutor(len(GROUPS)) as pool:
        parts = pool.map(functools.partial(_reference_cases, out), GROUPS)
    return {k: v for p in parts for k, v in p.items()}


def _rl2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _cell(case: str, n: int, zero1: bool):
    arch, shape, over, _ = CASES[case]
    return registry.build_cell(arch, shape, mesh_dp=n, overrides=dict(
        over, zero1=True) if zero1 else dict(over), opt_cfg=OPT)


def _inputs(reference, case: str, cfg):
    """The reference's initial state (through ``*_train_state_from_tree``)
    and batch as the port's."""
    fam = registry.family_of(CASES[case][0])
    init = nest({k[len(case) + 6:]: v for k, v in reference.items()
                 if k.startswith(f"{case}/init/")})
    raw = {k[len(case) + 7:]: v for k, v in reference.items()
           if k.startswith(f"{case}/batch/")}
    if fam == "gnn" and cfg.compressed_adjacency:
        raw = compressed_graph(raw, pad_to=4, device="cpu", torch=True)
    batch = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
             for k, v in raw.items()}
    return (lambda: FROM_TREE[fam](init, cfg, device="cpu")), batch


def _step(cell, *, hooks: bool = True):
    """The cell's step at float32 compute (the cell's ZeRO-1 hooks)."""
    fam = cell.family
    loss = functools.partial(MODULES[fam].loss_fn, cfg=cell.cfg,
                             dtype=torch.float32)
    kw = {}
    if hooks and cell.fn.compute_cast is not None:
        kw = dict(compute_cast=cell.fn.compute_cast,
                  grad_transform=cell.fn.grad_transform)
    return make_train_step(loss, OPT, microbatch=cell.fn.microbatch, **kw)


def _specs(cell, batch):
    specs = cell.arg_specs
    if "gaps" in batch:  # the graph's own stream (its n), as the cell's
        specs = (specs[0], dict(specs[1], gaps=shd.compressed_array_specs(
            batch["gaps"], axis=shd.ALL)))
    return specs


def _run(step, init, batch):
    state = init()
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


_MESH_RUNS = {}


def _over_mesh(reference, case, mesh_name, zero1):
    """The port's run of the cell over the mesh (once a module: the test
    against the reference and the one against the single device read the
    same run)."""
    key = (id(reference), case, mesh_name, zero1)
    if key not in _MESH_RUNS:
        _MESH_RUNS[key] = _mesh_run(reference, case, mesh_name, zero1)
    return _MESH_RUNS[key]


def _mesh_run(reference, case, mesh_name, zero1):
    shape = MESHES[mesh_name]
    cell = _cell(case, shape[0], zero1)
    init, batch = _inputs(reference, case, cell.cfg)
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))
    sharded = jit_train_step(_step(cell), in_shardings=shd.to_named(
        mesh, _specs(cell, batch)))
    return cell, init, batch, sharded, _run(sharded, init, batch)


def _hold(got, want, shape, zero1, what):
    (mg, sg), (mw, pw, p0) = got, want
    loss = [m["loss"] for m in mg]
    norm = [m["grad_norm"] for m in mg]
    if zero1:
        assert _rel(loss, mw["loss"]).max() <= Z1_RTOL, (what, loss)
        assert _rel(norm[:1], mw["grad_norm"][:1]).max() <= 2.0**-7, what
        assert _rel(norm[1:], mw["grad_norm"][1:]).max() <= Z1_NORM_RTOL
    else:
        assert _rel(loss, mw["loss"]).max() <= RTOL, (what, loss)
        assert _rel(norm, mw["grad_norm"]).max() <= RTOL, (what, norm)
    bound = STEP_RL2[2] if zero1 else STEP_RL2[shape[1]]
    if what.startswith("lm"):
        bound = max(bound, LM_STEP_RL2)
    for k, v in param_leaves(sg["params"]).items():
        d = shd.whole(v).detach().numpy() - p0[k]
        assert _rl2(d, pw[k] - p0[k]) <= bound, (what, k)


@pytest.mark.parametrize("case,mesh_name,zero1", RUNS)
def test_train_cell_against_the_reference(reference, case, mesh_name, zero1):
    """The cell over the mesh against the reference's jitted cell on the
    same mesh, from the same state and batch."""
    _, _, _, sharded, got = _over_mesh(reference, case, mesh_name, zero1)
    assert sharded.split or sharded.rows == [(sharded.devices[0],)]
    tag = f"{case}/{mesh_name}{'z1' if zero1 else ''}"
    want = ({"loss": reference[f"{tag}/loss"],
             "grad_norm": reference[f"{tag}/grad_norm"]},
            {k[len(tag) + 8:]: v for k, v in reference.items()
             if k.startswith(f"{tag}/params/")},
            {k[len(case) + 13:]: v for k, v in reference.items()
             if k.startswith(f"{case}/init/params/")})
    _hold(got, want, MESHES[mesh_name], zero1, tag)


@pytest.mark.parametrize("case,mesh_name,zero1", RUNS)
def test_train_cell_against_the_single_device_step(reference, case,
                                                   mesh_name, zero1):
    """The same run against the port's single-device step (its hooks
    included): within the bounds; the molecule cell (a replicated batch,
    computed at the first position) bit for bit."""
    cell, init, batch, sharded, (mg, sg) = _over_mesh(reference, case,
                                                      mesh_name, zero1)
    m1, s1 = _run(_step(cell), init, batch)
    if case == "gin_molecule":
        assert not sharded.split and sharded.per_shard == 1
        assert mg == m1
        for (k, a), (_, b) in zip(flatten(convert.train_state_tree(sg)),
                                  flatten(convert.train_state_tree(s1))):
            assert torch.equal(a, b), k
        return
    p1 = {k: v.detach().numpy() for k, v in param_leaves(
        s1["params"]).items()}
    p0 = {k: v.detach().numpy() for k, v in param_leaves(
        init()["params"]).items()}
    _hold((mg, sg), ({"loss": [m["loss"] for m in m1],
                      "grad_norm": [m["grad_norm"] for m in m1]}, p1, p0),
          MESHES[mesh_name], zero1, case)


def test_one_position_mesh_gives_the_single_device_step(reference):
    """A mesh of one position splits nothing: the single-device step's
    bits, for a recsys and a GIN cell."""
    for case in ("two_tower", "gin_full"):
        cell = _cell(case, 1, False)
        init, batch = _inputs(reference, case, cell.cfg)
        mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
        sharded = jit_train_step(_step(cell), in_shardings=shd.to_named(
            mesh, _specs(cell, batch)))
        assert not sharded.split and sharded.per_shard == 1
        mg, sg = _run(sharded, init, batch)
        m1, s1 = _run(_step(cell), init, batch)
        assert mg == m1
        for (k, a), (_, b) in zip(flatten(convert.train_state_tree(sg)),
                                  flatten(convert.train_state_tree(s1))):
            assert torch.equal(a, b), k


def test_a_deal_where_the_positions_divide_the_microbatch_count(reference):
    """The LM case over 4 positions at microbatch 4: one whole part to each
    position, bit for bit with the single-device step (at microbatch 2,
    the reference case, each part's rows split)."""
    cell = _cell("lm", 4, False)
    cfg = dataclasses.replace(cell.cfg, microbatch=4)
    init, batch = _inputs(reference, "lm", cfg)
    step = make_train_step(functools.partial(lm.loss_fn, cfg=cfg,
                                             dtype=torch.float32), OPT,
                           microbatch=4)
    mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    sharded = jit_train_step(step, in_shardings=cell.in_shardings(mesh))
    assert not sharded.split and sharded.per_shard == 1
    mg, sg = _run(sharded, init, batch)
    m1, s1 = _run(step, init, batch)
    assert mg == m1
    for (k, a), (_, b) in zip(flatten(convert.train_state_tree(sg)),
                              flatten(convert.train_state_tree(s1))):
        assert torch.equal(a, b), k


# -- the pieces ---------------------------------------------------------------
def test_share_adds_the_positions_gradients_in_position_order():
    """``RowSplit.share``: every position the joined pieces; the backward
    the float32 sum in position order, rounded once to each piece's
    dtype."""
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 4, generator=g, dtype=torch.bfloat16)
          .requires_grad_(True) for _ in range(3)]
    split = dp.RowSplit((None,) * 3, (torch.device("cpu"),) * 3)
    outs = split.share(xs)
    whole = torch.cat([x.detach() for x in xs])
    assert all(torch.equal(o, whole) for o in outs)
    ws = [torch.randn(9, 4, generator=g) for _ in range(3)]
    sum(((o.float() * w).sum() for o, w in zip(outs, ws)),
        torch.zeros(())).backward()
    # each output's gradient arrives in bf16 (the backward of .float())
    g = [w.to(torch.bfloat16).float() for w in ws]
    want = ((g[0] + g[1]) + g[2]).to(torch.bfloat16)
    assert torch.equal(torch.cat([x.grad for x in xs]), want)


def test_split_rows_follows_the_batch_specs():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    devs = dp.row_devices(mesh, ("data",))
    batch = {"a": torch.arange(8).reshape(4, 2), "neg": torch.arange(5),
             "n": 3}
    sh = shd.to_named(mesh, {"a": (shd.DP, None), "neg": (None,)})
    parts = dp.split_rows(batch, sh, devs, mesh)
    assert [p["a"].tolist() for p in parts] == [[[0, 1], [2, 3]],
                                                [[4, 5], [6, 7]]]
    assert all(torch.equal(p["neg"], batch["neg"]) and p["n"] == 3
               for p in parts)
    assert dp.row_axes(mesh, sh) == ("data",)
    assert dp.row_axes(mesh, shd.to_named(mesh, {"a": (shd.ALL, None)})) \
        == ("data", "model")
    with pytest.raises(ValueError, match="do not split over 4"):
        dp.split_rows({"a": torch.zeros(6, 2)}, {}, (devs[0],) * 4, mesh)
    with pytest.raises(ValueError, match="different axes"):
        dp.row_axes(mesh, shd.to_named(mesh, {"a": (shd.DP,),
                                              "b": (shd.ALL,)}))
    assert dp.realign([torch.arange(4), torch.arange(4, 8)],
                      [(0, 4), (4, 8)], 3, 6, "cpu").tolist() == [3, 4, 5]


def test_launcher_trains_gin_over_two_positions(monkeypatch, capsys):
    """The launcher over a production mesh of two (logical ``cpu``)
    positions trains gin-tu's ``full_graph_sm`` cell, its microbatch of
    1 split by node rows and edges over them: the first step's loss equal
    to the one-position mesh's, the second within 2^-8 relative (bf16
    compute, the launcher's; the gradients' sums re-associate, read
    3.3e-4)."""
    from repro_torch.distributed import make_mesh as mk
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launcher

    base = ["--arch", "gin-tu", "--device", "cpu", "--steps", "2"]
    one = launcher.main(base)
    monkeypatch.setattr(launcher, "make_production_mesh", lambda **kw: mk(
        (2, 1), ("data", "model"), devices=["cpu"] * 2))
    monkeypatch.setattr(launcher, "dp_degree", launch_mesh.dp_degree)
    two = launcher.main(base)
    assert "mesh {'data': 2, 'model': 1}" in capsys.readouterr().out
    assert sorted(two["losses"]) == [0, 1]
    assert two["losses"][0] == one["losses"][0]
    assert _rel(two["losses"][1], one["losses"][1]) <= 2.0**-8
