"""Data-parallel training over a mesh on the CPU: ``jit_train_step``,
the ZeRO-1 hooks and ``compressed_psum``, held against the port's own
single-device step and against the reference.

* The step over a mesh of logical ``cpu`` shards deals the step's own
  microbatches out and equals ``make_train_step(microbatch=n·m)`` with
  the same hooks bit for bit (losses, aux, grad norms, every leaf of the
  state): LM with and without ZeRO-1, GIN, SASRec with ZeRO-1, BERT4Rec
  (its shared negatives), each with and without gradient compression,
  over 4 shards of one microbatch and 2 of two. ZeRO-1 only
  splits a leaf of at least 2^20 elements, which no reduced config has,
  so the LM here has a vocabulary of 2^14 (its embedding and head are
  2^20 elements) and SASRec 2^15 items at width 32.
* ``compressed_psum`` equals the reference's ``shard_map`` over 8 forced
  host devices bit for bit (``tests/torch_sharded_train_reference.py``,
  run once in a subprocess by the module fixture ``reference``).
* The hooked single-device step and the 4-shard step against the
  reference's hooked step under ``jax.jit`` and under
  ``jax.jit(step, in_shardings=...)`` on a ``(4, 1)`` mesh (of ``Auto``
  axes: on ``jax.make_mesh``'s mesh, whose axes jax 0.9 makes
  ``Explicit``, the reference's ``constrain`` raises; ROADMAP queue 3).
  Both compute in bf16 (the hooks' cast) on two frameworks that round
  bf16 in other places, so the bounds are the LM tests' bf16 kind: each
  step's loss within ``LOSS_RTOL = 2^-8`` relative (read at most
  4.9e-4), its grad norm within ``NORM_RTOL = 2^-5`` (read at most
  3.0e-3), and every leaf's change over 3 AdamW steps within relative L2
  ``STEP_RL2 = 0.5`` of the reference's change (read at most 0.167; a
  zero update reads 1).
* A step whose microbatch count the data positions do not divide splits
  each microbatch's rows over them and reduces its loss across them
  (every recsys and GNN train cell over 2 positions, at their reduced
  configs, against the single-device step;
  ``tests/test_torch_data_parallel.py`` holds them against the
  reference). BERT4Rec (float32) over 2 and 3 positions against the
  reference's ``jax.jit(step, in_shardings=...)`` at the same microbatch
  count, its negatives split and shared.
* The launcher over the production mesh: trains, resumes bit for bit
  from its checkpoint, and ``--multi-pod`` changes nothing.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import (lm_params_from_numpy,
                                 recsys_params_from_numpy, train_state_tree)
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.launch import train as launcher
from repro_torch.models import gnn, lm, recsys, registry
from repro_torch.train import (OptimizerConfig, ShardedParams,
                               init_train_state, jit_train_step,
                               make_train_step, param_leaves)
from repro_torch.train.grad_compress import compressed_psum
from repro_torch.tree import flatten, nest

sys.path.insert(0, str(Path(__file__).parent))
from torch_sharded_train_reference import (B4R_ROWS,  # noqa: E402
                                           B4R_RUNS, CELL_OVERRIDES,
                                           N_DEVICES, PEAK_LR, STEPS)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 2.0**-8
NORM_RTOL = 2.0**-5
STEP_RL2 = 0.5
B4R_RTOL = 1e-5
B4R_STEP_RL2 = 2.0**-14
OPT = OptimizerConfig(peak_lr=1e-2, warmup_steps=1, total_steps=3)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 8-device run, once per module."""
    out = tmp_path_factory.mktemp("sharded_train_reference") / "ref.npz"
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(f"{flags} --xla_force_host_platform_device_count="
                          f"{N_DEVICES}").strip())
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_train_reference.py"),
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


# -- the step over a mesh against the single-device step ----------------------
def _lm_case(zero1: bool, gc: bool):
    cfg = dataclasses.replace(registry.reduced_config("h2o-danube-1.8b"),
                              vocab=1 << 14, window=None)
    loss = lambda p, b: lm.loss_fn(p, b, cfg)  # noqa: E731
    hooks, rule = {}, shd.lm_param_spec(cfg, zero1=zero1)
    meta = registry.abstract_params(cfg, "lm")
    if zero1:
        _, cast, tr = registry.zero1_hooks(meta, shd.lm_param_spec(cfg))
        hooks = dict(compute_cast=cast, grad_transform=tr)
    rng = np.random.default_rng(3)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (8, 33)).astype(np.int32))} for _ in range(3)]
    return (lambda: lm.init_params(cfg, seed=0, device="cpu"), loss, hooks,
            shd.state_specs(meta, rule, has_ef=gc), batches,
            {"tokens": (shd.DP, None)})


def _gnn_case(gc: bool):
    from repro_torch.data.synthetic import random_graph

    cfg = registry.reduced_config("gin-tu")
    rng = np.random.default_rng(4)
    parts = [random_graph(rng, 16, 64, cfg.d_feat, cfg.n_classes)
             for _ in range(4)]  # node ids local to each quarter
    b = {k: torch.as_tensor(np.concatenate([p[k] for p in parts]))
         for k in parts[0]}
    b["label_mask"] = torch.as_tensor(rng.random(64) < 0.7)
    meta = registry.abstract_params(cfg, "gnn")
    return (lambda: gnn.init_params(cfg, seed=0, device="cpu"),
            lambda p, x: gnn.loss_fn(p, x, cfg), {},
            shd.state_specs(meta, shd.gnn_param_spec(cfg), has_ef=gc),
            [b] * 3, {k: (shd.DP,) for k in b})


def _recsys_case(gc: bool):
    cfg = dataclasses.replace(registry.reduced_config("sasrec"),
                              n_items=1 << 15, embed_dim=32)
    meta = registry.abstract_params(cfg, "recsys")
    master, cast, tr = registry.zero1_hooks(meta,
                                            shd.recsys_param_spec(cfg))
    specs = {"params": master, "opt": {"m": dict(master), "v": dict(master),
                                       "step": ()}}
    if gc:
        specs["ef"] = dict(master)
    shape = dataclasses.replace(registry.shapes_of("sasrec")["train_batch"],
                                dims={"batch": 16})
    rng = np.random.default_rng(6)
    batches = [registry.recsys_batch_for(cfg, shape, rng, device="cpu")
               for _ in range(3)]
    return (lambda: recsys.init_params(cfg, seed=0, device="cpu"),
            lambda p, x: recsys.loss_fn(p, x, cfg),
            dict(compute_cast=cast, grad_transform=tr), specs, batches,
            registry._recsys_batch(cfg, shape)[1])


def _bert4rec_case(gc: bool):
    """The train cell's batch: ``negatives`` is one list every row shares
    (spec ``(None,)``), which the step's microbatch rule splits or shares
    (``train_state._split``) as the single-device step does."""
    cfg = registry.reduced_config("bert4rec")
    meta = registry.abstract_params(cfg, "recsys")
    shape = dataclasses.replace(registry.shapes_of("bert4rec")["train_batch"],
                                dims={"batch": 16})
    rng = np.random.default_rng(7)
    batches = [registry.recsys_batch_for(cfg, shape, rng, device="cpu")
               for _ in range(3)]
    return (lambda: recsys.init_params(cfg, seed=0, device="cpu"),
            lambda p, x: recsys.loss_fn(p, x, cfg), {},
            shd.state_specs(meta, shd.recsys_param_spec(cfg), has_ef=gc),
            batches, registry._recsys_batch(cfg, shape)[1])


CASES = {"lm_zero1": lambda gc: _lm_case(True, gc),
         "lm": lambda gc: _lm_case(False, gc),
         "gnn": _gnn_case, "sasrec_zero1": _recsys_case,
         "bert4rec": _bert4rec_case}


def _run(step, init, batches, gc):
    state = init_train_state(init(), grad_compression=gc)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.mark.parametrize("shards,per_shard", [(4, 1), (2, 2)])
@pytest.mark.parametrize("grad_compression", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_the_microbatch_step(case, grad_compression,
                                                 shards, per_shard):
    init, loss, hooks, specs, batches, bspec = CASES[case](grad_compression)
    mb = shards * per_shard
    step = make_train_step(loss, OPT, microbatch=mb,
                           grad_compression=grad_compression, **hooks)
    mesh = make_mesh((shards, 1), ("data", "model"), devices=["cpu"] * shards)
    sharded = jit_train_step(step, in_shardings=(
        shd.to_named(mesh, specs), shd.to_named(mesh, bspec)))
    assert sharded.per_shard == per_shard
    m_sh, s_sh = _run(sharded, init, batches, grad_compression)
    m_one, s_one = _run(step, init, batches, grad_compression)
    assert m_sh == m_one
    assert isinstance(s_sh["params"], ShardedParams)
    split = [k for k, v in s_sh["params"].leaves.items()
             if isinstance(v, shd.BlockSharded)]
    assert bool(split) == ("zero1" in case)
    for k in split:
        assert len(s_sh["opt"]["m"][k].shards) == shards
    t_sh = dict(flatten(train_state_tree(s_sh)))
    t_one = dict(flatten(train_state_tree(s_one)))
    assert t_sh.keys() == t_one.keys()
    for k in t_one:
        assert torch.equal(t_sh[k], t_one[k]), k


def test_one_position_mesh_gives_the_single_device_step():
    """The launcher's mesh on one card: no split, one microbatch or
    several, the single-device step's bits."""
    for mb in (1, 2):
        init, loss, hooks, specs, batches, _ = _lm_case(False, False)
        step = make_train_step(loss, OPT, microbatch=mb)
        mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
        sharded = jit_train_step(step, in_shardings=(
            shd.to_named(mesh, specs), {}))
        m_sh, s_sh = _run(sharded, init, batches, False)
        m_one, s_one = _run(step, init, batches, False)
        assert m_sh == m_one
        for (k, a), (_, b) in zip(flatten(train_state_tree(s_sh)),
                                  flatten(train_state_tree(s_one))):
            assert torch.equal(a, b), k


def test_jit_train_step_refusals():
    """What a step over a mesh still refuses (shardings on two meshes); a
    microbatch count the 4 data positions do not divide (6, 2, 1) runs,
    each microbatch's rows split over them, and matches the
    single-device step at that count (bf16 bounds: the hooks' cast)."""
    init, loss, hooks, specs, _, _ = _lm_case(True, False)
    step = make_train_step(loss, OPT, microbatch=6, **hooks)
    assert jit_train_step(step) is step
    mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    rng = np.random.default_rng(9)
    batch = {"tokens": torch.as_tensor(rng.integers(0, 1 << 14, (24, 33))
                                       .astype(np.int32))}
    for mb in (6, 2, 1):
        one = make_train_step(loss, OPT, microbatch=mb, **hooks)
        sharded = jit_train_step(one, in_shardings=(
            shd.to_named(mesh, specs), {}))
        assert sharded.split and sharded.per_shard == 0
        m_sh, _ = _run(sharded, init, [batch], False)
        m_one, _ = _run(one, init, [batch], False)
        assert abs(m_sh[0]["loss"] / m_one[0]["loss"] - 1) <= LOSS_RTOL, mb
        assert abs(m_sh[0]["grad_norm"] / m_one[0]["grad_norm"] - 1) <= \
            NORM_RTOL, mb
    other = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="meshes"):
        jit_train_step(make_train_step(loss, OPT), in_shardings=(
            shd.to_named(mesh, specs), shd.to_named(other, {"t": (None,)})))


def test_placed_state_round_trips_through_the_checkpoint_tree():
    init, loss, hooks, specs, batches, _ = _lm_case(True, True)
    step = make_train_step(loss, OPT, microbatch=4, grad_compression=True,
                           **hooks)
    mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    sharded = jit_train_step(step, in_shardings=(
        shd.to_named(mesh, specs), {}))
    state = init_train_state(init(), grad_compression=True)
    state, _ = sharded(state, batches[0])
    tree = train_state_tree(state)
    placed = train_state_tree(state, whole=False)
    assert isinstance(placed["params"]["embed"]["emb"], shd.BlockSharded)
    for (k, a), (_, b) in zip(flatten(tree), flatten(placed)):
        assert torch.equal(a, shd.whole(b)), k
    assert set(nest(param_leaves(state["params"]))) == set(tree["params"])


# -- a loss reduced across positions ------------------------------------------
SPANNING = [(a, sh) for a, sh, _ in registry.all_cells()
            if registry.family_of(a) in ("gnn", "recsys")
            and registry.shapes_of(a)[sh].step == "train"]
GIN_OVER = dict(n_layers=2, d_hidden=16, d_feat=12, n_classes=3)


def _reduced_cell(arch, shape, n, overrides=None):
    """The train cell at its reduced config (a GIN cell keeps its shape's
    task and adjacency; ``overrides`` replace the recsys one's) and a
    small batch of its leaves."""
    from repro_torch.data.graph import compress_adjacency
    from repro_torch.data.sampler import CSRGraph
    from repro_torch.data.synthetic import molecule_batch, random_graph

    rng = np.random.default_rng(10)
    if registry.family_of(arch) == "recsys":
        red = registry.reduced_config(arch)
        over = overrides or {f.name: getattr(red, f.name) for f in
                             dataclasses.fields(red)
                             if f.name not in ("name", "kind", "extras")}
        cell = registry.build_cell(arch, shape, mesh_dp=n, overrides=over)
        small = dataclasses.replace(cell.shape, dims={"batch": 8})
        return cell, registry.recsys_batch_for(cell.cfg, small, rng,
                                               device="cpu")
    cell = registry.build_cell(arch, shape, mesh_dp=n, overrides=GIN_OVER)
    cfg = cell.cfg
    if cfg.task == "graph":
        b = molecule_batch(rng, 4, 8, 16, cfg.d_feat, cfg.n_classes)
        return cell, {"feats": torch.as_tensor(b["feats"]),
                      "labels": torch.as_tensor(b["labels"]),
                      "edge_valid": torch.ones(64, dtype=torch.bool),
                      "graph_ids": torch.as_tensor(b["graph_ids"]),
                      "edge_src": torch.as_tensor(b["edge_src"]),
                      "edge_dst": torch.as_tensor(b["edge_dst"])}
    g = random_graph(rng, 32, 400, cfg.d_feat, cfg.n_classes)
    b = {"feats": torch.as_tensor(g["feats"]),
         "labels": torch.as_tensor(g["labels"]),
         "label_mask": torch.as_tensor(rng.random(32) < 0.7),
         "edge_valid": torch.as_tensor(rng.random(400) < 0.9)}
    if not cfg.compressed_adjacency:
        b.update(edge_src=torch.as_tensor(g["edge_src"]),
                 edge_dst=torch.as_tensor(g["edge_dst"]))
        return cell, b
    c = compress_adjacency(CSRGraph.from_edges(g["edge_src"], g["edge_dst"],
                                               32), device="cpu")
    c.pop("_bits_per_edge")
    c.pop("edge_valid")  # the batch's own mask, over the CSR slots
    b.update(c)
    specs = dict(cell.arg_specs[1], gaps=shd.compressed_array_specs(
        b["gaps"], axis=shd.ALL))
    return dataclasses.replace(cell, arg_specs=(cell.arg_specs[0], specs)), b


@pytest.mark.parametrize("arch,shape", SPANNING)
def test_cell_whose_loss_spans_positions_is_refused(arch, shape):
    """The recsys and GNN train cells step at microbatch 1: over two data
    positions each microbatch's rows split over them and the loss
    (masked means, the two-tower in-batch softmax, a full graph) reduces
    across them; a replicated batch (``molecule``) runs at the first
    position. One step of the reduced cell matches the single-device step:
    its loss within 1e-5 relative, its grad norm within ``NORM_RTOL``
    (bf16 compute: the split re-associates the gradients' sums). The
    one-position mesh (one card) takes the cell whole."""
    cell, batch = _reduced_cell(arch, shape, 2)
    assert cell.fn.microbatch == 1
    two = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    sharded = jit_train_step(cell.fn, in_shardings=cell.in_shardings(two))
    assert sharded.split == (shape != "molecule")
    init = functools.partial(registry._family_init(cell.family), cell.cfg,
                             seed=0, device="cpu")
    m_sh, _ = _run(sharded, init, [batch], False)
    m_one, _ = _run(cell.fn, init, [batch], False)
    assert abs(m_sh[0]["loss"] / m_one[0]["loss"] - 1) <= 1e-5
    assert abs(m_sh[0]["grad_norm"] / m_one[0]["grad_norm"] - 1) <= NORM_RTOL
    one = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    assert jit_train_step(cell.fn, in_shardings=cell.in_shardings(
        one)).per_shard == 1


def _bert4rec_reference_inputs(reference):
    cfg = registry.reduced_config("bert4rec")
    shape = dataclasses.replace(registry.shapes_of("bert4rec")["train_batch"],
                                dims={"batch": B4R_ROWS})
    meta = registry.abstract_params(cfg, "recsys")
    specs = (shd.state_specs(meta, shd.recsys_param_spec(cfg)),
             registry._recsys_batch(cfg, shape)[1])
    init = nest({k[9:]: v for k, v in reference.items()
                 if k.startswith("b4r/init/")})
    batch = {k[10:]: torch.as_tensor(v) for k, v in reference.items()
             if k.startswith("b4r/batch/")}
    return (cfg, specs, lambda: recsys_params_from_numpy(init, cfg,
                                                         device="cpu"), batch)


@pytest.mark.parametrize("n,mb", B4R_RUNS)
def test_bert4rec_shared_negatives_against_the_reference(reference, n, mb):
    """BERT4Rec's train step (float32 compute) at microbatch ``mb`` over
    ``n`` data positions, with the cell's state and batch specs
    (``negatives``: ``(None,)``). Where ``n`` divides ``mb`` it equals the
    single-device step at ``mb`` bit for bit (at 2 x 2 the microbatch rule
    splits the 16 negatives, at 3 x 3 it shares them whole); at 2 x 1 the
    microbatch's rows split over the positions, every position reading
    all the negatives, and the step is held against the reference as the
    single-device step is. Against the reference's ``jax.jit(step,
    in_shardings=...)`` on an ``(n, 1)`` mesh, whose function is the
    single-device step's at ``mb``: the loss and grad norm within
    ``B4R_RTOL = 1e-5`` relative (float32 sums in other orders, read at
    most 1.9e-7), every leaf's change over the steps within relative L2
    ``B4R_STEP_RL2 = 2^-14`` of the reference's (read at most 3.4e-6)."""
    cfg, specs, init, batch = _bert4rec_reference_inputs(reference)
    opt = OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)
    step = make_train_step(
        lambda p, b: recsys.loss_fn(p, b, cfg, dtype=torch.float32), opt,
        microbatch=mb)
    mesh = make_mesh((n, 1), ("data", "model"), devices=["cpu"] * n)
    named = (shd.to_named(mesh, specs[0]), shd.to_named(mesh, specs[1]))
    m_port, s_port = _run(step, init, [batch] * STEPS, False)
    sharded = jit_train_step(step, in_shardings=named)
    m_sh, s_sh = _run(sharded, init, [batch] * STEPS, False)
    runs = [(m_port, s_port)]
    if mb % n:
        assert sharded.split
        runs.append((m_sh, s_sh))
    else:
        assert m_sh == m_port
        for (k, a), (_, b) in zip(flatten(train_state_tree(s_sh)),
                                  flatten(train_state_tree(s_port))):
            assert torch.equal(a, b), k
    tag = f"b4r/{n}x{mb}"
    for m, s in runs:
        np.testing.assert_allclose([x["loss"] for x in m],
                                   reference[f"{tag}/loss"], rtol=B4R_RTOL)
        np.testing.assert_allclose([x["grad_norm"] for x in m],
                                   reference[f"{tag}/grad_norm"],
                                   rtol=B4R_RTOL)
        for k, v in param_leaves(s["params"]).items():
            p0 = reference[f"b4r/init/{k}"]
            d_ref = reference[f"{tag}/params/{k}"] - p0
            assert _rl2(shd.whole(v).detach().numpy() - p0, d_ref) <= \
                B4R_STEP_RL2, k


# -- compressed_psum ----------------------------------------------------------
def test_compressed_psum_matches_reference(reference):
    x, want = reference["psum/in"], reference["psum/out"]
    mesh = make_mesh((N_DEVICES,), ("data",), devices=["cpu"] * N_DEVICES)
    per = x.shape[0] // N_DEVICES
    got = compressed_psum(shd.BlockSharded(mesh, ("data",), tuple(
        torch.as_tensor(x[i * per:(i + 1) * per]) for i in range(N_DEVICES))),
        "data")
    assert isinstance(got, shd.BlockSharded) and got.axes == ("data",)
    np.testing.assert_array_equal(got.gather().numpy(), want)


def test_compressed_psum_refuses_other_layouts():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    x = shd.split_blocks(torch.zeros(4, 3), mesh, ("data",))
    with pytest.raises(ValueError, match="model"):
        compressed_psum(x, "model")
    with pytest.raises(ValueError, match="BlockSharded"):
        compressed_psum(torch.zeros(4), "data")


# -- against the reference's hooked step --------------------------------------
def _rl2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("where", ["single", "mesh"])
def test_hooked_step_matches_reference(reference, where):
    opt = OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)
    cell = registry.build_cell("h2o-danube-1.8b", "train_4k", mesh_dp=4,
                               overrides=dict(CELL_OVERRIDES, zero1=True),
                               opt_cfg=opt)
    init = nest({k[5:]: v for k, v in reference.items()
                 if k.startswith("init/")})
    step = cell.fn
    if where == "mesh":
        mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
        step = jit_train_step(cell.fn, in_shardings=cell.in_shardings(mesh))
    state = init_train_state(lm_params_from_numpy(init, cell.cfg,
                                                  device="cpu"))
    losses, norms = [], []
    for t in reference["tokens"]:
        state, m = step(state, {"tokens": torch.as_tensor(t)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, reference[f"{where}/loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, reference[f"{where}/grad_norm"],
                               rtol=NORM_RTOL)
    got = param_leaves(state["params"])
    for k, v in got.items():
        p0 = reference[f"init/{k}"]
        d_ref = reference[f"{where}/params/{k}"] - p0
        d_port = shd.whole(v).detach().numpy() - p0
        assert _rl2(d_port, d_ref) <= STEP_RL2, k


# -- the launcher over the production mesh ------------------------------------
def test_launcher_over_the_mesh_resumes_bit_for_bit(tmp_path, capsys):
    base = ["--arch", "gin-tu", "--device", "cpu"]
    full = launcher.main(base + ["--steps", "5"])
    assert isinstance(full["state"]["params"], ShardedParams)
    assert "mesh {'data': 1, 'model': 1}" in capsys.readouterr().out
    ck = str(tmp_path / "ck")
    launcher.main(base + ["--steps", "3", "--ckpt-dir", ck])
    resumed = launcher.main(base + ["--steps", "5", "--ckpt-dir", ck])
    assert resumed["start"] == 3
    assert [resumed["losses"][s] for s in (3, 4)] == [full["losses"][s]
                                                      for s in (3, 4)]
    pod = launcher.main(base + ["--steps", "2", "--multi-pod"])
    assert [pod["losses"][s] for s in (0, 1)] == [full["losses"][s]
                                                  for s in (0, 1)]
    for (k, a), (_, b) in zip(flatten(train_state_tree(full["state"])),
                              flatten(train_state_tree(resumed["state"]))):
        assert torch.equal(a, b), k
