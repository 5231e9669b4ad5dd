"""Tensor- and expert-parallel compute over a ``(data, model)`` mesh on
the CPU, held against the reference's jitted cells on the same meshes and
against the port's own single-device functions.

The module fixture ``reference`` runs ``tests/torch_model_parallel_reference.py``
once a case, the three in parallel subprocesses under 8 forced host
devices: the reference's train step (float32 compute, with and without
ZeRO-1), prefill, chunked prefill and decode cells under ``jax.jit(...,
in_shardings=cell.in_shardings(mesh))`` over ``(2, 2)`` and ``(1, 4)``
meshes of ``Auto`` axes. The three reduced configs make every rule bite
(``CASES`` there): a dense GQA model whose K/V projections the rule
replicates and whose cache it splits by head dimension; an olmoe-like
model with experts over ``model`` (``ep_shard``), its K/V heads split and
its cache split by heads; a mixtral-like model whose experts' hidden
units are split, with 2 K/V heads shared by 4 positions, a sliding
window and a head-dimension cache. The port runs ``train.jit_train_step``
and ``registry.run_cell`` over logical ``cpu`` shards.

What is bit for bit, and what is held within a tolerance:

* **Bit for bit.** ``moe_drop_frac`` of every step against the port's
  single-device step; a cache's layout (its split dimensions and axes)
  against the reference's; the decode cache's ``index``. Column splits
  need no sum: ``nn/moe.py``'s router, dispatch and (expert parallel)
  every output, and the vocabulary-parallel embedding, are bit for bit
  given the same input (``tests/test_torch_tensor_parallel.py``).
* **Within ``RTOL = 1e-5``** (float32 on both sides; the row-parallel
  and vocabulary sums re-associate, as XLA's and torch's CPU kernels do):
  every step's loss and the first step's grad norm without ZeRO-1,
  against the reference and against the single-device step (read at most
  2.3e-6 and 1.1e-7); prefill, chunked-prefill and decode logits and
  caches, of their largest ``|value|``, against both.
* **After an AdamW step** the parameters differ where a gradient near 0
  changed sign: Adam moves such an element by ``lr`` either way. So the
  later grad norms are held within ``NORM_RTOL`` (float32: 2^-12, read at
  most 1.2e-4; the port's single-device step reads as far from the
  reference) and every leaf's change over the 3 steps within relative L2
  ``STEP_RL2 = 2^-5`` of the reference's and of the single-device step's
  (read at most 1.4e-2 and 6.8e-3; a skipped layer or a zero update
  reads about 1).
* **ZeRO-1** rounds the compute copy and every gradient to bf16 (the
  hooks; the reference's bf16 products on the CPU round again), so its
  losses are held within ``Z1_LOSS_RTOL = 2^-14`` (read at most 2.7e-5),
  its first grad norm within ``RTOL`` (read at most 3.4e-6) and its later
  ones within 2^-7 (read at most 4.5e-3).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm, registry
from repro_torch.train import (OptimizerConfig, init_train_state,
                               jit_train_step, make_train_step, map_params,
                               param_leaves)
from repro_torch.tree import nest

sys.path.insert(0, str(Path(__file__).parent))
from torch_model_parallel_reference import (CAPACITY, CASES,  # noqa: E402
                                            CHUNK, MESHES, N_DEVICES,
                                            PEAK_LR, STEPS, TRAIN)

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
Z1_LOSS_RTOL = 2.0**-14
NORM_RTOL = {False: 2.0**-12, True: 2.0**-7}  # after the first step
STEP_RL2 = 2.0**-5
OPT = OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)


def _reference_case(out: Path, case: str) -> dict:
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(f"{flags} --xla_force_host_platform_device_count="
                          f"{N_DEVICES}").strip())
    path = out / f"{case}.npz"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_model_parallel_reference.py"),
         str(path), case], env=env, cwd=ROOT, capture_output=True, text=True,
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
    """The reference's runs, a case a subprocess, in parallel."""
    out = tmp_path_factory.mktemp("model_parallel_reference")
    with ThreadPoolExecutor(len(CASES)) as pool:
        parts = pool.map(functools.partial(_reference_case, out), CASES)
    return {k: v for p in parts for k, v in p.items()}


def _mesh(name):
    return make_mesh(MESHES[name], ("data", "model"), devices=["cpu"] * 4)


def _params(reference, case, cfg):
    init = nest({k[len(case) + 6:]: v for k, v in reference.items()
                 if k.startswith(f"{case}/init/")})
    return lm_params_from_numpy(init, cfg, device="cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rl2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _splits(x) -> list:
    return [[d, list(a)] for d, a in x.splits]


# -- the train step -----------------------------------------------------------
def _train(reference, case, mesh_name, zero1, *, single=False):
    """``STEPS`` steps of the port's train cell at float32 compute over the
    mesh (or, with ``single``, the single-device step at the same
    microbatch count): metrics a step and the final state."""
    arch, over = CASES[case]
    mesh = _mesh(mesh_name)
    cell = registry.build_cell(arch, "train_4k", mesh_dp=mesh.shape["data"],
                               overrides=dict(over, zero1=zero1), opt_cfg=OPT)
    cfg = cell.cfg
    hooks = {}
    if zero1:
        _, cast, tr = registry.zero1_hooks(registry.abstract_params(cfg, "lm"),
                                           shd.lm_param_spec(cfg))
        hooks = dict(compute_cast=cast, grad_transform=tr)
    step = make_train_step(
        functools.partial(lm.loss_fn, cfg=cfg, dtype=torch.float32), OPT,
        microbatch=cfg.microbatch, **hooks)
    if not single:
        step = jit_train_step(step, in_shardings=cell.in_shardings(mesh))
    state = init_train_state(_params(reference, case, cfg))
    metrics = []
    for t in reference[f"{case}/tokens"]:
        state, m = step(state, {"tokens": torch.as_tensor(t)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference_and_single_device(reference, case,
                                                        mesh_name, zero1):
    """The port's ``jit_train_step`` over the mesh against its own
    single-device step at the same microbatch count (losses and grad
    norms; ``moe_drop_frac`` bit for bit; every leaf's change) and, for
    each run of the reference's ``TRAIN``, against the reference's jitted
    step on the same mesh (losses, grad norms, every leaf's change). Over
    ``(1, 4)`` ZeRO-1 splits nothing over ``data``; over ``(2, 2)`` its
    split leaves are 2-D grids, as the reference lays them out."""
    tag = f"{case}/{mesh_name}/train{int(zero1)}"
    m_mesh, s_mesh = _train(reference, case, mesh_name, zero1)
    m_one, s_one = _train(reference, case, mesh_name, zero1, single=True)
    loss_tol = Z1_LOSS_RTOL if zero1 else RTOL
    norms = [m["grad_norm"] for m in m_mesh]
    against_ref = (mesh_name, zero1) in TRAIN
    refs = [(reference[f"{tag}/loss"], "reference")] if against_ref else []
    for want, where in refs + [([m["loss"] for m in m_one], "single")]:
        np.testing.assert_allclose([m["loss"] for m in m_mesh], want,
                                   rtol=loss_tol, err_msg=where)
    refs = ([(reference[f"{tag}/grad_norm"], "reference")] if against_ref
            else [])
    for want, where in refs + [([m["grad_norm"] for m in m_one], "single")]:
        np.testing.assert_allclose(norms[0], want[0], rtol=RTOL,
                                   err_msg=where)
        np.testing.assert_allclose(norms[1:], want[1:],
                                   rtol=NORM_RTOL[zero1], err_msg=where)
    assert ([m["moe_drop_frac"] for m in m_mesh]
            == [m["moe_drop_frac"] for m in m_one])
    leaves = s_mesh["params"].leaves
    two_d = [k for k, v in leaves.items() if isinstance(v, shd.BlockSharded)
             and v.dim2 is not None]
    assert bool(two_d) == (zero1 and mesh_name == "2x2"), two_d
    one = param_leaves(s_one["params"])
    for k, v in leaves.items():
        p0 = reference[f"{case}/init/{k}"]
        got = shd.whole(v).detach().numpy() - p0
        wants = [(one[k].detach().numpy() - p0, "single")]
        if against_ref:
            wants.append((reference[f"{tag}/params/{k}"] - p0, "ref"))
        for want, where in wants:
            assert _rl2(got, want) <= STEP_RL2, (k, where)


# -- serving ------------------------------------------------------------------
def _serve_cells(case, mesh):
    arch, over = CASES[case]
    n = mesh.shape["data"]
    prefill = registry.build_cell(arch, "prefill_32k", mesh_dp=n,
                                  overrides=dict(over))
    decode = registry.build_cell(arch, "decode_32k", mesh_dp=n,
                                 overrides=dict(over))
    cfg = prefill.cfg
    f32 = torch.float32
    return cfg, {
        "prefill": dataclasses.replace(prefill, fn=functools.partial(
            lm.prefill, cfg=cfg, cache_capacity=CAPACITY, dtype=f32)),
        "chunked": dataclasses.replace(prefill, fn=functools.partial(
            lm.prefill_chunked, cfg=cfg, chunk=CHUNK, dtype=f32)),
        "decode": dataclasses.replace(decode, fn=functools.partial(
            lm.decode_step, cfg=cfg, dtype=f32))}


def _close(got, want, what):
    assert _rel(got, want) <= RTOL, (what, _rel(got, want))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", list(CASES))
def test_serving_cells_match_reference_and_single_device(reference, case,
                                                         mesh_name):
    """``registry.run_cell`` over the mesh: the prefill and chunked-prefill
    cells' logits and caches, then ``DECODE`` decode steps from the
    prefill's cache (fed the reference's tokens), against the reference's
    jitted cells and the port's single-device functions, float32 compute.
    The prefill caches leave split along the sequence over ``model`` (and
    the batch over ``data``), the decode cache by heads or head dimension,
    as the reference's are; the logits over the vocabulary."""
    mesh = _mesh(mesh_name)
    cfg, cells = _serve_cells(case, mesh)
    params = _params(reference, case, cfg)
    tag = f"{case}/{mesh_name}"
    prompt = torch.as_tensor(reference[f"{case}/prompt"])
    single = {"prefill": functools.partial(lm.prefill, cache_capacity=CAPACITY),
              "chunked": functools.partial(lm.prefill_chunked, chunk=CHUNK)}
    with torch.no_grad():
        for name in ("prefill", "chunked"):
            (lg, cache), placed = registry.run_cell(cells[name], mesh, params,
                                                    prompt)
            assert _splits(cache["k"]) == json.loads(
                str(reference[f"{tag}/{name}/splits"]))
            assert _splits(lg) == ([[0, ["data"]]] if mesh.shape["data"] > 1
                                   else []) + [[1, ["model"]]]
            s_lg, s_cache = single[name](params, prompt, cfg,
                                         dtype=torch.float32)
            for want, where in ((reference[f"{tag}/{name}/logits"], "ref"),
                                (s_lg.numpy(), "single")):
                _close(shd.whole(lg).numpy(), want, f"{name} logits {where}")
            for k in ("k", "v"):
                got = shd.whole(cache[k]).numpy()
                _close(got, reference[f"{tag}/{name}/{k}"], f"{name} {k}")
                _close(got, s_cache[k].numpy(), f"{name} {k} single")
            if name == "prefill":
                first, s_first = cache, s_cache
        cur, s_cur = dict(first), dict(s_first)
        for i, t in enumerate(reference[f"{case}/next"]):
            tok = torch.as_tensor(t)
            (lg, cur), placed = registry.run_cell(cells["decode"], mesh,
                                                  placed, cur, tok)
            s_lg, s_cur = lm.decode_step(params, s_cur, tok, cfg,
                                         dtype=torch.float32)
            _close(shd.whole(lg).numpy(),
                   reference[f"{tag}/decode/logits/{i}"], f"decode {i}")
            _close(shd.whole(lg).numpy(), s_lg.numpy(), f"decode {i} single")
        assert cur["index"] == s_cur["index"] == prompt.shape[1] + len(
            reference[f"{case}/next"])
        assert _splits(cur["k"]) == json.loads(
            str(reference[f"{tag}/decode/splits"]))
        for k in ("k", "v"):
            got = shd.whole(cur[k]).numpy()
            _close(got, reference[f"{tag}/decode/{k}"], f"decode {k}")
            _close(got, s_cur[k].numpy(), f"decode {k} single")


def test_decode_writes_the_placed_cache_in_place(reference):
    """A decode over ``(1, 4)`` writes the new token's keys and values into
    the slices of the cache the caller placed (the cell's layout), and
    places the parameters once: a second call takes them as placed."""
    mesh = _mesh("1x4")
    cfg, cells = _serve_cells("dense", mesh)
    params = map_params(lambda k, p: p.to(torch.bfloat16),
                        _params(reference, "dense", cfg))
    prompt = torch.as_tensor(reference["dense/prompt"])
    with torch.no_grad():
        (_, cache), placed = registry.run_cell(cells["prefill"], mesh,
                                               params, prompt)
        laid = {k: shd.place(v, cells["decode"].in_shardings(mesh)[1][k])
                if k != "index" else v for k, v in cache.items()}
        before = [s.clone() for s in laid["k"].shards]
        tok = torch.as_tensor(reference["dense/next"][0])
        (_, out), again = registry.run_cell(cells["decode"], mesh, placed,
                                            laid, tok)
    assert out["k"] is laid["k"] and again.leaves.keys() == placed.leaves.keys()
    assert all(again.leaves[k] is placed.leaves[k] for k in placed.leaves)
    slot = prompt.shape[1]
    for s, b in zip(laid["k"].shards, before):
        assert not torch.equal(s[:, :, slot], b[:, :, slot])
        assert torch.equal(s[:, :, :slot], b[:, :, :slot])
