"""The port's training stack on the CPU against the reference's on the same
numpy inputs: ``lr_schedule``, ``adamw_update`` (clipping, decay, bias
correction) over 20 steps, int8 ``quantize`` and error feedback, GIN's
``make_train_step`` (float32 compute; ``microbatch`` 1 and 2, gradient
compression on and off; raw, ``edge_valid``-masked and compressed
adjacency, and the molecule graph task), GIN's gradients against
``jax.grad`` of the reference's ``loss_fn``, and the launcher with a
resume.

Tolerance: ``RTOL = 1e-5``, relative to each leaf's largest ``|value|``
(a loss: to ``|loss|``). Both packages compute in float32 with the same
operations in the same order, and GIN's sums by owner and by source add
in the reference's edge order; what is left is the matrix products' and
reductions' summation order (XLA's against torch's CPU kernels) and an
ulp of ``cos`` / ``pow``: measured at most 1.6e-6 over 6 steps. The
error feedback after GIN steps is a rounding residual that carries every
step's gradient error and the rounding of every step's scale, so it is
held by ``EF_RTOL = 1e-4`` relative to the leaf's gradient RMS (the
bias-corrected √v): measured at most 2.3e-5 over 6 steps. Quantization
and error feedback on the same inputs are exact.

Microbatched GIN batches hold two graphs with node ids local to each
half, so that each part of the split is a graph of its own, as the
reference's split (the leading dim of every leaf) takes it."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data.graph import compress_adjacency as r_compress
from repro.data.sampler import CSRGraph as RCSR
from repro.data.synthetic import molecule_batch, random_graph
from repro.models import gnn as R
from repro.models import registry as Rreg
from repro.train import OptimizerConfig as ROpt
from repro.train import init_train_state as r_init_state
from repro.train import make_train_step as r_make_step
from repro.train import grad_compress as r_gc
from repro.train import optimizer as r_opt
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.data.graph import compress_adjacency
from repro_torch.data.sampler import CSRGraph
from repro_torch.data.synthetic import molecule_batch as t_molecule_batch
from repro_torch.launch import train as launcher
from repro_torch.models import gnn as T
from repro_torch.models import registry as Treg
from repro_torch.train import OptimizerConfig as TOpt
from repro_torch.train import grad_compress as t_gc
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step
from repro_torch.train import optimizer as t_opt
from repro_torch.train import param_leaves
from repro_torch.tree import flatten

ARCH = "gin-tu"
RTOL = 1e-5
EF_RTOL = 1e-4


def _assert_leaf_close(ref, got, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert ref.shape == got.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(ref - got).max()) <= RTOL * scale, what


def _assert_tree_close(ref_tree, got: dict, what=""):
    ref = dict(flatten(ref_tree))
    assert list(ref) == list(got), what
    for k in ref:
        _assert_leaf_close(ref[k], got[k], f"{what} {k}")


# -- optimizer ----------------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 30), (5, 5)])
def test_lr_schedule_matches_reference(warmup, total):
    kw = dict(peak_lr=3e-3, warmup_steps=warmup, total_steps=total,
              min_lr_frac=0.1)
    for s in range(0, total + 20, 3):
        ref = float(r_opt.lr_schedule(ROpt(**kw), jnp.int32(s)))
        got = float(t_opt.lr_schedule(TOpt(**kw), torch.tensor(s,
                                                               dtype=torch.int32)))
        assert got == pytest.approx(ref, rel=RTOL, abs=1e-12), s


@pytest.mark.parametrize("weight_decay,grad_clip", [(0.1, 1.0), (0.0, 50.0)])
def test_adamw_matches_reference_over_20_steps(weight_decay, grad_clip):
    """The same params and per-step gradients (every fourth step's large
    enough to be clipped when ``grad_clip`` is 1): params, moments, step,
    grad norm and lr after each step."""
    rng = np.random.default_rng(1)
    p0 = {"b": rng.standard_normal(7).astype(np.float32),
          "w": rng.standard_normal((5, 3)).astype(np.float32),
          "z": {"eps": np.float32(0.25)}}
    cfg = dict(peak_lr=0.05, warmup_steps=3, total_steps=20,
               weight_decay=weight_decay, grad_clip=grad_clip)
    rp = jax.tree_util.tree_map(jnp.asarray, p0)
    r_state = r_opt.init_opt_state(rp)
    tp = {k: torch.tensor(v) for k, v in flatten(p0)}
    t_state = t_opt.init_opt_state(tp)
    assert list(tp) == ["b", "w", "z/eps"]
    for step in range(20):
        big = 30.0 if step % 4 == 0 else 0.3
        g = {k: (rng.standard_normal(np.shape(v)) * big).astype(np.float32)
             for k, v in flatten(p0)}
        rg = {"b": jnp.asarray(g["b"]), "w": jnp.asarray(g["w"]),
              "z": {"eps": jnp.asarray(g["z/eps"])}}
        rp, r_state, rm = r_opt.adamw_update(rp, rg, r_state, ROpt(**cfg))
        tp, t_state, tm = t_opt.adamw_update(
            tp, {k: torch.tensor(v) for k, v in g.items()}, t_state,
            TOpt(**cfg))
        _assert_tree_close(rp, tp, f"params at step {step}")
        _assert_tree_close(r_state["m"], t_state["m"], "m")
        _assert_tree_close(r_state["v"], t_state["v"], "v")
        assert int(t_state["step"]) == int(r_state["step"]) == step + 1
        assert t_state["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(rm[k]), rel=RTOL)


def test_grad_clip_reported_before_clipping():
    cfg = TOpt(grad_clip=1.0, peak_lr=1.0, warmup_steps=0)
    p = {"w": torch.zeros(3)}
    _, _, m = t_opt.adamw_update(p, {"w": torch.full((3,), 100.0)},
                                 t_opt.init_opt_state(p), cfg)
    assert float(m["grad_norm"]) > 100.0


# -- gradient compression -----------------------------------------------------
def test_quantize_and_error_feedback_match_reference_exactly():
    rng = np.random.default_rng(2)
    for x in (rng.standard_normal((40, 9)).astype(np.float32) * 1e-3,
              np.zeros(5, np.float32),
              np.array([1.5, -2.5, 0.5, 127.0, -127.0], np.float32)):
        rq, rs = r_gc.quantize(jnp.asarray(x))
        tq, ts = t_gc.quantize(torch.tensor(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        assert float(ts) == float(rs)
        np.testing.assert_array_equal(t_gc.dequantize(tq, ts).numpy(),
                                      np.asarray(r_gc.dequantize(rq, rs)))
    p = {"a": np.zeros((6, 4), np.float32), "b": np.zeros(3, np.float32)}
    r_ef = r_gc.init_ef_state(jax.tree_util.tree_map(jnp.asarray, p))
    t_ef = t_gc.init_ef_state({k: torch.tensor(v) for k, v in p.items()})
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        r_out, r_ef = r_gc.compress_grads_with_ef(
            {k: jnp.asarray(v) for k, v in g.items()}, r_ef)
        t_out, t_ef = t_gc.compress_grads_with_ef(
            {k: torch.tensor(v) for k, v in g.items()}, t_ef)
        for k in p:
            np.testing.assert_array_equal(t_out[k].numpy(),
                                          np.asarray(r_out[k]))
            np.testing.assert_array_equal(t_ef[k].numpy(),
                                          np.asarray(r_ef[k]))


# -- GIN train step -----------------------------------------------------------
def _gin_case(kind: str, seed: int = 5):
    """(reference cfg, port cfg, reference batch, port batch): two halves
    with local node ids (see the module's docstring)."""
    rng = np.random.default_rng(seed)
    cfg, tcfg = Rreg.reduced_config(ARCH), Treg.reduced_config(ARCH)
    if kind == "graph":
        cfg = dataclasses.replace(cfg, task="graph")
        tcfg = dataclasses.replace(tcfg, task="graph")
        parts = [molecule_batch(rng, 4, 8, 16, 12, 3) for _ in range(2)]
        b = {k: np.concatenate([p[k] for p in parts])
             for k in ("feats", "edge_src", "edge_dst", "graph_ids",
                       "labels")}
    else:
        n, e = 64, 256
        parts = [random_graph(rng, n // 2, e // 2, 12, 3) for _ in range(2)]
        b = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        b["label_mask"] = rng.random(n) < 0.7
        if kind == "masked":
            b["edge_valid"] = rng.random(e) < 0.8
    if kind != "compressed":
        return (cfg, tcfg, {k: jnp.asarray(v) for k, v in b.items()},
                {k: torch.tensor(v) for k, v in b.items()})
    n = len(b["feats"])
    cfg = dataclasses.replace(cfg, compressed_adjacency=True)
    tcfg = dataclasses.replace(tcfg, compressed_adjacency=True)
    r = r_compress(RCSR.from_edges(b["edge_src"], b["edge_dst"], n))
    t = compress_adjacency(CSRGraph.from_edges(b["edge_src"], b["edge_dst"],
                                               n), device="cpu")
    keep = ("feats", "labels", "label_mask")
    rb = {**{k: jnp.asarray(b[k]) for k in keep},
          **{k: v if k == "gaps" else jnp.asarray(v)
             for k, v in r.items() if not k.startswith("_")}}
    tb = {**{k: torch.tensor(b[k]) for k in keep},
          **{k: v for k, v in t.items() if not k.startswith("_")}}
    return cfg, tcfg, rb, tb


def _params(cfg, tcfg, seed=0):
    params = R.init_params(jax.random.PRNGKey(seed), cfg)
    return params, gnn_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")


CASES = [(k, mb, gc) for k in ("raw", "masked", "compressed", "graph")
         for mb in (1, 2) for gc in (False, True)
         if not (k == "compressed" and mb == 2)]


@pytest.mark.parametrize("kind,microbatch,grad_compression", CASES)
def test_gin_train_step_matches_reference(kind, microbatch, grad_compression):
    """Six steps of ``make_train_step`` (AdamW, peak_lr 1e-2, warm-up 1, as
    the reference's GIN test): the loss and accuracy of every step, then
    the parameters, moments and error feedback."""
    steps = 6
    cfg, tcfg, rb, tb = _gin_case(kind)
    params, tp = _params(cfg, tcfg)
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=steps)
    r_step = jax.jit(r_make_step(
        lambda p, b: R.loss_fn(p, b, cfg, dtype=jnp.float32), ROpt(**kw),
        grad_compression=grad_compression, microbatch=microbatch))
    t_step = t_make_step(
        lambda p, b: T.loss_fn(p, b, tcfg, dtype=torch.float32), TOpt(**kw),
        grad_compression=grad_compression, microbatch=microbatch)
    rs = r_init_state(params, grad_compression=grad_compression)
    ts = t_init_state(tp, grad_compression=grad_compression)
    losses = []
    for step in range(steps):
        rs, rm = r_step(rs, rb)
        ts, tm = t_step(ts, tb)
        for k in ("loss", "accuracy", "grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(rm[k]), rel=RTOL), (
                step, k)
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]
    _assert_tree_close(rs["params"], param_leaves(ts["params"]), "params")
    _assert_tree_close(rs["opt"]["m"], ts["opt"]["m"], "m")
    _assert_tree_close(rs["opt"]["v"], ts["opt"]["v"], "v")
    assert int(ts["opt"]["step"]) == steps
    if grad_compression:  # against each leaf's gradient RMS
        b2 = TOpt().b2
        for k, ef in flatten(rs["ef"]):
            rms = float(torch.sqrt(ts["opt"]["v"][k].max() / (1 - b2**steps)))
            err = float(np.abs(np.asarray(ef) - ts["ef"][k].numpy()).max())
            assert err <= EF_RTOL * rms, k


@pytest.mark.parametrize("kind", ["raw", "masked", "compressed", "graph"])
def test_gin_gradients_match_jax_grad(kind):
    cfg, tcfg, rb, tb = _gin_case(kind, seed=11)
    params, tp = _params(cfg, tcfg, seed=3)
    rg = jax.grad(lambda p: R.loss_fn(p, rb, cfg, dtype=jnp.float32)[0])(
        params)
    leaves = param_leaves(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    loss, _ = T.loss_fn(tp, tb, tcfg, dtype=torch.float32)
    loss.backward()
    _assert_tree_close(rg, {k: p.grad for k, p in leaves.items()}, kind)


def test_gin_train_step_at_bf16_compute_learns():
    """The default bf16 compute (float32 aggregation) trains: the loss
    falls over 10 steps (no reference comparison at bf16: the two
    frameworks round bf16 in other places)."""
    _, tcfg, _, tb = _gin_case("masked")
    tp = T.init_params(tcfg, seed=1, device="cpu")
    step = t_make_step(lambda p, b: T.loss_fn(p, b, tcfg),
                       TOpt(peak_lr=1e-2, warmup_steps=1, total_steps=10))
    state = t_init_state(tp)
    losses = [float(step(state, tb)[1]["loss"]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_microbatch_refuses_what_it_cannot_split():
    _, tcfg, _, tb = _gin_case("compressed")
    step = t_make_step(lambda p, b: T.loss_fn(p, b, tcfg), TOpt(),
                       microbatch=2)
    state = t_init_state(T.init_params(tcfg, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="gaps"):
        step(state, tb)
    _, tcfg, _, tb = _gin_case("raw")
    step = t_make_step(lambda p, b: T.loss_fn(p, b, tcfg), TOpt(),
                       microbatch=3)
    tb = {**tb, "feats": tb["feats"][:64]}
    with pytest.raises(ValueError, match="not divisible"):
        step(t_init_state(T.init_params(tcfg, seed=0, device="cpu")), tb)


def test_molecule_batch_matches_reference():
    a = molecule_batch(np.random.default_rng(3), 5, 7, 11, 4, 2)
    b = t_molecule_batch(np.random.default_rng(3), 5, 7, 11, 4, 2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# -- registry and launcher ----------------------------------------------------
def test_registry_family_init():
    from repro_torch.models import lm, recsys

    assert Treg._family_init("gnn") is T.init_params
    assert Treg._family_init("recsys") is recsys.init_params
    assert Treg._family_init("lm") is lm.init_params
    out = launcher.main(["--arch", "mixtral-8x7b", "--steps", "1",
                         "--reduced", "--device", "cpu"])
    assert list(out["losses"]) == [0] and np.isfinite(out["losses"][0])


def _launch(*argv):
    return launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--peak-lr", "1e-2", *argv])


def test_launcher_reduced_on_cpu_and_resume(tmp_path, capsys):
    """8 steps straight through; then 4 steps with checkpoints (async at
    step 2, the last at step 3) and a restart to 8 that resumes at step 4:
    every loss equal bit for bit to the uninterrupted run's (warm-up 5:
    the first 4 steps' learning rates do not depend on the total)."""
    whole = _launch("--steps", "8")
    ck = str(tmp_path / "ck")
    first = _launch("--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2")
    assert first["start"] == 0
    assert sorted(int(d.split("_")[1]) for d in
                  __import__("os").listdir(ck)) == [2, 3]
    second = _launch("--steps", "8", "--ckpt-dir", ck, "--ckpt-every", "2")
    assert second["start"] == 4
    assert "[resume] from step 3" in capsys.readouterr().out
    assert {**first["losses"], **second["losses"]} == whole["losses"]
    assert whole["losses"][7] < whole["losses"][0]
    for a, b in zip(param_leaves(whole["state"]["params"]).values(),
                    param_leaves(second["state"]["params"]).values()):
        assert torch.equal(a, b)


def test_launcher_full_config_compressed_batch(capsys):
    """Without ``--reduced``: gin-tu at full width on ``full_graph_sm``'s
    node and edge counts, its adjacency compressed, with gradient
    compression."""
    out = launcher.main(["--arch", ARCH, "--steps", "2", "--device", "cpu",
                         "--grad-compression"])
    assert len(out["losses"]) == 2 and all(np.isfinite(
        list(out["losses"].values())))
    assert "ef" in out["state"]
    assert "done:" in capsys.readouterr().out
