"""The recsys family in the port against the reference on the CPU, for each
of the four kinds (SASRec, BERT4Rec, BST, two-tower) at the reference's
``reduced_config``, with the reference's parameters carried across by
``convert.recsys_params_from_numpy`` and inputs from seeded numpy: the
configs and the registry, ``recsys_batch``, the loss and its aux, the
gradients per leaf against ``jax.grad``, three AdamW steps of
``make_train_step``, ``serve_scores``, ``retrieval_scores_compressed``
(``dot_score`` through its plain version here), the train launcher, the
serve CLI, checkpoints written by either package and restored by the
other, and the two ways ``loss_fn`` keeps a large batch whole (the
two-tower loss in row chunks, block recomputation) against the direct
computation.

Tolerances. Float32 compute: ``RTOL = 1e-5`` relative to each leaf's
largest ``|value|`` (a loss: to ``|loss|``), ``tests/test_torch_train.py``'s
GIN tolerance: the same operations in the same order, summed in another
order by XLA's and torch's CPU kernels (measured at most 1.8e-6 on the
gradients). After AdamW steps a parameter also carries Adam's
normalisation of that gradient error: an element whose gradient is near
0 moves by ``lr·m̂/(√v̂ + eps)``, which a gradient error of ``RTOL`` of the
leaf's largest gradient moves by up to ``2·RTOL·max√v̂ / (√v̂ + eps)``
of ``lr`` (at most ``lr``). The parameters are held within ``RTOL`` of
the leaf's largest value plus twice that sum over the steps, computed
from the reference's own moments (measured at most 0.42 of it).

bf16 compute (the default): the reference on the CPU rounds its score
products to bf16 (``accum_dtype()`` is ``None`` off the TPU), the port
keeps them float32 as on the TPU, so the two compute other functions
there: each step's loss within ``BF16_LOSS_RTOL = 2^-5`` relative
(measured at most 1.1e-2), aux within 2^-3 absolute (a fraction of 32
rows may flip), and each leaf's parameter change after three steps
within relative L2 ``BF16_STEP_RL2 = 0.75`` of the change the float32
reference makes, whose products are not rounded to bf16 either
(measured at most 0.63, BST; the bf16 reference's own change reads up to
0.75 against it). A leaf left unchanged reads 1 and fails. Serving and retrieval scores
at bf16 within ``BF16_SCORE`` of the scores' largest magnitude: 2^-5
(the sequence kinds: two encoder blocks of bf16 rounding at other places,
measured at most 2^-6) and one bf16 ulp (two-tower). Integer outputs
(ids, the batch) are equal bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as RManager
from repro.core import CompressedIntArray as RArr
from repro.data.synthetic import recsys_batch as r_batch
from repro.models import recsys as R
from repro.models import registry as Rreg
from repro.train import OptimizerConfig as ROpt
from repro.train import init_train_state as r_init_state
from repro.train import make_train_step as r_make_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.shapes import RECSYS_SHAPES
from repro_torch.convert import (recsys_params_from_numpy,
                                 recsys_train_state_from_tree,
                                 train_state_tree)
from repro_torch.core import CompressedIntArray as TArr
from repro_torch.data.synthetic import recsys_batch as t_batch
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as launcher
from repro_torch.models import recsys as T
from repro_torch.models import registry as Treg
from repro_torch.train import OptimizerConfig as TOpt
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step
from repro_torch.train import param_leaves
from repro_torch.tree import flatten

from torch_parity import assert_same, bf16_ulps

RTOL = 1e-5
BF16_LOSS_RTOL = 2.0**-5
BF16_STEP_RL2 = 0.75
BF16_SCORE = {"sasrec": 2.0**-5, "bert4rec": 2.0**-5, "bst": 2.0**-5}
ARCH_OF = {"sasrec": "sasrec", "bert4rec": "bert4rec", "bst": "bst",
           "two_tower": "two-tower-retrieval"}
KINDS = list(ARCH_OF)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BATCH = 32


def _model(kind, seed=0):
    arch = ARCH_OF[kind]
    cfg, tcfg = Rreg.reduced_config(arch), Treg.reduced_config(arch)
    params = R.init_params(jax.random.PRNGKey(seed), cfg)
    tp = recsys_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, device="cpu")
    return cfg, tcfg, params, tp


def _batch(cfg, kind, seed=1, batch=BATCH):
    b = r_batch(np.random.default_rng(seed), kind, batch, cfg.seq_len,
                cfg.n_items, n_mask=cfg.n_mask, n_negatives=cfg.n_negatives,
                n_users=cfg.n_users)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.tensor(v) for k, v in b.items()})


def _leaf_close(ref, got, what="", rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert ref.shape == got.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ref - got).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


# -- configs, registry, data ---------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_configs_and_registry_match_reference(kind):
    arch = ARCH_OF[kind]
    for shape in ("train_batch", "serve_p99", "retrieval_cand"):
        full, tfull = (Rreg.resolve_config(arch, shape),
                       Treg.resolve_config(arch, shape))
        for f in dataclasses.fields(tfull):
            assert getattr(tfull, f.name) == getattr(full, f.name), f.name
    red, tred = Rreg.reduced_config(arch), Treg.reduced_config(arch)
    assert dataclasses.asdict(tred) == dataclasses.asdict(red)
    for c, tc in ((full, tfull), (red, tred)):
        assert (tc.vocab_rows, tc.user_rows, tc.param_count(),
                tc.dense_flops_per_example()) == (
            c.vocab_rows, c.user_rows, c.param_count(),
            c.dense_flops_per_example())
    assert Treg.family_of(arch) == Rreg.family_of(arch) == "recsys"
    assert Treg._family_init("recsys") is T.init_params
    tp = T.init_params(tred, seed=0, device="cpu")
    assert list(param_leaves(tp)) == [k for k, _ in flatten(
        R.init_params(jax.random.PRNGKey(0), red))]


@pytest.mark.parametrize("kind", KINDS)
def test_recsys_batch_matches_reference(kind):
    cfg = Rreg.reduced_config(ARCH_OF[kind])
    kw = dict(n_mask=cfg.n_mask, n_negatives=cfg.n_negatives,
              n_users=cfg.n_users)
    a = r_batch(np.random.default_rng(3), kind, 9, cfg.seq_len, cfg.n_items,
                **kw)
    b = t_batch(np.random.default_rng(3), kind, 9, cfg.seq_len, cfg.n_items,
                **kw)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", ["train_batch", "serve_p99",
                                   "retrieval_cand"])
def test_concrete_batches_have_the_reference_leaves(kind, shape):
    """``recsys_batch_for`` gives the leaves, shapes and dtypes of the
    reference's abstract ``_recsys_batch`` (at a small batch and
    candidate count)."""
    arch = ARCH_OF[kind]
    cfg = Rreg.reduced_config(arch)
    sd = RECSYS_SHAPES[shape]
    small = dataclasses.replace(sd, dims={**sd.dims, "batch": min(
        sd.dims["batch"], 8), **({"n_candidates": 512}
                                 if shape == "retrieval_cand" else {})})
    abstract, _ = Rreg._recsys_batch(cfg, small)
    got = Treg.recsys_batch_for(Treg.reduced_config(arch), small,
                                np.random.default_rng(0), device="cpu")
    assert set(got) == set(abstract)
    for k, sds in abstract.items():
        if k == "cands" and shape == "retrieval_cand":
            arr = got[k]
            assert (arr.format, arr.block_size, arr.differential, arr.n) == (
                "vbyte", 128, True, 512)
            assert arr.stride % sd.dims["payload_stride"] == 0
            ids = arr.decode()
            assert np.all(np.diff(ids.astype(np.int64)) > 0)
            assert ids.min() >= 1 and ids.max() < cfg.vocab_rows
            continue
        assert tuple(got[k].shape) == tuple(sds.shape), k
        assert got[k].dtype == torch.int32, k


# -- loss, gradients and the train step ---------------------------------------
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_loss_aux_and_gradients_match_reference(kind, dt):
    cfg, tcfg, params, tp = _model(kind)
    rb, tb = _batch(cfg, kind)
    rdt, tdt = DTYPES[dt]
    (r_loss, r_aux), r_grads = jax.value_and_grad(
        lambda p: R.loss_fn(p, rb, cfg, dtype=rdt), has_aux=True)(params)
    leaves = param_leaves(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    loss, aux = T.loss_fn(tp, tb, tcfg, dtype=tdt)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert set(aux) == set(r_aux)
    if dt == "bf16":
        assert float(loss) == pytest.approx(float(r_loss),
                                            rel=BF16_LOSS_RTOL)
        for k in aux:
            assert abs(float(aux[k]) - float(r_aux[k])) <= 2.0**-3, k
        return
    _leaf_close(r_loss, loss, "loss")
    for k in aux:
        assert float(aux[k]) == pytest.approx(float(r_aux[k]), rel=RTOL), k
    ref = dict(flatten(r_grads))
    assert list(ref) == list(leaves)
    for (k, r), g in zip(ref.items(), grads):
        _leaf_close(r, g, k)


def _adam_slack(r_state, slack, lr, step, b2):
    """Accumulate, per element, the change a gradient error of ``RTOL`` of
    the leaf's largest gradient makes in Adam's step (see the module's
    note), from the reference's moments after ``step`` steps."""
    for k, v in flatten(r_state["opt"]["v"]):
        sv = np.sqrt(np.asarray(v, np.float64) / (1 - b2 ** step))
        slack[k] = slack.get(k, 0.0) + lr * np.minimum(
            1.0, 2 * RTOL * sv.max() / (sv + 1e-8))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_three_adamw_steps_match_reference(kind, dt):
    """Three steps of ``make_train_step`` (AdamW, peak_lr 5e-3, warm-up 1,
    as the reference's recsys test) on one batch: each step's loss, aux,
    grad norm and lr, then the parameters (at bf16 their change, against
    the float32 reference's) and moments."""
    steps = 3
    cfg, tcfg, params, tp = _model(kind)
    rb, tb = _batch(cfg, kind)
    rdt, tdt = DTYPES[dt]
    kw = dict(peak_lr=5e-3, warmup_steps=1, total_steps=steps)
    p0 = {k: v.detach().clone() for k, v in param_leaves(tp).items()}
    r_step = jax.jit(r_make_step(lambda p, b: R.loss_fn(p, b, cfg, dtype=rdt),
                                 ROpt(**kw)))
    t_step = t_make_step(lambda p, b: T.loss_fn(p, b, tcfg, dtype=tdt),
                         TOpt(**kw))
    rs, ts = r_init_state(params), t_init_state(tp)
    if dt == "bf16":  # the float32 reference's change, for the parameters
        f32_step = jax.jit(r_make_step(
            lambda p, b: R.loss_fn(p, b, cfg, dtype=jnp.float32), ROpt(**kw)))
        fs = r_init_state(params)
        for _ in range(steps):
            fs, _ = f32_step(fs, rb)
    slack = {}
    for step in range(steps):
        rs, rm = r_step(rs, rb)
        ts, tm = t_step(ts, tb)
        _adam_slack(rs, slack, float(rm["lr"]), step + 1, TOpt().b2)
        if step == 0 and dt == "f32":  # the moments hold the 1st gradient
            for part in ("m", "v"):
                for k, r in flatten(rs["opt"][part]):
                    _leaf_close(r, ts["opt"][part][k], f"{part} {k}")
        if dt == "f32":
            for k in rm:
                assert float(tm[k]) == pytest.approx(float(rm[k]),
                                                     rel=RTOL), (step, k)
        else:
            assert float(tm["loss"]) == pytest.approx(
                float(rm["loss"]), rel=BF16_LOSS_RTOL), step
    assert int(ts["opt"]["step"]) == steps
    got = param_leaves(ts["params"])
    for k, r in flatten(rs["params"] if dt == "f32" else fs["params"]):
        r, t = np.asarray(r), got[k].detach().numpy()
        if dt == "f32":
            tol = RTOL * np.abs(r).max() + 2 * slack[k]
            assert np.all(np.abs(r - t) <= tol), k
        else:
            d_ref, d_port = r - p0[k].numpy(), t - p0[k].numpy()
            rl2 = np.linalg.norm(d_ref - d_port) / max(
                np.linalg.norm(d_ref), 1e-30)
            assert rl2 <= BF16_STEP_RL2, (k, rl2)


SEQ_LOSSES = {"sasrec": T._sasrec_loss, "bert4rec": T._bert4rec_loss,
              "bst": T._bst_loss}


@pytest.mark.parametrize("kind", KINDS)
def test_remat_changes_nothing(kind):
    """Block recomputation (``remat``) gives the same loss and gradients
    bit for bit on the CPU; ``train_options`` picks it, and the two-tower
    loss chunk, from the batch's size as stated."""
    _, tcfg, _, tp = _model(kind)
    _, tb = _batch(Rreg.reduced_config(ARCH_OF[kind]), kind)
    leaves = param_leaves(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    if kind in SEQ_LOSSES:
        outs = []
        for remat in (False, True):
            loss, _ = SEQ_LOSSES[kind](tp, tb, tcfg, torch.bfloat16, remat)
            outs.append([loss] + list(torch.autograd.grad(
                loss, list(leaves.values()))))
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    # at 32 rows loss_fn takes neither
    assert T.train_options(tcfg, BATCH) in ({"remat": False},
                                            {"loss_chunk": None})
    full = Treg.resolve_config(ARCH_OF[kind], "train_batch")
    opts = T.train_options(full, 65536)
    assert opts == {"sasrec": {"remat": False}, "bert4rec": {"remat": True},
                    "bst": {"remat": False},
                    "two_tower": {"loss_chunk": 4096}}[kind]


@pytest.mark.parametrize("lr", [5e-3, 1e-4])
def test_bst_full_width_rate(lr):
    """BST at its full widths (embed 32, 8 heads, seq 20, MLP
    1024-512-256; the item vocabulary cut to 2^16 rows, 8,192 batch rows),
    4 AdamW steps (warm-up 1) at bf16 in both packages. At the reference
    test's 5e-3 both losses jump at step 2 (measured 0.6941 -> 9.9272 in
    the reference, 9.8422 in the port) and the two agree there within
    ``BF16_LOSS_RTOL``; at 1e-4, the rate ``chip_smoke.py`` trains BST at,
    both fall at every step and agree within ``BF16_LOSS_RTOL`` (measured
    equal to 4 digits)."""
    cfg = dataclasses.replace(Rreg.resolve_config("bst", "train_batch"),
                              n_items=1 << 16)
    tcfg = dataclasses.replace(Treg.resolve_config("bst", "train_batch"),
                               n_items=1 << 16)
    params = R.init_params(jax.random.PRNGKey(0), cfg)
    tp = recsys_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, device="cpu")
    rb, tb = _batch(cfg, "bst", batch=8192)
    kw = dict(peak_lr=lr, warmup_steps=1, total_steps=4)
    r_step = jax.jit(r_make_step(lambda p, b: R.loss_fn(p, b, cfg),
                                 ROpt(**kw)))
    t_step = t_make_step(lambda p, b: T.loss_fn(p, b, tcfg), TOpt(**kw))
    rs, ts, rl, tl = r_init_state(params), t_init_state(tp), [], []
    for _ in range(4):
        rs, rm = r_step(rs, rb)
        ts, tm = t_step(ts, tb)
        rl.append(float(rm["loss"]))
        tl.append(float(tm["loss"]))
    if lr == 5e-3:
        for r, t in zip(rl[:2], tl[:2]):
            assert t == pytest.approx(r, rel=BF16_LOSS_RTOL), (rl, tl)
        assert rl[1] > 4 * rl[0] and tl[1] > 4 * tl[0], (rl, tl)
    else:
        for r, t in zip(rl, tl):
            assert t == pytest.approx(r, rel=BF16_LOSS_RTOL), (rl, tl)
        for x in (rl, tl):
            assert all(b < a for a, b in zip(x, x[1:])), (rl, tl)


@pytest.mark.parametrize("chunk", [1, 5, 8, 31])
def test_chunked_two_tower_loss_equals_unchunked(chunk):
    """The in-batch softmax ``chunk`` rows at a time (each chunk's logits
    recomputed in the backward pass) against the whole ``[B, B]`` one:
    the loss and aux within float32 rounding (``RTOL``) at float32 and at
    the default bf16 compute; the gradients within ``RTOL`` at float32
    and, at bf16, within two bf16 ulps of each leaf's largest magnitude
    (the whole product's gradient rounds its sum to bf16 once, the
    chunks' each round theirs before they add in float32; measured 1.5
    at chunk 1)."""
    _, tcfg, _, tp = _model("two_tower")
    _, tb = _batch(Rreg.reduced_config(ARCH_OF["two_tower"]), "two_tower")
    leaves = param_leaves(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    for dtype in (torch.float32, torch.bfloat16):
        outs = []
        for c in (None, chunk):
            loss, aux = T._two_tower_loss(tp, tb, tcfg, dtype, c)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            outs.append((loss, aux, grads))
        (l0, a0, g0), (l1, a1, g1) = outs
        _leaf_close(l0.detach(), l1, "loss")
        assert float(a0["in_batch_top1"]) == float(a1["in_batch_top1"])
        for k, x, y in zip(leaves, g0, g1):
            if dtype == torch.float32:
                _leaf_close(x, y, k)
            else:
                ulp = 2.0 ** (int(np.floor(np.log2(float(
                    x.abs().max())))) - 7)
                assert float((x - y).abs().max()) <= 2 * ulp, k


# -- serving -------------------------------------------------------------------
def _serve_batch(cfg, tcfg, seed):
    shape = dataclasses.replace(RECSYS_SHAPES["serve_p99"], dims={"batch": 6})
    tb = Treg.recsys_batch_for(tcfg, shape, np.random.default_rng(seed),
                               device="cpu")
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}, tb


def _scores_close(ref, got, kind, dt, what=""):
    r = torch.tensor(np.asarray(jnp.asarray(ref, jnp.float32)))
    assert tuple(r.shape) == tuple(got.shape), what
    if dt == "f32":
        return _leaf_close(r.numpy(), got, what)
    if kind == "two_tower":
        assert bf16_ulps(r, got.float()) <= 1, what
        return
    err = float((r - got.float()).abs().max())
    assert err <= BF16_SCORE[kind] * float(r.abs().max()), (what, err)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_serve_scores_match_reference(kind, dt):
    cfg, tcfg, params, tp = _model(kind)
    rb, tb = _serve_batch(cfg, tcfg, 4)
    rdt, tdt = DTYPES[dt]
    ref = R.serve_scores(params, rb, cfg, dtype=rdt)
    with torch.inference_mode():
        got = T.serve_scores(tp, tb, tcfg, dtype=tdt)
    assert got.dtype == torch.float32
    _scores_close(ref, got, kind, dt, "serve_scores")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_retrieval_scores_compressed_matches_reference(kind, dt,
                                                       monkeypatch):
    """One query against 300 compressed candidates: ids bit for bit (the
    top ids too at float32), scores as serving's; BST in row chunks
    smaller than the list."""
    cfg, tcfg, params, tp = _model(kind)
    rng = np.random.default_rng(6)
    cands = np.sort(rng.choice(np.arange(1, cfg.vocab_rows), 300,
                               replace=False)).astype(np.uint64)
    hist = rng.integers(1, cfg.n_items, (1, cfg.seq_len)).astype(np.int32)
    rb = {"cands": RArr.encode(cands, differential=True),
          "hist": jnp.asarray(hist)}
    tb = {"cands": TArr.encode(cands, differential=True, device="cpu"),
          "hist": torch.tensor(hist)}
    if kind == "two_tower":
        rb["user_id"], tb["user_id"] = jnp.asarray([7]), torch.tensor([7])
    rdt, tdt = DTYPES[dt]
    monkeypatch.setattr(T, "BST_ROWS", 100)
    r_s, (r_ts, r_ti) = R.retrieval_scores_compressed(
        params, rb, cfg, top_k=20, plan="unfused", dtype=rdt)
    with torch.inference_mode():
        t_s, (t_ts, t_ti) = T.retrieval_scores_compressed(
            tp, tb, tcfg, top_k=20, dtype=tdt)
    _scores_close(r_s, t_s, kind, dt, "scores")
    _scores_close(r_ts, t_ts, kind, dt, "top scores")
    if dt == "f32":
        assert_same(r_ti, t_ti, "top ids")
    assert set(t_ti.tolist()) <= set(cands.astype(int).tolist())


# -- launchers ----------------------------------------------------------------
@pytest.mark.parametrize("arch", list(ARCH_OF.values()))
def test_train_launcher_reduced_on_cpu(arch, capsys):
    out = launcher.main(["--arch", arch, "--steps", "3", "--reduced",
                         "--device", "cpu", "--peak-lr", "1e-2"])
    assert sorted(out["losses"]) == [0, 1, 2]
    assert all(np.isfinite(list(out["losses"].values())))
    assert "done:" in capsys.readouterr().out


def test_train_launcher_resumes_bit_for_bit(tmp_path, capsys):
    """SASRec: 6 steps straight through; then 3 steps with checkpoints and
    a restart to 6 that resumes at step 3: every loss equal bit for bit
    (each step draws a fresh batch from the launcher's generator, which a
    restart reseeds, as the reference's does: the batches of steps 3-5
    differ, so only the state is held)."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", "sasrec", "--reduced", "--device", "cpu",
            "--peak-lr", "1e-2", "--ckpt-dir", ck, "--ckpt-every", "1"]
    first = launcher.main(argv + ["--steps", "3"])
    assert first["start"] == 0
    second = launcher.main(argv + ["--steps", "3"])
    assert second["start"] == 3 and second["losses"] == {}
    assert "[resume] from step 2" in capsys.readouterr().out
    for a, b in zip(param_leaves(first["state"]["params"]).values(),
                    param_leaves(second["state"]["params"]).values()):
        assert torch.equal(a, b)
    assert torch.equal(first["state"]["opt"]["step"],
                       second["state"]["opt"]["step"])


@pytest.mark.parametrize("arch", ["sasrec", "bert4rec", "bst"])
def test_serve_cli_sequence_archs_on_the_cpu(arch, capsys):
    serve_launcher.main(["--arch", arch, "--device", "cpu", "--batch", "3"])
    out = capsys.readouterr().out
    assert "scored batch 3" in out and '"finite": true' in out


# -- checkpoints across packages ----------------------------------------------
def _states(kind):
    cfg, tcfg, params, tp = _model(kind)
    rb, tb = _batch(cfg, kind)
    kw = dict(peak_lr=5e-3, warmup_steps=1, total_steps=2)
    rs = r_init_state(params)
    r_step = jax.jit(r_make_step(
        lambda p, b: R.loss_fn(p, b, cfg, dtype=jnp.float32), ROpt(**kw)))
    for _ in range(2):
        rs, _ = r_step(rs, rb)
    ts = recsys_train_state_from_tree(jax.tree_util.tree_map(np.asarray, rs),
                                      tcfg, device="cpu")
    return cfg, tcfg, rs, ts


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_interchange_both_ways(tmp_path, kind):
    cfg, tcfg, rs, ts = _states(kind)
    # the reference's directory, restored by the port
    RManager(str(tmp_path / "r")).save(5, rs)
    fresh = train_state_tree(t_init_state(T.init_params(
        tcfg, seed=9, device="cpu")))
    got, step = CheckpointManager(str(tmp_path / "r")).restore_latest(fresh)
    assert step == 5
    state = recsys_train_state_from_tree(got, tcfg, device="cpu")
    for (k, a), (_, b) in zip(flatten(train_state_tree(state)),
                              flatten(train_state_tree(ts))):
        assert torch.equal(a.detach(), b.detach()), k
    assert int(state["opt"]["step"]) == 2
    assert all(p.requires_grad for p in param_leaves(state["params"]).values())
    # the port's directory, restored by the reference
    CheckpointManager(str(tmp_path / "t")).save(7, train_state_tree(ts))
    example = jax.tree_util.tree_map(jnp.zeros_like, rs)
    back, step = RManager(str(tmp_path / "t")).restore_latest(example)
    assert step == 7
    for (k, a), (_, b) in zip(flatten(back), flatten(rs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), k)
    assert sorted(os.listdir(tmp_path / "t")) == ["step_00000007"]
