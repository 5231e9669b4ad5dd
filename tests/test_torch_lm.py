"""The LM family in the port against the reference on the CPU: the five
configs and the registry (``param_count``, ``reduced_config``,
``resolve_config`` with ``moe.`` overrides, concrete batches,
``cache_head_axes``), ``loss_fn`` and its gradients against ``jax.grad``,
AdamW steps of ``make_train_step`` (with microbatches), ``prefill``,
``prefill_chunked`` and ``decode_step`` (the cache's ``index`` and ring
slots), remat policies and banded attention, and the launchers (LM
checkpoint directories across packages: ``tests/test_torch_checkpoint.py``).
The
reference's parameters are carried across by
``convert.lm_params_from_numpy``; inputs come from seeded numpy. Models:
the reference's tiny dense / MoE / sliding-window configs
(``tests/test_lm.py``) and ``reduced_config`` of all five architectures.

Tolerances. Float32 compute on both sides: ``RTOL = 1e-5`` of each
output's largest ``|value|`` (a loss: of ``|loss|``), the GIN and recsys
tests' tolerance: the same operations in the same order, summed in
another order by XLA's and torch's CPU kernels. After AdamW steps the
parameters also carry Adam's normalisation of that gradient error (see
``tests/test_torch_recsys_train.py``), bounded from the reference's own
moments. Integer outputs (ids, batches, ``index``, which slots hold a
key) are equal bit for bit.

bf16 compute (the default) is held against the float32 reference, whose
products are not rounded to bf16 either (the port keeps float32
accumulation where the reference asks for it, as on the TPU; the
reference on the CPU rounds those products to bf16). Bounds, from the
readings at the reduced configs: the loss within ``BF16_LOSS_RTOL =
2^-10`` relative (read at most 2.4e-4; skipping the last layer moves it
by at least 1.7e-3), every gradient leaf within relative L2
``BF16_GRAD_RL2 = 2^-3`` (read at most 0.086, olmoe, where the bf16
reference itself reads 0.089; a skipped layer reads at least 0.62 on
every leaf) and every leaf's change over three AdamW steps within
relative L2 ``BF16_STEP_RL2 = 0.5`` of the float32 reference's change
(read at most 0.34, olmoe; a zero update reads 1). The planted faults
(a layer skipped, the update left at zero) fail these bounds, which
``test_bf16_bounds_catch_planted_faults`` checks.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import lm as R
from repro.models import registry as Rreg
from repro.train import OptimizerConfig as ROpt
from repro.train import init_train_state as r_init_state
from repro.train import make_train_step as r_make_step
from repro_torch.configs.shapes import LM_SHAPES
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as launcher
from repro_torch.models import lm as T
from repro_torch.models import registry as Treg
from repro_torch.train import OptimizerConfig as TOpt
from repro_torch.train import init_train_state as t_init_state
from repro_torch.train import make_train_step as t_make_step
from repro_torch.train import param_leaves
from repro_torch.tree import flatten

RTOL = 1e-5
BF16_LOSS_RTOL = 2.0**-10
BF16_GRAD_RL2 = 2.0**-3
BF16_STEP_RL2 = 0.5
ARCHS = ["h2o-danube-1.8b", "olmoe-1b-7b", "yi-6b", "glm4-9b",
         "mixtral-8x7b"]


def _tiny(mod, name, **kw):
    """The reference's tiny configs (``tests/test_lm.py``), in ``mod``."""
    base = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=97, q_chunk=16, kv_chunk=16, loss_chunk=8)
    if name == "moe":
        base.update(d_ff=0, n_kv_heads=4, moe=mod.MoESettings(
            n_experts=4, top_k=2, d_ff=48, capacity_factor=2.0))
    elif name == "swa":
        base.update(window=8)
    base.update(kw)
    return mod.LMConfig(**base)


def _configs(name, **kw):
    """``(reference cfg, port cfg)`` for a tiny config name or an arch."""
    if name in ARCHS:
        return (dataclasses.replace(Rreg.reduced_config(name), **kw),
                dataclasses.replace(Treg.reduced_config(name), **kw))
    return _tiny(R, name, **kw), _tiny(T, name, **kw)


@functools.lru_cache(maxsize=None)
def _ref_params(name, seed=0):
    cfg, _ = _configs(name)
    return R.init_params(jax.random.PRNGKey(seed), cfg)


def _port(name, tcfg=None, seed=0):
    tcfg = tcfg or _configs(name)[1]
    return lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, _ref_params(name, seed)), tcfg,
        device="cpu")


def _tokens(vocab, shape, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, shape)
    return toks.astype(np.int32)


def _close(ref, got, what, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert ref.shape == got.shape, f"{what}: {ref.shape} != {got.shape}"
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ref - got).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _rl2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# -- configs and the registry --------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    rmod = Rreg._module(arch)
    tmod = Treg._module(arch)
    assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(rmod.CONFIG)
    assert (tmod.FAMILY, tmod.SKIPS) == (rmod.FAMILY, rmod.SKIPS)
    t, r = tmod.CONFIG, rmod.CONFIG
    assert (t.param_count(), t.active_param_count(), t.dh, t.rotary_dim) == \
        (r.param_count(), r.active_param_count(), r.dh, r.rotary_dim)
    assert Treg.family_of(arch) == "lm"
    assert Treg.shapes_of(arch) == LM_SHAPES
    assert Treg._family_init("lm") is T.init_params


def test_lm_shapes_and_arch_ids_match_reference():
    from repro.configs.shapes import LM_SHAPES as R_SHAPES

    assert {k: dataclasses.asdict(v) for k, v in LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}
    assert set(Treg.ARCH_IDS) == set(Rreg.ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_and_resolved_configs_match_reference(arch):
    assert dataclasses.asdict(Treg.reduced_config(arch)) == \
        dataclasses.asdict(Rreg.reduced_config(arch))
    overrides = {"moe.top_k": 1, "moe.capacity_factor": 3.0, "q_chunk": 256,
                 "remat_policy": "save_block_outputs"}
    for shape in LM_SHAPES:
        for dp in (1, 4):
            for over in (None, overrides):
                want = Rreg.resolve_config(arch, shape, dp_degree=dp,
                                           overrides=over)
                got = Treg.resolve_config(arch, shape, dp_degree=dp,
                                          overrides=over)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (shape, dp, over)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_counts(arch):
    """The port's own initialiser: the reference's tree paths, shapes and
    leaf count; ``param_count`` is what it holds."""
    cfg, tcfg = _configs(arch)
    tp = T.init_params(tcfg, seed=3, device="cpu")
    got = {k: tuple(v.shape) for k, v in flatten(tp.tree())}
    want = {k: tuple(v.shape) for k, v in flatten(_ref_params(arch))}
    assert got == want
    assert sum(v.numel() for v in param_leaves(tp).values()) == \
        tcfg.param_count()


def test_lm_batch_for_has_the_reference_leaves():
    cfg, tcfg = _configs("h2o-danube-1.8b")
    for name, shape in LM_SHAPES.items():
        want, _ = Rreg._lm_batch(cfg, shape)
        got = Treg.lm_batch_for(tcfg, shape, np.random.default_rng(0),
                                device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), name
            assert got[k].dtype == torch.int32
            assert 0 <= int(got[k].min()) and int(got[k].max()) < tcfg.vocab


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_head_axes_matches_reference(arch):
    cfg, tcfg = Rreg._module(arch).CONFIG, Treg._module(arch).CONFIG
    for tp in (1, 2, 4, 8, 16, 3):
        assert T.cache_head_axes(tcfg, tp) == R.cache_head_axes(cfg, tp)


# -- loss and gradients --------------------------------------------------------
MODELS = ["dense", "moe", "swa"] + ARCHS


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(name, dtype_name="f32"):
    cfg, _ = _configs(name)
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    batch = {"tokens": jnp.asarray(_tokens(cfg.vocab, (4, 33)))}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: R.loss_fn(p, batch, cfg, dtype=dt), has_aux=True))(
            _ref_params(name))
    return float(loss), {k: float(v) for k, v in aux.items()}, \
        dict(flatten(grads))


def _port_loss_grads(name, dtype=torch.float32, tp=None, tcfg=None):
    cfg, tcfg0 = _configs(name)
    tcfg = tcfg or tcfg0
    tp = tp if tp is not None else _port(name, tcfg)
    leaves = param_leaves(tp)
    for p in leaves.values():
        p.requires_grad_(True)
    batch = {"tokens": torch.tensor(_tokens(cfg.vocab, (4, 33)))}
    loss, aux = T.loss_fn(tp, batch, tcfg, dtype=dtype)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss), {k: float(v) for k, v in aux.items()}, \
        dict(zip(leaves, grads))


@pytest.mark.parametrize("name", MODELS)
def test_loss_aux_and_gradients_match_reference(name):
    r_loss, r_aux, r_grads = _ref_loss_grads(name)
    loss, aux, grads = _port_loss_grads(name)
    _close(r_loss, loss, "loss")
    assert set(aux) == set(r_aux)
    for k in aux:
        assert aux[k] == pytest.approx(r_aux[k], rel=RTOL, abs=2.0**-23), k
    assert list(grads) == list(r_grads)
    for k, r in r_grads.items():
        _close(r, grads[k], k)


def _bf16_errors(name, tp=None):
    """``(loss rel err, worst leaf's gradient rel L2)`` of the bf16 port
    against the float32 reference."""
    r_loss, _, r_grads = _ref_loss_grads(name)
    loss, _, grads = _port_loss_grads(name, torch.bfloat16, tp=tp)
    return (abs(loss - r_loss) / abs(r_loss),
            max(_rl2(grads[k].float().numpy(), r) for k, r in r_grads.items()))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_gradients_against_f32_reference(arch):
    loss_err, grad_err = _bf16_errors(arch)
    assert loss_err <= BF16_LOSS_RTOL, loss_err
    assert grad_err <= BF16_GRAD_RL2, grad_err


def _skip_last_layer(tp):
    real = tp.layers.unbind
    tp.layers.unbind = lambda: real()[:-1]
    return tp


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b"])
def test_bf16_bounds_catch_planted_faults(arch):
    """A port that skips its last layer fails the bf16 loss and gradient
    bounds; an update left at zero fails the step bound."""
    loss_err, grad_err = _bf16_errors(arch, tp=_skip_last_layer(_port(arch)))
    assert loss_err > BF16_LOSS_RTOL and grad_err > BF16_GRAD_RL2
    d_ref = np.random.default_rng(0).standard_normal(64)
    assert _rl2(np.zeros(64), d_ref) > BF16_STEP_RL2


@functools.lru_cache(maxsize=None)
def _ref_steps(name, dtype_name, steps, microbatch):
    cfg, _ = _configs(name)
    dt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    batch = {"tokens": jnp.asarray(_tokens(cfg.vocab, (4, 33)))}
    kw = dict(peak_lr=5e-3, warmup_steps=1, total_steps=steps)
    step = jax.jit(r_make_step(lambda p, b: R.loss_fn(p, b, cfg, dtype=dt),
                               ROpt(**kw), microbatch=microbatch))
    state, metrics, slack = r_init_state(_ref_params(name)), [], {}
    for i in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        # the change a gradient error of RTOL of the leaf's largest
        # gradient makes in this step (see the module's note)
        for k, v in flatten(state["opt"]["v"]):
            sv = np.sqrt(np.asarray(v, np.float64) / (1 - ROpt().b2 ** (i + 1)))
            slack[k] = slack.get(k, 0.0) + metrics[-1]["lr"] * np.minimum(
                1.0, 2 * RTOL * sv.max() / (sv + 1e-8))
    return jax.tree_util.tree_map(np.asarray, state), metrics, slack


@pytest.mark.parametrize("name,microbatch", [("dense", 1), ("moe", 2),
                                             ("olmoe-1b-7b", 1)])
def test_adamw_steps_match_reference(name, microbatch):
    """Three steps of ``make_train_step`` (AdamW, peak_lr 5e-3, warm-up 1)
    at float32, the batch in ``microbatch`` parts: every step's metrics,
    then the parameters and moments."""
    steps = 3
    cfg, tcfg = _configs(name)
    rs, r_metrics, slack = _ref_steps(name, "f32", steps, microbatch)
    kw = dict(peak_lr=5e-3, warmup_steps=1, total_steps=steps)
    step = t_make_step(lambda p, b: T.loss_fn(p, b, tcfg, dtype=torch.float32),
                       TOpt(**kw), microbatch=microbatch)
    ts = t_init_state(_port(name))
    batch = {"tokens": torch.tensor(_tokens(cfg.vocab, (4, 33)))}
    for i in range(steps):
        ts, m = step(ts, batch)
        for k, v in r_metrics[i].items():
            assert float(m[k]) == pytest.approx(v, rel=1e-4, abs=2.0**-23), \
                (i, k)
    assert int(ts["opt"]["step"]) == steps
    got = param_leaves(ts["params"])
    for k, r in flatten(rs["params"]):
        err = np.abs(r - got[k].detach().numpy())
        assert np.all(err <= RTOL * np.abs(r).max() + 2 * slack[k]), k
    for part in ("m", "v"):
        for k, r in flatten(rs["opt"][part]):
            t = ts["opt"][part][k].numpy()
            assert np.abs(r - t).max() <= 1e-3 * np.abs(r).max() + 1e-30, \
                (part, k)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"])
def test_bf16_adamw_steps_against_f32_reference(arch):
    """Each leaf's change over three bf16 steps against the float32
    reference's change (olmoe: the largest readings of the five)."""
    steps = 3
    cfg, tcfg = _configs(arch)
    rs, _, _ = _ref_steps(arch, "f32", steps, 1)
    tp = _port(arch)
    p0 = {k: v.detach().clone() for k, v in param_leaves(tp).items()}
    step = t_make_step(lambda p, b: T.loss_fn(p, b, tcfg),
                       TOpt(peak_lr=5e-3, warmup_steps=1, total_steps=steps))
    ts = t_init_state(tp)
    batch = {"tokens": torch.tensor(_tokens(cfg.vocab, (4, 33)))}
    for _ in range(steps):
        ts, _ = step(ts, batch)
    got = param_leaves(ts["params"])
    for k, r in flatten(rs["params"]):
        d_ref = r - p0[k].numpy()
        d_port = got[k].detach().numpy() - p0[k].numpy()
        assert _rl2(d_port, d_ref) <= BF16_STEP_RL2, k


# -- remat and banded attention ------------------------------------------------
@pytest.mark.parametrize("name", ["dense", "moe", "swa"])
def test_remat_policies_and_banded_attention_give_the_same_loss(name):
    """No remat, ``remat_policy="full"`` and ``"save_block_outputs"``: the
    same loss and gradients bit for bit; ``banded_attention=True`` (with
    the window) the reference's banded loss within RTOL."""
    outs = []
    for kw in (dict(remat=False), dict(remat=True),
               dict(remat=True, remat_policy="save_block_outputs")):
        _, tcfg = _configs(name, **kw)
        loss, _, grads = _port_loss_grads(name, tcfg=tcfg)
        outs.append((loss, grads))
    for loss, grads in outs[1:]:
        assert loss == outs[0][0]
        for k, g in grads.items():
            assert torch.equal(g, outs[0][1][k]), k
    cfg, tcfg = _configs(name, banded_attention=True, window=8)
    toks = _tokens(cfg.vocab, (2, 33), seed=5)
    want, _ = R.loss_fn(_ref_params(name), {"tokens": jnp.asarray(toks)}, cfg,
                        dtype=jnp.float32)
    got, _ = T.loss_fn(_port(name, tcfg), {"tokens": torch.tensor(toks)}, tcfg,
                       dtype=torch.float32)
    _close(want, got, "banded loss")
    _, tcfg_u = _configs(name, window=8)
    unbanded, _ = T.loss_fn(_port(name, tcfg_u),
                            {"tokens": torch.tensor(toks)}, tcfg_u,
                            dtype=torch.float32)
    _close(unbanded.detach(), got, "banded vs unbanded")


# -- prefill, chunked prefill and decode ---------------------------------------
def _chunk_configs(window, moe):
    kw = dict(name="t", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=4 if moe else 2, d_ff=64, vocab=97, q_chunk=8,
              kv_chunk=8, loss_chunk=8, window=window)
    return tuple(mod.LMConfig(**kw, moe=mod.MoESettings(
        n_experts=4, top_k=2, d_ff=48, capacity_factor=4.0) if moe else None)
        for mod in (R, T))


def _cache_close(rc, tc, what):
    assert int(rc["index"]) == tc["index"], what
    for part in ("k", "v"):
        _close(rc[part], tc[part], f"{what} {part}")


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("moe", [False, True])
def test_prefill_chunked_and_decode_match_reference(window, moe):
    """``prefill`` and ``prefill_chunked`` (chunk 8 of 32 tokens: the
    ``swa_local`` path for window 8) against the reference's, logits and
    caches; then a decode step from each cache."""
    cfg, tcfg = _chunk_configs(window, moe)
    params = R.init_params(jax.random.PRNGKey(0), cfg)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    toks = _tokens(97, (2, 32))
    nxt = _tokens(97, (2,), seed=2)
    f32 = dict(dtype=jnp.float32)
    for fn, tfn in ((R.prefill, T.prefill),
                    (functools.partial(R.prefill_chunked, chunk=8),
                     functools.partial(T.prefill_chunked, chunk=8))):
        lg, cache = jax.jit(lambda p, t: fn(p, t, cfg, **f32))(
            params, jnp.asarray(toks))
        t_lg, t_cache = tfn(tp, torch.tensor(toks), tcfg, dtype=torch.float32)
        _close(lg, t_lg, "prefill logits")
        _cache_close(cache, t_cache, "prefill cache")
        d, cache = R.decode_step(params, cache, jnp.asarray(nxt), cfg, **f32)
        t_d, t_cache = T.decode_step(tp, t_cache, torch.tensor(nxt), tcfg,
                                     dtype=torch.float32)
        _close(d, t_d, "decode logits")
        _cache_close(cache, t_cache, "decode cache")


@pytest.mark.parametrize("name", ["dense", "moe", "swa"])
def test_decode_over_8_tokens_matches_reference(name):
    """A prefill of 8 tokens with room for 16, then 8 decode steps (the
    sliding-window config's ring of 8 slots wraps): every step's logits
    and cache against the reference's, and which slots hold a key bit for
    bit."""
    cfg, tcfg = _configs(name)
    params, tp = _ref_params(name), _port(name)
    toks = _tokens(cfg.vocab, (2, 16), seed=3)
    f32 = dict(dtype=jnp.float32)
    lg, cache = R.prefill(params, jnp.asarray(toks[:, :8]), cfg,
                          cache_capacity=16, **f32)
    t_lg, t_cache = T.prefill(tp, torch.tensor(toks[:, :8]), tcfg,
                              cache_capacity=16, dtype=torch.float32)
    _close(lg, t_lg, "prefill")
    step = jax.jit(lambda p, c, t: R.decode_step(p, c, t, cfg, **f32))
    for t in range(8, 16):
        lg, cache = step(params, cache, jnp.asarray(toks[:, t]))
        t_lg, t_cache = T.decode_step(tp, t_cache, torch.tensor(toks[:, t]),
                                      tcfg, dtype=torch.float32)
        _close(lg, t_lg, f"position {t}")
        _cache_close(cache, t_cache, f"position {t}")


@pytest.mark.parametrize("window,capacity", [(8, 8), (None, 12)])
def test_cache_index_and_ring_slots_match_reference(window, capacity):
    """From ``init_cache`` (zeros), 20 decode steps: ``index`` and the
    slots that hold a key equal the reference's at every step (a ring of
    8 for the window; the last slot, clamped, past a full cache)."""
    cfg, tcfg = _chunk_configs(window, False)
    params = R.init_params(jax.random.PRNGKey(0), cfg)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, device="cpu")
    cache = R.init_cache(cfg, 2, capacity, dtype=jnp.float32)
    t_cache = T.init_cache(tcfg, 2, capacity, dtype=torch.float32,
                           device="cpu")
    assert t_cache["k"].shape == cache["k"].shape
    step = jax.jit(lambda p, c, t: R.decode_step(p, c, t, cfg,
                                                 dtype=jnp.float32))
    toks = _tokens(97, (20, 2), seed=4)
    for i in range(20):
        cache = step(params, cache, jnp.asarray(toks[i]))[1]
        t_cache = T.decode_step(tp, t_cache, torch.tensor(toks[i]), tcfg,
                                dtype=torch.float32)[1]
        assert int(cache["index"]) == t_cache["index"] == i + 1
        filled = np.asarray(cache["k"] != 0).any(axis=(0, 1, 3, 4))
        np.testing.assert_array_equal(
            (t_cache["k"] != 0).any(4).any(3).any(1).any(0).numpy(), filled)
        _cache_close(cache, t_cache, f"step {i}")


# -- launchers and checkpoints -------------------------------------------------
def test_train_launcher_lm_reduced_on_cpu(capsys):
    out = launcher.main(["--arch", "h2o-danube-1.8b", "--reduced", "--device",
                         "cpu", "--steps", "3"])
    assert sorted(out["losses"]) == [0, 1, 2]
    assert all(np.isfinite(list(out["losses"].values())))
    assert "done:" in capsys.readouterr().out


def test_serve_cli_lm_on_the_cpu(capsys):
    serve_launcher.main(["--arch", "olmoe-1b-7b", "--device", "cpu",
                         "--tokens", "4"])
    out = capsys.readouterr().out
    stats = json.loads(out.strip().splitlines()[-1])
    assert "generated 4 tokens x batch 4" in out
    assert stats["finite"] and stats["tokens"] == 4 and len(stats["sample"]) == 4


def test_launcher_lm_checkpoint_resumes(tmp_path, capsys):
    """The LM launcher with checkpoints: a second run resumes after the
    first's last step and leaves the state as it found it."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--ckpt-dir", ck, "--ckpt-every", "1", "--steps", "2"]
    first = launcher.main(argv)
    second = launcher.main(argv)
    assert second["start"] == 2 and second["losses"] == {}
    assert "[resume] from step 1" in capsys.readouterr().out
    for a, b in zip(param_leaves(first["state"]["params"]).values(),
                    param_leaves(second["state"]["params"]).values()):
        assert torch.equal(a, b)
