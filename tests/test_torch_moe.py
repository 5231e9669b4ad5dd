"""``nn/moe.py`` in the port against the reference's on the CPU, with the
reference's parameters carried across and inputs from seeded numpy.

Bit for bit: ``_positions_within_expert`` (the stable ranking), the
router's ``top_e`` (equal probabilities ordered by lower expert index, as
``lax.top_k``: planted by duplicated router columns and all-zero token
rows), and the dispatch's ``dst`` / ``keep`` (which rows are dropped).
At float32 on both sides, within ``RTOL = 1e-5`` of each output's
largest magnitude: ``moe_apply``'s output and gradients (against
``jax.grad``) with one and two dispatch groups, with and without drops;
``moe_aux_loss`` and ``moe_drop_frac`` within ``RTOL`` relative (the
drop fraction is a count over ``n`` in float32, which the reference
rounds one way eagerly and another under ``jit``; the rows dropped are
held bit for bit by ``keep``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.nn import moe as R
from repro_torch.models.recsys import topk_lower_index
from repro_torch.nn import moe as T

RTOL = 1e-5
D, F, E = 16, 24, 8


def _close(ref, got, what, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert ref.shape == got.shape, what
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(ref - got).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _model(seed=0, ties=True):
    """Reference parameters (router columns 1 = 5 and 2 = 6 duplicated:
    every token ties those experts) and the port's copy."""
    p = jax.tree_util.tree_map(np.asarray, R.moe_init(
        jax.random.PRNGKey(seed), D, F, E))
    p = jax.tree_util.tree_map(np.array, p)
    if ties:
        p["router"]["w"][:, 5] = p["router"]["w"][:, 1]
        p["router"]["w"][:, 6] = p["router"]["w"][:, 2]
    tp = T.MoE(*(torch.tensor(p[k]["w"]) for k in ("router", "gate", "up",
                                                    "down")))
    return jax.tree_util.tree_map(jnp.asarray, p), tp


def _x(T_, seed=1):
    x = np.random.default_rng(seed).standard_normal((T_, D)).astype(np.float32)
    x[::7] = 0.0  # all-zero rows: every expert ties
    return x


@pytest.mark.parametrize("n,n_experts,seed", [(6, 3, 0), (64, 4, 1),
                                              (512, 8, 2), (1, 2, 3)])
def test_positions_within_expert_matches_reference(n, n_experts, seed):
    flat = np.random.default_rng(seed).integers(0, n_experts, n).astype(np.int32)
    ranks = jax.jit(R._positions_within_expert, static_argnums=1)
    want = np.asarray(ranks(jnp.asarray(flat), n_experts))
    got = T._positions_within_expert(torch.tensor(flat), n_experts)
    np.testing.assert_array_equal(got.numpy(), want)
    # a leading group dim: each row ranked on its own
    rows = np.stack([flat, flat[::-1]])
    got2 = T._positions_within_expert(torch.tensor(rows), n_experts)
    for r, g in zip(rows, got2):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(ranks(jnp.asarray(r), n_experts)))


def test_positions_within_expert_example():
    got = T._positions_within_expert(torch.tensor([1, 0, 1, 1, 0, 2]), 3)
    assert got.tolist() == [0, 0, 1, 2, 1, 0]


@pytest.mark.parametrize("K", [1, 2, 3, 8])
def test_router_top_e_with_planted_ties(K):
    p, _ = _model()
    x = _x(40)
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"]["w"], axis=-1)
    r_p, r_e = jax.lax.top_k(probs, K)
    t_p, t_e = topk_lower_index(torch.tensor(np.asarray(probs)), K)
    np.testing.assert_array_equal(t_e.numpy(), np.asarray(r_e))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(r_p))
    assert (t_e[::7] == torch.arange(K)).all()  # zero rows: experts 0..K-1


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("capacity", [1, 3, 64])
def test_dispatch_matches_reference(G, capacity):
    """``dst``, ``keep`` bit for bit; the buffer and gates equal (a gather
    and a select: no arithmetic)."""
    p, _ = _model()
    Tg, K = 24, 2
    x = _x(G * Tg)
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"]["w"], axis=-1)
    top_p, top_e = jax.lax.top_k(probs, K)
    xg = jnp.asarray(x).reshape(G, Tg, D)
    eg, pg = top_e.reshape(G, Tg, K), top_p.reshape(G, Tg, K)
    want = jax.jit(jax.vmap(lambda a, b, c: R._dispatch_group(
        a, b, c, n_experts=E, capacity=capacity, dtype=jnp.float32)))(
            xg, eg, pg)
    got = T._dispatch_group(
        torch.tensor(np.asarray(xg)), torch.tensor(np.asarray(eg)),
        torch.tensor(np.asarray(pg)), n_experts=E, capacity=capacity,
        dtype=torch.float32)
    names = ("buf", "dst", "gates", "keep")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w,
                                      err_msg=name)
    if capacity == 1:
        assert not got[3].all()  # rows were dropped


CASES = [(1, 8.0), (2, 8.0), (1, 0.5), (2, 0.5)]


def _r_apply(G, cf):
    return jax.jit(lambda p, x: R.moe_apply(
        p, x, top_k=2, capacity_factor=cf, dispatch_groups=G,
        dtype=jnp.float32))


@pytest.mark.parametrize("G,cf", CASES)
def test_moe_apply_matches_reference(G, cf):
    p, tp = _model()
    x = _x(48)
    out, aux = _r_apply(G, cf)(p, jnp.asarray(x))
    t_out, t_aux = T.moe_apply(tp, torch.tensor(x), top_k=2,
                               capacity_factor=cf, dispatch_groups=G,
                               dtype=torch.float32)
    _close(out, t_out, "out")
    assert float(t_aux["moe_drop_frac"]) == pytest.approx(
        float(aux["moe_drop_frac"]), rel=RTOL, abs=2.0**-23)
    assert (float(aux["moe_drop_frac"]) > 0) == (cf < 1.0)
    assert float(t_aux["moe_aux_loss"]) == pytest.approx(
        float(aux["moe_aux_loss"]), rel=RTOL)


def test_groups_fall_back_to_one_where_they_do_not_divide():
    p, tp = _model()
    x = _x(45)
    out, aux = _r_apply(2, 0.5)(p, jnp.asarray(x))
    t_out, t_aux = T.moe_apply(tp, torch.tensor(x), top_k=2,
                               capacity_factor=0.5, dispatch_groups=2,
                               dtype=torch.float32)
    _close(out, t_out, "out")
    assert float(t_aux["moe_drop_frac"]) == pytest.approx(
        float(aux["moe_drop_frac"]), rel=RTOL, abs=2.0**-23)


@pytest.mark.parametrize("G,cf", CASES)
def test_moe_gradients_match_jax_grad(G, cf):
    p, tp = _model(ties=False)
    x = _x(48)
    w = np.random.default_rng(9).standard_normal((48, D)).astype(np.float32)

    def r_loss(params, xx):
        out, aux = R.moe_apply(params, xx, top_k=2, capacity_factor=cf,
                               dispatch_groups=G, dtype=jnp.float32)
        return jnp.sum(out * w) + aux["moe_aux_loss"]

    r_g, r_gx = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(p, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    leaves = [tp.router, tp.gate, tp.up, tp.down]
    for t in leaves:
        t.requires_grad_(True)
    out, aux = T.moe_apply(tp, xt, top_k=2, capacity_factor=cf,
                           dispatch_groups=G, dtype=torch.float32)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum()
                                + aux["moe_aux_loss"], leaves + [xt])
    for name, g in zip(("router", "gate", "up", "down"), grads):
        _close(r_g[name]["w"], g, name)
    _close(r_gx, grads[-1], "x")
