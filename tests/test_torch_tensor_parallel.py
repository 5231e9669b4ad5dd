"""The pieces of compute over a mesh's ``model`` axis, on the CPU: a leaf
split along two dimensions (``split_of``, ``place``, ``BlockSharded``'s
grid, ``gather`` and ``keep``), the position helpers of
``distributed/tensor_parallel.py`` against the unsplit operations, the
attention head ranges, the head-dimension decode, MoE over the positions
against ``moe_apply`` on the same input, a model-parallel train state
through the checkpoint, and the recsys and GIN families over ``model``
(a step and a serving cell, against the single device).

Bit for bit: the column-parallel product (its columns are the unsplit
product's), the vocabulary-parallel lookup and the target's logit (one
non-zero term a sum), MoE's router, dispatch, ``moe_aux_loss`` and
``moe_drop_frac``, and the expert-parallel MoE output. Within ``RTOL =
1e-6`` of the largest ``|value|`` (float32): the row-parallel product,
the logsumexp across positions, the head-dimension decode and the MoE
output over split hidden units, whose float32 sums re-associate.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import train_state_tree
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.api import NamedSharding, named_sharding
from repro_torch.models import lm, registry
from repro_torch.nn import attention as attn
from repro_torch.nn import moe as moe_lib
from repro_torch.train import (OptimizerConfig, init_train_state,
                               jit_train_step, make_train_step)

sys.path.insert(0, str(Path(__file__).parent))
from repro_torch.tree import flatten

RTOL = 1e-6
CPU4 = ["cpu"] * 4


def _mesh(shape=(2, 2)):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


def _close(got, want, rtol=RTOL):
    err = float((got.double() - want.double()).abs().max())
    assert err <= rtol * float(want.double().abs().max()), err


# -- a leaf split along two dimensions ----------------------------------------
@pytest.mark.parametrize("shape,spec,want", [
    ((2, 2), (None, shd.DP, "model"), ((1, ("data",)), (2, ("model",)))),
    ((1, 4), (None, shd.DP, "model"), ((2, ("model",)),)),
    ((2, 2), ("model", shd.DP), ((0, ("model",)), (1, ("data",)))),
    ((4, 1), (None, shd.DP, "model"), ((1, ("data",)),)),
    ((2, 2), (None, None), ()),
])
def test_split_of_gives_up_to_two_split_dimensions(shape, spec, want):
    mesh = _mesh(shape)
    assert shd.split_of(named_sharding(mesh, *spec).spec, mesh) == want


def test_split_of_refuses_an_axis_twice_and_three_dimensions():
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), devices=CPU4)
    with pytest.raises(ValueError, match="names mesh axis 'data' twice"):
        shd.split_of(("data", "data"), mesh)
    with pytest.raises(ValueError, match="twice"):
        shd.split_of((("pod", "data"), "data"), mesh)
    with pytest.raises(NotImplementedError, match="at most two"):
        shd.split_of(("pod", "data", "model"),
                     make_mesh((2, 2, 2), ("pod", "data", "model"),
                               devices=["cpu"] * 8))


@pytest.mark.parametrize("spec", [(None, shd.DP, "model"),
                                  ("model", None, shd.DP)])
def test_a_grid_places_gathers_and_keeps_either_split(spec):
    mesh = _mesh()
    x = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    grid = shd.place(x, NamedSharding(mesh, named_sharding(mesh, *spec).spec),
                     copy=True)
    assert grid.grid == (2, 2) and grid.shape == x.shape
    assert torch.equal(grid.gather(), x)
    assert torch.equal(shd.whole(grid), x)
    for axes in (("data",), ("model",)):
        kept = grid.keep(axes)
        one = tuple(a if a == axes[0] or (a == shd.DP and axes == ("data",))
                    else None for a in spec)
        direct = shd.place(x, named_sharding(mesh, *one))
        assert kept.splits == direct.splits
        for a, b in zip(kept.shards, direct.shards):
            assert torch.equal(a, b)
        # place goes both ways: a grid to one split (keep), one split to
        # the grid (each shard narrowed further)
        assert shd.place(grid, named_sharding(mesh, *one)).splits == \
            direct.splits
        refined = shd.place(direct, named_sharding(mesh, *spec))
        assert refined.splits == grid.splits
        for a, b in zip(refined.shards, grid.shards):
            assert torch.equal(a, b)
    whole = shd.place(grid, named_sharding(mesh, None, None, None))
    assert isinstance(whole, shd.Replicated)
    assert torch.equal(whole.first, x)


def test_a_grid_shard_lies_on_its_mesh_position():
    devs = [torch.device("meta")] * 4
    mesh = make_mesh((2, 2), ("data", "model"), devices=devs)
    assert shd.shard_devices(mesh, ("data",), ("model",)) == tuple(devs)
    cpu = _mesh()
    grid = shd.place(torch.zeros(4, 4), named_sharding(cpu, shd.DP, "model"))
    assert [tuple(s.shape) for s in grid.shards] == [(2, 2)] * 4
    moved = shd.BlockSharded(cpu, ("model",), tuple(
        torch.zeros(4, 2) for _ in range(2)), 1)
    assert shd.place(moved, named_sharding(cpu, None, "model")) is moved


def test_uneven_splits_raise():
    mesh = _mesh((1, 4))
    with pytest.raises(ValueError, match="do not split into 4"):
        shd.place(torch.zeros(6, 8), named_sharding(mesh, "model", None))
    two = _mesh()
    split = shd.place(torch.zeros(4, 3), named_sharding(two, "model", None))
    with pytest.raises(ValueError, match="do not split into 2"):
        shd.place(split, named_sharding(two, "model", shd.DP))
    with pytest.raises(ValueError, match="do not split into 4"):
        tp.ModelParallel(mesh, tuple(mesh.devices.flat), {}).split(
            torch.zeros(2, 6), 1)


def _tp_zero1_case():
    """A reduced LM whose embedding and head (2^20 elements) ZeRO-1 splits
    over the data axes on top of their ``model`` split: 2-D grids."""
    cfg = dataclasses.replace(registry.reduced_config("h2o-danube-1.8b"),
                              vocab=1 << 14, window=None, n_heads=8,
                              microbatch=2)
    meta = registry.abstract_params(cfg, "lm")
    _, cast, tr = registry.zero1_hooks(meta, shd.lm_param_spec(cfg))
    step = make_train_step(lambda p, b: lm.loss_fn(p, b, cfg), OptimizerConfig(
        peak_lr=1e-2, warmup_steps=1, total_steps=3), microbatch=2,
        compute_cast=cast, grad_transform=tr)
    specs = shd.state_specs(meta, shd.lm_param_spec(cfg, zero1=True))
    return cfg, step, specs


def test_a_model_parallel_state_round_trips_through_the_checkpoint(tmp_path):
    """A ZeRO-1 state over ``(2, 2)`` (grids for the embedding and the
    head) saved by ``CheckpointManager`` as whole leaves, restored into a
    fresh state, placed again and stepped: the same bits as the run that
    never stopped."""
    cfg, step, specs = _tp_zero1_case()
    mesh = _mesh()
    sharded = jit_train_step(step, in_shardings=(shd.to_named(mesh, specs),
                                                 {}))
    rng = np.random.default_rng(5)
    batches = [{"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab, (4, 17)).astype(np.int32))} for _ in range(2)]
    state = init_train_state(lm.init_params(cfg, seed=0, device="cpu"))
    state, _ = sharded(state, batches[0])
    emb = state["params"].leaves["embed/emb"]
    assert emb.splits == ((0, ("model",)), (1, ("data",)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, train_state_tree(state))
    fresh = init_train_state(lm.init_params(cfg, seed=1, device="cpu"))
    tree = mgr.restore(1, train_state_tree(fresh))
    for (k, a), (_, b) in zip(flatten(tree), flatten(train_state_tree(state))):
        assert torch.equal(a, b), k
    leaves = dict(flatten(tree["params"]))
    restored = init_train_state(lm.init_params(cfg, seed=1, device="cpu"))
    for k, p in flatten(restored["params"].tree()):
        p.data.copy_(leaves[k])
    for part in ("m", "v"):
        for k in restored["opt"][part]:
            restored["opt"][part][k].copy_(dict(flatten(
                tree["opt"][part]))[k])
    restored["opt"]["step"] = tree["opt"]["step"]
    a, ma = sharded(state, batches[1])
    b, mb = sharded(restored, batches[1])
    assert float(ma["loss"]) == float(mb["loss"])
    for (k, x), (_, y) in zip(flatten(train_state_tree(a)),
                              flatten(train_state_tree(b))):
        assert torch.equal(x, y), k


# -- the position helpers -----------------------------------------------------
def _slices(w, dim, k=4):
    return tp.Slices(tuple(torch.chunk(w, k, dim=dim)), dim)


def test_column_and_row_parallel_products():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 32, generator=g)
    w = torch.randn(32, 48, generator=g)
    cols = tp.column_dense(x, _slices(w, 1), dtype=torch.float32)
    assert torch.equal(torch.cat(cols, -1), x @ w)  # no sum: bit for bit
    xs = list(torch.chunk(x, 4, dim=-1))
    _close(tp.row_dense(xs, _slices(w, 0), home="cpu", dtype=torch.float32),
           x @ w)
    with pytest.raises(ValueError, match="rows"):
        tp.row_dense(xs, _slices(w, 1), home="cpu")
    with pytest.raises(ValueError, match="last"):
        tp.column_dense(x, _slices(w, 0))


def test_vocabulary_parallel_embedding_and_logsumexp():
    g = torch.Generator().manual_seed(1)
    emb = torch.randn(64, 16, generator=g)
    ids = torch.randint(0, 64, (3, 7), generator=g)
    got = tp.vocab_embedding(_slices(emb, 0), ids, home="cpu",
                             dtype=torch.bfloat16)
    assert torch.equal(got, torch.nn.functional.embedding(ids, emb).to(
        torch.bfloat16))
    logits = torch.randn(3, 7, 64, generator=g) * 10
    lse, true = tp.vocab_logsumexp(list(torch.chunk(logits, 4, -1)), ids,
                                   home="cpu")
    _close(lse, torch.logsumexp(logits, -1))
    assert torch.equal(true, torch.gather(logits, -1, ids[..., None])[..., 0])
    # the backward: the gradient of logsumexp is the softmax
    parts = [p.clone().requires_grad_(True)
             for p in torch.chunk(logits, 4, -1)]
    lse, _ = tp.vocab_logsumexp(parts, ids, home="cpu")
    lse.sum().backward()
    _close(torch.cat([p.grad for p in parts], -1),
           torch.softmax(logits, -1))


@pytest.mark.parametrize("H,Hk,k,want", [
    (8, 4, 4, [(0, 2, 0, 1), (2, 4, 1, 2), (4, 6, 2, 3), (6, 8, 3, 4)]),
    (8, 2, 4, [(0, 2, 0, 1), (2, 4, 0, 1), (4, 6, 1, 2), (6, 8, 1, 2)]),
    (16, 16, 4, [(0, 4, 0, 4), (4, 8, 4, 8), (8, 12, 8, 12),
                 (12, 16, 12, 16)]),
    (32, 8, 4, [(0, 8, 0, 2), (8, 16, 2, 4), (16, 24, 4, 6),
                (24, 32, 6, 8)]),
])
def test_head_ranges(H, Hk, k, want):
    assert attn.head_ranges(H, Hk, k) == want


def test_head_ranges_refuse_what_does_not_align():
    with pytest.raises(ValueError, match="do not split"):
        attn.head_ranges(6, 3, 4)
    with pytest.raises(ValueError, match="align"):
        attn.head_ranges(12, 6, 4)


def test_head_dimension_decode_matches_decode_attention():
    g = torch.Generator().manual_seed(2)
    B, H, Hk, D, Sc = 2, 8, 2, 16, 12
    q = torch.randn(B, H, D, generator=g)
    k = torch.randn(B, Sc, Hk, D, generator=g)
    v = torch.randn(B, Sc, Hk, D, generator=g)
    valid = torch.arange(Sc) < 9
    want = attn.decode_attention(q, k, v, valid, dtype=torch.float32)
    got = attn.decode_attention_dh(q, list(torch.chunk(k, 4, -1)),
                                   list(torch.chunk(v, 4, -1)), valid,
                                   home="cpu", dtype=torch.float32)
    _close(got, want)


@pytest.mark.parametrize("split", ["experts", "hidden"])
def test_moe_over_the_positions_matches_moe_apply(split):
    """The router, the dispatch and the combine run at home on the whole
    ``x``: ``moe_aux_loss`` and ``moe_drop_frac`` bit for bit; the
    expert-parallel output bit for bit, the hidden-split one within
    ``RTOL`` (its ``down`` partials are summed)."""
    g = torch.Generator().manual_seed(3)
    params = moe_lib.moe_init(32, 24, 8, generator=g)
    x = torch.randn(40, 32, generator=g)
    kw = dict(top_k=2, capacity_factor=1.0, dispatch_groups=2,
              dtype=torch.float32)
    want, want_aux = moe_lib.moe_apply(params, x, **kw)
    dims = {"experts": (0, 0, 0), "hidden": (2, 2, 1)}[split]
    view = type("V", (), dict(
        router=params.router,
        **{n: _slices(getattr(params, n), d) for n, d in
           zip(("gate", "up", "down"), dims)}))
    got, aux = moe_lib.moe_apply_mp(view, x, home="cpu", **kw)
    assert float(want_aux["moe_drop_frac"]) > 0
    for key in want_aux:
        assert torch.equal(aux[key], want_aux[key]), key
    if split == "experts":
        assert torch.equal(got, want)
    else:
        _close(got, want)


# -- the recsys and GIN families over the model axis ---------------------------
RECSYS_GNN = [("sasrec", "train_batch"), ("two-tower-retrieval",
                                          "train_batch"),
              ("gin-tu", "full_graph_sm")]


@pytest.mark.parametrize("arch,shape", RECSYS_GNN)
def test_recsys_and_gnn_over_the_model_axis_are_refused(arch, shape):
    """The cell over ``(1, 2)`` (GIN over ``(1, 4)``, its node batch split
    over every position) runs and matches the single-device step: a step
    of the reduced cell (recsys at 2^16 items, so its tables split by
    rows over ``model``), its loss within 1e-5 relative and its grad norm
    within 2^-5 (bf16 compute: the row-parallel and cross-position sums
    re-associate). The one-position mesh keeps ``k == 1``."""
    from test_torch_sharded_train import _reduced_cell, _run

    over = {}
    if arch != "gin-tu":
        red = registry.reduced_config(arch)
        over = {f.name: getattr(red, f.name) for f in dataclasses.fields(
            red) if f.name not in ("name", "kind", "extras")}
        over.update(n_items=1 << 16, n_users=red.n_users and 1 << 16)
    cell, batch = _reduced_cell(arch, shape, 1, over)
    mesh = _mesh((1, 2 if arch != "gin-tu" else 4))
    sharded = jit_train_step(cell.fn, in_shardings=cell.in_shardings(mesh))
    assert sharded.mesh.shape["model"] > 1 and sharded.tp == (
        arch != "gin-tu")
    assert sharded.split == (arch == "gin-tu")
    init = functools.partial(registry._family_init(cell.family), cell.cfg,
                             seed=0, device="cpu")
    m_sh, s_sh = _run(sharded, init, [batch], False)
    m_one, _ = _run(cell.fn, init, [batch], False)
    assert abs(m_sh[0]["loss"] / m_one[0]["loss"] - 1) <= 1e-5
    assert abs(m_sh[0]["grad_norm"] / m_one[0]["grad_norm"] - 1) <= 2**-5
    if arch != "gin-tu":
        emb = [k for k in s_sh["params"].leaves if k.endswith("_emb/emb")]
        assert any(isinstance(s_sh["params"].leaves[k], shd.BlockSharded)
                   for k in emb)
    assert jit_train_step(cell.fn, in_shardings=cell.in_shardings(
        _mesh((1, 1)))).mesh.shape["model"] == 1


def test_recsys_serving_cell_over_the_model_axis_is_refused():
    """SASRec's ``serve_p99`` over ``(1, 4)`` (a reduced config at 2^16
    items: its table split by rows) runs through ``run_cell`` and equals
    the single-device scores bit for bit (a row-split lookup adds one
    non-zero row); a train cell still goes to ``jit_train_step``."""
    red = registry.reduced_config("sasrec")
    over = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name not in ("name", "kind", "extras")}
    cell = registry.build_cell("sasrec", "serve_p99", mesh_dp=1,
                               overrides=dict(over, n_items=1 << 16))
    small = dataclasses.replace(cell.shape, dims={"batch": 8})
    batch = registry.recsys_batch_for(cell.cfg, small,
                                      np.random.default_rng(2), device="cpu")
    from repro_torch.models import recsys

    params = recsys.init_params(cell.cfg, seed=0, device="cpu")
    with torch.no_grad():
        got, placed = registry.run_cell(cell, _mesh((1, 4)), params, batch)
        want = cell.fn(params, batch)
    assert isinstance(placed.leaves["item_emb/emb"], shd.BlockSharded)
    assert torch.equal(shd.whole(got), want)
    lm_train = registry.build_cell("h2o-danube-1.8b", "train_4k", mesh_dp=1)
    with pytest.raises(ValueError, match="jit_train_step"):
        registry.run_cell(lm_train, _mesh((1, 4)), None, None)


def test_decode_over_a_cache_split_along_the_sequence_over_data():
    """The ``long_500k`` cell (one row: its cache split along the sequence
    over ``data``, by head dimension over ``model``) over ``(2, 2)``: the
    runner gathers the cache over ``data``, runs the row at the first data
    position and writes the new slot back into the placed shards. Logits
    and cache against the single-device decode within ``RTOL`` (float32)."""
    import functools

    over = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab=256, window=None)
    cell = registry.build_cell("h2o-danube-1.8b", "long_500k", mesh_dp=2,
                               overrides=over)
    cfg = cell.cfg
    cell = dataclasses.replace(cell, fn=functools.partial(
        lm.decode_step, cfg=cfg, dtype=torch.float32))
    assert cell.arg_specs[1]["k"] == (None, None, "data", None, "model")
    params = lm.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(4)
    shape = (cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.dh)
    cache = {"k": torch.randn(shape, generator=g),
             "v": torch.randn(shape, generator=g), "index": 20}
    single = {k: v.clone() if k != "index" else v for k, v in cache.items()}
    mesh = _mesh()
    laid = {k: shd.place(v, cell.in_shardings(mesh)[1][k]) if k != "index"
            else v for k, v in cache.items()}
    assert laid["k"].splits == ((2, ("data",)), (4, ("model",)))
    tok = torch.tensor([7], dtype=torch.int32)
    with torch.no_grad():
        (lg, out), _ = registry.run_cell(cell, mesh, params, laid, tok)
        want, single = lm.decode_step(params, single, tok, cfg,
                                      dtype=torch.float32)
    assert out["k"] is laid["k"] and out["index"] == 21
    _close(shd.whole(lg), want)
    for k in ("k", "v"):
        _close(shd.whole(out[k]), single[k])
