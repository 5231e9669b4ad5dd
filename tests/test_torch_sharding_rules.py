"""The port's sharding rules and registry cells against the reference's.

For every one of the 40 cells (``all_cells(include_skipped=True)``) the
count and the skips, and for each built cell at ``mesh_dp=16`` every
argument leaf's path, shape, dtype and spec equal the reference's
``build_cell`` (LM and recsys train cells also with ``zero1=True``): the
port's arguments are tensors on the ``meta`` device, the reference's
``ShapeDtypeStruct`` values. The port keeps uint32 leaves as int32 holding
their bits, so a reference uint32 leaf is an int32 one here. Then the
rule tables leaf by leaf (``zero1_extend``, ``lm_cache_spec``,
``recsys_param_spec`` in each serving mode), ``named_sharding`` /
``constrain``, the production mesh, and a ``model`` axis larger than 1
(placed, gathered back and stepped over).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.distributed import api as r_api
from repro.distributed import sharding as r_shd
from repro.models import registry as Rreg
from repro_torch.core.compressed_array import FORMAT_LEAVES
from repro_torch.distributed import api as t_api
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as t_shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry as Treg
from repro_torch.tree import flatten

MESH_DP = 16
CELLS = list(Rreg.all_cells(include_skipped=True))
TRAIN_ZERO1 = [(a, s) for a, s, why in CELLS if why is None
               and Rreg.family_of(a) in ("lm", "recsys")
               and Rreg.shapes_of(a)[s].step == "train"]


def _ref_key(p) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    raise TypeError(p)


def _ref_leaves(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_ref_key(p) for p in path): x for path, x in flat}


def _port_leaves(tree, prefix="") -> dict:
    """Path → leaf over the port's arguments and spec trees: models by
    ``tree()``, dicts, tuples, ``CompressedIntArray`` leaves by name, and
    spec tuples as leaves."""
    from repro_torch.core import CompressedIntArray

    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, torch.nn.Module):
        return {join(k): v for k, v in flatten(tree.tree())}
    if isinstance(tree, dict):  # keys sorted, as jax flattens a dict
        out = {}
        for k in sorted(tree):
            out.update(_port_leaves(tree[k], join(k)))
        return out
    if isinstance(tree, CompressedIntArray):
        return {join(k): getattr(tree, k) for k in FORMAT_LEAVES[tree.format]}
    if isinstance(tree, tuple) and not t_shd._is_spec(tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, join(i)))
        return out
    return {prefix: tree}


def _dtype(ref) -> str:
    name = str(np.dtype(ref.dtype))
    return "int32" if name == "uint32" else name


def test_cells_and_skips_match_reference():
    assert list(Treg.all_cells(include_skipped=True)) == CELLS
    assert len(CELLS) == 40
    assert Treg.list_archs() == Rreg.list_archs()
    for a in Rreg.list_archs():
        assert Treg.skips_of(a) == Rreg.skips_of(a)
    assert list(Treg.all_cells()) == list(Rreg.all_cells())


@pytest.mark.parametrize("arch,shape,zero1", [
    (a, s, False) for a, s, _ in CELLS] + [(a, s, True)
                                           for a, s in TRAIN_ZERO1])
def test_cell_args_and_specs_match_reference(arch, shape, zero1):
    why = Rreg.skips_of(arch).get(shape)
    if why is not None:  # a skipped cell: the same reason, nothing built
        assert Treg.skips_of(arch)[shape] == why
        return
    over = {"zero1": True} if zero1 else None
    ref = Rreg.build_cell(arch, shape, mesh_dp=MESH_DP, overrides=over)
    got = Treg.build_cell(arch, shape, mesh_dp=MESH_DP, overrides=over)
    assert (got.family, got.donate, got.assembly) == (
        ref.family, ref.donate, ref.assembly)
    assert got.shape.dims == ref.shape.dims
    r_args, t_args = _ref_leaves(ref.args), _port_leaves(got.args)
    assert list(t_args) == list(r_args)
    for k, r in r_args.items():
        t = t_args[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(r.shape), k
        assert str(t.dtype).removeprefix("torch.") == _dtype(r), k
    r_specs = _ref_leaves(ref.arg_specs, is_leaf=lambda x: isinstance(x, P))
    t_specs = _port_leaves(got.arg_specs)
    assert list(t_specs) == list(r_specs)
    for k, r in r_specs.items():
        assert t_specs[k] == tuple(r), k


def test_zero1_cells_split_leaves_over_the_data_axes():
    """The ZeRO-1 master splits over ``('pod', 'data')`` exactly where the
    reference's does, and the hooks run on one device as casts."""
    cell = Treg.build_cell("h2o-danube-1.8b", "train_4k", mesh_dp=MESH_DP,
                           overrides={"zero1": True})
    split = {k for k, s in cell.arg_specs[0]["params"].items()
             if t_shd.DP in s}
    assert "embed/emb" in split and "layers/ffn/down/w" in split
    assert "final_norm/scale" not in split
    assert cell.fn.compute_cast is not None
    assert cell.fn.grad_transform is not None


def _leaf(shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("spec,shape", [
    ((), (1 << 20,)), ((None,), (1 << 20,)), ((None,), ((1 << 20) - 1,)),
    (("model", None), (32000, 2560)), ((None, None, "model"), (24, 2560, 64)),
    ((None, "model", None, None), (16, 8, 4096, 14336)),
    ((None, None), (1 << 15, 33)), ((None, None), (31, 1 << 16)),
    ((None,), (3, 1 << 20)),
])
def test_zero1_extend_matches_reference(spec, shape):
    ref = r_shd.zero1_extend(P(*spec), jax.ShapeDtypeStruct(shape,
                                                            jnp.float32))
    assert t_shd.zero1_extend(spec, _leaf(shape)) == tuple(ref)


@pytest.mark.parametrize("arch", [a for a in Rreg.list_archs()
                                  if Rreg.family_of(a) == "lm"])
@pytest.mark.parametrize("batch,mesh_dp", [(1, 16), (16, 16), (128, 32),
                                           (8, 16)])
def test_lm_cache_spec_matches_reference(arch, batch, mesh_dp):
    rc = Rreg.resolve_config(arch, "decode_32k")
    tc = Treg.resolve_config(arch, "decode_32k")
    assert t_shd.lm_cache_spec(tc, batch, mesh_dp) == tuple(
        r_shd.lm_cache_spec(rc, batch, mesh_dp))


@pytest.mark.parametrize("mode", ["row", "column", "replicated"])
@pytest.mark.parametrize("arch", [a for a in Rreg.list_archs()
                                  if Rreg.family_of(a) == "recsys"])
def test_recsys_param_spec_serving_modes_match_reference(arch, mode):
    rc = dataclasses.replace(Rreg.resolve_config(arch, "serve_p99"),
                             serve_table_mode=mode)
    tc = dataclasses.replace(Treg.resolve_config(arch, "serve_p99"),
                             serve_table_mode=mode)
    r_params = Rreg.abstract_params(rc, "recsys")
    t_params = Treg.abstract_params(tc, "recsys")
    for serving in (False, True):
        ref = _ref_leaves(r_shd.tree_specs(
            r_params, r_shd.recsys_param_spec(rc, serving=serving)),
            is_leaf=lambda x: isinstance(x, P))
        got = t_shd.tree_specs(t_params,
                               t_shd.recsys_param_spec(tc, serving=serving))
        assert list(got) == list(ref)
        assert got == {k: tuple(v) for k, v in ref.items()}


def test_path_str_matches_reference():
    tree = {"a": [{"b": 1, "c": (2, 3)}], "d": {"e": 4}}
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        assert t_shd._path_str(path) == r_shd._path_str(path)
        assert t_shd._path_str(r_shd._path_str(path)) == r_shd._path_str(path)


@pytest.mark.parametrize("axes", [("data", None), (("pod", "data"), None),
                                  ("pod",), (None, ("data", "model")),
                                  (("pod", "data", "model"),), ()])
def test_named_sharding_resolves_axes_as_reference(axes):
    r_mesh = jax.make_mesh((1, 1), ("data", "model"),
                           devices=jax.devices()[:1])
    t_mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    ref = r_api.named_sharding(r_mesh, *axes)
    got = t_api.named_sharding(t_mesh, *axes)
    assert got.spec == tuple(ref.spec) and got.mesh == t_mesh


def test_constrain_places_under_a_mesh_and_is_a_noop_without():
    x = torch.arange(64.0).reshape(8, 8)
    assert t_api.constrain(x, "data", None) is x
    mesh = make_mesh((4, 1), ("data", "model"), devices=["cpu"] * 4)
    with t_api.activate_mesh(mesh):
        split = t_api.constrain(x, None, ("pod", "data"))
        whole = t_api.constrain(split, None, None)
    assert isinstance(split, t_shd.BlockSharded) and split.dim == 1
    assert [tuple(s.shape) for s in split.shards] == [(8, 2)] * 4
    assert torch.equal(split.gather(), x)
    assert isinstance(whole, t_shd.Replicated)
    assert torch.equal(whole.on("cpu"), x)


def test_a_model_axis_larger_than_one_raises():
    """What replaced the refusal of a ``model`` axis larger than 1: a
    ``model`` split places and gathers back (with a data split on a second
    dimension, a grid), ``jit_train_step`` takes a ``(2, 2)`` mesh and
    runs an LM step (its loss the single-device step's within 1e-5 at
    float32: the row-parallel sums re-associate), and a spec that names
    one axis twice still raises."""
    from repro_torch.models import lm
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   jit_train_step, make_train_step)

    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    x = torch.arange(64.0).reshape(8, 8)
    split = t_shd.place(x, t_api.named_sharding(mesh, "model", None))
    assert split.splits == ((0, ("model",)),)
    assert torch.equal(split.gather(), x)
    grid = t_shd.place(x, t_api.named_sharding(mesh, "model", "data"))
    assert grid.splits == ((0, ("model",)), (1, ("data",)))
    assert [tuple(s.shape) for s in grid.shards] == [(4, 4)] * 4
    assert torch.equal(grid.gather(), x)

    cfg = dataclasses.replace(Treg.reduced_config("h2o-danube-1.8b"),
                              n_layers=1, vocab=64, microbatch=2)
    step = make_train_step(
        lambda p, b: lm.loss_fn(p, b, cfg, dtype=torch.float32),
        OptimizerConfig(), microbatch=2)
    specs = t_shd.state_specs(Treg.abstract_params(cfg, "lm"),
                              t_shd.lm_param_spec(cfg))
    sharded = jit_train_step(step, in_shardings=(t_shd.to_named(mesh, specs),
                                                 {}))
    batch = {"tokens": torch.arange(4 * 17, dtype=torch.int32).reshape(
        4, 17) % cfg.vocab}
    losses = [float(fn(init_train_state(lm.init_params(
        cfg, seed=0, device="cpu")), batch)[1]["loss"])
        for fn in (sharded, step)]
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    with pytest.raises(ValueError, match="names mesh axis 'data' twice"):
        t_shd.place(x, t_api.named_sharding(
            make_mesh((4,), ("data",), devices=["cpu"] * 4), "data", "data"))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_lies_over_the_devices(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * 4)
    want = ({"pod": 1, "data": 4, "model": 1} if multi_pod
            else {"data": 4, "model": 1})
    assert mesh.shape == want
    from repro_torch.launch.mesh import dp_degree

    assert dp_degree(mesh) == 4


def test_production_mesh_needs_a_card_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
