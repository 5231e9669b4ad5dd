"""The port's analysis tools against the reference's, on the CPU.

* ``launch/cost_model.py``: for every cell of ``all_cells()``, single-pod
  (``dp = tp = 16`` over 256 devices) and over ``(4, 1)`` (dp 4, tp 1),
  ``lm_cost`` (ZeRO-1 off and on), ``gnn_cost``, ``recsys_cost`` and
  ``roofline_math.model_flops_global`` equal the reference's float for
  float, each built from its own package's ``resolve_config``. Where the
  reference divides 0 by 0 (an expert-parallel MoE over a ``model`` axis
  of 1), the port counts no all-to-all: it equals the reference on the
  config without ``ep_shard``, which changes that term only.
* ``launch/roofline_math.py``: the terms over the H100 datasheet peaks.
* ``launch/dryrun.py``: a cell's ``argument_bytes_per_device`` (and each
  part) equals a count made here from the reference's abstract arguments
  and ``PartitionSpec`` values over the same mesh shape (a split dimension
  rounded up a position), for cells of every family, ZeRO-1 off and on;
  the LM train rows equal ``tools/zero1_state_bytes.py``'s state; the CLI
  over every cell on ``meta``.
* the stream-level helpers (``delta_decode``, ``masked.count_integers``,
  the three ``decode_stream`` functions, ``synthetic.sorted_id_bag``)
  against the reference's on seeded numpy inputs.
"""
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from torch_parity import np_u32

from repro.launch import cost_model as rcm
from repro.launch import roofline_math as rrm
from repro.models import registry as Rreg
from repro_torch.launch import cost_model as tcm
from repro_torch.launch import dryrun
from repro_torch.launch import roofline_math as trm
from repro_torch.models import registry as Treg

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s) for a, s, _ in Rreg.all_cells()]
# (n_chips, dp, tp): the reference's single-pod mesh, and (4, 1)
MESHES = {"16x16": (256, 16, 16), "4x1": (4, 4, 1)}


def _costs(cm, cfg, shape, fam, n, dp, tp) -> dict:
    if fam == "lm":
        return {z: cm.lm_cost(cfg, shape, n_chips=n, dp=dp, tp=tp,
                              assembly={"zero1": z}) for z in (False, True)}
    fn = cm.gnn_cost if fam == "gnn" else cm.recsys_cost
    return {None: fn(cfg, shape, n_chips=n, dp=dp, tp=tp)}


def _fields(costs: dict) -> dict:
    return {k: (c.flops, c.bytes, c.wire_bytes) for k, c in costs.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cost_model_and_model_flops_equal_reference(arch, shape, mesh):
    n, dp, tp = MESHES[mesh]
    fam = Rreg.family_of(arch)
    r_cfg = Rreg.resolve_config(arch, shape, dp_degree=dp)
    t_cfg = Treg.resolve_config(arch, shape, dp_degree=dp)
    r_shape, t_shape = Rreg.shapes_of(arch)[shape], Treg.shapes_of(arch)[shape]
    assert t_shape.dims == r_shape.dims and t_shape.step == r_shape.step
    got = _fields(_costs(tcm, t_cfg, t_shape, fam, n, dp, tp))
    try:
        want = _fields(_costs(rcm, r_cfg, r_shape, fam, n, dp, tp))
    except ZeroDivisionError:  # the reference's 0/0 all-to-all at tp 1
        assert fam == "lm" and tp == 1 and r_cfg.moe.ep_shard
        r_cfg = dataclasses.replace(r_cfg, moe=dataclasses.replace(
            r_cfg.moe, ep_shard=False))
        want = _fields(_costs(rcm, r_cfg, r_shape, fam, n, dp, tp))
    assert got == want
    r_cell = SimpleNamespace(family=fam, cfg=r_cfg, shape=r_shape)
    t_cell = SimpleNamespace(family=fam, cfg=t_cfg, shape=t_shape)
    assert trm.model_flops_global(t_cell) == rrm.model_flops_global(r_cell)


def test_cell_cost_reads_the_cells_assembly():
    cell = Treg.build_cell("h2o-danube-1.8b", "train_4k", mesh_dp=16,
                           overrides={"zero1": True})
    got = tcm.cell_cost(cell, n_chips=256, dp=16)
    want = tcm.lm_cost(cell.cfg, cell.shape, n_chips=256, dp=16,
                       assembly={"zero1": True})
    assert (got.flops, got.bytes, got.wire_bytes) == (
        want.flops, want.bytes, want.wire_bytes)


def test_decode_cost_equals_reference():
    for fused in (False, True):
        r, t = rcm.decode_cost(1e6, fused=fused), tcm.decode_cost(
            1e6, fused=fused)
        assert (t.flops, t.bytes) == (r.flops, r.bytes)
    assert tcm._ring(8, 1e6, reduce=True) == rcm._ring(8, 1e6, reduce=True)
    assert tcm._ring(1, 1e6) == 0.0


def test_cost_model_zero1_reduces_opt_state_traffic():
    from repro_torch.configs.mixtral_8x7b import CONFIG
    from repro_torch.configs.shapes import LM_SHAPES

    base = tcm.lm_cost(CONFIG, LM_SHAPES["train_4k"], n_chips=256, dp=16)
    z1 = tcm.lm_cost(CONFIG, LM_SHAPES["train_4k"], n_chips=256, dp=16,
                     assembly={"zero1": True})
    assert z1.flops < base.flops  # split AdamW
    assert base.flops > 0 and base.bytes > 0 and base.wire_bytes > 0


def test_cost_model_decode_memory_bound():
    from repro_torch.configs.glm4_9b import CONFIG
    from repro_torch.configs.shapes import LM_SHAPES

    c = tcm.lm_cost(CONFIG, LM_SHAPES["decode_32k"], n_chips=256, dp=16)
    r = trm.make_roofline(c.flops, c.bytes, c.wire_bytes, c.flops)
    assert r.dominant in ("memory", "collective")  # never compute-bound


def test_roofline_terms_and_dominance_on_h100():
    assert (trm.PEAK_FLOPS, trm.HBM_BW, trm.LINK_BW) == (989e12, 3.35e12,
                                                         450e9)
    r = trm.make_roofline(flops=989e12, bytes_=3.35e12 * 2,
                          wire_bytes=450e9 * 3,
                          model_flops_per_device=494.5e12)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(3.0)
    assert r.dominant == "collective"
    assert r.step_time_s == pytest.approx(3.0)
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(494.5e12 / (3.0 * 989e12))
    d = r.to_dict()
    assert d["dominant"] == "collective"
    assert d["step_time_bound_s"] == r.step_time_s


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
def _ref_key(p) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    raise TypeError(p)


def _ref_leaves(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_ref_key(p) for p in path): x for path, x in flat}


def _ref_part(cell, path: str) -> str:
    """The part of a reference argument leaf, by its path."""
    arg, _, rest = path.partition("/")
    if isinstance(cell.args[0], dict) and "opt" in cell.args[0]:  # state
        if arg == "0":
            return "params" if rest.startswith("params/") else "optimizer"
        return "batch"
    if arg == "0":
        return "params"
    if cell.family == "lm" and cell.shape.step == "decode" and arg == "1":
        return "cache"
    return "batch"


def _ref_bytes(cell, mesh: dict) -> dict:
    """Bytes a position holds of each part of the reference's arguments
    laid out by its specs over a mesh of ``mesh`` axis sizes, each split
    dimension rounded up."""
    args = _ref_leaves(cell.args)
    specs = _ref_leaves(cell.arg_specs, is_leaf=lambda x: isinstance(x, P))
    assert list(args) == list(specs)
    out = dict.fromkeys(("params", "optimizer", "batch", "cache"), 0)
    for k, a in args.items():
        shape = list(a.shape)
        for dim, entry in enumerate(tuple(specs[k])):
            names = (() if entry is None else (entry,)
                     if isinstance(entry, str) else tuple(entry))
            n = math.prod(mesh.get(x, 1) for x in names)
            shape[dim] = -(-shape[dim] // n)
        out[_ref_part(cell, k)] += math.prod(shape) * np.dtype(
            a.dtype).itemsize
    return out


DRY_CELLS = [
    ("h2o-danube-1.8b", "train_4k", False),
    ("h2o-danube-1.8b", "train_4k", True),
    ("olmoe-1b-7b", "decode_32k", False),
    ("mixtral-8x7b", "long_500k", False),
    ("glm4-9b", "prefill_32k", False),
    ("gin-tu", "ogb_products", False),
    ("gin-tu", "molecule", False),
    ("sasrec", "retrieval_cand", False),
    ("two-tower-retrieval", "train_batch", False),
    ("two-tower-retrieval", "train_batch", True),
    ("bst", "serve_p99", False),
]


@pytest.mark.parametrize("mesh_shape", [(16, 16), (4, 1)])
@pytest.mark.parametrize("arch,shape,zero1", DRY_CELLS)
def test_dryrun_argument_bytes_equal_reference_specs(arch, shape, zero1,
                                                     mesh_shape):
    over = {"zero1": True} if zero1 else None
    rec = dryrun.run_cell(arch, shape, mesh_shape=mesh_shape,
                          overrides=over)
    ref = Rreg.build_cell(arch, shape, mesh_dp=mesh_shape[0], overrides=over)
    want = _ref_bytes(ref, {"data": mesh_shape[0], "model": mesh_shape[1]})
    assert rec["argument_bytes_by_part"] == want
    assert rec["argument_bytes_per_device"] == sum(want.values())
    assert rec["fits_80GB"] == (sum(want.values()) < 80e9)
    assert rec["n_chips"] == math.prod(mesh_shape)
    assert rec["device"] == "meta"
    assert set(rec["not_carried_over"]) and rec["roofline"]["dominant"] in (
        "compute", "memory", "collective")


def test_dryrun_default_mesh_is_the_reference_production_mesh():
    rec = dryrun.run_cell("sasrec", "train_batch")
    assert (rec["mesh"], rec["n_chips"]) == ("16x16", 256)
    rec = dryrun.run_cell("sasrec", "train_batch", multi_pod=True)
    assert (rec["mesh"], rec["n_chips"]) == ("2x16x16", 512)
    cell = Rreg.build_cell("sasrec", "train_batch", mesh_dp=32)
    assert rec["argument_bytes_by_part"] == _ref_bytes(
        cell, {"pod": 2, "data": 16, "model": 16})


def test_dryrun_cost_terms_are_the_cost_models():
    rec = dryrun.run_cell("olmoe-1b-7b", "train_4k", mesh_shape=(4, 1))
    cell = Treg.build_cell("olmoe-1b-7b", "train_4k", mesh_dp=4)
    c = tcm.cell_cost(cell, n_chips=4, dp=4, tp=1)
    assert (rec["corrected_flops_per_device"],
            rec["corrected_bytes_per_device"],
            rec["wire_bytes_per_device"]) == (c.flops, c.bytes, c.wire_bytes)
    mf = trm.model_flops_global(cell) / 4
    assert rec["model_flops_per_device"] == mf
    assert rec["roofline"] == trm.make_roofline(c.flops, c.bytes,
                                                c.wire_bytes, mf).to_dict()


def _zero1_tool():
    spec = importlib.util.spec_from_file_location(
        "zero1_state_bytes", ROOT / "tools" / "zero1_state_bytes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_lm_train_state_equals_zero1_tool():
    """The params and the optimizer state a card holds, over ``(4, 1)``,
    with and without ZeRO-1: the float32 master, and ``m`` and ``v`` with
    the int32 step."""
    for row in _zero1_tool().rows(4):
        rec = dryrun.run_cell(row["arch"], "train_4k", mesh_shape=(4, 1),
                              overrides={"zero1": row["zero1"]})
        parts = rec["argument_bytes_by_part"]
        assert parts["params"] == row["master"], row["arch"]
        assert parts["optimizer"] == row["m"] + row["v"] + 4, row["arch"]


def test_dryrun_cli_over_every_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--cards", "1", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "no card is used" in out.stdout
    files = sorted(tmp_path.iterdir())
    assert not [f for f in files if f.suffix == ".err"]
    assert len(files) == len(CELLS)
    for arch, shape in CELLS:
        rec = json.loads((tmp_path / f"{arch}__{shape}__single_1cards.json")
                         .read_text())
        assert (rec["mesh"], rec["n_chips"]) == ("1x1", 1)
        assert rec["argument_bytes_per_device"] == sum(
            rec["argument_bytes_by_part"].values())


# ---------------------------------------------------------------------------
# the stream-level helpers
# ---------------------------------------------------------------------------
@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _values(rng, n):
    bits = rng.integers(0, 33, size=n).astype(np.uint64)
    return np.minimum(rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
                      >> (np.uint64(62) - bits), np.uint64(2**32 - 1))


def test_delta_decode_equals_reference(rng):
    from repro.core.vbyte import delta_decode as r_dd
    from repro_torch.core.vbyte import delta_decode as t_dd
    from repro_torch.core.vbyte import delta_encode

    ids = np.sort(rng.integers(0, 1 << 40, size=500)).astype(np.uint64)
    got = t_dd(delta_encode(ids))
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, ids)
    gaps = rng.integers(0, 1 << 20, size=300).astype(np.uint64)
    np.testing.assert_array_equal(t_dd(gaps), r_dd(gaps))
    np.testing.assert_array_equal(t_dd(np.zeros(0)), r_dd(np.zeros(0)))


@pytest.mark.parametrize("nbytes", [None, 0, 1, 17, 200])
def test_count_integers_equals_reference(rng, nbytes):
    from repro.core.vbyte import masked as rm
    from repro_torch.core.vbyte import encode_stream
    from repro_torch.core.vbyte import masked as tm

    data = np.concatenate([encode_stream(_values(rng, 60)),
                           np.zeros(9, np.uint8),
                           rng.integers(0, 256, size=40).astype(np.uint8)])
    got = tm.count_integers(torch.from_numpy(data), nbytes)
    want = rm.count_integers(jnp.asarray(data), nbytes)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want)


def _stream_case(rng, fmt, n, n_max):
    """(reference args, port args) of one stream of ``n`` values,
    zero-padded to ``n_max`` slots' worth of bytes."""
    if fmt == "vbyte":
        from repro_torch.core.vbyte import encode_stream

        tight = encode_stream(_values(rng, n))
        data = np.concatenate([tight, np.zeros(5 * (n_max - n) + 3,
                                               np.uint8)])
        return ((jnp.asarray(data), tight.size),
                (torch.from_numpy(data), tight.size))
    if fmt == "streamvbyte":
        from repro_torch.core.vbyte.stream_vbyte import encode_stream

        control, data = encode_stream(_values(rng, n))
        control = np.concatenate([control, np.zeros(-(-n_max // 4),
                                                    np.uint8)])
        data = np.concatenate([data, np.zeros(4 * n_max, np.uint8)])
        return ((jnp.asarray(control), jnp.asarray(data)),
                (torch.from_numpy(control), torch.from_numpy(data)))
    from repro_torch.core.vbyte.binpack import pack_rows

    w = int(rng.integers(1, 33))
    vals = _values(rng, n) & np.uint64((1 << w) - 1)
    row = np.zeros((1, n_max), np.uint64)
    row[0, :n] = vals
    data = np.concatenate([pack_rows(row, w)[0], np.zeros(5, np.uint8)])
    widths = np.array([w], np.uint8)
    return ((jnp.asarray(widths), jnp.asarray(data)),
            (torch.from_numpy(widths), torch.from_numpy(data)))


@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("n,n_max", [(37, 37), (37, 64), (1, 5)])
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_decode_stream_equals_reference(rng, fmt, n, n_max, differential):
    from repro.core.vbyte import binpack_masked as rb
    from repro.core.vbyte import masked as rv
    from repro.core.vbyte import stream_masked as rs
    from repro_torch.core.vbyte import binpack_masked as tb
    from repro_torch.core.vbyte import masked as tv
    from repro_torch.core.vbyte import stream_masked as ts

    r_args, t_args = _stream_case(rng, fmt, n, n_max)
    base = 123456789
    if fmt == "vbyte":  # n integers in nbytes valid bytes; n_max slots
        (r_data, nbytes), (t_data, _) = r_args, t_args
        want, r_n = rv.decode_stream(r_data, n_max, nbytes=nbytes,
                                     differential=differential, base=base)
        got, t_n = tv.decode_stream(t_data, n_max, nbytes=nbytes,
                                    differential=differential, base=base)
        assert t_n == int(r_n) == n
    else:
        r_fn, t_fn = {"streamvbyte": (rs, ts), "binpack": (rb, tb)}[fmt]
        want = r_fn.decode_stream(*r_args, n_max, n=n,
                                  differential=differential, base=base)
        got = t_fn.decode_stream(*t_args, n_max, n=n,
                                 differential=differential, base=base)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_max,)
    np.testing.assert_array_equal(np_u32(got), np_u32(want))
    assert not np_u32(got)[n:].any()


def test_sorted_id_bag_equals_reference():
    from repro.data.synthetic import sorted_id_bag as r_bag
    from repro_torch.data.synthetic import sorted_id_bag as t_bag

    for n, vocab in ((50, 1000), (300, 200), (1, 1)):
        got = t_bag(np.random.default_rng(n), n, vocab)
        want = r_bag(np.random.default_rng(n), n, vocab)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
