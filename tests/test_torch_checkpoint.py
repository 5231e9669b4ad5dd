"""The port's ``CheckpointManager`` on the CPU: the reference's
checkpoint cases (round trip with bf16, VByte-coded and zigzagged integer
leaves; pruning to ``keep`` with async saves; no partial directories),
corrupt and truncated steps raising ``CheckpointError`` and skipped back
by ``restore_latest``, and directories that interchange with the
reference's ``CheckpointManager`` both ways: the reference's GIN and LM
train states (dense and MoE LMs, their layers stacked ``[L, ...]``)
restored by the port and the port's by the reference, every leaf bit
for bit."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as RManager
from repro.models import gnn as R
from repro.models import registry as Rreg
from repro.train import init_train_state as r_init_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import (gnn_train_state_from_tree,
                                 lm_train_state_from_tree, train_state_tree)
from repro_torch.models import registry as Treg
from repro_torch.robustness import CheckpointError
from repro_torch.tree import flatten

ARCH = "gin-tu"


def _state():
    return {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                   "emb": torch.ones((4, 2), dtype=torch.bfloat16)},
        "steps": torch.arange(1000, dtype=torch.int32),  # vbyte leaf
        "big": torch.arange(-3000, 3000, dtype=torch.int32),  # ≥ 4096 ints
        "neg": torch.tensor([-5, 3, -1], dtype=torch.int32),  # zigzag
        "flag": torch.tensor([True, False]),
    }


def _assert_same(a, b):
    fa, fb = flatten(a), flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        x, y = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x, y
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), k


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, state)
    mgr.save(7, state)
    restored, step = mgr.restore_latest(state)
    assert step == 7
    _assert_same(state, restored)
    with open(tmp_path / "step_00000007" / "manifest.json") as f:
        codecs = {e["name"]: e["codec"] for e in json.load(f)["leaves"]}
    assert codecs == {"big": "vbyte_zigzag", "flag": "raw",
                      "neg": "vbyte_zigzag", "params/emb": "bf16_as_u16",
                      "params/w": "raw", "steps": "vbyte_zigzag"}


def test_checkpoint_prune_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"x": torch.ones(10)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state, async_=True)
        state["x"] += 1  # a save copies its leaves before it returns
    mgr.wait()
    assert mgr.steps() == [3, 4]
    got, step = mgr.restore_latest(state)
    assert step == 4 and torch.equal(got["x"], torch.full((10,), 4.0))


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(3)})
    assert all(not d.startswith(".tmp") for d in os.listdir(tmp_path))


@pytest.mark.parametrize("fault", ["truncated_npz", "garbage_manifest",
                                   "missing_leaves", "shape_mismatch"])
def test_corrupt_step_raises_and_is_skipped_back(tmp_path, fault):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    state = _state()
    for s in (1, 2, 3):
        state["steps"] = state["steps"] + 1
        mgr.save(s, state)
    d = tmp_path / "step_00000003"
    if fault == "truncated_npz":
        data = (d / "leaves.npz").read_bytes()
        (d / "leaves.npz").write_bytes(data[: len(data) // 2])
    elif fault == "garbage_manifest":
        (d / "manifest.json").write_text("{not json")
    elif fault == "missing_leaves":
        os.remove(d / "leaves.npz")
    else:
        m = json.loads((d / "manifest.json").read_text())
        w = next(e for e in m["leaves"] if e["name"] == "params/w")
        w["shape"] = [7, 7]
        (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(CheckpointError, match="step 3"):
        mgr.restore(3, state)
    got, step = mgr.restore_latest(state)
    assert step == 2
    assert torch.equal(got["steps"], torch.arange(1000, dtype=torch.int32)
                       + 2)


def _gin_states(grad_compression: bool):
    """The reference's GIN train state and the port's copy of it."""
    cfg = Rreg.reduced_config(ARCH)
    tcfg = Treg.reduced_config(ARCH)
    rs = r_init_state(R.init_params(jax.random.PRNGKey(0), cfg),
                      grad_compression=grad_compression)
    rng = np.random.default_rng(0)
    # moments, step and error feedback away from their zeros
    rs = jax.tree_util.tree_map(
        lambda x: x if x.ndim == 0 else x + jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), rs)
    rs["opt"]["step"] = jnp.int32(17)
    tree = jax.tree_util.tree_map(np.asarray, rs)
    ts = gnn_train_state_from_tree(tree, tcfg, device="cpu")
    return cfg, tcfg, rs, ts


@pytest.mark.parametrize("grad_compression", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path,
                                                   grad_compression):
    cfg, tcfg, rs, ts = _gin_states(grad_compression)
    RManager(str(tmp_path)).save(5, rs)
    fresh = train_state_tree(
        gnn_train_state_from_tree(
            jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)),
                                   rs), tcfg, device="cpu"))
    got, step = CheckpointManager(str(tmp_path)).restore_latest(fresh)
    assert step == 5
    _assert_same(jax.tree_util.tree_map(
        lambda x: torch.as_tensor(np.asarray(x)), rs), got)
    state = gnn_train_state_from_tree(got, tcfg, device="cpu")
    _assert_same(train_state_tree(ts), train_state_tree(state))
    assert int(state["opt"]["step"]) == 17


@pytest.mark.parametrize("grad_compression", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path,
                                                   grad_compression):
    cfg, tcfg, rs, ts = _gin_states(grad_compression)
    CheckpointManager(str(tmp_path)).save(9, train_state_tree(ts))
    example = jax.tree_util.tree_map(jnp.zeros_like, rs)
    got, step = RManager(str(tmp_path)).restore_latest(example)
    assert step == 9
    for (k, a), (_, b) in zip(flatten(got), flatten(rs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), k)
    with open(tmp_path / "step_00000009" / "manifest.json") as f:
        names = [e["name"] for e in json.load(f)["leaves"]]
    assert names == [jax.tree_util.keystr(p, simple=True, separator="/")
                     for p, _ in jax.tree_util.tree_flatten_with_path(rs)[0]]


def test_generic_leaves_interchange_both_ways(tmp_path):
    """bf16, zigzagged and long VByte integer leaves written by one package
    and read by the other."""
    state = _state()
    CheckpointManager(str(tmp_path / "t")).save(1, state)
    dtypes = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
              torch.int32: jnp.int32, torch.bool: jnp.bool_}
    r_example = jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, dtypes[x.dtype]), state)
    got, _ = RManager(str(tmp_path / "t")).restore_latest(r_example)
    r_state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy()), state)
    for (k, a), (_, b) in zip(flatten(got), flatten(r_state)):
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64), k)
    RManager(str(tmp_path / "r")).save(1, r_state)
    back, _ = CheckpointManager(str(tmp_path / "r")).restore_latest(state)
    _assert_same(state, back)


@pytest.mark.parametrize("n_max,pad,differential", [
    (300, 0, False), (300, 17, True), (120, 5, False), (400, 0, True)])
def test_decode_stream_matches_reference(n_max, pad, differential):
    """The manager's host decoder for long integer leaves against the
    reference's ``decode_stream``: every byte length, zero padding past
    ``nbytes``, fewer or more slots than integers, differential with a
    base."""
    from repro.core.vbyte.masked import decode_stream as r_decode
    from repro_torch.core.vbyte.encode import encode_stream
    from repro_torch.core.vbyte.masked import decode_stream

    rng = np.random.default_rng(n_max + pad)
    bits = rng.integers(0, 33, 300).astype(np.uint64)
    vals = rng.integers(0, 1 << 62, 300, dtype=np.uint64) >> (
        np.uint64(62) - bits)
    data = np.concatenate([encode_stream(vals), np.zeros(pad, np.uint8)])
    kw = dict(nbytes=len(data) - pad, differential=differential, base=7)
    want, n_want = r_decode(jnp.asarray(data), n_max, **kw)
    got, n_got = decode_stream(torch.from_numpy(data), n_max, **kw)
    assert n_got == int(n_want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def _lm_states(arch):
    from repro.models import lm as RL

    cfg, tcfg = Rreg.reduced_config(arch), Treg.reduced_config(arch)
    rs = r_init_state(RL.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    rs = jax.tree_util.tree_map(  # moments away from their zeros
        lambda x: x if x.ndim == 0 else x + jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)), rs)
    rs["opt"]["step"] = jnp.int32(11)
    ts = lm_train_state_from_tree(jax.tree_util.tree_map(np.asarray, rs),
                                  tcfg, device="cpu")
    return tcfg, rs, ts


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b"])
def test_lm_checkpoints_interchange_both_ways(tmp_path, arch):
    from repro_torch.models import lm as TL
    from repro_torch.train import init_train_state as t_init_state
    from repro_torch.train import param_leaves

    tcfg, rs, ts = _lm_states(arch)
    # the reference's directory, restored by the port
    RManager(str(tmp_path / "r")).save(5, rs)
    fresh = train_state_tree(t_init_state(TL.init_params(tcfg, seed=9,
                                                         device="cpu")))
    got, step = CheckpointManager(str(tmp_path / "r")).restore_latest(fresh)
    assert step == 5
    state = lm_train_state_from_tree(got, tcfg, device="cpu")
    _assert_same(train_state_tree(ts), train_state_tree(state))
    assert int(state["opt"]["step"]) == 11
    assert all(p.requires_grad for p in param_leaves(state["params"]).values())
    # the port's directory, restored by the reference
    CheckpointManager(str(tmp_path / "t")).save(7, train_state_tree(ts))
    example = jax.tree_util.tree_map(jnp.zeros_like, rs)
    back, step = RManager(str(tmp_path / "t")).restore_latest(example)
    assert step == 7
    for (k, a), (_, b) in zip(flatten(back), flatten(rs)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), k)
    with open(tmp_path / "t" / "step_00000007" / "manifest.json") as f:
        names = [e["name"] for e in json.load(f)["leaves"]]
    assert names == [jax.tree_util.keystr(p, simple=True, separator="/")
                     for p, _ in jax.tree_util.tree_flatten_with_path(rs)[0]]
