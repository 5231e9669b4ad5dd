"""Every ported epilogue through the port's ``dispatch.decode`` — torch fused
and unfused, the kernel plan on CPU tensors (its plain version), and the
``ref`` path — equals the reference's ``apply_grid`` and
``dispatch.decode(plan="unfused")`` bit for bit, including probe padding,
count-0 blocks and the weighted stream."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import CompressedIntArray as RArr
from repro.kernels.vbyte_decode import dispatch as Rdispatch
from repro.kernels.vbyte_decode import epilogues as Repi
from repro.kernels.vbyte_decode.ops import normalize_probe as R_normalize_probe
from repro_torch.kernels.vbyte_decode import dispatch as Tdispatch
from repro_torch.kernels.vbyte_decode import epilogues as Tepi
from repro_torch.kernels.vbyte_decode.dispatch import DecodePlan
from repro_torch.kernels.vbyte_decode.ops import (normalize_block_meta,
                                                  normalize_probe)

from torch_parity import assert_same

B = 32
PORTED = ("stream", "checksum", "membership", "membership_rows", "bm25_accum",
          "bm25_accum_rows", "bm25_weighted", "bm25_weighted_rows")
PORT_PLANS = ("auto", "torch", DecodePlan("torch", fused=False), "cuda",
              DecodePlan("cuda", fused=False), "ref")


def _workload(seed, differential, *, n=700, zero_blocks=3):
    """Host operands (docid stream + aligned impact stream, count-0 blocks
    appended) and host extras for every epilogue."""
    rng = np.random.default_rng(seed)
    if differential:
        vals = np.sort(rng.choice(5000, size=n, replace=False)).astype(np.uint64)
    else:
        vals = rng.integers(0, 5000, size=n).astype(np.uint64)
    arr = RArr.encode(vals, block_size=B, differential=differential)
    imp = RArr.encode(rng.integers(1, 300, size=n).astype(np.uint64),
                      block_size=B)
    pad = ((0, zero_blocks), (0, 0))
    ops = {"payload": np.pad(np.asarray(arr.payload), pad),
           "counts": np.pad(np.asarray(arr.counts), pad[0]),
           "bases": np.pad(np.asarray(arr.bases), pad[0])}
    nb = ops["payload"].shape[0]
    w_payload = np.pad(np.asarray(imp.payload), pad)
    # broadcast probes: half present in the list, half random; padded with -1
    probe = np.unique(np.concatenate([rng.choice(vals, 20), rng.integers(0, 5000, 20)]))
    probe = normalize_probe(probe, 64)
    rows_probe = np.where(rng.random((nb, 1)) < 0.2, -1,
                          rng.choice(vals, (nb, 1))).astype(np.int32)
    impact = np.array([[7]], np.int32)
    extras = {
        "stream": {}, "checksum": {},
        "membership": {"probe": probe},
        "membership_rows": {"probe": rows_probe},
        "bm25_accum": {"probe": probe, "impact": impact},
        "bm25_accum_rows": {"probe": rows_probe, "impact": impact},
        "bm25_weighted": {"probe": probe, "w_payload": w_payload},
        "bm25_weighted_rows": {"probe": rows_probe, "w_payload": w_payload},
    }
    return ops, extras


def _port(ops, extras):
    t_ops = {"payload": torch.tensor(ops["payload"]),
             "counts": torch.tensor(ops["counts"]),
             "bases": torch.tensor(ops["bases"].view(np.int32))}
    return t_ops, {k: torch.tensor(v) for k, v in extras.items()}


@pytest.mark.parametrize("differential", [False, True])
@pytest.mark.parametrize("epilogue", PORTED)
def test_epilogue_parity(epilogue, differential):
    ops, extras = _workload(21, differential)
    ex = extras[epilogue]
    r_ops = {k: jnp.asarray(v) for k, v in ops.items()}
    r_ex = {k: jnp.asarray(v) for k, v in ex.items()}
    kw = dict(format="vbyte", block_size=B, differential=differential,
              epilogue=epilogue)
    ref = Rdispatch.decode(r_ops, epilogue_operands=r_ex, plan="unfused", **kw)
    grid = Rdispatch.decode(r_ops, format="vbyte", block_size=B,
                            differential=differential, plan="jnp")
    assert_same(ref, Repi.apply_grid(epilogue, grid, r_ops["counts"], r_ex))
    t_ops, t_ex = _port(ops, ex)
    for plan in PORT_PLANS:
        out = Tdispatch.decode(t_ops, epilogue_operands=t_ex, plan=plan, **kw)
        assert_same(ref, out, f"{epilogue} {plan}")
    # the port's apply_grid on the port's decoded grid, and the plain version
    t_grid = Tdispatch.decode(t_ops, format="vbyte", block_size=B,
                              differential=differential, plan="torch")
    assert_same(ref, Tepi.apply_grid(epilogue, t_grid, t_ops["counts"], t_ex))
    assert_same(ref, Tepi.fused_decode_plain(
        t_ops["payload"], t_ops["counts"], t_ops["bases"], t_ex,
        epilogue=epilogue, block_size=B, differential=differential))


@pytest.mark.parametrize("epilogue", ["membership_rows", "bm25_weighted"])
def test_pallas_fused_kernel_parity_tiny(epilogue):
    """Against the Pallas fused kernel itself (interpret mode), tiny."""
    ops, extras = _workload(22, True, n=90, zero_blocks=1)
    r_ops = {k: jnp.asarray(v) for k, v in ops.items()}
    r_ex = {k: jnp.asarray(v) for k, v in extras[epilogue].items()}
    ref = Rdispatch.decode(r_ops, format="vbyte", block_size=B,
                           differential=True, epilogue=epilogue,
                           epilogue_operands=r_ex, plan="kernel")
    t_ops, t_ex = _port(ops, extras[epilogue])
    out = Tepi.fused_decode(t_ops, t_ex, format="vbyte", epilogue=epilogue,
                            block_size=B, differential=True)
    assert_same(ref, out, epilogue)


def test_weighted_stream_long_weights_and_empty_probe_set():
    """Weights of every byte length (the weight tile decodes with the main
    tile's counts), and an all-padding probe set that matches nothing."""
    rng = np.random.default_rng(23)
    vals = np.sort(rng.choice(10**6, size=150, replace=False)).astype(np.uint64)
    w = rng.integers(0, 2**32, size=150, dtype=np.uint64)
    arr = RArr.encode(vals, block_size=B, differential=True)
    imp = RArr.encode(w, block_size=B)
    ops = {k: np.asarray(v) for k, v in arr.device_operands().items()}
    probe = R_normalize_probe(np.sort(rng.choice(vals, 30, replace=False)), 32)
    for ex in ({"probe": probe, "w_payload": np.asarray(imp.payload)},
               {"probe": np.full((1, 8), -1, np.int32),
                "w_payload": np.asarray(imp.payload)}):
        r_ops = {k: jnp.asarray(v) for k, v in ops.items()}
        ref = Rdispatch.decode(r_ops, format="vbyte", block_size=B,
                               differential=True, epilogue="bm25_weighted",
                               epilogue_operands={k: jnp.asarray(v)
                                                  for k, v in ex.items()},
                               plan="unfused")
        t_ops, t_ex = _port(ops, ex)
        for plan in ("torch", "cuda", "ref"):
            out = Tdispatch.decode(t_ops, format="vbyte", block_size=B,
                                   differential=True, epilogue="bm25_weighted",
                                   epilogue_operands=t_ex, plan=plan)
            assert_same(ref, out, plan)


def test_normalize_probe_and_block_meta_errors():
    for bad, match in ((np.array([5, 3]), "sorted"),
                       (np.array([-1, 3]), r"\[0, 2\^31\)"),
                       (np.array([2**31]), r"\[0, 2\^31\)"),
                       (np.arange(10), "width")):
        with pytest.raises(ValueError, match=match):
            normalize_probe(bad, 8)
        with pytest.raises(ValueError, match=match):
            R_normalize_probe(bad, 8)
    np.testing.assert_array_equal(normalize_probe([1, 4, 4, 9], 8),
                                  R_normalize_probe([1, 4, 4, 9], 8))
    x = torch.arange(6, dtype=torch.int32)
    assert normalize_block_meta("counts", x[:, None], 6).shape == (6,)
    for bad in (x[:5], x.reshape(2, 3), x[None, :]):
        with pytest.raises(ValueError, match="counts must have shape"):
            normalize_block_meta("counts", bad, 6)


def test_epilogue_registry_errors():
    ops, extras = _workload(24, True, n=64, zero_blocks=0)
    t_ops, _ = _port(ops, {})
    kw = dict(format="vbyte", block_size=B, differential=True)
    with pytest.raises(ValueError, match="missing"):
        Tdispatch.decode(t_ops, epilogue="membership", **kw)
    with pytest.raises(ValueError, match="unexpected"):
        Tdispatch.decode(t_ops, epilogue="stream",
                         epilogue_operands={"probe": torch.zeros(1, 4)}, **kw)
    with pytest.raises(ValueError, match="unknown epilogue"):
        Tdispatch.decode(t_ops, epilogue="nope", **kw)
    for name in ("bag_sum", "dot_score", "adjacency_rebase"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Tdispatch.decode(t_ops, epilogue=name, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Tepi.fused_decode(t_ops, {}, format="streamvbyte", epilogue="stream",
                          block_size=B, differential=True)
    w = torch.as_tensor(extras["bm25_weighted"]["w_payload"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Tdispatch.decode(t_ops, epilogue="bm25_weighted",
                         epilogue_operands={
                             "probe": torch.as_tensor(extras["membership"]["probe"]),
                             "w_control": w, "w_data": w}, **kw)
    assert set(PORTED) == set(Tepi.EPILOGUES)
