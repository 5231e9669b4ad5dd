"""The plain twin of kernel 2's broadcast search (``epilogues.probe_search``:
the per-row sortedness test, the probe-range cut, lower and upper bounds by
``torch.searchsorted``, weight sums over runs of equal slots, brute force on
rows that are not sorted) against the JAX reference's ``membership``,
``bm25_accum`` and ``bm25_weighted`` epilogues and against the port's plain
versions (``_probe_hits``), bit for bit, on adversarial grids: duplicate
docids (gap 0), prefix sums that wrap mod 2^32 partway through a row,
values >= 2^31, garbage and count-0 rows; duplicate probes, probe sets with
-1 in the middle, unsorted or all negative; P in {1, 3, 33, 512, 4096} and
1 to 777 rows. Inputs are made from numpy seeds."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.vbyte_decode import dispatch as Rdispatch
from repro.kernels.vbyte_decode import epilogues as Repi
from repro_torch.core.vbyte import binpack as bpk
from repro_torch.core.vbyte import encode as venc
from repro_torch.core.vbyte import stream_vbyte as svb
from repro_torch.kernels.vbyte_decode import dispatch as Tdispatch
from repro_torch.kernels.vbyte_decode import epilogues as Tepi

from torch_parity import (PROBE_KINDS, ROW_KINDS, assert_same, probe_rows,
                          probe_set, probe_weights)

EPILOGUES = ("membership", "bm25_accum", "bm25_weighted")
# (rows, probe width P, block size B)
SIZES = [(1, 1, 128), (5, 3, 128), (777, 1, 32), (777, 33, 32),
         (64, 512, 128), (777, 512, 32), (5, 4096, 128), (1, 4096, 32)]
W_FORMATS = ("vbyte", "streamvbyte", "binpack")


def _grid(rng, nb, B, kind="mixed"):
    """uint32 [nb, B] grid (garbage past each row's count) and int32
    counts."""
    _, _, vals = probe_rows(rng, nb, B, kind)
    grid = rng.integers(0, 2**32, (nb, B), dtype=np.uint64)
    counts = np.array([v.size for v in vals], np.int32)
    for t, v in enumerate(vals):
        grid[t, :v.size] = v
    return grid.astype(np.uint32), counts


def _weights(rng, counts, B, w_fmt):
    """The aligned weight stream's operands in ``w_fmt``."""
    lists = probe_weights(rng, counts)
    if w_fmt == "vbyte":
        return {"w_payload": venc.encode_ragged_blocked(lists,
                                                        block_size=B).payload}
    enc = {"streamvbyte": svb, "binpack": bpk}[w_fmt].encode_ragged_blocked(
        lists, block_size=B)
    meta = "w_control" if w_fmt == "streamvbyte" else "w_widths"
    return {meta: np.ascontiguousarray(getattr(enc, meta[2:])),
            "w_data": np.ascontiguousarray(enc.data)}


def _extras(rng, epilogue, probe, counts, B, w_fmt="vbyte"):
    ex = {"probe": probe}
    if epilogue == "bm25_accum":
        ex["impact"] = np.array([[7]], np.int32)
    if epilogue == "bm25_weighted":
        ex.update(_weights(rng, counts, B, w_fmt))
    return ex


def _check(epilogue, grid, counts, ex):
    """Reference apply_grid, the port's plain version and the twin agree."""
    ref = Repi.apply_grid(epilogue, jnp.asarray(grid), jnp.asarray(counts),
                          {k: jnp.asarray(v) for k, v in ex.items()})
    t_grid = torch.as_tensor(grid.view(np.int32))
    t_counts = torch.as_tensor(counts)
    t_ex = {k: torch.as_tensor(v) for k, v in ex.items()}
    valid = torch.arange(grid.shape[1])[None, :] < t_counts[:, None]
    assert_same(ref, Tepi.apply_grid(epilogue, t_grid, t_counts, t_ex),
                f"{epilogue} plain")
    twin = Tepi.PROBE_SEARCH[epilogue](t_grid, valid, **t_ex)
    assert twin.dtype == torch.int32
    assert_same(ref, twin, f"{epilogue} twin")
    return ref


@pytest.mark.parametrize("nb,P,B", SIZES)
@pytest.mark.parametrize("probe_kind", PROBE_KINDS)
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_twin_matches_reference_and_plain(epilogue, probe_kind, nb, P, B):
    rng = np.random.default_rng(nb * 7919 + P * 31 + B
                                + 1000 * PROBE_KINDS.index(probe_kind))
    grid, counts = _grid(rng, nb, B)
    probe = probe_set(rng, probe_kind, grid, counts, P)
    ex = _extras(rng, epilogue, probe, counts, B,
                 W_FORMATS[(nb + P) % len(W_FORMATS)])
    _check(epilogue, grid, counts, ex)


@pytest.mark.parametrize("row_kind", ROW_KINDS)
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_twin_on_each_row_kind(epilogue, row_kind):
    """Five rows of one kind against a sorted probe set drawn from them."""
    rng = np.random.default_rng(ROW_KINDS.index(row_kind) + 50)
    grid, counts = _grid(rng, 5, 128, row_kind)
    probe = probe_set(rng, "sorted", grid, counts, 33)
    ref = _check(epilogue, grid, counts,
                 _extras(rng, epilogue, probe, counts, 128))
    if row_kind in ("docids", "full") and epilogue == "membership":
        assert np.asarray(ref).any()  # the probes do hit these rows


@pytest.mark.parametrize("w_fmt", W_FORMATS)
def test_twin_sums_duplicate_docids(w_fmt):
    """Rows that repeat one docid many times (runs of gap 0) under repeated
    probes: each probe sums its whole run, mod 2^32."""
    rng = np.random.default_rng(9)
    B, nb = 128, 6
    grid = np.zeros((nb, B), np.uint32)
    for t in range(nb):
        grid[t] = np.sort(rng.choice(np.arange(100, 110, dtype=np.uint32), B))
    counts = np.array([B, B - 1, 64, 1, 0, B], np.int32)
    probe = np.full((1, 16), -1, np.int32)
    probe[0, :12] = np.sort(rng.integers(98, 112, 12))
    ex = _extras(rng, "bm25_weighted", probe, counts, B, w_fmt)
    ref = _check("bm25_weighted", grid, counts, ex)
    assert (np.asarray(ref).view(np.uint32) > 2**32 // 2).any()


def test_twin_searches_sorted_rows_without_brute_force(monkeypatch):
    """Sorted rows and a sorted probe set take the search branch only: with
    the slot-by-slot compare removed, the twin still gives the reference's
    values."""
    rng = np.random.default_rng(4)
    grid, counts = _grid(rng, 40, 128, "docids")
    probe = probe_set(rng, "sorted", grid, counts, 512)
    for epilogue in EPILOGUES:
        ex = _extras(rng, epilogue, probe, counts, 128)
        ref = Repi.apply_grid(epilogue, jnp.asarray(grid),
                              jnp.asarray(counts),
                              {k: jnp.asarray(v) for k, v in ex.items()})
        with monkeypatch.context() as m:
            m.setattr(Tepi, "_probe_hits", None)
            t_counts = torch.as_tensor(counts)
            twin = Tepi.PROBE_SEARCH[epilogue](
                torch.as_tensor(grid.view(np.int32)),
                torch.arange(128)[None, :] < t_counts[:, None],
                **{k: torch.as_tensor(v) for k, v in ex.items()})
        assert_same(ref, twin, epilogue)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_twin_on_each_core(fmt, epilogue):
    """Docid blocks encoded in each main format (differential, random bases,
    some of whose prefix sums wrap): the twin over the port's decoded grid
    against the reference's unfused decode + epilogue."""
    rng = np.random.default_rng(17)
    B, nb = 32, 50
    lists = [rng.choice(np.array([0, 1, 3, 500], np.uint64),
                        int(rng.integers(0, B + 1))) for _ in range(nb)]
    enc = {"vbyte": venc, "streamvbyte": svb,
           "binpack": bpk}[fmt].encode_ragged_blocked(lists, block_size=B)
    names = Tepi.FORMAT_OPERANDS[fmt]
    bases = rng.integers(0, 2**32, nb, dtype=np.uint64)
    bases[::3] = 2**32 - rng.integers(1, 2000, len(bases[::3]))
    ops = {k: np.ascontiguousarray(getattr(enc, k)) for k in names}
    ops["counts"] = np.asarray(enc.counts, np.int32)
    ops["bases"] = bases.astype(np.uint32).view(np.int32)
    kw = dict(format=fmt, block_size=B, differential=True)
    t_ops = {k: torch.as_tensor(v) for k, v in ops.items()}
    grid = Tdispatch.decode(t_ops, plan="torch", **kw)
    counts = ops["counts"]
    probe = probe_set(rng, "sorted", grid.numpy().view(np.uint32), counts, 64)
    ex = _extras(rng, epilogue, probe, counts, B, fmt)
    ref = Rdispatch.decode({k: jnp.asarray(v) for k, v in ops.items()},
                           epilogue=epilogue, plan="unfused",
                           epilogue_operands={k: jnp.asarray(v)
                                              for k, v in ex.items()}, **kw)
    valid = torch.arange(B)[None, :] < t_ops["counts"][:, None]
    twin = Tepi.PROBE_SEARCH[epilogue](
        grid, valid, **{k: torch.as_tensor(v) for k, v in ex.items()})
    assert_same(ref, twin, f"{fmt} {epilogue}")
