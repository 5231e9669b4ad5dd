"""``kernels.segment_sum.owner_sum`` (GIN's aggregation and graph readout)
on the CPU against the reference's ``jax.ops.segment_sum`` on the same
numpy inputs: bit for bit, float32 and bfloat16 accumulation.

The reference's f32 ``segment_sum`` on the CPU adds each segment's rows in
edge order, and its bf16 one rounds to bf16 after every add; the port
groups edges given in any order by owner with one stable sort
(``segments_from_owners``) and sums each owner's edges in that order, so
the two agree exactly — with raw edges in random order, masked edges,
owners without edges, one owner of 10^5 edges and rows of ``h`` read
through a view at an odd row offset."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.kernels.segment_sum import (owner_sum, owner_sum_plain,
                                             segments, segments_from_owners)

DT = {"f32": (torch.float32, jnp.float32),
      "bf16": (torch.bfloat16, jnp.bfloat16)}


def _feats(rng, n, d):
    """Rows of standard normals scaled by e^±8: sums that round."""
    return (rng.standard_normal((n, d))
            * np.exp(rng.uniform(-8, 8, (n, 1)))).astype(np.float32)


def _reference(h, src, dst, valid, n_owners, h_dt, agg):
    """The reference's aggregation: take, cast, mask, segment_sum."""
    hj = jnp.asarray(h).astype(DT[h_dt][1])
    msgs = jnp.take(hj, jnp.asarray(src), axis=0).astype(DT[agg][1])
    if valid is not None:
        msgs = jnp.where(jnp.asarray(valid)[:, None], msgs, 0)
    out = jax.ops.segment_sum(msgs, jnp.asarray(dst), num_segments=n_owners)
    return np.asarray(out.astype(jnp.float32))


def _port(h, src, dst, valid, n_owners, h_dt, agg):
    """The port's preparation (one stable sort by owner) and owner_sum."""
    ht = torch.tensor(h).to(DT[h_dt][0])
    perm, seg = segments_from_owners(torch.tensor(dst), n_owners)
    vt = None if valid is None else torch.tensor(valid)[perm]
    out = owner_sum(ht, torch.tensor(src)[perm], seg, vt,
                    accumulate=DT[agg][0])
    assert out.dtype == DT[agg][0] and out.shape == (n_owners, h.shape[1])
    return out.float().numpy()


def _assert_bits_equal(a, b):
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h_dt,agg", [("f32", "f32"), ("bf16", "f32"),
                                      ("bf16", "bf16"), ("f32", "bf16")])
def test_owner_sum_equals_segment_sum_raw_edges(h_dt, agg, masked):
    """20,000 edges in random order into 50 owners, d = 8."""
    rng = np.random.default_rng(7)
    n, e, d = 50, 20000, 8
    h = _feats(rng, 300, d)
    src = rng.integers(0, 300, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < 0.8 if masked else None
    _assert_bits_equal(_port(h, src, dst, valid, n, h_dt, agg),
                       _reference(h, src, dst, valid, n, h_dt, agg))


@pytest.mark.parametrize("agg", ["f32", "bf16"])
def test_owner_sum_empty_owners(agg):
    """Owners without edges (and past every edge's owner) sum to +0.0;
    an owner whose edges are all masked too."""
    rng = np.random.default_rng(8)
    n, e, d = 40, 600, 5
    h = _feats(rng, 64, d)
    src = rng.integers(0, 64, e).astype(np.int32)
    dst = (rng.integers(0, 10, e) * 3).astype(np.int32)  # owners 0, 3, .. 27
    valid = dst != 9
    got = _port(h, src, dst, valid, n, "f32", agg)
    _assert_bits_equal(got, _reference(h, src, dst, valid, n, "f32", agg))
    empty = np.setdiff1d(np.arange(n), dst[valid])
    assert empty.size > 20 and not got[empty].view(np.uint32).any()


@pytest.mark.parametrize("agg", ["f32", "bf16"])
def test_owner_sum_one_long_owner(agg):
    """One owner with 10^5 edges beside short ones: a long chain of adds
    in edge order."""
    rng = np.random.default_rng(9)
    d = 4
    h = _feats(rng, 1000, d)
    dst = np.concatenate([np.full(100_000, 2), rng.integers(0, 6, 500)])
    dst = rng.permutation(dst).astype(np.int32)
    src = rng.integers(0, 1000, dst.size).astype(np.int32)
    _assert_bits_equal(_port(h, src, dst, None, 6, "bf16", agg),
                       _reference(h, src, dst, None, 6, "bf16", agg))


@pytest.mark.parametrize("h_dt", ["f32", "bf16"])
def test_owner_sum_h_at_odd_row_offset_and_stride(h_dt):
    """``h`` a view: from row 1 of a wider buffer, columns 1..d (a row
    stride other than d), as CSR edges."""
    rng = np.random.default_rng(10)
    d, n_rows, n = 7, 90, 30
    buf = torch.tensor(_feats(rng, n_rows + 1, d + 3)).to(DT[h_dt][0])
    h = buf[1:, 1:d + 1]
    assert h.stride(0) == d + 3 and h.storage_offset() == d + 4
    deg = rng.integers(0, 40, n)
    ro = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    src = rng.integers(0, n_rows, ro[-1]).astype(np.int32)
    dst = np.repeat(np.arange(n), deg).astype(np.int32)
    out = owner_sum(h, torch.tensor(src), segments(torch.tensor(ro)))
    want = _reference(h.float().numpy(), src, dst, None, n, h_dt, "f32")
    _assert_bits_equal(out.numpy(), want)


def test_owner_sum_plain_is_index_add_in_edge_order():
    """The plain version's f32 sum is ``index_add_`` in edge order, and its
    bf16 sum rounds after every add: checked against a loop."""
    rng = np.random.default_rng(11)
    n, d = 7, 3
    deg = np.array([5, 0, 1, 30, 2, 0, 11])
    ro = torch.tensor(np.concatenate([[0], np.cumsum(deg)]))
    h = torch.tensor(_feats(rng, 20, d))
    src = torch.tensor(rng.integers(0, 20, int(deg.sum())).astype(np.int32))
    for acc in (torch.float32, torch.bfloat16):
        got = owner_sum_plain(h, src, ro, accumulate=acc)
        hh = h.to(acc).float()
        want = torch.zeros(n, d)
        for i in range(n):
            for e in range(int(ro[i]), int(ro[i + 1])):
                want[i] = want[i] + hh[src[e]]
                if acc == torch.bfloat16:
                    want[i] = want[i].to(acc).float()
        assert torch.equal(got.float(), want)


def test_owner_sum_refuses_what_it_does_not_take():
    h = torch.zeros(4, 3)
    seg = segments(torch.tensor([0, 2, 3], dtype=torch.int32))
    src = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="accumulate"):
        owner_sum(h, src, seg, accumulate=torch.float16)
    with pytest.raises(ValueError, match="h must be"):
        owner_sum(h.half(), src, seg)
    with pytest.raises(ValueError, match="src must be"):
        owner_sum(h, src.long(), seg)
    with pytest.raises(ValueError, match="edge_valid"):
        owner_sum(h, src, seg, torch.ones(2, dtype=torch.bool))
