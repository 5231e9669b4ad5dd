"""``kernels.segment_sum.owner_sum`` (GIN's aggregation and graph readout)
on the CPU against the reference's ``jax.ops.segment_sum`` on the same
numpy inputs: bit for bit, float32 and bfloat16 accumulation.

The reference's f32 ``segment_sum`` on the CPU adds each segment's rows in
edge order, and its bf16 one rounds to bf16 after every add; the port
groups edges given in any order by owner with one stable sort
(``segments_from_owners``) and sums each owner's edges in that order, so
the two agree exactly — with raw edges in random order, masked edges,
owners without edges, one owner of 10^5 edges and rows of ``h`` read
through a view at an odd row offset.

The backward (the same sum over the edges grouped by source) is held bit
for bit at float32 against autograd through the plain version and
against ``jax.grad`` of the reference's take + segment_sum, and the bf16
readout's against ``jax.grad`` of its bf16 segment_sum."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.kernels.segment_sum import (owner_sum, owner_sum_plain,
                                             segments, segments_by_source,
                                             segments_from_owners)

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


# ---------------------------------------------------------------------------
# the backward: owner_sum over the edges grouped by source
# ---------------------------------------------------------------------------
def _grad_case(rng, n_rows, n_owners, e, d, masked):
    h = torch.tensor(_feats(rng, n_rows, d))
    dst = torch.tensor(rng.integers(0, n_owners, e).astype(np.int32))
    src = torch.tensor(rng.integers(0, n_rows, e).astype(np.int32))
    src[rng.random(e) < 0.05] = -1  # masked by a negative source too
    valid = torch.tensor(rng.random(e) < 0.8) if masked else None
    perm, seg = segments_from_owners(dst, n_owners)
    return h, src[perm], seg, None if valid is None else valid[perm]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_owners", [50, 400])  # 400: owners without edges
def test_owner_sum_gradient_equals_autograd_through_plain(masked, n_owners):
    """The Function's gradient in ``h`` (owner_sum over the transposed
    grouping, each source's edges in edge order) equals autograd through
    the plain version (``index_select`` then ``index_add_``, whose
    backward adds in edge order too), bit for bit at float32; masked
    edges and rows no edge reads get +0.0."""
    rng = np.random.default_rng(21 + n_owners)
    h, src, seg, valid = _grad_case(rng, 300, n_owners, 3000, 6, masked)
    g = torch.tensor(_feats(rng, n_owners, 6))
    grads = []
    for fn in (lambda x: owner_sum(x, src, seg, valid),
               lambda x: owner_sum_plain(x, src, seg.row_offsets, valid)):
        x = h.clone().requires_grad_(True)
        out = fn(x)
        (out * g).sum().backward()
        grads.append(x.grad)
    _assert_bits_equal(grads[0].numpy(), grads[1].numpy())
    unread = np.setdiff1d(np.arange(300), src[src >= 0].numpy())
    assert not grads[0][unread].numpy().view(np.uint32).any()


def test_owner_sum_gradient_with_a_given_transposed_grouping():
    """``by_source`` built from the edges in their batch order (before the
    sort by owner) sums each source's gradients in that order: equal to
    the reference's backward (``jax.grad`` through take and segment_sum,
    whose scatter-add adds in batch order) bit for bit."""
    rng = np.random.default_rng(23)
    n, e, d = 60, 5000, 4
    h = _feats(rng, n, d)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < 0.9
    g = _feats(rng, n, d)

    def ref_loss(x):
        msgs = jnp.where(jnp.asarray(valid)[:, None],
                         jnp.take(x, jnp.asarray(src), axis=0), 0)
        out = jax.ops.segment_sum(msgs, jnp.asarray(dst), num_segments=n)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(h)))
    perm, seg = segments_from_owners(torch.tensor(dst), n)
    by = segments_by_source(torch.tensor(src), torch.tensor(dst), n,
                            torch.tensor(valid))
    x = torch.tensor(h, requires_grad=True)
    out = owner_sum(x, torch.tensor(src)[perm], seg,
                    torch.tensor(valid)[perm], by_source=by)
    (out * torch.tensor(g)).sum().backward()
    _assert_bits_equal(x.grad.numpy(), want)


def test_bf16_readout_gradient_matches_reference():
    """The graph readout in bf16 (one edge per node, rounded after every
    add): the gradient of each node is its graph's, as ``jax.grad`` of the
    reference's bf16 segment_sum gives it, bit for bit."""
    rng = np.random.default_rng(24)
    n, G, d = 90, 7, 5
    h = _feats(rng, n, d)
    gids = np.sort(rng.integers(0, G, n)).astype(np.int32)
    gids = rng.permutation(gids).astype(np.int32)
    g = _feats(rng, G, d)

    def ref_loss(x):
        out = jax.ops.segment_sum(x.astype(jnp.bfloat16), jnp.asarray(gids),
                                  num_segments=G)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    want = np.asarray(jax.grad(ref_loss)(jnp.asarray(h).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    x = torch.tensor(h).to(torch.bfloat16).requires_grad_(True)
    perm, gseg = segments_from_owners(torch.tensor(gids), G)
    out = owner_sum(x, perm.to(torch.int32), gseg, accumulate=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.tensor(g)).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    _assert_bits_equal(x.grad.float().numpy(), want)


def test_no_backward_where_h_needs_no_gradient(monkeypatch):
    """``h`` without grad (GIN's first layer gathers the input features):
    nothing recorded for a backward. A 3-layer GIN's backward runs the sum
    over the transposed grouping for layers 2 and 3 only, with one
    transposed grouping for the whole forward."""
    import dataclasses
    import importlib

    from repro_torch.models import gnn as T
    from repro_torch.models import registry

    mod = importlib.import_module("repro_torch.kernels.segment_sum.owner_sum")
    rng = np.random.default_rng(25)
    h, src, seg, valid = _grad_case(rng, 40, 40, 300, 3, True)
    with torch.enable_grad():
        assert owner_sum(h, src, seg, valid).grad_fn is None
        assert owner_sum(h.requires_grad_(True), src, seg,
                         valid).grad_fn is not None
    calls = {"forward": 0, "backward": 0}
    real = mod._owner_sum

    def spy(h, src, seg, edge_valid, accumulate, launch_count):
        calls["backward" if launch_count is mod.backward_launches
              else "forward"] += 1
        return real(h, src, seg, edge_valid, accumulate, launch_count)

    groupings = []
    real_by = mod.segments_by_source

    def spy_by(*a, **kw):
        groupings.append(1)
        return real_by(*a, **kw)

    monkeypatch.setattr(mod, "_owner_sum", spy)
    monkeypatch.setattr(T, "segments_by_source", spy_by)
    cfg = dataclasses.replace(registry.reduced_config("gin-tu"), n_layers=3)
    params = T.init_params(cfg, seed=0, device="cpu")
    for p in params.parameters():
        p.requires_grad_(True)
    n, e = 50, 400
    batch = {"feats": torch.randn(n, cfg.d_feat),
             "labels": torch.randint(0, cfg.n_classes, (n,)),
             "edge_src": torch.randint(0, n, (e,), dtype=torch.int32),
             "edge_dst": torch.randint(0, n, (e,), dtype=torch.int32)}
    loss, _ = T.loss_fn(params, batch, cfg)
    assert calls == {"forward": 3, "backward": 0} and len(groupings) == 1
    loss.backward()
    assert calls == {"forward": 3, "backward": 2}
    with torch.no_grad():
        T.loss_fn(params, batch, cfg)
    assert len(groupings) == 1  # none without grad
