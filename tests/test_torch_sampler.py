"""``data/sampler.py::NeighborSampler`` in the port against the
reference's on the CPU: for the same graph, seeds and generator state
both output the same arrays bit for bit (node ids, compact edge
endpoints, the validity mask, seed ids) and leave the generator in the
same state; the capacities are the reference's. Fanouts ``(5, 3)`` (the
reference's infra test) and ``(15, 10)`` (gin-tu's ``minibatch_lg``)."""
import numpy as np
import pytest

from repro.data.sampler import CSRGraph as RCSR
from repro.data.sampler import NeighborSampler as RSampler
from repro.data.synthetic import random_graph
from repro_torch.data.sampler import CSRGraph, NeighborSampler

KEYS = ("node_ids", "edge_src", "edge_dst", "edge_valid", "seed_ids")


def _graph(n_nodes, n_edges, *, isolated: int = 0):
    g = random_graph(np.random.default_rng(3), n_nodes, n_edges, 4, 3)
    src, dst = g["edge_src"], g["edge_dst"]
    if isolated:  # the last nodes aggregate nothing: no out-edges in the CSR
        keep = dst < n_nodes - isolated
        src, dst = src[keep], dst[keep]
    return (RCSR.from_edges(src, dst, n_nodes),
            CSRGraph.from_edges(src, dst, n_nodes))


@pytest.mark.parametrize("fanouts,n_nodes,n_edges,n_seeds", [
    ((5, 3), 500, 5000, 32),
    ((15, 10), 20000, 400000, 1024),
    ((4, 4, 2), 300, 900, 17),
])
@pytest.mark.parametrize("isolated", [0, 40])
def test_sample_matches_reference(fanouts, n_nodes, n_edges, n_seeds,
                                  isolated):
    rg, tg = _graph(n_nodes, n_edges, isolated=isolated)
    np.testing.assert_array_equal(rg.indptr, tg.indptr)
    np.testing.assert_array_equal(rg.indices, tg.indices)
    rs, ts = RSampler(rg, fanouts), NeighborSampler(tg, fanouts)
    seeds = np.random.default_rng(1).choice(n_nodes, n_seeds, replace=False)
    r_rng, t_rng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):  # consecutive batches from one generator
        want, got = rs.sample(seeds, r_rng), ts.sample(seeds, t_rng)
        assert set(got) == set(KEYS)
        for k in KEYS:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert r_rng.random() == t_rng.random()  # the same draws, in order
    assert ts.edge_capacity(n_seeds) == rs.edge_capacity(n_seeds)
    assert ts.node_capacity(n_seeds) == rs.node_capacity(n_seeds)


def test_sample_truncates_at_the_edge_capacity():
    """A batch larger than the static capacity (capacity recomputed
    smaller than the sampled edges) is cut as the reference cuts it."""
    rg, tg = _graph(400, 4000)

    class Small:
        def edge_capacity(self, n_seeds):
            return 50

    rs, ts = RSampler(rg, (6, 4)), NeighborSampler(tg, (6, 4))
    rs.edge_capacity = ts.edge_capacity = Small().edge_capacity
    seeds = np.arange(20)
    want = rs.sample(seeds, np.random.default_rng(2))
    got = ts.sample(seeds, np.random.default_rng(2))
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["edge_valid"].all() and got["edge_src"].shape == (50,)
