"""Layered neighbor sampler (GraphSAGE-style fanout) over a CSR adjacency.

The port of ``repro/data/sampler.py``: ``CSRGraph`` and
``NeighborSampler``, host numpy. The sampler serves gin-tu's
``minibatch_lg`` shape (1,024 seeds, fanout 15-10): fixed-shape padded
subgraph batches for the device step.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray  # int64 [n_nodes + 1]
    indices: np.ndarray  # int32 [n_edges] — sorted within each row

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray, n_nodes: int) -> "CSRGraph":
        """CSR over outgoing edges of `dst -> src` message direction:
        row u holds the neighbors whose features u aggregates.

        The edges are sorted by (dst, src) as one int64 key ``dst * n +
        src``: the same order as ``np.lexsort((src, dst))`` (equal keys are
        equal edges), ~10x faster at ogbn-products' 62M edges."""
        n = max(int(n_nodes), 1)
        key = np.asarray(dst, np.int64) * n + np.asarray(src, np.int64)
        key.sort()
        d = key // n
        indptr = np.zeros(n_nodes + 1, np.int64)
        indptr[1:] = np.cumsum(np.bincount(d, minlength=n_nodes))
        return cls(indptr=indptr, indices=(key - d * n).astype(np.int32))

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


class NeighborSampler:
    """Uniform with-replacement fanout sampling, fully vectorized."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...]):
        self.g = graph
        self.fanouts = tuple(fanouts)

    def sample(self, seeds: np.ndarray, rng: np.random.Generator):
        """Returns a compacted, padded subgraph batch (the reference's
        arrays for the same seeds and generator state: one
        ``rng.random((len(frontier), f))`` draw a layer, in its order).

        Output dict: feats must be attached by the caller via `node_ids`.
          node_ids  [N_sub]   original node id per compact id (sorted)
          edge_src  [E_max]   compact ids (padded)
          edge_dst  [E_max]
          edge_valid[E_max]
          seed_ids  [n_seeds] compact ids of the seeds (for the loss mask)

        Compact ids are positions in the sorted ``node_ids``
        (``np.searchsorted``), which is what the reference's dict
        relabeling gives.
        """
        g = self.g
        frontier = seeds.astype(np.int64)
        all_src, all_dst = [], []
        nodes = [seeds.astype(np.int64)]
        for f in self.fanouts:
            deg = g.indptr[frontier + 1] - g.indptr[frontier]
            has = deg > 0
            r = rng.random((len(frontier), f))
            offs = np.floor(r * np.maximum(deg, 1)[:, None]).astype(np.int64)
            idx = g.indptr[frontier][:, None] + offs
            nbrs = g.indices[np.minimum(idx, g.n_edges - 1)]
            nbrs = np.where(has[:, None], nbrs, -1)
            src = nbrs.reshape(-1)
            dst = np.repeat(frontier, f)
            keep = src >= 0
            all_src.append(src[keep])
            all_dst.append(dst[keep])
            frontier = np.unique(src[keep])
            nodes.append(frontier)
        node_ids = np.unique(np.concatenate(nodes))
        src = np.concatenate(all_src) if all_src else np.zeros(0, np.int64)
        dst = np.concatenate(all_dst) if all_dst else np.zeros(0, np.int64)

        def compact(x):
            return np.searchsorted(node_ids, x).astype(np.int32)

        c_src, c_dst, c_seed = compact(src), compact(dst), compact(seeds)
        # pad edges to the static capacity
        e_max = self.edge_capacity(len(seeds))
        E = len(c_src)
        pad = e_max - E
        if pad < 0:
            c_src, c_dst, E, pad = c_src[:e_max], c_dst[:e_max], e_max, 0
        return {
            "node_ids": node_ids.astype(np.int64),
            "edge_src": np.pad(c_src, (0, pad)),
            "edge_dst": np.pad(c_dst, (0, pad)),
            "edge_valid": np.arange(e_max) < E,
            "seed_ids": c_seed,
        }

    def edge_capacity(self, n_seeds: int) -> int:
        cap, frontier = 0, n_seeds
        for f in self.fanouts:
            cap += frontier * f
            frontier *= f
        return cap

    def node_capacity(self, n_seeds: int) -> int:
        cap, frontier = n_seeds, n_seeds
        for f in self.fanouts:
            frontier *= f
            cap += frontier
        return cap
