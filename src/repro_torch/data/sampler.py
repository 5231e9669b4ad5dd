"""CSR adjacency (the ``CSRGraph`` part of ``repro/data/sampler.py``;
numpy). The layered neighbor sampler serves the mini-batch shape and is
not ported yet (ROADMAP queue 1 item 14)."""
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
