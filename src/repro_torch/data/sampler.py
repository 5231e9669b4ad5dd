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
        row u holds the neighbors whose features u aggregates."""
        order = np.lexsort((src, dst))
        s, d = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, d + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr=indptr, indices=s.astype(np.int32))

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)
