"""Synthetic data (numpy; the same generators as the reference).

``posting_list_group`` mirrors the paper's ClueWeb09 experiment: sorted
document ids drawn from a 50M-document universe, grouped by list length
2^K..2^{K+1}-1 — shorter lists have larger gaps and compress worse.
``random_graph`` makes a graph with skewed in-degrees for the GNN.
"""
from __future__ import annotations

import numpy as np

CLUEWEB_DOCS = 50_000_000  # ClueWeb09 Cat. B document count (paper §V)


def posting_list(rng: np.random.Generator, length: int,
                 universe: int = CLUEWEB_DOCS) -> np.ndarray:
    """One sorted docid list of `length` distinct ids (uniform over universe).

    Short lists sample exactly without replacement; from 2^22 ids up
    ``rng.choice(replace=False)`` is too expensive, so the list comes from
    sorted-gap sampling: draw ``length`` ids in the range shrunk by
    ``length``, sort, and add ``arange`` so every gap is ≥ 1.
    """
    if universe > 1 << 32:
        raise ValueError("universe must fit in uint32 docids")
    if length >= universe:
        return np.arange(universe, dtype=np.uint32)
    if length < 1 << 22:
        ids = rng.choice(universe, size=length, replace=False)
        return np.sort(ids).astype(np.uint32)
    y = np.sort(rng.integers(0, universe - length + 1, size=length,
                             dtype=np.int64))
    return (y + np.arange(length, dtype=np.int64)).astype(np.uint32)


def posting_list_group(rng: np.random.Generator, k: int, n_lists: int,
                       universe: int = CLUEWEB_DOCS) -> list[np.ndarray]:
    """Lists with lengths in [2^K, 2^{K+1}) — the paper's grouping."""
    lengths = rng.integers(1 << k, 1 << (k + 1), size=n_lists)
    return [posting_list(rng, int(l), universe) for l in lengths]


def posting_tfs(rng: np.random.Generator, length: int, *,
                zipf_a: float = 1.35, max_tf: int = 64) -> np.ndarray:
    """Per-posting term frequencies for one list: Zipf-skewed ints ≥ 1,
    clipped to ``max_tf`` (BM25 saturation makes larger tfs
    indistinguishable after quantization)."""
    z = rng.zipf(zipf_a, size=length)
    return np.minimum(z, max_tf).astype(np.int64)


def random_graph(rng: np.random.Generator, n_nodes: int, n_edges: int,
                 d_feat: int, n_classes: int, power: float = 0.8):
    """Random graph with skewed degrees; returns dict of numpy arrays."""
    # preferential-attachment-ish: destination prob ∝ rank^-power
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64) ** -power
    p = ranks / ranks.sum()
    dst = rng.choice(n_nodes, size=n_edges, p=p)
    src = rng.integers(0, n_nodes, size=n_edges)
    feats = rng.standard_normal((n_nodes, d_feat), dtype=np.float32)
    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    return {
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "feats": feats,
        "labels": labels,
    }
