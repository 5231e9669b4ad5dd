"""Synthetic data (numpy; the same generators as the reference).

``posting_list_group`` mirrors the paper's ClueWeb09 experiment: sorted
document ids drawn from a 50M-document universe, grouped by list length
2^K..2^{K+1}-1 — shorter lists have larger gaps and compress worse.
``random_graph`` makes a graph with skewed in-degrees for the GNN,
``molecule_batch`` a batch of small graphs for its graph task,
``recsys_batch`` a recsys training batch, ``sorted_id_bag`` a sorted id
bag and ``token_stream`` the LM pipeline's Zipf token ids.
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


def token_stream(rng: np.random.Generator, n_tokens: int, vocab: int,
                 zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-distributed token ids (the LM data pipeline's input), uint64."""
    z = rng.zipf(zipf_a, size=n_tokens)
    return np.minimum(z - 1, vocab - 1).astype(np.uint64)


def sorted_id_bag(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """A sorted multi-hot id bag of ``min(n, vocab)`` distinct ids below
    ``vocab`` (a recsys history for embedding bags and retrieval), uint64."""
    return np.sort(rng.choice(vocab, size=min(n, vocab),
                              replace=False)).astype(np.uint64)


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


def molecule_batch(rng: np.random.Generator, batch: int, nodes_per: int,
                   edges_per: int, d_feat: int, n_classes: int):
    """Batched small graphs (graph classification), block-diagonal edge
    index."""
    N, E = batch * nodes_per, batch * edges_per
    offs = np.repeat(np.arange(batch) * nodes_per, edges_per)
    src = rng.integers(0, nodes_per, size=E) + offs
    dst = rng.integers(0, nodes_per, size=E) + offs
    return {
        "feats": rng.standard_normal((N, d_feat), dtype=np.float32),
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "graph_ids": np.repeat(np.arange(batch), nodes_per).astype(np.int32),
        "labels": rng.integers(0, n_classes, size=batch).astype(np.int32),
        "n_graphs": batch,
    }


def recsys_batch(rng: np.random.Generator, kind: str, batch: int, seq_len: int,
                 n_items: int, *, n_mask: int = 0, n_negatives: int = 1024,
                 n_users: int = 0):
    """Workload-shaped recsys training batch (ids are 1-based; 0 =
    padding): numpy arrays, the reference's draws in its order."""
    hist = rng.integers(1, n_items, size=(batch, seq_len + 1)).astype(np.int32)
    if kind == "sasrec":
        return {"hist": hist,
                "neg": rng.integers(1, n_items,
                                    size=(batch, seq_len)).astype(np.int32)}
    if kind == "bert4rec":
        h = hist[:, :seq_len].copy()
        mask_pos = np.stack([rng.choice(seq_len, n_mask, replace=False)
                             for _ in range(batch)]).astype(np.int32)
        targets = np.take_along_axis(h, mask_pos, axis=1)
        np.put_along_axis(h, mask_pos, n_items + 1, axis=1)  # [MASK] row
        return {"hist": h, "mask_pos": mask_pos, "targets": targets,
                "negatives": rng.integers(1, n_items,
                                          size=n_negatives).astype(np.int32)}
    if kind == "bst":
        return {"hist": hist[:, :seq_len],
                "target": rng.integers(1, n_items, size=batch).astype(np.int32),
                "label": (rng.random(batch) < 0.5).astype(np.int32)}
    if kind == "two_tower":
        return {"user_id": rng.integers(1, max(n_users, 2),
                                        size=batch).astype(np.int32),
                "hist": hist[:, :seq_len],
                "item_id": rng.integers(1, n_items, size=batch).astype(np.int32)}
    raise ValueError(kind)
