"""Input shapes of the LM, GNN and recsys families (data only; the port of
``repro/configs/shapes.py``).

Sizes that feed node/edge-sharded tensors are padded up to multiples of
512 for the reference's multi-pod mesh; ``raw_nodes``/``raw_edges`` are
the datasets' own sizes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ShapeDef:
    name: str
    step: str  # "train" | "prefill" | "decode" | "serve" | "retrieval"
    dims: dict[str, Any] = field(default_factory=dict)


def _pad512(n: int) -> int:
    return -(-n // 512) * 512


# -- LM transformers ---------------------------------------------------------
LM_SHAPES = {
    "train_4k": ShapeDef("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    "prefill_32k": ShapeDef("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    "decode_32k": ShapeDef("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    "long_500k": ShapeDef("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
}

# d_feat / n_classes are dataset properties of each shape's public source:
# cora (full_graph_sm), reddit (minibatch_lg), ogbn-products, synthetic molecules.
GNN_SHAPES = {
    "full_graph_sm": ShapeDef("full_graph_sm", "train", {
        "n_nodes": _pad512(2708), "n_edges": _pad512(10556),
        "d_feat": 1433, "n_classes": 7, "compressed_adjacency": True,
        "payload_stride": 128, "raw_nodes": 2708, "raw_edges": 10556,
    }),
    "minibatch_lg": ShapeDef("minibatch_lg", "train", {
        # 1024 seeds, fanout 15-10 over a Reddit-scale graph (232965 nodes,
        # 114.6M edges, d_feat 602, 41 classes); padded sampler capacities.
        "n_nodes": _pad512(1024 * (1 + 15 + 150)), "n_edges": _pad512(1024 * (15 + 150)),
        "d_feat": 602, "n_classes": 41, "compressed_adjacency": False,
        "batch_nodes": 1024, "fanout": (15, 10),
        "graph_nodes": 232965, "graph_edges": 114615892,
    }),
    "ogb_products": ShapeDef("ogb_products", "train", {
        "n_nodes": _pad512(2449029), "n_edges": _pad512(61859140),
        "d_feat": 100, "n_classes": 47, "compressed_adjacency": True,
        "payload_stride": 384, "raw_nodes": 2449029, "raw_edges": 61859140,
    }),
    "molecule": ShapeDef("molecule", "train", {
        "n_nodes": 128 * 30, "n_edges": 128 * 64, "d_feat": 16, "n_classes": 2,
        "compressed_adjacency": False, "task": "graph", "batch_graphs": 128,
    }),
}

RECSYS_SHAPES = {
    "train_batch": ShapeDef("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeDef("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeDef("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeDef("retrieval_cand", "retrieval", {
        "batch": 1, "n_candidates": 1 << 20, "payload_stride": 256,
    }),
}
