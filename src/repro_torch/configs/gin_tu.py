"""GIN [arXiv:1810.00826] — 5 layers, d_hidden 64, sum aggregator,
learnable ε.

d_feat / n_classes / adjacency mode vary per shape (cora, reddit-scale
sampled, ogbn-products, batched molecules) and are resolved by
``models.registry.resolve_config``. Adjacency for the full-graph shapes
is VByte-compressed.
"""
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu",
    n_layers=5,
    d_hidden=64,
)

FAMILY = "gnn"
