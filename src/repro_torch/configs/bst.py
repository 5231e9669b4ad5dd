"""BST — Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874].

embed_dim 32, seq 20 (+ target item), 1 block, 8 heads, MLP 1024-512-256 →
CTR logit. Item vocabulary 2^23 rows. retrieval_cand runs the full ranker
per candidate (pointwise CTR scoring).
"""
from repro_torch.models.recsys import RecSysConfig

CONFIG = RecSysConfig(
    name="bst",
    kind="bst",
    n_items=1 << 23,
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp_dims=(1024, 512, 256),
    serve_candidates=1024,
)

FAMILY = "recsys"

SKIPS = {}
