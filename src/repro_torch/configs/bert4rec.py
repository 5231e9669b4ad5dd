"""BERT4Rec [arXiv:1904.06690] — embed_dim 64, 2 blocks, 2 heads, seq 200,
bidirectional encoder, masked-item prediction (15% → 30 positions) with
shared sampled negatives (encoder-only: its shape set has no decode step).
"""
from repro_torch.models.recsys import RecSysConfig

CONFIG = RecSysConfig(
    name="bert4rec",
    kind="bert4rec",
    n_items=1 << 20,
    embed_dim=64,
    seq_len=200,
    n_blocks=2,
    n_heads=2,
    n_mask=30,
    n_negatives=1024,
    serve_candidates=1024,
)

FAMILY = "recsys"

SKIPS = {}
