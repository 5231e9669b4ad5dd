"""Two-tower retrieval [Yi et al., RecSys'19 (YouTube)] — embed_dim 256,
tower MLP 1024-512-256, dot-product interaction. Id embeddings 128-wide
over 2^23 users / 2^23 items. Serving scores a VByte-compressed
1M-candidate list (``configs.shapes.RECSYS_SHAPES["retrieval_cand"]``).
"""
from repro_torch.models.recsys import RecSysConfig

CONFIG = RecSysConfig(
    name="two-tower-retrieval",
    kind="two_tower",
    n_items=1 << 23,
    n_users=1 << 23,
    embed_dim=256,
    id_dim=128,
    seq_len=50,
    mlp_dims=(1024, 512, 256),
    serve_candidates=4096,
)

FAMILY = "recsys"

SKIPS = {}
