"""SASRec [arXiv:1808.09781] — embed_dim 50, 2 blocks, 1 head, seq 50,
causal self-attention, next-item binary CE with sampled negatives.
Item vocabulary scaled to 2^20 rows (taxonomy §B.6 huge-table regime);
histories are VByte posting lists in the data pipeline.
"""
from repro_torch.models.recsys import RecSysConfig

CONFIG = RecSysConfig(
    name="sasrec",
    kind="sasrec",
    n_items=1 << 20,
    embed_dim=50,
    seq_len=50,
    n_blocks=2,
    n_heads=1,
    serve_candidates=1024,
)

FAMILY = "recsys"

SKIPS = {}
