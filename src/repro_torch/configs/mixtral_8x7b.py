"""Mixtral-8x7B [arXiv:2401.04088; hf mistralai/Mixtral-8x7B-v0.1].

32L, d_model 4096, 32 heads (GQA kv=8), per-expert d_ff 14336, vocab 32000,
8 experts top-2, sliding-window attention (window 4096, rolling-buffer KV
cache) → long_500k runs. 8 experts < 16 TP shards → tensor-parallel inside
experts (d_ff sharded), experts replicated across the model axis.
"""
from repro_torch.models.lm import LMConfig, MoESettings

CONFIG = LMConfig(
    microbatch=8,
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,  # unused (MoE)
    vocab=32000,
    rope_theta=1e6,
    window=4096,
    moe=MoESettings(n_experts=8, top_k=2, d_ff=14336, ep_shard=False),
)

FAMILY = "lm"
SKIPS = {}
