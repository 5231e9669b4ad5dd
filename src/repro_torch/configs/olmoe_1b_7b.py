"""OLMoE-1B-7B [arXiv:2409.02060; hf allenai/OLMoE-1B-7B-0924].

16L, d_model 2048, 16 heads (GQA kv=16 — i.e. MHA), per-expert d_ff 1024,
vocab 50304, 64 experts top-8. Full attention → long_500k skipped
(DESIGN.md §5). Expert-parallel: 64 experts % 16 TP shards == 0.
"""
from repro_torch.models.lm import LMConfig, MoESettings

CONFIG = LMConfig(
    microbatch=4,
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # unused (MoE)
    vocab=50304,
    rope_theta=10000.0,
    moe=MoESettings(n_experts=64, top_k=8, d_ff=1024, ep_shard=True),
)

FAMILY = "lm"
SKIPS = {"long_500k": "pure full attention — no sub-quadratic path (spec: skip)"}
