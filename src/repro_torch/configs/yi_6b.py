"""Yi-6B [arXiv:2403.04652; hf 01-ai/Yi-6B].

32L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000, RoPE theta
5e6. Pure full attention → long_500k skipped (DESIGN.md §5).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    microbatch=8,
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5e6,
)

FAMILY = "lm"
SKIPS = {"long_500k": "pure full attention — no sub-quadratic path (spec: skip)"}
