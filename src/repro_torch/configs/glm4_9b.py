"""GLM4-9B [hf THUDM/glm-4-9b].

40L, d_model 4096, 32 heads (GQA kv=2), d_ff 13696, vocab 151552, RoPE with
partial rotary (half the head dims). Pure full attention → long_500k skipped.
Simplification noted in DESIGN.md: GLM4's post-attention residual config is
mapped onto the shared pre-norm block (same FLOP/byte profile).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    microbatch=8,
    name="glm4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    rope_theta=10000.0,
    rotary_fraction=0.5,
)

FAMILY = "lm"
SKIPS = {"long_500k": "pure full attention — no sub-quadratic path (spec: skip)"}
