"""H2O-Danube-1.8B [arXiv:2401.16818; hf h2oai/h2o-danube-1.8b-base].

24L, d_model 2560, 32 heads (GQA kv=8), d_ff 6912, vocab 32000.
Llama+Mistral mix: sliding-window attention (4096) → long_500k runs.
head_dim = 2560/32 = 80.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    microbatch=4,
    name="h2o-danube-1.8b",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    rope_theta=10000.0,
    window=4096,
)

FAMILY = "lm"
SKIPS = {}
