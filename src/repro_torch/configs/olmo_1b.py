"""OLMo-1B — dense, MHA (kv=16), non-parametric LayerNorm, no biases.
[arXiv:2402.00838; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50_304,
    mlp="swiglu",
    norm="nonparametric_ln",
    tie_embeddings=True,
    source="arXiv:2402.00838",
)

SMOKE = FULL.replace(
    name="olmo-1b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
)
