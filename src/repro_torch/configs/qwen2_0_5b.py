"""Qwen2-0.5B — dense, GQA (kv=2), QKV bias, tied embeddings.
[arXiv:2407.10671; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2407.10671",
)

SMOKE = FULL.replace(
    name="qwen2-0.5b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)
