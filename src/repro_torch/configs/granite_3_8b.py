"""Granite-3-8B — dense, GQA (kv=8).
[hf:ibm-granite/granite-3.0 family; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12_800,
    vocab_size=49_155,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    param_dtype="bfloat16",
    source="hf:ibm-granite/granite-3.0-2b-base",
)

SMOKE = FULL.replace(
    name="granite-3-8b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, param_dtype="float32",
)
