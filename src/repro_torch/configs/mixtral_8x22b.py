"""Mixtral-8x22B — MoE (8 experts, top-2), GQA (kv=8), sliding-window attn.
[arXiv:2401.04088; hf]"""
from .base import ArchConfig, MoEConfig

FULL = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    attention="sliding",
    window=4096,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    param_dtype="bfloat16",
    source="arXiv:2401.04088",
)

SMOKE = FULL.replace(
    name="mixtral-8x22b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, window=32,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.5),
    param_dtype="float32",
)
