"""Snowflake Arctic-480B — MoE (128 experts, top-2) + dense residual FFN,
GQA (kv=8). [hf:Snowflake/snowflake-arctic-base; hf]"""
from .base import ArchConfig, MoEConfig

FULL = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(num_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual=True),
    param_dtype="bfloat16",
    source="hf:Snowflake/snowflake-arctic-base",
)

SMOKE = FULL.replace(
    name="arctic-480b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=1.5,
                  dense_residual=True),
    param_dtype="float32",
)
