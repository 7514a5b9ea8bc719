"""Mamba2-780M — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from .base import ArchConfig, SSMConfig

FULL = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                                 # attn-free; mixing is the SSM block
    vocab_size=50_280,
    attention="none",
    block_pattern=("ssm",),
    mlp="none",
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)

SMOKE = FULL.replace(
    name="mamba2-780m-smoke",
    num_layers=2, d_model=64, vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                  chunk_size=32),
)
