"""HuBERT-XLarge — audio encoder-only transformer (wav2vec2 arch); the CNN
feature extractor is a STUB (``input_specs`` provides frame embeddings).
[arXiv:2106.07447; unverified]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    attention="bidir",
    mlp="gelu",
    norm="layernorm",
    is_encoder=True,
    frontend="audio_stub",
    param_dtype="bfloat16",
    source="arXiv:2106.07447",
)

SMOKE = FULL.replace(
    name="hubert-xlarge-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64, param_dtype="float32",
)
