"""InternVL2-2B — VLM; InternLM2-1.8B language backbone, InternViT frontend
as a STUB (``input_specs`` provides precomputed patch embeddings).
[arXiv:2404.16821; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    mlp="swiglu",
    norm="rmsnorm",
    frontend="vision_stub",
    frontend_len=256,                      # ViT patch tokens prepended
    source="arXiv:2404.16821",
)

SMOKE = FULL.replace(
    name="internvl2-2b-smoke",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, frontend_len=8,
)
