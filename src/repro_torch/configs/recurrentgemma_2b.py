"""RecurrentGemma-2B (Griffin) — hybrid: RG-LRU recurrent blocks + local
sliding-window attention in a (rec, rec, attn) pattern; GQA kv=1 (MQA).
[arXiv:2402.19427; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    attention="sliding",
    window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    scan_layers=False,                      # heterogeneous stack → unrolled
    source="arXiv:2402.19427",
)

SMOKE = FULL.replace(
    name="recurrentgemma-2b-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, window=16, lru_width=64,
)
