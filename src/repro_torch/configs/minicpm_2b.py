"""MiniCPM-2B — dense llama-like, MHA (kv=36), WSD learning-rate schedule.
[arXiv:2404.06395; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2404.06395",
)

# Trainer default for this arch: WSD (warmup-stable-decay) schedule — see
# repro/optim/optimizer.py::wsd_schedule.
SMOKE = FULL.replace(
    name="minicpm-2b-smoke",
    num_layers=2, d_model=72, num_heads=6, num_kv_heads=6, head_dim=12,
    d_ff=144, vocab_size=256,
)
