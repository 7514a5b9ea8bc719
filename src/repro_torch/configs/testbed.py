"""The LM testbed of the Galen search: the JAX package's ``LM_CFG`` and
``SERVE_CTX`` (``benchmarks/common.py``), copied so the port's entry
points need nothing of that package.

4 layers, d_model 256, 8 heads / 4 KV heads of 32, d_ff 1024, vocab 256,
bf16 compute: every unit is 256-aligned, so the MIX (int4) option is legal
everywhere and the paper's full action space is reachable. The oracle's
context is single-stream decode at a 512-token context (batch 1).
"""
from __future__ import annotations

from ..core.latency import LatencyContext
from .base import ArchConfig

LM_CFG = ArchConfig(name="testbed-lm", num_layers=4, d_model=256,
                    num_heads=8, num_kv_heads=4, head_dim=32, d_ff=1024,
                    vocab_size=256, scan_layers=True)

SERVE_CTX = LatencyContext(tokens=1, seq_ctx=512, mode="decode", batch=1)

# The JAX trainer's validation batch: 64 sequences of 48 tokens.
VAL_BATCH, VAL_SEQ = 64, 48
