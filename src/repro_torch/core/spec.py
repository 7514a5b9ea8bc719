"""Shared compression types — plain dataclasses, no tensor library.

``LayerSpec`` describes one compressible unit (a conv/linear or a fused
group like qkv) to the search: what can be pruned/quantized, the hardware
rounding granularity, and the cost-model inputs the latency oracle needs.

``LayerCMP`` is the *discrete* compression decision for one unit — the
output of mapping the agent's continuous actions (paper Eq. 4/8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class LayerSpec:
    name: str                  # e.g. "blocks.3.mlp.up"
    kind: str                  # conv|attn_qkv|attn_out|mlp_up|mlp_down|
                               # moe_up|moe_down|ssm_in|ssm_out|
                               # rglru_in|rglru_out|embed|head
    layer_idx: int             # block index; -1 for embed/head
    in_dim: int
    out_dim: int
    # pruning
    prunable: bool = False
    prune_dim: int = 0         # size of the prunable dim (ff / heads / ch)
    prune_granularity: int = 1 # hardware rounding multiple
    dep_group: str = ""        # non-empty => pruning follows another unit
    # quantization
    quantizable: bool = True
    mix_supported: bool = True
    # cost model (per token, at full width)
    flops_per_token: float = 0.0
    weight_elems: int = 0
    act_elems_per_token: int = 0
    extra: dict = field(default_factory=dict, hash=False, compare=False)


@dataclass
class LayerCMP:
    """Discrete compression-method parameters for one unit."""
    keep: int                  # kept channels/heads on the prunable dim
    mode: str = "FP32"         # FP32|INT8|MIX
    w_bits: int = 32
    a_bits: int = 32

    @property
    def sparsity(self) -> float:
        return 0.0


def effective_bits(cmp: "LayerCMP") -> tuple[int, int]:
    if cmp.mode == "FP32":
        return 32, 32
    if cmp.mode == "INT8":
        return 8, 8
    return cmp.w_bits, cmp.a_bits
