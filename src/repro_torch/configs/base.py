"""Configuration system (a copy of the JAX package's ``configs/base.py``,
kept here so the port imports nothing of that package).

Two config kinds:
  * ``ArchConfig``  — a model architecture (one per assigned arch).
  * ``ShapeConfig`` — an input-shape cell (train_4k / prefill_32k / ...).

Configs are frozen dataclasses so they hash and can key caches.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False          # Arctic-style parallel dense FFN
    router_dtype: str = "float32"
    combine: str = "allreduce"            # allreduce | reduce_scatter (§Perf)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64                    # SSD head dim (P)
    expand: int = 2                       # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256                 # SSD chunked-scan block length


@dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture. Fields default to a dense decoder LM."""
    name: str = "dense"
    family: str = "dense"                 # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # --- attention / mixing ---
    attention: str = "causal"             # causal|bidir|sliding|none
    window: int = 4096                    # for attention == "sliding" / local layers
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # hybrid block pattern, tiled to num_layers; entries: "attn"|"rglru"|"ssm"
    block_pattern: Tuple[str, ...] = ("attn",)
    lru_width: int = 0                    # RG-LRU width (0 => d_model)

    # --- ffn ---
    mlp: str = "swiglu"                   # swiglu|geglu|gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # --- embeddings / norms ---
    norm: str = "rmsnorm"                 # rmsnorm|layernorm|nonparametric_ln
    tie_embeddings: bool = False
    frontend: str = "none"                # none|vision_stub|audio_stub
    frontend_len: int = 0                 # prefix positions fed by the stub
    is_encoder: bool = False              # encoder-only (no causal mask, no decode)

    # --- numerics / compile ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True              # lax.scan over a homogeneous stack
    remat: str = "none"                   # none|full|dots_saveable

    # --- bookkeeping ---
    source: str = ""                      # citation tag

    def __post_init__(self):
        if self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixing kind, block_pattern tiled to num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def homogeneous(self) -> bool:
        return len(set(self.layer_kinds)) == 1

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer does full-length quadratic attention."""
        if self.attention == "sliding":
            return True
        kinds = set(self.layer_kinds)
        if "attn" in kinds and self.attention in ("causal", "bidir"):
            return False
        return True

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                             # train|prefill|decode
    # decode: one new token against a KV cache of ``seq_len``.


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; reason if skipped."""
    if arch.is_encoder and shape.mode == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return True, ""
