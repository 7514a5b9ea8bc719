"""Useful-FLOPs counts of a step (the JAX package's
``launch/inputs.py::model_flops`` and its per-token helpers): the
6·N·D-style denominator of an MFU. The abstract input specs of that
module build JAX shape structs and have no counterpart here."""
from __future__ import annotations

from ..configs.base import ArchConfig, ShapeConfig
from ..core.compress import lm_layer_specs


def _fwd_flops_per_token(cfg: ArchConfig, ctx_len: int) -> float:
    total = 0.0
    for s in lm_layer_specs(cfg):
        total += s.flops_per_token
        if s.kind == "attn_qkv":
            S_eff = min(ctx_len, cfg.window) if cfg.attention == "sliding" \
                else ctx_len
            causal_frac = 0.5 if not cfg.is_encoder else 1.0
            total += 4.0 * S_eff * s.extra["head_dim"] * cfg.num_heads \
                * causal_frac
        elif s.kind == "ssm_in" and cfg.ssm:
            total += 6.0 * cfg.ssm.d_state * (cfg.ssm.expand * cfg.d_model)
    return total


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs per step: 6·N·D-style (3x forward for train)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        return 3.0 * _fwd_flops_per_token(cfg, S) * B * S
    if shape.mode == "prefill":
        return _fwd_flops_per_token(cfg, S) * B * S
    # decode: 1 token per sequence, full context attention
    return _fwd_flops_per_token_decode(cfg, S) * B


def _fwd_flops_per_token_decode(cfg: ArchConfig, ctx_len: int) -> float:
    total = 0.0
    for s in lm_layer_specs(cfg):
        total += s.flops_per_token
        if s.kind == "attn_qkv":
            S_eff = min(ctx_len, cfg.window) if cfg.attention == "sliding" \
                else ctx_len
            total += 4.0 * S_eff * s.extra["head_dim"] * cfg.num_heads
        elif s.kind == "ssm_in" and cfg.ssm:
            total += 6.0 * cfg.ssm.d_state * (cfg.ssm.expand * cfg.d_model)
    return total
