"""Residual sub-blocks of the dense family: attention and the MLP.

Compression hooks: ``cspec`` — a dict of quant specs
(``{"w_bits","a_bits"}``, host ints) and float 0/1 pruning masks; ``None``
means uncompressed. The MoE, SSM and RG-LRU blocks and decode wait for
later slices.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import layers as L


def _get(cspec, key):
    return None if cspec is None else cspec.get(key)


# ===========================================================================
# Attention sub-block
# ===========================================================================

def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    H, KV, D, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": L.linear_init(gen, d, H * D, dtype, device, bias=cfg.qkv_bias),
        "wk": L.linear_init(gen, d, KV * D, dtype, device, bias=cfg.qkv_bias),
        "wv": L.linear_init(gen, d, KV * D, dtype, device, bias=cfg.qkv_bias),
        "wo": L.linear_init(gen, H * D, d, dtype, device),
    }


def _qkv(p, x, cfg: ArchConfig, cspec):
    B, S, _ = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qs = _get(cspec, "qkv")
    q = L.linear(p["wq"], x, qs).reshape(B, S, H, D)
    k = L.linear(p["wk"], x, qs).reshape(B, S, KV, D)
    v = L.linear(p["wv"], x, qs).reshape(B, S, KV, D)
    return q, k, v


def apply_attention(p, x, cfg: ArchConfig, cspec=None, positions=None):
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, cspec)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    causal = not cfg.is_encoder
    window = cfg.window if cfg.attention == "sliding" else 0
    o = L.attention(q, k, v, causal=causal, window=window,
                    head_mask=_get(cspec, "head_mask"))
    o = o.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return L.linear(p["wo"], o, _get(cspec, "o"))


# ===========================================================================
# Dense MLP
# ===========================================================================

def init_mlp(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_up": L.linear_init(gen, d, ff, dtype, device),
         "w_down": L.linear_init(gen, ff, d, dtype, device)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = L.linear_init(gen, d, ff, dtype, device)
    return p


def apply_mlp(p, x, cfg: ArchConfig, cspec=None):
    qs_up, qs_down = _get(cspec, "up"), _get(cspec, "down")
    ff_mask = _get(cspec, "ff_mask")
    up = L.linear(p["w_up"], x, qs_up)
    gate = L.linear(p["w_gate"], x, qs_up) if "w_gate" in p else up
    h = L.mlp_act(cfg.mlp, gate, up)
    if ff_mask is not None:
        h = h * ff_mask.to(h.dtype)
    return L.linear(p["w_down"], h, qs_down)
