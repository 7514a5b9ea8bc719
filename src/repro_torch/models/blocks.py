"""Residual sub-blocks of the dense family: attention (full sequence, and
single-token decode against a KV cache) and the MLP.

Compression hooks: ``cspec`` — a dict of quant specs
(``{"w_bits","a_bits"}``, host ints) and float 0/1 pruning masks; ``None``
means uncompressed. The MoE, SSM and RG-LRU blocks wait for the model-zoo
slice; ``ssm_dims`` (shape arithmetic only) is here for the layer specs.
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


def _qkv_rope(p, x, cfg: ArchConfig, cspec, positions):
    """q [B,S,H,D], k, v [B,S,KV,D] as the attention receives them: the
    projections, then RoPE on q and k at ``positions`` [B or 1, S]."""
    B, S, _ = x.shape
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qs = _get(cspec, "qkv")
    q = L.linear(p["wq"], x, qs).reshape(B, S, H, D)
    k = L.linear(p["wk"], x, qs).reshape(B, S, KV, D)
    v = L.linear(p["wv"], x, qs).reshape(B, S, KV, D)
    return (L.rope(q, positions, cfg.rope_theta),
            L.rope(k, positions, cfg.rope_theta), v)


def apply_attention(p, x, cfg: ArchConfig, cspec=None, positions=None):
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv_rope(p, x, cfg, cspec, positions)
    causal = not cfg.is_encoder
    window = cfg.window if cfg.attention == "sliding" else 0
    o = L.attention(q, k, v, causal=causal, window=window,
                    head_mask=_get(cspec, "head_mask"))
    o = o.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return L.linear(p["wo"], o, _get(cspec, "o"))


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                    device, cache_bits: int = 16) -> dict:
    """cache_bits=8 stores K/V as int8 with per-(token, head) f32 scales;
    a sliding-window config keeps a ring of ``min(max_len, window)``
    slots."""
    W = min(max_len, cfg.window) if cfg.attention == "sliding" else max_len
    KV, D = cfg.num_kv_heads, cfg.head_dim
    if cache_bits <= 8:
        return {
            "k": torch.zeros((batch, W, KV, D), dtype=torch.int8,
                             device=device),
            "v": torch.zeros((batch, W, KV, D), dtype=torch.int8,
                             device=device),
            "k_s": torch.zeros((batch, W, KV), device=device),
            "v_s": torch.zeros((batch, W, KV), device=device),
        }
    return {"k": torch.zeros((batch, W, KV, D), dtype=dtype, device=device),
            "v": torch.zeros((batch, W, KV, D), dtype=dtype, device=device)}


def _cache_write(cache, name, val, slot: int) -> None:
    """Write val [B,1,KV,D] into slot ``slot`` of the cache, in place (the
    JAX package returns a new buffer from dynamic_update_slice), as int8
    codes with a per-(token, head) scale max|val| / 127 if the cache is
    int8. Both quotients divide a tensor by a tensor: ``tensor / float``
    multiplies by the reciprocal on the card."""
    buf = cache[name]
    if buf.dtype == torch.int8:
        vf = val.float()
        amax = vf.abs().amax(-1)                             # [B,1,KV]
        scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-8)
        q = torch.clamp(torch.round(vf / scale[..., None]), -128, 127)
        buf[:, slot:slot + 1] = q.to(torch.int8)
        cache[name + "_s"][:, slot:slot + 1] = scale
    else:
        buf[:, slot:slot + 1] = val.to(buf.dtype)


def _cache_read(cache, name, dtype):
    buf = cache[name]
    if buf.dtype == torch.int8:
        return (buf.float() * cache[name + "_s"][..., None]).to(dtype)
    return buf


def decode_attention_block(p, x, cache, pos: int, cfg: ArchConfig,
                           cspec=None):
    """x: [B,1,d]; pos: the current position (a host int). Writes this
    token's K/V into ``cache`` in place (the JAX package returns a new
    cache) and returns the block's output."""
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv_rope(p, x, cfg, cspec,
                        torch.full((B, 1), pos, device=x.device))
    W = cache["k"].shape[1]
    ring = cfg.attention == "sliding"
    slot = pos % W if ring else pos
    if slot >= W:
        raise ValueError(f"position {pos} is past the cache's {W} slots")
    _cache_write(cache, "k", k, slot)
    _cache_write(cache, "v", v, slot)
    o = L.decode_attention(q, _cache_read(cache, "k", x.dtype),
                           _cache_read(cache, "v", x.dtype), pos + 1,
                           window=cfg.window if ring else 0, ring=ring,
                           head_mask=_get(cspec, "head_mask"))
    return L.linear(p["wo"], o.reshape(B, 1, H * D), _get(cspec, "o"))


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


def ssm_dims(cfg: ArchConfig):
    """(d_inner, SSD heads, conv width) of an SSM config."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, nheads, conv_dim
