"""Decoder LM of every family the JAX package runs (dense attention, MoE,
Mamba-2 (SSM), the RG-LRU hybrid (Griffin)) and its two stub frontends
(an audio encoder fed frame embeddings, a VLM whose first positions are
patch embeddings): ``init``, ``forward`` (train / prefill), ``init_cache``
and ``decode_step`` (one new token against a KV, SSM or RG-LRU cache;
an encoder has none), and ``param_count``. Each layer dispatches on its
kind (``cfg.layer_kinds[i]``); an attention layer carries an MLP or,
where the config has ``moe``, the MoE block.

The JAX package stacks homogeneous layers on a leading axis and scans over
them; here ``params["blocks"]``, ``cspec["blocks"]`` and the cache are
lists with one entry per layer, and each pass is a Python loop.

A batched cspec (``cspec["slots"]`` = K policies, bits as K-tuples or
[K] int32 device tensors; what the JAX package gets from ``vmap`` over
stacked cspecs) runs the K policies in one forward: the policies' rows are folded into the batch axis, each slot
gathers its tokens from its own quantized embedding table, and
``forward`` returns [K, B, S, V].
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from . import blocks as B
from . import layers as L


# ---------------------------------------------------------------------------
# Per-kind block init / apply / cache / decode dispatch
# ---------------------------------------------------------------------------

def _init_block(kind: str, gen: torch.Generator, cfg: ArchConfig, dtype,
                device) -> dict:
    if kind == "attn":
        return {"attn_norm": L.norm_init(cfg.norm, cfg.d_model, dtype,
                                         device),
                "attn": B.init_attention(gen, cfg, dtype, device),
                "mlp_norm": L.norm_init(cfg.norm, cfg.d_model, dtype,
                                        device),
                **({"moe": B.init_moe(gen, cfg, dtype, device)}
                   if cfg.moe is not None
                   else {"mlp": B.init_mlp(gen, cfg, dtype, device)})}
    if kind == "ssm":
        return {"norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device),
                "ssm": B.init_ssm(gen, cfg, dtype, device)}
    if kind == "rglru":
        return {"mix_norm": L.norm_init(cfg.norm, cfg.d_model, dtype,
                                        device),
                "rglru": B.init_rglru(gen, cfg, dtype, device),
                "mlp_norm": L.norm_init(cfg.norm, cfg.d_model, dtype,
                                        device),
                "mlp": B.init_mlp(gen, cfg, dtype, device)}
    raise ValueError(kind)


def _ffn(p, h, cfg: ArchConfig, cs: dict):
    """An attention layer's feed-forward half: the MoE block or the MLP."""
    if "moe" in p:
        return B.apply_moe(p["moe"], h, cfg, cs.get("moe"))
    return B.apply_mlp(p["mlp"], h, cfg, cs.get("mlp"))


def _apply_block(kind: str, p, x, cfg: ArchConfig, cspec, positions):
    cs = cspec or {}
    if kind == "attn":
        h = L.apply_norm(cfg.norm, p["attn_norm"], x)
        x = x + B.apply_attention(p["attn"], h, cfg, cs.get("attn"),
                                  positions)
        h = L.apply_norm(cfg.norm, p["mlp_norm"], x)
        return x + _ffn(p, h, cfg, cs)
    if kind == "ssm":
        h = L.apply_norm(cfg.norm, p["norm"], x)
        return x + B.apply_ssm(p["ssm"], h, cfg, cs.get("ssm"))
    if kind == "rglru":
        h = L.apply_norm(cfg.norm, p["mix_norm"], x)
        x = x + B.apply_rglru(p["rglru"], h, cfg, cs.get("rglru"))
        h = L.apply_norm(cfg.norm, p["mlp_norm"], x)
        return x + B.apply_mlp(p["mlp"], h, cfg, cs.get("mlp"))
    raise ValueError(kind)


def _init_block_cache(kind: str, cfg: ArchConfig, batch: int, max_len: int,
                      dtype, device, cache_bits: int = 16) -> dict:
    """``cache_bits`` sets the KV cache's storage; an SSM's or an RG-LRU's
    conv window and state ignore it, as in the JAX package."""
    if kind == "attn":
        return B.init_attn_cache(cfg, batch, max_len, dtype, device,
                                 cache_bits)
    if kind == "ssm":
        return B.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return B.init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def _decode_block(kind: str, p, x, cache, pos: int, cfg: ArchConfig,
                  cspec):
    cs = cspec or {}
    if kind == "attn":
        h = L.apply_norm(cfg.norm, p["attn_norm"], x)
        x = x + B.decode_attention_block(p["attn"], h, cache, pos, cfg,
                                         cs.get("attn"))
        h = L.apply_norm(cfg.norm, p["mlp_norm"], x)
        return x + _ffn(p, h, cfg, cs)
    if kind == "ssm":
        h = L.apply_norm(cfg.norm, p["norm"], x)
        return x + B.decode_ssm(p["ssm"], h, cache, pos, cfg, cs.get("ssm"))
    if kind == "rglru":
        h = L.apply_norm(cfg.norm, p["mix_norm"], x)
        x = x + B.decode_rglru(p["rglru"], h, cache, pos, cfg,
                               cs.get("rglru"))
        h = L.apply_norm(cfg.norm, p["mlp_norm"], x)
        return x + B.apply_mlp(p["mlp"], h, cfg, cs.get("mlp"))
    raise ValueError(kind)


def init(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded random weights from the port's own ``torch.Generator`` (a
    different stream from the JAX package's keys: to hold the two against
    each other, carry the JAX weights over with ``repro_torch.convert``).
    An audio-frontend config has no ``embed`` (its inputs are frame
    embeddings)."""
    dtype = L.dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict[str, Any] = {}
    if cfg.frontend != "audio_stub":
        params["embed"] = (torch.randn((cfg.vocab_size, cfg.d_model),
                                       generator=gen, device=device)
                           / (cfg.d_model ** 0.5)).to(dtype)
    params["blocks"] = [_init_block(kind, gen, cfg, dtype, device)
                        for kind in cfg.layer_kinds]
    params["final_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["unembed"] = L.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                          dtype, device)["w"]
    return params


def param_count(params) -> int:
    """Elements over every leaf of a param tree (dicts and lists)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()


def device_of(params) -> torch.device:
    """The device of a param tree: that of its first tensor (weight
    containers included; an audio-frontend model has no ``embed``)."""
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        for v in params:
            d = device_of(v)
            if d is not None:
                return d
        return None
    return params.device if isinstance(params, torch.Tensor) else None


def _embed_inputs(cfg: ArchConfig, params, tokens, cspec,
                  embeds=None) -> torch.Tensor:
    """The first layer's input: an audio frontend's frame embeddings
    [B, S, d] as they come; else the token embeddings in the compute
    dtype, with a vision frontend's ``embeds`` [B, P, d] over the first
    P positions. Under a batched cspec of K policies each slot gathers
    from its own quantized table and the frontend's embeddings repeat
    for every slot ([K·B, S, d])."""
    K = None if cspec is None else cspec.get("slots")
    if cfg.frontend == "audio_stub":
        if K:
            return embeds.expand(K, *embeds.shape).reshape(
                -1, *embeds.shape[1:])
        return embeds
    compute = L.dtype_of(cfg.compute_dtype)
    table = L.getw(params, "embed", compute)
    ebits = None if cspec is None else cspec.get("embed_bits")
    if K:
        # [K, V, d] tables (a view of the one table where no slot
        # quantizes it); slot k's rows are the k-th block of the batch
        tables = table.expand(K, *table.shape) if ebits is None \
            else L.fake_quant_weight_slots(table, ebits)
        x = tables[:, tokens].to(compute)
    else:
        if ebits is not None:
            table = L.fake_quant_weight(table, ebits)
        x = table[tokens].to(compute)[None]
    if cfg.frontend == "vision_stub" and embeds is not None:
        P = embeds.shape[1]
        x = torch.cat([embeds.to(x.dtype).expand(x.shape[0], *embeds.shape),
                       x[:, :, P:]], 2)
    return x.reshape(-1, *x.shape[2:])


def _unembed(cfg: ArchConfig, params, x, cspec) -> torch.Tensor:
    w = L.getw(params, "embed", x.dtype).T if cfg.tie_embeddings \
        else L.getw(params, "unembed", x.dtype)
    hbits = None if cspec is None else cspec.get("head_bits")
    K = None if cspec is None else cspec.get("slots")
    if K:
        # the tied transpose is copied once (ops.fake_quant_slots), not
        # once per slot
        ws = w.expand(K, *w.shape) if hbits is None \
            else L.fake_quant_weight_slots(w, hbits)
        xs = x.reshape(K, -1, x.shape[-1])
        return L.product_slots(xs, ws, x.dtype).float().reshape(
            K, -1, *x.shape[1:-1], w.shape[-1])
    if hbits is not None:
        w = L.fake_quant_weight(w, hbits)
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype)).float()


def forward(cfg: ArchConfig, params, tokens=None, cspec=None,
            positions=None, embeds=None) -> torch.Tensor:
    """tokens [B, S] int64 (and/or a frontend's ``embeds``: [B, S, d]
    frames for an audio encoder, [B, P, d] patches over the first P
    positions for a VLM) -> logits [B, S, vocab] (f32); [K, B, S, vocab]
    for a batched cspec of K policies."""
    x = _embed_inputs(cfg, params, tokens, cspec, embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    blocks_cs = None if cspec is None else cspec.get("blocks")
    for i, p_l in enumerate(params["blocks"]):
        x = _apply_block(cfg.layer_kinds[i], p_l, x, cfg,
                         None if blocks_cs is None else blocks_cs[i],
                         positions)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(cfg, params, x, cspec)


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def _check_decoder(cfg: ArchConfig) -> None:
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name}: an encoder-only arch has no decode "
                         f"step")


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               cache_bits: int = 16, device="cuda") -> list:
    """One cache dict per layer: an attention layer's K/V in the compute
    dtype (int8 codes and scales with ``cache_bits=8``; a ring of
    ``window`` slots for a sliding-window layer), an SSM or RG-LRU layer's
    conv window and f32 state. An encoder has none (ValueError)."""
    _check_decoder(cfg)
    dtype = dtype or L.dtype_of(cfg.compute_dtype)
    return [_init_block_cache(kind, cfg, batch, max_len, dtype, device,
                              cache_bits) for kind in cfg.layer_kinds]


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int,
                cspec=None, embeds=None):
    """tokens: [B, 1]; pos: the position of these tokens (a host int).
    Returns (logits [B, 1, V] f32, cache); the cache is updated in
    place. ``embeds`` as ``forward`` takes them (a VLM's patches cover
    the prompt, so decode passes none)."""
    _check_decoder(cfg)
    x = _embed_inputs(cfg, params, tokens, cspec, embeds)
    blocks_cs = None if cspec is None else cspec.get("blocks")
    for i, (p_l, c_l) in enumerate(zip(params["blocks"], cache)):
        x = _decode_block(cfg.layer_kinds[i], p_l, x, c_l, pos, cfg,
                          None if blocks_cs is None else blocks_cs[i])
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    return _unembed(cfg, params, x, cspec), cache
