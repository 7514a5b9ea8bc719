"""Residual sub-blocks: attention (full sequence, and single-token decode
against a KV cache), the MLP, the MoE block (top-k routed experts with a
capacity dispatch, and Arctic's dense residual), the Mamba-2 (SSD) block
and the RG-LRU (Griffin) recurrent block (each full sequence, and
single-token decode against its conv and state cache).

Compression hooks: ``cspec`` — a dict of quant specs
(``{"w_bits","a_bits"}``, host ints) and float 0/1 pruning masks; ``None``
means uncompressed. A batched cspec (K policies: bits as K-tuples, masks
[K, n], the policies' rows folded into the batch axis) takes the same
paths: ``layers.project`` and ``layers.apply_mask`` take either form.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.quantization import (fake_quant_act, fake_quant_act_slots,
                                 fake_quant_weight, fake_quant_weight_slots,
                                 slotted)
from ..kernels import ops, ref
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
    return L.linear(p["w_down"], L.apply_mask(h, ff_mask), qs_down)


# ===========================================================================
# MoE (top-k, capacity dispatch; optional Arctic dense residual)
# ===========================================================================

def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    """The router [d, E] (f32 whatever the param dtype), the expert stacks
    ``w_up`` / ``w_gate`` [E, d, ff] and ``w_down`` [E, ff, d] as raw
    arrays, and, for a dense residual (Arctic), ``dense_w_*`` raw [d, ff]
    / [ff, d]. Each stack is drawn in f32 and scaled in place before its
    cast, so a full-width stack costs one f32 copy at a time."""
    m = cfg.moe
    d, ff, E = cfg.d_model, cfg.d_ff, m.num_experts

    def draw(shape, std):
        return torch.randn(shape, generator=gen, device=device).mul_(std)

    p = {"router": draw((d, E), 1.0 / math.sqrt(d)),
         "w_up": draw((E, d, ff), 1.0 / math.sqrt(d)).to(dtype),
         "w_gate": draw((E, d, ff), 1.0 / math.sqrt(d)).to(dtype),
         "w_down": draw((E, ff, d), 1.0 / math.sqrt(ff)).to(dtype)}
    if m.dense_residual:
        p["dense_w_up"] = L.linear_init(gen, d, ff, dtype, device)["w"]
        p["dense_w_gate"] = L.linear_init(gen, d, ff, dtype, device)["w"]
        p["dense_w_down"] = L.linear_init(gen, ff, d, dtype, device)["w"]
    return p


def moe_capacity(Tg: int, E: int, K: int, capacity_factor: float) -> int:
    """Slots per expert for a group of Tg tokens: all of them where Tg·E
    <= 4096 (decode, small batches: nothing drops), else K·Tg/E times
    the capacity factor, rounded up to a multiple of 4 (at least 4)."""
    if Tg * E <= 4096:
        return Tg
    cap = int(math.ceil(K * Tg / E * capacity_factor))
    return max(4, -(-cap // 4) * 4)


def moe_dispatch(gates: torch.Tensor, E: int, K: int, capacity: int):
    """Grouped dispatch. gates [G, Tg, E] softmax probs -> (dispatch
    [G, E, C] token index per expert slot, Tg = the pad row where a slot
    is empty; gate values [G, Tg, K] renormalised over the K chosen;
    slot [G, Tg, K] flat index e·C + position of each choice, E·C where
    it dropped; keep [G, Tg, K]). Positions count each expert's earlier
    choices in token-major, k-minor order (flat index t·K + k), within
    the group; a choice at position >= C drops."""
    G, Tg, _ = gates.shape
    gate_vals, expert_idx = torch.topk(gates, K, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    e_flat = expert_idx.reshape(G, Tg * K)
    onehot = F.one_hot(e_flat, E)                           # [G, Tg*K, E]
    pos = ((torch.cumsum(onehot, 1) - onehot) * onehot).sum(-1)
    keep = pos < capacity
    pos_c = torch.where(keep, pos, torch.full_like(pos, capacity))
    tok = (torch.arange(Tg * K, device=gates.device) // K).expand(G, -1)
    gi = torch.arange(G, device=gates.device)[:, None].expand(-1, Tg * K)
    dispatch = torch.full((G, E, capacity + 1), Tg, dtype=torch.int64,
                          device=gates.device)
    # only the overflow column (dropped below) takes repeated writes
    dispatch[gi, e_flat, pos_c] = tok
    slot = torch.where(keep, e_flat * capacity + pos,
                       torch.full_like(pos, E * capacity))
    return (dispatch[:, :, :capacity], gate_vals, slot.reshape(G, Tg, K),
            keep.reshape(G, Tg, K))


def moe_route(p, xt: torch.Tensor, cfg: ArchConfig):
    """Route the token groups xt [G, Tg, d]: the router in f32, softmax,
    then ``moe_dispatch`` at ``moe_capacity(Tg, ...)`` slots per expert;
    returns its (dispatch, gate values, slot, keep)."""
    m = cfg.moe
    gates = torch.softmax(torch.matmul(xt.float(), p["router"].float()), -1)
    return moe_dispatch(gates, m.num_experts, m.top_k, moe_capacity(
        xt.shape[1], m.num_experts, m.top_k, m.capacity_factor))


def dispatch_groups(T: int, E: int, groups: int = 1) -> int:
    """Dispatch groups for T tokens: ``groups`` (a data-parallel axis's
    size), halved while the group's tokens would not divide evenly or
    would number fewer than 4·E. On one device ``groups`` is 1, as the
    JAX package has it without a mesh; the argument waits for a
    sharding slice."""
    G = groups
    while G > 1 and (T % G != 0 or T // G < 4 * E):
        G //= 2
    return max(1, G)


def _n_slots(qs) -> int:
    """K for a batched quant spec (K policies' rows folded into the batch
    axis), 1 for a scalar spec or none."""
    if qs is None or not slotted(qs["w_bits"]):
        return 1
    return len(qs["w_bits"])


def _expert_act(xe: torch.Tensor, qs, P: int) -> torch.Tensor:
    """Fake-quantize dispatched activations [P·G, E, C, n] at ``qs``'s
    a_bits: one range per channel over all of a policy's rows, empty
    slots' zero pad rows included (as the JAX package counts them)."""
    if qs is None:
        return xe
    if P == 1:
        return fake_quant_act(xe, qs["a_bits"])
    return fake_quant_act_slots(xe.reshape(P, -1, xe.shape[-1]),
                                qs["a_bits"]).reshape(xe.shape)


def _expert_product(xe: torch.Tensor, w: torch.Tensor, qs,
                    P: int) -> torch.Tensor:
    """xe [P·G, E, C, n_in] by the expert stack w [E, n_in, n_out] under
    ``qs``'s w_bits: the stack fake-quantized per output channel over
    the experts and rows together (read in place as its [E·n_in, n_out]
    view), per policy for a batched spec; one batched product over the
    experts. The quantized copy lives only for its product."""
    E, n_in, n_out = w.shape
    if qs is None:
        return torch.matmul(xe, w.to(xe.dtype))
    if P == 1:
        return torch.matmul(xe, fake_quant_weight(w, qs["w_bits"])
                            .to(xe.dtype))
    ws = fake_quant_weight_slots(w.reshape(E * n_in, n_out), qs["w_bits"])
    xs = xe.reshape(P, -1, E, xe.shape[2], n_in)
    return torch.matmul(xs, ws.reshape(P, 1, E, n_in, n_out).to(xe.dtype)
                        ).reshape(*xe.shape[:-1], n_out)


def apply_moe(p, x, cfg: ArchConfig, cspec=None):
    """Top-k routed experts over x [B, S, d]: the router in f32, softmax,
    ``moe_dispatch`` with ``moe_capacity`` slots per expert (overflow
    tokens drop), the gathered tokens [G, E, C, d] (an empty slot reads a
    zero pad row) through the gated experts, and the outputs combined
    with the renormalised gates of the kept choices; plus the dense
    residual MLP where the config has one (its spec under ``dense_up`` /
    ``dense_down`` / ``dense_ff_mask``). A batched cspec (K policies'
    rows folded into B) dispatches each policy's tokens on their own:
    K groups, each its own positions and capacity, each its own
    quantized experts (what ``vmap`` gives the JAX package)."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    d = x.shape[-1]
    qs_up, qs_down = _get(cspec, "up"), _get(cspec, "down")
    P = _n_slots(qs_up)
    T = x.shape[0] * x.shape[1] // P
    G = dispatch_groups(T, E)
    Tg = T // G
    xt = x.reshape(P * G, Tg, d)
    dispatch, gate_vals, slot, keep = moe_route(p, xt, cfg)
    cap = dispatch.shape[-1]

    gi = torch.arange(P * G, device=x.device)[:, None]
    pad = torch.zeros((P * G, 1, d), dtype=x.dtype, device=x.device)
    xe = torch.cat([xt, pad], 1)[gi, dispatch.reshape(P * G, E * cap)]
    xe = _expert_act(xe.reshape(P * G, E, cap, d), qs_up, P)
    # each buffer is dropped once consumed: a full-width arctic-480b layer
    # at 32K tokens peaks near 64 GB with them
    dt = x.dtype
    up = _expert_product(xe, L.getw(p, "w_up", dt), qs_up, P)
    gate = _expert_product(xe, L.getw(p, "w_gate", dt), qs_up, P)
    del xe
    h = L.mlp_act("swiglu" if cfg.mlp == "swiglu" else "geglu", gate, up)
    del up, gate
    h = _expert_act(L.apply_mask(h, _get(cspec, "ff_mask")), qs_down, P)
    ye = _expert_product(h, L.getw(p, "w_down", dt), qs_down, P)
    del h

    ye = torch.cat([ye.reshape(P * G, E * cap, d),
                    torch.zeros((P * G, 1, d), dtype=ye.dtype,
                                device=x.device)], 1)
    per_tk = ye[gi, slot.reshape(P * G, Tg * K)].reshape(P * G, Tg, K, d)
    w = torch.where(keep, gate_vals, torch.zeros_like(gate_vals))
    out = (per_tk * w.to(per_tk.dtype)[..., None]).sum(2).reshape(x.shape)
    if m.dense_residual:
        dspec = None if cspec is None else {
            "up": cspec.get("dense_up"), "down": cspec.get("dense_down"),
            "ff_mask": cspec.get("dense_ff_mask")}

        def as_linear(v):
            return v if isinstance(v, dict) else {"w": v}
        out = out + apply_mlp({k: as_linear(p["dense_" + k])
                               for k in ("w_up", "w_gate", "w_down")},
                              x, cfg, dspec)
    return out


# ===========================================================================
# Mamba-2 (SSD) block
# ===========================================================================

def ssm_dims(cfg: ArchConfig):
    """(d_inner, SSD heads, conv channels) of an SSM config."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, nheads, conv_dim


def init_ssm(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    """Raw-array weights, as in the JAX package: ``in_proj`` [d, z | x | B
    | C | dt], ``out_proj``, the depthwise ``conv_w`` [K, conv_dim], the
    decays ``A_log`` = log(linspace(1, 16)), the skip ``D``, ``dt_bias``
    and the gated norm's scale."""
    s = cfg.ssm
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    d = cfg.d_model
    d_proj = 2 * d_inner + 2 * s.d_state + nheads
    return {
        "in_proj": L.linear_init(gen, d, d_proj, dtype, device)["w"],
        "out_proj": L.linear_init(gen, d_inner, d, dtype, device)["w"],
        "conv_w": (torch.randn((s.conv_width, conv_dim), generator=gen,
                               device=device) / s.conv_width).to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          device=device)),
        "D": torch.ones((nheads,), device=device),
        "dt_bias": torch.zeros((nheads,), device=device),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
    }


def ssd_chunked(xh, dA, Bm, Cm, chunk: int, init_state=None):
    """The chunked SSD scan: xh [b,s,h,p] (dt-scaled inputs), dA [b,s,h]
    log decays, Bm, Cm [b,s,n] (one group), f32 -> (y [b,s,h,p], final
    state [b,h,p,n]). A CPU tensor takes the port of the JAX package's
    jnp path (``ref.ssd_chunked_ref``, zero padding of a ragged s); a
    CUDA tensor goes through K8 (``ops.ssd_scan``), which starts from a
    zero state: no path on the card passes ``init_state`` (prefill
    starts from zero, decode has its own one-step update), so a CUDA
    call with one raises."""
    if xh.device.type == "cpu":
        return ref.ssd_chunked_ref(xh, dA, Bm, Cm, chunk, init_state)
    if init_state is not None:
        raise ValueError("ssd_chunked: K8 takes no initial state on the "
                         "card")
    return ops.ssd_scan(xh, dA, Bm, Cm, chunk=chunk)


def ssd_inputs(p, x, cfg: ArchConfig, cspec, conv_state):
    """The SSM block's front half, x [B,S,d] -> ``((xh_dt, dA, Bm, Cm),
    (z, xh, new_conv))``: the first four are exactly what the chunked
    scan (K8) receives, f32 (xh_dt [B,S,h,P], dA [B,S,h], Bm, Cm
    [B,S,N], views of the conv output when it is f32); the rest feed
    the back half.
    In order: the (fake-quantized) input projection, the causal conv
    over silu(x | B | C) from ``conv_state``, dt = softplus(dt +
    dt_bias), dA = dt · -exp(A_log), xh_dt = xh · dt."""
    s = cfg.ssm
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    (proj,) = L.project(x, _get(cspec, "in"),
                        L.getw(p, "in_proj", x.dtype))
    z, xbc, dt = torch.split(proj, [d_inner, conv_dim, nheads], -1)
    y_conv, new_conv = L.causal_conv1d(xbc * torch.sigmoid(xbc),
                                       p["conv_w"], conv_state)
    xs, Bm, Cm = torch.split(y_conv, [d_inner, s.d_state, s.d_state], -1)
    dtf = dt.float() + p["dt_bias"][None, None]
    dtf = torch.logaddexp(dtf, torch.zeros_like(dtf))         # softplus
    a = -torch.exp(p["A_log"])                                 # [h]
    dA = dtf * a[None, None]
    xh = xs.reshape(*xs.shape[:2], nheads, s.head_dim)
    xh_dt = xh.float() * dtf[..., None]
    return (xh_dt, dA, Bm.float(), Cm.float()), (z, xh, new_conv)


def _ssm_inner(p, x, cfg: ArchConfig, cspec, conv_state, ssm_state, *,
               decode: bool = False):
    """x: [B,S,d] -> (out [B,S,d], new conv state, new SSM state). The
    whole sequence goes through ``ssd_chunked``; ``decode`` (S = 1) takes
    one step of the recurrence from ``ssm_state``."""
    d_inner = ssm_dims(cfg)[0]
    (xh_dt, dA, Bm, Cm), (z, xh, new_conv) = ssd_inputs(
        p, x, cfg, cspec, conv_state)
    if decode:
        # single step: state' = exp(dA) state + x_dt ⊗ B ; y = C · state'
        dec = torch.exp(dA[:, 0])                              # [B,h]
        upd = torch.einsum("bn,bhp->bhpn", Bm[:, 0], xh_dt[:, 0])
        new_state = dec[..., None, None] * ssm_state + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], new_state)[:, None]
    else:
        y, new_state = ssd_chunked(xh_dt, dA, Bm, Cm, cfg.ssm.chunk_size,
                                   ssm_state)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = L.apply_mask(y, _get(cspec, "head_mask"), trailing=1)
    y = y.reshape(*x.shape[:2], d_inner).to(x.dtype)
    # gated RMSNorm (mamba2)
    y = L.apply_norm("rmsnorm", {"scale": p["norm_scale"]},
                     y * (z * torch.sigmoid(z)))
    (out,) = L.project(y, _get(cspec, "out"),
                       L.getw(p, "out_proj", y.dtype))
    return out, new_conv, new_state


def apply_ssm(p, x, cfg: ArchConfig, cspec=None):
    out, _, _ = _ssm_inner(p, x, cfg, cspec, None, None)
    return out


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """The conv window (the last K-1 inputs, in ``dtype``) and the f32
    SSM state [batch, heads, P, N]; no length: an SSM's cache does not
    grow with the context."""
    s = cfg.ssm
    _, nheads, conv_dim = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, nheads, s.head_dim, s.d_state),
                             device=device),
    }


def decode_ssm(p, x, cache, pos: int, cfg: ArchConfig, cspec=None):
    """x: [B,1,d]. Replaces the cache's conv window and state in place
    (the JAX package returns a new cache) and returns the block's
    output."""
    out, cache["conv"], cache["state"] = _ssm_inner(
        p, x, cfg, cspec, cache["conv"], cache["state"], decode=True)
    return out


# ===========================================================================
# RG-LRU (Griffin / RecurrentGemma) recurrent block
# ===========================================================================

_LRU_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ArchConfig, dtype, device):
    """Raw-array weights, as in the JAX package: the input projections
    ``w_x`` (recurrence) and ``w_y`` (gate branch), ``w_out``, the
    depthwise ``conv_w`` [4, width], the per-channel (diagonal) gates
    ``w_a``, ``b_a``, ``w_i``, ``b_i`` (zero) and ``a_param``, set so that
    a^c is U(0.9, 0.999) at r = 1 (Griffin App. A); gates and a_param f32."""
    d, w = cfg.d_model, cfg.lru_width

    def zeros():
        return torch.zeros((w,), device=device)

    lin = torch.linspace(0.9, 0.999, w, device=device)
    return {
        "w_x": L.linear_init(gen, d, w, dtype, device)["w"],
        "w_y": L.linear_init(gen, d, w, dtype, device)["w"],
        "w_out": L.linear_init(gen, w, d, dtype, device)["w"],
        "conv_w": (torch.randn((4, w), generator=gen, device=device)
                   / 4.0).to(dtype),
        "w_a": zeros(), "b_a": zeros(), "w_i": zeros(), "b_i": zeros(),
        "a_param": torch.log(torch.expm1(-torch.log(lin) / _LRU_C)),
    }


def _rglru_gates(p, u):
    """u [B,S,w] (the conv output) -> (a, b), f32: the recurrence gate r
    and input gate i, log a = -c softplus(a_param) r, and b = sqrt(1 -
    a^2) (i u), in the JAX package's order (sqrt of max(1 - exp(2 log a),
    1e-12); softplus as logaddexp(x, 0))."""
    uf = u.float()
    r = torch.sigmoid(uf * p["w_a"] + p["b_a"])
    i = torch.sigmoid(uf * p["w_i"] + p["b_i"])
    a_param = p["a_param"]
    softplus = torch.logaddexp(a_param, torch.zeros_like(a_param))
    log_a = -_LRU_C * softplus * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * uf)
    return a, b


def rglru_inputs(p, x, cfg: ArchConfig, cspec, conv_state=None):
    """The RG-LRU block's front half, x [B,S,d] -> ``((a, b), (y,
    new_conv))``: a and b [B,S,w] f32 are exactly what the scan (K7)
    receives; y is the gate branch gelu(x w_y) and new_conv the conv
    window after these tokens. In order: the fake-quantized input (once)
    and ``w_x``, ``w_y``, the two projections, the causal conv over x w_x
    from ``conv_state``, the gates."""
    u, y = L.project(x, _get(cspec, "in"), L.getw(p, "w_x", x.dtype),
                     L.getw(p, "w_y", x.dtype))
    y = F.gelu(y, approximate="tanh")
    u, new_conv = L.causal_conv1d(u, p["conv_w"], conv_state)
    return _rglru_gates(p, u), (y, new_conv)


def _rglru_out(p, h, y, cspec):
    """The back half: g = h y (width-masked), then the fake-quantized
    output projection."""
    g = L.apply_mask(h * y, _get(cspec, "width_mask"))
    (out,) = L.project(g, _get(cspec, "out"), L.getw(p, "w_out", g.dtype))
    return out


def apply_rglru(p, x, cfg: ArchConfig, cspec=None):
    """x [B,S,d] -> [B,S,d]. The recurrence h_t = a_t h_{t-1} + b_t runs
    through ``ops.rglru_scan``: K7 for a CUDA tensor, the sequential plain
    version for a CPU one. The JAX package's model takes an
    ``associative_scan`` there, which sums in another order (within
    2.3e-6 of the sequential walk per row at S 32,768: ``PERF.md``)."""
    (a, b), (y, _) = rglru_inputs(p, x, cfg, cspec)
    h = ops.rglru_scan(a, b).to(x.dtype)
    return _rglru_out(p, h, y, cspec)


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """The f32 recurrence state [batch, width] and the conv window (the
    last 3 inputs, in ``dtype``); no length."""
    return {"state": torch.zeros((batch, cfg.lru_width), device=device),
            "conv": torch.zeros((batch, 3, cfg.lru_width), dtype=dtype,
                                device=device)}


def decode_rglru(p, x, cache, pos: int, cfg: ArchConfig, cspec=None):
    """x: [B,1,d]. One step of the recurrence from the cached state;
    replaces the cache's state and conv window in place (the JAX package
    returns a new cache) and returns the block's output."""
    (a, b), (y, conv) = rglru_inputs(p, x, cfg, cspec, cache["conv"])
    h = a[:, 0] * cache["state"] + b[:, 0]
    out = _rglru_out(p, h[:, None].to(x.dtype), y, cspec)
    cache["state"], cache["conv"] = h, conv
    return out
