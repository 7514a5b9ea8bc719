"""Layer primitives of the dense decoder LM.

Every matmul-bearing primitive takes an optional quant spec ``qs`` —
``{"w_bits": int, "a_bits": int}`` — and optional structured-pruning
masks, so a Galen compression policy can flow through the whole model.
With ``qs=None``/``mask=None`` the hooks vanish.

A batched quant spec carries K policies at once (the batched
validation): its bits are K-tuples of host ints or [K] int32 device
tensors (the fused engine's epoch graph), its masks [K, n]. The K policies'
rows are folded into the batch axis (slot k is the k-th block of rows),
so every other op runs unchanged; only the quantizers, the products that
follow them (``project``) and the masks (``apply_mask``) see the policy
axis, and each takes either form of spec or mask.

Weight layout convention: ``[in, out]`` (biases ``[out]``), as in the JAX
package, so fake-quant ranges are per output channel on the last axis.
The large products stay ``torch.einsum``/``matmul``, as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.deploy import unpack_int4_weight
from ..core.quantization import (fake_quant_act, fake_quant_act_slots,
                                 fake_quant_weight, fake_quant_weight_slots,
                                 slotted)
from ..kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Linear (+ fake quant + masks)
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
                bias: bool = False, scale: Optional[float] = None) -> dict:
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = (torch.randn((d_in, d_out), generator=gen, device=device) * std
         ).to(dtype)
    if bias:
        return {"w": w, "b": torch.zeros((d_out,), dtype=dtype,
                                         device=device)}
    return {"w": w}


def project(x: torch.Tensor, qs: Optional[dict], *ws: torch.Tensor
            ) -> list:
    """x [..., d_in] times each weight of ``ws`` ([d_in, d_out] each),
    under the quant spec ``qs``: none, a scalar spec, or a batched one
    (bits as K-tuples or [K] device tensors, the K policies' rows folded
    into the batch axis:
    slot k's rows quantized at ``a_bits[k]`` over their own range, each
    weight at ``w_bits[k]``, then one product over the slots,
    ``product_slots``). x is quantized once for all of ``ws``. Returns
    one product per weight, in their order."""
    if qs is None:
        return [torch.einsum("...i,io->...o", x, w.to(x.dtype)) for w in ws]
    if not slotted(qs["w_bits"]):
        xq = fake_quant_act(x, qs["a_bits"])
        return [torch.einsum("...i,io->...o", xq, fake_quant_weight(
            w, qs["w_bits"]).to(x.dtype)) for w in ws]
    K = len(qs["a_bits"])
    xs = fake_quant_act_slots(x.reshape(K, -1, x.shape[-1]), qs["a_bits"])
    return [product_slots(xs, fake_quant_weight_slots(w, qs["w_bits"]),
                          x.dtype).reshape(*x.shape[:-1], w.shape[-1])
            for w in ws]


def product_slots(xs: torch.Tensor, ws: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """xs [K, rows, d_in] by the K slots' weights ws [K, d_in, d_out]
    (cast to ``dtype``): one bmm, or one product of all K·rows rows where
    the slots share one weight (slot stride 0). In bf16 each slot equals
    the scalar forward of its policy on the card; in f32 the bmm sums in
    another order than the scalar path's 2-D product, and a last-bit
    difference moves whole fake-quant steps downstream
    (``tools/batched_products.py``)."""
    if ws.stride(0) == 0:
        return torch.matmul(xs, ws[0].to(dtype))
    return torch.bmm(xs, ws.to(dtype))


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor],
               trailing: int = 0) -> torch.Tensor:
    """x times a pruning mask on axis -(1 + trailing): [n], or [K, n] for
    K policies whose rows are folded into the batch axis (slot k's mask
    on the k-th block of rows). ``None`` leaves x as it is."""
    if mask is None:
        return x
    m = mask.reshape(mask.shape + (1,) * trailing).to(x.dtype)
    if mask.dim() == 1:
        return x * m
    tail = x.shape[x.dim() - 1 - trailing:]
    return (x.reshape((mask.shape[0], -1) + tuple(tail)) * m[:, None]
            ).reshape(x.shape)


def materialize_weight(p, dtype: torch.dtype):
    """Resolve a weight container (see ``core/deploy.py``) to a dense
    tensor. Deployed int8 / packed-int4 storage dequantizes on the fly,
    in ``dtype``: codes times per-channel scale (an MoE stack's codes
    [E, in, out] times its per-expert scales [E, 1, out])."""
    if not isinstance(p, dict):
        return p
    if "w" in p:
        return p["w"]
    if "w_q" in p:
        return p["w_q"].to(dtype) * p["w_scale"].to(dtype)
    if "w_p" in p:
        return unpack_int4_weight(p["w_p"]).to(dtype) \
            * p["w_scale"].to(dtype)
    raise KeyError(f"no weight in container: {list(p)}")


def getw(container: dict, name: str, dtype: torch.dtype):
    """Fetch a possibly deploy-quantized raw weight (the embedding, the
    unembedding, an MoE layer's expert stacks)."""
    v = container[name]
    if isinstance(v, dict):
        return materialize_weight(v, dtype)
    return v


def linear(p: dict, x: torch.Tensor, qs: Optional[dict] = None,
           out_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    (y,) = project(x, qs, materialize_weight(p, x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    if out_mask is not None:
        y = y * out_mask.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(kind: str, d: int, dtype, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, p: dict, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (xf * p["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.var(xf, -1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        xf = xf * p["scale"].float() + p["bias"].float()
    return xf.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions.float()[..., None] * freqs        # [..., S, half]
    ang = ang[..., None, :]                           # [..., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention — one dense block up to 512 positions; beyond that the chunked
# online softmax: kernel K6 for a CUDA tensor, the port of the JAX
# package's jnp chunked loop (``attention_chunked``) for a CPU one.
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _attn_scores_mask(qpos, kpos, causal: bool, window: int):
    """qpos [Q], kpos [K] -> bool mask [Q, K] (True = attend)."""
    qp = qpos[:, None]
    kp = kpos[None, :]
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= kp > qp - window
    m &= kp >= 0
    return m


def attention(q, k, v, *, causal: bool, window: int = 0,
              q_chunk: int = 512, k_chunk: int = 1024,
              head_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention. q: [B,S,H,D]; k,v: [B,S,KV,D]. window=0 -> unlimited.

    For S <= max(q_chunk, 512) one dense block; otherwise the chunked
    online softmax: K6 (``ops.flash_attention``, on transposed views, no
    copy) for a CUDA tensor, ``attention_chunked`` for a CPU one.
    ``head_mask`` ([H], or [K, H] for K policies' rows folded into B)
    applies after either, as in the JAX package."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    if S <= max(q_chunk, 512):
        scale = 1.0 / math.sqrt(D)
        qq = q.reshape(B, S, KV, G, D)
        positions = torch.arange(S, device=q.device)
        s = torch.einsum("bqkgd,blkd->bkgql", qq, k).float() * scale
        mask = _attn_scores_mask(positions, positions, causal, window)
        s = torch.where(mask[None, None, None], s,
                        torch.full_like(s, NEG_INF))
        p = torch.softmax(s, -1)
        o = torch.einsum("bkgql,blkd->bqkgd", p.to(v.dtype), v)
        o = o.reshape(B, S, H, D)
    elif q.device.type == "cpu":
        o = attention_chunked(q, k, v, causal=causal, window=window,
                              q_chunk=q_chunk, k_chunk=k_chunk)
    else:
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window).transpose(1, 2).to(v.dtype)
    return apply_mask(o, head_mask, trailing=1)


def attention_chunked(q, k, v, *, causal: bool, window: int = 0,
                      q_chunk: int = 512,
                      k_chunk: int = 1024) -> torch.Tensor:
    """The JAX package's jnp chunked attention, as a loop over q-chunks
    (outer) and k-chunks (inner, online softmax): S padded to each chunk
    multiple (padded q positions read S, padded k positions -1), scores
    cast to f32 after the einsum in the input dtype, p cast to v's dtype
    before P.V. K6's plain version at lengths where the dense
    ``ref.attention_ref`` would not fit. q: [B,S,H,D]; k,v: [B,S,KV,D]
    -> [B,S,H,D] in v's dtype."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    n_q = -(-S // q_chunk)
    n_k = -(-S // k_chunk)
    positions = torch.arange(S, device=q.device)

    def pad_s(x, to, value=0):
        fill = torch.full((x.shape[0], to - S) + tuple(x.shape[2:]), value,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], 1)

    qq = pad_s(q.reshape(B, S, KV, G, D), n_q * q_chunk)
    k_p, v_p = pad_s(k, n_k * k_chunk), pad_s(v, n_k * k_chunk)
    qpos = pad_s(positions[None], n_q * q_chunk, S)[0]
    kpos = pad_s(positions[None], n_k * k_chunk, -1)[0]

    outs = []
    for i in range(n_q):
        rows = slice(i * q_chunk, (i + 1) * q_chunk)
        qi = qq[:, rows].permute(0, 2, 3, 1, 4)          # [B,KV,G,Cq,D]
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, D), device=q.device)
        for j in range(n_k):
            cols = slice(j * k_chunk, (j + 1) * k_chunk)
            ki = k_p[:, cols].transpose(1, 2)            # [B,KV,Ck,D]
            vi = v_p[:, cols].transpose(1, 2)
            s = torch.einsum("bkgqd,bkld->bkgql", qi, ki).float() * scale
            mask = _attn_scores_mask(qpos[rows], kpos[cols], causal, window)
            s = torch.where(mask[None, None, None], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgql,bkld->bkgqd", p.to(vi.dtype), vi).float()
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.stack(outs)                              # [n_q,B,KV,G,Cq,D]
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, n_q * q_chunk, H, D)
    return out[:, :S].to(v.dtype)


def decode_attention(q, k_cache, v_cache, cache_len: int, *,
                     window: int = 0, ring: bool = False,
                     head_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Single-token attention against a cache.

    q: [B,1,H,D]; caches: [B,W,KV,D]; cache_len: current length (a host
    int). ``ring=True`` means the cache is a ring buffer of size W
    (sliding window): all valid slots are attended, positions already
    rotated."""
    B, _, H, D = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qq = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,blkd->bkgl", qq, k_cache).float()
    s = s / math.sqrt(D)
    slot = torch.arange(W, device=q.device)
    valid = slot < (min(cache_len, W) if ring else cache_len)
    if window > 0 and not ring:
        valid &= slot > cache_len - 1 - window
    s = torch.where(valid[None, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, -1)
    o = torch.einsum("bkgl,blkd->bkgd", p.to(v_cache.dtype), v_cache)
    o = o.reshape(B, 1, H, D)
    return apply_mask(o, head_mask, trailing=1)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def mlp_act(kind: str, gate: torch.Tensor, up: Optional[torch.Tensor]):
    if kind == "swiglu":
        return gate * torch.sigmoid(gate) * up
    if kind == "geglu":
        return torch.nn.functional.gelu(gate, approximate="tanh") * up
    if kind == "gelu":
        return torch.nn.functional.gelu(gate, approximate="tanh")
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (the SSM block's front conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """x: [B,S,C]; w: [K,C] depthwise. Returns y ([B,S,C], in x's dtype)
    and the new state ([B,K-1,C], x's dtype): the last K-1 inputs, for
    streaming decode. The JAX package's order: ``sum(xs[:, i:i+S] *
    w[i])`` over the taps, a bf16 input times the f32 weight promoted to
    f32 and summed in f32, then cast back."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xs = torch.cat([state.to(x.dtype), x], 1)             # [B, S+K-1, C]
    S = x.shape[1]
    y = xs[:, 0:S] * w[0][None, None]
    for i in range(1, K):
        y = y + xs[:, i:i + S] * w[i][None, None]
    new_state = xs[:, -(K - 1):] if K > 1 else state
    return y.to(x.dtype), new_state
