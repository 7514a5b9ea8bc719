"""Plain PyTorch versions of the hand-written kernels.

Each is the function its kernel computes, written as ordinary tensor ops
(one PyTorch kernel per op on the card). The wrappers use them for CPU
tensors; the tests hold them against the JAX package, and ``chip_smoke.py``
holds each kernel against them on the card.
"""
from __future__ import annotations

import math

import torch


def fake_quant_ref(x: torch.Tensor, bits: int) -> torch.Tensor:
    """K1's function: x [R, C] f32, bf16 or f16 -> quantize-dequantize with
    the range of each channel (last axis) reduced over the rows, in f32, then
    cast to x's dtype (the TPU kernel's ``out.astype(o_ref.dtype)``);
    ``bits >= 32`` passes x through. The arithmetic of
    ``core.quantization.quantize`` / ``dequantize`` (the JAX package's
    ``fake_quant`` before its STE)."""
    from ..core.quantization import dequantize, quantize
    if bits >= 32:
        return x.clone()
    q, s, z = quantize(x, min(max(int(bits), 1), 31), dims=(0,))
    return dequantize(q, s, z).to(x.dtype)


def fake_quant_ste_ref(x: torch.Tensor, bits: int) -> torch.Tensor:
    """K1's straight-through mode: ``(xf + (xq - xf)).to(x.dtype)`` with
    xf = x in f32 and xq = ``fake_quant_ref(xf)``, each step one correctly
    rounded op: the forward value of ``core.quantization.fake_quant``'s
    chain (and of the JAX package's STE)."""
    if bits >= 32:
        return x.clone()
    xf = x.float()
    return (xf + (fake_quant_ref(xf, bits) - xf)).to(x.dtype)


def fake_quant_slots_ref(x: torch.Tensor, bits, ste: bool = False
                         ) -> torch.Tensor:
    """K1 over K policy slots: x [K, R, C] -> [K, R, C] in x's dtype, slot
    k quantized at ``bits[k]`` with its own per-channel range over its own
    R rows (``fake_quant_ref``, or ``fake_quant_ste_ref`` with ``ste``,
    slot by slot); a slot stride of 0 (one tensor shared by every slot)
    gives every slot the same range."""
    fn = fake_quant_ste_ref if ste else fake_quant_ref
    return torch.stack([fn(x[k], int(b)) for k, b in enumerate(bits)])


def mlp3_ref(x, w1, b1, w2, b2, w3, b3, sigmoid: bool):
    """K2's function: the 3-layer trunk, returning (y, h1, h2)."""
    h1 = torch.relu(x @ w1 + b1)
    h2 = torch.relu(h1 @ w2 + b2)
    y = h2 @ w3 + b3
    return (torch.sigmoid(y) if sigmoid else y), h1, h2


def mlp3_members_ref(x, w1, b1, w2, b2, w3, b3, sigmoid: bool):
    """K2's member form: P networks at once, x [P, B, D0] and every weight
    and bias with the leading member axis; member p is ``mlp3_ref`` on
    its own slices. Returns (y, h1, h2), each [P, B, ·]."""
    outs = [mlp3_ref(x[p], w1[p], b1[p], w2[p], b2[p], w3[p], b3[p],
                     sigmoid) for p in range(x.shape[0])]
    return tuple(torch.stack(z) for z in zip(*outs))


def polyak_ref(target: torch.Tensor, online: torch.Tensor,
               tau: float) -> torch.Tensor:
    """K3's function: ``(1 - tau) * target + tau * online``, the tree-map
    soft update of the JAX package's ``ddpg.polyak_update``."""
    return (1 - tau) * target + tau * online


def fused_adam_polyak_ref(leaves, t: torch.Tensor, lr: float, tau: float,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8):
    """The fused Adam + Polyak pass of one network over stacked leaves
    (the JAX package's ``ddpg._fused_adam_polyak``): ``leaves`` is a list
    of (p, m, v, g, target) tensors with a leading member axis P, ``t``
    the (P,) int32 Adam step counts. The bias correction is folded into
    per-member ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)`` and ``eps_t =
    eps * sqrt(1 - b2^t)`` at the new step t + 1 (an exact rewrite of
    ``adam_step``), then per element Adam and the soft target update on
    the new parameters. Returns ([(p, m, v, target)] new, t + 1)."""
    t = t + 1
    tf = t.float()
    c1 = 1 - torch.pow(b1, tf)
    c2 = 1 - torch.pow(b2, tf)
    lr_t = lr * torch.sqrt(c2) / c1
    eps_t = eps * torch.sqrt(c2)
    out = []
    for p, m, v, g, tg in leaves:
        nd = (1,) * (p.dim() - 1)
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        p2 = p - lr_t.reshape(-1, *nd) * m2 / (
            torch.sqrt(v2) + eps_t.reshape(-1, *nd))
        out.append((p2, m2, v2, (1 - tau) * tg + tau * p2))
    return out, t


# --- quantized matmul (K4, K5) ----------------------------------------------
# Convention: zero offsets are ADDED back on dequantization, x = s·(q + z).
# Every quotient divides a tensor by a tensor: ``tensor / float`` is
# reciprocal-then-multiply on the card, not the correctly rounded quotient.

def quantize_rows(x: torch.Tensor, bits: int = 8):
    """Asymmetric per-row quantization -> (q int8, scale [R], zero [R]),
    q in the signed range (q = round(x/s) − z, so the z's cancel on the
    round trip). The JAX package's ``ref.quantize_rows``."""
    x = x.float()
    x_min = x.amin(1)
    span = torch.clamp_min(x.amax(1) - x_min, 1e-8)
    s = span / torch.full_like(span, 2.0 ** bits - 1.0)
    z = torch.round(x_min / s) + 2.0 ** (bits - 1)
    q = torch.clamp(torch.round(x / s[:, None]) - z[:, None],
                    -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1)
    return q.to(torch.int8), s, z


def quantize_cols(w: torch.Tensor, bits: int = 8):
    """Per-column quantization of w [K, N] -> (q [K, N], scale [N],
    zero [N])."""
    qT, s, z = quantize_rows(w.T, bits)
    return qT.T.contiguous(), s, z


def dequant_matmul_ref(xq, wq, sx, zx, sw, zw) -> torch.Tensor:
    """Dequantize, then an f32 matmul: x = sx·(xq + zx), w = sw·(wq + zw)."""
    x = sx[:, None] * (xq.float() + zx[:, None])
    w = sw[None, :] * (wq.float() + zw[None, :])
    return x @ w


def int8_matmul_ref(xq, wq, sx, zx, sw, zw, k_true: int = 0):
    """K4's function, the integer-accumulation form:
    y = (sx·sw)·(((acc + zx·colsum_w) + zw·rowsum_x) + (K·zx)·zw), each
    step one correctly rounded f32 op in this order. ``acc`` is a float64
    product of the codes, exact (PyTorch has no int32 matmul on CUDA);
    the code sums are exact in f32. ``k_true``: the unpadded contraction
    length (0 = all of K)."""
    acc = (xq.double() @ wq.double()).float()
    rowsum = xq.float().sum(1)
    colsum = wq.float().sum(0)
    K = k_true or xq.shape[1]
    corr = (acc + zx[:, None] * colsum[None, :]
            + zw[None, :] * rowsum[:, None]
            + K * zx[:, None] * zw[None, :])
    return sx[:, None] * sw[None, :] * corr


def pack_int4(w4: torch.Tensor) -> torch.Tensor:
    """[..., K, N] int8 in [-8, 7] -> [..., K/2, N] packed two per byte
    (low nibble = even row)."""
    lo = w4[..., 0::2, :].to(torch.int32) & 0xF
    hi = (w4[..., 1::2, :].to(torch.int32) & 0xF) << 4
    b = lo | hi                                   # 0..255
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def unpack_int4_ref(packed: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] packed -> [..., K, N] int8 in [-8, 7]: row 2i is the
    sign-extended low nibble of byte i, row 2i+1 its high nibble."""
    p = packed.to(torch.int32)
    low = ((p & 0xF) ^ 8) - 8
    high = p >> 4                                 # arithmetic shift
    out = torch.stack([low, high], dim=-2)        # [..., K/2, 2, N]
    shape = packed.shape[:-2] + (2 * packed.shape[-2], packed.shape[-1])
    return out.reshape(shape).to(torch.int8)


def quant_matmul_ref(xq, wq, sx, zx, sw, zw, packed: bool = False,
                     k_true: int = 0) -> torch.Tensor:
    """K4 (``packed=False``, wq [K, N]) and K5 (``packed=True``, wq
    [K/2, N] packed int4): the codes' product with the dequant epilogue."""
    if packed:
        wq = unpack_int4_ref(wq)
    return int8_matmul_ref(xq, wq, sx, zx, sw, zw, k_true)


# --- flash attention (K6) -----------------------------------------------------

def attention_ref(q, k, v, *, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """K6's function, dense: q [B,H,S,D]; k,v [B,KV,S,D] -> [B,H,S,D] in
    q's dtype, an f32 softmax over every key with the finite -1e30 mask
    (the JAX package's ``ref.attention_ref``). Its scores take S² memory:
    at long S the model's chunked branch (``layers.attention_chunked``)
    is the plain reference instead."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    qq = q.reshape(B, KV, H // KV, S, D)
    s = torch.einsum("bkgqd,bkld->bkgql", qq.float(),
                     k.float()) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, -1)
    o = torch.einsum("bkgql,bkld->bkgqd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


# --- RG-LRU scan (K7) ---------------------------------------------------------

def rglru_scan_ref(a, b, h0=None) -> torch.Tensor:
    """K7's function, sequential: ``h_t = a_t * h_{t-1} + b_t`` over a, b
    [B,S,C] in f32 from h0 [B,C] (zero by default), one multiply and one
    add per step, each correctly rounded; returns a's dtype (the JAX
    package's ``ref.rglru_scan_ref``)."""
    B, S, C = a.shape
    h = torch.zeros((B, C), device=a.device) if h0 is None else h0.float()
    af, bf = a.float(), b.float()
    out = torch.empty((B, S, C), device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


# --- SSD chunked scan (K8) ----------------------------------------------------

def ssd_scan_ref(xh, dA, Bm, Cm):
    """Sequential SSD ground truth (the JAX package's ``ref.ssd_scan_ref``):
    xh [B,S,H,P] (dt-scaled inputs); dA [B,S,H] log decays; Bm, Cm
    [B,S,N]. One step per token on an f32 state [B,H,P,N]:
    ``state = exp(dA_t) state + x_t ⊗ B_t``, ``y_t = state · C_t``.
    Returns (y in xh's dtype, final state f32)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    state = torch.zeros((B, H, P, N), device=xh.device)
    ys = []
    for t in range(S):
        dec = torch.exp(dA[:, t].float())                      # [B,H]
        upd = torch.einsum("bn,bhp->bhpn", Bm[:, t].float(),
                           xh[:, t].float())
        state = dec[..., None, None] * state + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), state))
    return torch.stack(ys, 1).to(xh.dtype), state


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., l] log decays -> [..., l, l]: ``cs[i] - cs[j]`` (the sum of
    a over j+1..i) on and below the diagonal, -inf above, so that its
    exp is the lower-triangular decay matrix and the positive upper
    entries are never exponentiated (the JAX package's
    ``blocks._segsum``)."""
    l = a.shape[-1]
    cs = torch.cumsum(a, -1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, torch.full_like(d, -math.inf))


def ssd_chunked_ref(xh, dA, Bm, Cm, chunk: int, init_state=None):
    """K8's function in its chunked form (Mamba-2, arXiv:2405.21060
    listing 1), the JAX package's jnp ``blocks.ssd_chunked``: S padded
    with zeros to a multiple of ``chunk``; per chunk the cumulative
    decays, the intra-chunk product (C Bᵀ ⊙ exp(segsum)) X, the chunk's
    state, a sequential pass over the chunk states from ``init_state``
    (zero by default) and the inter-chunk output exp(A_cs) ⊙ (C ·
    stateᵀ). Shapes as ``ssd_scan_ref``; f32. Returns (y [B,S,H,P],
    final state [B,H,P,N])."""
    b, s, h, pdim = xh.shape
    n = Bm.shape[-1]
    pad = (-s) % chunk
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dA = torch.nn.functional.pad(dA, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    sp = s + pad
    c = sp // chunk
    X = xh.reshape(b, c, chunk, h, pdim)
    A = dA.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # [b,h,c,l]
    Bc = Bm.reshape(b, c, chunk, n)
    Cc = Cm.reshape(b, c, chunk, n)

    A_cum = torch.cumsum(A, -1)                                # [b,h,c,l]
    Lmat = torch.exp(segsum(A))                                # [b,h,c,l,l]
    Y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, Lmat, X)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)          # [b,h,c,l]
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, X)
    chunk_decay = torch.exp(A_cum[..., -1])                    # [b,h,c]
    prev = torch.zeros((b, h, pdim, n), dtype=X.dtype, device=X.device) \
        if init_state is None else init_state
    prevs = []                                 # the state BEFORE each chunk
    for ci in range(c):
        prevs.append(prev)
        prev = states[:, ci] + chunk_decay[..., ci, None, None] * prev
    prev_states = torch.stack(prevs, 1)                        # [b,c,h,p,n]
    state_decay = torch.exp(A_cum)                             # [b,h,c,l]
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         state_decay)
    Y = (Y_diag + Y_off).reshape(b, sp, h, pdim)[:, :s]
    return Y, prev
