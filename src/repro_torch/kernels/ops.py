"""Public ops over the kernel wrappers: reshape to the kernel's layout,
attach a gradient, flatten a network. Each routes by the tensor it is
given: the plain version for a CPU tensor, the kernel for a CUDA one.

There is no padding to the TPU's (8, 128) tiles here: the CUDA kernels
mask their own ragged edges.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fake_quant as _fq
from . import flash_attention as _fa
from . import mlp_fused as _mlp
from . import quant_matmul as _qm
from . import ref as _ref
from . import rglru_scan as _rg
from . import ssd_scan as _ssd


def quantize_operands(x: torch.Tensor, w: torch.Tensor, w_bits: int = 8):
    """The codes and scales ``quantized_matmul`` hands the kernel:
    ``((xq, wq, sx, zx, sw, zw), packed)``. x is quantized per row at 8
    bits, w per column at 4 bits (``w_bits <= 4``: packed two per byte,
    K5) or 8 (K4). The JAX op pads every dim to a multiple of 256; the
    kernels mask ragged M and N instead, and an odd K gets one zero
    column on xq and one zero row on wq before packing int4 (the
    caller's ``k_true`` keeps the true count), so the function is the
    same."""
    xq, sx, zx = _ref.quantize_rows(x, 8)
    packed = w_bits <= 4
    wq, sw, zw = _ref.quantize_cols(w, 4 if packed else 8)
    if packed:
        if x.shape[1] % 2:
            xq = F.pad(xq, (0, 1))
            wq = F.pad(wq, (0, 0, 0, 1))
        wq = _ref.pack_int4(wq)
    return (xq.contiguous(), wq.contiguous(), sx, zx, sw, zw), packed


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     w_bits: int = 8) -> torch.Tensor:
    """x [M, K] @ w [K, N] (f32 or bf16) through the quantized kernel:
    ``quantize_operands``, integer product, fused dequant (K4, or K5 for
    ``w_bits <= 4``). Returns f32 [M, N]."""
    args, packed = quantize_operands(x, w, w_bits)
    return _qm.quant_matmul(*args, packed=packed, k_true=x.shape[1])


def fused_fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-channel (last axis) fake quant of an f32 tensor of any rank,
    the range reduced over every other axis. No gradient (the caller's
    straight-through estimator provides it)."""
    shape = x.shape
    out = _fq.fake_quant_2d(x.detach().reshape(-1, shape[-1]).contiguous(),
                            bits)
    return out.reshape(shape)


class _FakeQuantSTE(torch.autograd.Function):
    """K1 in its straight-through mode: the forward is one kernel pass
    over x in its own dtype writing ``(xf + (xq - xf)).to(x.dtype)``, the
    backward the identity (the STE of ``core.quantization.fake_quant``)."""

    @staticmethod
    def forward(ctx, x, bits):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if x2.stride(-1) != 1:
            x2 = x2.contiguous()
        return _fq.fake_quant_2d(x2, bits, ste=True).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant_ste(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-channel (last axis) fake quant of an f32, bf16 or f16 tensor of
    any rank with the straight-through estimator, in x's dtype: forward
    ``(xf + (xq - xf)).to(x.dtype)`` (K1's straight-through mode, reading
    x in place where its rows have unit channel stride), gradient the
    identity."""
    return _FakeQuantSTE.apply(x, bits)


def fake_quant_slots(x: torch.Tensor, bits) -> torch.Tensor:
    """K1 over K policy slots in its straight-through mode, x [K, R, C]
    (f32, bf16 or f16; ``w.expand(K, R, C)`` for one tensor shared by
    every slot): slot k's ``(xf + (xq - xf)).to(x.dtype)`` at ``bits[k]``
    with its own range, one launch for the K slots. A view whose rows
    K1 cannot read in place (channel stride not 1, such as the tied
    head's ``embed.T``) is copied once, however many slots share it.
    ``bits``: K host ints, or a [K] int32 tensor on x's device (K1's
    device-bits entry, the fused engine's epoch graph). No gradient: the
    batched validation runs under ``no_grad``."""
    _, R, C = x.shape
    if x.stride(2) != 1 and C > 1 or x.stride(1) < C and R > 1:
        x = x[0].contiguous().expand_as(x) if x.stride(0) == 0 \
            else x.contiguous()
    if isinstance(bits, torch.Tensor):
        return _fq.fake_quant_slots_dev(x, bits, ste=True)
    return _fq.fake_quant_slots(x, bits, ste=True)


class _MLP3(torch.autograd.Function):
    """K2 forward; the backward is plain tensor ops over the residuals the
    kernel emits (the JAX package's ``ops._mlp3_vjp_bwd``: relu' = h > 0,
    sigmoid' = y (1 - y)), computing only the gradients autograd asks for
    (the actor loss needs none for the critic's weights)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, sigmoid):
        y, h1, h2 = _mlp.mlp3(x, w1, b1, w2, b2, w3, b3, sigmoid=sigmoid)
        ctx.save_for_backward(x, w1, w2, w3, h1, h2, y)
        ctx.sigmoid = sigmoid
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3, h1, h2, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        dz3 = dy * y * (1.0 - y) if ctx.sigmoid else dy
        dw3 = h2.T @ dz3 if need[5] else None
        db3 = dz3.sum(0) if need[6] else None
        dz2 = (dz3 @ w3.T) * (h2 > 0)
        dw2 = h1.T @ dz2 if need[3] else None
        db2 = dz2.sum(0) if need[4] else None
        dz1 = (dz2 @ w2.T) * (h1 > 0)
        dw1 = x.T @ dz1 if need[1] else None
        db1 = dz1.sum(0) if need[2] else None
        dx = dz1 @ w1.T if need[0] else None
        return dx, dw1, db1, dw2, db2, dw3, db3, None


def fused_mlp3(params, x: torch.Tensor, final: str = "linear"):
    """Fused 3-layer MLP forward, differentiable. ``params`` is the DDPG
    layout, three ``{"w", "b"}`` layers; ``final`` is "linear" or
    "sigmoid"."""
    (l1, l2, l3) = params
    return _MLP3.apply(x.contiguous(), l1["w"], l1["b"], l2["w"], l2["b"],
                       l3["w"], l3["b"], final == "sigmoid")


def fused_mlp3_members(params, x: torch.Tensor, final: str = "linear"):
    """The trunk of P member networks on x [P, B, D0] in one K2 launch
    (its member form), no gradient: ``params`` the DDPG layout with a
    leading member axis on every leaf (a population's stacked agent
    state)."""
    (l1, l2, l3) = params
    return _mlp.mlp3_members(x.contiguous(), l1["w"], l1["b"], l2["w"],
                             l2["b"], l3["w"], l3["b"],
                             sigmoid=final == "sigmoid")[0]


def fused_polyak_nets(targets, onlines, tau: float):
    """Soft-target update of several networks (each a list of ``{"w",
    "b"}`` layers) as one kernel launch over all their leaves, read where
    they lie (K3's table of leaves; no flattening copy). Returns the new
    networks, whose leaves are views of one new buffer (no in-place
    update)."""
    t_leaves = [l[k] for net in targets for l in net for k in sorted(l)]
    p_leaves = [l[k] for net in onlines for l in net for k in sorted(l)]
    new = iter(_mlp.polyak_leaves(t_leaves, p_leaves, tau))
    return [[{k: next(new) for k in sorted(l)} for l in net]
            for net in targets]


def fused_polyak(target, online, tau: float):
    """Soft-target update of one network (a list of ``{"w", "b"}``
    layers) as one kernel pass (``fused_polyak_nets`` of one network)."""
    return fused_polyak_nets([target], [online], tau)[0]


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def _plain_vjp(ctx, plain, grads_out) -> tuple:
    """The backward of a kernel forward: ``plain`` (the chain the JAX
    package differentiates) recomputed from the saved inputs under
    ``enable_grad`` and differentiated against ``grads_out`` (None for an
    output nobody used). One gradient per saved input, None where the
    input asked for none. Only the inputs are kept between forward and
    backward, as activation checkpointing keeps them."""
    xs = [None if x is None else x.detach().requires_grad_(need)
          for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = plain(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    used = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
    wrt = [x for x in xs if x is not None and x.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in used], wrt,
                                   [g for _, g in used], allow_unused=True)
               if used and wrt else [None] * len(wrt))
    return tuple(next(got) if x is not None and x.requires_grad else None
                 for x in xs)


def _attention_plain(q, k, v, causal: bool, window: int):
    """K6's function on its [B,H,S,D] layout through the JAX model's
    chunked jnp chain (``layers.attention_chunked``, on the [B,S,H,D]
    views the model hands in): what the JAX package differentiates past
    512 positions."""
    from ..models.layers import attention_chunked   # layers imports ops
    return attention_chunked(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal,
                             window=window).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """K6 under autograd: the forward is one kernel launch (the bits of a
    no-grad call); the backward recomputes ``_attention_plain`` from the
    saved q, k, v and differentiates it (the JAX package's K2 pattern,
    ``custom_vjp`` with the reference chain as its backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window)
        return _fa.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        causal, window = ctx.mask
        return (*_plain_vjp(ctx, lambda q, k, v: _attention_plain(
            q, k, v, causal, window), (g,)), None, None)


class _RGLRUScan(torch.autograd.Function):
    """K7 under autograd: one launch forward; the backward differentiates
    the sequential ``ref.rglru_scan_ref`` recomputed from a, b (and
    h0)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        ctx.save_for_backward(a, b, h0)
        return _rg.rglru_scan(a, b, h0)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(ctx, _ref.rglru_scan_ref, (g,))


class _SSDScan(torch.autograd.Function):
    """K8 under autograd: one launch forward for (y, final state); the
    backward differentiates the chunked ``ref.ssd_chunked_ref`` (the JAX
    model's jnp ``ssd_chunked``) at the caller's chunk, recomputed from
    xh, dA, B, C."""

    @staticmethod
    def forward(ctx, xh, dA, Bm, Cm, chunk):
        ctx.save_for_backward(xh, dA, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _ssd.ssd_scan(xh, dA, Bm, Cm, chunk=min(chunk, max(
            xh.shape[1], 1)))

    @staticmethod
    def backward(ctx, gy, gstate):
        return (*_plain_vjp(ctx, lambda *xs: _ref.ssd_chunked_ref(
            *xs, ctx.chunk), (gy, gstate)), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,H,S,D]; k,v [B,KV,S,D] -> [B,H,S,D] (K6). The JAX op pads S
    to its blocks' multiple; the kernel masks the ragged edge instead.
    On a CUDA tensor under autograd (an input requires grad) the kernel
    runs inside ``_FlashAttention``, whose backward differentiates the
    chunked plain chain; a CPU tensor takes the plain version, which
    autograd differentiates directly."""
    if q.device.type != "cpu" and _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0=None) -> torch.Tensor:
    """a, b [B,S,C]; h0 [B,C] or None -> h [B,S,C] in a's dtype, ``h_t =
    a_t h_{t-1} + b_t`` (K7). The JAX op halves its blocks until they
    divide S and C; the kernel masks ragged edges instead. On a CUDA
    tensor under autograd the kernel runs inside ``_RGLRUScan`` (backward:
    the sequential plain version differentiated); a CPU tensor takes the
    plain version."""
    if a.device.type != "cpu" and _wants_grad(a, b, h0):
        return _RGLRUScan.apply(a, b, h0)
    return _rg.rglru_scan(a, b, h0)


def ssd_scan(xh: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int = 256):
    """xh [B,S,H,P] (dt-scaled inputs); dA [B,S,H] log decays; Bm, Cm
    [B,S,N] -> (y [B,S,H,P], final state [B,H,P,N]) (K8). The JAX op
    halves the chunk until it divides S; the kernel masks the ragged
    edge at any chunk length instead, which is the same function. On a
    CUDA tensor under autograd the kernel runs inside ``_SSDScan``
    (backward: the chunked plain version at ``chunk`` differentiated); a
    CPU tensor takes the plain version."""
    if xh.device.type != "cpu" and _wants_grad(xh, dA, Bm, Cm):
        return _SSDScan.apply(xh, dA, Bm, Cm, chunk)
    return _ssd.ssd_scan(xh, dA, Bm, Cm, chunk=min(chunk, max(
        xh.shape[1], 1)))
