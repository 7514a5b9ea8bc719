"""Fake quantization (paper Eq. 3) — asymmetric uniform, dynamic per-channel
range, straight-through estimator.

The paper's three layer modes map to effective bit widths:
    FP32 -> bits = 32 (pass-through)
    INT8 -> bits = 8
    MIX  -> bits in [1, MAX_MIX_BITS]  (weights and activations independent)

Bits are host ints here (the scalar engine builds its compression spec on
the host), so ``bits >= 32`` skips the quantizer outright. A CPU tensor
runs the plain chain through ``kernels.ops.fused_fake_quant`` (K1's plain
version); any other tensor takes ``kernels.ops.fake_quant_ste``, K1 in
its straight-through mode, one pass over x in its own dtype with the
same arithmetic. The math is f32 inside and the result is cast back to
the input's dtype, at the same points as the JAX package's
``core/quantization.py``.

The batched validation carries K policies at once: its bits are K-tuples
of host ints, one per policy slot, or, in the fused engine's epoch graph,
a [K] int32 tensor on the device. ``fake_quant_act_slots`` and
``fake_quant_weight_slots`` are the per-policy forms (what ``vmap`` makes
of ``fake_quant`` in the JAX package): each slot gets its own range and
its own bits, ``bits >= 32`` passes the slot through. With host bits a
site at which every slot is >= 32 launches nothing; device bits always
launch K1, which copies such slots (nothing on the host may read them).
They run under ``no_grad`` (no straight-through gradient).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .policy import MAX_MIX_BITS


def _minmax(x: torch.Tensor, dims: Sequence[int]):
    x_min = torch.amin(x, dim=tuple(dims), keepdim=True)
    x_max = torch.amax(x, dim=tuple(dims), keepdim=True)
    # Guard degenerate (constant) channels.
    span = torch.clamp_min(x_max - x_min, 1e-8)
    return x_min, x_min + span


def quantize(x: torch.Tensor, bits: int, dims: Sequence[int]):
    """Paper Eq. 3: Q(r) = clip(floor(s*r - z), -n, n).

    Returns (q, scale, offset); all computed in f32. ``dims``: reduction
    axes for the dynamic range (per-channel = all axes except the channel
    one)."""
    xf = x.float()
    n = 2.0 ** bits - 1.0
    x_min, x_max = _minmax(xf, dims)
    # A tensor numerator: ``float / tensor`` is reciprocal-then-multiply in
    # PyTorch, which is not the correctly rounded quotient the kernel uses.
    s = torch.full_like(x_min, n) / (x_max - x_min)
    z = torch.floor(s * x_min) + 2.0 ** (bits - 1.0)
    q = torch.clamp(torch.floor(s * xf - z), -n, n)
    return q, s, z


def dequantize(q: torch.Tensor, s: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    return (q + z + 0.5) / s  # +0.5: mid-rise reconstruction of the floor


def fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize-dequantize per channel (last axis, range over all other
    axes) with straight-through gradients; ``bits >= 32`` passes x
    through."""
    if bits >= 32:
        return x
    from ..kernels import ops
    if x.device.type != "cpu":
        return ops.fake_quant_ste(x, bits)
    xf = x.float()
    xq = ops.fused_fake_quant(xf, bits)
    # Straight-through estimator: forward quantized values, identity grad.
    return (xf + (xq - xf).detach()).to(x.dtype)


def fake_quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Weights: per-OUTPUT-channel range (last axis is the out dim here)."""
    return fake_quant(w, bits)


def fake_quant_act(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Activations: per-channel over the feature (last) axis."""
    return fake_quant(x, bits)


def slotted(bits) -> bool:
    """Whether a quant spec's bits are a batched spec's (K-tuples of host
    ints, or a [K] int32 device tensor) rather than one host int."""
    return isinstance(bits, (tuple, torch.Tensor))


def _all_pass(bits) -> bool:
    """Whether host bits pass every slot through (device bits: unknown)."""
    return not isinstance(bits, torch.Tensor) and min(bits) >= 32


def fake_quant_act_slots(x: torch.Tensor, bits) -> torch.Tensor:
    """Activations of K policies, x [K, rows, C]: slot k quantized at
    ``bits[k]`` (K host ints or a [K] int32 device tensor) with one range
    per channel over that slot's rows only; the straight-through forward
    value, in x's dtype."""
    if _all_pass(bits):
        return x
    from ..kernels import ops
    return ops.fake_quant_slots(x, bits)


def fake_quant_weight_slots(w: torch.Tensor, bits) -> torch.Tensor:
    """A weight w [R, C] shared by K policies, quantized at each slot's
    bits (per output channel, as ``fake_quant_weight``): [K, R, C]; a
    view of w itself (slot stride 0) where every slot passes it
    through."""
    shared = w.expand(len(bits), *w.shape)
    if _all_pass(bits):
        return shared
    from ..kernels import ops
    return ops.fake_quant_slots(shared, bits)


def bits_for_mode(mode: str, mix_bits: int = MAX_MIX_BITS) -> int:
    """Effective bits of a layer mode: FP32 32, INT8 8, MIX ``mix_bits``."""
    return {"FP32": 32, "INT8": 8, "MIX": mix_bits}[mode]
