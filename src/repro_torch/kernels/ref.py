"""Plain PyTorch versions of the hand-written kernels.

Each is the function its kernel computes, written as ordinary tensor ops
(one PyTorch kernel per op on the card). The wrappers use them for CPU
tensors; the tests hold them against the JAX package, and ``chip_smoke.py``
holds each kernel against them on the card.
"""
from __future__ import annotations

import torch


def fake_quant_ref(x: torch.Tensor, bits: int) -> torch.Tensor:
    """K1's function: x [R, C] f32 -> quantize-dequantize with the range of
    each channel (last axis) reduced over the rows; ``bits >= 32`` passes
    x through. The arithmetic of ``core.quantization.quantize`` /
    ``dequantize`` (the JAX package's ``fake_quant`` before its STE)."""
    from ..core.quantization import dequantize, quantize
    if bits >= 32:
        return x.clone()
    q, s, z = quantize(x, min(max(int(bits), 1), 31), dims=(0,))
    return dequantize(q, s, z)


def mlp3_ref(x, w1, b1, w2, b2, w3, b3, sigmoid: bool):
    """K2's function: the 3-layer trunk, returning (y, h1, h2)."""
    h1 = torch.relu(x @ w1 + b1)
    h2 = torch.relu(h1 @ w2 + b2)
    y = h2 @ w3 + b3
    return (torch.sigmoid(y) if sigmoid else y), h1, h2


def polyak_ref(target: torch.Tensor, online: torch.Tensor,
               tau: float) -> torch.Tensor:
    """K3's function: ``(1 - tau) * target + tau * online``, the tree-map
    soft update of the JAX package's ``ddpg.polyak_update``."""
    return (1 - tau) * target + tau * online
