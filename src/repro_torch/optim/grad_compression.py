"""Gradient compression with error feedback (the JAX package's
``optim/grad_compression.py``): int8 uniform quantization with one scale
per leaf, or top-k magnitude sparsification, each optionally adding the
previous step's residual first (Karimireddy et al. 2019, "Error Feedback
Fixes SignSGD"). The compressed gradients stay dense tensors; the
traffic they would save across a slower link is modelled, not sent.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .optimizer import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class GradCompressionConfig:
    kind: str = "none"                 # none|int8|topk
    topk_frac: float = 0.01
    error_feedback: bool = True


def init_residual(params):
    """A zero residual per leaf, in the leaf's dtype."""
    return tree_unflatten(params, [torch.zeros_like(p)
                                   for p in tree_leaves(params)])


def _int8_compress(g: torch.Tensor):
    # a tensor divisor: on CUDA ``tensor / float`` multiplies by the
    # reciprocal, which is not the correctly rounded quotient
    scale = torch.amax(torch.abs(g)) / torch.tensor(127.0, device=g.device) \
        + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(g) >= thresh).to(g.dtype)


def compress_grads(grads, residual, cfg: GradCompressionConfig):
    """Returns (compressed but dense grads, new residual)."""
    if cfg.kind == "none":
        return grads, residual

    def one(g, r):
        g32 = g.float()
        if cfg.error_feedback:
            g32 = g32 + r.float()
        if cfg.kind == "int8":
            out = _int8_decompress(*_int8_compress(g32))
        elif cfg.kind == "topk":
            out = g32 * _topk_mask(g32, cfg.topk_frac)
        else:
            raise ValueError(cfg.kind)
        new_r = (g32 - out) if cfg.error_feedback else r
        return out.to(g.dtype), new_r.to(r.dtype)

    pairs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                       tree_leaves(residual))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            tree_unflatten(residual, [p[1] for p in pairs]))
