"""Deployment-mode quantization: store weights in integer containers.

The search evaluates ACCURACY with fake quant; deployment materializes a
policy as real int8 / packed-int4 weights, so the weight traffic of the
serving forward shrinks (what the latency oracle's container terms
model). ``models/layers.py::materialize_weight`` dequantizes them on the
fly into the consuming matmul.

Weight container formats (contraction axis = -2):
    {"w":  bf16/f32 [..., in, out]}                           — uncompressed
    {"w_q": int8 [..., in, out],    "w_scale": f32 [..., 1, out]} — int8
    {"w_p": int8 [..., in//2, out], "w_scale": f32 [..., 1, out]} — int4
Scales are per output channel (per layer: ``params["blocks"]`` is a list
of per-layer dicts, which the walk visits one by one, as the JAX
package's stacked tree gives each layer its own scales), and per expert
for an MoE layer's stacks ``w_up`` / ``w_gate`` [E, d, ff] and
``w_down`` [E, ff, d] (``w_scale`` [E, 1, out]).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ref import pack_int4, unpack_int4_ref


def quantize_weight(w: torch.Tensor, bits: int) -> dict:
    """Symmetric integer quantization along the contraction axis (-2).

    ``bits`` must be a Python int in [2, 8]. The grid honors the ASKED
    width — ``2**(bits-1) - 1`` positive levels; ``bits <= 4`` ships in
    the packed-int4 container (an even contraction dim is required),
    5..8 in the int8 one. Codes are clipped to [-qmax, qmax]."""
    if isinstance(bits, bool) or not isinstance(bits, (int, np.integer)) \
            or not 2 <= int(bits) <= 8:
        raise ValueError(
            f"quantize_weight: bits must be an int in [2, 8], got {bits!r}"
            " (FP32 layers keep their raw container; 1-bit deployment"
            " is unsupported)")
    bits = int(bits)
    if bits <= 4 and w.shape[-2] % 2 != 0:
        raise ValueError(
            f"quantize_weight: packed int4 needs an even contraction dim, "
            f"got shape {tuple(w.shape)}")
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.float()
    absmax = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True), 1e-8)
    # tensor / tensor: ``tensor / float`` is reciprocal-then-multiply on
    # the card, which can move a code across a rounding boundary
    scale = absmax / torch.full_like(absmax, qmax)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    if bits <= 4:
        return {"w_p": pack_int4(q), "w_scale": scale}
    return {"w_q": q, "w_scale": scale}


def unpack_int4_weight(packed: torch.Tensor) -> torch.Tensor:
    """[..., K//2, N] -> [..., K, N] int8 in [-8, 7] (row 2i = low
    nibble)."""
    return unpack_int4_ref(packed)


RAW_WEIGHT_NAMES = ("w_up", "w_gate", "w_down", "dense_w_up",
                    "dense_w_gate", "dense_w_down", "in_proj", "out_proj",
                    "w_x", "w_y", "w_out", "embed", "unembed")


def quantize_params_for_deploy(params, bits: int = 8,
                               raw_names=RAW_WEIGHT_NAMES, bits_for=None):
    """Convert every matmul weight in a params tree to integer storage:
    ``{"w": ...}`` linear dicts and raw named tensors (embeddings).

    ``bits_for``: optional callable ``name -> int | None`` giving a
    per-weight width keyed by the weight's name (the enclosing dict key
    for ``{"w": ...}`` containers, the tensor's own key for raw named
    weights). ``None`` or a value > 8 keeps that weight raw; otherwise
    the value overrides the uniform ``bits``. An odd contraction dim
    keeps a weight raw where int4 packing is asked."""

    def resolve(name):
        if bits_for is None:
            return bits
        b = bits_for(name)
        if b is None or b > 8:
            return None
        return max(2, int(b))

    def packable(v, b):
        return b is not None and (b > 4 or v.shape[-2] % 2 == 0)

    def walk(node, name=""):
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) >= 2:
                b = resolve(name)
                if packable(node["w"], b):
                    out = {k: v for k, v in node.items() if k != "w"}
                    out.update(quantize_weight(node["w"], b))
                    return out
                return dict(node)
            out = {}
            for k, v in node.items():
                b = resolve(k)
                if k in raw_names and getattr(v, "ndim", 0) >= 2 \
                        and packable(v, b):
                    out[k] = quantize_weight(v, b)
                else:
                    out[k] = walk(v, k)
            return out
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        return node

    return walk(params)


def deployed_bytes(params) -> int:
    """Bytes of every tensor in a (possibly deployed) params tree."""
    if isinstance(params, dict):
        return sum(deployed_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(deployed_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
