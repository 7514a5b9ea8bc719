"""K6 wrapper: GQA attention with an online softmax, causal /
bidirectional / sliding window (``csrc/flash_attention.cu``; replaces the
JAX package's ``kernels/flash_attention.py::_flash_kernel``)."""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, H, S, D]; k, v [B, KV, S, D] (f32 or bf16, any strides:
    the kernel reads element strides, so transposed views need no copy)
    -> [B, H, S, D] in q's dtype, laid out like q. ``window=0`` is
    unlimited. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if q.device.type == "cpu":
        if k.device.type != "cpu" or v.device.type != "cpu":
            raise ValueError(f"flash_attention: q is on the CPU, k on "
                             f"{k.device}, v on {v.device}")
        return attention_ref(q, k, v, causal=causal, window=window)
    B, H, S, D = q.shape
    KV = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    for t, name, shape in ((q, "q", (B, H, S, D)), (k, "k", (B, KV, S, D)),
                           (v, "v", (B, KV, S, D))):
        build.check_operand(t, name, 4, q.dtype, contiguous=False)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} q heads over {KV} kv heads")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 16)(
        *(s for t in (q, k, v, out) for s in t.stride()))
    err = build.lib("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, H, KV, S, D, int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(D), int(causal), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
