"""K6 wrapper: GQA attention with an online softmax, causal /
bidirectional / sliding window (``csrc/flash_attention.cu``; replaces the
JAX package's ``kernels/flash_attention.py::_flash_kernel``).

Two routes, chosen here and nowhere else (``route``): bf16 at head dim
64, 80 (hubert-xlarge: a 64-column and a 16-column TMA box per row), 128
or 256 takes the tensor-core kernel (wgmma, TMA-fed tiles); f32, and
bf16 at head dims 16 and 32, the CUDA-core template."""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
TC_HEAD_DIMS = (64, 80, 128, 256)
# flash_attention_tc_launch's codes past the cudaError_t range
_NO_ENCODE_ENTRY, _ENCODE_ERROR = 1999, 2000


def route(dtype: torch.dtype, head_dim: int) -> str:
    """"tc" (tensor cores: wgmma on TMA-fed tiles) for bf16 at head dim
    64, 80, 128 or 256; "simt" (f32 FMAs on the CUDA cores) otherwise —
    f32 must keep its 2e-5 parity, which the tensor cores' TF32 would
    not."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def check_tma_terms(t: torch.Tensor, name: str) -> None:
    """What a TMA tensor map takes of a bf16 [B, NH, S, D] view: d-stride
    1, every other stride a multiple of 8 elements (16 bytes; a dim of
    size 1 is never stepped, so its stride is free), a 16-byte aligned
    base. Raises ValueError naming the term that fails; never copies."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the tensor-core route's TMA needs "
                         f"d-stride 1, got {t.stride(-1)}")
    for dim, (n, s) in enumerate(zip(t.shape[:-1], t.stride()[:-1])):
        if n > 1 and s % 8:
            raise ValueError(f"{name}: the tensor-core route's TMA needs "
                             f"strides in multiples of 8 elements (16 "
                             f"bytes); dim {dim} has stride {s}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the tensor-core route's TMA needs a "
                         f"16-byte aligned base address, got "
                         f"{t.data_ptr():#x}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, H, S, D]; k, v [B, KV, S, D] (f32 or bf16; strided views
    such as the layer's [B,S,H,D] seen through a transpose need no copy)
    -> [B, H, S, D] in q's dtype, laid out like q. ``window=0`` is
    unlimited. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel of its ``route`` or raises."""
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
    path = route(q.dtype, D)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if path == "tc":    # out has q's strides or is contiguous: it passes
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            check_tma_terms(t, name)
    strides = (ctypes.c_longlong * 16)(
        *(s for t in (q, k, v, out) for s in t.stride()))
    lib = build.lib("flash_attention")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, H, KV, S, D)
    tail = (1.0 / math.sqrt(D), int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if path == "tc":
        err = lib.flash_attention_tc_launch(*args, *tail)
        if err == _NO_ENCODE_ENTRY:
            raise RuntimeError("flash_attention_tc: the driver has no "
                               "cuTensorMapEncodeTiled")
        if err >= _ENCODE_ERROR:
            raise RuntimeError(f"flash_attention_tc: cuTensorMapEncodeTiled "
                               f"failed with CUresult {err - _ENCODE_ERROR}")
        build.check(err, "flash_attention_tc")
    else:
        err = lib.flash_attention_launch(*args, int(q.dtype == torch.bfloat16),
                                         *tail)
        build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    if path == "tc":
        build.LAUNCHES["flash_attention_tc"] += 1
    return out
