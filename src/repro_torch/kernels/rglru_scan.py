"""K7 wrapper: the RG-LRU linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``
(``csrc/rglru_scan.cu``; replaces the JAX package's
``kernels/rglru_scan.py::_rglru_kernel``)."""
from __future__ import annotations

import torch

from . import build
from .ref import rglru_scan_ref

CHUNK = 128
MAX_CHUNKS = 65535          # the grid's y dimension


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0=None, *,
               chunk: int = CHUNK) -> torch.Tensor:
    """a, b [B, S, C] (f32 or bf16, one dtype, contiguous); h0 [B, C] f32
    or None (zero). Returns h [B, S, C] in a's dtype, f32 inside. The
    kernel walks chunks of ``chunk`` tokens in two passes around a short
    carry pass; ragged S and C are masked. A CPU tensor takes the plain
    version (the sequential ``ref.rglru_scan_ref``); a CUDA tensor
    launches the kernel or raises."""
    if a.device.type == "cpu":
        for t, name in ((b, "b"), (h0, "h0")):
            if t is not None and t.device.type != "cpu":
                raise ValueError(f"rglru_scan: a is on the CPU, {name} on "
                                 f"{t.device}")
        return rglru_scan_ref(a, b, h0)
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a: expected float32 or bfloat16, got {a.dtype}")
    B, S, C = a.shape
    build.check_operand(a, "a", 3, a.dtype)
    build.check_operand(b, "b", 3, a.dtype)
    if tuple(b.shape) != (B, S, C):
        raise ValueError(f"b: expected {(B, S, C)}, got {tuple(b.shape)}")
    if h0 is not None:
        build.check_operand(h0, "h0", 2)
        if tuple(h0.shape) != (B, C):
            raise ValueError(f"h0: expected {(B, C)}, got "
                             f"{tuple(h0.shape)}")
    nc = -(-S // chunk) if chunk >= 1 else 0
    if not (chunk >= 1 and nc <= MAX_CHUNKS and B <= MAX_CHUNKS):
        raise ValueError(f"rglru_scan: chunk {chunk} gives {nc} chunks "
                         f"(1 <= chunk, at most {MAX_CHUNKS} chunks and "
                         f"batch rows)")
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    # Scratch (each chunk's end state, its product of a, the state
    # entering it) is freed on return: the caching allocator hands its
    # memory only to work queued after these launches on the same stream.
    scratch = torch.empty((3, B, nc, C), dtype=torch.float32,
                          device=a.device)
    err = build.lib("rglru_scan").rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        scratch[2].data_ptr(), B, S, C, int(chunk),
        int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "rglru_scan")
    build.LAUNCHES["rglru_scan"] += 1
    return h
