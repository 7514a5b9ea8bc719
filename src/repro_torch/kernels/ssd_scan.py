"""K8 wrapper: the Mamba-2 chunked SSD scan (``csrc/ssd_scan.cu``;
replaces the JAX package's ``kernels/ssd_scan.py::_ssd_kernel``)."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ssd_chunked_ref

MAX_HEAD_DIM = 64
MAX_STATE = 256
MAX_CHUNK = 1024


def ssd_scan(xh: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256):
    """xh [B,S,H,P] (dt-scaled inputs) and dA [B,S,H] (log decays),
    contiguous; Bm, Cm [B,S,N] with a contiguous last dim (views of a
    wider tensor are read with their strides); all f32. Returns (y
    [B,S,H,P], final state [B,H,P,N]) from a zero state. A ragged S is
    masked in the kernel. A CPU tensor takes the plain version (the
    chunked form, ``ref.ssd_chunked_ref``); a CUDA tensor launches the
    kernel or raises."""
    if xh.device.type == "cpu":
        for t, name in ((dA, "dA"), (Bm, "Bm"), (Cm, "Cm")):
            if t.device.type != "cpu":
                raise ValueError(f"ssd_scan: xh is on the CPU, {name} on "
                                 f"{t.device}")
        return ssd_chunked_ref(xh, dA, Bm, Cm, chunk)
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    for t, name, shape, contiguous in (
            (xh, "xh", (B, S, H, P), True), (dA, "dA", (B, S, H), True),
            (Bm, "Bm", (B, S, N), False), (Cm, "Cm", (B, S, N), False)):
        build.check_operand(t, name, len(shape), contiguous=contiguous)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
        if not contiguous and t.stride(-1) != 1:
            raise ValueError(f"{name}: the state dim must be contiguous")
    if not (1 <= P <= MAX_HEAD_DIM and 4 <= N <= MAX_STATE and N % 4 == 0
            and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan: head dim {P} (<= {MAX_HEAD_DIM}), "
                         f"state {N} (a multiple of 4, <= {MAX_STATE}) or "
                         f"chunk {chunk} (<= {MAX_CHUNK}) out of range")
    y = torch.empty_like(xh)
    fin = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    # Scratch (cumulative decays, chunk decays, chunk states) is freed on
    # return: the caching allocator hands its memory only to work queued
    # after these launches on the same stream.
    nc = -(-S // chunk)
    acs = torch.empty((B, H, S), dtype=torch.float32, device=xh.device)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=xh.device)
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32,
                         device=xh.device)
    strides = (ctypes.c_longlong * 4)(Bm.stride(0), Bm.stride(1),
                                      Cm.stride(0), Cm.stride(1))
    err = build.lib("ssd_scan").ssd_scan_launch(
        xh.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), strides,
        y.data_ptr(), fin.data_ptr(), acs.data_ptr(), decay.data_ptr(),
        states.data_ptr(), B, S, H, P, N, int(chunk),
        torch.cuda.current_stream(xh.device).cuda_stream)
    build.check(err, "ssd_scan")
    build.LAUNCHES["ssd_scan"] += 1
    return y, fin
