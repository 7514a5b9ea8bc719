"""K8 wrapper: the Mamba-2 chunked SSD scan (``csrc/ssd_scan.cu``;
replaces the JAX package's ``kernels/ssd_scan.py::_ssd_kernel``), with
two routes chosen by shape (``route``)."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ssd_chunked_ref

MAX_HEAD_DIM = 64
MAX_STATE = 256
MAX_CHUNK = 1024
TC_HEAD_DIM = 64
TC_STATES = (64, 128)
TC_TILE = 64


def route(P: int, N: int, chunk: int) -> str:
    """"tc" (tensor cores: wgmma in split TF32 on TMA-fed tiles) for head
    dim 64, state 64 or 128 and a chunk that is a multiple of 64 (the
    mamba2 family's full-width shapes); "simt" (f32 FMAs on the CUDA
    cores) otherwise."""
    if P == TC_HEAD_DIM and N in TC_STATES and chunk % TC_TILE == 0:
        return "tc"
    return "simt"


def check_tma_terms(t: torch.Tensor, name: str) -> None:
    """What a TMA tensor map takes of an f32 view: last stride 1, every
    other stride a multiple of 4 elements (16 bytes; a dim of size 1 is
    never stepped), a 16-byte aligned base. Raises ValueError naming the
    term that fails; never copies."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the tensor-core route's TMA needs its "
                         f"last stride 1, got {t.stride(-1)}")
    for dim, (n, st) in enumerate(zip(t.shape[:-1], t.stride()[:-1])):
        if n > 1 and st % 4:
            raise ValueError(f"{name}: the tensor-core route's TMA needs "
                             f"strides in multiples of 4 elements (16 "
                             f"bytes); dim {dim} has stride {st}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the tensor-core route's TMA needs a "
                         f"16-byte aligned base address, got "
                         f"{t.data_ptr():#x}")


def ssd_scan(xh: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int = 256):
    """xh [B,S,H,P] (dt-scaled inputs) and dA [B,S,H] (log decays),
    contiguous; Bm, Cm [B,S,N] with a contiguous last dim (views of a
    wider tensor are read with their strides); all f32. Returns (y
    [B,S,H,P], final state [B,H,P,N]) from a zero state. A ragged S is
    masked in the kernel. ``route`` picks the kernel by shape; on the
    tensor-core route a view TMA cannot read raises ValueError (it is
    never copied). A CPU tensor takes the plain version (the
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
    tc = route(P, N, chunk) == "tc"
    if tc:
        for t, name in ((xh, "xh"), (Bm, "Bm"), (Cm, "Cm")):
            check_tma_terms(t, name)
    y = torch.empty_like(xh)
    fin = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    # Scratch (cumulative decays, chunk decays, chunk states and, on the
    # tensor-core route, the C Bᵀ tiles) is freed on return: the caching
    # allocator hands its memory only to work queued after these launches
    # on the same stream.
    nc = -(-S // chunk)
    acs = torch.empty((B, H, S), dtype=torch.float32, device=xh.device)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=xh.device)
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32,
                         device=xh.device)
    strides = (ctypes.c_longlong * 4)(Bm.stride(0), Bm.stride(1),
                                      Cm.stride(0), Cm.stride(1))
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    lib = build.lib("ssd_scan")
    if tc:
        nt = chunk // TC_TILE
        cb = torch.empty((B, nc, nt * (nt + 1) // 2, TC_TILE * TC_TILE),
                         dtype=torch.float32, device=xh.device)
        err = lib.ssd_scan_tc_launch(
            xh.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            strides, y.data_ptr(), fin.data_ptr(), acs.data_ptr(),
            decay.data_ptr(), states.data_ptr(), cb.data_ptr(), B, S, H, P,
            N, int(chunk), stream)
        build.check(err, f"ssd_scan (tensor-core route) at {(B, S, H, P, N)}"
                    f" chunk {chunk}")
        build.LAUNCHES["ssd_scan_tc"] += 1
    else:
        err = lib.ssd_scan_launch(
            xh.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            strides, y.data_ptr(), fin.data_ptr(), acs.data_ptr(),
            decay.data_ptr(), states.data_ptr(), B, S, H, P, N, int(chunk),
            stream)
        build.check(err, "ssd_scan")
    build.LAUNCHES["ssd_scan"] += 1
    return y, fin
