"""K7 wrapper: the RG-LRU linear recurrence ``h_t = a_t ⊙ h_{t-1} + b_t``
(``csrc/rglru_scan.cu``; replaces the JAX package's
``kernels/rglru_scan.py::_rglru_kernel``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .ref import rglru_scan_ref

CHUNK = 128
SLAB = 128                  # channels per tile: threads per block (one
                            # block per SM in f32 at CHUNK 128)
SMEM_BYTES = 232448 - 1024  # dynamic shared memory a block may take
MAX_TILES = 2 ** 31 - 1     # the grid's x dimension


class Plan(NamedTuple):
    slab: int               # channels per tile (threads per block)
    n_slabs: int
    n_chunks: int
    tiles: int              # blocks of the one launch, one per tile
    smem_bytes: int         # one tile of a and b in shared memory
    state_words: int        # 64-bit words: the state leaving each chunk
                            # but the last, per (batch row, channel)


def plan(B: int, S: int, C: int, chunk: int, itemsize: int,
         slab: int = 0) -> Plan:
    """K7's one launch for a, b [B, S, C] of ``itemsize`` bytes: a tile
    per (chunk of ``chunk`` tokens, batch row, slab of ``slab`` channels,
    by default ``SLAB`` or the widest multiple of 32 below it whose tile
    fits), its a and b held in shared memory; raises where a tile of 32
    channels does not fit a block or the tiles overflow the grid."""
    if chunk < 1:
        raise ValueError(f"rglru_scan: chunk {chunk} < 1")
    if not slab:
        slab = max(32, min(SLAB, SMEM_BYTES // (2 * chunk * itemsize)
                           // 32 * 32))
    n_chunks, n_slabs = _cdiv(S, chunk), _cdiv(C, slab)
    smem = 2 * chunk * slab * itemsize
    if smem > SMEM_BYTES:
        raise ValueError(f"rglru_scan: chunk {chunk} needs {smem} bytes of "
                         f"shared memory per tile of {slab} channels "
                         f"(at most {SMEM_BYTES})")
    tiles = n_chunks * B * n_slabs
    if tiles > MAX_TILES:
        raise ValueError(f"rglru_scan: chunk {chunk} gives {tiles} tiles "
                         f"(at most {MAX_TILES})")
    return Plan(slab, n_slabs, n_chunks, tiles, smem,
                max(0, n_chunks - 1) * B * C)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# Per (device index, stream): [int64 tensor, the last epoch]. Word 0 is
# the ticket (its low 32 bits; the kernel leaves it at zero), the rest
# the state words. Zeroed once when made or grown; each call then takes
# a new epoch, so no call needs a memset. One per stream: calls on one
# stream run in order and never share their words.
_WORK: dict = {}


def _workspace(device: torch.device, stream: int, words: int) -> tuple:
    key = (device.index, stream)
    w = _WORK.get(key)
    if w is None or w[0].numel() < 1 + words or w[1] >= 2 ** 32 - 1:
        size = max(1 + words, 0 if w is None else 2 * w[0].numel())
        w = _WORK[key] = [torch.zeros(size, dtype=torch.int64,
                                      device=device), 0]
    w[1] += 1
    return w[0], w[1]


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0=None, *,
               chunk: int = CHUNK) -> torch.Tensor:
    """a, b [B, S, C] (f32 or bf16, one dtype, contiguous); h0 [B, C] f32
    or None (zero). Returns h [B, S, C] in a's dtype, f32 inside. One
    launch: each tile of ``chunk`` tokens is read once, walked, handed
    the state leaving the chunk before it down a chain of flags, and
    walked again to write h (``plan``); ragged S and C are masked. A CPU
    tensor takes the plain version (the sequential
    ``ref.rglru_scan_ref``); a CUDA tensor launches the kernel or
    raises."""
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
    p = plan(B, S, C, chunk, a.element_size())
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    stream = torch.cuda.current_stream(a.device).cuda_stream
    work, epoch = _workspace(a.device, stream, p.state_words)
    err = build.lib("rglru_scan").rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), work[1:].data_ptr(), work.data_ptr(), B, S, C,
        int(chunk), p.slab, epoch, int(a.dtype == torch.bfloat16), stream)
    build.check(err, "rglru_scan")
    build.LAUNCHES["rglru_scan"] += 1
    return h
