"""K1 wrapper: per-channel fake quantization of a 2-D f32, bf16 or f16
tensor (``csrc/fake_quant.cu``; replaces the JAX package's
``kernels/fake_quant.py::fake_quant_kernel``), plain or with the
straight-through forward value fused in; and of K policy slots at once
(``fake_quant_slots``: [K, R, C], each slot at its own bits with its own
range, what ``vmap`` makes of the TPU kernel in the batched validation),
its bits host ints or, in ``fake_quant_slots_dev``, a [K] int32 tensor on
the card that the kernel reads (the TPU kernel's ``bits_ref``)."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import build
from .ref import fake_quant_ref, fake_quant_slots_ref, fake_quant_ste_ref

SMS = 132                   # streaming multiprocessors of an H100 SXM
THREADS = 256               # FQ_THREADS
LANES = 8                   # FQ_LANES: threads of 16 bytes per row segment
ROWS = THREADS // LANES     # rows a block walks per step
TARGET_BLOCKS = 8 * SMS     # blocks to aim for: ~8 per SM, a short tail
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_SLOTS = 64              # FQ_MAX_SLOTS: policy slots per launch


class Plan(NamedTuple):
    n_ctiles: int           # channel tiles of LANES x 16 bytes
    n_slabs: int            # row slabs; one: a single fused launch
    slab_rows: int          # rows per slab, a multiple of ROWS
    fused: bool             # one launch (one slab) or two


@functools.lru_cache(maxsize=512)
def plan(R: int, C: int, itemsize: int, slots: int = 1) -> Plan:
    """K1's grid for x [R, C] of ``itemsize`` bytes (each of ``slots``
    policy slots): (row slab x channel tile) blocks per slot, enough
    slabs to put ~8 blocks on every SM over all the slots, but no more
    than keep pass 2's fold (each block reads every slab's min and max
    of its channels, 8 bytes per slab) within an eighth of a slab's own
    bytes: n_slabs^2 <= R * itemsize / 64."""
    n_ctiles = _cdiv(C, LANES * (16 // itemsize))
    cap = max(1, math.isqrt(R * itemsize // 64))
    want = max(1, min(_cdiv(TARGET_BLOCKS, n_ctiles * slots), cap))
    slab_rows = _cdiv(_cdiv(R, want), ROWS) * ROWS
    n_slabs = _cdiv(R, slab_rows)
    return Plan(n_ctiles, n_slabs, slab_rows, n_slabs == 1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vector_ok(x: torch.Tensor) -> bool:
    """Whether K1 may read x with 16-byte loads: x on 16 bytes, its width
    and every stride but the channel's (rows, slots) multiples of the
    16-byte vector (else the kernels' scalar path)."""
    n = 16 // x.element_size()
    return (x.data_ptr() % 16 == 0 and x.shape[-1] % n == 0
            and all(x.stride(i) % n == 0 for i in range(x.dim() - 1)))


def fake_quant_2d(x: torch.Tensor, bits: int,
                  ste: bool = False) -> torch.Tensor:
    """x [R, C] f32, bf16 or f16 (unit channel stride; a row-sliced view is
    read in place): quantize-dequantize with per-channel (last axis)
    range reduced over the rows, returned in x's dtype. ``ste``: return
    the straight-through forward value ``xf + (xq - xf)`` instead (the
    arithmetic of ``core.quantization.fake_quant``). ``bits`` is a host
    int; >= 32 copies x. The grid is ``plan``'s. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return fake_quant_ste_ref(x, bits) if ste else fake_quant_ref(x, bits)
    if x.dtype not in DTYPES:
        raise TypeError(f"x: expected float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    build.check_operand(x, "x", 2, dtype=x.dtype, contiguous=False)
    R, C = x.shape
    if x.stride(1) != 1 and C > 1 or x.stride(0) < C and R > 1:
        raise ValueError(f"x: expected unit channel stride and rows apart "
                         f"by >= C, got strides {x.stride()}")
    out = torch.empty((R, C), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    p = plan(R, C, x.element_size())
    part = torch.empty(0 if p.fused or bits >= 32 else 2 * p.n_slabs * C,
                       dtype=torch.float32, device=x.device)
    err = build.lib("fake_quant").fake_quant_launch(
        x.data_ptr(), out.data_ptr(), part.data_ptr() or None,
        x.stride(0) if R > 1 else C, R, C, int(bits),
        DTYPES[x.dtype], int(ste), p.n_slabs, p.slab_rows,
        int(vector_ok(x)), int(p.fused),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fake_quant")
    build.LAUNCHES["fake_quant"] += 1
    return out


def fake_quant_slots(x: torch.Tensor, bits, ste: bool = False
                     ) -> torch.Tensor:
    """x [K, R, C] f32, bf16 or f16: K policy slots, each quantized as
    ``fake_quant_2d`` would quantize it alone, at its own ``bits[k]`` (K
    host ints, at most ``MAX_SLOTS``; >= 32 copies the slot) with its own
    per-channel range over its R rows, into a new contiguous [K, R, C]
    of x's dtype. A slot stride of 0 (``w.expand(K, R, C)``) is one
    tensor, a weight, shared by every slot: its range is reduced once.
    Rows need unit channel stride (a row-sliced view is read in place).
    One launch of the grid ``plan(R, C, itemsize, K)`` per call,
    whatever the bits, for up to ``MAX_SLOTS`` slots; more slots are cut
    into launches of at most ``MAX_SLOTS`` each (``launches``). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    bits = tuple(int(b) for b in bits)
    K = len(bits)
    if x.dim() != 3 or x.shape[0] != K:
        raise ValueError(f"x: expected [K, R, C] with K = {K} slots, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return fake_quant_slots_ref(x, bits, ste)
    if x.dtype not in DTYPES:
        raise TypeError(f"x: expected float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    build.check_operand(x, "x", 3, dtype=x.dtype, contiguous=False)
    _, R, C = x.shape
    if x.stride(2) != 1 and C > 1 or x.stride(1) < C and R > 1:
        raise ValueError(f"x: expected unit channel stride and rows apart "
                         f"by >= C, got strides {x.stride()}")
    out = torch.empty((K, R, C), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    for k0, k1 in launches(K):
        _slots_launch(x[k0:k1], out[k0:k1], bits[k0:k1], ste)
    return out


def launches(K: int) -> list:
    """The (first, end) slots of each K1 launch over K policy slots: one
    launch for up to ``MAX_SLOTS``, else runs of ``MAX_SLOTS`` and the
    rest (a population's validation of P·K policies)."""
    return [(k, min(K, k + MAX_SLOTS)) for k in range(0, K, MAX_SLOTS)]


def _slots_launch(x, out, bits: tuple, ste: bool) -> None:
    """One launch of ``fake_quant_slots`` over at most ``MAX_SLOTS`` slots
    of x into ``out`` (contiguous)."""
    K, R, C = x.shape
    sld = x.stride(0) if K > 1 else 0
    p = plan(R, C, x.element_size(), K)
    part = torch.empty(
        0 if p.fused or min(bits) >= 32
        else (K if sld else 1) * 2 * p.n_slabs * C,
        dtype=torch.float32, device=x.device)
    err = build.lib("fake_quant").fake_quant_slots_launch(
        x.data_ptr(), out.data_ptr(), part.data_ptr() or None,
        x.stride(1) if R > 1 else C, sld, K, R, C, (ctypes.c_int * K)(*bits),
        DTYPES[x.dtype], int(ste), p.n_slabs, p.slab_rows,
        int(vector_ok(x)), int(p.fused),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fake_quant_slots")
    build.LAUNCHES["fake_quant_slots"] += 1


def fake_quant_slots_dev(x: torch.Tensor, bits: torch.Tensor,
                         ste: bool = False) -> torch.Tensor:
    """``fake_quant_slots`` with the K bits a [K] int32 tensor on x's
    device, read by the kernel: nothing the host does depends on their
    values, so the call can sit in a captured CUDA graph whose policies
    never leave the card. The grid is ``plan(R, C, itemsize, K)``'s, as
    for host bits; the scratch is sized for every slot quantizing; a
    slot at >= 32 bits is copied by the kernel; more than ``MAX_SLOTS``
    slots are cut into launches as ``fake_quant_slots`` cuts them. Bit-
    equal to ``fake_quant_slots`` at the same bits. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    K = bits.shape[0] if bits.dim() == 1 else -1
    if x.dim() != 3 or x.shape[0] != K:
        raise ValueError(f"x: expected [K, R, C] and bits [K], got "
                         f"{tuple(x.shape)} and {tuple(bits.shape)}")
    if x.device.type == "cpu":
        return fake_quant_slots_ref(x, bits, ste)
    if x.dtype not in DTYPES:
        raise TypeError(f"x: expected float32, bfloat16 or float16, got "
                        f"{x.dtype}")
    if bits.dtype != torch.int32 or bits.device != x.device \
            or bits.stride(0) != 1:
        raise ValueError(f"bits: expected contiguous int32 on {x.device}, "
                         f"got {bits.dtype} on {bits.device} with stride "
                         f"{bits.stride()}")
    build.check_operand(x, "x", 3, dtype=x.dtype, contiguous=False)
    _, R, C = x.shape
    if x.stride(2) != 1 and C > 1 or x.stride(1) < C and R > 1:
        raise ValueError(f"x: expected unit channel stride and rows apart "
                         f"by >= C, got strides {x.stride()}")
    out = torch.empty((K, R, C), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    for k0, k1 in launches(K):
        xs, os_ = x[k0:k1], out[k0:k1]
        n = k1 - k0
        sld = xs.stride(0) if n > 1 else 0
        p = plan(R, C, x.element_size(), n)
        part = torch.empty(0 if p.fused else (n if sld else 1) * 2
                           * p.n_slabs * C, dtype=torch.float32,
                           device=x.device)
        err = build.lib("fake_quant").fake_quant_slots_dev_launch(
            xs.data_ptr(), os_.data_ptr(), part.data_ptr() or None,
            x.stride(1) if R > 1 else C, sld, n, R, C,
            bits[k0:k1].data_ptr(), DTYPES[x.dtype], int(ste), p.n_slabs,
            p.slab_rows, int(vector_ok(xs)), int(p.fused),
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "fake_quant_slots_dev")
        build.LAUNCHES["fake_quant_slots_dev"] += 1
    return out
