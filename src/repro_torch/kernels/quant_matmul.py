"""K4 and K5 wrapper: the quantized matmul with the asymmetric dequant
epilogue (``csrc/quant_matmul.cu``; replaces the JAX package's
``kernels/quant_matmul.py::int8_matmul_kernel`` and
``int4_matmul_kernel``).

Two routes, chosen here and nowhere else (``route``): where TMA can read
both code matrices (K and N multiples of 16, 16-byte aligned bases) the
tensor-core kernel (s8 wgmma on TMA-fed tiles, split K over a thread-block
cluster as ``plan`` says); every other shape the CUDA-core kernel."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .ref import quant_matmul_ref

TILE = 128              # the tensor-core route's output tile and K tile
SMS = 132               # streaming multiprocessors of an H100 SXM
SPLITS = (1, 2, 4, 8)   # blocks per cluster that share an output tile
SPLIT_COST = 3          # the cluster's reduction, in K tiles' time
# the deepest load ring that fits 227 KB of shared memory: K4 stages 32 KB
# (xq and w tiles), K5 24 KB, beside the converted ring's 48 / 64 KB
MAX_STAGES = {False: 5, True: 6}
MAX_K = 131_071         # |acc| <= K * 2^14 must stay below 2^31
# quant_matmul_tc_launch's codes past the cudaError_t range
_NO_ENCODE_ENTRY, _ENCODE_ERROR = 1999, 2000


class Plan(NamedTuple):
    tiles_m: int
    tiles_n: int
    k_tiles: int
    split: int          # blocks per cluster, each a slice of the K tiles
    stages: int         # depth of the TMA load ring (2 .. MAX_STAGES)
    blocks: int


def route(M: int, K: int, N: int, packed: bool, xq=None, wq=None) -> str:
    """"tc" (tensor cores: s8 wgmma on TMA-fed tiles) where TMA can read
    the codes: K > 0, K and N multiples of 16 (row strides of 16 bytes,
    packed or not) and, for the tensors given, 16-byte aligned bases;
    "simt" (``__dp4a`` on the CUDA cores) otherwise — the JAX tests'
    ragged N, a K that is not a multiple of 16, an odd K padded for int4.
    Both compute the same bits."""
    if K <= 0 or K % 16 or N % 16:
        return "simt"
    for t in (xq, wq):
        if t is not None and t.data_ptr() % 16:
            return "simt"
    return "tc"


def plan(M: int, K: int, N: int, packed: bool = False,
         split: int = 0) -> Plan:
    """The tensor-core route's grid: 128 x 128 output tiles, K in tiles
    of 128 codes, one block per SM. ``split`` (0: choose) blocks of a
    cluster share a tile, each a balanced slice of the K tiles, summed
    through distributed shared memory. The cluster's reduction costs about
    ``SPLIT_COST`` K tiles' time, so a split is chosen only where the
    tiles leave most SMs idle: the largest split that keeps the grid
    within one wave of ``SMS`` and saves each block at least that many K
    tiles (at the testbed's (192, 1024, 256): 8; at 256³, 2 K tiles: 1).
    Stages: the K tiles a block walks, within 2 .. ``MAX_STAGES``."""
    if K > MAX_K:
        raise ValueError(f"quant_matmul: K {K} > {MAX_K}: the int32 "
                         f"accumulator could overflow")
    tiles_m, tiles_n = -(-M // TILE), -(-N // TILE)
    k_tiles = -(-K // TILE)
    tiles = tiles_m * tiles_n
    if not split:
        split = max(s for s in SPLITS
                    if s == 1 or (tiles * s <= SMS and s <= k_tiles
                                  and k_tiles - -(-k_tiles // s)
                                  >= SPLIT_COST))
    if split not in SPLITS or split > max(k_tiles, 1):
        raise ValueError(f"quant_matmul: split {split} not in {SPLITS} or "
                         f"above the {k_tiles} K tiles")
    stages = min(MAX_STAGES[bool(packed)], max(2, -(-k_tiles // split)))
    return Plan(tiles_m, tiles_n, k_tiles, split, stages, tiles * split)


def quant_matmul(xq, wq, sx, zx, sw, zw, *, packed: bool = False,
                 k_true: int = 0) -> torch.Tensor:
    """xq [M, K] int8; wq [K, N] int8 (K4) or, with ``packed``, [K/2, N]
    packed int4 (K5); sx, zx [M] and sw, zw [N] f32. Returns f32 [M, N]:
    ``sx·sw·(acc + zx·Σwq + zw·Σxq + k_true·zx·zw)``. ``k_true``: the
    unpadded contraction length (0 = all of K). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel of its ``route`` or
    raises."""
    if xq.device.type == "cpu":
        return quant_matmul_ref(xq, wq, sx, zx, sw, zw, packed, k_true)
    M, K = xq.shape
    N = wq.shape[1]
    if packed and K % 2:
        raise ValueError(f"packed int4 needs an even K, got {K}")
    rows = K // 2 if packed else K
    for t, name, shape, dtype in (
            (xq, "xq", (M, K), torch.int8), (wq, "wq", (rows, N), torch.int8),
            (sx, "sx", (M,), torch.float32), (zx, "zx", (M,), torch.float32),
            (sw, "sw", (N,), torch.float32), (zw, "zw", (N,), torch.float32)):
        build.check_operand(t, name, len(shape), dtype)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
    if K > MAX_K:
        raise ValueError(f"quant_matmul: K {K} > {MAX_K}: the int32 "
                         f"accumulator could overflow")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if M == 0 or N == 0:
        return out
    name = "quant_matmul_int4" if packed else "quant_matmul_int8"
    lib = build.lib("quant_matmul")
    args = (xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), zx.data_ptr(),
            sw.data_ptr(), zw.data_ptr(), out.data_ptr(), M, N, K,
            int(k_true or K))
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    if route(M, K, N, packed, xq, wq) == "tc":
        p = plan(M, K, N, packed)
        err = lib.quant_matmul_tc_launch(*args, int(packed), p.split,
                                         p.stages, stream)
        if err == _NO_ENCODE_ENTRY:
            raise RuntimeError("quant_matmul_tc: the driver has no "
                               "cuTensorMapEncodeTiled")
        if err >= _ENCODE_ERROR:
            raise RuntimeError(f"quant_matmul_tc: cuTensorMapEncodeTiled "
                               f"failed with CUresult {err - _ENCODE_ERROR}")
        build.check(err, f"{name} (tensor-core route) at {(M, K, N)}")
        build.LAUNCHES["quant_matmul_tc"] += 1
    else:
        err = getattr(lib, f"{name}_launch")(*args, stream)
        build.check(err, name)
    build.LAUNCHES[name] += 1
    return out
