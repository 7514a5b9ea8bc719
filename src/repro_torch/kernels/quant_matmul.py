"""K4 and K5 wrapper: the quantized matmul with the asymmetric dequant
epilogue (``csrc/quant_matmul.cu``; replaces the JAX package's
``kernels/quant_matmul.py::int8_matmul_kernel`` and
``int4_matmul_kernel``)."""
from __future__ import annotations

import torch

from . import build
from .ref import quant_matmul_ref


def quant_matmul(xq, wq, sx, zx, sw, zw, *, packed: bool = False,
                 k_true: int = 0) -> torch.Tensor:
    """xq [M, K] int8; wq [K, N] int8 (K4) or, with ``packed``, [K/2, N]
    packed int4 (K5); sx, zx [M] and sw, zw [N] f32. Returns f32 [M, N]:
    ``sx·sw·(acc + zx·Σwq + zw·Σxq + k_true·zx·zw)``. ``k_true``: the
    unpadded contraction length (0 = all of K). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
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
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    if M == 0 or N == 0:
        return out
    name = "quant_matmul_int4" if packed else "quant_matmul_int8"
    err = getattr(build.lib("quant_matmul"), f"{name}_launch")(
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), zx.data_ptr(),
        sw.data_ptr(), zw.data_ptr(), out.data_ptr(), M, N, K,
        int(k_true or K), torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return out
