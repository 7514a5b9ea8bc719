"""K2 and K3 wrappers: the fused 3-layer MLP forward (``csrc/mlp3.cu``)
and the flat Polyak update (``csrc/polyak.cu``), which replace the JAX
package's ``kernels/mlp_fused.py::_mlp3_kernel`` and ``_polyak_kernel``."""
from __future__ import annotations

import torch

from . import build
from .ref import mlp3_ref, polyak_ref


def mlp3(x, w1, b1, w2, b2, w3, b3, *, sigmoid: bool = False):
    """x [B, D0]; wi [D(i-1), Di]; bi [Di]. Returns ``(y, h1, h2)``.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if x.device.type == "cpu":
        return mlp3_ref(x, w1, b1, w2, b2, w3, b3, sigmoid)
    B, D0 = x.shape
    D1, D2, D3 = w1.shape[1], w2.shape[1], w3.shape[1]
    for t, name, shape in ((x, "x", (B, D0)), (w1, "w1", (D0, D1)),
                           (b1, "b1", (D1,)), (w2, "w2", (D1, D2)),
                           (b2, "b2", (D2,)), (w3, "w3", (D2, D3)),
                           (b3, "b3", (D3,))):
        build.check_operand(t, name, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
    y = torch.empty((B, D3), device=x.device, dtype=x.dtype)
    h1 = torch.empty((B, D1), device=x.device, dtype=x.dtype)
    h2 = torch.empty((B, D2), device=x.device, dtype=x.dtype)
    if B == 0:
        return y, h1, h2
    err = build.lib("mlp3").mlp3_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), y.data_ptr(),
        h1.data_ptr(), h2.data_ptr(), B, D0, D1, D2, D3, int(sigmoid),
        torch.cuda.current_stream(x.device).cuda_stream)
    # A launch whose activation tiles overflow a block's shared memory
    # (227 KB on Hopper) is refused by cudaFuncSetAttribute.
    build.check(err, f"mlp3 with widths {(D0, D1, D2)} (shared memory "
                f"is capped at 227 KB per block)")
    build.LAUNCHES["mlp3"] += 1
    return y, h1, h2


def polyak_flat(target: torch.Tensor, online: torch.Tensor,
                tau: float) -> torch.Tensor:
    """``(1 - tau) * target + tau * online`` over two flat f32 buffers,
    into a new buffer. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if target.device.type == "cpu":
        return polyak_ref(target, online, tau)
    build.check_operand(target, "target", 1)
    build.check_operand(online, "online", 1)
    if online.shape != target.shape:
        raise ValueError(f"online {tuple(online.shape)} != target "
                         f"{tuple(target.shape)}")
    out = torch.empty_like(target)
    n = target.numel()
    if n == 0:
        return out
    err = build.lib("polyak").polyak_launch(
        target.data_ptr(), online.data_ptr(), out.data_ptr(), n,
        1 - tau, tau, torch.cuda.current_stream(target.device).cuda_stream)
    build.check(err, "polyak")
    build.LAUNCHES["polyak"] += 1
    return out
