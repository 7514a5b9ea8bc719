"""Wrapper of the fused Adam + Polyak pass (``csrc/adam_polyak.cu``): one
launch updates every stacked leaf of one network of a population in place
(the Adam step with the bias correction folded into per-member scalars,
then the soft target update). It replaces no Pallas kernel: the JAX
package computes the pass (``core/ddpg.py::_fused_adam_polyak``) with jnp
outside any kernel."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import fused_adam_polyak_ref

MAX_LEAVES = 16     # the kernel's table of leaves (AP_MAX_LEAVES)


def adam_polyak_(leaves, t: torch.Tensor, lr: float, tau: float,
                 b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
    """In place: for each (p, m, v, g, target) of ``leaves`` (f32 tensors
    with a leading member axis P, contiguous) the Adam step at the new step
    count ``t + 1`` and ``target <- (1 - tau) target + tau p``; ``t`` ((P,)
    int32) is incremented. The values are ``ref.fused_adam_polyak_ref``'s.
    A CPU ``t`` takes the plain version (its results copied in); a CUDA one
    launches the kernel or raises."""
    leaves = [tuple(x) for x in leaves]
    if t.device.type == "cpu":
        new, t2 = fused_adam_polyak_ref(leaves, t, lr, tau, b1, b2, eps)
        for old, upd in zip(leaves, new):
            for dst, src in zip(old[:3] + old[4:], upd):
                dst.copy_(src)
        t.copy_(t2)
        return
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"adam_polyak: 1 to {MAX_LEAVES} leaves per "
                         f"launch, got {len(leaves)}")
    build.check_operand(t, "t", 1, dtype=torch.int32)
    P = t.shape[0]
    for i, leaf in enumerate(leaves):
        for name, x in zip(("p", "m", "v", "g", "target"), leaf):
            build.check_operand(x, f"{name}[{i}]", x.dim())
            if x.shape != leaf[0].shape or x.dim() < 1 or x.shape[0] != P:
                raise ValueError(
                    f"{name}[{i}]: expected {tuple(leaf[0].shape)} with {P}"
                    f" members, got {tuple(x.shape)}")
    n = (ctypes.c_longlong * len(leaves))(
        *[leaf[0].numel() // P for leaf in leaves])
    ptrs = [(ctypes.c_longlong * len(leaves))(*[leaf[j].data_ptr()
                                                for leaf in leaves])
            for j in range(5)]
    t.add_(1)
    f = ctypes.c_float
    err = build.lib("adam_polyak").adam_polyak_launch(
        *ptrs, n, len(leaves), P, t.data_ptr(), f(lr), f(b1), f(b2),
        f(1 - b1), f(1 - b2), f(eps), f(1 - tau), f(tau),
        torch.cuda.current_stream(t.device).cuda_stream)
    build.check(err, "adam_polyak")
    build.LAUNCHES["adam_polyak"] += 1
