"""K2 and K3 wrappers: the fused 3-layer MLP forward (``csrc/mlp3.cu``),
also over P member networks in one launch (``mlp3_members``: the JAX
package's vmapped kernel in a population's rollout), and the Polyak
update over a list of leaves (``csrc/polyak.cu``), which replace the JAX
package's ``kernels/mlp_fused.py::_mlp3_kernel`` and ``_polyak_kernel``."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import mlp3_members_ref, mlp3_ref, polyak_ref

MAX_LEAVES = 32     # the kernel's table of leaves (POLYAK_MAX_LEAVES)
CLUSTER = 8         # K2's CTAs per thread-block cluster (MLP_CLUSTER)
ROWS = 8            # K2's batch rows per cluster (MLP_BM)


def mlp3_plan(D1: int, D2: int) -> tuple:
    """K2's split of the columns: ``(n1, n2)``. A cluster of ``CLUSTER``
    CTAs takes ``ROWS`` batch rows (8 and 16 clusters at the DDPG
    batches 64 and 128); CTA ``rank`` takes columns ``[rank * n1, +n1)``
    of h1 and ``[rank * n2, +n2)`` of h2, n1 and n2 the smallest
    multiples of 4 that cover D1 and D2 in ``CLUSTER`` slices (the last
    CTAs may get fewer or none)."""
    return 4 * -(-D1 // (4 * CLUSTER)), 4 * -(-D2 // (4 * CLUSTER))


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
    n1, n2 = mlp3_plan(D1, D2)
    err = build.lib("mlp3").mlp3_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), y.data_ptr(),
        h1.data_ptr(), h2.data_ptr(), B, D0, D1, D2, D3, int(sigmoid),
        n1, n2, torch.cuda.current_stream(x.device).cuda_stream)
    # A launch whose weight slices and activation tiles overflow a CTA's
    # shared memory (227 KB on Hopper) is refused by cudaFuncSetAttribute.
    build.check(err, f"mlp3 with widths {(D0, D1, D2)} (shared memory "
                f"is capped at 227 KB per block)")
    build.LAUNCHES["mlp3"] += 1
    return y, h1, h2


def mlp3_members(x, w1, b1, w2, b2, w3, b3, *, sigmoid: bool = False):
    """K2's member form: x [P, B, D0]; wi [P, D(i-1), Di]; bi [P, Di], all
    contiguous. Returns ``(y, h1, h2)``, each [P, B, ·]: member p's rows
    are what ``mlp3`` gives on member p's slices, bit for bit on the card
    (one launch for all P). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return mlp3_members_ref(x, w1, b1, w2, b2, w3, b3, sigmoid)
    P, B, D0 = x.shape
    D1, D2, D3 = w1.shape[2], w2.shape[2], w3.shape[2]
    for t, name, shape in ((x, "x", (P, B, D0)), (w1, "w1", (P, D0, D1)),
                           (b1, "b1", (P, D1)), (w2, "w2", (P, D1, D2)),
                           (b2, "b2", (P, D2)), (w3, "w3", (P, D2, D3)),
                           (b3, "b3", (P, D3))):
        build.check_operand(t, name, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
    y = torch.empty((P, B, D3), device=x.device, dtype=x.dtype)
    h1 = torch.empty((P, B, D1), device=x.device, dtype=x.dtype)
    h2 = torch.empty((P, B, D2), device=x.device, dtype=x.dtype)
    if B == 0 or P == 0:
        return y, h1, h2
    n1, n2 = mlp3_plan(D1, D2)
    err = build.lib("mlp3").mlp3_members_launch(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), y.data_ptr(),
        h1.data_ptr(), h2.data_ptr(), B, D0, D1, D2, D3, int(sigmoid),
        n1, n2, P, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"mlp3_members with widths {(D0, D1, D2)} over {P} "
                f"members (shared memory is capped at 227 KB per block)")
    build.LAUNCHES["mlp3_members"] += 1
    return y, h1, h2


def polyak_leaves(targets, onlines, tau: float) -> list:
    """``(1 - tau) * t + tau * p`` for every pair of leaves (f32 tensors
    of any shape, pairs of equal shape) in one kernel launch, read where
    they lie (no copy into a flat buffer). Returns the new leaves: on the
    card, views of one fresh buffer (each leaf starting on 16 bytes); on
    the CPU, the plain version per leaf. A CPU leaf takes the plain
    version; CUDA leaves launch the kernel or raise."""
    targets, onlines = list(targets), list(onlines)
    if len(targets) != len(onlines):
        raise ValueError(f"{len(targets)} target leaves, {len(onlines)} "
                         f"online leaves")
    if targets and targets[0].device.type == "cpu":
        return [polyak_ref(t, p, tau) for t, p in zip(targets, onlines)]
    if not 1 <= len(targets) <= MAX_LEAVES:
        raise ValueError(f"polyak: 1 to {MAX_LEAVES} leaves per launch, "
                         f"got {len(targets)}")
    offsets, total = [], 0
    for i, (t, p) in enumerate(zip(targets, onlines)):
        build.check_operand(t, f"target[{i}]", t.dim())
        build.check_operand(p, f"online[{i}]", p.dim())
        if p.shape != t.shape:
            raise ValueError(f"online[{i}] {tuple(p.shape)} != target[{i}] "
                             f"{tuple(t.shape)}")
        offsets.append(total)
        total += -(-t.numel() // 4) * 4
    flat = torch.empty(total, device=targets[0].device, dtype=torch.float32)
    outs = [flat[o:o + t.numel()].view(t.shape)
            for o, t in zip(offsets, targets)]
    live = [i for i, t in enumerate(targets) if t.numel()]
    if not live:
        return outs
    n = len(live)
    ptrs = [(ctypes.c_longlong * n)(*[seq[i].data_ptr() for i in live])
            for seq in (targets, onlines, outs)]
    sizes = (ctypes.c_longlong * n)(*[targets[i].numel() for i in live])
    err = build.lib("polyak").polyak_launch(
        *ptrs, sizes, n, 1 - tau, tau,
        torch.cuda.current_stream(targets[0].device).cuda_stream)
    build.check(err, "polyak")
    build.LAUNCHES["polyak"] += 1
    return outs

