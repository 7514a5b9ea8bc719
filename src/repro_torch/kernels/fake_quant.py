"""K1 wrapper: per-channel fake quantization of a 2-D f32 tensor
(``csrc/fake_quant.cu``; replaces the JAX package's
``kernels/fake_quant.py::fake_quant_kernel``)."""
from __future__ import annotations

import torch

from . import build
from .ref import fake_quant_ref


def fake_quant_2d(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x [R, C] f32: quantize-dequantize with per-channel (last axis)
    range reduced over the rows. ``bits`` is a host int; >= 32 passes
    through. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if x.device.type == "cpu":
        return fake_quant_ref(x, bits)
    build.check_operand(x, "x", 2)
    out = torch.empty_like(x)
    R, C = x.shape
    if x.numel() == 0:
        return out
    err = build.lib("fake_quant").fake_quant_launch(
        x.data_ptr(), out.data_ptr(), R, C, int(bits),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fake_quant")
    build.LAUNCHES["fake_quant"] += 1
    return out
