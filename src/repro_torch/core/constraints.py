"""Hardware legality checks for compression-method parameters (CMPs).

The rules are those of the reference oracle's target (TPU v5e), kept as
they are so the port searches the same action space:

  * pruned dims are rounded so the *kept* count is a multiple of the
    unit's ``prune_granularity`` (128-lane alignment in the oracle);
  * MIX (sub-8-bit) weights need the contracted dim 256-aligned (int4
    packing); layers that cannot satisfy it take INT8 instead;
  * embedding/unembedding are INT8-or-FP32 only.

``LegalTables`` holds the same rules as per-spec tensors, the form that
``policy.map_actions_batch`` and the fused engine's rollout consume.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .spec import LayerCMP, LayerSpec

MXU_LANE = 128
INT4_ALIGN = 256


def round_keep(spec: LayerSpec, keep: int) -> int:
    """Round a kept-channel count down to the hardware granularity
    (>= one granule)."""
    g = max(1, spec.prune_granularity)
    keep = max(g, (keep // g) * g)
    return min(keep, spec.prune_dim)


def mix_allowed(spec: LayerSpec) -> bool:
    if not spec.mix_supported or not spec.quantizable:
        return False
    # int4 weight packing wants the contraction dim 256-aligned
    return spec.in_dim % INT4_ALIGN == 0 or spec.kind == "conv"


def legalize(spec: LayerSpec, cmp: LayerCMP) -> LayerCMP:
    """Clamp a proposed CMP to what the hardware target supports."""
    if spec.prunable and spec.prune_dim:
        cmp.keep = round_keep(spec, cmp.keep)
    else:
        cmp.keep = spec.prune_dim
    if not spec.quantizable:
        cmp.mode, cmp.w_bits, cmp.a_bits = "FP32", 32, 32
    elif cmp.mode == "MIX" and not mix_allowed(spec):
        # paper: unsupported layers take the INT8 option instead
        cmp.mode, cmp.w_bits, cmp.a_bits = "INT8", 8, 8
    return cmp


# ===========================================================================
# Tensor form — the same legality rules as data, for vectorized mapping
# ===========================================================================

class LegalTables(NamedTuple):
    """Per-spec legality parameters (one entry per ``LayerSpec``) as
    tensors on the engine's device: policy-independent constants that a
    captured rollout reads in place."""
    prune_dim: torch.Tensor    # (L,) f32
    granularity: torch.Tensor  # (L,) f32  (>= 1)
    prunable: torch.Tensor     # (L,) bool  (prunable AND prune_dim > 0)
    quantizable: torch.Tensor  # (L,) bool
    mix_ok: torch.Tensor       # (L,) bool  (mix_allowed per spec)


def legal_tables(specs: Sequence[LayerSpec], device="cpu") -> LegalTables:
    f32 = dict(dtype=torch.float32, device=device)
    return LegalTables(
        prune_dim=torch.tensor([s.prune_dim for s in specs], **f32),
        granularity=torch.tensor(
            [max(1, s.prune_granularity) for s in specs], **f32),
        prunable=torch.tensor([bool(s.prunable and s.prune_dim)
                               for s in specs], device=device),
        quantizable=torch.tensor([s.quantizable for s in specs],
                                 device=device),
        mix_ok=torch.tensor([mix_allowed(s) for s in specs], device=device))


def round_keep_arrays(keep, granularity, prune_dim):
    """``round_keep`` as tensor ops: round kept counts down to the
    granularity, floor one granule, cap at the prunable dim. Inputs
    broadcast; counts stay exact in f32."""
    rounded = torch.maximum(torch.floor(keep / granularity) * granularity,
                            granularity)
    return torch.minimum(rounded, prune_dim)
