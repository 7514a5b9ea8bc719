"""Continuous policy -> discrete CMP mapping (paper Eq. 1, 4, 8).

A *policy* is the per-layer list of continuous compression parameters in
[0,1] (Eq. 1). Actions from the agents are mapped:

  * pruning: Eq. 4 inverse mapping  d_v(r) = floor((1-r) * v) + 1
  * quantization: threshold selection (Eq. 8) with t_mix=0.5, t_int8=0.2,
    then Eq. 4 against the max mix bit width.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from . import constraints
from .spec import LayerCMP, LayerSpec, effective_bits

# MIX above 6 bits is never better than INT8 on the oracle's target
# (same matrix-unit path, worse packing), as the paper found on ARM.
MAX_MIX_BITS = 6

T_MIX = 0.5
T_INT8 = 0.2


def n_actions(methods: str) -> int:
    """Action-vector length per method set (paper: r_p / r_w,r_a / all 3)."""
    return {"p": 1, "q": 2, "pq": 3}[methods]


def d_inverse(r: float, v: int) -> int:
    """Paper Eq. 4: continuous ratio r in [0,1] -> discrete value in [1, v]."""
    return int(np.floor((1.0 - r) * v)) + 1 if v > 0 else 0


def scale_mix_action(a: float) -> float:
    """Paper Eq. 8 (with the min/max order fixed — the printed equation's
    clip bounds are transposed): r = clip((a - t_mix)/(1 - t_mix), 0, 1)."""
    return float(np.clip((a - T_MIX) / (1.0 - T_MIX), 0.0, 1.0))


def quant_cmp_from_actions(a_w: float, a_a: float,
                           max_bits: int = MAX_MIX_BITS) -> LayerCMP:
    """Threshold-based quant-mode selection (paper §Quantization details)."""
    if max(a_w, a_a) > T_MIX:
        # r is a *compression ratio*: r=0 -> max_bits, r=1 -> 1 bit (Eq. 4)
        r_w, r_a = scale_mix_action(a_w), scale_mix_action(a_a)
        return LayerCMP(keep=0, mode="MIX",
                        w_bits=min(d_inverse(r_w, max_bits), max_bits),
                        a_bits=min(d_inverse(r_a, max_bits), max_bits))
    if max(a_w, a_a) > T_INT8:
        return LayerCMP(keep=0, mode="INT8", w_bits=8, a_bits=8)
    return LayerCMP(keep=0, mode="FP32", w_bits=32, a_bits=32)


def prune_keep_from_action(spec: LayerSpec, a_p: float) -> int:
    """Action -> kept channel count (Eq. 4 with v = original count)."""
    if not spec.prunable or spec.prune_dim == 0:
        return spec.prune_dim
    return min(d_inverse(float(a_p), spec.prune_dim), spec.prune_dim)


def map_actions(spec: LayerSpec, actions: Sequence[float],
                methods: str) -> LayerCMP:
    """methods: "p" (prune), "q" (quant) or "pq" (joint)."""
    if methods == "p":
        cmp = LayerCMP(keep=prune_keep_from_action(spec, actions[0]))
    elif methods == "q":
        cmp = quant_cmp_from_actions(actions[0], actions[1])
        cmp.keep = spec.prune_dim
    elif methods == "pq":
        cmp = quant_cmp_from_actions(actions[1], actions[2])
        cmp.keep = prune_keep_from_action(spec, actions[0])
    else:
        raise ValueError(methods)
    return constraints.legalize(spec, cmp)


def action_columns(methods: str) -> tuple:
    """(prune, w-quant, a-quant) column indices into the action vector.
    Dead columns point at index 0; the rollout keeps the reference's
    parameters for a method the agent does not search."""
    if methods == "p":
        return (0, 0, 0)
    if methods == "q":
        return (0, 0, 1)
    if methods == "pq":
        return (0, 1, 2)
    raise ValueError(methods)


def map_actions_batch(actions: torch.Tensor, *, prune_dim, granularity,
                      prunable, quantizable, mix_ok, ip=0, iw=1, ia=2):
    """Vectorized ``map_actions`` + ``legalize`` over K action rows for
    ONE spec: (K, A) f32 actions -> (keep, w_bits, a_bits) f32 tensors of
    *effective* bits (the ``PolicyBatch`` form). The spec parameters are
    0-d tensors (a row of ``constraints.legal_tables``); ``ip``/``iw``/
    ``ia`` the action columns of ``action_columns``. Element for element
    the scalar path: Eq. 4, the Eq. 8 thresholds, then the hardware
    legalization (granularity rounding, MIX -> INT8 where int4 cannot
    pack, FP32 where nothing quantizes), in f32 as the JAX package's."""
    a_p, a_w, a_a = actions[..., ip], actions[..., iw], actions[..., ia]

    # pruning: d_inverse(a_p, prune_dim), rounded to the granularity
    raw = torch.floor((1.0 - a_p) * prune_dim) + 1.0
    keep = torch.minimum(raw, prune_dim)
    keep = constraints.round_keep_arrays(keep, granularity, prune_dim)
    keep = torch.where(prunable, keep, prune_dim)

    # quantization: threshold mode selection + Eq. 4 on mix bits (the
    # divisor 1 - T_MIX is 0.5, so tensor / scalar is exact on any route)
    hi = torch.maximum(a_w, a_a)
    is_mix = hi > T_MIX
    is_int8 = ~is_mix & (hi > T_INT8)
    r_w = torch.clamp((a_w - T_MIX) / (1.0 - T_MIX), 0.0, 1.0)
    r_a = torch.clamp((a_a - T_MIX) / (1.0 - T_MIX), 0.0, 1.0)
    mix_w = torch.clamp_max(torch.floor((1.0 - r_w) * MAX_MIX_BITS) + 1.0,
                            float(MAX_MIX_BITS))
    mix_a = torch.clamp_max(torch.floor((1.0 - r_a) * MAX_MIX_BITS) + 1.0,
                            float(MAX_MIX_BITS))
    is_int8 = is_int8 | (is_mix & ~mix_ok)
    is_mix = is_mix & mix_ok
    eight, full = torch.full_like(hi, 8.0), torch.full_like(hi, 32.0)
    wb = torch.where(is_mix, mix_w, torch.where(is_int8, eight, full))
    ab = torch.where(is_mix, mix_a, torch.where(is_int8, eight, full))
    wb = torch.where(quantizable, wb, full)
    ab = torch.where(quantizable, ab, full)
    return keep, wb, ab


@dataclass
class Policy:
    """A complete compression policy for a model (one CMP per LayerSpec)."""
    cmps: List[LayerCMP] = field(default_factory=list)

    @staticmethod
    def reference(specs: Sequence[LayerSpec]) -> "Policy":
        """P_r — the initial no-compression policy."""
        return Policy([LayerCMP(keep=s.prune_dim) for s in specs])

    def macs_fraction(self, specs: Sequence[LayerSpec]) -> float:
        tot = sum(s.flops_per_token for s in specs) or 1.0
        acc = 0.0
        for s, c in zip(specs, self.cmps):
            f_out = (c.keep / s.prune_dim) if s.prune_dim else 1.0
            acc += s.flops_per_token * f_out
        return acc / tot

    def bops(self, specs: Sequence[LayerSpec]) -> float:
        """Bit operations: MACs * w_bits * a_bits (Baskin et al. 2021)."""
        acc = 0.0
        for s, c in zip(specs, self.cmps):
            f_out = (c.keep / s.prune_dim) if s.prune_dim else 1.0
            acc += s.flops_per_token / 2.0 * f_out * c.w_bits * c.a_bits
        return acc


@dataclass
class PolicyBatch:
    """K policies over the same LayerSpec list, as (K, L) arrays.

    ``keep`` holds kept counts; ``w_bits``/``a_bits`` hold *effective*
    bits (mode already resolved).
    """
    keep: np.ndarray
    w_bits: np.ndarray
    a_bits: np.ndarray

    def __len__(self) -> int:
        return self.keep.shape[0]


def policies_from_batch(specs: Sequence[LayerSpec],
                        batch: PolicyBatch) -> List[Policy]:
    """Inverse of ``stack_policies``. Effective bits map back to modes
    uniquely: (32,32) -> FP32, (8,8) -> INT8, anything else is MIX
    (mix bits are capped at ``MAX_MIX_BITS`` < 8 by Eq. 8)."""
    out = []
    for k in range(len(batch)):
        cmps = []
        for i in range(len(specs)):
            w = int(round(float(batch.w_bits[k, i])))
            a = int(round(float(batch.a_bits[k, i])))
            keep = int(round(float(batch.keep[k, i])))
            if w >= 32 and a >= 32:
                cmps.append(LayerCMP(keep=keep))
            elif w == 8 and a == 8:
                cmps.append(LayerCMP(keep=keep, mode="INT8", w_bits=8,
                                     a_bits=8))
            else:
                cmps.append(LayerCMP(keep=keep, mode="MIX", w_bits=w,
                                     a_bits=a))
        out.append(Policy(cmps))
    return out


def stack_policies(specs: Sequence[LayerSpec],
                   policies: Sequence[Policy]) -> PolicyBatch:
    """Pack K policies into the array form of ``PolicyBatch``."""
    K, L = len(policies), len(specs)
    keep = np.zeros((K, L), np.float64)
    wb = np.zeros((K, L), np.float64)
    ab = np.zeros((K, L), np.float64)
    for k, p in enumerate(policies):
        for i, c in enumerate(p.cmps):
            keep[k, i] = c.keep
            wb[k, i], ab[k, i] = effective_bits(c)
    return PolicyBatch(keep=keep, w_bits=wb, a_bits=ab)
