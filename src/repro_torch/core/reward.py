"""Reward functions.

Primary: the *absolute reward* (Bender et al. 2020) used by the paper
(Eq. 6):   r(P) = acc + β · | T_P / (c · T_ref) − 1 |,  β < 0.

Also provided: the hard-exponential reward (MnasNet) the paper tried and
rejected.

``compute_reward`` is the scalar host path; ``compute_reward_batch`` is
the same math over (K,) numpy arrays (the batched engine's record tail)
or tensors (the fused engine, on the device).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class RewardConfig:
    target_ratio: float = 0.3          # c — target latency fraction
    beta: float = -3.0                 # cost exponent (paper: -3.0)
    kind: str = "absolute"             # absolute|hard_exponential
    hard_beta: float = -0.07           # exponent for kind="hard_exponential"


def absolute_reward(acc: float, latency: float, ref_latency: float,
                    c: float, beta: float = -3.0) -> float:
    return acc + beta * abs(latency / (c * ref_latency) - 1.0)


def hard_exponential_reward(acc: float, latency: float, ref_latency: float,
                            c: float, beta: float = -0.07) -> float:
    """MnasNet-style: acc * (T/T_target)^beta, only penalizing overshoot."""
    ratio = latency / (c * ref_latency)
    return acc * (ratio ** beta if ratio > 1.0 else 1.0)


def compute_reward(cfg: RewardConfig, acc: float, latency: float,
                   ref_latency: float) -> float:
    if cfg.kind == "absolute":
        return absolute_reward(acc, latency, ref_latency, cfg.target_ratio,
                               cfg.beta)
    if cfg.kind == "hard_exponential":
        return hard_exponential_reward(acc, latency, ref_latency,
                                       cfg.target_ratio, cfg.hard_beta)
    raise ValueError(cfg.kind)


def compute_reward_batch(cfg: RewardConfig, acc, latency, ref_latency):
    """``compute_reward`` over (K,) numpy arrays or tensors. With tensors
    ``ref_latency`` may be a 0-d tensor (the epoch engine's) or a float;
    the divisor is made a tensor, so the quotient is correctly rounded on
    every device (the card takes ``tensor / float`` as a product by the
    reciprocal)."""
    xp = torch if isinstance(latency, torch.Tensor) else np
    denom = cfg.target_ratio * ref_latency
    if xp is torch and not isinstance(denom, torch.Tensor):
        denom = torch.full((), denom, dtype=latency.dtype,
                           device=latency.device)
    ratio = latency / denom
    if cfg.kind == "absolute":
        return acc + cfg.beta * xp.abs(ratio - 1.0)
    if cfg.kind == "hard_exponential":
        return acc * xp.where(ratio > 1.0, ratio ** cfg.hard_beta, 1.0)
    raise ValueError(cfg.kind)
