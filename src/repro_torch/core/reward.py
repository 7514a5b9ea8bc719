"""Reward functions.

Primary: the *absolute reward* (Bender et al. 2020) used by the paper
(Eq. 6):   r(P) = acc + β · | T_P / (c · T_ref) − 1 |,  β < 0.

Also provided: the hard-exponential reward (MnasNet) the paper tried and
rejected.

``compute_reward`` is the scalar host path; ``compute_reward_batch`` is
the same math over (K,) arrays, for the batched engine's record tail.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
    """``compute_reward`` over (K,) numpy arrays (the batched engine keeps
    its record tail on the host)."""
    ratio = latency / (cfg.target_ratio * ref_latency)
    if cfg.kind == "absolute":
        return acc + cfg.beta * np.abs(ratio - 1.0)
    if cfg.kind == "hard_exponential":
        return acc * np.where(ratio > 1.0, ratio ** cfg.hard_beta, 1.0)
    raise ValueError(cfg.kind)
