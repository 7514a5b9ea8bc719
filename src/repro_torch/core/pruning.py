"""Structured pruning — ℓ1 channel selection (Li et al. 2017, paper §Pruning).

Given a weight (or a group of weights sharing an output dim) and a kept
count, produce a float 0/1 mask keeping the channels with the largest ℓ1
norms. During search the mask multiplies activations (identical accuracy
effect to removal, static shapes).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def l1_scores(ws: Sequence[torch.Tensor], axis: int = -1) -> torch.Tensor:
    """Sum of ℓ1 norms over every weight in the group, reduced to the
    channel axis (default: last = output channels)."""
    total = None
    for w in ws:
        red = tuple(i for i in range(w.dim()) if i != (axis % w.dim()))
        s = torch.sum(torch.abs(w.float()), dim=red)
        total = s if total is None else total + s
    return total


def keep_mask(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Float mask keeping the ``keep`` highest-scoring channels. Ties at
    the threshold go to the lower channel index, as in the JAX package:
    threshold at the keep-th largest score, then drop later-indexed
    channels past the count."""
    n = scores.shape[0]
    keep = int(np.clip(keep, 0, n))
    if keep >= n:
        return torch.ones((n,), dtype=torch.float32, device=scores.device)
    if keep == 0:
        return torch.zeros((n,), dtype=torch.float32, device=scores.device)
    thresh = torch.sort(scores).values[n - keep]
    mask = (scores >= thresh).float()
    excess = torch.cumsum(mask, 0) > keep
    return torch.where(excess, torch.zeros_like(mask), mask)


def keep_mask_dynamic(scores: torch.Tensor, keep,
                      sorted_scores=None) -> torch.Tensor:
    """``keep_mask`` for a vector of K kept counts: scores [n] and keep
    [K] (host ints, or an int tensor on the scores' device: the fused
    engine's, read without a sync) -> float masks [K, n]. The same
    selection as ``keep_mask`` for each count: threshold at the keep-th
    largest score, then drop later-indexed ties past the count.
    ``sorted_scores`` is ``torch.sort(scores).values``, for a caller that
    sorts once (a cspec builder)."""
    n = scores.shape[0]
    if isinstance(keep, torch.Tensor):
        keep = torch.clamp(keep.to(torch.int64), 0, n)
    else:
        keep = torch.as_tensor(np.clip(np.asarray(keep, np.int64), 0, n),
                               device=scores.device)
    if sorted_scores is None:
        sorted_scores = torch.sort(scores).values
    thresh = sorted_scores[torch.clamp(n - keep, 0, n - 1)]
    mask = (scores[None, :] >= thresh[:, None]).float()
    mask = torch.where(torch.cumsum(mask, 1) > keep[:, None],
                       torch.zeros_like(mask), mask)
    return torch.where(keep[:, None] > 0, mask, torch.zeros_like(mask))


def head_scores(wq: torch.Tensor, num_heads: int) -> torch.Tensor:
    """ℓ1 score per attention head from wq [d, H*hd]."""
    d, hhd = wq.shape
    hd = hhd // num_heads
    w = torch.abs(wq.float()).reshape(d, num_heads, hd)
    return torch.sum(w, dim=(0, 2))


def slice_indices(mask) -> np.ndarray:
    """Indices of kept channels of a 0/1 mask (a tensor on any device, or
    an array), as a host array (used when materializing the deployed,
    truly sliced model)."""
    if isinstance(mask, torch.Tensor):
        mask = mask.detach().cpu().numpy()
    return np.nonzero(np.asarray(mask) > 0)[0]
