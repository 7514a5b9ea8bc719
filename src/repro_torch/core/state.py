"""Agent state construction (paper Fig. 2: model features X_t -> s_t).

Features per time step (one compressible unit): position, unit kind,
dimensions, FLOPs/weight shares, sensitivity probes, previous action, and
latency-budget bookkeeping under the partial policy (AMC's reduced/rest
features, computed against the hardware latency oracle instead of FLOPs).

Three builders share the feature definitions: ``build_state`` (scalar)
and ``build_state_batch`` (K episodes) in host numpy, so the features
match the reference exactly, and ``fused_state_block`` (the fused
engine's rollout) on the device, from the per-step constants of
``StateTables`` (the same numpy values, moved once).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .latency import (HardwareTarget, LatencyContext, PolicyLatency,
                      fifo_cached, policy_latency)
from .policy import Policy
from .sensitivity import FEATURE_PROBES, SensitivityResult
from .spec import LayerSpec

KINDS = ("conv", "attn_qkv", "attn_out", "mlp_up", "mlp_down", "moe_up",
         "moe_down", "ssm_in", "ssm_out", "rglru_in", "rglru_out", "embed",
         "head")


def state_dim(action_dim: int) -> int:
    return (1 + len(KINDS) + 3 + 2 + 2 + len(FEATURE_PROBES)
            + action_dim + 3)


def build_state(specs: Sequence[LayerSpec], t: int, partial: Policy,
                sens: SensitivityResult, prev_action: np.ndarray,
                hw: HardwareTarget, ctx: LatencyContext,
                ref_lat: PolicyLatency, window: int = 0) -> np.ndarray:
    static, this_share, rest_share, ref_total = _static_features(
        specs, t, sens, ref_lat)
    cur = policy_latency(specs, partial, hw, ctx, window)
    # latency of units decided so far (indices < t) under partial policy
    # vs what remains at reference cost; policy_latency may interleave
    # attention-extra entries, so map each unit back by name
    decided = sum(u.time_s for u in cur.units
                  if _unit_index(u.name, specs) < t)
    tail = np.asarray([this_share, decided / ref_total, rest_share],
                      np.float32)
    return np.concatenate([static,
                           np.asarray(prev_action, np.float32).ravel(),
                           tail])


def build_state_batch(specs: Sequence[LayerSpec], t: int, cur_lat,
                      sens: SensitivityResult, prev_actions: np.ndarray,
                      ref_lat: PolicyLatency) -> np.ndarray:
    """Batched ``build_state``: one (K, state_dim) array for K episodes.

    ``cur_lat`` is a ``BatchedPolicyLatency`` for the K partial policies
    (the caller evaluates the vectorized oracle each step). All features
    except ``prev_action`` and the decided-latency share are identical
    across the batch and cached per (specs, sens, ref_lat, t).
    """
    static, this_share, rest_share, ref_total = _static_features(
        specs, t, sens, ref_lat)
    prev_actions = np.atleast_2d(np.asarray(prev_actions, np.float32))
    K = prev_actions.shape[0]
    decided = (cur_lat.decided_before(t) / ref_total).astype(np.float32)
    tail = np.column_stack([
        np.full(K, this_share, np.float32), decided,
        np.full(K, rest_share, np.float32)])
    return np.concatenate([np.tile(static, (K, 1)), prev_actions, tail],
                          axis=1)


class StateTables:
    """Per-step state-feature constants for the fused rollout: everything
    in ``build_state_batch`` that does not depend on the partial policy,
    one row per actionable unit — the static feature block (T, S), the
    reference-latency shares (T, 2), the spec index per step — from the
    ``_static_features`` cache the numpy engines read, so the two paths
    agree bit for bit on these features. ``static`` and ``shares`` are
    numpy; ``to(device)`` gives their tensors."""

    def __init__(self, specs, steps, sens, ref_lat):
        rows, this_s, rest_s = [], [], []
        ref_total = 1.0
        for t in steps:
            static, a, b, ref_total = _static_features(specs, t, sens,
                                                       ref_lat)
            rows.append(static)
            this_s.append(a)
            rest_s.append(b)
        self.static = np.stack(rows).astype(np.float32)      # (T, S)
        self.shares = np.stack(                              # (T, 2)
            [np.asarray(this_s, np.float32),
             np.asarray(rest_s, np.float32)], axis=1)
        self.ref_total = float(ref_total)
        self.spec_idx = np.asarray(steps, np.int32)          # (T,)

    def to(self, device) -> tuple:
        """(static, shares, ref_total) as f32 tensors on ``device``."""
        f32 = dict(dtype=torch.float32, device=device)
        return (torch.as_tensor(self.static, **f32),
                torch.as_tensor(self.shares, **f32),
                torch.tensor(self.ref_total, **f32))


def fused_state_block(static_row, shares_row, decided, prev_actions):
    """One rollout step's (K, state_dim) block: the device twin of
    ``build_state_batch`` given ``StateTables`` rows and the decided-
    latency share of each of the K partial policies. A population's step
    is the (P, K, state_dim) block of P members: ``shares_row`` (P, 2),
    one row per member (its own reference latency), ``decided`` (P, K)
    and ``prev_actions`` (P, K, A); the static row is shared."""
    lead = prev_actions.shape[:-1]
    static = static_row.expand(*lead, static_row.shape[-1])
    tail = torch.stack([shares_row[..., 0, None].expand(lead), decided,
                        shares_row[..., 1, None].expand(lead)], dim=-1)
    return torch.cat([static, prev_actions, tail], dim=-1)


_static_cache: dict = {}
_STATIC_CACHE_MAX = 4096               # ~entries for dozens of searches


def _static_features(specs, t, sens, ref_lat):
    hit = fifo_cached(
        _static_cache, _STATIC_CACHE_MAX, (id(specs), id(sens),
                                           id(ref_lat), t),
        lambda h: h[0] is specs and h[1] is sens and h[2] is ref_lat,
        lambda: (specs, sens, ref_lat,
                 _compute_static_features(specs, t, sens, ref_lat)))
    return hit[3]


def _compute_static_features(specs, t, sens, ref_lat):
    s = specs[t]
    total_flops = sum(x.flops_per_token for x in specs) or 1.0
    total_weights = sum(x.weight_elems for x in specs) or 1.0
    feats = [t / max(1, len(specs))]
    feats += [1.0 if s.kind == k else 0.0 for k in KINDS]
    feats += [np.log1p(s.in_dim) / 12.0, np.log1p(s.out_dim) / 12.0,
              np.log1p(s.prune_dim) / 12.0]
    feats += [s.flops_per_token / total_flops,
              s.weight_elems / total_weights]
    feats += [1.0 if s.prunable else 0.0, 1.0 if s.mix_supported else 0.0]
    # array-form probe row (log1p KLs; MISSING_KL sentinel where a probe
    # was not run — legality-aware, see SensitivityResult.feature_row)
    static = np.concatenate([np.asarray(feats, np.float32),
                             sens.feature_row(s.name)])
    ref_total = ref_lat.total_s or 1.0
    this_share = sum(u.time_s for u in ref_lat.units
                     if _unit_index(u.name, specs) == t) / ref_total
    rest_share = sum(u.time_s for u in ref_lat.units
                     if _unit_index(u.name, specs) >= t) / ref_total
    return (static, this_share, rest_share, ref_total)


_name_cache: dict = {}


def _unit_index(unit_name: str, specs: Sequence[LayerSpec]) -> int:
    key = id(specs)
    hit = _name_cache.get(key)
    # identity-guard + strong ref, so a recycled list id cannot serve a
    # stale table (same idiom as _static_cache / the oracle cache)
    if hit is None or hit[0] is not specs:
        hit = (specs, {s.name: i for i, s in enumerate(specs)})
        _name_cache[key] = hit
    base = unit_name[:-5] if unit_name.endswith(".attn") else unit_name
    return hit[1].get(base, len(specs))
