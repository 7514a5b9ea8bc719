"""Hardware latency oracle, scalar analytic half (numpy float64).

``policy_latency`` is the fast closed-form roofline model the RL reward
probes every episode: compute / memory / collective terms per unit with
matrix-unit 128-padding, int8 = 2x matrix rate, int4 weight packing,
KV-cache traffic and MoE active-expert traffic.

The modelled target is the JAX package's ``V5E`` table (a TPU v5e data
sheet), kept as it is so the port's latencies match the reference's. It
is reference data for the model, not a measurement of any chip the port
runs on. ``calib=`` takes a ``core.measure.CalibrationTable`` measured on
the card the port runs on: it rescales each unit term by its fitted
(kind, container) factor, and the attention extras and the dispatch
overhead by the lumped residual factors.

``policy_latency_batch`` (``BatchOracle``) evaluates K policies at once
with numpy array ops over precomputed per-spec tables, the same roofline
terms in float64: the batched engine probes it every layer step.
``DeviceBatchOracle`` (``get_device_oracle``) is the same roofline as
f32 tensor ops on the engine's device, tables borrowed from the
``BatchOracle`` (calibration factors included): the fused engine's
rollout probes it every layer step without leaving the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from .policy import Policy, PolicyBatch, stack_policies
from .spec import LayerCMP, LayerSpec, effective_bits


@dataclass(frozen=True)
class HardwareTarget:
    name: str = "tpu-v5e"
    peak_bf16: float = 197e12          # FLOP/s per chip
    peak_int8: float = 394e12          # OP/s per chip
    hbm_bw: float = 819e9              # B/s per chip
    ici_bw: float = 50e9               # B/s per link
    mxu_align: int = 128
    op_overhead: float = 1e-7          # per fused-op dispatch (XLA fuses
                                       # whole blocks; ~0.1us residual)


V5E = HardwareTarget()


@dataclass(frozen=True)
class LatencyContext:
    tokens: int                        # tokens processed by one step
    seq_ctx: int = 0                   # attention context length
    mode: str = "prefill"              # train|prefill|decode
    chips: int = 1
    tp: int = 1                        # model-axis ways (activation collectives)
    cache_bits: int = 16               # KV-cache storage precision
    batch: int = 1


def _weight_bytes_per_elem(w_bits: int) -> float:
    if w_bits >= 9:
        return 2.0                     # native bf16
    if w_bits >= 5:
        return 1.0                     # int8 container
    return 0.5                         # int4 packing


def _act_bytes_per_elem(a_bits: int) -> float:
    return 1.0 if a_bits <= 8 else 2.0


# Weight-container buckets, in the fixed order calibration tables use:
# column 0 = raw (bf16/f32), 1 = int8 container, 2 = packed int4.
CONTAINERS = ("raw", "int8", "int4")


def container_for_bits(w_bits: int) -> str:
    """Deployment container a ``w_bits``-wide weight ships in — the same
    thresholds as ``_weight_bytes_per_elem`` (>=9 raw, 5..8 int8, <=4
    packed int4). Calibration tables (core/measure.py) are keyed by
    (layer kind, container)."""
    if w_bits >= 9:
        return "raw"
    return "int8" if w_bits >= 5 else "int4"


def pad_align(x, align):
    """MXU-lane padding: ceil(max(x, 1) / align) * align, of a scalar or
    a numpy array."""
    return np.ceil(np.maximum(x, 1.0) / align) * align


def _pad(x: float, align: int) -> float:
    return float(pad_align(x, align))


def _peak(w_bits: int, a_bits: int, hw: HardwareTarget) -> float:
    return hw.peak_int8 if (w_bits <= 8 and a_bits <= 8) else hw.peak_bf16


@dataclass
class UnitLatency:
    name: str
    compute_s: float
    memory_s: float
    collective_s: float = 0.0

    @property
    def time_s(self) -> float:
        # compute/memory overlap within a fused op; collectives exposed
        return max(self.compute_s, self.memory_s) + self.collective_s


@dataclass
class PolicyLatency:
    units: list = field(default_factory=list)
    overhead_s: float = 0.0

    @property
    def total_s(self) -> float:
        return sum(u.time_s for u in self.units) + self.overhead_s

    @property
    def compute_s(self) -> float:
        return sum(u.compute_s for u in self.units)

    @property
    def memory_s(self) -> float:
        return sum(u.memory_s for u in self.units)

    @property
    def collective_s(self) -> float:
        return sum(u.collective_s for u in self.units)

    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)


def _resolve_keep_fracs(specs: Sequence[LayerSpec], policy: Policy) -> dict:
    """dep_group name -> keep fraction provided by the owning unit."""
    fracs: dict[str, float] = {}
    for s, c in zip(specs, policy.cmps):
        if not s.prunable or not s.prune_dim:
            continue
        frac = c.keep / s.prune_dim
        if s.kind == "attn_qkv":
            fracs[f"L{s.layer_idx}.heads"] = frac
        elif s.kind == "mlp_up":
            grp = "dense_ff" if s.extra.get("dense_residual") else "ff"
            fracs[f"L{s.layer_idx}.{grp}"] = frac
        elif s.kind == "moe_up":
            fracs[f"L{s.layer_idx}.moe_ff"] = frac
        elif s.kind == "ssm_in":
            fracs[f"L{s.layer_idx}.ssm_heads"] = frac
        elif s.kind == "rglru_in":
            fracs[f"L{s.layer_idx}.lru"] = frac
    return fracs


def unit_latency(spec: LayerSpec, cmp: LayerCMP, in_frac: float,
                 hw: HardwareTarget, ctx: LatencyContext) -> UnitLatency:
    w_bits, a_bits = effective_bits(cmp)
    keep_frac = (cmp.keep / spec.prune_dim) if spec.prune_dim else 1.0
    T = ctx.tokens
    chips = max(1, ctx.chips)

    # --- matmul dims after pruning + MXU padding ---
    if spec.kind == "conv":
        # im2col on the MXU: m = spatial positions, k = k²·cin, n = cout.
        # Channels pad to the 128 lane width — pruning below a 128
        # boundary buys no MXU time (TPU truth; ARM had no such floor).
        px = spec.extra.get("px", 1)
        m = T * px
        k_dim = (spec.weight_elems / max(1, spec.out_dim)) * in_frac
        n_dim = spec.out_dim * keep_frac
        k_pad = _pad(k_dim, hw.mxu_align)
        n_pad = _pad(n_dim, hw.mxu_align)
        flops = 2.0 * m * k_pad * n_pad
        w_bytes = (spec.weight_elems * in_frac * keep_frac
                   * _weight_bytes_per_elem(w_bits))
        a_bytes = m * k_dim * _act_bytes_per_elem(a_bits) + m * n_dim * 2.0
        compute = flops / (_peak(w_bits, a_bits, hw) * chips)
        memory = (w_bytes + a_bytes) / (hw.hbm_bw * chips)
        return UnitLatency(spec.name, compute, memory)
    k_dim = spec.in_dim * in_frac
    if spec.kind == "attn_qkv":
        hd = spec.extra.get("head_dim", 128)
        kv = spec.extra.get("kv_heads", 0)
        n_dim = keep_frac * (spec.out_dim - 2 * kv * hd) + 2 * kv * hd
    elif spec.prunable and spec.prune_dim:
        n_dim = spec.out_dim * keep_frac
    else:
        n_dim = spec.out_dim
    k_pad = _pad(k_dim, hw.mxu_align)
    n_pad = _pad(n_dim, hw.mxu_align)

    if spec.kind == "embed":
        # gather: one row per token
        mem = T * spec.out_dim * _weight_bytes_per_elem(w_bits)
        return UnitLatency(spec.name, 0.0, mem / (hw.hbm_bw * chips))

    # number of matmuls fused in this unit (e.g. gated MLP up+gate = 2)
    E_cnt = spec.extra.get("experts", 1) or 1
    n_mats = max(1.0, spec.weight_elems /
                 max(1, spec.in_dim * spec.out_dim * E_cnt))
    flops = 2.0 * T * k_pad * n_pad * n_mats
    expert_frac = 1.0
    if spec.kind in ("moe_up", "moe_down"):
        K = spec.extra["top_k"]
        flops = 2.0 * T * K * k_pad * n_pad * n_mats
        # weights touched: small batches only stream active experts' rows
        expert_frac = min(1.0, (ctx.batch * K) / E_cnt) \
            if ctx.mode == "decode" else 1.0

    w_elems = spec.weight_elems * keep_frac * in_frac * expert_frac
    w_bytes = w_elems * _weight_bytes_per_elem(w_bits)
    a_bytes = T * k_dim * _act_bytes_per_elem(a_bits) + T * n_dim * 2.0

    compute = flops / (_peak(w_bits, a_bits, hw) * chips)
    memory = (w_bytes + a_bytes) / (hw.hbm_bw * chips)

    # TP activation collective (all-reduce of the unit output) when sharded
    coll = 0.0
    if ctx.tp > 1 and spec.kind in ("attn_out", "mlp_down", "moe_down",
                                    "ssm_out", "rglru_out", "head"):
        coll = 2.0 * T * n_dim * 2.0 * (ctx.tp - 1) / ctx.tp / hw.ici_bw
    return UnitLatency(spec.name, compute, memory, coll)


def _attention_extra(spec: LayerSpec, cmp: LayerCMP, hw: HardwareTarget,
                     ctx: LatencyContext, window: int) -> UnitLatency:
    """Score+AV compute and KV-cache traffic for one attention layer."""
    hd = spec.extra.get("head_dim", 128)
    kv = spec.extra.get("kv_heads", 1)
    keep_heads = cmp.keep if spec.prune_dim else 0
    S = ctx.seq_ctx if window <= 0 else min(ctx.seq_ctx, window)
    chips = max(1, ctx.chips)
    flops = 4.0 * ctx.tokens * S * hd * keep_heads
    if ctx.mode in ("train", "prefill"):
        flops *= 0.5  # causal: half the positions on average
    cache_bytes = ctx.tokens * S * 2 * kv * hd * (ctx.cache_bits / 8.0)
    comp = flops / (hw.peak_bf16 * chips)
    mem = cache_bytes / (hw.hbm_bw * chips)
    return UnitLatency(spec.name + ".attn", comp, mem)


def _scale_unit(u: UnitLatency, f: float) -> UnitLatency:
    return UnitLatency(u.name, u.compute_s * f, u.memory_s * f,
                       u.collective_s * f)


def policy_latency(specs: Sequence[LayerSpec], policy: Policy,
                   hw: HardwareTarget = V5E,
                   ctx: Optional[LatencyContext] = None,
                   window: int = 0, calib=None) -> PolicyLatency:
    """The analytic oracle: per-unit roofline terms under ``policy``.
    ``calib``: optional measured-vs-analytic correction table
    (``core.measure.CalibrationTable``); unit terms are scaled by the
    fitted (kind, container) factor, attention extras and dispatch
    overhead by the lumped residual factors."""
    ctx = ctx or LatencyContext(tokens=1, seq_ctx=1, mode="decode")
    fracs = _resolve_keep_fracs(specs, policy)
    out = PolicyLatency()
    n_ops = 0
    for s, c in zip(specs, policy.cmps):
        in_frac = fracs.get(s.dep_group, 1.0) if s.dep_group else 1.0
        u = unit_latency(s, c, in_frac, hw, ctx)
        if calib is not None:
            w_bits, _ = effective_bits(c)
            u = _scale_unit(u, calib.factor(s.kind,
                                            container_for_bits(w_bits)))
        out.units.append(u)
        n_ops += 1
        if s.kind == "attn_qkv" and ctx.seq_ctx > 0:
            e = _attention_extra(s, c, hw, ctx, window)
            if calib is not None:
                e = _scale_unit(e, calib.extra_factor())
            out.units.append(e)
            n_ops += 1
    out.overhead_s = n_ops * hw.op_overhead \
        * (calib.overhead_factor() if calib is not None else 1.0)
    return out


def fifo_cached(cache: dict, max_entries: int, key, is_valid, factory):
    """Identity-guarded FIFO cache lookup, shared by the oracle and
    static-feature caches.

    Entries are value-keyed (``key`` may embed ``id()``s of
    identity-keyed operands); ``is_valid(hit)`` re-probes those
    identities so a recycled id can never serve a stale entry (the
    cached value holds strong refs, keeping live ids stable). On
    insert, the OLDEST entries are evicted (dict = insertion order) —
    a long multi-member search only recomputes one member's tables,
    never everyone's at once.
    """
    hit = cache.get(key)
    if hit is not None and is_valid(hit):
        return hit
    # drop a stale entry for this key first: the rebuild replaces it
    # (no growth, so nobody else gets evicted) and the fresh entry
    # takes a NEW insertion position instead of inheriting the old one
    cache.pop(key, None)
    while len(cache) >= max_entries:
        del cache[next(iter(cache))]
    hit = factory()
    cache[key] = hit
    return hit


# ===========================================================================
# Vectorized analytic oracle — K policies as one stack of array ops
# ===========================================================================

_COLL_KINDS = ("attn_out", "mlp_down", "moe_down", "ssm_out", "rglru_out",
               "head")


@dataclass
class BatchedPolicyLatency:
    """Latency of K policies at once; mirrors ``PolicyLatency`` totals.

    ``unit_time_s`` is (K, L) in spec order; ``extra_time_s`` is (K, E)
    for the attention score/AV+KV-cache terms, with ``extra_spec_idx``
    mapping each extra column back to its attn_qkv spec.
    """
    unit_time_s: np.ndarray
    extra_time_s: np.ndarray
    extra_spec_idx: np.ndarray
    overhead_s: float

    @property
    def total_s(self) -> np.ndarray:
        return (self.unit_time_s.sum(axis=1)
                + self.extra_time_s.sum(axis=1) + self.overhead_s)

    def decided_before(self, t: int) -> np.ndarray:
        """Per-policy latency of units with spec index < t (the AMC
        'reduced' bookkeeping feature, under the partial policy)."""
        out = self.unit_time_s[:, :t].sum(axis=1)
        if self.extra_time_s.shape[1]:
            cols = self.extra_spec_idx < t
            out = out + self.extra_time_s[:, cols].sum(axis=1)
        return out


class BatchOracle:
    """Precomputed per-spec tables; calling it evaluates a PolicyBatch
    with numpy array ops instead of the per-layer Python loop."""

    def __init__(self, specs: Sequence[LayerSpec], hw: HardwareTarget,
                 ctx: LatencyContext, window: int = 0, calib=None):
        self.specs, self.hw, self.ctx, self.window = specs, hw, ctx, window
        self.calib = calib
        if calib is not None:
            self.calib_f = np.asarray(calib.unit_factors(specs), np.float64)
            self.extra_f = float(calib.extra_factor())
            self.overhead_f = float(calib.overhead_factor())
        else:
            self.calib_f, self.extra_f, self.overhead_f = None, 1.0, 1.0
        L = len(specs)
        g = lambda f: np.asarray([f(s) for s in specs], np.float64)
        self.is_conv = np.asarray([s.kind == "conv" for s in specs])
        self.is_embed = np.asarray([s.kind == "embed" for s in specs])
        self.is_qkv = np.asarray([s.kind == "attn_qkv" for s in specs])
        self.is_moe = np.asarray([s.kind in ("moe_up", "moe_down")
                                  for s in specs])
        is_coll = np.asarray([s.kind in _COLL_KINDS for s in specs])
        self.prunable = np.asarray([bool(s.prunable and s.prune_dim)
                                    for s in specs])
        self.in_dim = g(lambda s: s.in_dim)
        self.out_dim = g(lambda s: s.out_dim)
        self.prune_dim = g(lambda s: s.prune_dim)
        self.weight_elems = g(lambda s: s.weight_elems)
        self.px = g(lambda s: s.extra.get("px", 1))
        self.hd = g(lambda s: s.extra.get("head_dim", 128))
        self.kv = g(lambda s: s.extra.get("kv_heads", 0))
        self.kv_cache = g(lambda s: s.extra.get("kv_heads", 1))
        e_cnt = g(lambda s: s.extra.get("experts", 1) or 1)
        self.n_mats = np.maximum(
            1.0, self.weight_elems /
            np.maximum(1.0, self.in_dim * self.out_dim * e_cnt))
        self.top_k = g(lambda s: s.extra.get("top_k", 1) or 1)
        if ctx.mode == "decode":
            self.expert_frac = np.where(
                self.is_moe,
                np.minimum(1.0, (ctx.batch * self.top_k) / e_cnt), 1.0)
        else:
            self.expert_frac = np.ones(L)
        # dep_group -> owning unit index (the mapping of
        # _resolve_keep_fracs, but positional)
        groups: dict[str, int] = {}
        for i, s in enumerate(specs):
            if not s.prunable or not s.prune_dim:
                continue
            if s.kind == "attn_qkv":
                groups[f"L{s.layer_idx}.heads"] = i
            elif s.kind == "mlp_up":
                grp = "dense_ff" if s.extra.get("dense_residual") else "ff"
                groups[f"L{s.layer_idx}.{grp}"] = i
            elif s.kind == "moe_up":
                groups[f"L{s.layer_idx}.moe_ff"] = i
            elif s.kind == "ssm_in":
                groups[f"L{s.layer_idx}.ssm_heads"] = i
            elif s.kind == "rglru_in":
                groups[f"L{s.layer_idx}.lru"] = i
        self.owner = np.asarray(
            [groups.get(s.dep_group, -1) if s.dep_group else -1
             for s in specs])
        T, tp = ctx.tokens, ctx.tp
        self.coll_coef = np.where(
            is_coll & (tp > 1),
            2.0 * T * 2.0 * (tp - 1) / max(1, tp) / hw.ici_bw, 0.0)
        # attention score/AV + KV-cache extras (one column per attn_qkv)
        self.extra_idx = np.nonzero(self.is_qkv)[0] if ctx.seq_ctx > 0 \
            else np.zeros((0,), np.int64)
        self.n_ops = L + len(self.extra_idx)

    def _pad(self, x: np.ndarray) -> np.ndarray:
        return pad_align(x, self.hw.mxu_align)

    def __call__(self, batch: PolicyBatch) -> BatchedPolicyLatency:
        hw, ctx = self.hw, self.ctx
        T, chips = ctx.tokens, max(1, ctx.chips)
        keep, wb, ab = batch.keep, batch.w_bits, batch.a_bits

        keep_frac = np.where(self.prune_dim > 0,
                             keep / np.maximum(self.prune_dim, 1.0), 1.0)
        in_frac = np.where(self.owner >= 0,
                           keep_frac[:, np.maximum(self.owner, 0)], 1.0)
        wbpe = np.where(wb >= 9, 2.0, np.where(wb >= 5, 1.0, 0.5))
        abpe = np.where(ab <= 8, 1.0, 2.0)
        peak = np.where((wb <= 8) & (ab <= 8), hw.peak_int8, hw.peak_bf16)

        k_dim = np.where(
            self.is_conv,
            (self.weight_elems / np.maximum(1.0, self.out_dim)) * in_frac,
            self.in_dim * in_frac)
        n_dim = np.where(
            self.is_qkv,
            keep_frac * (self.out_dim - 2 * self.kv * self.hd)
            + 2 * self.kv * self.hd,
            np.where(self.prunable, self.out_dim * keep_frac, self.out_dim))
        k_pad, n_pad = self._pad(k_dim), self._pad(n_dim)

        m_rows = np.where(self.is_conv, T * self.px, T)
        flops = 2.0 * m_rows * k_pad * n_pad * np.where(
            self.is_conv, 1.0,
            self.n_mats * np.where(self.is_moe, self.top_k, 1.0))
        w_bytes = (self.weight_elems * keep_frac * in_frac
                   * self.expert_frac * wbpe)
        a_bytes = m_rows * k_dim * abpe + m_rows * n_dim * 2.0

        compute = flops / (peak * chips)
        memory = (w_bytes + a_bytes) / (hw.hbm_bw * chips)
        compute = np.where(self.is_embed, 0.0, compute)
        memory = np.where(self.is_embed,
                          T * self.out_dim * wbpe / (hw.hbm_bw * chips),
                          memory)
        coll = self.coll_coef * n_dim
        unit_time = np.maximum(compute, memory) + coll
        if self.calib_f is not None:
            bucket = np.where(wb >= 9, 0, np.where(wb >= 5, 1, 2))
            unit_time = unit_time * self.calib_f[
                np.arange(len(self.specs))[None, :], bucket.astype(np.int64)]

        if len(self.extra_idx):
            q = self.extra_idx
            S = ctx.seq_ctx if self.window <= 0 \
                else min(ctx.seq_ctx, self.window)
            keep_heads = np.where(self.prune_dim[q] > 0, keep[:, q], 0.0)
            eflops = 4.0 * T * S * self.hd[q] * keep_heads
            if ctx.mode in ("train", "prefill"):
                eflops = eflops * 0.5
            cache = T * S * 2 * self.kv_cache[q] * self.hd[q] \
                * (ctx.cache_bits / 8.0)
            extra = np.maximum(eflops / (hw.peak_bf16 * chips),
                               cache / (hw.hbm_bw * chips))
        else:
            extra = np.zeros((len(batch), 0))
        return BatchedPolicyLatency(
            unit_time_s=unit_time, extra_time_s=extra * self.extra_f,
            extra_spec_idx=self.extra_idx,
            overhead_s=self.n_ops * hw.op_overhead * self.overhead_f)


_oracle_cache: dict = {}
_ORACLE_CACHE_MAX = 64


def get_batch_oracle(specs: Sequence[LayerSpec], hw: HardwareTarget,
                     ctx: LatencyContext, window: int = 0,
                     calib=None) -> BatchOracle:
    """The ``BatchOracle`` of (specs, hw, ctx, window, calib), built once:
    ctx and hw are frozen dataclasses, so value-keying is safe; specs
    and calib tables are identity-keyed with the ``fifo_cached``
    identity guard."""
    return fifo_cached(
        _oracle_cache, _ORACLE_CACHE_MAX,
        (id(specs), hw, ctx, window, id(calib) if calib is not None else None),
        lambda o: o.specs is specs and o.calib is calib,
        lambda: BatchOracle(specs, hw, ctx, window, calib))


def policy_latency_batch(
        specs: Sequence[LayerSpec],
        policies: Union[PolicyBatch, Sequence[Policy]],
        hw: HardwareTarget = V5E, ctx: Optional[LatencyContext] = None,
        window: int = 0, calib=None) -> BatchedPolicyLatency:
    """Vectorized ``policy_latency`` over a stack of K policies: the same
    roofline terms in float64, so ``out.total_s[k]`` equals
    ``policy_latency(specs, policies[k], ...).total_s`` up to summation
    order."""
    ctx = ctx or LatencyContext(tokens=1, seq_ctx=1, mode="decode")
    if not isinstance(policies, PolicyBatch):
        policies = stack_policies(specs, policies)
    return get_batch_oracle(specs, hw, ctx, window, calib)(policies)


# ===========================================================================
# Device oracle — the BatchOracle in f32 tensor ops, for the fused rollout
# ===========================================================================

class HwParams(NamedTuple):
    """The hardware rates the roofline divides by, as f32 tensors on the
    engine's device (``mxu_align`` stays on the oracle: it shapes the
    padding formula): 0-d for one target, or shaped (P, 1, 1) to
    broadcast one target per member over (P, K, L) policy rows
    (``stack_hw_params``)."""
    peak_bf16: torch.Tensor
    peak_int8: torch.Tensor
    hbm_bw: torch.Tensor
    ici_bw: torch.Tensor
    op_overhead: torch.Tensor


def hw_params(hw: HardwareTarget, device="cpu") -> HwParams:
    f32 = dict(dtype=torch.float32, device=device)
    return HwParams(*(torch.tensor(getattr(hw, k), **f32)
                      for k in HwParams._fields))


def stack_hw_params(hwps) -> HwParams:
    """P targets' 0-d ``HwParams`` as one with (P, 1, 1) fields: member p's
    rates broadcast over its (K, L) rows of a (P, K, L) policy block."""
    return HwParams(*(torch.stack(xs).reshape(-1, 1, 1)
                      for xs in zip(*hwps)))


def _per_row(rate: torch.Tensor) -> torch.Tensor:
    """A rate of ``HwParams`` shaped for per-policy totals: (P, 1) from a
    member-stacked (P, 1, 1), a 0-d one as it is."""
    return rate[..., 0] if rate.dim() else rate


class DeviceBatchOracle:
    """``BatchOracle``'s roofline as f32 tensor ops on ``device``: the
    counterpart of the JAX package's ``JaxBatchOracle``, the oracle the
    fused rollout probes every layer step. Its tables are borrowed from
    the (cached) ``BatchOracle``, calibration factors included, and live
    on the device, so a captured rollout reads them in place. Matches
    the float64 oracle up to f32 rounding, and the JAX one term for
    term. The policy tensors may carry leading axes: (K, L), or a
    population's (P, K, L) with member-stacked ``hwp`` (the JAX package's
    ``vmap`` over members); sums run over the last axis."""

    def __init__(self, specs: Sequence[LayerSpec], hw: HardwareTarget,
                 ctx: LatencyContext, window: int = 0, calib=None,
                 device="cpu"):
        b = get_batch_oracle(specs, hw, ctx, window, calib)
        dev = torch.device(device)
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=dev)
        flag = lambda x: torch.as_tensor(np.asarray(x, bool), device=dev)
        self.specs, self.hw, self.ctx, self.window = specs, hw, ctx, window
        self.calib, self.device = calib, dev
        self.calib_f = None if b.calib_f is None else f32(b.calib_f)
        self.extra_f = float(b.extra_f)
        self.overhead_f = float(b.overhead_f)
        self.hwp = hw_params(hw, dev)
        self.is_conv, self.is_embed = flag(b.is_conv), flag(b.is_embed)
        self.is_qkv, self.is_moe = flag(b.is_qkv), flag(b.is_moe)
        self.prunable = flag(b.prunable)
        self.in_dim, self.out_dim = f32(b.in_dim), f32(b.out_dim)
        self.prune_dim = f32(b.prune_dim)
        self.weight_elems = f32(b.weight_elems)
        self.px, self.hd, self.kv = f32(b.px), f32(b.hd), f32(b.kv)
        self.n_mats, self.top_k = f32(b.n_mats), f32(b.top_k)
        self.expert_frac = f32(b.expert_frac)
        self.owner = torch.as_tensor(np.maximum(b.owner, 0), device=dev)
        self.has_owner = flag(b.owner >= 0)
        # BatchOracle folds 1/ici_bw into coll_coef; keep the rate out
        self.coll_base = f32(b.coll_coef * hw.ici_bw)
        self.extra_idx = torch.as_tensor(b.extra_idx, device=dev)
        self.spec_idx = torch.arange(len(specs), device=dev)
        self.bucket_rows = self.spec_idx[None, :]
        self.n_ops = b.n_ops
        self.mxu_align = f32(hw.mxu_align)
        self.chips = float(max(1, ctx.chips))
        self.tokens = float(ctx.tokens)
        self.causal = ctx.mode in ("train", "prefill")
        self.seq = float(ctx.seq_ctx if window <= 0
                         else min(ctx.seq_ctx, window))
        if len(b.extra_idx):
            q = b.extra_idx
            self.extra_hd = f32(b.hd[q])
            self.extra_prunable = flag(b.prune_dim[q] > 0)
            self.extra_cache_bytes = f32(
                ctx.tokens * self.seq * 2 * b.kv_cache[q] * b.hd[q]
                * (ctx.cache_bits / 8.0))

    def _pad(self, x):
        return torch.ceil(torch.clamp_min(x, 1.0) / self.mxu_align) \
            * self.mxu_align

    def unit_times(self, keep, wb, ab, hwp: Optional[HwParams] = None):
        """(..., L) per-unit and (..., E) attention-extra times of the f32
        (..., L) policy tensors: the terms of ``BatchOracle.__call__``.
        ``hwp``: the rates to divide by (default this oracle's target's;
        a population passes its members', stacked)."""
        hwp = self.hwp if hwp is None else hwp
        T, chips = self.tokens, self.chips
        keep_frac = torch.where(
            self.prune_dim > 0, keep / torch.clamp_min(self.prune_dim, 1.0),
            torch.ones_like(keep))
        in_frac = torch.where(self.has_owner, keep_frac[..., self.owner],
                              torch.ones_like(keep))
        wbpe = torch.where(wb >= 9, 2.0, torch.where(wb >= 5, 1.0, 0.5))
        abpe = torch.where(ab <= 8, 1.0, 2.0)
        peak = torch.where((wb <= 8) & (ab <= 8), hwp.peak_int8,
                           hwp.peak_bf16)

        k_dim = torch.where(
            self.is_conv,
            (self.weight_elems / torch.clamp_min(self.out_dim, 1.0))
            * in_frac, self.in_dim * in_frac)
        n_dim = torch.where(
            self.is_qkv,
            keep_frac * (self.out_dim - 2 * self.kv * self.hd)
            + 2 * self.kv * self.hd,
            torch.where(self.prunable, self.out_dim * keep_frac,
                        self.out_dim))
        k_pad, n_pad = self._pad(k_dim), self._pad(n_dim)

        m_rows = torch.where(self.is_conv, T * self.px,
                             torch.full_like(self.px, T))
        flops = 2.0 * m_rows * k_pad * n_pad * torch.where(
            self.is_conv, torch.ones_like(self.n_mats),
            self.n_mats * torch.where(self.is_moe, self.top_k,
                                      torch.ones_like(self.top_k)))
        w_bytes = (self.weight_elems * keep_frac * in_frac
                   * self.expert_frac * wbpe)
        a_bytes = m_rows * k_dim * abpe + m_rows * n_dim * 2.0

        compute = flops / (peak * chips)
        memory = (w_bytes + a_bytes) / (hwp.hbm_bw * chips)
        compute = torch.where(self.is_embed, 0.0, compute)
        memory = torch.where(
            self.is_embed, T * self.out_dim * wbpe / (hwp.hbm_bw * chips),
            memory)
        coll = self.coll_base / hwp.ici_bw * n_dim
        unit_time = torch.maximum(compute, memory) + coll
        if self.calib_f is not None:
            bucket = torch.where(wb >= 9, 0, torch.where(wb >= 5, 1, 2))
            unit_time = unit_time * self.calib_f[self.bucket_rows, bucket]

        if len(self.extra_idx):
            keep_heads = torch.where(self.extra_prunable,
                                     keep[..., self.extra_idx], 0.0)
            eflops = 4.0 * T * self.seq * self.extra_hd * keep_heads
            if self.causal:
                eflops = eflops * 0.5
            extra = torch.maximum(
                eflops / (hwp.peak_bf16 * chips),
                self.extra_cache_bytes / (hwp.hbm_bw * chips)) \
                * self.extra_f
        else:
            extra = keep.new_zeros((*keep.shape[:-1], 0))
        return unit_time, extra

    def totals(self, unit_time, extra_time,
               hwp: Optional[HwParams] = None):
        hwp = self.hwp if hwp is None else hwp
        return (unit_time.sum(dim=-1) + extra_time.sum(dim=-1)
                + self.n_ops * _per_row(hwp.op_overhead) * self.overhead_f)

    def decided_before(self, unit_time, extra_time, t: int):
        """Per-policy latency of units with spec index < t: the device
        form of ``BatchedPolicyLatency.decided_before`` (masked sums over
        the whole row, as the JAX oracle takes them)."""
        out = (unit_time * (self.spec_idx < t)).sum(dim=-1)
        if len(self.extra_idx):
            out = out + (extra_time * (self.extra_idx < t)).sum(dim=-1)
        return out


_device_oracle_cache: dict = {}


def get_device_oracle(specs: Sequence[LayerSpec], hw: HardwareTarget,
                      ctx: LatencyContext, window: int = 0, calib=None,
                      device="cpu") -> DeviceBatchOracle:
    """FIFO-evicting cache, the keying of ``get_batch_oracle`` plus the
    device."""
    dev = torch.device(device)
    return fifo_cached(
        _device_oracle_cache, _ORACLE_CACHE_MAX,
        (id(specs), hw, ctx, window, id(calib) if calib is not None
         else None, str(dev)),
        lambda o: o.specs is specs and o.calib is calib,
        lambda: DeviceBatchOracle(specs, hw, ctx, window, calib, dev))
