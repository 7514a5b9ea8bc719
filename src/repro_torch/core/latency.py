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
overhead by the lumped residual factors. The batched and traced oracle
forms wait for the batched engines.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .policy import Policy
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


def _pad(x: float, align: int) -> float:
    """MXU-lane padding: ceil(max(x, 1) / align) * align."""
    return float(np.ceil(np.maximum(x, 1.0) / align) * align)


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
