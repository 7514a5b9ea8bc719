"""Sensitivity analysis (paper Eq. 5, generalized ZeroQ), fused.

For each layer and each probe CMP, compress ONLY that layer (reference
policy elsewhere) and measure the KL divergence between the compressed and
the original model's output distributions over N calibration samples:

    Ω(P) = 1/N Σ_j D_KL( M_P(θ;x_j) || M(θ;x_j) )

Every probe CMP is **legalized** first (``constraints.legalize``), so the
KL features describe policies the agent can reach.

``run_sensitivity`` evaluates the whole layer × probe plan in chunks of C
probe policies, each chunk ONE batched forward over C policy slots
(``log_probs_batch``: the batched validation's slot axis, K1 once per
fake-quant site for the C slots), its KLs reduced on the device and read
back once at the end (the JAX package's fused analysis, whose probe loop
is a ``lax.scan`` over vmapped chunks). Probes that legalize to one
policy are evaluated once. Results are memoized on the adapter per
(batch, params) identity, so every engine built on one model, every
member of a ``PopulationSearch``, shares one analysis (and the same
``SensitivityResult`` object, which shared rollouts require).
``run_sensitivity_sequential`` keeps the one-forward-per-probe path as the
parity reference; ``full_sweep`` is the paper's Fig. 6 sweep over the same
fused core.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .constraints import legalize
from .latency import fifo_cached
from .policy import Policy, PolicyBatch, policies_from_batch, stack_policies
from .spec import LayerCMP, LayerSpec, effective_bits


def kl_divergence(logp_c: torch.Tensor, logp_o: torch.Tensor) -> torch.Tensor:
    """D_KL(compressed || original) averaged over batch (and positions)."""
    p_c = torch.exp(logp_c)
    kl = torch.sum(p_c * (logp_c - logp_o), dim=-1)
    return torch.mean(kl)


# probe CMPs of the dense sweep (paper: a predefined number of sample
# policies)
QUANT_W_PROBES = (8, 6, 4, 3, 2)
QUANT_A_PROBES = (8, 6, 4, 3, 2)
N_PRUNE_PROBES = 10

# the fixed probe set feeding the agent state (see SensitivityResult)
FEATURE_W_PROBES = (4, 2)
FEATURE_A_PROBES = (4, 2)
FEATURE_PRUNE_FRACS = (0.5, 0.25)
FEATURE_PROBES = ("w4", "w2", "a4", "a2", "p50", "p25")

# Sentinel for probes that were never run (layer not quantizable / not
# prunable): a probed-and-robust layer reads 0.0 (log1p(0)), an unprobed
# one reads MISSING_KL.
MISSING_KL = -1.0


@dataclass
class SensitivityResult:
    """per layer-spec name -> {probe_name: KL}"""
    table: Dict[str, Dict[str, float]]

    def feature_row(self, name: str) -> np.ndarray:
        """(len(FEATURE_PROBES),) f32 probe features for one layer:
        log1p-squashed KLs, ``MISSING_KL`` where the probe was not run."""
        row = self.table.get(name, {})
        return np.asarray(
            [np.log1p(row[k]) if k in row else MISSING_KL
             for k in FEATURE_PROBES], np.float32)


@dataclass(frozen=True)
class ProbeEntry:
    """One layer×probe row of a plan."""
    spec_idx: int
    layer: str
    method: str                # quant_w | quant_a | prune
    param: float               # bits (quant) or kept fraction (prune)
    tag: str                   # feature key, e.g. "w4" / "p50"


@dataclass
class ProbePlan:
    """All probes of one analysis in array form: row p of the (P, L)
    arrays is the reference policy with column ``entries[p].spec_idx``
    replaced by the **legalized** probe CMP (effective bits)."""
    entries: List[ProbeEntry]
    keep: np.ndarray           # (P, L) f64
    w_bits: np.ndarray         # (P, L) f64
    a_bits: np.ndarray         # (P, L) f64
    ref: Tuple[np.ndarray, np.ndarray, np.ndarray]   # (L,) each


def build_probe_plan(specs: Sequence[LayerSpec],
                     w_probes: Sequence[int] = FEATURE_W_PROBES,
                     a_probes: Sequence[int] = FEATURE_A_PROBES,
                     prune_fracs: Sequence[float] = FEATURE_PRUNE_FRACS
                     ) -> ProbePlan:
    """Enumerate the layer×probe single-layer policies, each routed
    through ``legalize`` so the plan only contains reachable CMPs."""
    ref_pb = stack_policies(specs, [Policy.reference(specs)])
    ref = (ref_pb.keep[0], ref_pb.w_bits[0], ref_pb.a_bits[0])
    entries: List[ProbeEntry] = []
    rows: List[Tuple[float, float, float]] = []

    def add(i: int, cmp: LayerCMP, method: str, param, tag: str):
        cmp = legalize(specs[i], cmp)
        w, a = effective_bits(cmp)
        entries.append(ProbeEntry(i, specs[i].name, method, param, tag))
        rows.append((float(cmp.keep), float(w), float(a)))

    for i, s in enumerate(specs):
        if s.quantizable:
            for b in w_probes:
                add(i, LayerCMP(keep=s.prune_dim, mode="MIX",
                                w_bits=int(b), a_bits=32),
                    "quant_w", b, f"w{int(b)}")
            for b in a_probes:
                add(i, LayerCMP(keep=s.prune_dim, mode="MIX",
                                w_bits=32, a_bits=int(b)),
                    "quant_a", b, f"a{int(b)}")
        if s.prunable and s.prune_dim:
            for frac in prune_fracs:
                add(i, LayerCMP(keep=max(1, int(s.prune_dim * float(frac)))),
                    "prune", float(frac),
                    f"p{int(round(float(frac) * 100))}")

    P, L = len(entries), len(specs)
    keep = np.tile(ref[0], (P, 1))
    wb = np.tile(ref[1], (P, 1))
    ab = np.tile(ref[2], (P, 1))
    for p, (e, row) in enumerate(zip(entries, rows)):
        keep[p, e.spec_idx], wb[p, e.spec_idx], ab[p, e.spec_idx] = row
    return ProbePlan(entries, keep, wb, ab, ref)


_plan_cache: dict = {}
_PLAN_CACHE_MAX = 256


def feature_probe_plan(specs: Sequence[LayerSpec]) -> ProbePlan:
    """The agent-state probe plan, cached per spec-list identity."""
    return fifo_cached(_plan_cache, _PLAN_CACHE_MAX, id(specs),
                       lambda h: h[0] is specs,
                       lambda: (specs, build_probe_plan(specs)))[1]


def _plan_kls(cmodel, batch, plan: ProbePlan, chunk: int) -> np.ndarray:
    """(P,) probe KLs of a plan, fused: the distinct probe rows, padded to
    a multiple of ``chunk`` with reference rows (KL 0; equal chunks, one
    launch grid), go through the batched forward ``chunk`` policies at a
    time (``cspec_builder`` -> ``log_probs_batch``), each slot's KL
    against the reference log-probs reduced on the device; one readback,
    the padding dropped and the KLs fanned back out to the probes."""
    P, L = plan.keep.shape
    if P == 0:
        return np.zeros((0,), np.float64)
    rows = np.concatenate([plan.keep, plan.w_bits, plan.a_bits], axis=1)
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    U = uniq.shape[0]
    chunk = max(1, min(int(chunk), U))
    pad = (-U) % chunk
    if pad:
        uniq = np.concatenate([uniq, np.tile(np.concatenate(plan.ref),
                                             (pad, 1))])
    build = cmodel.cspec_builder()
    logp_o = cmodel.log_probs(batch, cmodel.build_cspec(
        Policy.reference(cmodel.specs)))
    kls = []
    for c0 in range(0, U + pad, chunk):
        blk = uniq[c0:c0 + chunk]
        lp = cmodel.log_probs_batch(batch, build(
            blk[:, :L], blk[:, L:2 * L], blk[:, 2 * L:]))
        kls += [kl_divergence(lp[c], logp_o) for c in range(chunk)]
    kls = torch.stack(kls).double().cpu().numpy()[:U]
    return kls[inverse.reshape(-1)]


def _plan_kls_sequential(cmodel, batch, plan: ProbePlan) -> np.ndarray:
    """(P,) probe KLs, one forward per distinct probe policy (the host
    cspec, ``build_cspec``). Each KL is reduced on the device; the host
    reads all of them once at the end."""
    specs = cmodel.specs
    logp_o = cmodel.log_probs(batch, cmodel.build_cspec(
        Policy.reference(specs)))
    rows = np.concatenate([plan.keep, plan.w_bits, plan.a_bits], axis=1)
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    L = len(specs)
    pols = policies_from_batch(specs, PolicyBatch(
        keep=uniq[:, :L], w_bits=uniq[:, L:2 * L], a_bits=uniq[:, 2 * L:]))
    kls = torch.stack([
        kl_divergence(cmodel.log_probs(batch, cmodel.build_cspec(pol)),
                      logp_o) for pol in pols])
    return kls.double().cpu().numpy()[inverse.reshape(-1)]


def _result_from_plan(specs, plan: ProbePlan,
                      kls: np.ndarray) -> SensitivityResult:
    table: Dict[str, Dict[str, float]] = {s.name: {} for s in specs}
    for e, kl in zip(plan.entries, kls):
        table[e.layer][e.tag] = float(kl)
    return SensitivityResult(table)


_MEMO_CACHE_MAX = 8                    # per adapter instance
DEFAULT_CHUNK = 8


def run_sensitivity(cmodel, batch, chunk: int = DEFAULT_CHUNK,
                    memo: bool = True) -> SensitivityResult:
    """The agent-state analysis: legalized feature probes for every
    layer, fused (``_plan_kls``: ``chunk`` probe policies a forward).
    ``cmodel``: ``CompressibleLM`` or ``CompressibleResNet``; ``batch``:
    calibration data (tokens or labelled images). ``memo=True`` shares
    the result across callers with the same (cmodel, batch, params)
    identity; the memo lives on the adapter, so it does not outlive the
    model."""
    plan = feature_probe_plan(cmodel.specs)

    def compute():
        kls = _plan_kls(cmodel, batch, plan, chunk)
        return (batch, cmodel.params,
                _result_from_plan(cmodel.specs, plan, kls))

    if not memo:
        return compute()[2]
    cache = getattr(cmodel, "_sens_memo", None)
    if cache is None:
        cache = cmodel._sens_memo = {}
    return fifo_cached(cache, _MEMO_CACHE_MAX, id(batch),
                       lambda h: h[0] is batch and h[1] is cmodel.params,
                       compute)[2]


def run_sensitivity_sequential(cmodel, batch) -> SensitivityResult:
    """The parity reference of ``run_sensitivity``: the same legalized
    plan, one forward per distinct probe policy through the host cspec
    builder (the port's analysis before the fused one)."""
    plan = feature_probe_plan(cmodel.specs)
    return _result_from_plan(cmodel.specs, plan,
                             _plan_kls_sequential(cmodel, batch, plan))


def full_sweep(cmodel, batch, w_bits=QUANT_W_PROBES, a_bits=QUANT_A_PROBES,
               n_prune: int = N_PRUNE_PROBES,
               chunk: int = DEFAULT_CHUNK) -> List[dict]:
    """The dense sweep of the paper's Fig. 6 over the same fused core as
    ``run_sensitivity``, every probe legalized the same way: one row per
    layer × probe, ``{"layer", "method", "param", "kl"}``."""
    plan = build_probe_plan(
        cmodel.specs, w_probes=w_bits, a_probes=a_bits,
        prune_fracs=tuple(float(f) for f in np.linspace(0.1, 1.0, n_prune)))
    kls = _plan_kls(cmodel, batch, plan, chunk)
    return [{"layer": e.layer, "method": e.method, "param": e.param,
             "kl": float(kl)} for e, kl in zip(plan.entries, kls)]
