"""Sensitivity analysis (paper Eq. 5, generalized ZeroQ), probe by probe.

For each layer and each probe CMP, compress ONLY that layer (reference
policy elsewhere) and measure the KL divergence between the compressed and
the original model's output distributions over N calibration samples:

    Ω(P) = 1/N Σ_j D_KL( M_P(θ;x_j) || M(θ;x_j) )

Every probe CMP is **legalized** first (``constraints.legalize``), so the
KL features describe policies the agent can reach. The port evaluates the
plan one probe at a time (the JAX package's
``run_sensitivity_sequential``); probes that legalize to the same policy
are evaluated once. The JAX package's fused one-dispatch analysis waits
for the batched engines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .constraints import legalize
from .policy import Policy, PolicyBatch, policies_from_batch, stack_policies
from .spec import LayerCMP, LayerSpec, effective_bits


def kl_divergence(logp_c: torch.Tensor, logp_o: torch.Tensor) -> torch.Tensor:
    """D_KL(compressed || original) averaged over batch (and positions)."""
    p_c = torch.exp(logp_c)
    kl = torch.sum(p_c * (logp_c - logp_o), dim=-1)
    return torch.mean(kl)


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


def plan_kls(cmodel, batch, plan: ProbePlan) -> np.ndarray:
    """(P,) probe KLs, one forward per distinct probe policy. Each KL is
    reduced on the device; the host reads all of them once at the end."""
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


def run_sensitivity(cmodel, batch) -> SensitivityResult:
    """The agent-state analysis: legalized feature probes for every
    layer. ``cmodel``: ``CompressibleLM`` or ``CompressibleResNet``;
    ``batch``: calibration data (tokens or labelled images)."""
    plan = build_probe_plan(cmodel.specs)
    kls = plan_kls(cmodel, batch, plan)
    table: Dict[str, Dict[str, float]] = {s.name: {} for s in cmodel.specs}
    for e, kl in zip(plan.entries, kls):
        table[e.layer][e.tag] = float(kl)
    return SensitivityResult(table)
