"""Measured-latency oracle: the port's stand-in for the paper's
compile-and-measure loop (Galen compiles each candidate policy and times
it on the target; analytic proxies can mis-rank policies).

Three layers, bottom-up:

* **Unit measurement** (``measure_unit_rows``) — for every layer spec,
  the deploy-path op the policy would execute
  (``deploy.quantize_weight`` container -> ``layers.materialize_weight``
  -> matmul; a gather for embeddings) in each weight container (raw /
  int8 / packed int4), timed best-of-N with ``torch.cuda.synchronize``
  fencing, next to the analytic roofline term of the same (spec,
  container). ``measure_kernel_rows`` times the quantized-matmul kernels
  K4 and K5 (``kernels.ops.quantized_matmul``) beside a dense f32 matmul.

* **Calibration** (``fit_calibration`` -> ``CalibrationTable``) — per
  (layer kind, container) geometric-mean measured/analytic ratios, plus a
  lumped residual for the attention extras and dispatch overhead fitted
  from a whole-model measurement. The JSON keys are the JAX package's,
  so either package reads the other's file; the port's own file is
  ``artifacts/torch_latency_calibration.json``
  (``python -m repro_torch.launch.calibrate``).

* **Policy measurement** (``measure_policy``) — deploy a search policy
  onto integer containers (``quantize_params_for_deploy(bits_for=...)``)
  and time the deployed forward. FIFO-memoized by the policy's container
  signature, so ``oracle_mode="measured"`` re-times only distinct top-K
  candidates.

Deployment is by weight NAME, as in the JAX package (whose scan-stacked
layers share one array per name): a policy deploys each name at the
WIDEST container any layer asks for, and structured pruning is not
materialized. XLA's compiled cost analysis (the JAX package's
``roofline_from_compiled``) has no counterpart here, so model rows carry
no ``"roofline"`` key.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .deploy import quantize_params_for_deploy, quantize_weight
from .latency import (CONTAINERS, V5E, HardwareTarget, LatencyContext,
                      container_for_bits, fifo_cached, policy_latency,
                      unit_latency)
from .policy import Policy
from .spec import LayerCMP, LayerSpec, effective_bits

# The port's own table, measured on the card it runs on; never the JAX
# package's artifacts/latency_calibration.json.
DEFAULT_CALIBRATION_PATH = str(Path(__file__).resolve().parents[3]
                               / "artifacts"
                               / "torch_latency_calibration.json")

# Container -> the LayerCMP whose analytic term the measurement is
# compared against (full width kept; the containers differ only in
# weight storage, which is what the deploy path changes).
CONTAINER_BITS = {"raw": None, "int8": 8, "int4": 4}


def _container_cmp(spec: LayerSpec, container: str) -> LayerCMP:
    keep = spec.prune_dim if spec.prune_dim else 0
    if container == "raw":
        return LayerCMP(keep=keep, mode="FP32")
    if container == "int8":
        return LayerCMP(keep=keep, mode="INT8", w_bits=8, a_bits=8)
    return LayerCMP(keep=keep, mode="MIX", w_bits=4, a_bits=4)


@dataclass(frozen=True)
class MeasureConfig:
    warmup: int = 2
    repeats: int = 5
    tokens: int = 64          # rows fed to each unit op (the m dimension)
    seed: int = 0


def _fence(out) -> None:
    """Wait for the device work behind ``out`` (the counterpart of
    ``jax.block_until_ready``)."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def time_best(fn: Callable[[], object], warmup: int = 2,
              repeats: int = 5) -> float:
    """Best-of-N host wall clock of ``fn()``, each call fenced by a device
    sync: the latency a caller sees, launches included."""
    for _ in range(max(1, warmup)):
        _fence(fn())
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        _fence(fn())
        best = min(best, time.perf_counter() - t0)
    return best


# ===========================================================================
# Unit measurement
# ===========================================================================

def _unit_dims(spec: LayerSpec) -> tuple:
    """(k, n) of the dense-equivalent matmul a unit executes on the deploy
    path. Convs are their im2col view; gated MLPs fold the up+gate
    matmuls into one widened n (the FLOPs/bytes the analytic unit
    charges)."""
    if spec.kind == "conv":
        k = int(round(spec.weight_elems / max(1, spec.out_dim)))
        return k, int(spec.out_dim)
    if spec.kind == "embed":
        return int(spec.in_dim), int(spec.out_dim)      # vocab rows, d cols
    k = int(spec.in_dim)
    return k, int(round(spec.weight_elems / max(1, k)))


def _unit_callable(spec: LayerSpec, container: str, m: int,
                   gen: torch.Generator, device):
    """The deploy-path op of one (spec, container): materialize the
    integer container and run the consuming op, as ``models/layers.py``
    does at serving time."""
    from ..models.layers import materialize_weight

    k, n = _unit_dims(spec)
    w = torch.randn((k, n), generator=gen, device=device)
    p = {"w": w} if container == "raw" \
        else quantize_weight(w, CONTAINER_BITS[container])
    if spec.kind == "embed":
        ids = torch.randint(0, k, (m,), generator=gen, device=device)
        return lambda: torch.index_select(
            materialize_weight(p, torch.float32), 0, ids)
    x = torch.randn((m, k), generator=gen, device=device)
    return lambda: x @ materialize_weight(p, x.dtype)


@torch.no_grad()
def measure_unit_rows(specs: Sequence[LayerSpec],
                      hw: HardwareTarget = V5E,
                      ctx: Optional[LatencyContext] = None,
                      cfg: MeasureConfig = MeasureConfig(),
                      device="cuda") -> list:
    """Measured-vs-analytic rows per (unique unit shape, container).

    MoE expert stacks have no dense 2-D equivalent and fall back to the
    1.0 factor; the skip is recorded as an explicit row, as is an int4
    container on an odd contraction dim, so the table never silently
    reads as full coverage."""
    ctx = ctx or LatencyContext(tokens=cfg.tokens, seq_ctx=0, mode="prefill")
    mctx = dataclasses.replace(ctx, tokens=cfg.tokens)
    rows, seen = [], set()
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    for spec in specs:
        if spec.kind in ("moe_up", "moe_down"):
            rows.append({"kind": spec.kind, "name": spec.name,
                         "skipped": "stacked expert weights"})
            continue
        k, n = _unit_dims(spec)
        for container in CONTAINERS:
            if container == "int4" and k % 2:
                rows.append({"kind": spec.kind, "name": spec.name,
                             "container": container,
                             "skipped": "odd contraction dim"})
                continue
            sig = (spec.kind, k, n, container)
            if sig in seen:         # repeated layers repeat shapes
                continue
            t = time_best(_unit_callable(spec, container, cfg.tokens, gen,
                                         device), cfg.warmup, cfg.repeats)
            ana = unit_latency(spec, _container_cmp(spec, container),
                               1.0, hw, mctx).time_s
            seen.add(sig)
            rows.append({"kind": spec.kind, "name": spec.name,
                         "container": container, "k": k, "n": n,
                         "m": cfg.tokens, "measured_s": t,
                         "analytic_s": ana,
                         "ratio": t / ana if ana > 0 else float("inf")})
    return rows


@torch.no_grad()
def measure_kernel_rows(cfg: MeasureConfig = MeasureConfig(),
                        dims: tuple = (256, 256, 256),
                        device="cuda") -> list:
    """Rows timing the quantized-matmul kernels (K4 int8, K5 packed int4,
    through ``kernels.ops.quantized_matmul``, its quantization steps
    included) against the dense f32 matmul of the same shape. The
    deployed forward uses the dequantize-into-matmul path measured by
    ``measure_unit_rows``; these rows track the kernel alternative."""
    from ..kernels import ops

    M, K, N = dims
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    x = torch.randn((M, K), generator=gen, device=device)
    w = torch.randn((K, N), generator=gen, device=device)
    rows = [{"kernel": "dense_f32", "M": M, "K": K, "N": N,
             "measured_s": time_best(lambda: x @ w, cfg.warmup,
                                     cfg.repeats)}]
    for bits, name in ((8, "quant_matmul_int8"), (4, "quant_matmul_int4")):
        t = time_best(lambda: ops.quantized_matmul(x, w, w_bits=bits),
                      cfg.warmup, cfg.repeats)
        rows.append({"kernel": name, "M": M, "K": K, "N": N,
                     "measured_s": t})
    return rows


# ===========================================================================
# Calibration table
# ===========================================================================

@dataclass
class CalibrationTable:
    """Measured/analytic correction factors, keyed (kind, container).

    ``ratios[kind][container]`` scales that unit's roofline term;
    ``extra["attn"]`` scales the attention score/AV + KV-cache extras and
    ``extra["overhead"]`` the per-op dispatch overhead (both lumped
    residuals from a whole-model fit). Unknown kinds/containers fall back
    to 1.0, so a partial table degrades to the analytic oracle."""
    ratios: dict
    extra: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    def factor(self, kind: str, container: str) -> float:
        return float(self.ratios.get(kind, {}).get(container, 1.0))

    def extra_factor(self) -> float:
        return float(self.extra.get("attn", 1.0))

    def overhead_factor(self) -> float:
        return float(self.extra.get("overhead", 1.0))

    def unit_factors(self, specs: Sequence[LayerSpec]) -> np.ndarray:
        """(L, 3) per-spec factors in ``latency.CONTAINERS`` column
        order."""
        out = np.ones((len(specs), len(CONTAINERS)), np.float64)
        for i, s in enumerate(specs):
            for j, c in enumerate(CONTAINERS):
                out[i, j] = self.factor(s.kind, c)
        return out

    def to_dict(self) -> dict:
        return {"ratios": self.ratios, "extra": self.extra, "meta": self.meta}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "CalibrationTable":
        return cls(ratios=d.get("ratios", {}), extra=d.get("extra", {}),
                   meta=d.get("meta", {}))

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def load_calibration(path: Optional[str] = None) -> CalibrationTable:
    """Load a calibration table; by default the port's own
    ``artifacts/torch_latency_calibration.json``."""
    try:
        return CalibrationTable.load(path or DEFAULT_CALIBRATION_PATH)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"calibration table not found at "
            f"{path or DEFAULT_CALIBRATION_PATH!r}: measure it on the card "
            f"with `python -m repro_torch.launch.calibrate` or pass "
            f"calib= explicitly") from None


def fit_calibration(unit_rows: Sequence[dict],
                    meta: Optional[dict] = None) -> CalibrationTable:
    """Geometric-mean measured/analytic ratio per (kind, container)."""
    logs: dict = {}
    for r in unit_rows:
        if "ratio" not in r or not np.isfinite(r["ratio"]) or r["ratio"] <= 0:
            continue
        logs.setdefault(r["kind"], {}).setdefault(
            r["container"], []).append(np.log(r["ratio"]))
    ratios = {k: {c: float(np.exp(np.mean(v))) for c, v in d.items()}
              for k, d in logs.items()}
    return CalibrationTable(ratios=ratios, meta=meta or {})


def fit_extra_factor(table: CalibrationTable, specs: Sequence[LayerSpec],
                     ref_policy: Policy, measured_total_s: float,
                     hw: HardwareTarget, ctx: LatencyContext,
                     window: int = 0) -> None:
    """Fit the lumped attention/overhead residual in place: whatever the
    whole-model measurement shows beyond the calibrated unit terms is
    attributed to the extras (attention score/AV, norms, dispatch). The
    extra factors are reset first, so refitting is idempotent."""
    table.extra["attn"] = table.extra["overhead"] = 1.0
    pl = policy_latency(specs, ref_policy, hw, ctx, window, calib=table)
    unit_s = sum(u.time_s for u in pl.units if not u.name.endswith(".attn"))
    extra_s = sum(u.time_s for u in pl.units if u.name.endswith(".attn"))
    extra_s += pl.overhead_s
    if extra_s > 0:
        f = max(0.0, (measured_total_s - unit_s)) / extra_s
        table.extra["attn"] = f
        table.extra["overhead"] = f


# ===========================================================================
# Whole-policy deployment + measurement
# ===========================================================================

def spec_param_names(spec: LayerSpec) -> tuple:
    """Param-tree weight names a spec's policy decision governs (the
    names ``quantize_params_for_deploy`` keys containers by)."""
    k = spec.kind
    if k == "embed":
        return ("embed",)
    if k == "head":
        return ("unembed", "head")
    if k == "attn_qkv":
        return ("wq", "wk", "wv")
    if k == "attn_out":
        return ("wo",)
    if k == "mlp_up":
        return ("dense_w_up", "dense_w_gate") \
            if spec.extra.get("dense_residual") else ("w_up", "w_gate")
    if k == "mlp_down":
        return ("dense_w_down",) \
            if spec.extra.get("dense_residual") else ("w_down",)
    if k == "moe_up":
        return ("w_up", "w_gate")
    if k == "moe_down":
        return ("w_down",)
    if k == "ssm_in":
        return ("in_proj",)
    if k == "ssm_out":
        return ("out_proj",)
    if k == "rglru_in":
        return ("w_x", "w_y")
    if k == "rglru_out":
        return ("w_out",)
    if k == "conv":
        return ("stem", "conv1", "conv2", "skip")
    return ()


def policy_bits_by_name(specs: Sequence[LayerSpec],
                        policy: Policy) -> dict:
    """Weight name -> deployed bit width (>8 = raw). Deployment is by
    name, so the WIDEST width any layer asks for wins: no layer is
    quantized harder than its policy allows."""
    bits: dict = {}
    for s, c in zip(specs, policy.cmps):
        wb, _ = effective_bits(c)
        for name in spec_param_names(s):
            bits[name] = max(bits.get(name, 0), int(wb))
    return bits


def deploy_policy_params(cmodel, policy: Policy):
    """A search policy's quantization decisions as real integer weight
    containers on the model's params."""
    bits = policy_bits_by_name(cmodel.specs, policy)
    return quantize_params_for_deploy(cmodel.params,
                                      bits_for=lambda n: bits.get(n))


def _deployed_forward(cmodel):
    """fn(deployed params, batch) -> logits: the deployed forward of a
    ``CompressibleLM`` or a ``CompressibleResNet``. The ResNet's takes raw
    weights only, as the JAX package's does (whose ``resnet._conv`` reads
    ``p["w"]``): a tree holding an int8 or packed-int4 container raises
    ``ValueError`` (``models.resnet.RAW_ONLY``)."""
    cfg = cmodel.cfg
    if not hasattr(cfg, "vocab_size"):
        from ..models import resnet as R

        @torch.no_grad()
        def fwd_resnet(qp, batch):
            return R.forward(cfg, qp, batch["images"])
        return fwd_resnet
    from ..models import model as M

    @torch.no_grad()
    def fwd(qp, batch):
        return M.forward(cfg, qp, batch["tokens"])
    return fwd


_measure_memo: dict = {}
_MEASURE_MEMO_MAX = 32


def measure_policy(cmodel, policy: Policy, batch: dict,
                   cfg: MeasureConfig = MeasureConfig()) -> float:
    """Wall-clock seconds of the deployed forward under ``policy``'s
    containers. FIFO-memoized on (model params, batch, container
    signature): ``oracle_mode="measured"`` re-times only distinct top-K
    candidates, and repeated winners are free."""
    bits = policy_bits_by_name(cmodel.specs, policy)
    sig = tuple(sorted((n, container_for_bits(b)) for n, b in bits.items()))
    key = (id(cmodel.params), id(batch), sig, cfg)

    def factory():
        qp = quantize_params_for_deploy(cmodel.params,
                                        bits_for=lambda n: bits.get(n))
        fwd = _deployed_forward(cmodel)
        t = time_best(lambda: fwd(qp, batch), cfg.warmup, cfg.repeats)
        # hold refs so the identity key can't be recycled under us
        return (cmodel.params, batch, t)

    hit = fifo_cached(_measure_memo, _MEASURE_MEMO_MAX, key,
                      lambda h: h[0] is cmodel.params and h[1] is batch,
                      factory)
    return hit[2]


def measure_model_row(cmodel, batch: dict, container: str,
                      cfg: MeasureConfig = MeasureConfig()) -> dict:
    """Whole-model deployed-forward measurement for a uniform container.
    Deploys through ``uniform_policy``, so the measurement and the
    calibrated oracle's prediction describe the same containers
    (mix-unsupported embed/head ride int8 in the "int4" row)."""
    qp = cmodel.params if container == "raw" else deploy_policy_params(
        cmodel, uniform_policy(cmodel.specs, container))
    fwd = _deployed_forward(cmodel)
    t = time_best(lambda: fwd(qp, batch), cfg.warmup, cfg.repeats)
    return {"container": container, "measured_s": t}


def uniform_policy(specs: Sequence[LayerSpec], container: str) -> Policy:
    """Uniform-quantization policy matching ``measure_model_row``'s
    deployment: INT8 everywhere for "int8"; 4-bit MIX where supported
    (INT8 on mix-unsupported embed/head) for "int4"."""
    pol = Policy.reference(specs)
    if container == "raw":
        return pol
    for s, c in zip(specs, pol.cmps):
        if not s.quantizable:
            continue
        if container == "int8" or not s.mix_supported:
            c.mode, c.w_bits, c.a_bits = "INT8", 8, 8
        else:
            c.mode, c.w_bits, c.a_bits = "MIX", 4, 4
    return pol
