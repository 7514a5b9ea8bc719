"""Calibrate the analytic latency oracle against the deploy path as it
runs on the card: the port's measured-latency table.

    PYTHONPATH=src python -m repro_torch.launch.calibrate [--out PATH]

Steps, as in the JAX package's ``benchmarks/calibrate_oracle.py``:

1. per-unit deploy-path measurements (``measure_unit_rows``): every
   layer-spec shape of the LM testbed in each weight container, timed
   against its analytic roofline term;
2. the quantized-matmul kernel rows (``measure_kernel_rows``: K4, K5);
3. whole-model deployed forwards for uniform raw / int8 / int4 policies;
4. ``fit_calibration`` (per-kind geometric-mean ratios) and
   ``fit_extra_factor`` (attention/overhead residual from the raw row);
5. demo: for the uniform int8/int4 policies, the calibrated oracle's
   predicted latency ratio vs raw next to the measured one
   (``within_tol``).

The model is the full-width testbed (``configs.testbed.LM_CFG``) with
seeded random weights, fed 4 × 48 validation tokens. Factors are
specific to the card and its settings (``meta`` records them). The
output JSON (default ``artifacts/torch_latency_calibration.json``, the
file ``SearchConfig(oracle_mode="calibrated")`` loads) holds the
``ratios``/``extra``/``meta`` keys ``CalibrationTable.load`` reads, beside
the evidence (units / kernels / model / demo).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..configs.base import ArchConfig
from ..configs.testbed import LM_CFG, VAL_BATCH, VAL_SEQ
from ..core.compress import CompressibleLM
from ..core.latency import CONTAINERS, V5E, LatencyContext, policy_latency
from ..core.measure import (DEFAULT_CALIBRATION_PATH, MeasureConfig,
                            fit_calibration, fit_extra_factor,
                            measure_kernel_rows, measure_model_row,
                            measure_unit_rows, uniform_policy)
from ..core.policy import Policy
from ..data.pipeline import make_bigram_table, sample_bigram
from ..models import model as M

# demo acceptance: |predicted_ratio - measured_ratio| <= TOL * measured
DEMO_TOL = 0.35
CALIB_SEQS = 4               # validation sequences fed to the forwards
SEED = 0                     # weights, tokens and unit operands


def calibration_batch(cfg: ArchConfig, device) -> dict:
    """The first ``CALIB_SEQS`` sequences of the seeded validation batch
    (the JAX calibration's ``val["tokens"][:4]``)."""
    toks = sample_bigram(make_bigram_table(cfg.vocab_size, SEED),
                         VAL_BATCH, VAL_SEQ, SEED + 7)[:CALIB_SEQS]
    return {"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                      device=device)}


def run(out_path=DEFAULT_CALIBRATION_PATH, warmup: int = 2,
        repeats: int = 5, verbose: bool = True, device="cuda",
        cfg: ArchConfig = LM_CFG) -> dict:
    """Measure, fit and (when ``out_path``) write the table; returns the
    whole JSON object. ``device="cpu"`` runs the same steps on the CPU
    (plain versions in place of the kernels), for tests only."""
    cm = CompressibleLM(cfg, M.init(cfg, seed=SEED, device=device))
    batch = calibration_batch(cfg, device)
    B, S = batch["tokens"].shape
    # prefill context matching the measured forward: B sequences of S
    # tokens in one call
    mctx = LatencyContext(tokens=B * S, seq_ctx=S, mode="prefill", batch=B)
    mcfg = MeasureConfig(warmup=warmup, repeats=repeats, tokens=B * S,
                         seed=SEED)

    if verbose:
        print(f"# measuring units ({len(cm.specs)} specs x "
              f"{len(CONTAINERS)} containers, deduped) ...", flush=True)
    unit_rows = measure_unit_rows(cm.specs, V5E, mctx, mcfg, device=device)
    kernel_rows = measure_kernel_rows(mcfg, device=device)
    if verbose:
        print("# measuring whole-model deployed forwards ...", flush=True)
    model_rows = {c: measure_model_row(cm, batch, c, mcfg)
                  for c in CONTAINERS}

    dev = torch.device(device)
    meta = {
        "model": cfg.name,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "torch": torch.__version__,
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
        "ctx": {"tokens": B * S, "seq_ctx": S, "mode": "prefill",
                "batch": B},
        "note": ("factors are specific to the card and its settings; "
                 "the analytic terms are the V5E roofline"),
    }
    table = fit_calibration(unit_rows, meta=meta)
    ref = Policy.reference(cm.specs)
    fit_extra_factor(table, cm.specs, ref,
                     model_rows["raw"]["measured_s"], V5E, mctx)

    # --- demo: calibrated prediction vs measured wall clock ---
    ref_pred = policy_latency(cm.specs, ref, V5E, mctx, calib=table).total_s
    raw_meas = model_rows["raw"]["measured_s"]
    demo = []
    for c in ("int8", "int4"):
        pol = uniform_policy(cm.specs, c)
        pred = policy_latency(cm.specs, pol, V5E, mctx, calib=table).total_s
        pr = pred / ref_pred
        mr = model_rows[c]["measured_s"] / raw_meas
        demo.append({"container": c, "predicted_s": pred,
                     "predicted_ratio": pr, "measured_ratio": mr,
                     "tolerance": DEMO_TOL,
                     "within_tol": abs(pr - mr) <= DEMO_TOL * mr})

    out = {"meta": meta, "ratios": table.ratios, "extra": table.extra,
           "units": unit_rows, "kernels": kernel_rows,
           "model": model_rows, "demo": demo}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    if verbose:
        if out_path:
            print(f"# wrote {out_path}")
        for k, d in sorted(table.ratios.items()):
            facs = " ".join(f"{c}={v:.4g}" for c, v in sorted(d.items()))
            print(f"  ratio {k:10s} {facs}")
        print(f"  extra attn/overhead = {table.extra_factor():.4g}")
        for r in demo:
            print(f"  demo {r['container']}: predicted_ratio="
                  f"{r['predicted_ratio']:.4f} measured_ratio="
                  f"{r['measured_ratio']:.4f} within_tol={r['within_tol']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_CALIBRATION_PATH)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device; the table is measured on the "
              "card only", file=sys.stderr)
        return 2
    out = run(a.out, a.warmup, a.repeats)
    return 1 if any(not r["within_tol"] for r in out["demo"]) else 0


if __name__ == "__main__":
    raise SystemExit(main())
