#!/usr/bin/env python3
"""Where K8's tensor-core route spends its time, on one GPU: pieces of
``src/repro_torch/kernels/csrc/ssd_scan.cu`` taken out or changed one at
a time, each kernel timed at mamba2-780m's prefill shape.

    python3 tools/k8_ablation.py

Each variant is the committed source with a few named text substitutions
(the script fails if one no longer matches), compiled by ``nvcc`` as
``kernels/build.py`` compiles K8, and loaded in place of the built
library. Variants that take work out ("no_...") break the output and
are timed only; the others are also held against the chunked plain
version at the slow-decay check (1, 4096, 48, 64, 128), 2e-4 as
``chip_smoke.py`` holds K8. Each kernel's device time per call comes
from the profiler over a few calls at (1, 32768, 48, 64, 128), chunk
256, in the order A B ... B A, so drift on the card shows as a gap
between a variant's two passes. Prints the card's name and power limit.
Needs a card; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

INTRA = "            mma_split<2, 1, false, true>(acc, [&](int g, int kk,"
INTER = "mma_rows<N>(acc, sC, smem_u32(r1), smem_u32(r1 + TILE));"
TRANSPOSE = "        transpose_x<T>(xs + (jt & 1) * X_TILE, xt_hi, xt_lo, true);"
STATE = "        mma_split<MT, MT, true, false>(acc,"
# name -> (what the variant changes, breaks the output, substitutions)
VARIANTS = {
    "final": ("the committed kernel", False, []),
    "no_intra_mma": ("output pass: no scores and no product with the X "
                     "tiles", True,
                     [(INTRA, "            if (false) " + INTRA.lstrip())]),
    "no_inter_mma": ("output pass: no C·stateᵀ", True,
                     [(INTER, "if (false) " + INTER)]),
    "no_transpose": ("output pass: X tiles not transposed or split", True,
                     [(TRANSPOSE, "")]),
    "no_state_mma": ("state pass: no products", True,
                     [(STATE, "        if (false) " + STATE.lstrip())]),
    "state_3stages": ("state pass: a ring of three slices, not two", False,
                      [("constexpr int SL_STAGES = 2;",
                        "constexpr int SL_STAGES = 3;")]),
    "fast_exp": ("output pass: the scores' exp as __expf (ex2.approx)",
                 False, [("? sc[4 * j + 2 * i + cc] * expf(ar[i] - a_c[jl])",
                          "? sc[4 * j + 2 * i + cc] * __expf(ar[i] - a_c[jl])")]),
    "carry_ahead_8": ("carry pass: 8 chunks' loads in flight, not 16",
                      False, [("#define SSD_CARRY_AHEAD 16",
                               "#define SSD_CARRY_AHEAD 8")]),
}


def compile_all(build, out_dir: Path) -> dict:
    src = (build.CSRC / "ssd_scan.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, _, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: substitution no longer matches "
                                 f"once: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
    return {name: out_dir / f"{name}.so" for name in VARIANTS}


def load(build, path: Path) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    for fn, argtypes in build._SIGNATURES["ssd_scan"].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k8_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = compile_all(build, ROOT / "build" / "k8_ablation")
    dev = torch.device("cuda", 0)
    check = cs.ssd_case(15, 1, 4096, 48, 64, 128, 0.01, dev)
    want = ref.ssd_chunked_ref(*check, 256)
    timed = cs.ssd_case(16, 1, 32768, 48, 64, 128, 0.5, dev)
    print("kernel us per call at (1, 32768, 48, 64, 128), chunk 256: "
          "cb / state / carry / out = total", flush=True)
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        what, breaks, _ = VARIANTS[name]
        build._libs["ssd_scan"] = load(build, libs[name])
        verdict = "timing only"
        if not breaks:
            y, fin = ops.ssd_scan(*check, chunk=256)
            ok = torch.allclose(y, want[0], 2e-4, 2e-4) and \
                torch.allclose(fin, want[1], 2e-4, 2e-4)
            verdict = "holds 2e-4" if ok else "MISSES 2e-4"
        t = cs.kernel_times_us(lambda: ops.ssd_scan(*timed, chunk=256), 5)
        parts = [t.get(f"ssd_tc::{k}", t.get(k, 0.0)) for k in
                 ("ssd_tc_cb", "ssd_tc_state", "ssd_state_pass",
                  "ssd_tc_out")]
        print(f"{name:14s} {' / '.join(f'{p:.1f}' for p in parts)} = "
              f"{sum(parts):.1f} ({verdict}; {what})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
