#!/usr/bin/env python3
"""Ablation of K6's tensor-core route on one GPU: each design choice of
``src/repro_torch/kernels/csrc/flash_attention.cu`` taken back, one at a
time, and timed against the committed kernel.

    python3 tools/k6_ablation.py

Each variant is the committed source with a few named text substitutions
(the script fails if one no longer matches), compiled by ``nvcc`` as
``kernels/build.py`` compiles K6, loaded in place of the built library,
checked against the dense plain version (bf16 atol 0.04 and each row
within 2^-6, as ``chip_smoke.py`` holds K6) at ragged shapes, and timed
with CUDA events at the prefill shapes, in the order A B ... B A so that
drift on the card shows as a gap between a variant's two passes. Prints
``ptxas``' notes on the route's kernels (registers, spills, serialised
wgmma) per variant, the card's name and power limit, and SDPA's time on
the causal shapes as a yardstick. Needs a card; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

NC = "static constexpr int NC = D == 64 ? 3 : 2;"
STAGES = "static constexpr int STAGES = D > 128 ? 2 : 3;"
# name -> (what the variant takes back, [(committed text, variant text)])
VARIANTS = {
    "final": ("the committed kernel", []),
    "role_by_tid": ("the warpgroup role from threadIdx.x, not a shuffle", [
        ("__shfl_sync(0xffffffffu, threadIdx.x / 128, 0)",
         "threadIdx.x / 128")]),
    "exp2f": ("exp2f in place of ex2.approx.ftz", [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = exp2f(x);")]),
    "no_turns": ("no round robin of the consumers' products", [
        ("if (cw == NC - 1) named_arrive(NC + 1, 256);", ""),
        ("if (cw < NC - 1 || it < n_kt - 1) named_arrive(their_turn, 256);",
         ""),
        ("named_sync(my_turn, 256);", ";")]),
    "k_with_v": ("K stages released with V, after P.V", [
        ("        mbar_arrive(empty_k(0));\n", ""),
        ("            mbar_arrive(empty_k(s));\n", ""),
        ("            mbar_arrive(empty_v(sp));",
         "            mbar_arrive(empty_k(sp));\n"
         "            mbar_arrive(empty_v(sp));")]),
    "two_stages": ("two K/V stages at every head dim", [
        (STAGES, "static constexpr int STAGES = 2;")]),
    "nc2_d64": ("two consumer warpgroups at D 64", [
        (NC, "static constexpr int NC = 2;")]),
}
CHECKS = ((1, 300, 4, 2, 64, True, 0), (2, 1100, 14, 2, 64, True, 0),
          (1, 4097, 10, 1, 256, True, 2048), (1, 1000, 4, 2, 64, False, 96),
          (2, 640, 6, 3, 128, True, 100), (1, 1100, 7, 7, 128, False, 0))
# (B, S, H, KV, D, window): qwen2-0.5b, recurrentgemma-2b, olmo-1b heads
TIMED = ((1, 32768, 14, 2, 64, 0), (1, 32768, 10, 1, 256, 2048),
         (1, 32768, 16, 16, 128, 0), (1, 4096, 14, 2, 64, 0),
         (1, 4096, 10, 1, 256, 2048))


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"substitution no longer matches: {old!r}")
        src = src.replace(old, new)
    return src


def compile_all(build, out_dir: Path) -> dict:
    """One nvcc per variant, all at once; name -> (library path, ptxas
    notes on the route's kernels, their ptxas rows)."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, subs))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(
                ".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        notes = sorted({re.sub(r" (around|in) (line|the function).*", "",
                               line[line.index("(C75"):])
                        for line in log.splitlines()
                        if "tc_kernel" in line and "(C75" in line})
        rows = [r for r in build._ptxas_summary(log)
                if "tc_kernel" in r["kernel"]]
        out[name] = (out_dir / f"{name}.so", notes, rows)
    return out


def load(build, path: Path) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    for fn, argtypes in build._SIGNATURES["flash_attention"].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k6_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = compile_all(build, ROOT / "build" / "k6_ablation")
    for name, (_, notes, rows) in libs.items():
        regs = [(r["kernel"].split("ILi")[1].split("E")[0], r["registers"],
                 r.get("spill_store_bytes", 0)) for r in rows]
        print(f"{name}: {VARIANTS[name][0]}; ptxas (D, registers at entry, "
              f"spill bytes) {regs}; notes {notes or 'none'}", flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, S, H, KV, D):
        return [torch.randn(shape, generator=gen, device=dev)
                .to(torch.bfloat16).transpose(1, 2)
                for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]

    def ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    checks = {c: qkv(*c[:5]) for c in CHECKS}
    timed = {c: qkv(*c[:5]) for c in TIMED}
    print("timed (ms): " + ", ".join(
        f"{c[:5]} window {c[5]}" for c in TIMED), flush=True)
    failed = []
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for name in order:
        build._libs["flash_attention"] = load(build, libs[name][0])
        worst = 0.0
        for (B, S, H, KV, D, causal, window), (q, k, v) in checks.items():
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            rel = float(((got.float() - want.float()).norm(dim=-1)
                         / want.float().norm(dim=-1)).max())
            worst = max(worst, rel)
            if not (err <= 0.04 and rel <= 2.0 ** -6):
                failed.append((name, (B, S, H, KV, D, causal, window)))
        times = [ms(lambda: flash_attention(q, k, v, window=c[5]))
                 for c, (q, k, v) in timed.items()]
        print(f"{name:12s} rows <= {worst:.4f}: "
              + " ".join(f"{t:.4f}" for t in times), flush=True)
    lib = [ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)) if not c[5] else None
        for c, (q, k, v) in timed.items()]
    print("sdpa        : " + " ".join("-" if t is None else f"{t:.4f}"
                                      for t in lib), flush=True)
    if failed:
        print(f"variants that disagree with the plain version: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
