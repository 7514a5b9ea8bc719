#!/usr/bin/env python3
"""Ablation of K6's tensor-core route on one GPU: each design choice of
``src/repro_torch/kernels/csrc/flash_attention.cu`` taken back or changed,
one at a time, and timed against the committed kernel.

    python3 tools/k6_ablation.py [--variants a,b+c,...] [--baseline SRC]

Each variant is the committed source with a few named text substitutions
(the script fails if one no longer matches); ``b+c`` applies both.
``--baseline`` adds another ``flash_attention.cu`` (say, the parent
commit's, from ``git show``) as the variant "baseline"; a shape its
build cannot run is shown as "-". Each is compiled by ``nvcc`` as
``kernels/build.py`` compiles K6, all at once, loaded in place of the
built library, checked against the dense plain version (bf16 atol 0.04
and each row within 2^-6, as ``chip_smoke.py`` holds K6) at ragged
shapes, and again at D 80 with q and k zero in columns 64-79 (which tells
a fault of the 16-column box in S = Q.K^T from one in P.V), then timed
with CUDA events at the prefill shapes, in the order A B ... B A so that
drift on the card shows as a gap between a variant's two passes. Prints
the card's name and power limit, nvcc's whole log for the committed
source, ``ptxas``' notes on the route's kernels (registers, spills,
serialised wgmma) per variant, and SDPA's time on the shapes without a
window (causal, or bidirectional as hubert-xlarge) as a yardstick. Needs
a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

NC = "static constexpr int NC = D == 64 || D == 80 ? 3 : 2;"
STAGES = "static constexpr int STAGES = D > 128 ? 2 : 3;"
BN = "static constexpr int BN = D > 128 ? 64 : D == 80 ? 96 : 128;"
# name -> (what the variant changes, [(committed text, variant text)])
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
        (NC, "static constexpr int NC = D == 80 ? 3 : 2;")]),
    "nc2_d80": ("two consumer warpgroups at D 80 (BM 128, 240 registers)", [
        (NC, "static constexpr int NC = D == 64 ? 3 : 2;")]),
    "four_stages_d80": ("four K/V stages at D 80", [
        (STAGES, "static constexpr int STAGES = D > 128 ? 2 "
                 ": D == 80 ? 4 : 3;")]),
    "bn64_d80": ("64-key tiles at D 80", [
        (BN, "static constexpr int BN = D > 128 || D == 80 ? 64 : 128;")]),
    "bn128_d80": ("128-key tiles at D 80 (spills at 160 registers)", [
        (BN, "static constexpr int BN = D > 128 ? 64 : 128;")]),
    "tiles_first_g1": ("q tiles fastest in the grid at G = 1 (MHA)", [
        ("    const int h = bid % H;\n"
         "    const int qt = n_qt - 1 - (bid / H) % n_qt;",
         "    const int h = G == 1 ? (bid / n_qt) % H : bid % H;\n"
         "    const int qt = n_qt - 1 - (G == 1 ? bid % n_qt "
         ": (bid / H) % n_qt);")]),
}
CHECKS = ((1, 300, 4, 2, 64, True, 0), (2, 1100, 14, 2, 64, True, 0),
          (1, 4097, 10, 1, 256, True, 2048), (1, 1000, 4, 2, 64, False, 96),
          (2, 640, 6, 3, 128, True, 100), (1, 1100, 7, 7, 128, False, 0),
          (1, 4097, 16, 16, 80, False, 0), (2, 640, 8, 2, 80, True, 100),
          (1, 37, 4, 4, 80, True, 0))
# D 80 checks again with q and k zero in columns 64-79
ZERO_TAIL = ((2, 300, 8, 2, 80, True, 96), (1, 4097, 16, 16, 80, False, 0))
# (B, S, H, KV, D, window, causal): qwen2-0.5b, recurrentgemma-2b,
# olmo-1b, granite-3-8b and hubert-xlarge heads
TIMED = ((1, 32768, 14, 2, 64, 0, True), (1, 32768, 10, 1, 256, 2048, True),
         (1, 32768, 16, 16, 128, 0, True), (1, 32768, 32, 8, 128, 0, True),
         (1, 32768, 16, 16, 80, 0, False), (1, 4096, 14, 2, 64, 0, True),
         (1, 4096, 10, 1, 256, 2048, True), (1, 4096, 16, 16, 80, 0, False))


def variant_source(src: str, names: str) -> str:
    for name in names.split("+"):
        for old, new in VARIANTS[name][1]:
            if old not in src:
                raise SystemExit(f"{name}: substitution no longer matches: "
                                 f"{old!r}")
            src = src.replace(old, new)
    return src


def compile_all(build, sources: dict, out_dir: Path) -> dict:
    """One nvcc per source, all at once; name -> (library path, nvcc's
    log, ptxas notes on the route's kernels, their ptxas rows)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
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
        out[name] = (out_dir / f"{name}.so", log, notes, rows)
    return out


def load(build, path: Path) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    for fn, argtypes in build._SIGNATURES["flash_attention"].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated; a+b applies both")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another flash_attention.cu, timed as 'baseline'")
    args = ap.parse_args()
    names = args.variants.split(",")
    for name in names:
        unknown = [n for n in name.split("+") if n not in VARIANTS]
        if unknown:
            raise SystemExit(f"unknown variant(s) {unknown}; "
                             f"known: {list(VARIANTS)}")
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
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    src = (build.CSRC / "flash_attention.cu").read_text()
    sources = {name: variant_source(src, name) for name in names}
    if args.baseline is not None:
        sources["baseline"] = args.baseline.read_text()
    libs = compile_all(build, sources, ROOT / "build" / "k6_ablation")
    if "final" in libs:
        print("nvcc's log for the committed source:\n" + libs["final"][1],
              flush=True)
    for name, (_, _, notes, rows) in libs.items():
        regs = [(r["kernel"].split("ILi")[1].split("E")[0], r["registers"],
                 r["spill_store_bytes"]) for r in rows]
        what = ("--baseline " + str(args.baseline) if name == "baseline"
                else "; ".join(VARIANTS[n][0] for n in name.split("+")))
        print(f"{name}: {what}; ptxas (D, registers, spill bytes) {regs}; "
              f"notes {notes or 'none'}", flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, S, H, KV, D, zero_tail=False):
        out = [torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2)
               for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
        if zero_tail:
            out[0][..., 64:] = 0
            out[1][..., 64:] = 0
        return out

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

    checks = {(c, False): qkv(*c[:5]) for c in CHECKS}
    checks.update({(c, True): qkv(*c[:5], zero_tail=True)
                   for c in ZERO_TAIL})
    timed = {c: qkv(*c[:5]) for c in TIMED}
    print("timed (ms): " + ", ".join(
        f"{c[:5]} window {c[5]}{'' if c[6] else ' bidirectional'}"
        for c in TIMED), flush=True)
    failed = []
    order = list(libs) + list(libs)[::-1]
    for name in order:
        build._libs["flash_attention"] = load(build, libs[name][0])
        worst = 0.0
        for ((B, S, H, KV, D, causal, window), zt), (q, k, v) in \
                checks.items():
            try:
                got = flash_attention(q, k, v, causal=causal, window=window)
            except RuntimeError:
                if name == "baseline":      # a head dim it has no route for
                    continue
                raise
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            rel = float(((got.float() - want.float()).norm(dim=-1)
                         / want.float().norm(dim=-1)).max())
            worst = max(worst, rel)
            if not (err <= 0.04 and rel <= 2.0 ** -6):
                failed.append((name, (B, S, H, KV, D, causal, window),
                               "zero tail" if zt else ""))
        times = []
        for c, (q, k, v) in timed.items():
            try:
                t = ms(lambda: flash_attention(q, k, v, window=c[5],
                                               causal=c[6]))
                times.append(f"{t:.4f}")
            except RuntimeError:
                if name != "baseline":
                    raise
                times.append("-")
        print(f"{name:12s} rows <= {worst:.4f}: " + " ".join(times),
              flush=True)
    lib = [ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=c[6], enable_gqa=True)) if not c[5] else None
        for c, (q, k, v) in timed.items()]
    print("sdpa        : " + " ".join("-" if t is None else f"{t:.4f}"
                                      for t in lib), flush=True)
    if failed:
        print(f"variants that disagree with the plain version: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
