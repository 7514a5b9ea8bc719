#!/usr/bin/env python3
"""Where K4/K5's time goes on one GPU, and what their checks refuse: the
tensor-core route (``src/repro_torch/kernels/csrc/quant_matmul.cu``,
``quant_matmul_tc_kernel``) beside its design choices taken back one at a
time, beside the CUDA-core kernel of the same source (the parent arm),
and with planted faults.

    python3 tools/k45_ablation.py [--sections time,faults]

``time``: at the path's shapes (the calibration's 256³, the testbed's
units at 192 tokens) and granite-3-8b's MLP at 32 and 4,096 tokens
(``chip_smoke.GRANITE_MLP``), K4 and K5, device microseconds per call
from CUDA events (host queued ahead; ``chip_smoke.cuda_ms``), in the
order A B ... B A, so drift on the card shows as a gap between an arm's
two passes. Arms: ``tc``, the route as ``kernels/quant_matmul.py::plan``
launches it; ``parent``, the CUDA-core kernel through its launch symbol;
``split N``, each other cluster size the K tiles allow (1 is split-K off);
``stages N``, the load ring at 2 and 3 stages or at its deepest; source
arms, the committed source with named text substitutions (the script
fails if one no longer matches), compiled as ``kernels/build.py``
compiles it: ``b_ring_2`` (the converted-B ring 2 deep instead of 3 / 4),
``a_box_128`` (the xq box 128 rows also at M <= 64), ``sext_nibbles``
(K5's nibbles sign-extended instead of taken times 16), and two that break
the output and are timed only, to show each role's share: ``no_products``
(no wgmma) and ``no_convert`` (B never written).
Every other arm is held bit for bit against the plain version.

``faults``: each planted fault is compiled, loaded in place of the built
library and run through ``chip_smoke.check_quant_matmul`` (every shape
of ``chip_smoke.quant_matmul_shapes`` and the asymmetric and ``k_true``
cases, exact); each must be refused (an ``AssertionError``), and the
committed source, the control, accepted.

Prints the card's name and power limit. Needs a card; exits 2 without
one, 1 when a fault is not refused.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "quant_matmul.cu"
OUT_DIR = ROOT / "build" / "k45_ablation"

BS = "    static constexpr int BS = PACKED ? 4 : 3;   // the converted-B ring"
MMA = "            if (active) {\n                const uint64_t ad"
CONVERT = ("            for (int h = 0; h < 8 / CONV_WARPS; ++h) {\n"
           "                const int slab = cw + CONV_WARPS * h;")
A_ROWS = "    return M <= 64 ? 64 : BM;"
NIBBLES = """    const uint32_t lo0 = (p0 << 4) & 0xF0F0F0F0u;
    const uint32_t hi0 = p0 & 0xF0F0F0F0u;
    const uint32_t lo1 = (p1 << 4) & 0xF0F0F0F0u;
    const uint32_t hi1 = p1 & 0xF0F0F0F0u;"""
SHIFT = "    constexpr int SHIFT = PACKED ? 4 : 0;"


def _sext(x: str) -> str:
    """C for the four nibbles in the low halves of x's bytes, each
    sign-extended to its byte (((b & 0xF) ^ 8) - 8)."""
    return f"(({x}) | (((({x}) >> 3) & 0x01010101u) * 0xF0u))"


SEXT = (NIBBLES
        .replace("(p0 << 4) & 0xF0F0F0F0u", _sext("p0 & 0x0F0F0F0Fu"))
        .replace("p0 & 0xF0F0F0F0u", _sext("(p0 >> 4) & 0x0F0F0F0Fu"))
        .replace("(p1 << 4) & 0xF0F0F0F0u", _sext("p1 & 0x0F0F0F0Fu"))
        .replace("p1 & 0xF0F0F0F0u", _sext("(p1 >> 4) & 0x0F0F0F0Fu")))
SOURCE_ARMS = {
    "b_ring_2": ("the converted-B ring 2 deep (the converter takes turns "
                 "with the products)", False,
                 [(BS, BS.replace("PACKED ? 4 : 3", "2"))]),
    "a_box_128": ("the xq box 128 rows at every M (TMA zero-fills the "
                  "second warpgroup's rows at M <= 64)", False,
                  [(A_ROWS, "    return BM;")]),
    "sext_nibbles": ("K5's nibbles sign-extended to codes, not taken "
                     "times 16 (more converter work)", False,
                     [(NIBBLES, SEXT), (SHIFT, SHIFT.replace(
                         "PACKED ? 4 : 0", "0"))]),
    "no_products": ("no wgmma: loads and conversion only", True,
                    [(MMA, MMA.replace("if (active)", "if (false)"))]),
    "no_convert": ("B never written: loads and products only", True,
                   [(CONVERT, CONVERT.replace("h < 8 / CONV_WARPS", "h < 0"))]),
}
SWIZZLE = "                        bt + n * 128 + ((slab ^ (n & 7)) << 4)) = o[q];"
PARTIAL = """        for (int q = 0; q < split; ++q) {
            const int4 v = *cluster.map_shared_rank("""
COLSUM = ("        for (int j = 0; j < 4; ++j) "
          "CSW[(ct / 32) * BN + 4 * lane + j] = cs[j];")
FAULTS = {
    "swizzle": ("the converter writes chunk slab ^ ((n + 1) % 8)",
                [(SWIZZLE, SWIZZLE.replace("(n & 7)", "((n + 1) & 7)"))]),
    "nibbles": ("K5 takes the high nibble as the even row",
                [(NIBBLES, NIBBLES.replace("lo0 =", "X0 =")
                  .replace("hi0 =", "lo0 =").replace("X0 =", "hi0 =")
                  .replace("lo1 =", "X1 =").replace("hi1 =", "lo1 =")
                  .replace("X1 =", "hi1 ="))]),
    "dropped_partial": ("split K sums the partial tiles of all blocks of "
                        "the cluster but the last",
                        [(PARTIAL, PARTIAL.replace("q < split",
                                                   "q < split - 1"))]),
    "colsum_off_by_one": ("each column takes its neighbour's code sum",
                          [(COLSUM, COLSUM.replace("cs[j]",
                                                   "cs[(j + 1) % 4]"))]),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"substitution no longer matches once: "
                             f"{old[:80]!r}")
        src = src.replace(old, new)
    return src


def compile_sources(texts: dict, nvcc: str, flags: list) -> dict:
    """name -> CUDA source text: one nvcc per source not yet built, all at
    once, into ``build/k45_ablation``; returns name -> library path."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name, text in texts.items():
        digest = hashlib.sha1((text + " ".join(flags)).encode()).hexdigest()
        lib = OUT_DIR / f"{name}.{digest[:12]}.so"
        out[name] = lib
        if lib.exists():
            continue
        cu = lib.with_suffix(".cu")
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            lib.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
    return out


def load(path: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build
    handle = ctypes.CDLL(str(path))
    for fn, argtypes in build._SIGNATURES["quant_matmul"].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def tc_call(lib, args, packed: bool, K: int, split: int, stages: int):
    """One launch of a library's tensor-core route at (split, stages)."""
    import torch
    from repro_torch.kernels import build
    xq, wq = args[0], args[1]
    M, N = xq.shape[0], wq.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = lib.quant_matmul_tc_launch(
        *(t.data_ptr() for t in args), out.data_ptr(), M, N, K, K,
        int(packed), split, stages,
        torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, f"tensor-core route, split {split}, {stages} stages")
    return out


def time_section(cs, libs: dict) -> None:
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.configs.testbed import LM_CFG
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(22)
    timed, _ = cs.quant_matmul_shapes(LM_CFG)
    for (M, K, N) in timed:
        big = (M, K, N) in cs.GRANITE_MLP
        for packed in (False, True):
            x = torch.randn((M, K), generator=gen, device=dev)
            w = torch.randn((K, N), generator=gen, device=dev)
            args, _ = ops.quantize_operands(x, w, 4 if packed else 8)
            del x, w
            want = ref.quant_matmul_ref(*args, packed=packed, k_true=K)
            p = qm.plan(M, K, N, packed)
            final = libs["final"]
            arms = {"tc": (f"the route as planned: split {p.split}, "
                           f"{p.stages} stages", final, p.split, p.stages,
                           False),
                    "parent": ("the CUDA-core kernel", None, 0, 0, False)}
            for s in qm.SPLITS:
                if s != p.split and s <= p.k_tiles:
                    arms[f"split {s}"] = (
                        "split-K off" if s == 1 else f"a cluster of {s}",
                        final, s, qm.plan(M, K, N, packed, s).stages, False)
            for st in sorted({2, 3, qm.MAX_STAGES[packed]} - {p.stages}):
                arms[f"stages {st}"] = (f"a load ring of {st}", final,
                                        p.split, st, False)
            for name, (what, breaks, _) in SOURCE_ARMS.items():
                arms[name] = (what, libs[name], p.split, p.stages, breaks)
            times = {}
            iters = (5, 1) if big else (30, 3)
            for name in list(arms) + list(arms)[::-1]:
                _, lib, s, st, _ = arms[name]
                if lib is None:
                    fn = lambda: cs.quant_matmul_simt(  # noqa: E731
                        args, packed, K)
                else:
                    fn = lambda: tc_call(  # noqa: E731
                        lib, args, packed, K, s, st)
                it = (2, 1) if big and lib is None else iters
                times.setdefault(name, []).append(cs.cuda_ms(fn, *it)[0] * 1e3)
            n_bytes = (M * K + (K * N // 2 if packed else K * N)
                       + 4 * M * N + 8 * (M + N))
            bound, by = cs.bound_ms(n_bytes, 2.0 * M * N * K, cs.INT8_OPS)
            print(f"[time] {'K5' if packed else 'K4'} {(M, K, N)}: us per "
                  f"call (two passes, A B ... B A); bound "
                  f"{bound * 1e3:.3f} us ({by}); {cs.CARD}", flush=True)
            for name, (what, lib, s, st, breaks) in arms.items():
                if breaks:
                    verdict = "timing only"
                else:
                    got = (cs.quant_matmul_simt(args, packed, K)
                           if lib is None
                           else tc_call(lib, args, packed, K, s, st))
                    verdict = ("bit-equal" if torch.equal(got, want)
                               else "NOT bit-equal")
                    del got
                t = times[name]
                print(f"  {name:12s} {t[0]:10.2f} / {t[1]:10.2f} us "
                      f"({min(t) / (bound * 1e3):.2f}x bound; {verdict}; "
                      f"{what})", flush=True)
            del args, want
            torch.cuda.empty_cache()


def fault_section(cs, paths: dict) -> bool:
    import torch
    from repro_torch.configs.testbed import LM_CFG
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    ok = True
    for name in ["final"] + list(FAULTS):
        build._libs["quant_matmul"] = load(paths[name])
        try:
            cs.check_quant_matmul(LM_CFG, dev)
            refused = None
        except AssertionError as e:
            refused = str(e)[:200]
        torch.cuda.empty_cache()
        if name == "final":
            good = refused is None
            print(f"[control] the committed source: "
                  f"{'accepted' if good else 'REFUSED: ' + refused}",
                  flush=True)
        else:
            good = refused is not None
            print(f"[fault {name}] {FAULTS[name][0]}: "
                  f"{'refused: ' + refused if good else 'NOT REFUSED'}",
                  flush=True)
        ok &= good
    build._libs.pop("quant_matmul", None)
    return ok


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sections", default="time,faults")
    sections = parser.parse_args().sections.split(",")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("k45_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    print(f"k45_ablation; card: {cs.CARD}", flush=True)
    src = SOURCE.read_text()
    texts = {"final": src}
    texts.update({name: variant_source(src, subs)
                  for name, (_, _, subs) in SOURCE_ARMS.items()})
    texts.update({name: variant_source(src, subs)
                  for name, (_, subs) in FAULTS.items()})
    paths = compile_sources(texts, build._nvcc(), build.NVCC_FLAGS)
    ok = True
    if "time" in sections:
        time_section(cs, {name: load(paths[name])
                          for name in ["final", *SOURCE_ARMS]})
    if "faults" in sections:
        ok = fault_section(cs, paths)
    print(f"k45_ablation: {'ok' if ok else 'a fault was NOT refused'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
