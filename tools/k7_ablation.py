#!/usr/bin/env python3
"""Where K7's time goes, on one GPU, and what its checks refuse: the
chained single-pass kernel (``src/repro_torch/kernels/csrc/rglru_scan.cu``)
beside its design choices taken back one at a time, beside the former
three-launch kernel (``tools/k7_three_pass.cu``, the parent arm), and with
planted faults.

    python3 tools/k7_ablation.py [--src DIR] [--sections time,faults,prefill]

``time``: each arm at recurrentgemma-2b's prefill shape (1, 32768, 2560)
f32 on seeded inputs with the path's decays, and at S 4,096, device
microseconds per call from CUDA events (host queued ahead; ``chip_smoke.
cuda_ms``), in the order A B ... B A, so drift on the card shows as a gap
between an arm's two passes. Source arms are the committed source with
named text substitutions (the script fails if one no longer matches),
compiled as ``kernels/build.py`` compiles K7; launch arms change the
chunk L or the slab of channels per tile. Arms that keep the function are
held bit for bit against the three-pass kernel at the same L, and each row
within ``chip_smoke.K7_ROW_TOL`` of the sequential plain version; the arm
without the chain's wait breaks the output and is timed only. Then the
hop: one slab of chunks (1, 65536, 128), timed with and without the wait;
the difference over the chain's hops is the time one hop adds.

``faults``: each planted fault is loaded in place of the built library and
run through ``chip_smoke.py``'s K7 checks (the cases of
``check_rglru_scan``, the many-wave case, the back-to-back calls); each
must be refused (an ``AssertionError``), and the committed kernel, the
control, accepted.

``prefill``: recurrentgemma-2b at full width (seeded random weights),
raw and under the seeded pq policy, two forwards each of 1 x 32,768
tokens after a 2,048-token warm-up (host clock ended by a sync), then
``chip_smoke.rglru_block_split``: layer 0's RG-LRU block in device ms,
split into its gate passes, K7, the GEMMs and the rest. ``--src`` imports
the port from another tree (default: this checkout's ``src``), so that one
call can time a parent unpacked beside this one (parent, this tree, this
tree, parent); ``time`` and ``faults`` run on this tree's port only.

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

THREE_PASS = ROOT / "tools" / "k7_three_pass.cu"
OUT_DIR = ROOT / "build" / "k7_ablation"

WAIT = "    if (!fresh(v, epoch)) {"
PRED = "wait_state(words + ((long long)(k - 1) * B + bb) * C + c, epoch);"
LOADS = """    if (vec) {
        // Thread tid copies the 16-byte column v of rows tid / lanes,
        // + W / lanes, ...: a warp covers whole rows of the slab.
        constexpr int V = 16 / sizeof(T);
        const int lanes = W / V, v = (tid % lanes) * V;
        const bool in_c = c0 + v < C;
        for (int g = 0; g < LRU_GROUPS; ++g) {
            const int r1 = min(n, (g + 1) * per_group);
            for (int r = g * per_group + tid / lanes; in_c && r < r1;
                 r += W / lanes) {
                const long long src = base + (long long)r * C + c0 + v;
                cp_async16(sa + r * W + v, a + src);
                cp_async16(sb + r * W + v, b + src);
            }
            cp_commit();
        }
    } else if (active) {"""
TMA_LOADS = """    __shared__ __align__(8) unsigned long long bars[LRU_GROUPS];
    if (vec) {
        const int row_bytes = min(W, C - c0) * (int)sizeof(T);
        if (tid == 0) {
            for (int g = 0; g < LRU_GROUPS; ++g) mbar_init(bars + g);
            asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
            for (int g = 0; g < LRU_GROUPS; ++g) {
                const int rows = max(0, min(n, (g + 1) * per_group)
                                        - g * per_group);
                mbar_expect_tx(bars + g, 2 * rows * row_bytes);
            }
        }
        __syncthreads();
        for (int g = 0; g < LRU_GROUPS; ++g) {
            const int r1 = min(n, (g + 1) * per_group);
            for (int r = g * per_group + tid; r < r1; r += W) {
                const long long src = base + (long long)r * C + c0;
                bulk_load(sa + r * W, a + src, row_bytes, bars + g);
                bulk_load(sb + r * W, b + src, row_bytes, bars + g);
            }
        }
    } else if (active) {"""
TMA_HELPERS = """__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n"
                 :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               int bytes) {
    asm volatile("{\\n.reg .b64 st;\\n"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\\n}\\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait0(unsigned long long* bar) {
    asm volatile("{\\n.reg .pred p;\\n"
                 "LAB_WAIT:\\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\\n"
                 "@!p bra.uni LAB_WAIT;\\n}\\n"
                 :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes,
                                          unsigned long long* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

// Grid: one block per tile;"""

# name -> (what the arm changes, breaks the output, substitutions)
VARIANTS = {
    "final": ("the committed kernel", False, []),
    "groups_1": ("a tile's loads in one group: walk 1 waits for the whole "
                 "tile", False,
                 [("#define LRU_GROUPS 4", "#define LRU_GROUPS 1")]),
    "tma_bulk": ("loads by TMA bulk copies (cp.async.bulk, one per token "
                 "row of the slab, completing on one mbarrier per group), "
                 "not 16-byte cp.async", False,
                 [("// Grid: one block per tile;", TMA_HELPERS),
                  (LOADS, TMA_LOADS),
                  ("        wait_groups(g);",
                   "        if (vec) mbar_wait0(bars + g);")]),
    "no_wait": ("the chain's wait taken out: each tile takes the word that "
                "is there (wrong output; timed to show the chain's cost)",
                True, [(WAIT, "    if (false) {")]),
}
# Launch arms on the committed source: name -> (what, chunk L, slab W).
SHAPES = {
    "W32": ("slabs of 32 channels (seven blocks per SM in f32)", 128, 32),
    "W64": ("slabs of 64 channels (three blocks per SM in f32)", 128, 64),
    "W192": ("slabs of 192 channels", 128, 192),
    "L64": ("chunks of 64 tokens", 64, 128),
    "L256_W32": ("chunks of 256 tokens in slabs of 32 channels (slabs of "
                 "128 at L 256 need 256 KB a tile in f32: they do not fit)",
                 256, 32),
    "W256_L64": ("slabs of 256 channels, chunks of 64", 64, 256),
}
# Planted faults: name -> (what, substitutions). Each must be refused.
FAULTS = {
    "stale_epoch": ("a word of the previous epoch is taken as this call's",
                    [("return (unsigned)(v >> 32) == epoch;",
                      "return (unsigned)(v >> 32) + 1 >= epoch;")]),
    "off_by_one": ("each chunk takes the state leaving chunk k - 2",
                   [(PRED, PRED.replace("(k - 1)", "max(k - 2, 0)"))]),
    "skipped_wait": ("the wait is skipped: each tile takes the word that "
                     "is there", [(WAIT, "    if (false) {")]),
}
TIMED = ((1, 32768, 2560), (1, 4096, 2560))

_P, _I = ctypes.c_void_p, ctypes.c_int


def variant_source(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"substitution no longer matches once: "
                             f"{old[:80]!r}")
        src = src.replace(old, new)
    return src


def compile_sources(texts: dict, nvcc: str, flags: list) -> dict:
    """name -> CUDA source text: one nvcc per source not yet built (the
    library's name carries the text's hash), all at once, into
    ``build/k7_ablation``; returns name -> library path."""
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


def load(path: Path, argtypes: list) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    handle.rglru_scan_launch.argtypes = argtypes
    handle.rglru_scan_launch.restype = ctypes.c_int
    return handle


_three_pass = []


def three_pass(a, b, h0=None, chunk: int = 128):
    """The former three-launch K7 (chunk states, carry pass, chunk
    outputs) on CUDA tensors, built from ``tools/k7_three_pass.cu`` at
    first use: the yardstick the chained kernel equals bit for bit at
    the same chunk."""
    import torch
    from repro_torch.kernels import build
    if not _three_pass:
        path = compile_sources({"three_pass": THREE_PASS.read_text()},
                               build._nvcc(), build.NVCC_FLAGS)["three_pass"]
        _three_pass.append(load(path, [_P] * 7 + [_I] * 5 + [_P]))
    B, S, C = a.shape
    nc = -(-S // chunk)
    h = torch.empty_like(a)
    scratch = torch.empty((3, B, nc, C), dtype=torch.float32,
                          device=a.device)
    err = _three_pass[0].rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        scratch[2].data_ptr(), B, S, C, chunk,
        int(a.dtype == torch.bfloat16),
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "three-pass K7")
    return h


def chained(lib, a, b, chunk: int, slab: int):
    """One launch of a chained library at (chunk, slab), on the
    wrapper's workspace."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as rg
    B, S, C = a.shape
    p = rg.plan(B, S, C, chunk, a.element_size(), slab)
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    work, epoch = rg._workspace(a.device, stream, p.state_words)
    err = lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), None, h.data_ptr(), work[1:].data_ptr(),
        work.data_ptr(), B, S, C, chunk, slab, epoch,
        int(a.dtype == torch.bfloat16), stream)
    build.check(err, "chained K7")
    return h


def time_section(cs, libs: dict) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    dev = torch.device("cuda", 0)
    arms = {name: (VARIANTS[name][0], libs[name], rg.CHUNK, rg.SLAB)
            for name in VARIANTS}
    arms.update({name: (what, libs["final"], L, W)
                 for name, (what, L, W) in SHAPES.items()})
    arms["three_pass"] = ("the former three-launch kernel (parent arm)",
                          None, rg.CHUNK, None)
    for B, S, C in TIMED:
        a, b, _ = cs.lru_case(30, B, S, C, "path", dev)
        want = ref.rglru_scan_ref(a, b)
        base = {L: three_pass(a, b, chunk=L) for L in (64, 128, 256)}
        n_bytes, _ = cs.rglru_work(B, S, C)
        bound, _ = cs.bound_ms(n_bytes, 0.0)
        print(f"[time] {(B, S, C)} f32, the path's decays: us per call "
              f"(two passes, A B ... B A); bound {bound * 1e3:.1f} us "
              f"(bytes)", flush=True)
        times = {}
        for name in list(arms) + list(arms)[::-1]:
            what, lib, L, W = arms[name]
            if lib is None:
                fn = lambda: three_pass(a, b, chunk=L)  # noqa: E731
            else:
                fn = lambda: chained(lib, a, b, L, W)  # noqa: E731
            ms, _ = cs.cuda_ms(fn, 10, 2)
            times.setdefault(name, []).append(ms * 1e3)
        for name, (what, lib, L, W) in arms.items():
            breaks = lib is not None and VARIANTS.get(name, ("", False))[1]
            got = (three_pass(a, b, chunk=L) if lib is None
                   else chained(lib, a, b, L, W))
            e = cs.rglru_errors(got, want)
            if breaks:
                verdict = f"timing only (rows off by up to {e['row']:.3g})"
            else:
                exact = bool(torch.equal(got, base[L]))
                ok = exact and e["row"] <= cs.K7_ROW_TOL
                verdict = (f"{'bit-equal' if exact else 'NOT bit-equal'} "
                           f"to three-pass at L {L}, max row rel "
                           f"{e['row']:.3g}{'' if ok else ' FAILS'}")
            t = times[name]
            print(f"  {name:12s} {t[0]:8.1f} / {t[1]:8.1f} us "
                  f"({min(t) / (bound * 1e3):.2f}x bound; {verdict}; "
                  f"{what})", flush=True)
        del a, b, want, base
        torch.cuda.empty_cache()
    # The hop: one slab (C = SLAB), so one chain of many chunks whose
    # loads are small; what the wait adds per chunk is the hop.
    for S, L in ((65536, 16), (65536, rg.CHUNK)):
        a, b, _ = cs.lru_case(31, 1, S, rg.SLAB, "path", dev)
        t = {}
        for name in ("final", "no_wait", "no_wait", "final"):
            ms, _ = cs.cuda_ms(lambda: chained(libs[name], a, b, L, rg.SLAB),
                               10, 2)
            t.setdefault(name, []).append(ms * 1e3)
        hops = -(-S // L) - 1
        hop = (min(t["final"]) - min(t["no_wait"])) / hops
        print(f"[hop] {(1, S, rg.SLAB)}, chunk {L}: one chain of {hops} "
              f"hops; {min(t['final']):.1f} us with the wait, "
              f"{min(t['no_wait']):.1f} without: {hop * 1e3:.0f} ns a hop",
              flush=True)


def fault_section(cs, paths: dict) -> bool:
    import torch
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    ok = True
    for name in ["final"] + list(FAULTS):
        build._libs["rglru_scan"] = load(paths[name], build._SIGNATURES[
            "rglru_scan"]["rglru_scan_launch"])
        refused = []
        for check, run in (
                ("check_rglru_scan", lambda: cs.check_rglru_scan(dev)),
                ("check_rglru_waves", lambda: cs.check_rglru_waves(dev)),
                ("check_rglru_back_to_back",
                 lambda: cs.check_rglru_back_to_back(dev))):
            try:
                run()
            except AssertionError as e:
                refused.append(check)
                print(f"  {check} refused: {str(e)[:200]}", flush=True)
        if name == "final":
            good = not refused
            print(f"[control] the committed kernel: "
                  f"{'accepted' if good else 'REFUSED by ' + str(refused)}",
                  flush=True)
        else:
            good = len(refused) == 3
            print(f"[fault {name}] {FAULTS[name][0]}: refused by "
                  f"{len(refused)} of 3 checks ({' '.join(refused)})",
                  flush=True)
        ok &= good
    build._libs.pop("rglru_scan", None)
    return ok


def prefill_section(cs) -> None:
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    cfg = get_config("recurrentgemma-2b")
    cm = CompressibleLM(cfg, M.init(cfg, seed=0, device="cuda"))
    cspec = cm.build_cspec(cs.seeded_policy(cm, 0))
    tokens = cs.prefill_tokens(cfg, 1, cs.PREFILL_SEQ, 0, "cuda")
    for name, c in (("raw", None), ("policy", cspec)):
        cs.release_cached_memory("cuda")
        cs.timed_prefill(cfg, cm.params, tokens[:, :cs.PREFILL_WARM_SEQ], c)
        ms = []
        for _ in range(2):
            cs.release_cached_memory("cuda")
            dt, launches = cs.timed_prefill(cfg, cm.params, tokens, c)
            ms.append(dt * 1e3)
        print(f"[prefill] {cfg.name} {name}, 1 x {cs.PREFILL_SEQ}: "
              f"{ms[0]:.1f} / {ms[1]:.1f} ms (host clock, two forwards); "
              f"K7 launches per forward {launches['rglru_scan']}; {cs.CARD}",
              flush=True)
    cs.release_cached_memory("cuda")
    r = cs.rglru_block_split(cfg, cm.params, tokens)
    print(f"[prefill] layer 0's RG-LRU block {tuple(r['shape'])}, device "
          f"ms: block {r['block']:.3f} = gate passes {r['gates']:.3f} "
          f"({r['gate_kernels']} kernels) + K7 {r['k7']:.3f} + GEMMs "
          f"{r['gemms']:.3f} + rest {r['rest']:.3f}", flush=True)
    del cm, tokens
    torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--sections", default="time,faults")
    args = parser.parse_args()
    sections = args.sections.split(",")
    if {"time", "faults"} & set(sections) and \
            Path(args.src).resolve() != (ROOT / "src").resolve():
        parser.error("the time and faults sections run on this tree only")
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("k7_ablation: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs      # the port stays the one imported above
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cs.CARD = card
    print(f"k7_ablation on {args.src}; card: {card}", flush=True)
    if "prefill" in sections:
        prefill_section(cs)
    if not {"time", "faults"} & set(sections):
        return 0
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
           / "rglru_scan.cu").read_text()
    texts = {name: variant_source(src, subs)
             for name, (_, _, subs) in VARIANTS.items()}
    texts.update({name: variant_source(src, subs)
                  for name, (_, subs) in FAULTS.items()})
    texts["three_pass"] = THREE_PASS.read_text()
    paths = compile_sources(texts, build._nvcc(), build.NVCC_FLAGS)
    sig = build._SIGNATURES["rglru_scan"]["rglru_scan_launch"]
    libs = {name: load(p, sig) for name, p in paths.items()
            if name != "three_pass"}
    ok = True
    if "time" in sections:
        time_section(cs, libs)
    if "faults" in sections:
        ok = fault_section(cs, paths)
    print(f"k7_ablation: {'ok' if ok else 'a fault was NOT refused'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
