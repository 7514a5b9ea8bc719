#!/usr/bin/env python3
"""K1 (fake quant) on one GPU: what the layers pay for it, where its time
goes in the compressed prefills, and its design choices taken back one at
a time; and K2 (the DDPG MLP) at the DDPG batches.

    python3 tools/k1_ablation.py [--src DIR]
        [--sections entry,prefill,ablation,k2,decode] [--archs A,B,...]

``--src`` imports the port from another tree (default: this checkout's
``src``), so that one call can time a parent commit unpacked beside this
one: run parent, this tree, this tree, parent. Sections:

entry     Per model (the LM testbed's validation at 3,072 tokens;
          qwen2-0.5b, mamba2-780m and recurrentgemma-2b at full width over
          32,768 tokens, or the zoo configs ``--archs`` names, an MoE
          config at ``chip_smoke.MOE_DEPTH``'s layers; seeded random
          weights, seeded pq policy), every
          (shape, bits) that ``chip_smoke.k1_calls`` lists, in the dtype the
          forward hands it (activations bf16, weights f32), with its
          launches per forward: device time per call (CUDA events) of
          ``core.quantization.fake_quant`` -- the call each quantized
          linear makes, so a tree whose chain copies x to f32 and runs three
          elementwise passes around K1 pays for them here -- beside the
          bound (x read once and written once in its dtype at 3.35 TB/s),
          and the sum over one forward. Then K2 (``mlp3``) for the actor and
          the critic at B 64 and 128.
prefill   One compressed prefill forward of 1 x 32,768 tokens per serving
          model (host clock ended by a sync, after a 2,048-token warm-up),
          then one under ``torch.profiler``: device time split into K1
          (kernels named ``fake_quant*`` or ``fq_*``), PyTorch's
          elementwise passes and copies (names holding ``elementwise`` or
          ``copy``) and the rest.
ablation  This tree only: K1 at the path's shapes with its grid forced
          (``kernels.fake_quant.plan`` replaced): the committed plan; one
          launch (one slab, the block reduces and quantizes its whole
          column tile); two launches over one slab; half, twice and four
          times the slabs.
decode    The one-slab K1 launches of a decode step (8 rows: one launch
          reduces and quantizes each column tile, ``plan(...).fused``)
          of the LM testbed, qwen2-0.5b and mamba2-780m under a seeded
          pq policy: device time per call of ``core.quantization
          .fake_quant`` at each distinct (shape, bits), 200 calls after
          20 warm-ups; run it on two trees to compare them.
k2        This tree only: K2, the critic at B 64 and 128: the
          committed kernel (8 rows per cluster), and ``csrc/mlp3.cu``
          changed by a text substitution (the script fails if one no
          longer matches), compiled as ``kernels/build.py`` compiles it:
          4 and 16 rows per cluster in place of 8; then one piece taken
          out: no layer-2 products, no h1 exchange through distributed
          shared memory, no staging of W2, and all three (what is left:
          the launch, the other stages and the cluster barriers). Those
          last break the output and are timed only. Variants run in the
          order A B ... B A.

Prints the card's name and power limit. Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import importlib
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

AB_SHAPES = (((3072, 256), "float32", 4, False),
             ((3072, 256), "bfloat16", 4, True),
             ((32768, 896), "bfloat16", 4, True),
             ((32768, 4864), "float32", 1, False),
             ((32768, 4864), "bfloat16", 4, True),
             ((2560, 256000), "float32", 8, True),
             ((8, 896), "bfloat16", 4, True))


def entry(cs, torch, models):
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.quantization import fake_quant
    from repro_torch.models import model as M
    for name, cfg, rows in models:
        cm = CompressibleLM(cfg, M.init(cfg, seed=0, device="cuda"))
        calls = cs.k1_calls(cfg, cm.build_cspec(cs.seeded_policy(cm, 0)),
                            rows)
        del cm
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(3)
        total = bound_total = 0.0
        cs.log(f"[entry] {name}: {len(calls)} K1 calls per forward over "
               f"{rows} tokens, {len(set(calls))} distinct; {cs.CARD}")
        for shape, bits in sorted(set(calls), key=lambda c: (-calls.count(c),
                                                             c)):
            dtype = cs.k1_call_dtype(cfg, shape, rows)
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            ms, _ = cs.cuda_ms(lambda: fake_quant(x, bits), 10, 2)
            bound = 2 * x.element_size() * x.numel() / cs.HBM_BYTES_PER_S \
                * 1e3
            n = calls.count((shape, bits))
            total += n * ms
            bound_total += n * bound
            cs.log(f"  {list(shape)} {str(dtype)[6:]} {bits} bits x{n}: "
                   f"{ms * 1e3:.2f} us per call, bound {bound * 1e3:.3f} us")
            del x
        cs.log(f"  {name}: {total:.3f} ms of fake_quant per forward, bound "
               f"{bound_total:.3f} ms")
        torch.cuda.empty_cache()
    from repro_torch.core.ddpg import _mlp_init
    from repro_torch.kernels.mlp_fused import mlp3
    gen = torch.Generator(device="cuda").manual_seed(2)
    for batch in (64, 128):
        for net, d0, d3, sig in (("actor", 33, 3, True),
                                 ("critic", 36, 1, False)):
            flat = [l[k] for l in _mlp_init(gen, (d0, 400, 300, d3), "cuda")
                    for k in ("w", "b")]
            x = torch.randn((batch, d0), generator=gen, device="cuda")
            ms, paced = cs.cuda_ms(lambda: mlp3(x, *flat, sigmoid=sig))
            cs.log(f"[entry] mlp3 {net} B {batch}: {ms * 1e3:.2f} us "
                   f"({paced * 1e3:.2f} paced); {cs.CARD}")


def prefill(cs, torch):
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    from repro_torch.train.train_step import make_prefill_step
    from torch.profiler import ProfilerActivity, profile
    for arch in ("qwen2-0.5b", "mamba2-780m", "recurrentgemma-2b"):
        cfg = get_config(arch)
        cm = CompressibleLM(cfg, M.init(cfg, seed=0, device="cuda"))
        cspec = cm.build_cspec(cs.seeded_policy(cm, 0))
        tokens = cs.prefill_tokens(cfg, 1, cs.PREFILL_SEQ, 0, "cuda")
        step = make_prefill_step(cfg, cspec)
        cs.release_cached_memory("cuda")
        step(cm.params, tokens[:, :cs.PREFILL_WARM_SEQ])
        cs.release_cached_memory("cuda")
        t0 = time.perf_counter()
        step(cm.params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cs.release_cached_memory("cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(cm.params, tokens)
            torch.cuda.synchronize()
        split = {"K1": 0.0, "elementwise and copies": 0.0, "rest": 0.0}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", 0.0)
            if re.search(r"fake_quant|\bfq_", ev.key):
                split["K1"] += t
            elif re.search(r"elementwise|copy", ev.key, re.I):
                split["elementwise and copies"] += t
            else:
                split["rest"] += t
        busy = sum(split.values())
        cs.log(f"[prefill] {arch} under the policy, 1 x {cs.PREFILL_SEQ}: "
               f"{wall * 1e3:.1f} ms (host clock); profiled device time "
               f"{busy / 1e3:.1f} ms: " + ", ".join(
                   f"{k} {v / 1e3:.1f} ms ({v / busy:.1%})"
                   for k, v in split.items()) + f"; {cs.CARD}")
        del cm, step, tokens, prof
        cs.release_cached_memory("cuda")


def ablation(cs, torch):
    from repro_torch.kernels import fake_quant as fq
    committed = fq.plan

    def slabs(p, R, n):
        rows = fq._cdiv(fq._cdiv(R, max(1, n)), fq.ROWS) * fq.ROWS
        k = fq._cdiv(R, rows)
        return fq.Plan(p.n_ctiles, k, rows, k == 1)

    variants = {
        "committed": lambda p, R: p,
        "one launch": lambda p, R: slabs(p, R, 1),
        "two launches, one slab": lambda p, R: slabs(p, R, 1)._replace(
            fused=False),
        "half the slabs": lambda p, R: slabs(p, R, p.n_slabs // 2),
        "twice the slabs": lambda p, R: slabs(p, R, 2 * p.n_slabs),
        "four times the slabs": lambda p, R: slabs(p, R, 4 * p.n_slabs),
    }
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape, dtype, bits, ste in AB_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda").to(
            getattr(torch, dtype))
        base = committed(*shape, x.element_size())
        times = {}
        for name in list(variants) + list(variants)[::-1]:
            p = variants[name](base, shape[0])
            fq.plan = lambda R, C, itemsize, p=p: p
            try:
                ms, _ = cs.cuda_ms(lambda: fq.fake_quant_2d(x, bits, ste=ste),
                                   20, 3)
            finally:
                fq.plan = committed
            times.setdefault(name, (p, []))[1].append(ms)
        mode = "straight-through" if ste else "plain"
        cs.log(f"[ablation] {list(shape)} {dtype} {bits} bits {mode}; "
               f"{cs.CARD}")
        for name, (p, ms) in times.items():
            cs.log(f"  {name:24s} {p.n_slabs:3d} slabs x {p.n_ctiles} tiles"
                   f"{'' if p.fused else ', two launches':15s}: " +
                   " / ".join(f"{t * 1e3:.2f}" for t in ms) + " us")
        del x
        torch.cuda.empty_cache()


K2_L2 = "    dense(h1s, D1, w2s, b2s, c2, h2s, c2, red);"
K2_PUSH = ("            *cluster.map_shared_rank(h1s + idx, (rank + p) % "
           "MLP_CLUSTER) = v;")
K2_W2 = "    stage(w2s, w2 + j2, D1, c2, D2);"
K2_ROWS = "#define MLP_BM 8"
K2_VARIANTS = {
    "no layer-2 products": [(K2_L2, K2_L2.replace("D1, w2s", "0, w2s"))],
    "no h1 exchange": [(K2_PUSH, "            ;")],
    "no W2 staging": [(K2_W2, "")],
}
K2_VARIANTS["launch, stages and barriers"] = [
    sub for subs in K2_VARIANTS.values() for sub in subs]
K2_VARIANTS = {f"{r} rows per cluster": [(K2_ROWS, f"#define MLP_BM {r}")]
               for r in (4, 16)} | K2_VARIANTS


def decode(cs, torch):
    from repro_torch.configs.testbed import LM_CFG
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.quantization import fake_quant
    from repro_torch.kernels.fake_quant import plan
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    rows = 8
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, cfg in (("testbed", LM_CFG),
                      ("qwen2-0.5b", get_config("qwen2-0.5b")),
                      ("mamba2-780m", get_config("mamba2-780m"))):
        cm = CompressibleLM(cfg, M.init(cfg, seed=0, device="cuda"))
        calls = cs.k1_calls(cfg, cm.build_cspec(cs.seeded_policy(cm, 0)),
                            rows)
        del cm
        gc.collect()
        torch.cuda.empty_cache()
        for shape, bits in sorted(set(calls)):
            dtype = cs.k1_call_dtype(cfg, shape, rows)
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            if not plan(*shape, x.element_size()).fused:
                continue
            ms, paced = cs.cuda_ms(lambda: fake_quant(x, bits), 200, 20)
            cs.log(f"[decode] {name} {list(shape)} {str(dtype)[6:]} {bits} "
                   f"bits x{calls.count((shape, bits))} a step: "
                   f"{ms * 1e3:.2f} us per call ({paced * 1e3:.2f} paced); "
                   f"{cs.CARD}")


def k2_variants(build) -> dict:
    """``csrc/mlp3.cu`` with each variant's substitutions, compiled in
    parallel; name -> loaded library."""
    src = (build.CSRC / "mlp3.cu").read_text()
    out = ROOT / "build" / "k2_ablation"
    out.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, subs in K2_VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: substitution no longer matches "
                                 f"once: {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = out / (re.sub(r"\W+", "_", name) + ".cu")
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(
                ".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        handle = ctypes.CDLL(str(so))
        for fn, argtypes in build._SIGNATURES["mlp3"].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        libs[name] = handle
    return libs


def k2_ablation(cs, torch):
    from repro_torch.core.ddpg import _mlp_init
    from repro_torch.kernels import build
    from repro_torch.kernels import mlp_fused as mf
    committed_lib = build.lib("mlp3")
    libs = k2_variants(build)
    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = [l[k] for l in _mlp_init(gen, (36, 400, 300, 1), "cuda")
            for k in ("w", "b")]
    variants = ["committed"] + list(libs)
    for batch in (64, 128):
        x = torch.randn((batch, 36), generator=gen, device="cuda")
        times = {}
        for name in variants + variants[::-1]:
            build._libs["mlp3"] = libs.get(name, committed_lib)
            try:
                ms, _ = cs.cuda_ms(lambda: mf.mlp3(x, *flat), 50, 5)
            finally:
                build._libs["mlp3"] = committed_lib
            times.setdefault(name, []).append(ms)
        cs.log(f"[ablation] mlp3 critic B {batch}; {cs.CARD}")
        for name, ms in times.items():
            cs.log(f"  {name:28s}: " + " / ".join(f"{t * 1e3:.2f}"
                                                   for t in ms) + " us")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sections",
                    default="entry,prefill,ablation,k2,decode")
    ap.add_argument("--archs",
                    default="qwen2-0.5b,mamba2-780m,recurrentgemma-2b",
                    help="the zoo configs of the entry section")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("k1_ablation: needs a GPU", file=sys.stderr)
        return 2
    importlib.import_module("repro_torch.kernels.fake_quant")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs      # the port stays the one imported above
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    from repro_torch.configs.testbed import LM_CFG, VAL_BATCH, VAL_SEQ
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_config
    build.build_all()
    cs.log(f"k1_ablation on {args.src}; {cs.CARD}")
    sections = args.sections.split(",")
    if "entry" in sections:
        zoo = [get_config(a) for a in args.archs.split(",")]
        entry(cs, torch, [("testbed", LM_CFG, VAL_BATCH * VAL_SEQ)] + [
            (c.name, c.replace(num_layers=cs.MOE_DEPTH.get(
                c.name, c.num_layers)), cs.PREFILL_SEQ) for c in zoo])
    if "prefill" in sections:
        prefill(cs, torch)
    if "ablation" in sections:
        ablation(cs, torch)
    if "k2" in sections:
        k2_ablation(cs, torch)
    if "decode" in sections:
        decode(cs, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
