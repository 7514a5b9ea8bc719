#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Device: requires CUDA (no CPU fallback); prints the card.
2. Build: compiles the hand-written kernels (K1 fake-quant, K2 fused
   3-layer MLP, K3 Polyak, K4/K5 int8 and packed-int4 quantized matmul)
   from ``src/repro_torch/kernels/csrc``, one nvcc per source, all at
   once, and prints nvcc's registers / shared memory per kernel.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, with its tolerance, and timed with CUDA
   events (kernel, plain version, one library call where one computes
   the same function) beside its bound. K4/K5 also: the asymmetric
   zero-point case with its SUBTRACT-convention canary, a padded K with
   ``k_true``, and ``torch._int_mm`` on the same codes as a yardstick for
   the int8 product alone.
4. Main path: the joint ("pq") ``CompressionSearch`` on the full-width LM
   testbed (seeded random weights, bf16 compute, analytic oracle):
   sensitivity analysis, then episodes of rollout, validation, reward and
   DDPG updates. The launch counts are reset just before and read just
   after; K1-K3 must have launched. The best policy's validation is
   checked against the plain CPU path on a small batch.
5. Calibration path: ``repro_torch.launch.calibrate.run`` at full width
   (unit, kernel and whole-model deploy-path timings, the fitted table,
   the int8/int4 demo rows), launch counts reset before and read after;
   K4 and K5 must have launched and every time must be finite.
6. Measured search: a pq ``CompressionSearch`` with
   ``oracle_mode="measured"`` on the fitted table; its top-K rows
   (predicted vs measured ratio) must be finite and its reference
   latency the calibrated oracle's.
7. Lines before the last: the kernels as JSON, then ``nvidia-smi``'s name
   and power limit. Last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # f32 outside the tensor cores
INT8_OPS = 1979e12             # int8 tensor cores, dense

KERNELS = {
    "fake_quant": {"source": "src/repro_torch/kernels/csrc/fake_quant.cu",
                   "replaces": "src/repro/kernels/fake_quant.py:22"},
    "mlp3": {"source": "src/repro_torch/kernels/csrc/mlp3.cu",
             "replaces": "src/repro/kernels/mlp_fused.py:32"},
    "polyak": {"source": "src/repro_torch/kernels/csrc/polyak.cu",
               "replaces": "src/repro/kernels/mlp_fused.py:85"},
    "quant_matmul_int8": {
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:53"},
    "quant_matmul_int4": {
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:90"},
}
MAIN_PATH_KERNELS = ("fake_quant", "mlp3", "polyak")
CALIBRATION_KERNELS = ("quant_matmul_int8", "quant_matmul_int4")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> tuple:
    """(device ms, paced ms) per call of ``fn``, both from CUDA events
    around ``iters`` back-to-back calls after a warm-up. For the device
    time a sleep kernel first holds the stream while the host queues all
    the calls, so the events bracket the calls' device work alone; the
    paced time lets the host issue them as it goes, so it also counts
    launch gaps (what a host-driven loop such as the search sees)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for ahead in (True, False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(50_000_000)     # tens of ms at H100 clocks
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return tuple(out)


def bound_ms(n_bytes: float, n_ops: float, peak: float = F32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_fake_quant(cfg, device) -> dict:
    """K1 at the activation shapes ([64*48, 256] and [64*48, 1024]) and
    every weight shape of the testbed; tolerance: exact (the plain
    version on the card runs the same correctly rounded f32 ops)."""
    import torch
    from repro_torch.kernels.fake_quant import fake_quant_2d
    from repro_torch.kernels.ref import fake_quant_ref
    from repro_torch.configs.testbed import VAL_BATCH, VAL_SEQ
    rows = VAL_BATCH * VAL_SEQ
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    shapes = [(rows, d), (rows, ff), (cfg.vocab_size, d),
              (d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd),
              (d, ff), (ff, d)]
    gen = torch.Generator(device=device).manual_seed(1)
    err, out = 0.0, {}
    for shape in dict.fromkeys(shapes):
        x = torch.randn(shape, generator=gen, device=device)
        for bits in (2, 4, 6, 8, 32):
            e = (fake_quant_2d(x, bits) - fake_quant_ref(x, bits)).abs()
            err = max(err, float(e.max()))
        log(f"  fake_quant {shape}: max |kernel - plain| so far {err:.3g}")
        if shape[0] == rows:        # the activation shapes: time them
            ms, paced = cuda_ms(lambda: fake_quant_2d(x, 4))
            plain, _ = cuda_ms(lambda: fake_quant_ref(x, 4))
            n = x.numel()
            bound, by = bound_ms(8.0 * n, 10.0 * n)
            log(f"    {list(shape)} 4 bits: {ms * 1e3:.2f} us kernel, "
                f"{plain * 1e3:.2f} us plain, bound {bound * 1e3:.3f} us")
            if shape == (rows, d):
                out.update(ms=ms, paced_ms=paced, plain_ms=plain,
                           bound_ms=bound, bound_by=by, shape=list(shape))
    out.update(max_abs_err=err, tolerance=0.0, library_ms=None)
    if err > 0.0:
        raise AssertionError(f"fake_quant disagrees with its plain version: "
                             f"max abs err {err}")
    return out


def check_mlp3(state_dim, action_dim, hidden, batch, device) -> dict:
    """K2 forward (y, h1, h2) and autograd backward for the actor and the
    critic at the DDPG batch; tolerance 1e-5 (f32, summation order)."""
    import torch
    from repro_torch.core.ddpg import _mlp_init
    from repro_torch.kernels import ops
    from repro_torch.kernels.mlp_fused import mlp3
    from repro_torch.kernels.ref import mlp3_ref
    gen = torch.Generator(device=device).manual_seed(2)
    err, out = 0.0, {}
    for name, d0, d3, final in (("actor", state_dim, action_dim, "sigmoid"),
                                ("critic", state_dim + action_dim, 1,
                                 "linear")):
        params = _mlp_init(gen, (d0,) + tuple(hidden) + (d3,), device)
        x = torch.randn((batch, d0), generator=gen, device=device)
        flat = [l[k] for l in params for k in ("w", "b")]
        sig = final == "sigmoid"
        got = mlp3(x, *flat, sigmoid=sig)
        want = mlp3_ref(x, *flat, sig)
        for g, w in zip(got, want):
            err = max(err, float((g - w).abs().max()))
        leaves_k = [t.clone().requires_grad_(True) for t in [x] + flat]
        leaves_r = [t.clone().requires_grad_(True) for t in [x] + flat]
        pk = [{"w": leaves_k[1 + 2 * i], "b": leaves_k[2 + 2 * i]}
              for i in range(3)]
        yk = ops.fused_mlp3(pk, leaves_k[0], final=final)
        yr = mlp3_ref(leaves_r[0], *leaves_r[1:], sig)[0]
        gk = torch.autograd.grad((yk ** 2).sum(), leaves_k)
        gr = torch.autograd.grad((yr ** 2).sum(), leaves_r)
        for a, b in zip(gk, gr):
            err = max(err, float((a - b).abs().max()))
        log(f"  mlp3 {name} [{batch},{d0}]->{hidden}->{d3}: max |kernel - "
            f"plain| so far {err:.3g}")
        if name == "critic":
            out["ms"], out["paced_ms"] = cuda_ms(
                lambda: mlp3(x, *flat, sigmoid=sig))
            out["plain_ms"], _ = cuda_ms(lambda: mlp3_ref(x, *flat, sig))
            d1, d2 = hidden
            w_elems = sum(t.numel() for t in flat)
            n_bytes = 4.0 * (x.numel() + w_elems + batch * (d1 + d2 + d3))
            n_ops = 2.0 * batch * (d0 * d1 + d1 * d2 + d2 * d3)
            out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops)
            out["shape"] = [batch, d0, d1, d2, d3]
    out.update(max_abs_err=err, tolerance=1e-5, library_ms=None)
    if err > 1e-5:
        raise AssertionError(f"mlp3 disagrees with its plain version: "
                             f"max abs err {err}")
    return out


def check_polyak(sizes, tau, device) -> dict:
    """K3 over the actor's and the critic's flat sizes; tolerance: exact
    (the same two products and sum, each correctly rounded)."""
    import torch
    from repro_torch.kernels.mlp_fused import polyak_flat
    from repro_torch.kernels.ref import polyak_ref
    gen = torch.Generator(device=device).manual_seed(3)
    err, out = 0.0, {}
    for n in sizes:
        t = torch.randn(n, generator=gen, device=device)
        p = torch.randn(n, generator=gen, device=device)
        err = max(err, float((polyak_flat(t, p, tau)
                              - polyak_ref(t, p, tau)).abs().max()))
        log(f"  polyak n={n}: max |kernel - plain| so far {err:.3g}")
    out["ms"], out["paced_ms"] = cuda_ms(lambda: polyak_flat(t, p, tau))
    out["plain_ms"], _ = cuda_ms(lambda: polyak_ref(t, p, tau))
    out["library_ms"], _ = cuda_ms(lambda: torch.lerp(t, p, tau))
    out["bound_ms"], out["bound_by"] = bound_ms(12.0 * n, 3.0 * n)
    out.update(max_abs_err=err, tolerance=0.0, shape=[n])
    if err > 0.0:
        raise AssertionError(f"polyak disagrees with its plain version: "
                             f"max abs err {err}")
    return out


def quant_matmul_shapes(cfg) -> tuple:
    """(M, K, N) of K4/K5's checks, as (timed, checked only): the
    ``measure_kernel_rows`` shape and every unit (k, n) of the testbed at
    the calibration's tokens; the JAX tests' ragged shapes and one odd
    K."""
    from repro_torch.configs.testbed import VAL_SEQ
    from repro_torch.core.compress import lm_layer_specs
    from repro_torch.core.measure import _unit_dims
    from repro_torch.launch.calibrate import CALIB_SEQS
    m = CALIB_SEQS * VAL_SEQ
    timed = [(256, 256, 256)] + [(m,) + _unit_dims(s)
                                 for s in lm_layer_specs(cfg)]
    return (list(dict.fromkeys(timed)),
            [(33, 512, 257), (200, 300, 130), (64, 301, 96)])


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def check_quant_matmul(cfg, device) -> dict:
    """K4 and K5 against their plain version on the card; tolerance: exact
    (int32 products are exact in both, and the epilogue is the same
    correctly rounded f32 steps in the same order). At every shape of
    ``quant_matmul_shapes`` with k_true = K; then the asymmetric case
    (x + 3, w − 1) with the SUBTRACT-convention canary, and a K padded
    from 300 to 512 with k_true = 300. ``ops.quantized_matmul`` must stay
    within the JAX tests' bounds of the f32 product (0.03 relative at
    int8, 0.2 at int4)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant_matmul import quant_matmul
    gen = torch.Generator(device=device).manual_seed(4)
    timed, ragged = quant_matmul_shapes(cfg)
    out = {}
    for bits, name in ((8, "quant_matmul_int8"), (4, "quant_matmul_int4")):
        packed = bits == 4
        err, units, res = 0.0, [], {}
        for (M, K, N) in timed + ragged:
            x = torch.randn((M, K), generator=gen, device=device)
            w = torch.randn((K, N), generator=gen, device=device)
            args, _ = ops.quantize_operands(x, w, bits)
            got = quant_matmul(*args, packed=packed, k_true=K)
            want = ref.quant_matmul_ref(*args, packed=packed, k_true=K)
            err = max(err, float((got - want).abs().max()))
            rel = _rel(ops.quantized_matmul(x, w, w_bits=bits), x @ w)
            log(f"  {name} ({M}, {K}, {N}): max |kernel - plain| so far "
                f"{err:.3g}; |quantized - f32| / |f32| = {rel:.4f}")
            if rel > (0.2 if packed else 0.03):
                raise AssertionError(f"{name} ({M}, {K}, {N}): quantized "
                                     f"product off the f32 one by {rel}")
            if (M, K, N) not in timed:
                continue
            ms, paced = cuda_ms(lambda: quant_matmul(*args, packed=packed,
                                                     k_true=K))
            plain, _ = cuda_ms(lambda: ref.quant_matmul_ref(
                *args, packed=packed, k_true=K))
            codes = ref.unpack_int4_ref(args[1]) if packed else args[1]
            int_mm, _ = cuda_ms(lambda: torch._int_mm(args[0], codes))
            n_bytes = (M * K + (K * N // 2 if packed else K * N)
                       + 4 * M * N + 8 * (M + N))
            bound, by = bound_ms(n_bytes, 2.0 * M * N * K, INT8_OPS)
            row = dict(shape=[M, K, N], ms=ms, paced_ms=paced, plain_ms=plain,
                       int_mm_ms=int_mm, bound_ms=bound, bound_by=by)
            log(f"    {[M, K, N]}: {ms * 1e3:.2f} us kernel, {plain * 1e3:.2f}"
                f" us plain, {int_mm * 1e3:.2f} us torch._int_mm (the int8 "
                f"product alone), bound {bound * 1e3:.3f} us ({by})")
            if (M, K, N) == (256, 256, 256):
                res.update(row)
            else:
                units.append(row)
        res.update(units=units, library_ms=None)

        # asymmetric zero points: large correction terms, so a sign slip
        # in the epilogue is a gross miss
        x = torch.randn((64, 128), generator=gen, device=device) + 3.0
        w = torch.randn((128, 96), generator=gen, device=device) - 1.0
        (xq, wq, sx, zx, sw, zw), _ = ops.quantize_operands(x, w, bits)
        got = quant_matmul(xq, wq, sx, zx, sw, zw, packed=packed)
        err = max(err, float((got - ref.quant_matmul_ref(
            xq, wq, sx, zx, sw, zw, packed=packed)).abs().max()))
        codes = ref.unpack_int4_ref(wq) if packed else wq
        truth = ref.dequant_matmul_ref(xq, codes, sx, zx, sw, zw)
        torch.testing.assert_close(got, truth, rtol=1e-3, atol=0.1)
        rel = _rel(truth, x @ w)
        wrong = _rel(ref.int8_matmul_ref(xq, codes, sx, -zx, sw, -zw), x @ w)
        log(f"  {name} asymmetric (64, 128, 96): |kernel - dequantized "
            f"truth| ok; rel vs f32 {rel:.4f}, SUBTRACT convention {wrong:.3g}")
        if not rel < (0.2 if packed else 0.03) or not wrong > 10 * rel:
            raise AssertionError(f"{name}: asymmetric case rel {rel}, "
                                 f"SUBTRACT canary {wrong}")

        # K padded 300 -> 512 with zero codes; k_true keeps the true count
        x = torch.randn((32, 300), generator=gen, device=device) + 1.0
        w = torch.randn((300, 64), generator=gen, device=device)
        xq, sx, zx = ref.quantize_rows(x, 8)
        codes, sw, zw = ref.quantize_cols(w, bits)
        truth = ref.dequant_matmul_ref(xq, codes, sx, zx, sw, zw)
        xq_p = torch.zeros((32, 512), dtype=torch.int8, device=device)
        xq_p[:, :300] = xq
        wq_p = torch.zeros((512, 64), dtype=torch.int8, device=device)
        wq_p[:300] = codes
        wq_p = ref.pack_int4(wq_p) if packed else wq_p
        got = quant_matmul(xq_p, wq_p, sx, zx, sw, zw, packed=packed,
                           k_true=300)
        err = max(err, float((got - ref.quant_matmul_ref(
            xq_p, wq_p, sx, zx, sw, zw, packed=packed, k_true=300)
        ).abs().max()))
        torch.testing.assert_close(got, truth, rtol=1e-3, atol=0.1)
        bad = float((quant_matmul(xq_p, wq_p, sx, zx, sw, zw, packed=packed)
                     - truth).abs().max())
        log(f"  {name} K padded 300 -> 512: k_true ok; without it off by "
            f"{bad:.3g}")
        if not bad > 1.0:
            raise AssertionError(f"{name}: k_true has no effect ({bad})")

        res.update(max_abs_err=err, tolerance=0.0)
        if err > 0.0:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"max abs err {err}")
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def run_main_path(cfg, device, *, episodes: int, warmup: int, updates: int,
                  batch_size: int, val_batch: int, val_seq: int,
                  seed: int = 0, verbose: bool = True):
    """Sensitivity + ``episodes`` of the pq search on ``cfg`` with seeded
    random weights. Returns (search, history, sensitivity seconds, episode
    seconds); the host clock brackets work that ends in a device sync."""
    import torch
    from repro_torch.configs.testbed import SERVE_CTX
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.reward import RewardConfig
    from repro_torch.core.search import CompressionSearch, SearchConfig
    from repro_torch.core.sensitivity import run_sensitivity
    from repro_torch.data.pipeline import make_bigram_table, sample_bigram
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models import model as M

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    cm = CompressibleLM(cfg, M.init(cfg, seed=seed, device=device))
    table = make_bigram_table(cfg.vocab_size, seed)
    val = {"tokens": torch.as_tensor(
        sample_bigram(table, val_batch, val_seq, seed + 7),
        dtype=torch.int64, device=device)}
    scfg = SearchConfig(
        methods="pq", episodes=episodes, seed=seed,
        reward=RewardConfig(target_ratio=0.5, beta=-3.0),
        ddpg=DDPGConfig(warmup_episodes=warmup, updates_per_episode=updates,
                        batch_size=batch_size, buffer_size=2000))
    sync()
    t0 = time.perf_counter()
    sens = run_sensitivity(cm, val)
    sync()
    t_sens = time.perf_counter() - t0
    if verbose:
        log(f"  launches after the sensitivity analysis: {dict(LAUNCHES)}")
    search = CompressionSearch(cm, val, scfg, SERVE_CTX, sens=sens)
    sync()
    t0 = time.perf_counter()
    history = []
    for e in range(episodes):
        rec = search.run_episode(e)
        history.append(rec)
        if verbose:
            bits = " ".join(f"{c.w_bits}/{c.a_bits}" for c in rec.policy.cmps)
            log(f"  ep {e:2d} reward={rec.reward:+.4f} acc={rec.accuracy:.4f} "
                f"lat_ratio={rec.latency_ratio:.4f} sigma={rec.sigma:.3f} "
                f"w/a bits: {bits}")
    sync()
    t_eps = time.perf_counter() - t0
    return search, history, t_sens, t_eps


def check_main_path(search, history, cfg, episodes: int) -> None:
    """Finite records of the expected count, then two agreements on a
    small batch under f32 compute: (1) the best policy's validation
    through the kernels equals, bit for bit, the same forward with the
    plain fake-quant in place of K1 on the same device; (2) the
    uncompressed forward on the device agrees with the plain CPU path
    (>= 99% of the next-token argmaxes; the matmuls sum in other
    orders)."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.policy import Policy
    from repro_torch.kernels import fake_quant as kfq
    from repro_torch.kernels.ref import fake_quant_ref
    if len(history) != episodes:
        raise AssertionError(f"{len(history)} records, wanted {episodes}")
    for r in history:
        vals = (r.reward, r.accuracy, r.latency_s, r.latency_ratio)
        if not all(math.isfinite(v) for v in vals) \
                or not 0.0 <= r.accuracy <= 1.0:
            raise AssertionError(f"bad record {r}")
    best = max(history, key=lambda r: r.reward)
    f32 = cfg.replace(compute_dtype="float32")
    cm = CompressibleLM(f32, search.cmodel.params)
    small = {"tokens": search.val_batch["tokens"][:8]}
    cspec = cm.build_cspec(best.policy)
    lp_kernel = cm.log_probs(small, cspec)
    launch = kfq.fake_quant_2d
    kfq.fake_quant_2d = fake_quant_ref
    try:
        lp_plain = cm.log_probs(small, cspec)
    finally:
        kfq.fake_quant_2d = launch
    if not torch.isfinite(lp_kernel).all() or tuple(lp_kernel.shape) != \
            tuple(small["tokens"].shape) + (cfg.vocab_size,):
        raise AssertionError(f"bad log-probs {tuple(lp_kernel.shape)}")
    diff = float((lp_kernel - lp_plain).abs().max())
    log(f"  best policy (episode {best.episode}), f32: max |log-prob through "
        f"K1 - through the plain fake-quant| = {diff:.3g}")
    if diff != 0.0:
        raise AssertionError("the kernel path and the plain path differ")

    ref = Policy.reference(cm.specs)
    cpu = CompressibleLM(f32, _to(search.cmodel.params, "cpu"))
    lp_dev = cm.log_probs(small, cm.build_cspec(ref)).cpu()
    lp_cpu = cpu.log_probs({"tokens": small["tokens"].cpu()},
                           cpu.build_cspec(ref))
    agree = float((lp_dev.argmax(-1) == lp_cpu.argmax(-1)).float().mean())
    log(f"  uncompressed, f32: argmax agreement device vs plain CPU path "
        f"{agree:.4f}, max |log-prob diff| "
        f"{float((lp_dev - lp_cpu).abs().max()):.3g}")
    if agree < 0.99:
        raise AssertionError(f"the device forward disagrees with the CPU "
                             f"path: {agree:.4f} of argmaxes agree")


def profile_episodes(search, first: int, n: int) -> dict:
    """Where an episode's time goes, from ``n`` more episodes (not in the
    launch counts): host-clock split of rollout / validation / update
    (each ended by a device sync), then one ``torch.profiler`` pass for
    the device's busy share and the kernels that take most device time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.policy import Policy
    split = {"rollout": 0.0, "validation": 0.0, "update": 0.0}
    agent = search.agent
    chunk = agent.update_chunk
    act = agent.act
    cm = search.cmodel
    accuracy = cm.accuracy

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out
        return run

    agent.update_chunk = timed("update", chunk)
    agent.act = timed("rollout", act)
    cm.accuracy = timed("validation", accuracy)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in range(first, first + n):
            search.run_episode(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        agent.update_chunk, agent.act, cm.accuracy = chunk, act, accuracy
    split = {k: v / n for k, v in split.items()}
    split["other host"] = wall / n - sum(split.values())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for e in range(first + n, first + 2 * n):
            search.run_episode(e)
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    rows = [(getattr(ev, "self_device_time_total", 0.0), ev.key)
            for ev in prof.key_averages()
            if getattr(ev, "device_type", None) is not None
            and "CUDA" in str(ev.device_type)]
    busy_s = sum(t for t, _ in rows) * 1e-6
    return {"episode_s": wall / n, "split_s": split,
            "profiled_wall_s": wall_prof, "device_busy_s": busy_s,
            "top": sorted(rows, reverse=True)[:8]}


# ---------------------------------------------------------------------------
# Phases 5 and 6: the calibration path and the measured search
# ---------------------------------------------------------------------------

def _positive(x) -> bool:
    return isinstance(x, float) and math.isfinite(x) and x > 0


def run_calibration(cfg, device, verbose: bool = True) -> dict:
    """``launch.calibrate.run`` (no file written); prints its rows and
    fails on a time that is not finite and positive."""
    from repro_torch.launch import calibrate
    out = calibrate.run(out_path=None, device=device, cfg=cfg,
                        verbose=False)
    for r in out["units"]:
        if "skipped" in r:
            log(f"  unit {r['kind']:9s} {r['container']:4s} skipped: "
                f"{r['skipped']}")
            continue
        if verbose:
            log(f"  unit {r['kind']:9s} {r['container']:4s} m={r['m']} "
                f"k={r['k']} n={r['n']}: {r['measured_s'] * 1e6:.2f} us "
                f"measured, {r['analytic_s'] * 1e6:.4f} us analytic, "
                f"ratio {r['ratio']:.4g}")
        if not (_positive(r["measured_s"]) and _positive(r["ratio"])):
            raise AssertionError(f"bad unit row {r}")
    for r in out["kernels"]:
        log(f"  kernel row {r['kernel']} {r['M']}x{r['K']}x{r['N']}: "
            f"{r['measured_s'] * 1e6:.2f} us (host clock, quantization "
            f"steps included, best of 5)")
    for c, r in out["model"].items():
        log(f"  model {c}: {r['measured_s'] * 1e3:.4f} ms per deployed "
            f"forward ({out['meta']['ctx']['batch']} x "
            f"{out['meta']['ctx']['seq_ctx']} tokens)")
    for k, d in sorted(out["ratios"].items()):
        log(f"  ratio {k:9s} " + " ".join(
            f"{c}={v:.4g}" for c, v in sorted(d.items())))
    log(f"  extra (attention / overhead) factor "
        f"{out['extra']['attn']:.4g}")
    for r in out["demo"]:
        log(f"  demo {r['container']}: predicted_ratio "
            f"{r['predicted_ratio']:.4f}, measured_ratio "
            f"{r['measured_ratio']:.4f}, within_tol={r['within_tol']} "
            f"(tolerance {r['tolerance']}; a finding, not a check)")
    times = [r["measured_s"] for r in out["kernels"]] + \
        [r["measured_s"] for r in out["model"].values()] + \
        [r["predicted_s"] for r in out["demo"]]
    if not all(_positive(t) for t in times) \
            or not math.isfinite(out["extra"]["attn"]):
        raise AssertionError("a calibration time is not finite and positive")
    return out


def run_measured_search(cfg, device, table_dict: dict, *, episodes: int,
                        warmup: int, updates: int, batch_size: int):
    """A pq search in ``oracle_mode="measured"`` on the fitted table, at
    the table's own context and token batch (so that the predicted and
    the measured ratios describe the same forward). Checks the top-K rows
    and that the reference latency is the calibrated oracle's."""
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.latency import V5E, LatencyContext, policy_latency
    from repro_torch.core.measure import CalibrationTable
    from repro_torch.core.policy import Policy
    from repro_torch.core.reward import RewardConfig
    from repro_torch.core.search import CompressionSearch, SearchConfig
    from repro_torch.launch.calibrate import SEED, calibration_batch
    from repro_torch.models import model as M

    top_k = 3
    table = CalibrationTable.from_dict(table_dict)
    ctx = LatencyContext(**table.meta["ctx"])
    batch = calibration_batch(cfg, device)
    cm = CompressibleLM(cfg, M.init(cfg, seed=SEED, device=device))
    scfg = SearchConfig(
        methods="pq", episodes=episodes, seed=SEED,
        reward=RewardConfig(target_ratio=0.5, beta=-3.0),
        ddpg=DDPGConfig(warmup_episodes=warmup, updates_per_episode=updates,
                        batch_size=batch_size, buffer_size=2000),
        oracle_mode="measured", measure_top_k=top_k)
    search = CompressionSearch(cm, batch, scfg, ctx, calib=table)
    result = search.run()
    want = policy_latency(cm.specs, Policy.reference(cm.specs), V5E, ctx,
                          calib=table).total_s
    if search.ref_lat.total_s != want:
        raise AssertionError(f"reference latency {search.ref_lat.total_s} "
                             f"is not the calibrated oracle's {want}")
    rows = result.measured or []
    if len(rows) != min(top_k, episodes):
        raise AssertionError(f"{len(rows)} measured rows, wanted {top_k}")
    for r in rows:
        if not all(_positive(float(r[k])) for k in (
                "predicted_s", "predicted_ratio", "measured_s",
                "measured_ref_s", "measured_ratio")):
            raise AssertionError(f"bad measured row {r}")
    return result


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a GPU only", file=sys.stderr)
        return 2
    from repro_torch.configs.testbed import LM_CFG, VAL_BATCH, VAL_SEQ
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.policy import n_actions
    from repro_torch.core.state import state_dim
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s for "
        f"{sorted(report) or 'nothing (cached)'}")
    for name, r in sorted(report.items()):
        for row in r["ptxas"]:
            log(f"  {name}: {row}")

    log("[kernels] each kernel against its plain version on the card")
    A = n_actions("pq")
    S = state_dim(A)
    ddpg = DDPGConfig(state_dim=S, action_dim=A)
    batch = 64
    d1, d2 = ddpg.hidden
    actor_n = S * d1 + d1 + d1 * d2 + d2 + d2 * A + A
    critic_n = (S + A) * d1 + d1 + d1 * d2 + d2 + d2 + 1
    results = {
        "fake_quant": check_fake_quant(LM_CFG, device),
        "mlp3": check_mlp3(S, A, ddpg.hidden, batch, device),
        "polyak": check_polyak((actor_n, critic_n), ddpg.tau, device),
        **check_quant_matmul(LM_CFG, device),
    }
    for name, r in results.items():
        lib_ms = r["library_ms"]
        log(f"  {name} {r['shape']}: {r['ms'] * 1e3:.2f} us kernel "
            f"({r['paced_ms'] * 1e3:.2f} us per call paced by the host), "
            f"{r['plain_ms'] * 1e3:.2f} us plain, "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'} library,"
            f" bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}); "
            f"max err {r['max_abs_err']:.3g} (tol {r['tolerance']})")

    episodes, warmup, updates = 12, 4, 16
    log(f"[main path] pq CompressionSearch on {LM_CFG.name} "
        f"({LM_CFG.num_layers}L d={LM_CFG.d_model} {LM_CFG.compute_dtype}), "
        f"{episodes} episodes, warmup {warmup}, {updates} updates/episode, "
        f"DDPG batch {batch}")
    build.reset_launches()
    search, history, t_sens, t_eps = run_main_path(
        LM_CFG, device, episodes=episodes, warmup=warmup, updates=updates,
        batch_size=batch, val_batch=VAL_BATCH, val_seq=VAL_SEQ)
    launches = dict(build.LAUNCHES)
    log(f"  sensitivity {t_sens:.3f} s; {episodes} episodes in {t_eps:.3f} s "
        f"= {episodes / t_eps:.3f} episodes/s; launches {launches}")
    missing = [k for k in MAIN_PATH_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    check_main_path(search, history, LM_CFG, episodes)

    prof = profile_episodes(search, episodes, 2)
    log(f"[time] {prof['episode_s'] * 1e3:.1f} ms per episode (host clock, "
        f"syncs at phase ends): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in prof["split_s"].items()))
    if prof["device_busy_s"] > 0:
        busy = prof["device_busy_s"] / 2
        log(f"  profiler: device busy {busy * 1e3:.1f} ms per episode, "
            f"{busy / prof['episode_s']:.1%} of the unprofiled episode "
            f"({1 - busy / prof['episode_s']:.1%} idle; the profiled "
            f"wall, {prof['profiled_wall_s'] * 1e3:.0f} ms for 2, is "
            f"mostly tracing); top device time over 2 episodes (us):")
        for t, key in prof["top"]:
            log(f"    {t:10.1f}  {key[:90]}")
    else:
        log("  profiler: no device time recorded (device busy share not "
            "measured)")

    log(f"[calibration path] launch.calibrate.run on {LM_CFG.name} at full "
        f"width (deploy-path units, K4/K5 kernel rows, raw/int8/int4 "
        f"deployed forwards, fit)")
    build.reset_launches()
    t0 = time.perf_counter()
    calib = run_calibration(LM_CFG, device)
    calib_launches = dict(build.LAUNCHES)
    log(f"  {time.perf_counter() - t0:.2f} s; launches {calib_launches}")
    missing = [k for k in CALIBRATION_KERNELS if calib_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the calibration "
                             f"path: {missing}")
    launches.update({k: calib_launches[k] for k in CALIBRATION_KERNELS})

    m_eps, m_warm = 8, 4
    log(f"[measured search] pq CompressionSearch, oracle_mode='measured' on "
        f"the fitted table, {m_eps} episodes, warmup {m_warm}, top 3 "
        f"re-timed")
    build.reset_launches()
    t0 = time.perf_counter()
    res = run_measured_search(LM_CFG, device, calib, episodes=m_eps,
                              warmup=m_warm, updates=4, batch_size=batch)
    log(f"  {time.perf_counter() - t0:.2f} s; reference latency "
        f"{res.ref_latency_s * 1e3:.4f} ms (calibrated oracle); launches "
        f"{dict(build.LAUNCHES)}")
    for r in res.measured:
        log(f"  top-K episode {r['episode']} reward {r['reward']:+.4f}: "
            f"predicted {r['predicted_s'] * 1e3:.4f} ms (ratio "
            f"{r['predicted_ratio']:.4f}), measured "
            f"{r['measured_s'] * 1e3:.4f} ms vs reference "
            f"{r['measured_ref_s'] * 1e3:.4f} ms (ratio "
            f"{r['measured_ratio']:.4f})")

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": launches[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in results.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
