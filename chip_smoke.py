#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Device: requires CUDA (no CPU fallback); prints the card.
2. Build: compiles the hand-written kernels (K1 fake-quant, K2 fused
   3-layer MLP, K3 Polyak) from ``src/repro_torch/kernels/csrc`` and
   prints nvcc's registers / shared memory per kernel.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes, with its tolerance, and timed with CUDA events
   (kernel, plain version, one library call where one computes the same
   function) beside its bound.
4. Main path: the joint ("pq") ``CompressionSearch`` on the full-width LM
   testbed (seeded random weights, bf16 compute): sensitivity analysis,
   then episodes of rollout, validation, reward and DDPG updates. The
   launch counts are reset just before and read just after; every kernel
   must have launched. The best policy's validation is checked against
   the plain CPU path on a small batch.
5. Lines before the last: the kernels as JSON, then ``nvidia-smi``'s name
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

KERNELS = {
    "fake_quant": {"source": "src/repro_torch/kernels/csrc/fake_quant.cu",
                   "replaces": "src/repro/kernels/fake_quant.py:22"},
    "mlp3": {"source": "src/repro_torch/kernels/csrc/mlp3.cu",
             "replaces": "src/repro/kernels/mlp_fused.py:32"},
    "polyak": {"source": "src/repro_torch/kernels/csrc/polyak.cu",
               "replaces": "src/repro/kernels/mlp_fused.py:85"},
}


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
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
    missing = [k for k, v in launches.items() if v == 0]
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
