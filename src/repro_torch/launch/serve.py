"""Serving launcher: batched greedy decode with a KV cache (+ optional
Galen compression policy applied at load time), on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --smoke --batch 4 --steps 32

The library functions take the params' device; ``main`` runs on CUDA
only and refuses without a card. An encoder (hubert-xlarge) has no
decode step (``configs.base.cell_supported``): ``decode_loop`` refuses it
and ``main`` serves it one prefill over seeded frame embeddings
(``encode``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models import layers as L
from ..models import model as M
from ..models.registry import get_config
from ..train.train_step import make_prefill_step, make_serve_step


def _device(params) -> torch.device:
    """The device of the first weight tensor (containers included)."""
    return M.device_of(params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def _run_request(step, params, cache, toks, steps: int):
    out = [toks]
    for pos in range(steps):
        logits, cache = step(params, cache, toks, pos)
        toks = torch.argmax(logits[:, -1:], -1)
        out.append(toks)
    return out


def decode_loop(cfg, params, batch: int, steps: int, max_len: int,
                cspec=None, prompt=None, cache_bits: int = 16):
    """``steps`` greedy decode steps from a one-token prompt (zeros by
    default), argmax on the device. Returns (tokens [batch, steps + 1],
    seconds); the host clock ends on a device sync. ``cache_bits=8``
    stores the KV cache as int8."""
    step = make_serve_step(cfg, cspec=cspec)
    device = _device(params)
    cache = M.init_cache(cfg, batch, max_len, cache_bits=cache_bits,
                         device=device)
    toks = prompt if prompt is not None else \
        torch.zeros((batch, 1), dtype=torch.int64, device=device)
    _sync(device)
    t0 = time.perf_counter()
    out = _run_request(step, params, cache, toks, steps)
    _sync(device)
    dt = time.perf_counter() - t0
    return torch.cat(out, 1), dt


@torch.no_grad()
def encode(cfg, params, batch: int, frames: int, cspec=None,
           seed: int = 0):
    """An encoder's serving request: one prefill over seeded frame
    embeddings [batch, frames, d] (standard normal, from a numpy seed, in
    the compute dtype). Returns (per-frame class ids [batch, frames],
    seconds on the host clock, ended by a device sync)."""
    import numpy as np
    device = _device(params)
    embeds = torch.as_tensor(
        np.random.default_rng(seed).standard_normal(
            (batch, frames, cfg.d_model), dtype=np.float32),
        device=device).to(L.dtype_of(cfg.compute_dtype))
    step = make_prefill_step(cfg, cspec)
    _sync(device)
    t0 = time.perf_counter()
    classes = torch.argmax(step(params, None, embeds), -1)
    _sync(device)
    return classes, time.perf_counter() - t0


def sustained_throughput(cfg, params, batch: int, steps: int, max_len: int,
                         cspec=None, requests: int = 4,
                         cache_bits: int = 16):
    """Serving throughput under SUSTAINED batched requests: one warm-up
    request (first-touch allocations excluded), then ``requests`` fresh
    batched decode requests back to back, each with a new KV cache — the
    steady-state tok/s a deployed (possibly compressed) model sustains.

    Returns ``(tok_per_s, per_request_seconds)``."""
    step = make_serve_step(cfg, cspec=cspec)
    device = _device(params)
    prompt0 = torch.zeros((batch, 1), dtype=torch.int64, device=device)

    def one_request():
        cache = M.init_cache(cfg, batch, max_len, cache_bits=cache_bits,
                             device=device)
        _run_request(step, params, cache, prompt0, steps)
        _sync(device)

    one_request()
    times = []
    t_all = time.perf_counter()
    for _ in range(requests):
        t0 = time.perf_counter()
        one_request()
        times.append(time.perf_counter() - t0)
    dt = time.perf_counter() - t_all
    return requests * batch * steps / dt, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--policy", default=None,
                    help="JSON policy file from a Galen search")
    ap.add_argument("--sustained", type=int, default=0, metavar="N",
                    help="also measure steady-state tok/s over N "
                         "back-to-back batched requests")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve: no CUDA device; the port serves on the card only",
              file=sys.stderr)
        return 2

    cfg = get_config(args.arch, smoke=args.smoke)
    params = M.init(cfg, seed=0, device="cuda")

    cspec = None
    if args.policy:
        from ..core.compress import CompressibleLM
        from ..core.policy import Policy
        from ..core.spec import LayerCMP
        with open(args.policy) as f:
            rows = json.load(f)
        cspec = CompressibleLM(cfg, params).build_cspec(
            Policy([LayerCMP(**r) for r in rows]))

    if cfg.is_encoder:
        classes, dt = encode(cfg, params, args.batch, args.max_len, cspec)
        print(f"[serve] {args.arch} is an encoder (no decode step): "
              f"{args.batch} x {args.max_len} frames in {dt:.2f}s -> "
              f"{args.batch * args.max_len / dt:.1f} frames/s "
              f"({torch.cuda.get_device_name(0)})")
        print("[serve] sample:", classes[0, :16].tolist())
        return 0

    tokens, dt = decode_loop(cfg, params, args.batch, args.steps,
                             args.max_len, cspec)
    tps = args.batch * args.steps / dt
    print(f"[serve] {args.arch}: {args.steps} steps x batch {args.batch} "
          f"in {dt:.2f}s -> {tps:.1f} tok/s "
          f"({torch.cuda.get_device_name(0)})")
    print("[serve] sample:", tokens[0, :16].tolist())

    if args.sustained > 0:
        tok_s, times = sustained_throughput(
            cfg, params, args.batch, args.steps, args.max_len, cspec,
            requests=args.sustained)
        print(f"[serve] sustained: {args.sustained} requests -> "
              f"{tok_s:.1f} tok/s "
              f"(per-request {min(times):.3f}-{max(times):.3f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
