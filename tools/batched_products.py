#!/usr/bin/env python3
"""The batched validation's products on one GPU: one bmm over the policy
slots (``layers.product_slots``, what the port runs) against each slot's
own 2-D product, each held against the scalar forward of the slot's
policy.

    python3 tools/batched_products.py

On the full-width LM testbed (seeded random weights, 8 x 48 seeded
tokens), for 8 policies (the reference, then seeded pq policies as
``chip_smoke.seeded_policy`` draws them) in one batched cspec, in f32
and bf16 compute: per slot, the largest |logit difference| from the
scalar forward (``model.forward`` with the policy's own cspec) and the
share of argmaxes that agree, first with the committed products (one
bmm for the K slots; a matmul of all the rows where they share a
weight), then with ``product_slots`` replaced by one 2-D product per
slot (the scalar path's own). Then
the time of one batched forward under each at the validation batch (64 x
48 tokens): host clock around the forward and a sync, best of 10 after
2 warm-ups (the forward is ~1,000 launches, so the host's launch cost
counts, as it does in the search). Prints the card's name and power
limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def per_slot_products(xs, ws, dtype):
    """One 2-D product per slot, the scalar forward's own."""
    import torch
    return torch.stack([torch.einsum("ri,io->ro", x, w.to(dtype))
                        for x, w in zip(xs, ws)])


def forward_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Best host-clock ms of ``fn`` followed by a device sync."""
    import torch
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def main() -> int:
    import torch
    import chip_smoke as C
    from repro_torch.configs.testbed import LM_CFG, VAL_BATCH, VAL_SEQ
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.policy import Policy, stack_policies
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    if not torch.cuda.is_available():
        print("batched_products: needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    C.CARD = card
    dev = torch.device("cuda", 0)
    params = M.init(LM_CFG, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, LM_CFG.vocab_size, (VAL_BATCH, VAL_SEQ),
                         generator=gen, device=dev)
    committed = L.product_slots
    for dtype in ("float32", LM_CFG.compute_dtype):
        cfg = LM_CFG.replace(compute_dtype=dtype)
        cm = CompressibleLM(cfg, params)
        pols = [Policy.reference(cm.specs)] + [
            C.seeded_policy(cm, k) for k in range(1, C.SLOTS)]
        pb = stack_policies(cm.specs, pols)
        bcs = cm.cspec_builder()(pb.keep, pb.w_bits, pb.a_bits)
        small = toks[:8]
        with torch.no_grad():
            scalar = [M.forward(cfg, params, small, cm.build_cspec(p))
                      for p in pols]
            for name, fn in (("bmm", committed),
                             ("per-slot", per_slot_products)):
                L.product_slots = fn
                try:
                    lg = M.forward(cfg, params, small, bcs)
                    ms = forward_ms(lambda: M.forward(cfg, params, toks,
                                                      bcs))
                finally:
                    L.product_slots = committed
                rows = []
                for k, s in enumerate(scalar):
                    rows.append((float((s - lg[k]).abs().max()), float(
                        (s.argmax(-1) == lg[k].argmax(-1)).float().mean())))
                print(f"{dtype} {name}: batched forward {ms:.3f} ms (host "
                      f"clock) at "
                      f"{VAL_BATCH} x {VAL_SEQ} tokens x {C.SLOTS} slots; "
                      f"per slot (max |logit diff|, argmax agreement) vs "
                      f"its scalar forward: " + ", ".join(
                          f"({d:.3g}, {a:.4f})" for d, a in rows)
                      + f"; min agreement {min(a for _, a in rows):.4f}; "
                      f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
