"""Quickstart for the PyTorch port: the Galen joint pruning+quantization
search on the LM testbed, on one NVIDIA GPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]

The port has no trainer yet, so the testbed LM carries seeded random
weights (its accuracy sits near chance); the search itself — sensitivity
analysis, rollouts against the analytic latency oracle, validation with
the fake-quant kernel, DDPG updates with the fused MLP and Polyak
kernels — is the full path. ``--device cpu`` runs the same search on the
kernels' plain PyTorch versions.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.testbed import (LM_CFG, SERVE_CTX,  # noqa: E402
                                         VAL_BATCH, VAL_SEQ)
from repro_torch.core.compress import CompressibleLM  # noqa: E402
from repro_torch.core.ddpg import DDPGConfig  # noqa: E402
from repro_torch.core.reward import RewardConfig  # noqa: E402
from repro_torch.core.search import CompressionSearch, SearchConfig  # noqa: E402
from repro_torch.data.pipeline import make_bigram_table, sample_bigram  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--episodes", type=int, default=30)
    args = ap.parse_args()
    cfg = LM_CFG
    cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=args.device))
    val = {"tokens": torch.as_tensor(
        sample_bigram(make_bigram_table(cfg.vocab_size, 0), VAL_BATCH,
                      VAL_SEQ, 7), dtype=torch.int64, device=args.device)}
    print(f"testbed LM: {cfg.num_layers}L d={cfg.d_model} on {args.device} "
          f"(seeded random weights)")
    scfg = SearchConfig(
        methods="pq", episodes=args.episodes,
        reward=RewardConfig(target_ratio=0.5, beta=-3.0),
        ddpg=DDPGConfig(warmup_episodes=8, updates_per_episode=16,
                        batch_size=64, buffer_size=2000))
    search = CompressionSearch(cm, val, scfg, SERVE_CTX)
    res = search.run(verbose=True)
    best = res.best_under_budget(0.05) or res.best
    print(f"\nbest policy: accuracy {best.accuracy:.3f} "
          f"(uncompressed {res.ref_accuracy:.3f}), latency "
          f"{best.latency_s / res.ref_latency_s:.2%} of uncompressed, "
          f"MACs {best.macs_frac:.2%}")
    for s, c in zip(search.specs, best.policy.cmps):
        keep = f"keep {c.keep}/{s.prune_dim}" if s.prunable else ""
        print(f"  {s.name:12s} {c.mode:5s} w{c.w_bits:<2d} a{c.a_bits:<2d} "
              f"{keep}")


if __name__ == "__main__":
    main()
