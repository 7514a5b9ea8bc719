"""The paper's core thesis on the PyTorch port: the SAME model gets
DIFFERENT optimal compression policies on DIFFERENT hardware targets
(``examples/hardware_specific_policies.py`` on ``repro_torch``'s
modules).

Target A: single v5e chip, batch-1 decode (edge-serving analogue).
Target B: 16-chip TP slice of a pod, batch-128 decode_32k (pod serving) —
          KV-cache traffic dominates, so the joint agent should shift
          from weight-int4 toward cache-friendly pruning.

    PYTHONPATH=src python examples/hardware_specific_policies_torch.py \
        [--episodes 30] [--device cuda|cpu]

The model is the LM testbed (``configs/testbed.py::LM_CFG``) trained by
the port's ``train_testbed_lm(LM_CFG, steps=220, batch=16, seq=48)``,
the settings of the JAX package's testbed cache.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.testbed import LM_CFG  # noqa: E402
from repro_torch.core.compress import CompressibleLM  # noqa: E402
from repro_torch.core.ddpg import DDPGConfig  # noqa: E402
from repro_torch.core.latency import LatencyContext  # noqa: E402
from repro_torch.core.reward import RewardConfig  # noqa: E402
from repro_torch.core.search import CompressionSearch, SearchConfig  # noqa: E402
from repro_torch.train.trainer import train_testbed_lm  # noqa: E402


def run_target(name, cm, val, ctx, episodes=30):
    scfg = SearchConfig(methods="pq", episodes=episodes,
                        reward=RewardConfig(target_ratio=0.5),
                        ddpg=DDPGConfig(warmup_episodes=8,
                                        updates_per_episode=16,
                                        batch_size=64))
    search = CompressionSearch(cm, val, scfg, ctx)
    res = search.run(verbose=False)
    best = res.best_under_budget(0.05) or res.best
    bits = [c.w_bits for s, c in zip(search.specs, best.policy.cmps)
            if s.quantizable]
    keeps = [c.keep / s.prune_dim for s, c in
             zip(search.specs, best.policy.cmps) if s.prune_dim]
    print(f"[{name}] acc={best.accuracy:.3f} "
          f"lat={best.latency_s / res.ref_latency_s:.2%} "
          f"mean_w_bits={np.mean(bits):.1f} mean_keep={np.mean(keeps):.2f}")
    return best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    params, val, acc = train_testbed_lm(LM_CFG, steps=220, batch=16, seq=48,
                                        device=args.device)
    print(f"testbed LM trained on {args.device}: accuracy {acc:.3f}")
    cm = CompressibleLM(LM_CFG, params)
    edge = LatencyContext(tokens=1, seq_ctx=512, mode="decode", batch=1)
    pod = LatencyContext(tokens=128, seq_ctx=32_768, mode="decode",
                         batch=128, chips=16, tp=16)
    a = run_target("edge: 1 chip, batch-1 decode", cm, val, edge,
                   args.episodes)
    b = run_target("pod: 16-chip TP, batch-128 decode-32k", cm, val, pod,
                   args.episodes)
    same = sum(ca.mode == cb.mode and ca.keep == cb.keep
               for ca, cb in zip(a.policy.cmps, b.policy.cmps))
    print(f"\npolicies agree on {same}/{len(a.policy.cmps)} layers — "
          "hardware target changes the optimal policy (paper §Introduction)")
    return a, b


if __name__ == "__main__":
    main()
