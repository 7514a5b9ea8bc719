"""End-to-end pipeline on the PyTorch port: TRAIN a model with the
production trainer (checkpoint + restart safe), COMPRESS it with the
Galen joint agent, QAT-RETRAIN under the found policy, then SERVE it
under sustained batched requests (``examples/train_compress_serve.py``
on ``repro_torch``'s modules).

    PYTHONPATH=src python examples/train_compress_serve_torch.py \
        [--steps 200] [--episodes 30] [--device cuda|cpu]

On one GPU by default (the kernels: K1 fake quant in the QAT forwards
and validations, K2 / K3 in the agent's updates); ``--device cpu`` runs
the same path on the kernels' plain versions. ``--steps 2`` is the
smoke: every stage scales down with the step budget (tiny search, 4 QAT
steps, short decode) but the SAME code paths execute. ``main(argv)``
returns the stages' results.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.compress import CompressibleLM  # noqa: E402
from repro_torch.core.ddpg import DDPGConfig  # noqa: E402
from repro_torch.core.latency import LatencyContext  # noqa: E402
from repro_torch.core.reward import RewardConfig  # noqa: E402
from repro_torch.core.search import CompressionSearch, SearchConfig  # noqa: E402
from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       ShardedTokenDataset, to_device)
from repro_torch.launch.serve import (decode_loop,  # noqa: E402
                                      sustained_throughput)
from repro_torch.optim.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_init, tree_leaves,
                                         tree_unflatten)
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--episodes", type=int, default=None,
                    help="search episodes (default: 30, or 6 in smoke)")
    ap.add_argument("--target", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    # --steps 2 is the smoke: every stage shrinks with the budget
    smoke = args.steps <= 10
    episodes = args.episodes if args.episodes is not None \
        else (6 if smoke else 30)
    qat_steps = 4 if smoke else 60
    serve_steps = 8 if smoke else 24
    dcfg = DDPGConfig(warmup_episodes=2 if smoke else 8,
                      updates_per_episode=2 if smoke else 16,
                      batch_size=16 if smoke else 64)

    cfg = ArchConfig(name="e2e-lm", num_layers=4, d_model=128, num_heads=8,
                     num_kv_heads=4, head_dim=16, d_ff=512, vocab_size=256)

    # ---- 1. TRAIN with the production trainer (ckpt + resume) ----
    ckpt_dir = tempfile.mkdtemp(prefix="galen_e2e_")
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=min(20, args.steps),
                              total_steps=args.steps, weight_decay=0.0)
    tcfg = TrainerConfig(total_steps=args.steps,
                         ckpt_every=max(1, args.steps // 2),
                         log_every=max(1, args.steps // 4),
                         ckpt_dir=ckpt_dir)
    trainer = Trainer(cfg, opt_cfg, tcfg, seed=0, device=dev)
    trainer.maybe_restore()
    ds = ShardedTokenDataset(f"synthetic://{cfg.vocab_size}",
                             DataConfig(seq_len=48, global_batch=16))
    it = (ds.batch_at(s) for s in range(trainer.step, args.steps + 1))
    hist = trainer.fit(it)
    print(f"[1/4] trained {args.steps} steps; loss "
          f"{hist[-1]['loss']:.3f}; checkpoints in {ckpt_dir}")

    # ---- 2. COMPRESS: joint Galen search against the v5e oracle ----
    cm = CompressibleLM(cfg, trainer.params)
    val = to_device(ds.batch_at(10_001), dev)
    ctx = LatencyContext(tokens=1, seq_ctx=512, mode="decode", batch=1)
    scfg = SearchConfig(methods="pq", episodes=episodes,
                        reward=RewardConfig(target_ratio=args.target),
                        ddpg=dcfg)
    search = CompressionSearch(cm, val, scfg, ctx)
    res = search.run(verbose=False)
    best = res.best_under_budget(0.05) or res.best
    print(f"[2/4] search: accuracy {best.accuracy:.3f} "
          f"(clean {res.ref_accuracy:.3f}) at "
          f"{best.latency_s / res.ref_latency_s:.1%} latency")

    # ---- 3. QAT RETRAIN under the found policy (paper: 30 epochs) ----
    # the step updates in place: retrain a copy, the trained model stays
    cspec = cm.build_cspec(best.policy)
    params = tree_unflatten(trainer.params,
                            [p.clone() for p in tree_leaves(trainer.params)])
    opt = adamw_init(params, opt_cfg)
    qat_step = make_train_step(cfg, opt_cfg, cspec=cspec)
    for s in range(qat_steps):
        params, opt, m = qat_step(params, opt,
                                  to_device(ds.batch_at(20_000 + s), dev))
    cm2 = CompressibleLM(cfg, params)
    acc_rt = float(cm2.accuracy(val, cm2.build_cspec(best.policy)))
    print(f"[3/4] QAT retrain: accuracy {best.accuracy:.3f} -> {acc_rt:.3f}")

    # ---- 4. SERVE the compressed model under sustained requests ----
    cspec_final = cm2.build_cspec(best.policy)
    tokens, dt = decode_loop(cfg, params, batch=4, steps=serve_steps,
                             max_len=128, cspec=cspec_final)
    tok_s, times = sustained_throughput(
        cfg, params, batch=4, steps=serve_steps, max_len=128,
        cspec=cspec_final, requests=2 if smoke else 4)
    print(f"[4/4] served 4x{serve_steps} tokens in {dt:.2f}s; sustained "
          f"{tok_s:.1f} tok/s over batched requests "
          f"(per-request {min(times):.3f}-{max(times):.3f}s)")
    print("done.")
    return {"history": hist, "ckpt_dir": ckpt_dir, "best": best,
            "ref_accuracy": res.ref_accuracy, "qat_accuracy": acc_rt,
            "tokens": tokens, "decode_s": dt, "tok_s": tok_s,
            "vocab": cfg.vocab_size, "serve_steps": serve_steps}


if __name__ == "__main__":
    main()
