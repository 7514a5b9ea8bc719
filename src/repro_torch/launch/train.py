"""Production training launcher (the JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 200 [--smoke] [--ckpt-dir DIR] [--device cuda|cpu]

One process on one card: host 0 of 1 (``torch.distributed`` comes with
the port's distribution slice). The fault-tolerance loop: a
``StepTimeout`` -> wait for the checkpoint being written, reload the
latest atomic checkpoint -> continue (the data pipeline is a pure
function of (seed, step)). ``main(argv)`` runs in-process and returns
``{"history", "trainer", "attempts"}``.
"""
from __future__ import annotations

import argparse

from ..data.pipeline import DataConfig, Prefetcher, ShardedTokenDataset
from ..distributed.fault_tolerance import StepTimeout
from ..models.registry import get_config
from ..optim.optimizer import OptimizerConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--data", default=None,
                    help="token-shard dir or synthetic://<vocab>")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None,
                    help="cosine|wsd|constant (default: per-arch)")
    ap.add_argument("--max-retries", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    # per-arch schedule default: MiniCPM trains with WSD (arXiv:2404.06395)
    schedule = args.schedule or ("wsd" if "minicpm" in args.arch
                                 else "cosine")
    opt_cfg = OptimizerConfig(lr=args.lr, schedule=schedule,
                              warmup_steps=max(10, args.steps // 20),
                              total_steps=args.steps,
                              moment_dtype="bfloat16"
                              if cfg.param_dtype == "bfloat16" else "float32")
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         log_every=max(1, args.steps // 20))
    data_path = args.data or f"synthetic://{cfg.vocab_size}"
    ds = ShardedTokenDataset(
        data_path, DataConfig(seq_len=args.seq_len,
                              global_batch=args.global_batch,
                              shuffle_seed=0),
        host_id=0, num_hosts=1)

    for attempt in range(args.max_retries):
        trainer = Trainer(cfg, opt_cfg, tcfg, seed=0, device=args.device)
        trainer.maybe_restore()
        start = trainer.step
        it = (ds.batch_at(s) for s in range(start, args.steps + 1))
        batches = Prefetcher(iter(it), depth=2, device=args.device)
        try:
            hist = trainer.fit(batches)
            for row in hist:
                print(row, flush=True)
            print(f"[train] done at step {trainer.step}; "
                  f"median step {trainer.monitor.median_step_s * 1e3:.1f}ms; "
                  f"stragglers {len(trainer.monitor.stragglers)}")
            return {"history": hist, "trainer": trainer,
                    "attempts": attempt + 1}
        except StepTimeout as e:   # node hang -> restart from checkpoint
            print(f"[train] {e}; restarting from latest checkpoint "
                  f"(attempt {attempt + 1})", flush=True)
            if trainer.ckpt is not None:
                trainer.ckpt.wait()    # the save in flight lands first
            trainer = None
        finally:
            batches.stop()
    raise SystemExit("exceeded retry budget")


if __name__ == "__main__":
    main()
