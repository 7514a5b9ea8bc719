"""Fleet launcher: a population search with preemption-safe epoch
checkpoints (``core.search.FleetSearch``; the JAX package's
``launch/fleet.py``).

A fleet is P member searches, one per seed and/or hardware target, whose
epochs run as one shared replay on one card. Every ``--ckpt-every``
epochs the stacked carry lands in an atomic async checkpoint; a
restarted fleet (``--resume``) restores the newest intact step into its
own tensors and continues from the recorded episode cursor, bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.fleet \\
        --members 4 --episodes 32 --ckpt-dir /tmp/fleet [--device cpu]

``--data 0`` (no mesh) and ``--data 1`` run on one device; the default
sizes the data axis from the cards present, capped at ``--members``, and
a mesh of several cards is refused (a fleet over several cards waits for
a later slice, ROADMAP.md). ``main(argv)`` runs in-process and returns
the result dict that ``--json`` prints, with the ``FleetSearch`` itself
under ``"fleet"``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from ..core.ddpg import DDPGConfig
from ..core.latency import LatencyContext
from ..core.reward import RewardConfig
from ..core.search import FleetSearch, FusedCompressionSearch, SearchConfig
from ..distributed.fault_tolerance import elastic_data_axis

TINY_FLEET_CFG = dict(name="tiny-fleet", num_layers=3, d_model=64,
                      num_heads=4, num_kv_heads=2, head_dim=16, d_ff=256,
                      vocab_size=128, scan_layers=True)
FLEET_CTX = dict(tokens=1, seq_ctx=256, mode="decode", batch=1)


def fleet_data_axis(members: int, model: int = 1) -> int:
    """Data-axis extent for a fleet of ``members`` on this process's
    cards: the largest power of two they support, capped at the member
    count (a data axis wider than P would only shard padding)."""
    data = elastic_data_axis(1, torch.cuda.device_count(), model)
    while data > max(1, members):
        data //= 2
    return data


def fleet_mesh(members: int, data: Optional[int] = None, model: int = 1):
    """Mesh for a fleet: ``data=None`` sizes the data axis by
    ``fleet_data_axis``; ``data=0``, or an extent of one device, means
    no mesh (the fleet's one device). A mesh of several devices is
    refused: the port places a fleet on one card."""
    if data == 0:
        return None
    if data is None:
        data = fleet_data_axis(members, model)
    if data * model == 1:
        return None
    raise ValueError(
        f"a fleet mesh of data={data} x model={model} devices is not "
        f"ported (one card only); pass --data 0")


def tiny_fleet_members(cm, batch, members: int = 4, methods: str = "pq",
                       batch_size: int = 4, epoch_batches: int = 2,
                       updates: int = 2, seed0: int = 0,
                       warmup_episodes: int = 4, sens=None) -> list:
    """P same-method ``FusedCompressionSearch`` members in epoch mode, one
    per seed, on the compressible model ``cm`` and validation ``batch``,
    sharing one sensitivity table (``sens``, or the first member's
    analysis)."""
    ctx = LatencyContext(**FLEET_CTX)
    engines = []
    for p in range(members):
        scfg = SearchConfig(
            methods=methods, episodes=64,
            reward=RewardConfig(target_ratio=0.5),
            ddpg=DDPGConfig(warmup_episodes=warmup_episodes,
                            updates_per_episode=updates,
                            batch_size=16, buffer_size=256),
            seed=seed0 + p)
        m = FusedCompressionSearch(cm, batch, scfg, ctx, sens=sens,
                                   batch_size=batch_size,
                                   epoch_batches=epoch_batches)
        sens = m.sens
        engines.append(m)
    return engines


def tiny_fleet(members: int = 4, data: Optional[int] = None,
               methods: str = "pq", batch_size: int = 4,
               epoch_batches: int = 2, updates: int = 2, seed0: int = 0,
               warmup_episodes: int = 4, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 1, mesh=None,
               device="cuda") -> FleetSearch:
    """P same-method members (one per seed) on the tiny untrained LM
    (seeded weights, the bigram validation batch of seed 3) — the fleet
    the tests drive. Members share the model, validation batch, and ONE
    sensitivity analysis, so their epochs fuse into one replay."""
    from ..configs.base import ArchConfig
    from ..core.compress import CompressibleLM
    from ..data.pipeline import bigram_lm
    from ..models import model as M

    cfg = ArchConfig(**TINY_FLEET_CFG)
    cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=device))
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3, device=device)
    engines = tiny_fleet_members(
        cm, batch, members=members, methods=methods, batch_size=batch_size,
        epoch_batches=epoch_batches, updates=updates, seed0=seed0,
        warmup_episodes=warmup_episodes)
    if mesh is None:
        mesh = fleet_mesh(members, data)
    return FleetSearch(engines, mesh=mesh, fuse_rollouts=True,
                       ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


def _records_json(results) -> list:
    """Per-member [(episode, reward, accuracy, latency_s, sigma), ...] —
    the comparable record surface (policies compare via these)."""
    return [[(r.episode, float(r.reward), float(r.accuracy),
              float(r.latency_s), float(r.sigma)) for r in res.history]
            for res in results]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--data", type=int, default=None,
                    help="mesh data-axis extent; 0 = no mesh (one "
                         "device); default: largest power of two the "
                         "cards support, capped at --members (more than "
                         "one is refused)")
    ap.add_argument("--methods", default="pq")
    ap.add_argument("--episodes", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--epoch-batches", type=int, default=2)
    ap.add_argument("--updates", type=int, default=2)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --ckpt-dir "
                         "before running (resumes from its cursor)")
    ap.add_argument("--stop-after-epochs", type=int, default=0,
                    help="simulate preemption: exit after N epoch "
                         "dispatches (checkpoint cadence still applies)")
    ap.add_argument("--json", action="store_true",
                    help="print a JSON result blob on the last line")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    fleet = tiny_fleet(members=a.members, data=a.data, methods=a.methods,
                       batch_size=a.batch_size,
                       epoch_batches=a.epoch_batches, updates=a.updates,
                       seed0=a.seed0, ckpt_dir=a.ckpt_dir,
                       ckpt_every=a.ckpt_every, device=a.device)
    if a.resume:
        extra = fleet.restore_latest_checkpoint()
        if a.verbose and extra is not None:
            print(f"resumed at episode {fleet.epoch_cursor} "
                  f"(saved on mesh {extra['mesh_shape']})", flush=True)
    episodes = a.episodes
    if a.stop_after_epochs:
        per_epoch = a.batch_size * a.epoch_batches
        episodes = min(episodes, fleet.epoch_cursor
                       + a.stop_after_epochs * per_epoch)
    t0 = time.perf_counter()
    results = fleet.run_fleet(episodes, verbose=a.verbose)
    dt = time.perf_counter() - t0
    ran = sum(len(r.history) for r in results)
    out = {
        "devices": torch.cuda.device_count()
        if torch.device(a.device).type == "cuda" else 1,
        "mesh": dict(fleet.mesh.shape) if fleet.mesh is not None else None,
        "members": a.members,
        "epoch_cursor": fleet.epoch_cursor,
        "epochs_run": fleet.epochs_run,
        "episodes_ran": ran,
        "eps_per_s": round(ran / dt, 3) if dt > 0 else 0.0,
        "monitor": fleet.monitor.summary(),
        "records": _records_json(results),
    }
    if a.json:
        print(json.dumps(out), flush=True)
    elif a.verbose:
        print(f"{ran} episodes in {dt:.2f}s "
              f"({out['eps_per_s']} eps/s aggregate)", flush=True)
    out["fleet"] = fleet            # in-process callers read its state
    return out


if __name__ == "__main__":
    main()
