"""Fault tolerance & straggler mitigation (the JAX package's
``distributed/fault_tolerance.py``, which imports nothing of JAX, copied
so the port needs nothing of that package).

* ``StepMonitor`` — per-step wall-time tracking; flags stragglers when a
  step exceeds ``straggler_factor`` × the trailing median; raises
  ``StepTimeout`` on hard hangs so the launcher can checkpoint-restart.
* ``HealthLedger`` — host heartbeat bookkeeping; decides when to trigger an
  elastic re-mesh (drop failed hosts, shrink the data axis) and computes
  the replacement mesh shape.
* ``elastic_data_axis`` — largest data-parallel axis that the surviving
  host count supports (model axis is never shrunk — TP degree is a model
  property; data/pod axes absorb failures).

The launcher (``launch/train.py``) wraps ``Trainer.fit`` in a retry loop:
on ``StepTimeout`` it reloads the latest atomic checkpoint (written by
``checkpoint/checkpointing.py``) and continues; the data pipeline being a
pure function of (seed, step) makes the resume reproduce the stream.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class StepTimeout(RuntimeError):
    pass


@dataclass
class FaultToleranceConfig:
    straggler_factor: float = 2.0      # step > factor*median => straggler
    straggler_window: int = 50
    hard_timeout_s: float = 0.0        # 0 = disabled
    heartbeat_timeout_s: float = 60.0


class StepMonitor:
    def __init__(self, cfg: FaultToleranceConfig):
        self.cfg = cfg
        self.times: collections.deque = collections.deque(
            maxlen=cfg.straggler_window)
        self.stragglers: List[int] = []
        self.total_recorded = 0

    def record(self, step: int, dt: float):
        self.total_recorded += 1
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.cfg.straggler_factor * med:
                self.stragglers.append(step)
            if self.cfg.hard_timeout_s and dt > self.cfg.hard_timeout_s:
                raise StepTimeout(f"step {step} took {dt:.1f}s")
        self.times.append(dt)

    @property
    def median_step_s(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]

    def summary(self) -> dict:
        """JSON-able digest for fleet logs/manifests: epochs recorded, the
        trailing median, and which epochs were flagged as stragglers."""
        return {"recorded": self.total_recorded,
                "median_step_s": self.median_step_s,
                "stragglers": list(self.stragglers)}


class HealthLedger:
    """Track host heartbeats; propose elastic re-mesh on failure."""

    def __init__(self, num_hosts: int, cfg: FaultToleranceConfig):
        self.cfg = cfg
        self.last_seen: Dict[int, float] = {h: time.time()
                                            for h in range(num_hosts)}
        self.excluded: set = set()

    def heartbeat(self, host: int, now: Optional[float] = None):
        self.last_seen[host] = now if now is not None else time.time()

    def failed_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [h for h, t in self.last_seen.items()
                if h not in self.excluded
                and now - t > self.cfg.heartbeat_timeout_s]

    def exclude(self, hosts) -> None:
        self.excluded.update(hosts)

    @property
    def healthy(self) -> List[int]:
        return [h for h in self.last_seen if h not in self.excluded]


def elastic_data_axis(healthy_hosts: int, chips_per_host: int,
                      model_axis: int) -> int:
    """Largest power-of-two data axis the surviving chips support."""
    chips = healthy_hosts * chips_per_host
    data = max(1, chips // model_axis)
    p = 1
    while p * 2 <= data:
        p *= 2
    return p
