"""The training loop with checkpoint/restart and straggler detection
(the JAX package's ``train/trainer.py::Trainer``), the loop behind
``repro_torch.launch.train``; and the testbed trainers
(``train_testbed_lm`` and ``train_testbed_resnet``): short AdamW runs
that give the Galen search a trained model to compress, the LM on the
synthetic bigram language, the ResNet on Gaussian-blob images. Batches
come from the port's numpy generators (``data/pipeline.py``), which
draw the JAX package's tokens and pixels bit for bit from the same
seeds.

Each takes the JAX signature plus ``params`` (initial weights: the tests
feed the JAX package's, carried over with ``repro_torch.convert``; the
port's own seeded init otherwise) and ``device``. Given ``params`` are
copied first, so the caller's tensors keep their values (the train step
updates in place). The testbed trainers return (trained params,
validation batch, validation accuracy as a float).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..checkpoint import checkpointing as ckpt
from ..configs.base import ArchConfig
from ..data.pipeline import (blob_images, make_bigram_table, sample_bigram,
                             to_device)
from ..distributed.fault_tolerance import FaultToleranceConfig, StepMonitor
from ..models import model as M
from ..models import resnet as R
from ..optim.optimizer import (OptimizerConfig, adamw_init, adamw_update,
                               get_schedule, tree_leaves, tree_unflatten)
from .train_step import (_stacks_layers, make_train_step, stack_layers,
                         unstack_layers, value_and_grad)


def _start(params, init):
    if params is None:
        return init()
    return tree_unflatten(params, [p.clone() for p in tree_leaves(params)])


def _tokens(table, batch: int, seq: int, seed: int, device):
    return {"tokens": torch.as_tensor(sample_bigram(table, batch, seq, seed),
                                      dtype=torch.int64, device=device)}


@dataclass
class TrainerConfig:
    total_steps: int = 1000
    log_every: int = 50
    ckpt_every: int = 200
    ckpt_dir: Optional[str] = None
    ft: FaultToleranceConfig = field(default_factory=FaultToleranceConfig)


class Trainer:
    """AdamW training of an LM through ``make_train_step`` (QAT under
    ``cspec``), with an ``AsyncCheckpointer`` when ``tcfg.ckpt_dir`` is
    set. The saved tree is ``{"params", "opt"}`` in the JAX layout
    (``train_step.stack_layers``: the layers stacked where the JAX model
    scans them, dtypes kept; AdamW's ``{"m", "v", "step"}``), so either
    package restores the other's checkpoints."""

    def __init__(self, cfg: ArchConfig, opt_cfg: OptimizerConfig,
                 tcfg: TrainerConfig, params=None, seed: int = 0,
                 cspec=None, device="cuda"):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.device = torch.device(device)
        self.params = _start(params, lambda: M.init(cfg, seed, device))
        self.opt_state = adamw_init(self.params, opt_cfg)
        self.step_fn = make_train_step(cfg, opt_cfg, cspec=cspec)
        self.step = 0
        self.monitor = StepMonitor(tcfg.ft)
        self.ckpt = (ckpt.AsyncCheckpointer(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)

    def _tree(self) -> dict:
        st = self.opt_state
        return {"params": stack_layers(self.cfg, self.params),
                "opt": {"m": stack_layers(self.cfg, st["m"]),
                        "v": stack_layers(self.cfg, st["v"]),
                        "step": st["step"]}}

    def _like(self) -> dict:
        """The saved tree's structure without its copies: where the JAX
        layout stacks the layers, one layer's dict stands for the
        stack."""
        def layout(t):
            return {**t, "blocks": t["blocks"][0]} \
                if _stacks_layers(self.cfg) else t
        return {"params": layout(self.params),
                "opt": {"m": layout(self.opt_state["m"]),
                        "v": layout(self.opt_state["v"]),
                        "step": self.opt_state["step"]}}

    def _save(self) -> None:
        self.ckpt.save(self.step, self._tree(),
                       extra={"data_step": self.step})

    def maybe_restore(self):
        if self.ckpt is None:
            return
        restored, step, extra = ckpt.restore_latest(
            self.tcfg.ckpt_dir, self._like(), self.device)
        if restored is not None:
            opt = restored["opt"]
            self.params = unstack_layers(self.cfg, restored["params"])
            self.opt_state = {"m": unstack_layers(self.cfg, opt["m"]),
                              "v": unstack_layers(self.cfg, opt["v"]),
                              "step": opt["step"]}
            self.step = step
            print(f"[trainer] resumed from step {step}")

    def fit(self, data_iter, eval_fn: Optional[Callable] = None):
        """Steps over ``data_iter``'s batches (numpy or tensors) up to
        ``total_steps``: the host time of each step goes to the monitor
        (which may raise ``StepTimeout``), the loss is read back only on
        ``log_every`` steps, and a checkpoint lands every ``ckpt_every``
        steps and at the end (once, where the last step just landed).
        Returns the logged rows."""
        history = []
        saved = None
        for batch in data_iter:
            if self.step >= self.tcfg.total_steps:
                break
            t0 = time.perf_counter()
            batch = to_device(batch, self.device) if any(
                not isinstance(v, torch.Tensor) for v in batch.values()) \
                else batch
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            dt = time.perf_counter() - t0
            self.monitor.record(self.step, dt)
            if self.step % self.tcfg.log_every == 0:
                loss = float(metrics["loss"])
                row = {"step": self.step, "loss": loss, "dt": dt}
                if eval_fn is not None:
                    row["eval"] = float(eval_fn(self.params))
                history.append(row)
            if self.ckpt and self.step % self.tcfg.ckpt_every == 0:
                self._save()
                saved = self.step
        if self.ckpt:
            if saved != self.step:
                self._save()
            self.ckpt.wait()
        return history


# ---------------------------------------------------------------------------
# Testbed trainers — the trained models the Galen search compresses.
# ---------------------------------------------------------------------------

def train_testbed_lm(cfg, steps: int = 300, batch: int = 32, seq: int = 64,
                     seed: int = 0, lr: float = 3e-3, params=None,
                     device="cuda"):
    """AdamW (cosine, warmup 20, no weight decay) on bigram batches drawn
    with seeds ``seed * 10,000 + s``; validation: 64 sequences, seed
    ``seed * 10,000 + steps + 7``, next-token top-1 accuracy."""
    params = _start(params, lambda: M.init(cfg, seed, device))
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=20, total_steps=steps,
                              weight_decay=0.0)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    table = make_bigram_table(cfg.vocab_size, seed)
    for s in range(steps):
        params, opt_state, _ = step_fn(
            params, opt_state,
            _tokens(table, batch, seq, seed * 10_000 + s, device))
    val = _tokens(table, 64, seq, seed * 10_000 + steps + 7, device)
    with torch.no_grad():
        logits = M.forward(cfg, params, val["tokens"])
    acc = torch.mean((torch.argmax(logits[:, :-1], -1)
                      == val["tokens"][:, 1:]).float())
    return params, val, float(acc)


def resnet_loss(rcfg, params, batch: dict) -> torch.Tensor:
    """Mean CE of the ResNet's logits against the labels."""
    lp = torch.log_softmax(R.forward(rcfg, params, batch["images"]), -1)
    return -torch.mean(torch.gather(lp, -1, batch["labels"][:, None]))


def train_testbed_resnet(rcfg, steps: int = 250, batch: int = 64,
                         seed: int = 0, lr: float = 1e-2, params=None,
                         device="cuda"):
    """AdamW (cosine, warmup 10, weight decay 1e-4) on blob batches drawn
    with seeds ``seed * 10,000 + s``; validation: 256 images, seed
    ``seed * 10,000 + steps + 7``, top-1 accuracy."""
    params = _start(params, lambda: R.init(rcfg, seed, device))
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=10, total_steps=steps,
                              weight_decay=1e-4)
    opt_state = adamw_init(params, opt_cfg)
    sched = get_schedule(opt_cfg)
    for s in range(steps):
        b = blob_images(rcfg.num_classes, batch, rcfg.img_size,
                        seed=seed * 10_000 + s, device=device)
        _, grads = value_and_grad(lambda p: resnet_loss(rcfg, p, b), params)
        params, opt_state, _ = adamw_update(params, grads, opt_state,
                                            opt_cfg, sched)
    val = blob_images(rcfg.num_classes, 256, rcfg.img_size,
                      seed=seed * 10_000 + steps + 7, device=device)
    with torch.no_grad():
        logits = R.forward(rcfg, params, val["images"])
    acc = torch.mean((torch.argmax(logits, -1) == val["labels"]).float())
    return params, val, float(acc)
