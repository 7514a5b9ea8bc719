"""The testbed trainers (the JAX package's ``train/trainer.py::
train_testbed_lm`` and ``train_testbed_resnet``): short AdamW runs that
give the Galen search a trained model to compress, the LM on the
synthetic bigram language, the ResNet on Gaussian-blob images. Batches
come from the port's numpy generators (``data/pipeline.py``), which
draw the JAX package's tokens and pixels bit for bit from the same
seeds.

Both take the JAX signature plus ``params`` (initial weights: the tests
feed the JAX package's, carried over with ``repro_torch.convert``; the
port's own seeded init otherwise) and ``device``. Given ``params`` are
copied first, so the caller's tensors keep their values. Each returns
(trained params, validation batch, validation accuracy as a float).
"""
from __future__ import annotations

import torch

from ..data.pipeline import blob_images, make_bigram_table, sample_bigram
from ..models import model as M
from ..models import resnet as R
from ..optim.optimizer import (OptimizerConfig, adamw_init, adamw_update,
                               get_schedule, tree_leaves, tree_unflatten)
from .train_step import make_train_step, value_and_grad


def _start(params, init):
    if params is None:
        return init()
    return tree_unflatten(params, [p.clone() for p in tree_leaves(params)])


def _tokens(table, batch: int, seq: int, seed: int, device):
    return {"tokens": torch.as_tensor(sample_bigram(table, batch, seq, seed),
                                      dtype=torch.int64, device=device)}


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
