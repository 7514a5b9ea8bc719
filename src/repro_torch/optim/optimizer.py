"""AdamW and its learning-rate schedules (the JAX package's
``optim/optimizer.py``).

The schedules compute in f32 tensors, as jnp does: the step is an int32
tensor, ``step / warmup`` a true division in f32, the config's floats
enter as f32 operands. ``adamw_update`` follows the JAX expression op
for op (clip scale, f32 moments, f32 bias corrections, decoupled weight
decay on matrices only, the cast back to each leaf's dtype), each op one
``torch._foreach_*`` call over all the leaves. It is not
``torch.optim.AdamW``: that computes ``p·(1 − lr·wd)`` and
``sqrt(v)/sqrt(c2) + eps``, another rounding of the same formula.

Trees are nested dicts and lists of tensors (the port's param layout);
the optimizer state mirrors the param tree, with ``step`` a 0-d int32
tensor on the params' device. ``adamw_update`` writes the new params
and moments into their tensors in place, under ``no_grad``: at
qwen2-0.5b's 494 M parameters a functional update would copy the whole
model every step. It returns the same trees, so callers rebind as with
the JAX function.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"           # cosine|wsd|constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1            # WSD: fraction of steps in decay
    moment_dtype: str = "float32"      # bfloat16 for >=100B archs


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts (keys in sorted order, as JAX
    flattens a dict) and lists, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree shaped like ``like`` holding ``leaves`` in
    ``tree_leaves``' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(like)


def _f32(x: float, step: torch.Tensor) -> torch.Tensor:
    # a fill on the device: ``torch.tensor(x, device=...)`` would copy from
    # pageable host memory, which waits for the stream
    return torch.full((), x, dtype=torch.float32, device=step.device)


def _warm(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(step.float() / _f32(max(cfg.warmup_steps, 1),
                                               step), 1.0)


def cosine_schedule(cfg: OptimizerConfig) -> Callable:
    def f(step):
        warm = _warm(cfg, step)
        t = torch.clamp((step - cfg.warmup_steps).float()
                        / _f32(max(1, cfg.total_steps - cfg.warmup_steps),
                               step), 0.0, 1.0)
        return _f32(cfg.lr, step) * warm * 0.5 \
            * (1 + torch.cos(_f32(math.pi, step) * t))
    return f


def wsd_schedule(cfg: OptimizerConfig) -> Callable:
    """Warmup-Stable-Decay: linear warmup, flat plateau, sharp decay tail."""
    decay_start = int(cfg.total_steps * (1.0 - cfg.decay_frac))

    def f(step):
        warm = _warm(cfg, step)
        t = torch.clamp((step - decay_start).float()
                        / _f32(max(1, cfg.total_steps - decay_start), step),
                        0.0, 1.0)
        decay = torch.where(step > decay_start,
                            1.0 - t * _f32(1.0 - 0.1, step),
                            _f32(1.0, step))
        return _f32(cfg.lr, step) * warm * decay
    return f


def get_schedule(cfg: OptimizerConfig) -> Callable:
    """step (0-d int32 tensor) -> learning rate (0-d f32 tensor)."""
    return {"cosine": cosine_schedule, "wsd": wsd_schedule,
            "constant": lambda c: (lambda s: _f32(c.lr, s))
            }[cfg.schedule](cfg)


def adamw_init(params, cfg: OptimizerConfig) -> dict:
    """``{"m", "v"}`` zero trees in the moment dtype beside a 0-d int32
    ``step`` on the params' device."""
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" \
        else torch.float32
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [torch.zeros(p.shape, dtype=mdt,
                                                   device=p.device)
                                       for p in leaves])
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every leaf, in f32: each leaf's norm in one
    ``_foreach_norm`` call, then the root of their squares' sum (the JAX
    function sums the leaves' sums of squares; the two round apart by a
    few ulps)."""
    norms = torch._foreach_norm([x.float() for x in tree_leaves(tree)])
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptimizerConfig,
                 schedule: Optional[Callable] = None, decay=None):
    """One AdamW step: returns (params, state, metrics ``{"grad_norm",
    "lr"}``). The params and both moments are updated in place (module
    docstring); ``state["step"]`` is replaced by the incremented count.
    ``decay``: a tree of bools like ``params``, the leaves that take the
    decoupled weight decay; by default those with ``ndim >= 2``, the
    JAX rule on the JAX layout (``train_step.weight_decay_mask`` gives
    an LM's, whose layers the JAX model stacks)."""
    sched = schedule or get_schedule(cfg)
    step = state["step"] + 1
    lr = sched(step)
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` is reciprocal-then-multiply
    scale = torch.clamp_max(_f32(cfg.grad_clip, step) / (gnorm + 1e-9),
                            1.0) if cfg.grad_clip > 0 else None
    b1, b2 = cfg.betas
    c1 = 1.0 - _f32(b1, step) ** step.float()
    c2 = 1.0 - _f32(b2, step) ** step.float()
    ps, ms, vs = (tree_leaves(t) for t in (params, state["m"], state["v"]))
    decays = [p.dim() >= 2 for p in ps] if decay is None \
        else tree_leaves(decay)
    f32 = [x.float() for x in tree_leaves(grads)]
    g = f32 if scale is None else torch._foreach_mul(f32, scale)
    m32 = torch._foreach_add(torch._foreach_mul([m.float() for m in ms], b1),
                             torch._foreach_mul(g, 1 - b1))
    v32 = torch._foreach_add(torch._foreach_mul([v.float() for v in vs], b2),
                             torch._foreach_mul(torch._foreach_mul(g, 1 - b2),
                                                g))
    upd = torch._foreach_div(
        torch._foreach_div(m32, c1),
        torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v32, c2)),
                           cfg.eps))
    p32 = [p.float() for p in ps]
    dec = [i for i, d in enumerate(decays) if d]
    if dec:  # decoupled weight decay
        wd = torch._foreach_mul([p32[i] for i in dec], cfg.weight_decay)
        torch._foreach_add_([upd[i] for i in dec], wd)
    new_p = torch._foreach_sub(p32, torch._foreach_mul(upd, lr))
    for dst, src in ((ps, new_p), (ms, m32), (vs, v32)):
        torch._foreach_copy_(dst, src)
    return (params, {"m": state["m"], "v": state["v"], "step": step},
            {"grad_norm": gnorm, "lr": lr})
