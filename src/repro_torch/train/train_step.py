"""Train, eval, serve and prefill step functions (the JAX package's
``train/train_step.py``).

``make_train_step(cfg, opt_cfg)`` -> step(params, opt_state, batch, ...)
computing the next-token CE loss, its gradient and the AdamW update;
with a ``cspec`` (``CompressibleLM.build_cspec(policy)``) the forward
runs under the policy's fake quantization and pruning masks, the
straight-through gradient flowing through each quantizer (on the card
K1's straight-through route, ``kernels.ops.fake_quant_ste``): the
paper's quantization-aware retraining.

A batch is ``{"tokens"}`` for a decoder, plus ``"embeds"`` for a
frontend (a VLM's patch embeddings over its first positions, an audio
encoder's frame embeddings in place of tokens) and ``"labels"`` for an
encoder (per-frame classes).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..models import model as M
from ..optim.grad_compression import GradCompressionConfig, compress_grads
from ..optim.optimizer import (OptimizerConfig, adamw_update, get_schedule,
                               tree_leaves, tree_unflatten)


def _sharded_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE, ``logsumexp(logits) - logits[label]``. The JAX
    function takes the label's logit as a sum against a one-hot (which
    stays local to a vocab-sharded TPU layout); here a gather takes it.
    That is exact: the one-hot sum adds zeros to one product by 1.0. It
    also spares a [B, S, vocab] f32 one-hot (2.5 GB at qwen2-0.5b's
    vocab of 151,936 and 8 x 511 positions)."""
    lse = torch.logsumexp(logits, -1)
    return lse - torch.gather(logits, -1, labels[..., None])[..., 0]


def lm_loss(cfg: ArchConfig, params, batch: dict, cspec=None
            ) -> torch.Tensor:
    """Next-token CE of a decoder LM, averaged over every position that
    has a next token; a VLM's only over the positions from the last
    patch on (``pos >= frontend_len - 1``: the text the patches
    condition), summed over the batch and divided by the mask's sum,
    which, the mask being [1, S - 1] as in the JAX package, counts one
    row's positions; an encoder's per-frame CE against
    ``batch["labels"]``."""
    tokens = batch.get("tokens")
    logits = M.forward(cfg, params, tokens, cspec=cspec,
                       embeds=batch.get("embeds"))
    if cfg.is_encoder:
        return torch.mean(_sharded_ce(logits, batch["labels"]))
    nll = _sharded_ce(logits[:, :-1], tokens[:, 1:])
    if cfg.frontend == "vision_stub" and cfg.frontend_len > 0:
        pos = torch.arange(nll.shape[1], device=nll.device)[None]
        mask = (pos >= cfg.frontend_len - 1).to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def value_and_grad(loss_fn, params):
    """(loss, grads) of ``loss_fn(params)``, grads a tree like
    ``params`` (the counterpart of ``jax.value_and_grad``). The gradient
    comes from ``torch.autograd.grad`` over detached copies of the float
    leaves (views of the same memory), so the caller's tensors never
    require grad; a leaf the loss does not reach gets zeros."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(p.is_floating_point())
              for p in leaves]
        loss = loss_fn(tree_unflatten(params, xs))
        wrt = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for x in xs:
        g = next(got) if x.requires_grad else None
        grads.append(torch.zeros_like(x) if g is None else g)
    return loss.detach(), tree_unflatten(params, grads)


def _stacks_layers(cfg: ArchConfig) -> bool:
    """Whether the JAX model keeps the layers' params stacked on a leading
    axis (it scans homogeneous layers); the port always keeps one dict
    per layer. The JAX rules that work per leaf (weight decay by
    ``ndim``, one int8 scale or top-k threshold a leaf) see that
    layout."""
    return cfg.scan_layers and cfg.homogeneous


def stack_layers(cfg: ArchConfig, tree):
    """A tree in the port's LM layout -> the JAX layout: ``blocks`` one
    dict of leaves stacked over the layers (a copy) where the JAX model
    stacks them; the tree itself otherwise."""
    if not _stacks_layers(cfg):
        return tree
    blocks = tree["blocks"]
    stacked = [torch.stack(xs) for xs in zip(*map(tree_leaves, blocks))]
    return {**tree, "blocks": tree_unflatten(blocks[0], stacked)}


def unstack_layers(cfg: ArchConfig, tree):
    """The inverse of ``stack_layers``: per-layer views of the stacked
    leaves."""
    if not _stacks_layers(cfg):
        return tree
    leaves = tree_leaves(tree["blocks"])
    return {**tree, "blocks": [
        tree_unflatten(tree["blocks"], [x[i] for x in leaves])
        for i in range(cfg.num_layers)]}


def weight_decay_mask(cfg: ArchConfig, params):
    """Which leaves of the port's LM params take AdamW's weight decay: the
    JAX rule, ``ndim >= 2``, on the JAX layout. Where the JAX model
    stacks its layers every block leaf carries a leading layer axis, so
    its norm scales and biases are decayed too; here those leaves count
    one dimension more."""
    extra = int(_stacks_layers(cfg))
    out = {k: tree_unflatten(v, [p.dim() >= 2 for p in tree_leaves(v)])
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = tree_unflatten(params["blocks"], [
        p.dim() + extra >= 2 for p in tree_leaves(params["blocks"])])
    return {k: out[k] for k in params}


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig,
                    gc_cfg: Optional[GradCompressionConfig] = None,
                    cspec=None):
    """Returns step(params, opt_state, batch [, gc_residual]) ->
    (params, opt_state, metrics [, residual]); metrics ``{"loss",
    "grad_norm", "lr"}`` as 0-d tensors on the device (nothing is read
    back to the host). The params and moments are updated in place
    (``optim.optimizer.adamw_update``). ``gc_residual`` (from
    ``init_residual(params)``, the port's layout) is compressed with the
    gradients in the JAX layout (``stack_layers``), as the JAX step
    compresses its stacked leaves."""
    sched = get_schedule(opt_cfg)
    gc_cfg = gc_cfg or GradCompressionConfig()

    def step(params, opt_state, batch, gc_residual=None):
        loss, grads = value_and_grad(
            lambda p: lm_loss(cfg, p, batch, cspec), params)
        if gc_cfg.kind != "none" and gc_residual is not None:
            grads, gc_residual = (unstack_layers(cfg, t) for t in (
                compress_grads(stack_layers(cfg, grads),
                               stack_layers(cfg, gc_residual), gc_cfg)))
        params, opt_state, om = adamw_update(
            params, grads, opt_state, opt_cfg, sched,
            weight_decay_mask(cfg, params))
        metrics = {"loss": loss, **om}
        if gc_residual is not None:
            return params, opt_state, metrics, gc_residual
        return params, opt_state, metrics

    return step


def make_eval_step(cfg: ArchConfig, cspec=None):
    """step(params, batch) -> the CE loss, with no autograd graph."""

    def step(params, batch):
        with torch.no_grad():
            return lm_loss(cfg, params, batch, cspec)

    return step


def make_serve_step(cfg: ArchConfig, cspec=None):
    """One decode step: (params, cache, tokens [B,1], pos) ->
    (logits [B,1,V], cache)."""

    def step(params, cache, tokens, pos: int):
        return M.decode_step(cfg, params, cache, tokens, pos, cspec=cspec)

    return step


def make_prefill_step(cfg: ArchConfig, cspec=None):
    """One prefill forward: (params, tokens [B,S], embeds=None) -> logits
    [B,S,V] (f32), with no autograd graph; ``embeds`` a frontend's, as
    ``models.model.forward`` takes them (an audio encoder's in place of
    tokens, which are then ``None``)."""

    def step(params, tokens, embeds=None):
        with torch.no_grad():
            return M.forward(cfg, params, tokens, cspec=cspec,
                             embeds=embeds)

    return step
