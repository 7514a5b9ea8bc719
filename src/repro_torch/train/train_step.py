"""Serve and prefill step functions (the JAX package's
``train/train_step.py::make_serve_step`` and ``make_prefill_step``). The
training steps wait for the training slice."""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models import model as M


def make_serve_step(cfg: ArchConfig, cspec=None):
    """One decode step: (params, cache, tokens [B,1], pos) ->
    (logits [B,1,V], cache)."""

    def step(params, cache, tokens, pos: int):
        return M.decode_step(cfg, params, cache, tokens, pos, cspec=cspec)

    return step


def make_prefill_step(cfg: ArchConfig, cspec=None):
    """One prefill forward: (params, tokens [B,S]) -> logits [B,S,V]
    (f32), with no autograd graph."""

    def step(params, tokens):
        with torch.no_grad():
            return M.forward(cfg, params, tokens, cspec=cspec)

    return step
