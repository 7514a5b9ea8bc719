"""Carry weights and agent state from the JAX package into the port.

Inputs are the JAX package's trees with numpy leaves (``jax.device_get``
of its params or ``AgentState``); nothing here imports JAX. Layouts are
kept: weights stay ``[d_in, d_out]`` (a conv's ``[kh, kw, cin, cout]``),
so fake-quant ranges reduce over the same axes on both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.ddpg import AgentState
from .core.replay import DeviceReplayData


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def lm_params(cfg: ArchConfig, params, device="cuda") -> dict:
    """The JAX LM params -> the port's. Scan-stacked ``params["blocks"]``
    (one leading layer axis on every leaf) become a list of per-layer
    dicts; an unrolled list is taken as it is."""
    out = {k: _to_torch(v, device) for k, v in params.items()
           if k != "blocks"}
    blocks = params["blocks"]
    if isinstance(blocks, dict):
        blocks = [_layer(blocks, i) for i in range(cfg.num_layers)]
    out["blocks"] = [_to_torch(b, device) for b in blocks]
    return out


def resnet_params(params, device="cuda") -> dict:
    """The JAX ResNet params -> the port's: the same tree (``stem``, the
    ``stages`` list of block lists, ``head``), HWIO conv weights kept."""
    return _to_torch(params, device)


def agent_state(st, device="cuda") -> AgentState:
    """A whole JAX ``AgentState`` (numpy leaves) -> the port's: actor,
    critic, both targets, both Adam states (``m``, ``v``, ``t``), the
    running-norm statistics and the reward moving average. A population's
    stacked state (``tree_stack``: a leading member axis on every leaf,
    ``t`` (P,)) gives the port's stacked state (``ddpg.stack_states``'s
    layout). The JAX PRNG key has no counterpart (the port samples from a
    ``torch.Generator``; parity tests feed the JAX replay indices
    instead)."""
    def net(x):
        return [{k: torch.as_tensor(np.array(v, np.float32), device=device)
                 for k, v in layer.items()} for layer in x]

    def opt(o):
        return {"m": net(o["m"]), "v": net(o["v"]),
                "t": torch.as_tensor(np.array(o["t"], np.int32),
                                     device=device)}

    def scalar(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return AgentState(
        actor=net(st.actor), critic=net(st.critic),
        target_actor=net(st.target_actor),
        target_critic=net(st.target_critic),
        opt_a=opt(st.opt_a), opt_c=opt(st.opt_c),
        norm_count=scalar(st.norm_count), norm_mean=scalar(st.norm_mean),
        norm_var=scalar(st.norm_var), reward_ma=scalar(st.reward_ma),
        reward_ma_init=scalar(st.reward_ma_init))


def replay_data(data, device="cuda") -> DeviceReplayData:
    """A JAX ``DeviceReplayData`` ring (numpy leaves) -> the port's: the
    five f32 columns and ``ptr`` / ``size`` as int64, one ring or a
    population's stacked rings ((P, capacity, ·), ``ptr`` / ``size``
    (P,))."""
    f32 = [torch.as_tensor(np.array(x, np.float32), device=device)
           for x in data[:5]]
    i64 = [torch.as_tensor(np.array(x, np.int64), device=device)
           for x in (data.ptr, data.size)]
    return DeviceReplayData(*f32, *i64)
