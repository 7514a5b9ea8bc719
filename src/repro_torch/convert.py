"""Carry weights, optimizer and agent state from the JAX package into the
port, and the port's params and optimizer state back into the JAX
package's layout (``to_jax_*``), so that tests compare trees leaf by leaf.

Inputs are the JAX package's trees with numpy leaves (``jax.device_get``
of its params, AdamW state or ``AgentState``; bf16 leaves as the
``bfloat16`` numpy dtype JAX hands out); nothing here imports JAX. The
``to_jax_*`` functions return numpy leaves, bf16 widened to f32 (exact).
Layouts are kept: weights stay ``[d_in, d_out]`` (a conv's ``[kh, kw,
cin, cout]``), so fake-quant ranges reduce over the same axes on both
sides.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.ddpg import AgentState
from .core.replay import DeviceReplayData


def _leaf_to_torch(x, device) -> torch.Tensor:
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.as_tensor(x, device=device)


def _to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return _leaf_to_torch(tree, device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


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


def to_jax_lm_params(cfg: ArchConfig, params) -> dict:
    """The port's LM params (or a tree of that shape, such as a moment)
    -> numpy in the JAX layout: ``blocks`` stacked on a leading layer
    axis where the JAX model stacks them (``scan_layers`` over
    homogeneous layers), a list of per-layer dicts otherwise."""
    out = {k: _to_numpy(v) for k, v in params.items() if k != "blocks"}
    blocks = [_to_numpy(b) for b in params["blocks"]]
    out["blocks"] = _stack(blocks) if cfg.scan_layers and cfg.homogeneous \
        else blocks
    return out


def to_jax_resnet_params(params) -> dict:
    """The port's ResNet params -> numpy, the same tree."""
    return _to_numpy(params)


def adamw_state(cfg, st, device="cuda") -> dict:
    """A JAX ``adamw_init`` / ``adamw_update`` state (numpy leaves) -> the
    port's: ``m`` and ``v`` in the port's param layout (an LM's stacked
    ``blocks`` split as ``lm_params`` splits them for an ``ArchConfig``;
    the ResNet's tree for a ``ResNetConfig``), moments in their dtype,
    ``step`` a 0-d int32 tensor."""
    def tree(t):
        return lm_params(cfg, t, device) if isinstance(cfg, ArchConfig) \
            else resnet_params(t, device)
    return {"m": tree(st["m"]), "v": tree(st["v"]),
            "step": torch.as_tensor(np.array(st["step"], np.int32),
                                    device=device)}


def to_jax_adamw_state(cfg, state) -> dict:
    """The port's AdamW state -> numpy in the JAX layout (``m``, ``v``
    as ``to_jax_lm_params`` or ``to_jax_resnet_params``, ``step`` an
    int32 scalar)."""
    def tree(t):
        return to_jax_lm_params(cfg, t) if isinstance(cfg, ArchConfig) \
            else to_jax_resnet_params(t)
    return {"m": tree(state["m"]), "v": tree(state["v"]),
            "step": np.int32(state["step"].item())}


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
