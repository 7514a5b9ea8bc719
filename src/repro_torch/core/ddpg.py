"""DDPG (Lillicrap et al. 2015) in PyTorch — the paper's agent core.

Paper hyperparameters: actor/critic MLPs with hidden (400, 300); sigmoid-
bounded actions in [0,1]; Adam lr 1e-4 (actor) / 1e-3 (critic),
β1=0.9 β2=0.999; γ=0.99; batch 128; replay 2000; exploration via truncated
normal σ0=0.5, decay 0.95/episode; rewards in each sampled batch normalized
with a moving average; states standardized with running mean/var estimates.

Layout follows the JAX package: all learnable/learning state lives in an
``AgentState`` (networks as lists of ``{"w", "b"}`` layers, ``[in, out]``
weights, Adam step counts as 0-d device ints), manipulated by plain
functions (``update_step``, ``update_chunk``, ``agent_act_batch``,
``observe_states_pure``); ``DDPGAgent`` is the stateful shim the search
calls. The shim's tensors are never reallocated: a chunk's result and
the host's running-norm statistics are copied into them
(``adopt_state``, ``state_for_dispatch``), so a CUDA graph captured over
them (the fused engine's) stays valid from replay to replay.

Kernels: the actor/critic trunk runs through K2
(``kernels.ops.fused_mlp3``, whose backward is plain tensor ops) and the
soft target update of both networks through one K3 launch
(``kernels.ops.fused_polyak_nets``). The scalar and batched engines act
in host numpy with ``np.random.default_rng(seed)``, as in the JAX
package, so exploration draws match it bit for bit; the fused engine
acts on the device (``agent_act_batch``, K2) with its draws fed in, a
population's shared rollout through K2's member form.

Populations: ``stack_states`` / ``index_state`` stack P agent states (or
replay rings) along a leading member axis and give each member views of
the stack. ``population_update_chunk`` advances the stacked states in
place: the megabatched step (``_mega_update_step``: every product
batched over the members with ``torch.bmm``, a hand-written backward,
Adam and the soft target update as one fused kernel launch per network,
``kernels.adam_polyak``) for the paper's trunk, P solo ``update_chunk``s
(``population_update_chunk_vmap``, its parity reference) otherwise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.adam_polyak import adam_polyak_
from .replay import device_replay_sample


@dataclass(frozen=True)
class DDPGConfig:
    state_dim: int = 16
    action_dim: int = 1
    hidden: Tuple[int, int] = (400, 300)
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01                  # soft target update
    batch_size: int = 128
    buffer_size: int = 2000
    sigma0: float = 0.5
    sigma_decay: float = 0.95
    warmup_episodes: int = 10
    updates_per_episode: int = 32
    reward_ma_decay: float = 0.95      # moving-average reward normalizer


def _mlp_init(gen: torch.Generator, dims, device, final_scale=3e-3):
    params = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        lim = final_scale if i == len(dims) - 2 else 1.0 / math.sqrt(a)
        w = torch.rand((a, b), generator=gen, device=device) * (2 * lim) - lim
        params.append({"w": w, "b": torch.zeros((b,), device=device)})
    return params


def _mlp(params, x: torch.Tensor, final: Optional[str] = None):
    """The paper's 3-layer trunk on a 2-D batch through K2, on a
    population's [P, B, D0] block through K2's member form (the plain
    versions on a CPU tensor)."""
    if len(params) != 3:
        raise ValueError(f"the DDPG trunk has 3 layers, got {len(params)}")
    fn = ops.fused_mlp3_members if x.dim() == 3 else ops.fused_mlp3
    return fn(params, x, final="sigmoid" if final else "linear")


def actor_forward(params, state):
    return _mlp(params, state, "sigmoid")   # actions in [0, 1]


def _actor_forward_np(params, x: np.ndarray) -> np.ndarray:
    """Host-side actor forward for acting (one state per call)."""
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = np.maximum(x, 0.0)
    return 1.0 / (1.0 + np.exp(-x))


def critic_forward(params, state, action):
    x = torch.cat([state, action], dim=-1)
    return _mlp(params, x)[..., 0]


# --- minimal Adam ---

def adam_init(params):
    device = params[0]["w"].device
    return {"m": [{k: torch.zeros_like(v) for k, v in l.items()}
                  for l in params],
            "v": [{k: torch.zeros_like(v) for k, v in l.items()}
                  for l in params],
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def adam_step(params, grads, st, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The step count ``t`` is a 0-d device int, so the bias corrections
    ``1 - b^t`` are f32 device values, as in the JAX package's traced
    scan (and a captured graph bakes in no step)."""
    t = st["t"] + 1
    tf = t.float()
    c1 = 1 - torch.pow(b1, tf)
    c2 = 1 - torch.pow(b2, tf)
    new_p, new_m, new_v = [], [], []
    for p_l, g_l, m_l, v_l in zip(params, grads, st["m"], st["v"]):
        p2, m2, v2 = {}, {}, {}
        for k in p_l:
            g = g_l[k]
            m = b1 * m_l[k] + (1 - b1) * g
            v = b2 * v_l[k] + (1 - b2) * g * g
            mh = m / c1
            vh = v / c2
            p2[k] = p_l[k] - lr * mh / (torch.sqrt(vh) + eps)
            m2[k], v2[k] = m, v
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    return new_p, {"m": new_m, "v": new_v, "t": t}


def polyak_update_targets(targets, onlines, tau: float):
    """Soft-target update ``(1 - tau) * target + tau * online`` of the
    target networks (a sequence, here the actor's and the critic's) as
    one pass over all their leaves: one K3 launch on the card, its plain
    version on the CPU (the same arithmetic as the JAX package's per-leaf
    tree map). Returns the new target networks in order."""
    return ops.fused_polyak_nets(targets, onlines, tau)


@dataclass
class RunningNorm:
    """Standardize states with running mean/var (paper §Proposed Agents)."""
    dim: int
    count: float = 1e-4
    mean: np.ndarray = None
    var: np.ndarray = None

    def __post_init__(self):
        if self.mean is None:
            self.mean = np.zeros(self.dim, np.float32)
        if self.var is None:
            self.var = np.ones(self.dim, np.float32)

    def update(self, x: np.ndarray):
        x = np.atleast_2d(x)
        bc, bm, bv = x.shape[0], x.mean(0), x.var(0)
        delta = bm - self.mean
        tot = self.count + bc
        self.mean = self.mean + delta * bc / tot
        m_a = self.var * self.count
        m_b = bv * bc
        self.var = (m_a + m_b + delta ** 2 * self.count * bc / tot) / tot
        self.count = tot

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / np.sqrt(self.var + 1e-8)


# ===========================================================================
# Functional core
# ===========================================================================

class AgentState(NamedTuple):
    """Everything one DDPG agent learns or consumes while learning: the
    networks, moments, Adam step counts (``opt_*["t"]``, 0-d int32) and
    statistics, all tensors on the agent's device. The replay sampling
    stream is a ``torch.Generator`` held by ``DDPGAgent``."""
    actor: list
    critic: list
    target_actor: list
    target_critic: list
    opt_a: dict
    opt_c: dict
    norm_count: torch.Tensor    # () f32   running-norm sample count
    norm_mean: torch.Tensor     # (state_dim,) f32
    norm_var: torch.Tensor      # (state_dim,) f32
    reward_ma: torch.Tensor     # () f32   moving-average reward
    reward_ma_init: torch.Tensor  # () f32  0 = uninitialized


def agent_init(cfg: DDPGConfig, gen: torch.Generator, device) -> AgentState:
    dims_a = (cfg.state_dim,) + cfg.hidden + (cfg.action_dim,)
    dims_c = (cfg.state_dim + cfg.action_dim,) + cfg.hidden + (1,)
    actor = _mlp_init(gen, dims_a, device)
    critic = _mlp_init(gen, dims_c, device)
    clone = lambda net: [{k: v.clone() for k, v in l.items()} for l in net]
    f32 = dict(dtype=torch.float32, device=device)
    return AgentState(
        actor=actor, critic=critic,
        target_actor=clone(actor), target_critic=clone(critic),
        opt_a=adam_init(actor), opt_c=adam_init(critic),
        norm_count=torch.tensor(1e-4, **f32),
        norm_mean=torch.zeros((cfg.state_dim,), **f32),
        norm_var=torch.ones((cfg.state_dim,), **f32),
        reward_ma=torch.zeros((), **f32),
        reward_ma_init=torch.zeros((), **f32))


def agent_act_batch(cfg: DDPGConfig, st: AgentState, states, sigmas,
                    warmup, uniforms, normals):
    """Batched acting on the device, the draws fed in: K states -> K
    actions. Warmup rows take ``uniforms`` [K, A]; live rows run the
    standardized actor (K2) with truncated-normal exploration over the
    16 candidates ``mu + sigma * normals`` ([K, 16, A]): the first
    in-bounds candidate wins, else ``clip(cand[0], 0, 1)``, and sigma 0
    acts greedily. The JAX package's ``agent_act_batch`` given the same
    draws (not ``DDPGAgent.act_batch``, whose fallback draws a 17th
    normal). A population acts with its stacked state on (P, K, ·)
    blocks (every argument with the leading member axis): one launch of
    K2's member form, the same arithmetic per member."""
    s = (states - st.norm_mean.unsqueeze(-2)) / torch.sqrt(
        st.norm_var.unsqueeze(-2) + 1e-8)
    mu = actor_forward(st.actor, s)
    cand = mu.unsqueeze(-2) + sigmas[..., None, None] * normals
    ok = torch.all((cand >= 0.0) & (cand <= 1.0), dim=-1)    # [..., K, 16]
    first = torch.argmax(ok.to(torch.int32), dim=-1)
    pick = torch.gather(cand, -2, first[..., None, None].expand(
        *first.shape, 1, cand.shape[-1])).squeeze(-2)
    noisy = torch.where(ok.any(dim=-1, keepdim=True), pick,
                        torch.clamp(cand[..., 0, :], 0.0, 1.0))
    acted = torch.where(sigmas[..., None] > 0.0, noisy, mu)
    return torch.where(warmup[..., None], uniforms, acted)


def observe_states_pure(st: AgentState, states: torch.Tensor) -> AgentState:
    """Advance the running-norm statistics from an (N, state_dim) block
    on the device, in place (the f32 twin of ``RunningNorm.update``: the
    same parallel-variance formula, as the JAX package's
    ``observe_states_pure``). Returns ``st``."""
    bc = float(states.shape[0])
    bm = states.mean(dim=0)
    bv = states.var(dim=0, correction=0)
    delta = bm - st.norm_mean
    tot = st.norm_count + bc
    mean = st.norm_mean + delta * bc / tot
    m_a = st.norm_var * st.norm_count
    m_b = bv * bc
    var = (m_a + m_b + delta ** 2 * st.norm_count * bc / tot) / tot
    st.norm_count.copy_(tot)
    st.norm_mean.copy_(mean)
    st.norm_var.copy_(var)
    return st


def _grad_leaves(net):
    """Fresh leaf copies of a network that require grad."""
    return [{k: v.detach().requires_grad_(True) for k, v in l.items()}
            for l in net]


def _grads(loss, net):
    flat = [l[k] for l in net for k in l]
    gs = iter(torch.autograd.grad(loss, flat))
    return [{k: next(gs) for k in l} for l in net]


def ddpg_step(cfg: DDPGConfig, actor, critic, t_actor, t_critic,
              opt_a, opt_c, batch):
    """One critic + actor + soft-target update on a prepared batch
    (states already standardized, rewards already centered)."""
    s, a, r, s2, done = batch
    with torch.no_grad():
        a2 = actor_forward(t_actor, s2)
        q_target = r + cfg.gamma * (1.0 - done) * critic_forward(
            t_critic, s2, a2)
    cp = _grad_leaves(critic)
    lc = torch.mean((critic_forward(cp, s, a) - q_target) ** 2)
    critic, opt_c = adam_step(critic, _grads(lc, cp), opt_c, cfg.critic_lr)

    ap = _grad_leaves(actor)
    la = -torch.mean(critic_forward(critic, s, actor_forward(ap, s)))
    actor, opt_a = adam_step(actor, _grads(la, ap), opt_a, cfg.actor_lr)

    t_actor, t_critic = polyak_update_targets(
        (t_actor, t_critic), (actor, critic), cfg.tau)
    return (actor, critic, t_actor, t_critic, opt_a, opt_c, lc.detach(),
            la.detach())


def update_step(cfg: DDPGConfig, st: AgentState, batch):
    """One full scalar-semantics update on an explicit sampled batch:
    reward-MA advance -> reward centering -> state standardization with
    the snapshot norm stats -> ``ddpg_step``."""
    s, a, r, s2, done = batch
    batch_mean = torch.mean(r)
    d = cfg.reward_ma_decay
    ma = torch.where(st.reward_ma_init > 0.0,
                     d * st.reward_ma + (1.0 - d) * batch_mean, batch_mean)
    r = r - ma
    inv = 1.0 / torch.sqrt(st.norm_var + 1e-8)
    s = (s - st.norm_mean) * inv
    s2 = (s2 - st.norm_mean) * inv
    actor, critic, t_actor, t_critic, opt_a, opt_c, lc, la = ddpg_step(
        cfg, st.actor, st.critic, st.target_actor, st.target_critic,
        st.opt_a, st.opt_c, (s, a, r, s2, done))
    st = st._replace(actor=actor, critic=critic, target_actor=t_actor,
                     target_critic=t_critic, opt_a=opt_a, opt_c=opt_c,
                     reward_ma=ma, reward_ma_init=torch.ones_like(ma))
    return st, (lc, la)


def update_chunk(cfg: DDPGConfig, st: AgentState, replay, n: int,
                 gen: Optional[torch.Generator] = None,
                 indices: Optional[torch.Tensor] = None):
    """n critic/actor/target updates, each on a uniform replay sample of a
    ``DeviceReplay`` or its ``DeviceReplayData``. ``indices`` ((n,
    batch_size) ints) replaces the draws from ``gen``: the fused engine
    draws them before a replay, the parity tests feed the JAX package's.
    Returns the new state and the (n,) critic and actor losses, left on
    the device."""
    data = getattr(replay, "data", replay)
    if indices is None:
        indices = replay.sample_indices((n, cfg.batch_size), gen)
    lcs, las = [], []
    for i in range(n):
        batch = device_replay_sample(data, indices[i])
        st, (lc, la) = update_step(cfg, st, batch)
        lcs.append(lc)
        las.append(la)
    return st, (torch.stack(lcs), torch.stack(las))


# ===========================================================================
# Stateful shim
# ===========================================================================

class DDPGAgent:
    """Stateful facade over the functional core: host-numpy acting,
    device-side update chunks. All parameters live in ``self.state``."""

    def __init__(self, cfg: DDPGConfig, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        init_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = agent_init(cfg, init_gen, self.device)
        # replay sampling stream (the JAX package splits its agent key)
        self.sample_gen = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self.norm = RunningNorm(cfg.state_dim)
        self.np_rng = np.random.default_rng(seed)
        self._actor_host = None            # numpy actor copy for rollouts

    # ---------------- acting ----------------
    def act(self, state: np.ndarray, sigma: float,
            random: bool = False) -> np.ndarray:
        if random:
            return self.np_rng.uniform(0, 1, self.cfg.action_dim) \
                .astype(np.float32)
        s = self.norm.normalize(state.astype(np.float32))
        mu = _actor_forward_np(self._host_actor(),
                               np.atleast_2d(s))[0].astype(np.float32)
        if sigma > 0:
            # truncated normal on [0, 1] around mu (paper Eq. 7)
            for _ in range(16):
                a = self.np_rng.normal(mu, sigma)
                if np.all((a >= 0) & (a <= 1)):
                    return a.astype(np.float32)
            a = np.clip(self.np_rng.normal(mu, sigma), 0, 1)
            return a.astype(np.float32)
        return mu.astype(np.float32)

    def act_batch(self, states: np.ndarray, sigmas: np.ndarray,
                  random_mask: np.ndarray) -> np.ndarray:
        """Batched ``act``: one actor forward over K stacked states.

        ``sigmas`` and ``random_mask`` are per row (episodes in a batch
        keep their own sigma-schedule position and warmup flag). The
        draws come from the agent's generator in the JAX package's order:
        one uniform block for all warmup rows, then up to 16 passes that
        each draw normals for the rows still pending, then the clipped
        fallback for the rest.
        """
        states = np.atleast_2d(np.asarray(states, np.float32))
        K, A = states.shape[0], self.cfg.action_dim
        sigmas = np.broadcast_to(np.asarray(sigmas, np.float32), (K,))
        random_mask = np.broadcast_to(np.asarray(random_mask, bool), (K,))
        out = np.empty((K, A), np.float32)
        if random_mask.any():
            out[random_mask] = self.np_rng.uniform(
                0, 1, (int(random_mask.sum()), A)).astype(np.float32)
        det = ~random_mask
        if not det.any():
            return out
        s = self.norm.normalize(states[det])
        mu = _actor_forward_np(self._host_actor(), s).astype(np.float32)
        sig = sigmas[det][:, None]
        a = mu.copy()
        pending = sigmas[det] > 0
        for _ in range(16):
            if not pending.any():
                break
            rows = np.where(pending)[0]
            cand = self.np_rng.normal(mu[rows], sig[rows])
            ok = np.all((cand >= 0) & (cand <= 1), axis=1)
            a[rows[ok]] = cand[ok]
            pending[rows[ok]] = False
        if pending.any():
            rows = np.where(pending)[0]
            a[rows] = np.clip(self.np_rng.normal(mu[rows], sig[rows]), 0, 1)
        out[det] = a.astype(np.float32)
        return out

    def sigma_at(self, episode: int) -> float:
        e = max(0, episode - self.cfg.warmup_episodes)
        return self.cfg.sigma0 * (self.cfg.sigma_decay ** e)

    def _host_actor(self):
        """numpy copy of the actor params, refreshed after updates."""
        if self._actor_host is None:
            self._actor_host = [
                {k: v.detach().cpu().numpy().astype(np.float32)
                 for k, v in layer.items()}
                for layer in self.state.actor]
        return self._actor_host

    def observe_states(self, states: np.ndarray):
        self.norm.update(states)

    # ---------------- learning ----------------
    def state_for_dispatch(self) -> AgentState:
        """The state with the host running-norm statistics copied into its
        tensors, so an update chunk (or the fused rollout) standardizes
        with the values acting used."""
        st = self.state
        st.norm_count.fill_(self.norm.count)
        st.norm_mean.copy_(torch.as_tensor(self.norm.mean))
        st.norm_var.copy_(torch.as_tensor(self.norm.var))
        return st

    def adopt_state(self, st: AgentState):
        """Take a post-chunk state as truth by copying it into the agent's
        own tensors (never reallocated); invalidates the host actor."""
        copy_state(self.state, st)
        self._actor_host = None

    def update_chunk(self, replay, n: int,
                     indices: Optional[torch.Tensor] = None):
        """n updates (sampling included) against the ``DeviceReplay``;
        returns the (n,) loss tensors without synchronizing."""
        if n <= 0 or len(replay) < self.cfg.batch_size:
            return None
        st, losses = update_chunk(self.cfg, self.state_for_dispatch(),
                                  replay, int(n), self.sample_gen, indices)
        self.adopt_state(st)
        return losses


def state_leaves(st: AgentState) -> list:
    """Every tensor of an ``AgentState``, in one fixed order."""
    out = []
    for net in (st.actor, st.critic, st.target_actor, st.target_critic):
        out += [l[k] for l in net for k in sorted(l)]
    for opt in (st.opt_a, st.opt_c):
        out += [l[k] for part in ("m", "v") for l in opt[part]
                for k in sorted(l)] + [opt["t"]]
    return out + [st.norm_count, st.norm_mean, st.norm_var, st.reward_ma,
                  st.reward_ma_init]


def copy_state(dst: AgentState, src: AgentState) -> None:
    """Copy ``src``'s tensors into ``dst``'s, in place (``dst``'s are
    never reallocated, so a graph that reads them stays valid)."""
    for d, s in zip(state_leaves(dst), state_leaves(src)):
        if d is not s:
            d.copy_(s)


# ===========================================================================
# Populations: stacked states and the megabatched update
# ===========================================================================

def _tree_map(fn, *trees):
    """``fn`` over the tensors of identically shaped agent states or ring
    data (named tuples, lists and dicts of tensors)."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, list):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    raise TypeError(f"cannot map over {type(t0).__name__}")


def stack_states(trees):
    """P ``AgentState``s (or ``DeviceReplayData`` rings) of one shape as
    one whose every tensor has a leading member axis, in new memory (the
    JAX package's ``tree_stack``)."""
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def index_state(tree, i: int):
    """Member i of a stacked state or ring: views of the stacked tensors,
    so what is written through them lands in the stack (the JAX
    package's ``tree_index``, which copies)."""
    return _tree_map(lambda x: x[i], tree)


def population_update_chunk_vmap(cfg: DDPGConfig, states: AgentState,
                                 replays, n: int, indices: torch.Tensor):
    """The parity reference of the megabatched chunk (the JAX package's
    ``jit(vmap(update_chunk))``): each member's solo ``update_chunk`` on
    its own ring and its own (n, batch_size) indices (``indices`` (P, n,
    batch_size)), its result copied into the stacked ``states`` in place.
    Returns ``states`` and the (P, n) critic and actor losses."""
    lcs, las = [], []
    for i in range(indices.shape[0]):
        st = index_state(states, i)
        new, (lc, la) = update_chunk(cfg, st, index_state(replays, i), n,
                                     indices=indices[i])
        copy_state(st, new)
        lcs.append(lc)
        las.append(la)
    return states, (torch.stack(lcs), torch.stack(las))


def _fused_adam_polyak(params, grads, opt: dict, target, lr: float,
                       tau: float) -> None:
    """Adam (bias correction folded into per-member ``lr_t`` / ``eps_t``)
    and the soft target update of one network's stacked (P, ...) leaves
    in place: one ``kernels.adam_polyak`` launch (its plain version on the
    CPU); ``opt["t"]`` ((P,) int32) advances. An exact rewrite of
    ``adam_step`` then the Polyak EMA (the JAX package's function of the
    same name)."""
    leaves = [(p_l[k], m_l[k], v_l[k], g_l[k], t_l[k])
              for p_l, g_l, m_l, v_l, t_l in zip(params, grads, opt["m"],
                                                 opt["v"], target)
              for k in sorted(p_l)]
    adam_polyak_(leaves, opt["t"], lr, tau)


def _bwd_dw(h, dz):
    """Weight cotangent (P, B, i), (P, B, o) -> (P, i, o)."""
    return torch.bmm(h.transpose(1, 2), dz)


def _bwd_dx(dz, w):
    """Input cotangent (P, B, o), (P, i, o) -> (P, B, i)."""
    return torch.bmm(dz, w.transpose(1, 2))


@torch.no_grad()
def _mega_update_step(cfg: DDPGConfig, st: AgentState, batch):
    """One update of every member of a stacked state, in place: the same
    member-wise semantics as ``update_step`` (reward-MA advance, frozen-
    norm standardization, critic then actor Adam against the updated
    critic, Polyak), with every product batched over the members
    (``torch.bmm``), a hand-written backward that forms only the
    cotangents DDPG needs (the actor loss's first critic layer split
    ``[s, pi] @ W1 = s @ W1[:S] + pi @ W1[S:]``, so only the action
    columns get an input gradient) and one fused Adam + Polyak launch per
    network. ``batch``: (s, a, r, s2, done), each (P, B, ...). Returns
    ``st`` and the (P,) critic and actor losses (the JAX package's
    ``_mega_update_step``)."""
    s, a, r, s2, done = batch
    S = cfg.state_dim

    def lin(x, layer):
        return torch.bmm(x, layer["w"]) + layer["b"][:, None, :]

    batch_mean = torch.mean(r, dim=1)
    d = cfg.reward_ma_decay
    ma = torch.where(st.reward_ma_init > 0.0,
                     d * st.reward_ma + (1.0 - d) * batch_mean, batch_mean)
    r = r - ma[:, None]
    inv = 1.0 / torch.sqrt(st.norm_var + 1e-8)
    s = (s - st.norm_mean[:, None, :]) * inv[:, None, :]
    s2 = (s2 - st.norm_mean[:, None, :]) * inv[:, None, :]
    TA, TC, CR, AC = st.target_actor, st.target_critic, st.critic, st.actor

    # q_target through the target networks (forward only)
    x = torch.relu(lin(s2, TA[0]))
    x = torch.relu(lin(x, TA[1]))
    a2 = torch.sigmoid(lin(x, TA[2]))
    x = torch.relu(lin(torch.cat([s2, a2], -1), TC[0]))
    x = torch.relu(lin(x, TC[1]))
    q_next = lin(x, TC[2])[..., 0]
    q_target = r + cfg.gamma * (1.0 - done) * q_next

    # critic loss, its backward, and the fused Adam + Polyak of the critic
    xc = torch.cat([s, a], -1)
    z1 = lin(xc, CR[0])
    h1 = torch.relu(z1)
    z2 = lin(h1, CR[1])
    h2 = torch.relu(z2)
    e = lin(h2, CR[2])[..., 0] - q_target
    lc = torch.mean(e * e, dim=1)
    dz3 = ((2.0 / e.shape[1]) * e)[..., None]
    dz2 = _bwd_dx(dz3, CR[2]["w"]) * (z2 > 0)
    dz1 = _bwd_dx(dz2, CR[1]["w"]) * (z1 > 0)
    gc = [{"w": _bwd_dw(xc, dz1), "b": dz1.sum(1)},
          {"w": _bwd_dw(h1, dz2), "b": dz2.sum(1)},
          {"w": _bwd_dw(h2, dz3), "b": dz3.sum(1)}]
    _fused_adam_polyak(CR, gc, st.opt_c, st.target_critic, cfg.critic_lr,
                       cfg.tau)

    # actor loss against the updated critic
    w1s, w1a = CR[0]["w"][:, :S, :], CR[0]["w"][:, S:, :]
    z1a = lin(s, AC[0])
    h1a = torch.relu(z1a)
    z2a = lin(h1a, AC[1])
    h2a = torch.relu(z2a)
    pi = torch.sigmoid(lin(h2a, AC[2]))
    zq1 = torch.bmm(s, w1s) + torch.bmm(pi, w1a) + CR[0]["b"][:, None, :]
    hq1 = torch.relu(zq1)
    zq2 = lin(hq1, CR[1])
    hq2 = torch.relu(zq2)
    qpi = lin(hq2, CR[2])[..., 0]
    la = -torch.mean(qpi, dim=1)
    dz3q = torch.full_like(hq2[..., :1], -1.0 / qpi.shape[1])
    dzq2 = _bwd_dx(dz3q, CR[2]["w"]) * (zq2 > 0)
    dzq1 = _bwd_dx(dzq2, CR[1]["w"]) * (zq1 > 0)
    dz3a = _bwd_dx(dzq1, w1a) * pi * (1.0 - pi)
    dz2a = _bwd_dx(dz3a, AC[2]["w"]) * (z2a > 0)
    dz1a = _bwd_dx(dz2a, AC[1]["w"]) * (z1a > 0)
    ga = [{"w": _bwd_dw(s, dz1a), "b": dz1a.sum(1)},
          {"w": _bwd_dw(h1a, dz2a), "b": dz2a.sum(1)},
          {"w": _bwd_dw(h2a, dz3a), "b": dz3a.sum(1)}]
    _fused_adam_polyak(AC, ga, st.opt_a, st.target_actor, cfg.actor_lr,
                       cfg.tau)
    st.reward_ma.copy_(ma)
    st.reward_ma_init.fill_(1.0)
    return st, (lc, la)


def population_update_chunk_megabatched(cfg: DDPGConfig, states: AgentState,
                                        replays, n: int,
                                        indices: torch.Tensor):
    """n megabatched steps (``_mega_update_step``) of every member of the
    stacked ``states`` in place, step i on the transitions of each
    member's ring at ``indices[:, i]`` ((P, n, batch_size)). Returns
    ``states`` and the (P, n) critic and actor losses (the JAX package's
    ``population_update_chunk_megabatched``; its donation is the in-place
    update here)."""
    rows = torch.arange(indices.shape[0], device=indices.device)[:, None]
    lcs, las = [], []
    for i in range(n):
        idx = indices[:, i]
        batch = tuple(x[rows, idx] for x in replays[:5])
        _, (lc, la) = _mega_update_step(cfg, states, batch)
        lcs.append(lc)
        las.append(la)
    return states, (torch.stack(lcs, 1), torch.stack(las, 1))


def population_update_chunk(cfg: DDPGConfig, states: AgentState, replays,
                            n: int, indices: torch.Tensor):
    """Route a population's update chunk: the megabatched path for the
    paper's trunk (two hidden layers), P solo chunks otherwise (the JAX
    package's router; here the solo chunks refuse any other depth, which
    K2 does not compute). Both update the stacked states in place,
    member-wise within 1e-5 of each other, and return them with the
    (P, n) losses."""
    if len(cfg.hidden) != 2:
        return population_update_chunk_vmap(cfg, states, replays, n,
                                            indices)
    return population_update_chunk_megabatched(cfg, states, replays, n,
                                               indices)
