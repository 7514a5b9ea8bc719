"""The Galen search loop (paper Fig. 1/2): episodes of layer-wise policy
prediction, hardware-oracle validation, and DDPG optimization.

Three agents (paper §Proposed Agents) share this loop and differ only in
``methods``:  "p" (pruning), "q" (quantization), "pq" (joint).

``CompressionSearch.run_episode`` is the scalar engine of the JAX
package: walk the actionable units in order, build the agent state (which
probes the analytic latency oracle under the partial policy), act on the
host, map the continuous action to a legal CMP, then validate the finished
policy on the device (fake-quantized, pruned forward: kernel K1), reward,
push the episode's transitions into the device replay ring and run the
episode's DDPG updates (kernels K2 and K3). The latency oracle is the
analytic roofline, or in ``oracle_mode="calibrated"`` / ``"measured"`` the
roofline rescaled by a ``core.measure.CalibrationTable`` taken on the
card; "measured" also times the deployed forward of the top-K finalists
(``SearchResult.measured``).

``BatchedCompressionSearch`` runs K episodes per rollout with the same
per-episode semantics (sigma schedule, warmup, shared episode reward,
legality): per layer step one vectorized oracle call
(``policy_latency_batch``), ``build_state_batch`` and one host actor
forward (``DDPGAgent.act_batch``), then one validation of the K policies
(``CompressibleLM.accuracy_policy_batch``: one forward, K1 launched once
per fake-quant site for all K), one bulk ring write, and the live
episodes' updates as one chunk. Both engines advance through the chunk
hooks (``_chunk_size`` / ``_run_chunk``) and queue their updates
(``_queue_updates``).

``FusedCompressionSearch`` (the JAX package's fused engine) runs a
batch's whole rollout as one CUDA-graph replay: per layer step the
device oracle (``latency.DeviceBatchOracle``), ``fused_state_block``,
the actor (``ddpg.agent_act_batch``, K2) and ``map_actions_batch``, the
(K, L) policies in device tensors, its draws (warmup uniforms, the 16
exploration normals per row) drawn into static tensors just before the
replay. Validation stays the batched engine's eager forward on host
bits (the reference's per-batch path also reads the policies back), and
the batch's update chunk is one more replay (one graph per update
count). With ``epoch_batches=E`` (``run_epoch``) E whole batches —
rollout, ``observe_states_pure``, validation on device bits
(``accuracy_policy_fn``), reward, ring write, the batch's updates and
the running best — are one replay and one readback. The graphs
(``core.graphs``) share one memory pool; on the CPU the same pure
functions run eagerly through the kernels' plain versions.
``dispatch_log`` records "rollout" / "validate" / "push" / "update" per
batch, or "epoch" per epoch; ``graphs.COUNTS`` the captures and
replays; ``readbacks`` the epochs' device-to-host reads.

``PopulationSearch`` runs P member searches side by side (the paper's
p/q/pq agents, or one member per hardware target): their agent states
and rings stacked once into (P, ·) tensors that the members' own
tensors are views of, their update budgets run as one megabatched
update replay (``ddpg.population_update_chunk``: the products batched
over the members, a hand-written backward, the fused Adam + Polyak
kernel), and, for fused members of one target family, their rollouts
(K2's member form) or whole epochs as one replay.

``FleetSearch`` is the population run as a service: whole shared epochs
from an episode cursor, an atomic async checkpoint of the stacked carry
(agent states, rings, both random streams of every member) every few
epochs, and a resume that writes the checkpoint into the population's
own tensors and continues bit for bit. On one device; a mesh of several
is refused (``distributed/sharding.py``).
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..checkpoint.checkpointing import (AsyncCheckpointer, restore_latest,
                                        save_async)
from ..distributed.fault_tolerance import FaultToleranceConfig, StepMonitor
from ..distributed.sharding import population_shardings
from . import graphs
from .constraints import legal_tables
from .ddpg import (AgentState, DDPGAgent, DDPGConfig, agent_act_batch,
                   copy_state, index_state, observe_states_pure,
                   population_update_chunk, stack_states, state_leaves,
                   update_chunk)
from .latency import (V5E, HardwareTarget, LatencyContext, fifo_cached,
                      get_device_oracle, policy_latency,
                      policy_latency_batch, stack_hw_params)
from .policy import (Policy, PolicyBatch, action_columns, map_actions,
                     map_actions_batch, n_actions, policies_from_batch,
                     stack_policies)
from .replay import DeviceReplay, DeviceReplayData, device_replay_push
from .reward import RewardConfig, compute_reward, compute_reward_batch
from .sensitivity import SensitivityResult, run_sensitivity
from .spec import effective_bits
from .state import (StateTables, build_state, build_state_batch,
                    fused_state_block, state_dim)


@dataclass(frozen=True)
class SearchConfig:
    methods: str = "pq"                # p | q | pq
    episodes: int = 120
    reward: RewardConfig = field(default_factory=RewardConfig)
    ddpg: Optional[DDPGConfig] = None  # None -> sized to the method set
    seed: int = 0
    window: int = 0                    # attention window for the oracle
    track_bops: bool = True
    # latency oracle flavor (core/measure.py):
    #   analytic   — pure roofline (the default, no measurement)
    #   calibrated — roofline terms rescaled by the fitted per-(kind,
    #                container) factors of a CalibrationTable
    #   measured   — calibrated search + wall-clock re-timing of the
    #                top-K final candidates (SearchResult.measured)
    oracle_mode: str = "analytic"
    calibration_path: str = ""         # "" -> measure.DEFAULT_CALIBRATION_PATH
    measure_top_k: int = 3             # distinct candidates re-timed


@dataclass
class EpisodeRecord:
    episode: int
    reward: float
    accuracy: float
    latency_s: float
    latency_ratio: float
    macs_frac: float
    bops: float
    sigma: float
    policy: Policy = field(repr=False, default=None)


@dataclass
class SearchResult:
    history: List[EpisodeRecord]
    best: EpisodeRecord
    ref_latency_s: float
    ref_accuracy: float
    # oracle_mode="measured": wall-clock rows for the top-K candidates
    # (predicted vs measured seconds and ratios vs the reference model)
    measured: Optional[List[dict]] = None

    def best_under_budget(self, tol: float = 0.05) -> Optional[EpisodeRecord]:
        c = None
        for r in self.history:
            if r.latency_ratio <= (1.0 + tol):
                if c is None or r.accuracy > c.accuracy:
                    c = r
        return c


def _actionable(spec, methods: str) -> bool:
    if methods == "p":
        return spec.prunable and spec.prune_dim > 0
    if methods == "q":
        return spec.quantizable
    return spec.quantizable or (spec.prunable and spec.prune_dim > 0)


class CompressionSearch:
    """Owns: the compressible model, the sensitivity table, the latency
    oracle context, the agent, and the episode loop. The agent and the
    replay ring live on the model's device."""

    def __init__(self, cmodel, val_batch, search_cfg: SearchConfig,
                 ctx: LatencyContext, hw: HardwareTarget = V5E,
                 sens: Optional[SensitivityResult] = None,
                 calib_batch=None, calib=None):
        # latency-oracle flavor: a CalibrationTable rescales the oracle's
        # terms in calibrated/measured mode; analytic ignores it
        mode = search_cfg.oracle_mode
        if mode not in ("analytic", "calibrated", "measured"):
            raise ValueError(
                f"SearchConfig.oracle_mode must be analytic|calibrated|"
                f"measured, got {mode!r}")
        if mode != "analytic" and calib is None:
            from .measure import load_calibration
            calib = load_calibration(search_cfg.calibration_path or None)
        self.calib = calib if mode != "analytic" else None
        self.cmodel = cmodel
        self.specs = cmodel.specs
        self.cfg = search_cfg
        self.hw = hw
        self.ctx = ctx
        self.val_batch = val_batch
        device = cmodel.device
        native = n_actions(search_cfg.methods)
        ddpg_cfg = search_cfg.ddpg or DDPGConfig(
            state_dim=state_dim(native), action_dim=native)
        a_dim = max(native, ddpg_cfg.action_dim)
        if (ddpg_cfg.state_dim, ddpg_cfg.action_dim) != (state_dim(a_dim),
                                                         a_dim):
            ddpg_cfg = DDPGConfig(**{**ddpg_cfg.__dict__,
                                     "state_dim": state_dim(a_dim),
                                     "action_dim": a_dim})
        self.agent = DDPGAgent(ddpg_cfg, seed=search_cfg.seed, device=device)
        self.replay = DeviceReplay(ddpg_cfg.buffer_size, ddpg_cfg.state_dim,
                                   a_dim, device=device)
        self.sens = sens if sens is not None else run_sensitivity(
            cmodel, calib_batch if calib_batch is not None else val_batch)
        self.ref_policy = Policy.reference(self.specs)
        self.ref_lat = policy_latency(self.specs, self.ref_policy, hw, ctx,
                                      search_cfg.window, calib=self.calib)
        self.ref_acc = float(cmodel.accuracy(
            val_batch, cmodel.build_cspec(self.ref_policy)))
        self.steps = [i for i, s in enumerate(self.specs)
                      if _actionable(s, search_cfg.methods)]
        self._pending_updates = 0
        self._defer_updates = False     # PopulationSearch batches flushes

    def _flush_updates(self):
        """Run the queued update budget as one chunk, once the ring holds
        a DDPG batch."""
        n = self._pending_updates
        self._pending_updates = 0
        if n > 0 and len(self.replay) >= self.agent.cfg.batch_size:
            self.agent.update_chunk(self.replay, n)

    def _queue_updates(self, n: int):
        """Queue n updates and run them, unless a population defers the
        flush to run its members' chunks as one."""
        self._pending_updates += n
        if not self._defer_updates:
            self._flush_updates()

    def _fill_indices(self, indices: torch.Tensor, size: int):
        """One update chunk's replay indices, (n, batch_size), uniform
        over a filled prefix of ``size`` (the host mirror or an epoch
        schedule's), from the agent's sampling stream: the draws of
        ``DDPGAgent.update_chunk`` (a population fills its members' rows
        of a shared chunk with them; the parity tests feed the JAX
        package's)."""
        indices.random_(0, max(size, 1), generator=self.agent.sample_gen)

    def run_episode(self, episode: int) -> EpisodeRecord:
        cfg = self.cfg
        warmup = episode < self.agent.cfg.warmup_episodes
        sigma = self.agent.sigma_at(episode)
        partial = copy.deepcopy(self.ref_policy)
        a_dim = self.agent.cfg.action_dim
        prev_a = np.zeros(a_dim, np.float32)
        states, actions = [], []
        for t in self.steps:
            s_vec = build_state(self.specs, t, partial, self.sens, prev_a,
                                self.hw, self.ctx, self.ref_lat, cfg.window)
            a = self.agent.act(s_vec, sigma, random=warmup)
            cmp = map_actions(self.specs[t], a, cfg.methods)
            # single-method agents keep the other method's parameters from
            # the reference policy
            prev = partial.cmps[t]
            if cfg.methods == "q":
                cmp.keep = prev.keep
            elif cfg.methods == "p":
                cmp.mode, cmp.w_bits, cmp.a_bits = (prev.mode, prev.w_bits,
                                                    prev.a_bits)
            partial.cmps[t] = cmp
            states.append(s_vec)
            actions.append(a)
            prev_a = a
        policy = partial

        acc = float(self.cmodel.accuracy(self.val_batch,
                                         self.cmodel.build_cspec(policy)))
        lat = policy_latency(self.specs, policy, self.hw, self.ctx,
                             cfg.window, calib=self.calib)
        reward = compute_reward(cfg.reward, acc, lat.total_s,
                                self.ref_lat.total_s)
        # push transitions — one shared episode reward (paper §Schema),
        # one bulk ring write for the whole chain
        T = len(states)
        st_arr = np.stack(states)
        self.agent.observe_states(st_arr)
        nxt = np.concatenate([st_arr[1:], st_arr[-1:]])
        done = np.zeros(T, np.float32)
        done[-1] = 1.0
        self.replay.push_batch(st_arr, np.stack(actions),
                               np.full(T, reward, np.float32), nxt, done)
        if not warmup:
            self._queue_updates(self.agent.cfg.updates_per_episode)

        ratio = lat.total_s / (cfg.reward.target_ratio *
                               self.ref_lat.total_s)
        return EpisodeRecord(
            episode=episode, reward=reward, accuracy=acc,
            latency_s=lat.total_s, latency_ratio=ratio,
            macs_frac=policy.macs_fraction(self.specs),
            bops=policy.bops(self.specs) if cfg.track_bops else 0.0,
            sigma=sigma, policy=policy)

    # chunking hooks: the scalar engine advances one episode at a time;
    # BatchedCompressionSearch overrides them to roll K per call
    def _chunk_size(self) -> int:
        return 1

    def _run_chunk(self, first_episode: int,
                   k: int) -> List[EpisodeRecord]:
        return [self.run_episode(first_episode)]

    def run(self, episodes: Optional[int] = None,
            verbose: bool = False) -> SearchResult:
        n = episodes or self.cfg.episodes
        history: List[EpisodeRecord] = []
        best = None
        e = 0
        while e < n:
            k = min(self._chunk_size(), n - e)
            for rec in self._run_chunk(e, k):
                history.append(rec)
                if best is None or rec.reward > best.reward:
                    best = rec
                if verbose and (rec.episode % 10 == 0
                                or rec.episode == n - 1):
                    print(f"  ep {rec.episode:4d} reward={rec.reward:+.4f} "
                          f"acc={rec.accuracy:.3f} "
                          f"lat_ratio={rec.latency_ratio:.3f} "
                          f"sigma={rec.sigma:.3f}")
            e += k
        result = SearchResult(history=history, best=best,
                              ref_latency_s=self.ref_lat.total_s,
                              ref_accuracy=self.ref_acc)
        if self.cfg.oracle_mode == "measured":
            result.measured = self._measure_top_k(history)
        return result

    def _measure_top_k(self, history: List[EpisodeRecord]) -> List[dict]:
        """Wall-clock the deployed forward of the top-K candidates (the
        paper's measure-on-target step, applied only to finalists). The
        measurement memo is keyed by container signature, so candidates
        sharing a deployment are timed once."""
        from . import measure
        k = max(1, self.cfg.measure_top_k)
        top = sorted(history, key=lambda r: r.reward, reverse=True)[:k]
        ref_s = measure.measure_policy(self.cmodel, self.ref_policy,
                                       self.val_batch)
        rows = []
        for r in top:
            t = measure.measure_policy(self.cmodel, r.policy,
                                       self.val_batch)
            rows.append({
                "episode": r.episode, "reward": r.reward,
                "predicted_s": r.latency_s,
                "predicted_ratio": r.latency_s / self.ref_lat.total_s,
                "measured_s": t, "measured_ref_s": ref_s,
                "measured_ratio": t / ref_s if ref_s > 0 else float("inf"),
            })
        return rows


class BatchedCompressionSearch(CompressionSearch):
    """K episodes per rollout (``batch_size``); see the module docstring.

    Per-episode semantics (sigma schedule, warmup, shared episode
    reward, legality constraints) match ``CompressionSearch``; the
    batch's critic/actor updates run after the whole batch (the same
    total count), and the state normalizer advances once per batch, as
    in the JAX package's batched engine.
    """

    def __init__(self, cmodel, val_batch, search_cfg: SearchConfig,
                 ctx: LatencyContext, hw: HardwareTarget = V5E,
                 sens: Optional[SensitivityResult] = None,
                 calib_batch=None, calib=None, batch_size: int = 8):
        super().__init__(cmodel, val_batch, search_cfg, ctx, hw=hw,
                         sens=sens, calib_batch=calib_batch, calib=calib)
        self.batch_size = max(1, batch_size)

    def _batch_schedule(self, first_episode: int, k: int):
        """(warmup mask, sigma) per episode row: the one place the batch's
        exploration schedule is derived."""
        eps = range(first_episode, first_episode + k)
        warmup = np.asarray(
            [e < self.agent.cfg.warmup_episodes for e in eps])
        sigmas = np.asarray([self.agent.sigma_at(e) for e in eps],
                            np.float32)
        return warmup, sigmas

    def run_episode_batch(self, first_episode: int,
                          k: int) -> List[EpisodeRecord]:
        cfg = self.cfg
        eps = list(range(first_episode, first_episode + k))
        warmup, sigmas = self._batch_schedule(first_episode, k)
        partials = [copy.deepcopy(self.ref_policy) for _ in eps]
        # (K, L) policy arrays, updated in place as units are decided
        pb = stack_policies(self.specs, partials)
        prev_a = np.zeros((k, self.agent.cfg.action_dim), np.float32)
        step_states, step_actions = [], []
        for t in self.steps:
            cur = policy_latency_batch(self.specs, pb, self.hw, self.ctx,
                                       cfg.window, calib=self.calib)
            S = build_state_batch(self.specs, t, cur, self.sens, prev_a,
                                  self.ref_lat)
            A = self.agent.act_batch(S, sigmas, warmup)
            for j in range(k):
                cmp = map_actions(self.specs[t], A[j], cfg.methods)
                prev = partials[j].cmps[t]
                if cfg.methods == "q":
                    cmp.keep = prev.keep
                elif cfg.methods == "p":
                    cmp.mode, cmp.w_bits, cmp.a_bits = (
                        prev.mode, prev.w_bits, prev.a_bits)
                partials[j].cmps[t] = cmp
                pb.keep[j, t] = cmp.keep
                pb.w_bits[j, t], pb.a_bits[j, t] = effective_bits(cmp)
            step_states.append(S)
            step_actions.append(A)
            prev_a = A

        # one validation of the K policies and one oracle call
        accs = self.cmodel.accuracy_policy_batch(self.val_batch,
                                                 pb).cpu().numpy()
        lats = policy_latency_batch(self.specs, pb, self.hw, self.ctx,
                                    cfg.window, calib=self.calib).total_s
        rewards = compute_reward_batch(cfg.reward, accs, lats,
                                       self.ref_lat.total_s)
        return self._push_and_record(
            eps, warmup, sigmas, partials, np.stack(step_states),
            np.stack(step_actions), accs, lats, rewards)

    def _push_and_record(self, eps, warmup, sigmas, pols, states,
                         actions, accs, lats,
                         rewards) -> List[EpisodeRecord]:
        """The batch tail, the shared-episode-reward transition scheme:
        observe the (T, K, ·) states in T-major order, push the
        per-episode chains as one ring write in K-major order (reward
        repeated along each chain, done on the last step), queue the live
        episodes' update budget, and build the records."""
        cfg = self.cfg
        T, k = len(self.steps), len(eps)
        self._observe(states.reshape(T * k, -1))
        nxt = np.concatenate([states[1:], states[-1:]])
        done = np.zeros((T, k), np.float32)
        done[-1] = 1.0

        def order(x):
            return x.swapaxes(0, 1).reshape(T * k, *x.shape[2:])

        self.replay.push_batch(
            order(states), order(actions),
            np.repeat(rewards, T).astype(np.float32),
            order(nxt), order(done))
        self._log_push()
        n_live = int((~warmup).sum())
        self._queue_updates(self.agent.cfg.updates_per_episode * n_live)

        acc_l, lat_l, rew_l, sig_l = (
            np.asarray(x, np.float64).tolist()
            for x in (accs, lats, rewards, sigmas))
        denom = cfg.reward.target_ratio * self.ref_lat.total_s
        return [EpisodeRecord(
            episode=e, reward=rew_l[j], accuracy=acc_l[j],
            latency_s=lat_l[j], latency_ratio=lat_l[j] / denom,
            macs_frac=pols[j].macs_fraction(self.specs),
            bops=pols[j].bops(self.specs) if cfg.track_bops else 0.0,
            sigma=sig_l[j], policy=pols[j]) for j, e in enumerate(eps)]

    def _observe(self, states: np.ndarray):
        """Advance the running norm by a batch's (T*K, S) states."""
        self.agent.observe_states(states)

    def _log_push(self):
        """Hook: the fused engine logs its ring writes."""

    def _chunk_size(self) -> int:
        return self.batch_size

    def _run_chunk(self, first_episode: int,
                   k: int) -> List[EpisodeRecord]:
        return self.run_episode_batch(first_episode, k)



# ===========================================================================
# Fused engine: the rollout as one graph replay
# ===========================================================================

class MethodCols(NamedTuple):
    """Which action columns feed pruning / quantization, and whether each
    method is live (host values: a rollout graph is captured per set)."""
    ip: int
    iw: int
    ia: int
    do_p: bool
    do_q: bool


def method_cols(methods: str) -> MethodCols:
    return MethodCols(*action_columns(methods), "p" in methods,
                      "q" in methods)


def make_rollout_fn(cfg: DDPGConfig, oracle, legal, static_tab, spec_steps,
                    cols: MethodCols):
    """The pure rollout the fused engine captures: ``rollout(st, keep0,
    wb0, ab0, sigmas, warmup, hwp, shares, ref_total, uniforms, normals)
    -> (keep, wb, ab, states, actions, lats)``. Constants: the agent
    config, the device oracle, the legality tables, the (T, S) static
    feature rows on the device, the spec index of each step, the method
    columns. Everything hardware- or member-specific is an input (the
    JAX package's rollout), so one function serves a population:

    * one engine: its agent state, the (L,) reference policy rows, per-
      row sigmas (K,) and warmup flags (K,), its target's rates ``hwp``
      (0-d), its (T, 2) reference-latency shares and 0-d reference
      total, the draws (T, K, A) uniforms and (T, K, 16, A) normals;
      ``states`` / ``actions`` (T, K, ·), ``lats`` (K,);
    * P members (the population's shared rollout): their stacked state,
      sigmas / warmup (P, K), ``hwp`` with (P, 1, 1) fields, shares (P,
      T, 2), ref_total (P, 1), draws (P, T, K, ·); every output with the
      leading member axis. The oracle runs on (P, K, L) rows, the actor
      is one launch of K2's member form, ``map_actions_batch`` takes the
      P·K rows flattened.

    The whole episode environment, unrolled over the T steps (the JAX
    package's ``lax.scan``)."""

    def rollout(st, keep0, wb0, ab0, sigmas, warmup, hwp, shares,
                ref_total, uniforms, normals):
        lead, L = sigmas.shape, keep0.shape[-1]
        keep, wb, ab = (x.expand(*lead, L).clone()
                        for x in (keep0, wb0, ab0))
        prev_a = sigmas.new_zeros((*lead, cfg.action_dim))
        states, actions = [], []
        for i, t in enumerate(spec_steps):
            unit_t, extra_t = oracle.unit_times(keep, wb, ab, hwp)
            decided = oracle.decided_before(unit_t, extra_t, t) / ref_total
            S = fused_state_block(static_tab[i], shares.select(-2, i),
                                  decided, prev_a)
            A = agent_act_batch(cfg, st, S, sigmas, warmup,
                                uniforms.select(-3, i), normals.select(-4, i))
            new_keep, new_wb, new_ab = (x.reshape(lead) for x in
                                        map_actions_batch(
                A.reshape(-1, A.shape[-1]), prune_dim=legal.prune_dim[t],
                granularity=legal.granularity[t],
                prunable=legal.prunable[t], quantizable=legal.quantizable[t],
                mix_ok=legal.mix_ok[t], ip=cols.ip, iw=cols.iw, ia=cols.ia))
            # single-method agents keep the other method's reference
            # parameters (the host engines' rule)
            if cols.do_p:
                keep[..., t] = new_keep
            if cols.do_q:
                wb[..., t] = new_wb
                ab[..., t] = new_ab
            states.append(S)
            actions.append(A)
            prev_a = A
        unit_t, extra_t = oracle.unit_times(keep, wb, ab, hwp)
        lats = oracle.totals(unit_t, extra_t, hwp)
        return (keep, wb, ab, torch.stack(states, -3),
                torch.stack(actions, -3), lats)

    return rollout


# ===========================================================================
# Epoch mode: E episode batches as one graph replay
# ===========================================================================

def _schedule_segments(schedule: tuple) -> List[tuple]:
    """Group a static update schedule into (n_updates, batch count) runs
    of consecutive equal entries: (32, 64, 64, 64) -> [(32, 1), (64, 3)]
    (the JAX package's scan segments; here it names the runs an epoch's
    log and tests read)."""
    segs: List[tuple] = []
    for n in schedule:
        if segs and segs[-1][0] == n:
            segs[-1] = (n, segs[-1][1] + 1)
        else:
            segs.append((n, 1))
    return segs


def make_epoch_fn(cfg: DDPGConfig, reward_cfg: RewardConfig, rollout_fn,
                  acc_fn, T: int, K: int, schedule: tuple):
    """The pure epoch: E = len(schedule) episode batches, each the fused
    rollout, ``observe_states_pure``, the device validation (``acc_fn``:
    (N, L) int32 tensors -> (N,) accuracies), the reward, the ring write
    and its ``schedule[e]`` updates, then the running best — the agent
    states and the rings updated in place from batch to batch.

    ``epoch(st, members, keep0, wb0, ab0, sigmas, warmup, hwp, shares,
    ref_total, uniforms, normals, indices) -> [(ys, best)]``, one entry
    per member. ``st`` is what the rollout acts with; ``members`` a list
    of (agent state, ring data, 0-d reference total seconds). One engine:
    ``st`` its state, ``members`` itself, sigmas / warmup (E, K), the
    rollout's ``hwp`` / ``shares`` / ``ref_total`` (``make_rollout_fn``),
    the draws (E, T, K, ·), ``indices`` the (n, batch_size) replay
    indices of each batch (None where n is 0). A population (the JAX
    package's ``vmap`` of the epoch): ``st`` the stacked state whose
    member views the ``members`` hold, every input with the leading
    member axis ((P, E, K), (P, E, T, K, ·), indices (P, n, batch_size)):
    one rollout and one validation of the P·K policies per batch, then
    each member's reward, ring write and solo ``update_chunk``s. ``ys =
    (accs, lats, rewards, keep, wb, ab)`` stacked (E, ...) and ``best =
    (reward, episode offset, (3, L) policy rows)``: the first strict
    maximum over the member's E*K episodes, the rule of ``run``'s host
    loop."""

    def epoch(st, members, keep0, wb0, ab0, sigmas, warmup, hwp, shares,
              ref_total, uniforms, normals, indices):
        stacked = sigmas.dim() == 3
        L = keep0.shape[-1]
        f32 = dict(dtype=torch.float32, device=sigmas.device)
        best = [(torch.full((), float("-inf"), **f32),
                 torch.zeros((), dtype=torch.int64, device=sigmas.device),
                 torch.zeros((3, L), **f32)) for _ in members]
        ys = [[] for _ in members]
        for e, n in enumerate(schedule):
            out = rollout_fn(st, keep0, wb0, ab0, sigmas.select(-2, e),
                             warmup.select(-2, e), hwp, shares, ref_total,
                             uniforms.select(-4, e), normals.select(-5, e))
            accs = acc_fn(*(x.reshape(-1, L).to(torch.int32)
                            for x in out[:3])).reshape(out[5].shape)
            for i, (sti, ring, ref_total_s) in enumerate(members):
                keep, wb, ab, states, actions, lats, acc = (
                    z[i] if stacked else z for z in (*out, accs))
                # the normalizer advances at the batch boundary, as the
                # host engines' observe_states does
                observe_states_pure(sti, states.reshape(T * K, -1))
                rewards = compute_reward_batch(reward_cfg, acc, lats,
                                               ref_total_s)

                def order(z):
                    return z.transpose(0, 1).reshape(T * K, *z.shape[2:])

                nxt = torch.cat([states[1:], states[-1:]])
                done = states.new_zeros((T, K))
                done[-1] = 1.0
                device_replay_push(ring, order(states), order(actions),
                                   rewards[:, None].expand(K, T).reshape(-1),
                                   order(nxt), order(done))
                if n > 0:
                    idx = indices[e][i] if stacked else indices[e]
                    copy_state(sti, update_chunk(cfg, sti, ring, n,
                                                 indices=idx)[0])
                # the first maximum; a 0-d index would read j on the host
                best_r, best_e, best_p = best[i]
                r_j, j = torch.max(rewards, dim=0)
                better = r_j > best_r
                best[i] = (torch.where(better, r_j, best_r),
                           torch.where(better, e * K + j, best_e),
                           torch.where(better, torch.stack([keep, wb, ab], 1)
                                       .index_select(0, j.reshape(1))[0],
                                       best_p))
                ys[i].append((acc, lats, rewards, keep, wb, ab))
        return [(tuple(torch.stack(z) for z in zip(*y)), b)
                for y, b in zip(ys, best)]

    return epoch


def _epoch_flat(results, members) -> torch.Tensor:
    """An epoch's results as one flat f32 buffer, the epoch's one
    readback: per member its metrics and policies, its norm statistics
    and its best (``FusedCompressionSearch._finish_epoch`` reads one
    member's segment)."""
    flat = []
    for (ys, best), (st, _, _) in zip(results, members):
        flat += [z.reshape(-1).float() for z in ys]
        flat += [st.norm_count.reshape(1), st.norm_mean, st.norm_var,
                 best[0].reshape(1), best[1].reshape(1).float()]
    return torch.cat(flat)


_EPOCH_CACHE_MAX = 16


def _read(*tensors) -> list:
    """Tensors read to the host in one transfer: numpy arrays of their
    shapes (f32)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def _draw_inputs(lead: tuple, T: int, K: int, A: int, device) -> dict:
    """Static tensors for a batch's schedule and draws, with the leading
    axes ``lead`` (an epoch's E, a population's P): sigmas and warmup
    flags (*lead, K), uniforms (*lead, T, K, A), normals (*lead, T, K, 16,
    A)."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"sigmas": torch.empty((*lead, K), **f32),
            "warmup": torch.empty((*lead, K), dtype=torch.bool,
                                  device=device),
            "uniforms": torch.empty((*lead, T, K, A), **f32),
            "normals": torch.empty((*lead, T, K, 16, A), **f32)}


def _rollout_graph(owner, m0, k: int, state, tables: tuple,
                   P: Optional[int] = None):
    """The rollout graph of ``k`` episodes a batch, cached on ``owner`` (an
    engine, or a population of ``P`` engines like ``m0``): ``m0``'s
    rollout function over ``state()`` (the agent state, or the stacked
    one) and ``tables`` (``hwp``, shares, reference total), its static
    draw tensors with a leading P for a population. Returns (graph,
    static inputs)."""
    hit = owner._rollouts.get(k)
    if hit is None:
        x = _draw_inputs(() if P is None else (P,), len(m0.steps), k,
                         m0.agent.cfg.action_dim, owner.device)
        keep0, wb0, ab0 = m0._ref_rows
        fn = lambda: m0._rollout_fn(state(), keep0, wb0, ab0, x["sigmas"],
                                    x["warmup"], *tables, x["uniforms"],
                                    x["normals"])
        hit = owner._rollouts[k] = (graphs.Graph(
            "rollout", fn, owner.device, pool=owner._pool), x)
    return hit


def _epoch_graph(owner, m0, schedule: tuple, st, ring, members,
                 tables: tuple, P: Optional[int] = None):
    """The epoch graph of a schedule, FIFO-cached on ``owner`` (an engine,
    or a population of ``P`` engines like ``m0``; steady-state epochs
    share one schedule, hence one capture), keyed by the params object
    too: new weights capture anew. ``st`` / ``ring``: what the epoch
    updates in place (the engine's, or the stacked ones), ``members``:
    ``make_epoch_fn``'s. Returns (params, graph, static inputs)."""
    params = m0.cmodel.params

    def make():
        x = m0._epoch_inputs(schedule, P)
        epoch = m0._make_epoch_fn(schedule)
        keep0, wb0, ab0 = m0._ref_rows

        def fn():
            return _epoch_flat(epoch(
                st, members, keep0, wb0, ab0, x["sigmas"], x["warmup"],
                *tables, x["uniforms"], x["normals"], x["indices"]),
                members)

        g = graphs.Graph("epoch", fn, owner.device,
                         writes=state_leaves(st) + list(ring),
                         pool=owner._pool)
        return params, g, x

    return fifo_cached(owner._epoch_cache, _EPOCH_CACHE_MAX,
                       (m0.batch_size, schedule, id(params)),
                       lambda hit: hit[0] is params, make)


class FusedCompressionSearch(BatchedCompressionSearch):
    """K episodes per rollout, the rollout one graph replay; with
    ``epoch_batches=E > 0``, E batches per replay (the module
    docstring).

    Exploration draws come from a dedicated ``torch.Generator`` on the
    engine's device, seeded as the JAX package's rollout stream (``seed
    + 0x5EED``), separate from the agent's replay-sampling stream; they
    are drawn into static tensors before each replay (``_fill_draws``),
    as are the replay indices (``_fill_indices``), each bounded by the
    ring size the static schedule gives. The parity tests replace both
    with the JAX engine's draws. A per-batch engine and an epoch engine
    of the same seed draw the same numbers in the same order. In a
    population, each member fills its slice of the shared static
    tensors from its own generators, in its solo order.
    """

    def __init__(self, cmodel, val_batch, search_cfg: SearchConfig,
                 ctx: LatencyContext, hw: HardwareTarget = V5E,
                 sens: Optional[SensitivityResult] = None,
                 calib_batch=None, calib=None, batch_size: int = 8,
                 epoch_batches: int = 0):
        super().__init__(cmodel, val_batch, search_cfg, ctx, hw=hw,
                         sens=sens, calib_batch=calib_batch, calib=calib,
                         batch_size=batch_size)
        device = self.device = cmodel.device
        self.oracle = get_device_oracle(self.specs, hw, ctx,
                                        search_cfg.window, calib=self.calib,
                                        device=device)
        self.tables = StateTables(self.specs, self.steps, self.sens,
                                  self.ref_lat)
        static, self._shares, self._ref_total = self.tables.to(device)
        ref_pb = stack_policies(self.specs, [self.ref_policy])
        self._ref_rows = tuple(
            torch.as_tensor(x[0], dtype=torch.float32, device=device)
            for x in (ref_pb.keep, ref_pb.w_bits, ref_pb.a_bits))
        self._ref_total_s = torch.tensor(self.ref_lat.total_s,
                                         dtype=torch.float32, device=device)
        self._cols = method_cols(search_cfg.methods)
        self._rollout_fn = make_rollout_fn(
            self.agent.cfg, self.oracle, legal_tables(self.specs, device),
            static, [int(t) for t in self.tables.spec_idx], self._cols)
        self._rollout_gen = torch.Generator(device=device).manual_seed(
            search_cfg.seed + 0x5EED)
        self.dispatch_log: List[str] = []
        self.readbacks = 0
        self.epoch_batches = max(0, epoch_batches)
        self.last_epoch_best: Optional[tuple] = None
        self._reset_graphs()

    def _reset_graphs(self):
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self._rollouts: dict = {}      # K -> (graph, static inputs)
        self._updates: dict = {}       # n -> (graph, indices)
        self._epoch_cache: dict = {}   # (K, schedule, id(params)) -> ...

    # ------------------------------------------------------------- draws
    def _fill_draws(self, uniforms: torch.Tensor, normals: torch.Tensor):
        """One batch's exploration draws, into its static tensors: (T, K,
        A) uniforms in [0, 1) and (T, K, 16, A) standard normals."""
        uniforms.uniform_(generator=self._rollout_gen)
        normals.normal_(generator=self._rollout_gen)

    def _rollout_graph(self, k: int):
        return _rollout_graph(self, self, k, lambda: self.agent.state,
                              self._tables())

    def _tables(self) -> tuple:
        """This engine's rollout inputs that a population stacks: its
        target's rates, its (T, 2) shares, its reference total."""
        return self.oracle.hwp, self._shares, self._ref_total

    def _set_schedule(self, sigmas, warmup, first_episode: int, k: int):
        """A batch's sigmas and warmup flags into their static tensors."""
        warm, sig = self._batch_schedule(first_episode, k)
        sigmas.copy_(torch.as_tensor(sig))
        warmup.copy_(torch.as_tensor(warm))

    # --------------------------------------------------------- per batch
    def run_episode_batch(self, first_episode: int,
                          k: int) -> List[EpisodeRecord]:
        """The rollout as one replay, then the batch tail
        (``_finish_batch``)."""
        graph, x = self._rollout_graph(k)
        self._set_schedule(x["sigmas"], x["warmup"], first_episode, k)
        self._fill_draws(x["uniforms"], x["normals"])
        out = graph()
        self.dispatch_log.append("rollout")
        return self._finish_batch(first_episode, k, out)

    def _finish_batch(self, first_episode: int, k: int,
                      out: tuple) -> List[EpisodeRecord]:
        """Everything after a batch's rollout (``out``, the rollout's
        outputs for this engine, its own or its slice of a population's):
        the norm advanced on the device (``observe_states_pure``, as the
        epoch does, so the two modes agree), one read of the policies,
        states, actions and norm statistics, the validation on host bits,
        the reward on the device, the ring write and the queued updates."""
        keep, wb, ab, states, actions, lats = out
        st = self.agent.state
        observe_states_pure(st, states.reshape(-1, states.shape[-1]))
        keep, wb, ab, states, actions, count, mean, var = _read(
            keep, wb, ab, states, actions, st.norm_count, st.norm_mean,
            st.norm_var)
        self._mirror_norm(count, mean, var)
        pb = PolicyBatch(keep=keep.astype(np.float64),
                         w_bits=wb.astype(np.float64),
                         a_bits=ab.astype(np.float64))
        accs = self.cmodel.accuracy_policy_batch(self.val_batch, pb)
        self.dispatch_log.append("validate")
        rewards = compute_reward_batch(self.cfg.reward, accs, lats,
                                       self._ref_total_s)
        accs, lats, rewards = _read(accs, lats, rewards)
        warmup, sigmas = self._batch_schedule(first_episode, k)
        return self._push_and_record(
            list(range(first_episode, first_episode + k)), warmup, sigmas,
            policies_from_batch(self.specs, pb), states, actions, accs,
            lats, rewards)

    def _observe(self, states: np.ndarray):
        """The fused engine advances the norm on the device (above)."""

    def _mirror_norm(self, count, mean, var):
        """The host running norm takes the device's statistics."""
        self.agent.norm.count = float(np.asarray(count).reshape(-1)[0])
        self.agent.norm.mean = np.asarray(mean, np.float32)
        self.agent.norm.var = np.asarray(var, np.float32)
        self.agent._actor_host = None

    def _log_push(self):
        self.dispatch_log.append("push")

    def _flush_updates(self):
        """The queued budget as one update-graph replay (one graph per
        update count), once the ring holds a DDPG batch."""
        n = self._pending_updates
        self._pending_updates = 0
        if n > 0 and len(self.replay) >= self.agent.cfg.batch_size:
            self.dispatch_log.append("update")
            graph, idx = self._update_graph(n)
            self._fill_indices(idx, self.replay.size)
            graph()

    def _update_graph(self, n: int):
        hit = self._updates.get(n)
        if hit is None:
            agent = self.agent
            idx = torch.zeros((n, agent.cfg.batch_size), dtype=torch.int64,
                              device=self.device)
            fn = lambda: agent.adopt_state(update_chunk(
                agent.cfg, agent.state, self.replay.data, n,
                indices=idx)[0])
            hit = self._updates[n] = (graphs.Graph(
                "update", fn, self.device, writes=state_leaves(agent.state),
                pool=self._pool), idx)
        return hit

    # --------------------------------------------------------- epoch mode
    def _update_schedule(self, first_episode: int,
                         n_batches: int) -> tuple:
        """Per-batch update counts of an epoch, a static tuple: exactly
        the budgets ``_queue_updates`` / ``_flush_updates`` would run
        batch by batch (warmup from the episode indices, the ring-fill
        gate from the host size mirror, T*K pushes a batch). The mirror of
        the reference engine's method of the same name, which the parity
        tests compare with it; the engine itself reads ``_schedule_sizes``."""
        return tuple(n for n, _ in self._schedule_sizes(first_episode,
                                                        n_batches))

    def _schedule_sizes(self, first_episode: int, n_batches: int) -> list:
        """(update count, ring size after the batch's push) per batch."""
        K, T = self.batch_size, len(self.steps)
        cfg = self.agent.cfg
        size, cap = self.replay.size, self.replay.capacity
        out = []
        for e in range(n_batches):
            warmup, _ = self._batch_schedule(first_episode + e * K, K)
            n = cfg.updates_per_episode * int((~warmup).sum())
            size = min(size + T * K, cap)
            out.append((n if (n > 0 and size >= cfg.batch_size) else 0,
                        size))
        return out

    def _epoch_inputs(self, schedule: tuple, P: Optional[int] = None) -> dict:
        """Static tensors of an epoch: ``_draw_inputs`` with a leading E
        (after the population's P) and the replay indices of each batch,
        (n, batch_size) (P, n, batch_size), or None where n is 0."""
        lead = (len(schedule),) if P is None else (P, len(schedule))
        x = _draw_inputs(lead, len(self.steps), self.batch_size,
                         self.agent.cfg.action_dim, self.device)
        B, per = self.agent.cfg.batch_size, () if P is None else (P,)
        x["indices"] = [torch.zeros((*per, n, B), dtype=torch.int64,
                                    device=self.device) if n else None
                        for n in schedule]
        return x

    def _fill_epoch(self, x: dict, first_episode: int, sizes: list):
        """An epoch's schedule, draws and replay indices into this
        engine's static tensors (``x``: its own, or its slices of a
        population's), batch by batch in the per-batch engine's order."""
        K = self.batch_size
        for e, (n, size) in enumerate(sizes):
            self._set_schedule(x["sigmas"][e], x["warmup"][e],
                               first_episode + e * K, K)
            self._fill_draws(x["uniforms"][e], x["normals"][e])
            if n:
                self._fill_indices(x["indices"][e], size)

    def _epoch_member(self) -> tuple:
        """What the epoch updates and reads of this engine: (agent state,
        ring data, 0-d reference total seconds)."""
        return self.agent.state, self.replay.data, self._ref_total_s

    def _make_epoch_fn(self, schedule: tuple):
        return make_epoch_fn(
            self.agent.cfg, self.cfg.reward, self._rollout_fn,
            self.cmodel.accuracy_policy_fn(self.val_batch),
            len(self.steps), self.batch_size, schedule)

    def _epoch_graph(self, schedule: tuple):
        return _epoch_graph(self, self, schedule, self.agent.state,
                            self.replay.data, [self._epoch_member()],
                            self._tables())

    def run_epoch(self, first_episode: int,
                  n_batches: int) -> List[EpisodeRecord]:
        """E episode batches — rollout, validation, reward, ring write,
        updates, metrics — as one graph replay, then one readback that
        rehydrates the records."""
        if n_batches <= 0:
            return []
        self._flush_updates()           # epoch budgets are computed fresh
        sizes = self._schedule_sizes(first_episode, n_batches)
        _, graph, x = self._epoch_graph(tuple(n for n, _ in sizes))
        self._fill_epoch(x, first_episode, sizes)
        flat = graph()
        self.dispatch_log.append("epoch")
        host = flat.cpu().numpy()
        self.readbacks += 1
        return self._finish_epoch(first_episode, n_batches, host)

    def _epoch_flat_size(self, n_batches: int) -> int:
        """Floats of this engine's segment of an epoch's readback."""
        EK, L = n_batches * self.batch_size, len(self.specs)
        return 3 * EK + 3 * EK * L + 3 + 2 * self.agent.cfg.state_dim

    def _finish_epoch(self, first_episode: int, n_batches: int,
                      host: np.ndarray) -> List[EpisodeRecord]:
        """Advance the ring's host mirrors, take the norm statistics, and
        build the records from the epoch's readback (this engine's
        segment)."""
        cfg = self.cfg
        E, K, T = n_batches, self.batch_size, len(self.steps)
        L, S = len(self.specs), self.agent.cfg.state_dim
        self.replay.adopt(E * T * K)
        sizes = [E * K] * 3 + [E * K * L] * 3 + [1, S, S, 1, 1]
        parts, o = [], 0
        for n in sizes:
            parts.append(host[o:o + n])
            o += n
        accs, lats, rewards = (p.reshape(E, K) for p in parts[:3])
        keep, wb, ab = (p.reshape(E, K, L) for p in parts[3:6])
        count, mean, var, best_r, best_e = parts[6:]
        self._mirror_norm(count, mean, var)
        self.last_epoch_best = (first_episode + int(best_e[0]),
                                float(best_r[0]))
        denom = cfg.reward.target_ratio * self.ref_lat.total_s
        records = []
        for e in range(E):
            _, sigmas = self._batch_schedule(first_episode + e * K, K)
            pols = policies_from_batch(self.specs, PolicyBatch(
                keep=keep[e].astype(np.float64),
                w_bits=wb[e].astype(np.float64),
                a_bits=ab[e].astype(np.float64)))
            acc_l, lat_l, rew_l = (np.asarray(z[e], np.float64).tolist()
                                   for z in (accs, lats, rewards))
            for j in range(K):
                records.append(EpisodeRecord(
                    episode=first_episode + e * K + j, reward=rew_l[j],
                    accuracy=acc_l[j], latency_s=lat_l[j],
                    latency_ratio=lat_l[j] / denom,
                    macs_frac=pols[j].macs_fraction(self.specs),
                    bops=pols[j].bops(self.specs) if cfg.track_bops
                    else 0.0,
                    sigma=float(sigmas[j]), policy=pols[j]))
        return records

    def _chunk_size(self) -> int:
        if self.epoch_batches > 0:
            return self.batch_size * self.epoch_batches
        return self.batch_size

    def _run_chunk(self, first_episode: int,
                   k: int) -> List[EpisodeRecord]:
        if self.epoch_batches > 0:
            nb, rem = divmod(k, self.batch_size)
            recs = self.run_epoch(first_episode, nb) if nb else []
            if rem:       # trailing partial batch: the per-batch path
                recs += self.run_episode_batch(
                    first_episode + nb * self.batch_size, rem)
            return recs
        return self.run_episode_batch(first_episode, k)


# ===========================================================================
# Population: P member searches sharing their dispatches
# ===========================================================================

class PopulationSearch:
    """P member searches whose agents share every update dispatch.

    The paper's workload shape: the p/q/pq agents, and for hardware-
    specific policies one member per target, search side by side. At
    construction the population moves its members' agent states and
    replay rings into stacked (P, ·) tensors (``_stack_for_dispatch``)
    and rebinds each member's leaves to views of its slice, so the
    population's graphs and a member's own graphs read the same memory
    and nothing is copied per dispatch (a member's graphs captured
    before are dropped).

    Members roll out on their own (each already batched over K episodes)
    and queue their update budgets; when the budgets agree the
    population runs them as ONE megabatched update
    (``ddpg.population_update_chunk``: every product batched over the
    members, the fused Adam + Polyak kernel), one graph replay per update
    count, each member's replay indices drawn from its own generator in
    its solo order; budgets that diverge fall back to per-member
    flushes. Members must share one ``DDPGConfig`` (pad ``action_dim``
    to the population's maximum for mixed methods), one chunk size and
    one device.

    With ``fuse_rollouts=True``, ``FusedCompressionSearch`` members over
    the same specs / sensitivity table / context / window / methods /
    MXU alignment / calibration (the multi-target scenario, or several
    seeds) also share the rollout: one replay of the rollout over their
    stacked states, each member's hardware rates, latency shares and
    reference total as inputs (``make_rollout_fn``). Members that also
    share the model, the validation batch and the reward config, all in
    epoch mode, share whole epochs: one replay and one readback for all
    members per epoch, the validation of the P·K policies one forward
    (K1's device-bits entry once per site), each member's updates solo
    ``update_chunk``s inside it (K2, K3), as the JAX package's
    ``vmap(update_step)`` runs them. Incompatible members silently keep
    their own (still fused) dispatches. Every member logs each shared
    dispatch in its ``dispatch_log``; ``readbacks`` counts the shared
    epochs' device-to-host reads.
    """

    def __init__(self, members: Sequence[CompressionSearch],
                 fuse_rollouts: bool = False):
        if not members:
            raise ValueError("PopulationSearch needs at least one member")
        self.members = list(members)
        cfg0 = self.members[0].agent.cfg
        for m in self.members[1:]:
            if m.agent.cfg != cfg0:
                raise ValueError(
                    "population members must share a DDPGConfig (pad "
                    f"action_dim): {m.agent.cfg} != {cfg0}")
        if len({m._chunk_size() for m in self.members}) != 1:
            raise ValueError("population members must share a chunk size")
        devices = {m.agent.device for m in self.members}
        if len(devices) != 1:
            raise ValueError(f"population members must share one device, "
                             f"got {sorted(map(str, devices))}")
        self.device = devices.pop()
        self.fuse_rollouts = fuse_rollouts
        self.readbacks = 0
        self._fusable = None
        self._epoch_fusable = None
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self._rollouts: dict = {}      # k -> (graph, static inputs)
        self._updates: dict = {}       # n -> (graph, indices)
        self._epoch_cache: dict = {}   # (K, schedule, id(params)) -> ...
        self._stacked_tables = None
        self.state = self._stack_for_dispatch(
            [m.agent.state for m in self.members])
        self.ring = self._stack_for_dispatch(
            [m.replay.data for m in self.members])
        for i, m in enumerate(self.members):
            m.agent.state = index_state(self.state, i)
            m.replay.rebind(index_state(self.ring, i))
            if isinstance(m, FusedCompressionSearch):
                m._reset_graphs()      # their addresses are the old ones

    def _stack_for_dispatch(self, trees):
        """Stack per-member trees (agent states, rings, per-target
        tensors) along a new leading member axis, in new memory that the
        shared dispatches read (the JAX package's ``FleetSearch`` places
        it on a mesh; the port's refuses a mesh of several devices)."""
        return stack_states(trees)

    # ----------------------------------------------------------- fusion
    def _rollouts_fusable(self) -> bool:
        """One shared rollout needs one rollout function: the same spec
        list (identity: the oracle, legality and static tables are its
        constants), sensitivity table, context, window, methods (the step
        lists coincide), MXU alignment and calibration. Hardware rates
        and latency shares are inputs, so targets may differ."""
        if self._fusable is None:
            ms = self.members
            m0 = ms[0]
            self._fusable = all(isinstance(m, FusedCompressionSearch)
                                for m in ms) and \
                all(m.specs is m0.specs and m.sens is m0.sens
                    and m.ctx == m0.ctx
                    and m.cfg.window == m0.cfg.window
                    and m.cfg.methods == m0.cfg.methods
                    and m.hw.mxu_align == m0.hw.mxu_align
                    and m.calib is m0.calib
                    for m in ms[1:])
        return self._fusable

    def _epochs_fusable(self) -> bool:
        """A shared epoch also runs one validator and one reward: members
        must share the compressible model, the validation batch and the
        reward config (the per-target reference latency stays an input)
        and all run in epoch mode."""
        if self._epoch_fusable is None:
            ms = self.members
            m0 = ms[0]
            self._epoch_fusable = self._rollouts_fusable() and \
                all(getattr(m, "epoch_batches", 0) > 0 for m in ms) and \
                all(m.cmodel is m0.cmodel
                    and m.val_batch is m0.val_batch
                    and m.cfg.reward == m0.cfg.reward for m in ms[1:])
        return self._epoch_fusable

    def _member_tables(self) -> tuple:
        """The members' rollout inputs that differ by target (each
        engine's ``_tables``), stacked once: ``hwp`` with (P, 1, 1)
        fields, shares (P, T, 2), reference totals (P, 1)."""
        if self._stacked_tables is None:
            ms = self.members
            shares, ref_total = self._stack_for_dispatch(
                [list(m._tables()[1:]) for m in ms])
            self._stacked_tables = (
                stack_hw_params([m._tables()[0] for m in ms]), shares,
                ref_total.reshape(-1, 1))
        return self._stacked_tables

    def _run_fused_chunk(self, first_episode: int,
                         k: int) -> List[List[EpisodeRecord]]:
        """All members' rollouts as ONE replay, then each member's
        validation / ring write / records tail (``_finish_batch``)."""
        graph, x = self._rollout_graph(k)
        for i, m in enumerate(self.members):
            m._set_schedule(x["sigmas"][i], x["warmup"][i], first_episode,
                            k)
            m._fill_draws(x["uniforms"][i], x["normals"][i])
        outs = graph()
        for m in self.members:          # one shared dispatch, logged on each
            m.dispatch_log.append("rollout")
        return [m._finish_batch(first_episode, k, tuple(z[i] for z in outs))
                for i, m in enumerate(self.members)]

    def _rollout_graph(self, k: int):
        return _rollout_graph(self, self.members[0], k, lambda: self.state,
                              self._member_tables(), P=len(self.members))

    # ------------------------------------------------------- epoch mode
    def _epoch_graph(self, schedule: tuple):
        return _epoch_graph(self, self.members[0], schedule, self.state,
                            self.ring,
                            [m._epoch_member() for m in self.members],
                            self._member_tables(), P=len(self.members))

    def run_epoch(self, first_episode: int,
                  n_batches: int) -> List[List[EpisodeRecord]]:
        """All members' epochs — E batches x P members of rollout,
        validation, reward, ring write and updates — as ONE replay and ONE
        readback. Members whose update schedules diverge (they ran
        different histories) fall back to their own epoch replays."""
        if n_batches <= 0:
            return [[] for _ in self.members]
        for m in self.members:
            m._flush_updates()
        sizes = [m._schedule_sizes(first_episode, n_batches)
                 for m in self.members]
        scheds = {tuple(n for n, _ in s) for s in sizes}
        if len(scheds) != 1 or not self._epochs_fusable():
            return [m.run_epoch(first_episode, n_batches)
                    for m in self.members]
        _, graph, x = self._epoch_graph(scheds.pop())
        for i, (m, s) in enumerate(zip(self.members, sizes)):
            m._fill_epoch({key: [ix[i] if ix is not None else None
                                 for ix in v] if key == "indices" else v[i]
                           for key, v in x.items()}, first_episode, s)
        host = graph().cpu().numpy()
        self.readbacks += 1
        out, o = [], 0
        for m in self.members:          # one shared dispatch, logged on each
            m.dispatch_log.append("epoch")
            n = m._epoch_flat_size(n_batches)
            out.append(m._finish_epoch(first_episode, n_batches,
                                       host[o:o + n]))
            o += n
        return out

    def _run_epoch_chunk(self, first_episode: int,
                         k: int) -> List[List[EpisodeRecord]]:
        K = self.members[0].batch_size
        nb, rem = divmod(k, K)
        chunks = self.run_epoch(first_episode, nb) if nb \
            else [[] for _ in self.members]
        if rem:           # trailing partial batch: the per-batch fused path
            tail = self._run_fused_chunk(first_episode + nb * K, rem)
            chunks = [c + t for c, t in zip(chunks, tail)]
        return chunks

    def run(self, episodes: Optional[int] = None,
            verbose: bool = False) -> List[SearchResult]:
        """Run all members for the same episode count; returns one
        ``SearchResult`` per member, aligned with ``self.members``."""
        n = episodes or min(m.cfg.episodes for m in self.members)
        histories = [[] for _ in self.members]
        bests = [None for _ in self.members]
        saved = [m._defer_updates for m in self.members]
        try:
            for m in self.members:
                m._defer_updates = True
            e = 0
            while e < n:
                k = min(self.members[0]._chunk_size(), n - e)
                if self.fuse_rollouts and self._epochs_fusable():
                    chunks = self._run_epoch_chunk(e, k)
                elif self.fuse_rollouts and self._rollouts_fusable() \
                        and k <= self.members[0].batch_size:
                    chunks = self._run_fused_chunk(e, k)
                else:
                    # epoch members whose epochs can't be shared keep
                    # their own per-member epoch decomposition
                    chunks = [m._run_chunk(e, k) for m in self.members]
                for i, recs in enumerate(chunks):
                    for rec in recs:
                        histories[i].append(rec)
                        if bests[i] is None or rec.reward > bests[i].reward:
                            bests[i] = rec
                self._dispatch_updates()
                if verbose:
                    row = " ".join(
                        f"{m.cfg.methods}:{histories[i][-1].reward:+.3f}"
                        for i, m in enumerate(self.members))
                    print(f"  ep {e + k - 1:4d} rewards [{row}]")
                e += k
        finally:
            for m, flag in zip(self.members, saved):
                m._defer_updates = flag
        return [SearchResult(history=histories[i], best=bests[i],
                             ref_latency_s=m.ref_lat.total_s,
                             ref_accuracy=m.ref_acc)
                for i, m in enumerate(self.members)]

    # ---------------------------------------------------------- updates
    def _update_graph(self, n: int):
        hit = self._updates.get(n)
        if hit is None:
            cfg = self.members[0].agent.cfg
            idx = torch.zeros((len(self.members), n, cfg.batch_size),
                              dtype=torch.int64, device=self.device)
            fn = lambda: population_update_chunk(cfg, self.state, self.ring,
                                                 n, idx)
            hit = self._updates[n] = (graphs.Graph(
                "update", fn, self.device, writes=state_leaves(self.state),
                pool=self._pool), idx)
        return hit

    def _dispatch_updates(self):
        """One megabatched update replay for the whole population when the
        members' budgets agree and every ring holds a DDPG batch;
        per-member flushes otherwise."""
        ns = [m._pending_updates for m in self.members]
        ready = all(len(m.replay) >= m.agent.cfg.batch_size
                    for m in self.members)
        if len(set(ns)) == 1 and ns[0] > 0 and ready:
            graph, idx = self._update_graph(ns[0])
            for i, m in enumerate(self.members):
                m.agent.state_for_dispatch()
                m._fill_indices(idx[i], m.replay.size)
            graph()
            for m in self.members:
                m._pending_updates = 0
                m.agent._actor_host = None
                if isinstance(m, FusedCompressionSearch):
                    m.dispatch_log.append("update")   # shared dispatch
        else:
            for m in self.members:
                m._flush_updates()


# ===========================================================================
# Fleet: the population's epochs with checkpoints and resume
# ===========================================================================

class FleetSearch(PopulationSearch):
    """Population search with preemption-safe epoch checkpoints — search
    as a service (the JAX package's ``FleetSearch``).

    The members (``FusedCompressionSearch`` in epoch mode, of one epoch
    family) run whole shared epochs: one graph replay and one readback
    for all members an epoch (``PopulationSearch.run_epoch``). Every
    ``ckpt_every`` completed epochs the stacked carry is checkpointed
    through the atomic async writer (``checkpoint.checkpointing.
    save_async``, which returns with a finished host copy, so the next
    epoch's in-place updates never reach the writer): the stacked agent
    states (the host running-norm mirrors folded in), the stacked rings,
    and the state of both random streams of every member, the rollout
    draws' (``_rollout_gen``) and the replay indices' (``agent.
    sample_gen``), which the JAX package's carry holds as a rollout key
    and the agent state's key. The manifest's ``extra`` has the JAX
    package's keys: the epoch cursor, the mesh shape, per-member seeds,
    methods and ring ptr/size mirrors, the monitor's summary.
    ``restore_latest_checkpoint`` writes the newest intact checkpoint
    into the population's own tensors (never rebinding them: the
    members' views and every captured graph keep their addresses), sets
    the mirrors and the streams, and the next ``run_fleet`` continues
    from the saved cursor bit for bit. A ``StepMonitor`` times each epoch
    dispatch and flags stragglers (``monitor.summary()``).

    The fleet runs on one device. ``mesh`` is None, or a mesh (an object
    with ``axis_names`` and a ``shape`` mapping) that must have a
    ``data`` axis and span one device: the members stay stacked where
    they lie, as ``PopulationSearch`` stacks them
    (``distributed.sharding``: the identity placement); a mesh of
    several devices is refused.
    """

    def __init__(self, members: Sequence[CompressionSearch], mesh=None,
                 fuse_rollouts: bool = True, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 1, keep: int = 3,
                 ft_cfg: Optional[FaultToleranceConfig] = None):
        super().__init__(members, fuse_rollouts=fuse_rollouts)
        for m in self.members:
            if getattr(m, "epoch_batches", 0) <= 0:
                raise ValueError(
                    "FleetSearch members must be FusedCompressionSearch "
                    "in epoch mode (epoch_batches > 0)")
        if not self._epochs_fusable():
            raise ValueError(
                "FleetSearch members must share one epoch trace (same "
                "specs/sensitivity/context/methods/model/reward — vary "
                "seeds or hardware targets instead)")
        if mesh is not None and "data" not in mesh.axis_names:
            raise ValueError(
                f"FleetSearch mesh needs a 'data' axis to shard the "
                f"member dimension; got axes {mesh.axis_names}")
        if mesh is not None:
            population_shardings(self.state, mesh)   # refuses several
        self.mesh = mesh
        self.monitor = StepMonitor(ft_cfg or FaultToleranceConfig())
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = max(1, int(ckpt_every))
        self._ckpt = AsyncCheckpointer(ckpt_dir, keep=keep) \
            if ckpt_dir else None
        self.epoch_cursor = 0      # episodes completed (per member)
        self.epochs_run = 0        # epoch dispatches completed

    # ------------------------------------------------------- checkpointing
    def _fleet_carry(self) -> dict:
        """The checkpointable carry: the population's stacked agent
        states (``state_for_dispatch`` folds each member's host norm
        mirror in first) and rings, as dicts of their fields, and each
        member's two generator states (uint8 rows)."""
        for m in self.members:
            m.agent.state_for_dispatch()
        return {
            "agent": self.state._asdict(),
            "ring": self.ring._asdict(),
            "rollout_gen": torch.stack([m._rollout_gen.get_state()
                                        for m in self.members]),
            "sample_gen": torch.stack([m.agent.sample_gen.get_state()
                                       for m in self.members]),
        }

    def _manifest_extra(self) -> dict:
        return {
            "epoch_cursor": int(self.epoch_cursor),
            "epochs_run": int(self.epochs_run),
            "mesh_shape": dict(self.mesh.shape)
            if self.mesh is not None else None,
            "member_seeds": [int(m.cfg.seed) for m in self.members],
            "member_methods": [m.cfg.methods for m in self.members],
            "ring_ptr": [int(m.replay.ptr) for m in self.members],
            "ring_size": [int(m.replay.size) for m in self.members],
            "monitor": self.monitor.summary(),
        }

    def save_checkpoint(self, wait: bool = False):
        """Atomic async save of the stacked carry (one step per completed
        epoch). The host copy is taken now; the files are written in the
        background and the previous checkpoint stays intact until the
        new LATEST pointer lands."""
        if self._ckpt is None:
            raise ValueError("FleetSearch was built without ckpt_dir")
        save_async(self._ckpt, self.epochs_run, self._fleet_carry(),
                   self._manifest_extra())
        if wait:
            self._ckpt.wait()

    def restore_latest_checkpoint(self, directory: Optional[str] = None):
        """Restore the newest intact checkpoint into the fleet's own
        tensors. Returns the manifest extra, or None when no checkpoint
        exists; the next ``run_fleet`` continues bit for bit."""
        directory = directory or self.ckpt_dir
        if directory is None:
            raise ValueError("no checkpoint directory given")
        tree, _step, extra = restore_latest(directory, self._fleet_carry(),
                                            self.device)
        if tree is None:
            return None
        P = len(self.members)
        if len(extra.get("member_seeds", [])) != P:
            raise ValueError(
                f"checkpoint holds {len(extra.get('member_seeds', []))} "
                f"members, fleet has {P}")
        agent = AgentState(**tree["agent"])
        ring = DeviceReplayData(**tree["ring"])
        counts, means, vars_ = (x.cpu().numpy() for x in (
            agent.norm_count, agent.norm_mean, agent.norm_var))
        for i, m in enumerate(self.members):
            m.agent.adopt_state(index_state(agent, i))
            m._mirror_norm(counts[i], means[i], vars_[i])
            m.replay.load(index_state(ring, i), extra["ring_ptr"][i],
                          extra["ring_size"][i])
            # set_state reads a tensor's storage from its start: a row
            # of the stack must be copied into storage of its own first
            m._rollout_gen.set_state(tree["rollout_gen"][i].cpu().clone())
            m.agent.sample_gen.set_state(
                tree["sample_gen"][i].cpu().clone())
        self.epoch_cursor = int(extra["epoch_cursor"])
        self.epochs_run = int(extra["epochs_run"])
        return extra

    # --------------------------------------------------------- fleet loop
    def run_fleet(self, episodes: int,
                  verbose: bool = False) -> List[SearchResult]:
        """Run whole fleet epochs from ``self.epoch_cursor`` (0, or the
        restored checkpoint's cursor) until ``episodes`` total episodes
        per member, checkpointing every ``ckpt_every`` epochs. Histories
        cover only the episodes run by THIS call — a resumed fleet
        returns the post-restore tail."""
        K = self.members[0].batch_size
        E = self.members[0].epoch_batches
        if episodes % K:
            raise ValueError(
                f"episodes ({episodes}) must be a multiple of the "
                f"episode batch size ({K}) — fleets run whole batches")
        histories = [[] for _ in self.members]
        bests: List[Optional[EpisodeRecord]] = [None] * len(self.members)
        while self.epoch_cursor < episodes:
            nb = min(E, (episodes - self.epoch_cursor) // K)
            t0 = time.perf_counter()
            # run_epoch ends with the epoch's one blocking readback, so
            # this wall time covers the whole dispatch
            chunks = self.run_epoch(self.epoch_cursor, nb)
            self.epochs_run += 1
            self.monitor.record(self.epochs_run, time.perf_counter() - t0)
            self.epoch_cursor += nb * K
            for i, recs in enumerate(chunks):
                for rec in recs:
                    histories[i].append(rec)
                    if bests[i] is None or rec.reward > bests[i].reward:
                        bests[i] = rec
            if self._ckpt is not None and \
                    self.epochs_run % self.ckpt_every == 0:
                self.save_checkpoint()
            if verbose:
                row = " ".join(
                    f"{m.cfg.methods}:{histories[i][-1].reward:+.3f}"
                    for i, m in enumerate(self.members))
                print(f"  epoch {self.epochs_run:4d} "
                      f"ep {self.epoch_cursor:5d} rewards [{row}]")
        if self._ckpt is not None:
            self._ckpt.wait()
        return [SearchResult(history=histories[i], best=bests[i],
                             ref_latency_s=m.ref_lat.total_s,
                             ref_accuracy=m.ref_acc)
                for i, m in enumerate(self.members)]
