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
(``_queue_updates``). The fused, epoch, population and fleet engines
wait for later slices.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .ddpg import DDPGAgent, DDPGConfig
from .latency import (V5E, HardwareTarget, LatencyContext, policy_latency,
                      policy_latency_batch)
from .policy import Policy, map_actions, n_actions, stack_policies
from .replay import DeviceReplay
from .reward import RewardConfig, compute_reward, compute_reward_batch
from .sensitivity import SensitivityResult, run_sensitivity
from .spec import effective_bits
from .state import build_state, build_state_batch, state_dim


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

    def _flush_updates(self):
        """Run the queued update budget as one chunk, once the ring holds
        a DDPG batch."""
        n = self._pending_updates
        self._pending_updates = 0
        if n > 0 and len(self.replay) >= self.agent.cfg.batch_size:
            self.agent.update_chunk(self.replay, n)

    def _queue_updates(self, n: int):
        """Queue n updates and run them (a population of searches, a later
        slice, defers the flush to batch the members' chunks)."""
        self._pending_updates += n
        self._flush_updates()

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
        self.agent.observe_states(states.reshape(T * k, -1))
        nxt = np.concatenate([states[1:], states[-1:]])
        done = np.zeros((T, k), np.float32)
        done[-1] = 1.0

        def order(x):
            return x.swapaxes(0, 1).reshape(T * k, *x.shape[2:])

        self.replay.push_batch(
            order(states), order(actions),
            np.repeat(rewards, T).astype(np.float32),
            order(nxt), order(done))
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

    def _chunk_size(self) -> int:
        return self.batch_size

    def _run_chunk(self, first_episode: int,
                   k: int) -> List[EpisodeRecord]:
        return self.run_episode_batch(first_episode, k)
