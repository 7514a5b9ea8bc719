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
(``SearchResult.measured``). The batched, fused, epoch, population and
fleet engines wait for later slices.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .ddpg import DDPGAgent, DDPGConfig
from .latency import V5E, HardwareTarget, LatencyContext, policy_latency
from .policy import Policy, map_actions, n_actions
from .replay import DeviceReplay
from .reward import RewardConfig, compute_reward
from .sensitivity import SensitivityResult, run_sensitivity
from .state import build_state, state_dim


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
            self.agent.update_chunk(self.replay,
                                    self.agent.cfg.updates_per_episode)

        ratio = lat.total_s / (cfg.reward.target_ratio *
                               self.ref_lat.total_s)
        return EpisodeRecord(
            episode=episode, reward=reward, accuracy=acc,
            latency_s=lat.total_s, latency_ratio=ratio,
            macs_frac=policy.macs_fraction(self.specs),
            bops=policy.bops(self.specs) if cfg.track_bops else 0.0,
            sigma=sigma, policy=policy)

    def run(self, episodes: Optional[int] = None,
            verbose: bool = False) -> SearchResult:
        n = episodes or self.cfg.episodes
        history: List[EpisodeRecord] = []
        best = None
        for e in range(n):
            rec = self.run_episode(e)
            history.append(rec)
            if best is None or rec.reward > best.reward:
                best = rec
            if verbose and (rec.episode % 10 == 0 or rec.episode == n - 1):
                print(f"  ep {rec.episode:4d} reward={rec.reward:+.4f} "
                      f"acc={rec.accuracy:.3f} "
                      f"lat_ratio={rec.latency_ratio:.3f} "
                      f"sigma={rec.sigma:.3f}")
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
