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
``PopulationSearch``, the megabatched population update and the fleet
engine wait for a later slice.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import graphs
from .constraints import legal_tables
from .ddpg import (DDPGAgent, DDPGConfig, agent_act_batch, copy_state,
                   observe_states_pure, state_leaves, update_chunk)
from .latency import (V5E, HardwareTarget, LatencyContext, fifo_cached,
                      get_device_oracle, policy_latency,
                      policy_latency_batch)
from .policy import (Policy, PolicyBatch, action_columns, map_actions,
                     map_actions_batch, n_actions, policies_from_batch,
                     stack_policies)
from .replay import DeviceReplay, device_replay_push
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


def make_rollout_fn(cfg: DDPGConfig, oracle, legal, tables, spec_steps,
                    cols: MethodCols):
    """The pure rollout the fused engine captures: ``rollout(st, keep0,
    wb0, ab0, sigmas, warmup, ref_total, uniforms, normals) -> (keep, wb,
    ab, states, actions, lats)``. Constants: the agent config, the
    device oracle, the legality tables, ``tables`` = the (T, S) static
    feature rows and (T, 2) shares on the device, the spec index of each
    step, the method columns. Inputs: the agent state, the (L,) reference
    policy rows, per-row sigmas (K,) and warmup flags (K,), the reference
    total (0-d), the draws (T, K, A) uniforms and (T, K, 16, A) normals.
    ``states`` / ``actions`` are (T, K, ·) in step order, ``lats`` the
    final policies' oracle latency: the whole episode environment,
    unrolled over the T steps (the JAX package's ``lax.scan``)."""
    static_tab, shares = tables

    def rollout(st, keep0, wb0, ab0, sigmas, warmup, ref_total, uniforms,
                normals):
        K, L = sigmas.shape[0], keep0.shape[-1]
        keep, wb, ab = (x.expand(K, L).clone() for x in (keep0, wb0, ab0))
        prev_a = sigmas.new_zeros((K, cfg.action_dim))
        states, actions = [], []
        for i, t in enumerate(spec_steps):
            unit_t, extra_t = oracle.unit_times(keep, wb, ab)
            decided = oracle.decided_before(unit_t, extra_t, t) / ref_total
            S = fused_state_block(static_tab[i], shares[i], decided, prev_a)
            A = agent_act_batch(cfg, st, S, sigmas, warmup, uniforms[i],
                                normals[i])
            new_keep, new_wb, new_ab = map_actions_batch(
                A, prune_dim=legal.prune_dim[t],
                granularity=legal.granularity[t],
                prunable=legal.prunable[t], quantizable=legal.quantizable[t],
                mix_ok=legal.mix_ok[t], ip=cols.ip, iw=cols.iw, ia=cols.ia)
            # single-method agents keep the other method's reference
            # parameters (the host engines' rule)
            if cols.do_p:
                keep[:, t] = new_keep
            if cols.do_q:
                wb[:, t] = new_wb
                ab[:, t] = new_ab
            states.append(S)
            actions.append(A)
            prev_a = A
        unit_t, extra_t = oracle.unit_times(keep, wb, ab)
        lats = oracle.totals(unit_t, extra_t)
        return (keep, wb, ab, torch.stack(states), torch.stack(actions),
                lats)

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
    (K, L) int32 tensors -> (K,) accuracies), the reward, the ring write
    and its ``schedule[e]`` updates, then the running best — the agent
    state and the ring updated in place from batch to batch.

    ``epoch(st, ring, keep0, wb0, ab0, sigmas, warmup, ref_total,
    ref_total_s, uniforms, normals, indices) -> (ys, best)`` with
    sigmas / warmup (E, K), the draws (E, T, K, ·), ``indices`` the
    (n, batch_size) replay indices of each batch (None where n is 0),
    ``ys = (accs, lats, rewards, keep, wb, ab)`` stacked (E, ...) and
    ``best = (reward, episode offset, (3, L) policy rows)``: the first
    strict maximum over the epoch's E*K episodes, the rule of ``run``'s
    host loop."""

    def epoch(st, ring, keep0, wb0, ab0, sigmas, warmup, ref_total,
              ref_total_s, uniforms, normals, indices):
        L = keep0.shape[-1]
        best_r = sigmas.new_full((), float("-inf"))
        best_e = torch.zeros((), dtype=torch.int64, device=sigmas.device)
        best_p = sigmas.new_zeros((3, L))
        ys = []
        for e, n in enumerate(schedule):
            keep, wb, ab, states, actions, lats = rollout_fn(
                st, keep0, wb0, ab0, sigmas[e], warmup[e], ref_total,
                uniforms[e], normals[e])
            # the normalizer advances at the batch boundary, as the host
            # engines' observe_states does
            observe_states_pure(st, states.reshape(T * K, -1))
            accs = acc_fn(*(x.to(torch.int32) for x in (keep, wb, ab)))
            rewards = compute_reward_batch(reward_cfg, accs, lats,
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
                copy_state(st, update_chunk(cfg, st, ring, n,
                                            indices=indices[e])[0])
            # the first maximum; a 0-d index would read j on the host
            r_j, j = torch.max(rewards, dim=0)
            better = r_j > best_r
            best_r = torch.where(better, r_j, best_r)
            best_e = torch.where(better, e * K + j, best_e)
            best_p = torch.where(better, torch.stack([keep, wb, ab], 1)
                                 .index_select(0, j.reshape(1))[0], best_p)
            ys.append((accs, lats, rewards, keep, wb, ab))
        ys = tuple(torch.stack(z) for z in zip(*ys))
        return ys, (best_r, best_e, best_p)

    return epoch


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
    of the same seed draw the same numbers in the same order.
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
        static, shares, self._ref_total = self.tables.to(device)
        ref_pb = stack_policies(self.specs, [self.ref_policy])
        self._ref_rows = tuple(
            torch.as_tensor(x[0], dtype=torch.float32, device=device)
            for x in (ref_pb.keep, ref_pb.w_bits, ref_pb.a_bits))
        self._ref_total_s = torch.tensor(self.ref_lat.total_s,
                                         dtype=torch.float32, device=device)
        self._cols = method_cols(search_cfg.methods)
        self._rollout_fn = make_rollout_fn(
            self.agent.cfg, self.oracle, legal_tables(self.specs, device),
            (static, shares), [int(t) for t in self.tables.spec_idx],
            self._cols)
        self._rollout_gen = torch.Generator(device=device).manual_seed(
            search_cfg.seed + 0x5EED)
        self._pool = torch.cuda.graph_pool_handle() \
            if device.type == "cuda" else None
        self._rollouts: dict = {}      # K -> (graph, static inputs)
        self._updates: dict = {}       # n -> (graph, indices)
        self._epoch_cache: dict = {}   # (K, schedule, id(params)) -> ...
        self.dispatch_log: List[str] = []
        self.readbacks = 0
        self.epoch_batches = max(0, epoch_batches)
        self.last_epoch_best: Optional[tuple] = None

    # ------------------------------------------------------------- draws
    def _fill_draws(self, uniforms: torch.Tensor, normals: torch.Tensor):
        """One batch's exploration draws, into its static tensors: (T, K,
        A) uniforms in [0, 1) and (T, K, 16, A) standard normals."""
        uniforms.uniform_(generator=self._rollout_gen)
        normals.normal_(generator=self._rollout_gen)

    def _fill_indices(self, indices: torch.Tensor, size: int):
        """One batch's replay indices, (n, batch_size), uniform over a
        filled prefix of ``size`` (the host mirror or the schedule's)."""
        indices.random_(0, max(size, 1), generator=self.agent.sample_gen)

    def _rollout_inputs(self, k: int) -> dict:
        T, A = len(self.steps), self.agent.cfg.action_dim
        f32 = dict(dtype=torch.float32, device=self.device)
        return {"sigmas": torch.empty((k,), **f32),
                "warmup": torch.empty((k,), dtype=torch.bool,
                                      device=self.device),
                "uniforms": torch.empty((T, k, A), **f32),
                "normals": torch.empty((T, k, 16, A), **f32)}

    def _rollout_graph(self, k: int):
        hit = self._rollouts.get(k)
        if hit is None:
            x = self._rollout_inputs(k)
            keep0, wb0, ab0 = self._ref_rows
            fn = lambda: self._rollout_fn(
                self.agent.state, keep0, wb0, ab0, x["sigmas"],
                x["warmup"], self._ref_total, x["uniforms"], x["normals"])
            hit = self._rollouts[k] = (graphs.Graph(
                "rollout", fn, self.device, pool=self._pool), x)
        return hit

    def _set_schedule(self, sigmas, warmup, first_episode: int, k: int):
        """A batch's sigmas and warmup flags into their static tensors."""
        warm, sig = self._batch_schedule(first_episode, k)
        sigmas.copy_(torch.as_tensor(sig))
        warmup.copy_(torch.as_tensor(warm))

    # --------------------------------------------------------- per batch
    def run_episode_batch(self, first_episode: int,
                          k: int) -> List[EpisodeRecord]:
        """The rollout as one replay, then the batch tail: the norm
        advanced on the device (``observe_states_pure``, as the epoch
        does, so the two modes agree), one read of the policies, states,
        actions and norm statistics, the validation on host bits, the
        reward on the device, the ring write and the update replay."""
        graph, x = self._rollout_graph(k)
        self._set_schedule(x["sigmas"], x["warmup"], first_episode, k)
        self._fill_draws(x["uniforms"], x["normals"])
        keep, wb, ab, states, actions, lats = graph()
        self.dispatch_log.append("rollout")
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
            agent, data = self.agent, self.replay.data
            idx = torch.zeros((n, agent.cfg.batch_size), dtype=torch.int64,
                              device=self.device)
            fn = lambda: agent.adopt_state(update_chunk(
                agent.cfg, agent.state, data, n, indices=idx)[0])
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

    def _epoch_inputs(self, schedule: tuple) -> dict:
        E, K, T = len(schedule), self.batch_size, len(self.steps)
        A, B = self.agent.cfg.action_dim, self.agent.cfg.batch_size
        f32 = dict(dtype=torch.float32, device=self.device)
        return {"sigmas": torch.empty((E, K), **f32),
                "warmup": torch.empty((E, K), dtype=torch.bool,
                                      device=self.device),
                "uniforms": torch.empty((E, T, K, A), **f32),
                "normals": torch.empty((E, T, K, 16, A), **f32),
                "indices": [torch.zeros((n, B), dtype=torch.int64,
                                        device=self.device) if n else None
                            for n in schedule]}

    def _make_epoch_fn(self, schedule: tuple):
        return make_epoch_fn(
            self.agent.cfg, self.cfg.reward, self._rollout_fn,
            self.cmodel.accuracy_policy_fn(self.val_batch),
            len(self.steps), self.batch_size, schedule)

    def _epoch_graph(self, schedule: tuple):
        """The epoch graph of a schedule, FIFO-cached (steady-state epochs
        share one schedule, hence one capture), keyed by the params
        object too: new weights capture anew."""
        params = self.cmodel.params

        def make():
            x = self._epoch_inputs(schedule)
            epoch = self._make_epoch_fn(schedule)
            keep0, wb0, ab0 = self._ref_rows
            st, ring = self.agent.state, self.replay.data

            def fn():
                ys, best = epoch(st, ring, keep0, wb0, ab0, x["sigmas"],
                                 x["warmup"], self._ref_total,
                                 self._ref_total_s, x["uniforms"],
                                 x["normals"], x["indices"])
                # one flat f32 buffer: the epoch's one readback
                flat = [z.reshape(-1).float() for z in ys]
                flat += [st.norm_count.reshape(1), st.norm_mean,
                         st.norm_var, best[0].reshape(1),
                         best[1].reshape(1).float()]
                return torch.cat(flat)

            g = graphs.Graph("epoch", fn, self.device,
                             writes=state_leaves(st) + list(ring),
                             pool=self._pool)
            return params, g, x

        return fifo_cached(self._epoch_cache, _EPOCH_CACHE_MAX,
                           (self.batch_size, schedule, id(params)),
                           lambda hit: hit[0] is params, make)

    def run_epoch(self, first_episode: int,
                  n_batches: int) -> List[EpisodeRecord]:
        """E episode batches — rollout, validation, reward, ring write,
        updates, metrics — as one graph replay, then one readback that
        rehydrates the records."""
        if n_batches <= 0:
            return []
        self._flush_updates()           # epoch budgets are computed fresh
        sizes = self._schedule_sizes(first_episode, n_batches)
        schedule = tuple(n for n, _ in sizes)
        _, graph, x = self._epoch_graph(schedule)
        K = self.batch_size
        for e in range(n_batches):
            self._set_schedule(x["sigmas"][e], x["warmup"][e],
                               first_episode + e * K, K)
            self._fill_draws(x["uniforms"][e], x["normals"][e])
            if schedule[e]:
                self._fill_indices(x["indices"][e], sizes[e][1])
        flat = graph()
        self.dispatch_log.append("epoch")
        host = flat.cpu().numpy()
        self.readbacks += 1
        return self._finish_epoch(first_episode, n_batches, host)

    def _finish_epoch(self, first_episode: int, n_batches: int,
                      host: np.ndarray) -> List[EpisodeRecord]:
        """Advance the ring's host mirrors, take the norm statistics, and
        build the records from the epoch's readback."""
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
