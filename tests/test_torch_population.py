"""The port's population engine (``PopulationSearch``), its megabatched
update and its pieces against the JAX package, on the CPU (mirrors
``tests/test_update_floor.py``, ``tests/test_batched.py``,
``tests/test_fused.py`` and ``tests/test_epoch.py``; the graphs run
eagerly here, the card's capture and replay are held in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``).

Pieces and tolerances:
  * ``fused_adam_polyak_ref`` against the JAX ``_fused_adam_polyak`` on
    stacked leaves ≤1e-6 (f32 sums and pow in other orders); the
    kernel's wrapper on CPU tensors equals it exactly, in place.
  * the megabatched chunk (``population_update_chunk_megabatched``)
    against the JAX one and against the port's per-member path
    (``population_update_chunk_vmap``, P solo ``update_chunk``s) on the
    same states, rings (mixed fills and write positions) and replay
    indices, P 1 and 3: every state leaf and loss ≤1e-5, as the JAX tests
    hold the two JAX paths; three chunks in a row ≤1e-4. The router takes
    the megabatched path for the paper's trunk and the per-member one
    for another depth (whose solo chunks refuse it, as the port refuses
    any trunk but the paper's).
  * ``unit_times`` / ``totals`` with member-stacked ``hwp`` (V5E and the
    JAX tests' tpu-v5p) against the JAX oracle per target ≤1e-6
    relative, and equal to the port's oracle run per target.
  * ``mlp3_members_ref`` against P solo ``mlp3_ref`` calls, exact.
  * ``PopulationSearch`` against the JAX ``PopulationSearch``, fed the
    JAX replay indices (and the fused members' batch keys' draws),
    starting from the JAX agents: mixed p / q / pq batched members over
    6 episodes (shared megabatched updates), and fused members across
    two targets with shared rollouts: the tolerances of
    ``tests/test_fused.py`` (policies equal, accuracy 1e-6, latency
    1e-6 relative, reward 1e-5) and equal ``dispatch_log``s.
  * the port's epoch population against its per-batch population and
    against each member run alone on the same seed: exact on the CPU
    (the same operations on the same numbers; the card's stacked
    products are held in ``chip_smoke.py``).
  * fallbacks (mixed methods keep their own rollouts, unequal reward
    configs their own epochs), the refused constructions, and the
    members' tensors still views of the stacked ones after a run
    (``data_ptr``).

The exact equalities of records here, like those of the other search
parity tests, rest on these draws: a last-bit difference in a
compressed forward can move a whole fake-quant step, and through the
accuracy a reward (``tests/test_torch_flips.py`` bounds it over many
draws).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import ddpg as jddpg  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.replay import DeviceReplay as JReplay  # noqa: E402
from repro.core.reward import RewardConfig  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.models import model as M  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import reward as treward  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.adam_polyak import adam_polyak_  # noqa: E402
from repro_torch.kernels.ref import (fused_adam_polyak_ref,  # noqa: E402
                                     mlp3_members_ref, mlp3_ref)

from test_torch_fused import (CTX, TINY, _cmps, _port_cfg,  # noqa: E402
                              _sens_pair, _spec_pairs, _t, jax_draws,
                              random_policies)

V5P = dict(name="tpu-v5p", peak_bf16=459e12, peak_int8=918e12,
           hbm_bw=2765e9, ici_bw=90e9)
CFG = dict(state_dim=10, action_dim=6, hidden=(32, 24), batch_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of small CPU ops; with several test
    workers on one box, torch's intra-op thread pool makes each op wait
    for all its threads to be scheduled (a loaded box ran this module
    many times slower). One thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _max_err(a, b) -> float:
    """Largest |difference| over the leaves of two (port) states."""
    return max(float((x - y).abs().max()) for x, y in
               zip(tddpg.state_leaves(a), tddpg.state_leaves(b)))


def _jax_max_err(tstate, jstate) -> float:
    """Largest |difference| between a port state and a JAX one."""
    want = convert.agent_state(jax.device_get(jstate), device="cpu")
    return _max_err(tstate, want)


# ------------------------------------------------------- fused Adam + Polyak

def test_fused_adam_polyak_ref_matches_jax_and_wrapper_in_place():
    """Stacked leaves of a 3-member network at step counts 0, 7 and 99:
    the plain version against the JAX pass ≤1e-6, the step counts +1;
    the wrapper on CPU tensors writes exactly the plain version's values
    in place (p, m, v, target) and advances t."""
    rng = np.random.default_rng(0)
    P, shapes = 3, [(24,), (10, 24), (6,), (24, 6)]
    lv = [tuple((rng.standard_normal((P, *sh)) * s).astype(np.float32)
                for s in (0.05, 1e-3, 1e-3, 1e-2, 0.05)) for sh in shapes]
    lv = [(p, m, v * v, g, tg) for p, m, v, g, tg in lv]
    t = np.asarray([0, 7, 99], np.int32)
    params = [{"w": p} for p, *_ in lv]
    grads = [{"w": g} for _, _, _, g, _ in lv]
    st = {"m": [{"w": m} for _, m, *_ in lv],
          "v": [{"w": v} for _, _, v, *_ in lv], "t": jnp.asarray(t)}
    target = [{"w": tg} for *_, tg in lv]
    jp, jst, jtg = jax.jit(jddpg._fused_adam_polyak, static_argnums=(4, 5))(
        params, grads, st, target, 1e-3, 0.01)
    leaves = [tuple(torch.from_numpy(x.copy()) for x in leaf) for leaf in lv]
    new, t2 = fused_adam_polyak_ref(leaves, torch.from_numpy(t), 1e-3, 0.01)
    assert t2.tolist() == [1, 8, 100] == np.asarray(jst["t"]).tolist()
    for i, (p2, m2, v2, tg2) in enumerate(new):
        for got, want in ((p2, jp[i]["w"]), (m2, jst["m"][i]["w"]),
                          (v2, jst["v"][i]["w"]), (tg2, jtg[i]["w"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)
    tt = torch.from_numpy(t.copy())
    adam_polyak_(leaves, tt, 1e-3, 0.01)
    assert torch.equal(tt, t2)
    for leaf, upd in zip(leaves, new):
        for got, want in zip(leaf[:3] + leaf[4:], upd):
            assert torch.equal(got, want)


def test_mlp3_members_ref_is_solo_calls():
    """Member p of the member form is ``mlp3_ref`` on member p's slices,
    bit for bit (actor and critic heads)."""
    rng = np.random.default_rng(1)
    P, dims = 3, (10, 32, 24, 6)
    ws = [torch.from_numpy((rng.standard_normal((P, a, b)) / np.sqrt(a))
                           .astype(np.float32))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.standard_normal((P, b)).astype(np.float32))
          for b in dims[1:]]
    x = torch.from_numpy(rng.standard_normal((P, 5, 10)).astype(np.float32))
    flat = [ws[0], bs[0], ws[1], bs[1], ws[2], bs[2]]
    for sig in (True, False):
        got = mlp3_members_ref(x, *flat, sig)
        for p in range(P):
            want = mlp3_ref(x[p], *(t[p] for t in flat), sig)
            for g, w in zip(got, want):
                assert torch.equal(g[p], w)


# ------------------------------------------------------ the megabatched step

def _population(P, seed=0, cap=120, fill=90, **over):
    """The JAX tests' population: P agents from ``PRNGKey(seed + p)``,
    rings of mixed fills (and so write positions) of random
    transitions. Returns (JAX cfg, port cfg, JAX stacked states, JAX
    stacked rings)."""
    cfg = jddpg.DDPGConfig(**{**CFG, **over})
    rng = np.random.default_rng(seed)
    states, rings = [], []
    for p in range(P):
        st = jddpg.agent_init(cfg, jax.random.PRNGKey(seed + p))
        st = st._replace(
            norm_mean=jnp.asarray(rng.standard_normal(cfg.state_dim),
                                  jnp.float32),
            norm_var=jnp.asarray(rng.random(cfg.state_dim) + 0.5,
                                 jnp.float32))
        rep = JReplay(cap, cfg.state_dim, cfg.action_dim)
        for _ in range(fill - 17 * (p % 3)):
            rep.push(rng.standard_normal(cfg.state_dim).astype(np.float32),
                     rng.uniform(size=cfg.action_dim).astype(np.float32),
                     float(rng.standard_normal()),
                     rng.standard_normal(cfg.state_dim).astype(np.float32),
                     float(rng.integers(0, 2)))
        states.append(st)
        rings.append(rep.data)
    tcfg = tddpg.DDPGConfig(**{**CFG, **over})
    return cfg, tcfg, jddpg.tree_stack(states), jddpg.tree_stack(rings)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_idx(keys, sizes, n, batch):
    def member(key, size):
        _, ks = jddpg.chunk_sample_keys(key, n)
        return jax.vmap(lambda k: jax.random.randint(
            k, (batch,), 0, jnp.maximum(size, 1)))(ks)
    return jax.vmap(member)(keys, sizes)


def _jax_indices(states, rings, n, batch):
    """The (P, n, batch) replay indices a JAX population chunk draws:
    member p's ``chunk_sample_keys`` of its key, each step's uniform
    ``randint`` over its filled prefix (``device_replay_sample``)."""
    return torch.as_tensor(np.asarray(_jax_idx(states.key, rings.size, n,
                                               batch)).astype(np.int64))


def _port_pair(states, rings):
    ts = convert.agent_state(jax.device_get(states), device="cpu")
    tr = convert.replay_data(jax.device_get(rings), device="cpu")
    return ts, tr


_jmega = jax.jit(jddpg._mega_chunk, static_argnums=(0, 3))


@pytest.mark.parametrize("P", [1, 3])
def test_megabatched_chunk_matches_jax_and_per_member(P):
    """One chunk of 5 steps: the port's megabatched chunk against the JAX
    megabatched chunk and against P solo ``update_chunk``s on the same
    indices, every state leaf and the (P, n) losses ≤1e-5; the Adam step
    counts advance by n, the rings are untouched."""
    jcfg, tcfg, states, rings = _population(P, seed=P)
    n = 5
    idx = _jax_indices(states, rings, n, CFG["batch_size"])
    js, (jlc, jla) = _jmega(jcfg, states, rings, n)
    ts, tr = _port_pair(states, rings)
    ring_before = [x.clone() for x in tr]
    got, (lc, la) = tddpg.population_update_chunk_megabatched(
        tcfg, ts, tr, n, idx)
    assert got is ts and lc.shape == la.shape == (P, n)
    assert _jax_max_err(ts, js) <= 1e-5
    np.testing.assert_allclose(lc.numpy(), np.asarray(jlc), atol=1e-5)
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), atol=1e-5)
    assert ts.opt_a["t"].tolist() == ts.opt_c["t"].tolist() == [n] * P
    assert all(torch.equal(a, b) for a, b in zip(tr, ring_before))
    ref, _ = _port_pair(states, rings)
    _, (vlc, vla) = tddpg.population_update_chunk_vmap(tcfg, ref, tr, n, idx)
    assert _max_err(ts, ref) <= 1e-5
    assert float((vlc - lc).abs().max()) <= 1e-5
    assert float((vla - la).abs().max()) <= 1e-5


def test_megabatched_three_chunks_stay_on_the_per_member_trajectory():
    """Three chunks of 2 through each path (4 members): within 1e-4."""
    jcfg, tcfg, states, rings = _population(4, seed=42)
    a, tr = _port_pair(states, rings)
    b, _ = _port_pair(states, rings)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        idx = torch.randint(0, 73, (4, 2, CFG["batch_size"]), generator=gen)
        tddpg.population_update_chunk_megabatched(tcfg, a, tr, 2, idx)
        tddpg.population_update_chunk_vmap(tcfg, b, tr, 2, idx)
    assert _max_err(a, b) <= 1e-4


@pytest.mark.parametrize("hidden", [(32, 24), (32, 24, 16)])
def test_router_takes_the_megabatched_path_for_the_paper_trunk(
        hidden, monkeypatch):
    """The paper's trunk (two hidden layers) goes the megabatched way
    (one fused Adam + Polyak call a network a step); another depth the
    per-member way, whose solo chunks refuse a trunk K2 does not compute
    (``tests/test_torch_agent.py``), before any Adam step."""
    jcfg, tcfg, states, rings = _population(2, hidden=hidden)
    calls = []
    real = tddpg.adam_polyak_
    monkeypatch.setattr(tddpg, "adam_polyak_",
                        lambda *a, **k: (calls.append(1), real(*a, **k)))
    ts, tr = _port_pair(states, rings)
    idx = torch.randint(0, 50, (2, 2, CFG["batch_size"]),
                        generator=torch.Generator().manual_seed(1))
    if len(hidden) != 2:
        with pytest.raises(ValueError, match="3 layers"):
            tddpg.population_update_chunk(tcfg, ts, tr, 2, idx)
        assert not calls
        return
    got, (lc, _) = tddpg.population_update_chunk(tcfg, ts, tr, 2, idx)
    assert got is ts and lc.shape == (2, 2)
    assert len(calls) == 2 * 2


def test_stacked_state_views_and_converter():
    """``index_state`` gives views that write into the stack;
    ``stack_states`` of the members equals the converted JAX stack."""
    _, tcfg, states, rings = _population(3)
    ts, tr = _port_pair(states, rings)
    members = [tddpg.index_state(ts, i) for i in range(3)]
    again = tddpg.stack_states(members)
    assert all(torch.equal(x, y) for x, y in zip(tddpg.state_leaves(again),
                                                 tddpg.state_leaves(ts)))
    members[1].actor[0]["w"].add_(1.0)
    assert torch.equal(ts.actor[0]["w"][1], members[1].actor[0]["w"])
    assert members[2].opt_a["t"].dim() == 0
    assert tddpg.index_state(tr, 2).states.data_ptr() == \
        tr.states[2].data_ptr()


# ----------------------------------------------------------------- oracle

def test_device_oracle_hwp_matches_jax_per_target():
    """``unit_times`` / ``totals`` / ``decided_before`` over a (2, K, L)
    block with the two targets' rates stacked against the JAX oracle
    given each target's ``hwp`` ≤1e-6 relative, and equal to the port's
    own oracle of each target on its K rows."""
    specs_j, specs_t = _spec_pairs()[0]
    ctx = tlat.LatencyContext(**CTX)
    targets = (tlat.V5E, tlat.HardwareTarget(**V5P))
    jo = jlat.get_jax_oracle(specs_j, jlat.V5E, jlat.LatencyContext(**CTX))
    to = tlat.get_device_oracle(specs_t, tlat.V5E, ctx)
    hwps = [tlat.hw_params(hw) for hw in targets]
    stacked = tlat.stack_hw_params(hwps)
    assert stacked.peak_bf16.shape == (2, 1, 1)
    keep, wb, ab = random_policies(specs_j, 5, 3)
    block = [torch.from_numpy(np.stack([x, x])) for x in (keep, wb, ab)]
    tu, te = to.unit_times(*block, stacked)
    tt = to.totals(tu, te, stacked)
    assert tt.shape == (2, 5)
    for i, hw in enumerate(targets):
        jhw = jlat.hw_params(jlat.HardwareTarget(**V5P) if i else jlat.V5E)
        ju, je = jax.jit(jo.unit_times)(keep, wb, ab, jhw)
        np.testing.assert_allclose(tu[i].numpy(), np.asarray(ju), rtol=1e-6)
        np.testing.assert_allclose(tt[i].numpy(),
                                   np.asarray(jo.totals(ju, je, jhw)),
                                   rtol=1e-6)
        own = tlat.get_device_oracle(specs_t, hw, ctx)
        ou, oe = own.unit_times(_t(keep), _t(wb), _t(ab))
        assert torch.equal(ou, tu[i]) and torch.equal(own.totals(ou, oe),
                                                      tt[i])
        for t in (0, 3, len(specs_t)):
            assert torch.equal(to.decided_before(tu, te, t)[i],
                               own.decided_before(ou, oe, t))


# ------------------------------------------------------------ the engines

EPISODES, K, WARMUP, UPDATES, BATCH = 6, 3, 2, 2, 16
REWARD = dict(target_ratio=0.5, beta=-3.0)


@pytest.fixture(scope="module")
def lm():
    cfg = ArchConfig(**TINY, compute_dtype="float32")
    params = M.init(cfg, jax.random.PRNGKey(0))
    tcfg = _port_cfg(cfg)
    tm = tcompress.CompressibleLM(
        tcfg, convert.lm_params(tcfg, jax.device_get(params), device="cpu"))
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3)
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    jsens, tsn = _sens_pair(tm.specs, 11)
    return CompressibleLM(cfg, params), tm, batch, tb, jsens, tsn


def _cfgs(methods, episodes=EPISODES, action_dim=3, **reward):
    ddpg = dict(warmup_episodes=WARMUP, updates_per_episode=UPDATES,
                batch_size=BATCH, buffer_size=256, hidden=(32, 24),
                action_dim=action_dim)
    rw = {**REWARD, **reward}
    return (jsearch.SearchConfig(methods=methods, episodes=episodes, seed=0,
                                 reward=RewardConfig(**rw),
                                 ddpg=jddpg.DDPGConfig(**ddpg)),
            tsearch.SearchConfig(methods=methods, episodes=episodes, seed=0,
                                 reward=treward.RewardConfig(**rw),
                                 ddpg=tddpg.DDPGConfig(**ddpg)))


def _fed_populations(lm, make_pair, methods_hw, fuse):
    """A JAX population and the port's of the same members (the JAX
    agents carried over), run for EPISODES: every JAX shared update's
    replay indices and every fused member's batch-key draws recorded and
    fed to the port's members in the same order. Returns (JAX
    population, port population, JAX results, port results, shared
    update counts)."""
    pairs = [make_pair(lm, *mh) for mh in methods_hw]
    jpop = jsearch.PopulationSearch([j for j, _ in pairs],
                                    fuse_rollouts=fuse)
    for j, t in pairs:
        t.agent.state = convert.agent_state(jax.device_get(j.agent.state),
                                            device="cpu")
    tpop = tsearch.PopulationSearch([t for _, t in pairs],
                                    fuse_rollouts=fuse)
    fed = [[] for _ in pairs]
    keys = [[] for _ in pairs]
    shared = []
    real = jsearch.population_update_chunk

    def recording(cfg, states, rings, n, donate=False):
        shared.append(n)
        idx = _jax_indices(states, rings, n, BATCH)
        for i in range(len(pairs)):
            fed[i].append(idx[i])
        return real(cfg, states, rings, n, donate=donate)

    for i, (j, _) in enumerate(pairs):
        if hasattr(j, "_rollout_args"):
            def args(first, k, j=j, i=i, _real=j._rollout_args):
                out = _real(first, k)
                keys[i].append((j._last_batch_key, k))
                return out
            j._rollout_args = args
    jsearch.population_update_chunk = recording
    try:
        jr = jpop.run(episodes=EPISODES)
    finally:
        jsearch.population_update_chunk = real
    for i, (_, t) in enumerate(pairs):
        queue = list(fed[i])

        def fed_indices(indices, size, q=queue):
            idx = q.pop(0)
            assert tuple(idx.shape) == tuple(indices.shape) and \
                int(idx.max()) < size
            indices.copy_(idx)

        t._fill_indices = fed_indices
        if keys[i]:
            T, A = len(t.steps), t.agent.cfg.action_dim
            draws = [jax_draws(key, T, k, A) for key, k in keys[i]]

            def fed_draws(uniforms, normals, d=draws):
                uni, nrm = d.pop(0)
                uniforms.copy_(_t(uni))
                normals.copy_(_t(nrm))

            t._fill_draws = fed_draws
    tr = tpop.run(episodes=EPISODES)
    return jpop, tpop, jr, tr, shared


def _check_records(tr, jr):
    """The tolerances of ``tests/test_fused.py`` per member."""
    for t, j in zip(tr, jr):
        assert [r.episode for r in t.history] == list(range(EPISODES))
        for a, b in zip(t.history, j.history):
            assert _cmps(a.policy) == _cmps(b.policy), f"episode {b.episode}"
            np.testing.assert_allclose(a.accuracy, b.accuracy, atol=1e-6)
            np.testing.assert_allclose(a.latency_s, b.latency_s, rtol=1e-6)
            np.testing.assert_allclose(a.reward, b.reward, atol=1e-5)
            assert a.sigma == pytest.approx(b.sigma, rel=1e-6)


def _batched_pair(lm, methods, hw=None):
    jcm, tcm, jb, tb, jsens, tsn = lm
    jc, tc = _cfgs(methods)
    ctx = dict(CTX)
    return (jsearch.BatchedCompressionSearch(
        jcm, jb, jc, jlat.LatencyContext(**ctx), sens=jsens, batch_size=K),
        tsearch.BatchedCompressionSearch(
            tcm, tb, tc, tlat.LatencyContext(**ctx), sens=tsn,
            batch_size=K))


def _fused_pair(lm, methods, hw=None, epoch_batches=0):
    jcm, tcm, jb, tb, jsens, tsn = lm
    jc, tc = _cfgs(methods, action_dim=3)
    jhw = jlat.HardwareTarget(**V5P) if hw else jlat.V5E
    thw = tlat.HardwareTarget(**V5P) if hw else tlat.V5E
    return (jsearch.FusedCompressionSearch(
        jcm, jb, jc, jlat.LatencyContext(**CTX), hw=jhw, sens=jsens,
        batch_size=K),
        tsearch.FusedCompressionSearch(
            tcm, tb, tc, tlat.LatencyContext(**CTX), hw=thw, sens=tsn,
            batch_size=K, epoch_batches=epoch_batches))


@pytest.fixture(scope="module")
def batched_pops(lm):
    return _fed_populations(lm, _batched_pair,
                            [("p",), ("q",), ("pq",)], fuse=False)


@pytest.fixture(scope="module")
def fused_pops(lm):
    return _fed_populations(lm, _fused_pair,
                            [("pq", False), ("pq", True)], fuse=True)


def test_batched_population_matches_jax(batched_pops):
    """p, q and pq batched members (action_dim padded to 3) over 6
    episodes: records per member as the JAX population's; the updates
    ran as shared megabatched chunks (2 live episodes, then 3), none per
    member; every member's final agent state within 1e-5 of JAX's."""
    jpop, tpop, jr, tr, shared = batched_pops
    _check_records(tr, jr)
    assert shared == [UPDATES * 1, UPDATES * 3]
    for j, t in zip(jpop.members, tpop.members):
        assert t._pending_updates == 0 and not t._defer_updates
        assert _jax_max_err(t.agent.state, j.agent.state) <= 1e-5
        assert (t.replay.ptr, t.replay.size) == (j.replay.ptr,
                                                 j.replay.size)
    assert len({m.agent.cfg.action_dim for m in tpop.members}) == 1


def test_fused_population_across_targets_matches_jax(fused_pops):
    """Two fused members, V5E and tpu-v5p, with shared rollouts: records
    as the JAX population's, the same dispatch logs (per batch "rollout",
    "validate", "push", "update": every dispatch shared), the targets'
    latencies differ."""
    jpop, tpop, jr, tr, shared = fused_pops
    _check_records(tr, jr)
    assert tpop._rollouts_fusable() and not tpop._epochs_fusable()
    for j, t in zip(jpop.members, tpop.members):
        assert t.dispatch_log == j.dispatch_log == [
            "rollout", "validate", "push", "update"] * 2
    assert tr[0].history[0].latency_s != tr[1].history[0].latency_s
    assert shared == [UPDATES * 1, UPDATES * 3]


def test_member_tensors_stay_views_of_the_stack(batched_pops, fused_pops):
    """After the runs each member's agent and ring tensors still start
    where member i's slice of the population's stacked tensors does."""
    for pops in (batched_pops, fused_pops):
        tpop = pops[1]
        leaves = tddpg.state_leaves(tpop.state)
        for i, m in enumerate(tpop.members):
            for mine, stacked in zip(tddpg.state_leaves(m.agent.state),
                                     leaves):
                assert mine.data_ptr() == stacked[i].data_ptr()
            for mine, stacked in zip(m.replay.data, tpop.ring):
                assert mine.data_ptr() == stacked[i].data_ptr()
            assert m.replay.states.data_ptr() == tpop.ring.states[
                i].data_ptr()


def _port_member(lm, hw=None, epoch_batches=0, episodes=12, **reward):
    _, tcm, _, tb, _, tsn = lm
    _, tc = _cfgs("pq", episodes=episodes, **reward)
    thw = tlat.HardwareTarget(**V5P) if hw else tlat.V5E
    return tsearch.FusedCompressionSearch(
        tcm, tb, tc, tlat.LatencyContext(**CTX), hw=thw, sens=tsn,
        batch_size=K, epoch_batches=epoch_batches)


def _exact(ha, hb):
    assert len(ha) == len(hb)
    for a, b in zip(ha, hb):
        assert (a.reward, a.accuracy, a.latency_s, _cmps(a.policy)) == (
            b.reward, b.accuracy, b.latency_s, _cmps(b.policy))


def test_epoch_population_matches_per_batch_population_and_solo(lm):
    """Two targets in epoch mode (E 2, 12 episodes): one shared "epoch"
    dispatch and one readback per epoch, records equal to the per-batch
    population's and to each member run alone, exactly; the agent
    states too."""
    epop = tsearch.PopulationSearch([_port_member(lm, hw, 2)
                                     for hw in (False, True)],
                                    fuse_rollouts=True)
    assert epop._epochs_fusable()
    er = epop.run(episodes=12)
    assert epop.readbacks == 2
    for m in epop.members:
        assert m.dispatch_log == ["epoch", "epoch"]
    bpop = tsearch.PopulationSearch([_port_member(lm, hw)
                                     for hw in (False, True)],
                                    fuse_rollouts=True)
    br = bpop.run(episodes=12)
    for hw, e, b, em in zip((False, True), er, br, epop.members):
        _exact(e.history, b.history)
        solo = _port_member(lm, hw, 2)
        _exact(e.history, solo.run(episodes=12).history)
        assert _max_err(em.agent.state, solo.agent.state) == 0.0


def test_fallbacks_and_refused_populations(lm):
    """Mixed methods keep their own (fused) rollouts with shared
    updates; unequal reward configs keep their own epochs; an empty
    population, members of other DDPG configs or chunk sizes are
    refused."""
    _, tcm, _, tb, _, tsn = lm

    def member(methods, eb=0, ratio=0.5):
        _, tc = _cfgs(methods, episodes=K, target_ratio=ratio)
        return tsearch.FusedCompressionSearch(
            tcm, tb, tc, tlat.LatencyContext(**CTX), sens=tsn,
            batch_size=K, epoch_batches=eb)

    pop = tsearch.PopulationSearch([member(m) for m in ("p", "q", "pq")],
                                   fuse_rollouts=True)
    assert not pop._rollouts_fusable()
    res = pop.run(episodes=K)
    assert [len(r.history) for r in res] == [K] * 3
    pop = tsearch.PopulationSearch([member("pq", 2), member("pq", 2, 0.6)],
                                   fuse_rollouts=True)
    assert pop._rollouts_fusable() and not pop._epochs_fusable()
    pop.run(episodes=2 * K)
    assert [m.dispatch_log for m in pop.members] == [["epoch"]] * 2
    assert pop.readbacks == 0
    with pytest.raises(ValueError, match="at least one"):
        tsearch.PopulationSearch([])
    _, native = _cfgs("p", action_dim=1)
    other = tsearch.BatchedCompressionSearch(
        tcm, tb, native, tlat.LatencyContext(**CTX), sens=tsn,
        batch_size=K)
    with pytest.raises(ValueError, match="DDPGConfig"):
        tsearch.PopulationSearch([member("pq"), other])
    with pytest.raises(ValueError, match="chunk size"):
        tsearch.PopulationSearch([member("pq"), member("pq", 2)])


def test_population_launch_counts_on_cpu(lm):
    """On the CPU no kernel launches (every wrapper takes its plain
    version); the population's update runs the megabatched step, whose
    fused Adam + Polyak runs through its wrapper."""
    build.reset_launches()
    calls = []
    real = tddpg.adam_polyak_
    tddpg.adam_polyak_ = lambda *a, **k: (calls.append(1), real(*a, **k))
    try:
        pop = tsearch.PopulationSearch([_port_member(lm, hw, episodes=K * 2)
                                        for hw in (False, True)],
                                       fuse_rollouts=True)
        pop.run(episodes=2 * K)
    finally:
        tddpg.adam_polyak_ = real
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert len(calls) == 2 * UPDATES * (1 + 3)


def test_chip_smoke_population_phase_on_cpu():
    """``chip_smoke.py``'s population phase at a small size on the CPU
    (the graphs' functions eager, plain versions in place of the kernels,
    so the launch checks are fed the counts a run would make): the
    ResNet p / q / pq population with every step of every shared update
    chunk held to the per-member steps from the same state, the LM's
    two-target epoch population held to its eager run and to its members
    alone, K1's device-bits entry at every site of its last P·K-slot
    validation, the steady chunks and the fused sensitivity against the
    per-probe path; a wrong count is refused."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from repro_torch.configs.testbed import LM_CFG
    from repro_torch.core import sensitivity as tsens
    from repro_torch.models import resnet as TR
    cfg = LM_CFG.replace(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=2, head_dim=16, d_ff=128)
    rcfg = TR.ResNetConfig(stages=(1, 1), widths=(8, 16), img_size=8,
                           num_classes=4)
    lm_sens = tsens.SensitivityResult({s.name: {"w4": 0.01 * i} for i, s in
                                       enumerate(tcompress.lm_layer_specs(
                                           cfg))})
    r_sens = tsens.SensitivityResult({s.name: {"w4": 0.02 * i} for i, s in
                                      enumerate(TR.layer_specs(rcfg))})
    counted = []
    real = chip_smoke.check_fused_launches
    chip_smoke.check_fused_launches = lambda got, want, what: counted.append(
        (what, want))
    try:
        out = chip_smoke.population_phase(
            "cpu", lm_sens, r_sens, 16, lm_cfg=cfg, resnet_cfg=rcfg,
            val_batch=4, val_seq=16, images=16, episodes=8, warmup=4,
            updates=2)
    finally:
        chip_smoke.check_fused_launches = real
    chunks = out["resnet"]["chunk_errs"]
    assert [n for n, _, _ in chunks] == [2 * 4]
    assert max(e for _, e, _ in chunks) <= 1e-5
    assert out["lm"]["dev_check"]["max_abs_err"] == 0.0
    assert out["lm"]["dev_check"]["pairs"] > 0
    assert out["resnet_sens"]["probes"] > 0 and out["lm_sens"]["probes"] > 0
    wants = dict(counted)
    steady = wants["ResNet population, steady chunk"]
    assert steady["adam_polyak"] == 2 * 8 * 2 and steady["mlp3"] == 0
    assert steady["fake_quant_slots"] > 0
    lm = wants["LM population, steady chunk"]
    T = len(tcompress.lm_layer_specs(cfg))
    assert lm["mlp3_members"] == 2 * T and lm["polyak"] == 2 * 2 * 8 * 2
    assert lm["mlp3"] == 5 * lm["polyak"] and lm["adam_polyak"] == 0
    assert wants["ResNet population"]["adam_polyak"] == 4 * 2 * 4
    for part in ("resnet", "lm"):
        for mode in ("shared", "alone"):
            assert out[part][mode]["member_episode_s"] > 0
    with pytest.raises(AssertionError, match="adam_polyak"):
        chip_smoke.check_fused_launches(
            {**build.LAUNCHES, "adam_polyak": 1}, {"adam_polyak": 2},
            "a wrong count")
