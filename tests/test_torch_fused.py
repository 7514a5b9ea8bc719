"""The fused engine of the port (``FusedCompressionSearch``, per batch)
and its pieces against the JAX package's, on the CPU (mirrors
``tests/test_fused.py``). On the CPU the engine's graphs run their pure
functions eagerly through the kernels' plain versions; the card's
capture and replay are held in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Pieces: ``legal_tables`` / ``round_keep_arrays`` / ``map_actions_batch``
(exact: the same f32 operations) on the tiny LM's and ``RESNET_CFG``'s
specs; the device oracle against ``JaxBatchOracle`` (≤1e-6 relative: f32
sums in other orders), analytic and calibrated; ``StateTables`` /
``fused_state_block`` (exact); ``agent_act_batch`` fed the JAX draws
(≤1e-5: the actor's f32 products sum in another order);
``observe_states_pure`` (≤1e-6); the device ring's push and sample
(exact, wrap and oversize); ``compute_reward_batch`` (≤1e-6);
``_schedule_segments`` / ``_update_schedule`` (equal);
``accuracy_policy_fn`` (equal to ``accuracy_policy_batch``, and to the
JAX one under an f32 config). Then the per-batch engine against the JAX
``FusedCompressionSearch`` on the tiny LM, fed its batch keys' draws, its
replay indices and its sensitivity table, over two batches that straddle
warmup: the tolerances of ``tests/test_fused.py`` (reward 1e-5, accuracy
1e-6, latency 1e-5 relative, policies equal).

The JAX-parity records' exact policies and accuracies rest on this
test's draws: under a quantized policy a last-bit range difference can
move a whole fake-quant step and flip an argmax, so over many draws the
port's f32 accuracy is only within one token of JAX's
(``tests/test_torch_flips.py`` states the bound).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import constraints as jcons  # noqa: E402
from repro.core import ddpg as jddpg  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import replay as jreplay  # noqa: E402
from repro.core import reward as jreward  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.compress import CompressibleLM, lm_layer_specs  # noqa: E402
from repro.core.measure import CalibrationTable  # noqa: E402
from repro.core.sensitivity import SensitivityResult  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models import resnet as JR  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.configs.testbed import RESNET_CFG  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import constraints as tcons  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import measure as tmeasure  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import replay as treplay  # noqa: E402
from repro_torch.core import reward as treward  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402
from repro_torch.core import state as tstate  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402

TINY = dict(name="t", num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=256, vocab_size=128, scan_layers=True)
CTX = dict(tokens=1, seq_ctx=256, mode="decode", batch=1)
CALIB = dict(ratios={"attn_qkv": {"raw": 1.7, "int8": 2.3, "int4": 3.1},
                     "mlp_down": {"raw": 0.6, "int8": 1.2},
                     "head": {"int4": 4.0}},
             extra={"attn": 1.4, "overhead": 2.5})
RESNET_ARGS = {k: getattr(RESNET_CFG, k)
               for k in RESNET_CFG.__dataclass_fields__}


def _port_cfg(cfg):
    return TArchConfig(**{k: getattr(cfg, k)
                          for k in cfg.__dataclass_fields__})


def _spec_pairs():
    """(JAX specs, port specs) of the tiny LM and of ``RESNET_CFG``."""
    cfg = ArchConfig(**TINY)
    return [(lm_layer_specs(cfg), tcompress.lm_layer_specs(_port_cfg(cfg))),
            (JR.layer_specs(JR.ResNetConfig(**RESNET_ARGS)),
             TR.layer_specs(RESNET_CFG))]


def _t(x):
    return torch.as_tensor(np.array(x))


# The JAX references, jitted: eager JAX dispatches op by op.
_jmap = jax.jit(jpolicy.map_actions_batch, static_argnames=("ip", "iw",
                                                           "ia"))
_jpush = jax.jit(jreplay.device_replay_push)
_jact = jax.jit(jddpg.agent_act_batch, static_argnums=0)


# ---------------------------------------------------------------- mapping

@pytest.mark.parametrize("which", [0, 1])
def test_legal_tables_and_map_actions_batch_match_jax(which):
    """Exact: the legality tables, ``round_keep_arrays`` over random kept
    counts, and ``map_actions_batch`` per spec over random actions for
    each method set (plus the thresholds' own values)."""
    specs_j, specs_t = _spec_pairs()[which]
    jl, tl = jcons.legal_tables(specs_j), tcons.legal_tables(specs_t)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rng = np.random.default_rng(which)
    keep = (rng.random((16, len(specs_j))) * 600).astype(np.float32)
    np.testing.assert_array_equal(
        tcons.round_keep_arrays(_t(keep), tl.granularity, tl.prune_dim)
        .numpy(),
        np.asarray(jcons.round_keep_arrays(keep, jl.granularity,
                                           jl.prune_dim)))
    acts = rng.random((64, 3)).astype(np.float32)
    acts[:6] = [[0.5, 0.5, 0.5], [0.2, 0.2, 0.2], [0.0, 1.0, 0.5],
                [1.0, 0.0, 0.0], [0.7, 0.51, 0.49], [0.3, 0.21, 0.19]]
    for methods in ("p", "q", "pq"):
        ip, iw, ia = jpolicy.action_columns(methods)
        assert tpolicy.action_columns(methods) == (ip, iw, ia)
        for t in range(len(specs_j)):
            kw_j = dict(prune_dim=jl.prune_dim[t],
                        granularity=jl.granularity[t],
                        prunable=jl.prunable[t],
                        quantizable=jl.quantizable[t], mix_ok=jl.mix_ok[t],
                        ip=ip, iw=iw, ia=ia)
            kw_t = dict(prune_dim=tl.prune_dim[t],
                        granularity=tl.granularity[t],
                        prunable=tl.prunable[t],
                        quantizable=tl.quantizable[t], mix_ok=tl.mix_ok[t],
                        ip=ip, iw=iw, ia=ia)
            want = _jmap(acts, **kw_j)
            got = tpolicy.map_actions_batch(_t(acts), **kw_t)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------- oracle

def random_policies(specs_j, K, seed):
    """(K, L) f32 keep / w_bits / a_bits of K random legal pq policies
    (the JAX ``map_actions_batch`` spec by spec)."""
    jl = jcons.legal_tables(specs_j)
    acts = np.random.default_rng(seed).random(
        (len(specs_j), K, 3)).astype(np.float32)
    cols = [_jmap(
        acts[t], prune_dim=jl.prune_dim[t], granularity=jl.granularity[t],
        prunable=jl.prunable[t], quantizable=jl.quantizable[t],
        mix_ok=jl.mix_ok[t]) for t in range(len(specs_j))]
    return tuple(np.stack([np.asarray(c[i]) for c in cols], axis=1)
                 .astype(np.float32) for i in range(3))


@pytest.mark.parametrize("which,calibrated",
                         [(0, False), (0, True), (1, False)])
def test_device_oracle_matches_jax(which, calibrated):
    """``unit_times`` / ``totals`` / ``decided_before`` (every t) of the
    device oracle against ``JaxBatchOracle`` on random legal policies,
    ≤1e-6 relative, analytic and under a calibration table."""
    specs_j, specs_t = _spec_pairs()[which]
    ctx = CTX if which == 0 else dict(tokens=1, seq_ctx=0, mode="prefill")
    jcal = CalibrationTable(**CALIB) if calibrated else None
    tcal = tmeasure.CalibrationTable(**CALIB) if calibrated else None
    jo = jlat.get_jax_oracle(specs_j, jlat.V5E, jlat.LatencyContext(**ctx),
                             calib=jcal)
    to = tlat.get_device_oracle(specs_t, tlat.V5E,
                                tlat.LatencyContext(**ctx), calib=tcal)
    assert to is tlat.get_device_oracle(specs_t, tlat.V5E,
                                        tlat.LatencyContext(**ctx),
                                        calib=tcal)
    keep, wb, ab = random_policies(specs_j, 6, 7 + which)
    ju, je = jax.jit(jo.unit_times)(keep, wb, ab)
    tu, te = to.unit_times(_t(keep), _t(wb), _t(ab))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(to.totals(tu, te).numpy(),
                               np.asarray(jo.totals(ju, je)), rtol=1e-6)
    decided = jax.jit(jo.decided_before)
    for t in range(len(specs_j) + 1):
        np.testing.assert_allclose(
            to.decided_before(tu, te, t).numpy(),
            np.asarray(decided(ju, je, t)), rtol=1e-6)


# ------------------------------------------------------------------ state

def _sens_pair(specs, seed):
    rng = np.random.default_rng(seed)
    table = {s.name: {p: float(rng.random())
                      for p in tsens.FEATURE_PROBES[:4]}
             for s in specs if s.quantizable}
    return SensitivityResult(table), tsens.SensitivityResult(table)


def test_state_tables_and_block_match_jax():
    """Exact: the per-step static rows, shares and spec indices, and each
    step's (K, state_dim) block."""
    specs_j, specs_t = _spec_pairs()[0]
    jsens, tsn = _sens_pair(specs_t, 3)
    jref = jlat.policy_latency(specs_j, jpolicy.Policy.reference(specs_j),
                               jlat.V5E, jlat.LatencyContext(**CTX))
    tref = tlat.policy_latency(specs_t, tpolicy.Policy.reference(specs_t),
                               tlat.V5E, tlat.LatencyContext(**CTX))
    steps = list(range(len(specs_j)))
    jt = jstate.StateTables(specs_j, steps, jsens, jref)
    tt = tstate.StateTables(specs_t, steps, tsn, tref)
    np.testing.assert_array_equal(tt.static, jt.static)
    np.testing.assert_array_equal(tt.shares, jt.shares)
    np.testing.assert_array_equal(tt.spec_idx, jt.spec_idx)
    assert tt.ref_total == jt.ref_total
    static, shares, ref_total = tt.to("cpu")
    assert float(ref_total) == np.float32(jt.ref_total)
    rng = np.random.default_rng(4)
    for t in (0, 5, len(steps) - 1):
        decided = rng.random(5).astype(np.float32)
        prev = rng.random((5, 3)).astype(np.float32)
        want = jstate.fused_state_block(jt.static[t], jt.shares[t], decided,
                                        prev)
        got = tstate.fused_state_block(static[t], shares[t], _t(decided),
                                       _t(prev))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ agent

S_DIM, A_DIM = tstate.state_dim(3), 3


def _agents(seed=0):
    jcfg = jddpg.DDPGConfig(state_dim=S_DIM, action_dim=A_DIM,
                            hidden=(32, 24))
    tcfg = tddpg.DDPGConfig(state_dim=S_DIM, action_dim=A_DIM,
                            hidden=(32, 24))
    st = jddpg.agent_init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    st = st._replace(
        norm_mean=jnp.asarray(rng.standard_normal(S_DIM), jnp.float32),
        norm_var=jnp.asarray(rng.random(S_DIM) + 0.5, jnp.float32),
        norm_count=jnp.asarray(37.0, jnp.float32))
    return jcfg, tcfg, st, convert.agent_state(jax.device_get(st),
                                               device="cpu")


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _jax_draws(key, T, K, A):
    def step(k):
        k_uni, k_act = jax.random.split(k)
        return (jax.random.uniform(k_uni, (K, A)),
                jax.vmap(lambda kj: jax.random.normal(kj, (16, A)))(
                    jax.random.split(k_act, K)))
    return jax.vmap(step)(jax.random.split(key, T))


def jax_draws(key, T, K, A):
    """The draws a JAX fused rollout takes from a batch key: per step
    ``split(key, T)[t]`` -> (k_uni, k_act); uniforms ``uniform(k_uni,
    (K, A))``; row j's normals ``normal(split(k_act, K)[j], (16, A))``.
    Returns (T, K, A) uniforms and (T, K, 16, A) normals."""
    return tuple(np.asarray(x) for x in _jax_draws(key, T, K, A))


def test_agent_act_batch_matches_jax_with_fed_draws():
    """Warmup rows take the uniforms, live rows the first in-bounds of 16
    candidates (else the first clipped), sigma 0 acts greedily: ≤1e-5
    against the JAX ``agent_act_batch`` on the same key."""
    jcfg, tcfg, jst, tst = _agents(1)
    K = 8
    rng = np.random.default_rng(2)
    states = rng.standard_normal((K, S_DIM)).astype(np.float32)
    sigmas = np.asarray([0.5, 0.5, 2.0, 3.0, 0.0, 0.1, 0.5, 5.0],
                        np.float32)
    warmup = np.asarray([1, 0, 0, 0, 0, 1, 0, 0], bool)
    key = jax.random.PRNGKey(9)
    want = np.asarray(_jact(jcfg, jst, states, key, sigmas, warmup))
    # the draws of one rollout step's key (jax_draws' per-step split)
    k_uni, k_act = jax.random.split(key)
    uni = np.asarray(jax.random.uniform(k_uni, (K, A_DIM)))
    nrm = np.stack([np.asarray(jax.random.normal(kj, (16, A_DIM)))
                    for kj in jax.random.split(k_act, K)])
    got = tddpg.agent_act_batch(tcfg, tst, _t(states), _t(sigmas),
                                _t(warmup), _t(uni), _t(nrm)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[warmup], uni[warmup])
    assert ((got >= 0) & (got <= 1)).all()


def test_observe_states_pure_matches_jax():
    """The running-norm advance from an (N, S) block, in place: ≤1e-6."""
    _, _, jst, tst = _agents(3)
    x = np.random.default_rng(5).standard_normal((40, S_DIM)).astype(
        np.float32) * 3 + 1
    want = jddpg.observe_states_pure(jst, x)
    got = tddpg.observe_states_pure(tst, _t(x))
    assert got is tst
    for name in ("norm_count", "norm_mean", "norm_var"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- replay

def test_device_replay_push_and_sample_match_jax():
    """Exact ring contents, ``ptr`` and ``size`` after pushes that wrap and
    one oversized push, and the transitions at JAX's sample indices."""
    cap = 50
    jd = jreplay.device_replay_init(cap, S_DIM, A_DIM)
    td = treplay.device_replay_init(cap, S_DIM, A_DIM)
    rng = np.random.default_rng(6)
    for n in (20, 45, 70, 3):
        cols = (rng.standard_normal((n, S_DIM)), rng.random((n, A_DIM)),
                rng.standard_normal(n), rng.standard_normal((n, S_DIM)),
                (rng.random(n) > 0.8))
        cols = [np.asarray(c, np.float32) for c in cols]
        jd = _jpush(jd, *cols)
        assert treplay.device_replay_push(td, *map(_t, cols)) is td
        for a, b in zip(td, jd):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    key = jax.random.PRNGKey(3)
    want = jreplay.device_replay_sample(jd, key, 16)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(jd.size, 1))
    got = treplay.device_replay_sample(td, _t(idx).long())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compute_reward_batch_tensors_match_jax():
    """Both reward kinds on (K,) f32 tensors, the reference total a float
    and a 0-d tensor: ≤1e-6 against JAX's traced form."""
    rng = np.random.default_rng(8)
    acc = rng.random(16).astype(np.float32)
    lat = (rng.random(16) * 2e-3).astype(np.float32)
    for kind in ("absolute", "hard_exponential"):
        jc = jreward.RewardConfig(target_ratio=0.4, kind=kind)
        tc = treward.RewardConfig(target_ratio=0.4, kind=kind)
        want = np.asarray(jreward.compute_reward_batch(jc, acc, lat, 1.1e-3))
        for ref in (1.1e-3, torch.tensor(1.1e-3)):
            got = treward.compute_reward_batch(tc, _t(acc), _t(lat), ref)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)


def test_schedule_segments_match_jax():
    for sched in ((32, 64, 64, 64), (0, 0, 8), (), (5,), (1, 2, 2, 1)):
        assert tsearch._schedule_segments(sched) == \
            jsearch._schedule_segments(sched)


# ------------------------------------------------------------- validation

@pytest.fixture(scope="module")
def lm_pair():
    cfg = ArchConfig(**TINY, compute_dtype="float32")
    params = M.init(cfg, jax.random.PRNGKey(0))
    tcfg = _port_cfg(cfg)
    tm = tcompress.CompressibleLM(
        tcfg, convert.lm_params(tcfg, jax.device_get(params), device="cpu"))
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3)
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    return CompressibleLM(cfg, params), tm, batch, tb


def test_accuracy_policy_fn_matches_batch_and_jax(lm_pair):
    """The device-bits validator equals ``accuracy_policy_batch`` on the
    same policies (bits as [K] int32 tensors, masks from tensor kept
    counts) and the JAX ``accuracy_policy_batch`` under the f32 config;
    its cspec holds tensors where the host form holds tuples."""
    jcm, tcm, jb, tb = lm_pair
    # K_BATCH policies: the engines' validation then reuses this compile
    keep, wb, ab = random_policies(jcm.specs, K_BATCH, 12)
    wb[1] = ab[1] = 32.0                    # one policy passes through
    want = np.asarray(jcm.accuracy_policy_batch(
        jb, jpolicy.PolicyBatch(keep=keep, w_bits=wb, a_bits=ab)))
    host = tcm.accuracy_policy_batch(
        tb, tpolicy.PolicyBatch(keep=keep.astype(np.float64),
                                w_bits=wb.astype(np.float64),
                                a_bits=ab.astype(np.float64))).numpy()
    dev_in = [torch.as_tensor(x.astype(np.int32)) for x in (keep, wb, ab)]
    got = tcm.accuracy_policy_fn(tb)(*dev_in).numpy()
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1
    cs = tcm.cspec_builder()(*dev_in)
    qkv = cs["blocks"][0]["attn"]["qkv"]
    assert isinstance(qkv["w_bits"], torch.Tensor)
    assert qkv["w_bits"].dtype == torch.int32 and \
        qkv["w_bits"].is_contiguous()


# ---------------------------------------------------------- the engines

K_BATCH, EPISODES, WARMUP, UPDATES, BATCH = 4, 8, 2, 2, 16


def _scfgs(episodes=EPISODES):
    ddpg = dict(warmup_episodes=WARMUP, updates_per_episode=UPDATES,
                batch_size=BATCH, buffer_size=256, hidden=(32, 24))
    reward = dict(target_ratio=0.5, beta=-3.0)
    return (jsearch.SearchConfig(methods="pq", episodes=episodes, seed=0,
                                 reward=jreward.RewardConfig(**reward),
                                 ddpg=jddpg.DDPGConfig(**ddpg)),
            tsearch.SearchConfig(methods="pq", episodes=episodes, seed=0,
                                 reward=treward.RewardConfig(**reward),
                                 ddpg=tddpg.DDPGConfig(**ddpg)))


def run_fed_pair(jcm, tcm, jb, tb, ctx, episodes=EPISODES,
                 epoch_batches=0):
    # the engines' state features read the KL table; a seeded one spares
    # the JAX sensitivity analysis its compile
    """Run the JAX ``FusedCompressionSearch`` (per batch), recording each
    batch key and each update chunk's replay indices, then the port's
    engine (``epoch_batches``) on the same weights, initial agent state
    and (seeded) sensitivity table, its draws and indices replaced by
    JAX's.
    Returns (JAX engine, port engine, JAX result, port result, chunk
    sizes)."""
    jcfg, tcfg = _scfgs(episodes)
    jsens, tsn = _sens_pair(tcm.specs, 11)
    js = jsearch.FusedCompressionSearch(jcm, jb, jcfg,
                                        jlat.LatencyContext(**ctx),
                                        sens=jsens, batch_size=K_BATCH)
    ts = tsearch.FusedCompressionSearch(
        tcm, tb, tcfg, tlat.LatencyContext(**ctx), sens=tsn,
        batch_size=K_BATCH, epoch_batches=epoch_batches)
    ts.agent.state = convert.agent_state(jax.device_get(js.agent.state),
                                         device="cpu")
    keys, fed, sizes = [], [], []
    j_args, j_chunk = js._rollout_args, js.agent.update_chunk

    def recording_args(first, k):
        out = j_args(first, k)
        keys.append((js._last_batch_key, k))
        return out

    def recording_chunk(replay, n):
        if n > 0 and len(replay) >= BATCH:
            sizes.append(n)
            _, ks = jddpg.chunk_sample_keys(js.agent.state.key, n)
            fed.append(np.stack([np.asarray(jax.random.randint(
                k, (BATCH,), 0, max(len(replay), 1))) for k in ks]))
        return j_chunk(replay, n)

    js._rollout_args = recording_args
    js.agent.update_chunk = recording_chunk
    jr = js.run()
    T, A = len(ts.steps), ts.agent.cfg.action_dim
    draws = [jax_draws(key, T, k, A) for key, k in keys]
    queue = list(fed)

    def fed_draws(uniforms, normals):
        uni, nrm = draws.pop(0)
        uniforms.copy_(_t(uni))
        normals.copy_(_t(nrm))

    def fed_indices(indices, size):
        idx = queue.pop(0)
        assert idx.shape == tuple(indices.shape) and idx.max() < size
        indices.copy_(_t(idx))

    ts._fill_draws, ts._fill_indices = fed_draws, fed_indices
    tr = ts.run()
    assert not draws and not queue
    return js, ts, jr, tr, sizes


def _cmps(p):
    return [(c.keep, c.mode, c.w_bits, c.a_bits) for c in p.cmps]


def check_records(tr, jr, latency_rtol=1e-5):
    assert [r.episode for r in tr.history] == [r.episode for r in
                                               jr.history]
    for t, j in zip(tr.history, jr.history):
        assert _cmps(t.policy) == _cmps(j.policy), f"episode {j.episode}"
        np.testing.assert_allclose(t.accuracy, j.accuracy, atol=1e-6)
        np.testing.assert_allclose(t.latency_s, j.latency_s,
                                   rtol=latency_rtol)
        np.testing.assert_allclose(t.reward, j.reward, atol=1e-5)
        assert t.sigma == pytest.approx(j.sigma, rel=1e-6)
    assert len({tuple(_cmps(r.policy)) for r in tr.history}) > 1


@pytest.fixture(scope="module")
def lm_engines(lm_pair):
    jcm, tcm, jb, tb = lm_pair
    return run_fed_pair(jcm, tcm, jb, {"tokens": tb["tokens"]}, CTX)


def test_fused_engine_records_match_jax(lm_engines):
    """Two batches of 4 straddling warmup (2): policies equal, accuracy
    1e-6, latency 1e-5 relative, reward 1e-5, episode by episode."""
    _, _, jr, tr, _ = lm_engines
    assert tr.ref_accuracy == jr.ref_accuracy
    check_records(tr, jr)


def test_fused_engine_dispatches_ring_and_updates(lm_engines):
    """Per batch "rollout", "validate", "push", then "update" once the
    ring holds a DDPG batch; the same update chunks (2 live episodes,
    then 4); ptr/size exact (host mirrors and device); the ring's dones
    exact, its states, actions and rewards ≤1e-5 (the f32 oracle's
    decided-latency feature and the actor's products round in other
    orders than XLA's, by ulps); the norm statistics ≤1e-6."""
    js, ts, _, _, sizes = lm_engines
    assert sizes == [UPDATES * 2, UPDATES * 4]
    assert ts.dispatch_log == ["rollout", "validate", "push", "update"] * 2
    assert js.dispatch_log == ts.dispatch_log
    d = jax.device_get(js.replay.data)
    assert (ts.replay.ptr, ts.replay.size) == (js.replay.ptr,
                                               js.replay.size)
    assert (int(ts.replay.data.ptr), int(ts.replay.data.size)) == (
        int(d.ptr), int(d.size))
    np.testing.assert_array_equal(ts.replay.dones.numpy(),
                                  np.asarray(d.dones))
    for name in ("states", "actions", "rewards", "next_states"):
        np.testing.assert_allclose(getattr(ts.replay, name).numpy(),
                                   np.asarray(getattr(d, name)), atol=1e-5,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(ts.agent.norm.mean, js.agent.norm.mean,
                               atol=1e-6)
    np.testing.assert_allclose(ts.agent.norm.var, js.agent.norm.var,
                               atol=1e-6)
    assert ts.readbacks == 0 and ts.last_epoch_best is None


def test_update_schedule_matches_jax(lm_engines):
    """The static per-batch update counts of an epoch from the engines'
    current ring fill, from a warmup start and from steady state."""
    js, ts, _, _, _ = lm_engines
    for first, nb in ((0, 3), (8, 2), (1, 4)):
        assert ts._update_schedule(first, nb) == \
            js._update_schedule(first, nb)
