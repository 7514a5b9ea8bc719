"""Epoch mode of the port's fused engine (``FusedCompressionSearch(...,
epoch_batches=E)``) against its own per-batch mode and against the JAX
package's epoch engine, and the per-batch engine against the JAX one on
the ResNet testbed (``RESNET_CFG``), on the CPU (mirrors
``tests/test_epoch.py``; the graphs run eagerly here, the card's
capture and replay are held in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``).

Epoch against per batch, same seed: both modes draw the same numbers in
the same order and run the same operations (the running norm advances
on the device in both, the reward too), so records, ring, ptr/size and
the final agent state are held exact; the validation differs only in
carrying its bits as device tensors, which must not change a bit.
Against the JAX epoch engine, fed its batch keys' draws and its replay
indices: records as ``tests/test_fused.py`` holds them (policies equal,
accuracy 1e-6, latency 1e-5 relative, reward 1e-5), ring ≤1e-5 and the
agent state ≤1e-3 (the f32 products of ~30 updates sum in other orders
than XLA's and carry the ulps on).

The JAX-parity records' exact policies and accuracies rest on this
test's draws: under a quantized policy a last-bit range difference can
move a whole fake-quant step and flip an argmax, so over many draws the
port's f32 accuracy is only within one token of JAX's
(``tests/test_torch_flips.py`` states the bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import ddpg as jddpg  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.compress import CompressibleLM, CompressibleResNet  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models import resnet as JR  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.testbed import RESNET_CFG  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402

from test_torch_fused import (BATCH, CTX, K_BATCH, TINY, _cmps,  # noqa: E402
                              _port_cfg, _scfgs, _sens_pair, _t,
                              check_records, jax_draws, run_fed_pair)

IMG_CTX = dict(tokens=1, seq_ctx=0, mode="prefill", batch=1)


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
    return CompressibleLM(cfg, params), tm, batch, tb


def _port(tm, tb, epoch_batches=0, sens=None, episodes=16):
    _, tcfg = _scfgs(episodes)
    return tsearch.FusedCompressionSearch(
        tm, tb, tcfg, tlat.LatencyContext(**CTX), sens=sens,
        batch_size=K_BATCH, epoch_batches=epoch_batches)


def _exact_state(a, b):
    for x, y in zip(tddpg.state_leaves(a.agent.state), tddpg.state_leaves(b.agent.state)):
        assert torch.equal(x, y)
    for x, y in zip(a.replay.data, b.replay.data):
        assert torch.equal(x, y)
    assert (a.replay.ptr, a.replay.size) == (b.replay.ptr, b.replay.size)
    np.testing.assert_array_equal(a.agent.norm.mean, b.agent.norm.mean)
    np.testing.assert_array_equal(a.agent.norm.var, b.agent.norm.var)
    assert a.agent.norm.count == b.agent.norm.count


def _exact_records(ha, hb):
    assert [r.episode for r in ha] == [r.episode for r in hb]
    for a, b in zip(ha, hb):
        assert (a.reward, a.accuracy, a.latency_s, a.sigma) == \
            (b.reward, b.accuracy, b.latency_s, b.sigma), a.episode
        assert [(c.keep, c.w_bits, c.a_bits) for c in a.policy.cmps] == \
            [(c.keep, c.w_bits, c.a_bits) for c in b.policy.cmps]


def test_epoch_matches_per_batch_engine(lm):
    """Two epochs of 2 batches (the first straddling warmup, so a partial
    and the steady update schedule) against four per-batch batches on the
    same seed: records, ring, ptr/size, norm mirror and every agent
    tensor exact; one "epoch" dispatch and one readback per epoch, and
    the in-carry best is the last epoch's first maximum."""
    _, tm, _, tb = lm
    epoch = _port(tm, tb, epoch_batches=2)
    ref = _port(tm, tb, sens=epoch.sens)
    res_e, res_r = epoch.run(), ref.run()
    assert epoch.dispatch_log == ["epoch", "epoch"]
    assert epoch.readbacks == 2
    assert ref.dispatch_log.count("rollout") == 4
    _exact_records(res_e.history, res_r.history)
    _exact_state(epoch, ref)
    assert res_e.best.episode == res_r.best.episode
    last = res_e.history[8:]
    want = max(last, key=lambda r: r.reward)
    assert epoch.last_epoch_best == (want.episode, pytest.approx(
        want.reward, abs=1e-6))
    assert len(epoch._epoch_cache) == 2           # (4, 8) then (8, 8)


def test_epoch_remainder_and_schedule_cache(lm):
    """14 episodes through epochs of 2 batches of 4: an epoch, then one of
    a single batch and a per-batch tail of 2, numbered as the per-batch
    engine's with the same records; steady epochs reuse their graph."""
    _, tm, _, tb = lm
    epoch = _port(tm, tb, epoch_batches=2, episodes=14)
    ref = _port(tm, tb, sens=epoch.sens, episodes=14)
    res_e, res_r = epoch.run(), ref.run()
    assert [r.episode for r in res_e.history] == list(range(14))
    assert epoch.dispatch_log[:2] == ["epoch", "epoch"]
    assert "rollout" in epoch.dispatch_log        # the per-batch tail ran
    _exact_records(res_e.history, res_r.history)
    assert epoch._update_schedule(0, 2) != epoch._update_schedule(8, 2)
    n = len(epoch._epoch_cache)
    epoch.run_epoch(16, 2)
    epoch.run_epoch(24, 2)
    assert len(epoch._epoch_cache) == n + 1       # one steady schedule


def test_epoch_matches_jax_epoch_engine(lm):
    """One epoch (E 2, K 4: 8 episodes straddling warmup) against the JAX
    epoch engine, the port fed the JAX rollout stream's batch keys'
    draws and the replay indices its epoch scan derives from the agent
    key (``chunk_sample_keys`` per batch with updates, bounded by the
    ring size after the batch's push): records as the per-batch parity
    holds them, the in-carry best, ring ≤1e-5, agent state ≤1e-3."""
    jcm, tm, jb, tb = lm
    jcfg, tcfg = _scfgs(8)
    jsens, tsn = _sens_pair(tm.specs, 13)
    js = jsearch.FusedCompressionSearch(jcm, jb, jcfg,
                                        jlat.LatencyContext(**CTX),
                                        sens=jsens, batch_size=K_BATCH,
                                        epoch_batches=2)
    ts = tsearch.FusedCompressionSearch(
        tm, tb, tcfg, tlat.LatencyContext(**CTX), sens=tsn,
        batch_size=K_BATCH, epoch_batches=2)
    ts.agent.state = convert.agent_state(jax.device_get(js.agent.state),
                                         device="cpu")
    T, A = len(ts.steps), ts.agent.cfg.action_dim
    draws, fed = [], []
    j_epoch = js.run_epoch

    def recording_epoch(first, nb):
        rk, key = js._rollout_key, js.agent.state.key
        size, cap = js.replay.size, js.replay.capacity
        for n in js._update_schedule(first, nb):
            rk, bk = jax.random.split(rk)
            draws.append(jax_draws(bk, T, K_BATCH, A))
            size = min(size + T * K_BATCH, cap)
            if n:
                key, ks = jddpg.chunk_sample_keys(key, n)
                fed.append(np.stack([np.asarray(jax.random.randint(
                    k, (BATCH,), 0, max(size, 1))) for k in ks]))
        return j_epoch(first, nb)

    js.run_epoch = recording_epoch
    jr = js.run()

    def fed_draws(uniforms, normals):
        uni, nrm = draws.pop(0)
        uniforms.copy_(_t(uni))
        normals.copy_(_t(nrm))

    def fed_indices(indices, size):
        idx = fed.pop(0)
        assert idx.shape == tuple(indices.shape) and idx.max() < size
        indices.copy_(_t(idx))

    ts._fill_draws, ts._fill_indices = fed_draws, fed_indices
    tr = ts.run()
    assert not draws and not fed
    assert ts.dispatch_log == js.dispatch_log == ["epoch"]
    check_records(tr, jr)
    assert ts.last_epoch_best[0] == js.last_epoch_best[0]
    np.testing.assert_allclose(ts.last_epoch_best[1], js.last_epoch_best[1],
                               atol=1e-5)
    d = jax.device_get(js.replay.data)
    for got, want in zip(ts.replay.data, d):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    st = jax.device_get(js.agent.state)
    want = convert.agent_state(st, device="cpu")
    for got, w in zip(tddpg.state_leaves(ts.agent.state), tddpg.state_leaves(want)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-3,
                                   rtol=1e-3)


# ------------------------------------------------------- ResNet testbed

def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def resnet_engines():
    """The JAX and the port's per-batch fused engine on ``RESNET_CFG``
    (the port's seeded f32 weights carried to JAX), 16 blob images of
    16 x 16, the per-image context: two batches of 4 straddling warmup,
    the port fed the JAX draws, replay indices and KL table."""
    args = {k: getattr(RESNET_CFG, k) for k in RESNET_CFG.__dataclass_fields__}
    params = _to_jax(TR.init(RESNET_CFG, seed=0, device="cpu"))
    jcm = CompressibleResNet(JR.ResNetConfig(**args), params)
    tcm = tcompress.CompressibleResNet(RESNET_CFG, convert.resnet_params(
        jax.device_get(params), device="cpu"))
    jb = jdata.blob_images(10, 16, 16, seed=5)
    tb = tdata.blob_images(10, 16, 16, seed=5, device="cpu")
    return run_fed_pair(jcm, tcm, jb, tb, IMG_CTX)


def test_resnet_fused_engine_matches_jax(resnet_engines):
    """Policies equal, latency 1e-5 relative, episode by episode; the same
    update chunks and ring fill. Accuracy 1e-6 and reward 1e-5 except
    where the validation forward itself disagrees with XLA's on the
    policy: the port's GroupNorm and spatial mean round a few ulps off
    XLA's, so under a 2/4-bit policy an activation can move a whole step
    and one image's argmax flip (``tests/test_torch_resnet.py``). Such an
    episode's accuracy must be each side's own ``accuracy_policy_batch``
    of the policy, differ by at most one image (1/16), and move the
    reward by exactly that; at most one of the 8 episodes may."""
    js, ts, jr, tr, sizes = resnet_engines
    assert tr.ref_accuracy == jr.ref_accuracy
    assert sizes == [4, 8]
    assert (ts.replay.ptr, ts.replay.size) == (js.replay.ptr,
                                               js.replay.size)
    assert ts.dispatch_log == js.dispatch_log
    flips = 0
    for t, j in zip(tr.history, jr.history):
        assert _cmps(t.policy) == _cmps(j.policy), f"episode {j.episode}"
        np.testing.assert_allclose(t.latency_s, j.latency_s, rtol=1e-5)
        d = t.accuracy - j.accuracy
        if abs(d) > 1e-6:
            flips += 1
            assert abs(d) <= 1 / 16 + 1e-6
            np.testing.assert_allclose(t.reward - j.reward, d, atol=1e-5)
            tpb = tpolicy.stack_policies(ts.specs, [t.policy])
            jpb = jpolicy.stack_policies(js.specs, [j.policy])
            assert float(ts.cmodel.accuracy_policy_batch(
                ts.val_batch, tpb)[0]) == pytest.approx(t.accuracy,
                                                        abs=1e-6)
            assert float(js.cmodel.accuracy_policy_batch(
                js.val_batch, jpb)[0]) == pytest.approx(j.accuracy,
                                                        abs=1e-6)
        else:
            np.testing.assert_allclose(t.reward, j.reward, atol=1e-5)
    assert flips <= 1


def test_chip_smoke_fused_runs_on_cpu():
    """``chip_smoke.py``'s fused-path runs at a small size on the CPU
    (the graphs' functions eager, plain versions in place of the
    kernels, so no launch is counted and the counts checks are fed the
    launches a run would make): per batch and epoch mode against their
    eager references and each other, K1's device-bits entry at every
    site, the steady state's graph counts and the ``[time]`` split; a
    wrong launch count is refused."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from repro_torch.configs.testbed import LM_CFG, SERVE_CTX
    from repro_torch.kernels import build
    cfg = LM_CFG.replace(num_layers=2, d_ff=512)
    sens = tsens.SensitivityResult({s.name: {"w4": 0.01 * i}
                                    for i, s in enumerate(
                                        tcompress.lm_layer_specs(cfg))})

    def make(eps):
        cm, val, scfg = chip_smoke.search_inputs(
            cfg, "cpu", episodes=eps, warmup=2, updates=2, batch_size=16,
            val_batch=4, val_seq=16)
        return cm, val, scfg, SERVE_CTX, sens

    rows = 4 * 16
    gen = torch.Generator().manual_seed(0)

    def lm_input(call, dtype):
        (R, C), _ = call
        x = torch.randn((R, C) if R != rows else (8, R, C), generator=gen)
        return (x if R == rows else x.expand(8, R, C)).to(dtype)

    counted = []

    def no_launch_check(launches, want, what):
        counted.append(want)

    real = chip_smoke.check_fused_launches
    chip_smoke.check_fused_launches = no_launch_check
    try:
        out = chip_smoke.fused_runs(
            cfg.name, make, "cpu", 8,
            lambda cs: chip_smoke.k1_calls(cfg, cs, rows),
            lambda cs: chip_smoke.k1_calls(cfg, cs, rows),
            lambda calls: chip_smoke.check_fake_quant_dev_calls(
                calls, lm_input, lambda c: {torch.float32}, "cpu"))
    finally:
        chip_smoke.check_fused_launches = real
    assert out["dev_check"]["max_abs_err"] == 0.0
    assert out["dev_check"]["pairs"] > 0
    for mode in ("fused", "epoch"):
        assert out[mode]["profile"]["split_s"]["other host"] >= 0
    assert "epoch" in out["epoch"]["profile"]["split_s"]
    assert {"rollout", "update"} <= set(out["fused"]["profile"]["split_s"])
    # steady state: 1 batch of 8 live episodes, 2 updates each
    T = len(tcompress.lm_layer_specs(cfg))
    fused_want, epoch_want = counted
    assert fused_want["mlp3"] == T + 5 * 16 and fused_want["polyak"] == 16
    assert epoch_want["mlp3"] == 2 * (T + 5 * 16)
    assert epoch_want["fake_quant_slots_dev"] == 2 * len(
        chip_smoke.k1_calls(cfg, {"blocks": [
            {"attn": {"qkv": {"w_bits": torch.zeros(8), "a_bits":
                              torch.zeros(8)},
                      "o": {"w_bits": torch.zeros(8), "a_bits":
                            torch.zeros(8)}},
             "mlp": {"up": {"w_bits": torch.zeros(8), "a_bits":
                            torch.zeros(8)},
                     "down": {"w_bits": torch.zeros(8), "a_bits":
                              torch.zeros(8)}}}] * cfg.num_layers,
            "embed_bits": torch.zeros(8), "head_bits": torch.zeros(8)},
            rows))
    with pytest.raises(AssertionError, match="polyak"):
        chip_smoke.check_fused_launches({**build.LAUNCHES, "polyak": 1},
                                        {"polyak": 2}, "a wrong count")
