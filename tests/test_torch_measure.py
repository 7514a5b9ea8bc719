"""The port's measured-latency oracle against the JAX package's, on the
CPU: the quantized-matmul plain versions (K4/K5's functions), the
calibration table and its fits, the calibrated oracle, the calibrated
search fed the JAX draws, and the measured mode.

The JAX quantized matmul runs as its own tests run it here (Pallas in
interpret mode); on a CPU tensor the port's wrapper takes its plain
version. Inputs are made with numpy from a seed.

Tolerances:
  * ``quantize_rows`` / ``quantize_cols`` codes, scales and zeros, and
    ``int8_matmul_ref``: exact. ``dequant_matmul_ref``: ≤1e-6 relative
    in norm (f32 matmuls sum in other orders; single outputs differ by up
    to ~11 ulp at K = 512).
  * ``ops.quantized_matmul`` vs the JAX op run eagerly
    (``jax.disable_jit``): exact. Under ``jit`` XLA takes the scale's
    ``span / n`` as ``span * (1/n)``, one ulp off in most scales, which
    can flip a code at a rounding boundary: one int4 code at 256³ moved
    207 outputs by up to 1.15, past the JAX test's own bound (rtol 1e-3,
    atol 0.1). The port keeps the correctly rounded quotient of the
    JAX package's eager ``ref.quantize_rows``.
  * the calibration table and ``policy_latency(calib=)``: factors equal,
    fits ≤1e-9 relative, latencies ≤1e-6 relative (the same numpy
    float64 code).
  * the calibrated search: CMPs and accuracy exact, latency ≤1e-6
    relative, reward ≤1e-5 (as ``test_torch_search.py``).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import ddpg as jddpg  # noqa: E402
from repro.core import measure as jm  # noqa: E402
from repro.core import policy as jp  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.core.compress import CompressibleLM, lm_layer_specs  # noqa: E402
from repro.core.ddpg import DDPGConfig  # noqa: E402
from repro.core.latency import (V5E, LatencyContext,  # noqa: E402
                                policy_latency)
from repro.core.reward import RewardConfig  # noqa: E402
from repro.core.search import CompressionSearch, SearchConfig  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as M  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import measure as tm  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.core import reward as treward  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_CALIBRATION = os.path.join(ROOT, "artifacts", "latency_calibration.json")
CTX = dict(tokens=1, seq_ctx=512, mode="decode", batch=1)
TINY = dict(name="t", num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=256, vocab_size=128, scan_layers=True,
            compute_dtype="float32")
MATMUL_SHAPES = [(64, 128, 64), (200, 300, 130), (256, 256, 256),
                 (33, 512, 257)]


def _normal(seed, shape, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _synth_ratios(specs):
    return {s.kind: {"raw": 1.1, "int8": 1.7, "int4": 2.3} for s in specs}


# --------------------------------------------------------------------------
# K4 / K5: the plain versions and the op
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_rows_and_cols_match_jax(bits):
    x = _normal(bits, (33, 512)) * 2.0 + 0.5
    for jf, tf in ((jref.quantize_rows, tref.quantize_rows),
                   (jref.quantize_cols, tref.quantize_cols)):
        for j, t in zip(jf(jnp.asarray(x), bits), tf(_t(x), bits)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("M,K,N", [(33, 512, 257)])
def test_matmul_refs_match_jax(M, K, N):
    x, w = _normal(M, (M, K), 3.0), _normal(N, (K, N), -1.0)
    jargs = jref.quantize_rows(jnp.asarray(x), 8)[:1] \
        + jref.quantize_cols(jnp.asarray(w), 8)[:1] \
        + jref.quantize_rows(jnp.asarray(x), 8)[1:] \
        + jref.quantize_cols(jnp.asarray(w), 8)[1:]
    xq, wq, sx, zx, sw, zw = jargs
    targs = [_t(a) for a in (xq, wq, sx, zx, sw, zw)]
    np.testing.assert_array_equal(
        tref.int8_matmul_ref(*targs).numpy(),
        np.asarray(jref.int8_matmul_ref(xq, wq, sx, zx, sw, zw)))
    want = np.asarray(jref.dequant_matmul_ref(xq, wq, sx, zx, sw, zw))
    got = tref.dequant_matmul_ref(*targs).numpy()
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)


def test_pack_unpack_int4_match_jax():
    w4 = np.random.default_rng(4).integers(-8, 8, (64, 32)).astype(np.int8)
    packed = np.asarray(jref.pack_int4(jnp.asarray(w4)))
    np.testing.assert_array_equal(tref.pack_int4(_t(w4)).numpy(), packed)
    np.testing.assert_array_equal(tref.unpack_int4_ref(_t(packed)).numpy(),
                                  w4)


@pytest.mark.parametrize("M,K,N,w_bits",
                         [s + (b,) for s in MATMUL_SHAPES for b in (8, 4)]
                         + [(64, 301, 96, 4)])
def test_quantized_matmul_matches_jax_op(M, K, N, w_bits):
    """The port's op (CPU: the wrapper's plain version, no padding; an odd
    K padded to even for int4) against the JAX op (K/M/N padded to 256,
    Pallas interpret), both eager: equal."""
    x, w = _normal(M + K, (M, K)), _normal(N + 1, (K, N))
    with jax.disable_jit():
        want = np.asarray(jops.quantized_matmul(
            jnp.asarray(x), jnp.asarray(w), w_bits=w_bits))
    got = tops.quantized_matmul(_t(x), _t(w), w_bits=w_bits)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("packed", [False, True])
def test_asymmetric_zero_point_convention(packed):
    """The ADD convention x = s·(q + z), with teeth: strongly shifted data
    makes the zero-point terms large; the wrapper (plain version here)
    equals the dequantize-then-matmul truth, approximates the f32
    product, and the SUBTRACT convention misses badly."""
    bits = 4 if packed else 8
    x, w = _normal(20, (64, 128), 3.0), _normal(21, (128, 96), -1.0)
    xq, sx, zx = tref.quantize_rows(_t(x), 8)
    wq, sw, zw = tref.quantize_cols(_t(w), bits)
    want = tref.dequant_matmul_ref(xq, wq, sx, zx, sw, zw)
    got = quant_matmul(xq, tref.pack_int4(wq) if packed else wq, sx, zx,
                       sw, zw, packed=packed)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0.1)
    fp = _t(x) @ _t(w)
    rel = float((want - fp).norm() / fp.norm())
    assert rel < (0.2 if packed else 0.03)
    wrong = tref.int8_matmul_ref(xq, wq, sx, -zx, sw, -zw)
    assert float((wrong - fp).norm() / fp.norm()) > 10 * rel


def test_quant_matmul_k_true():
    """Zero-padding K must not corrupt the K·zx·zw term: with ``k_true``
    the padded call reproduces the unpadded truth; without it it is off."""
    x, w = _normal(50, (32, 300), 1.0), _normal(51, (300, 64))
    xq, sx, zx = tref.quantize_rows(_t(x), 8)
    wq, sw, zw = tref.quantize_cols(_t(w), 4)
    want = tref.dequant_matmul_ref(xq, wq, sx, zx, sw, zw)
    xq_p = torch.zeros((32, 512), dtype=torch.int8)
    xq_p[:, :300] = xq
    wq_p = torch.zeros((512, 64), dtype=torch.int8)
    wq_p[:300] = wq
    packed = tref.pack_int4(wq_p)
    got = quant_matmul(xq_p, packed, sx, zx, sw, zw, packed=True,
                       k_true=300)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0.1)
    bad = quant_matmul(xq_p, packed, sx, zx, sw, zw, packed=True)
    assert float((bad - want).abs().max()) > 1.0


# --------------------------------------------------------------------------
# Calibration table and the calibrated oracle
# --------------------------------------------------------------------------

def _specs():
    cfg = ArchConfig(**TINY)
    return lm_layer_specs(cfg), tcompress.lm_layer_specs(TArchConfig(**TINY))


def test_jax_calibration_file_loads_into_port_table():
    """Either package reads the other's file: the committed (CPU-measured)
    JAX table gives the port's table the same factors."""
    j = jm.CalibrationTable.load(JAX_CALIBRATION)
    t = tm.CalibrationTable.load(JAX_CALIBRATION)
    assert t.ratios == j.ratios and t.extra == j.extra and t.meta == j.meta
    js, ts = _specs()
    np.testing.assert_array_equal(t.unit_factors(ts), j.unit_factors(js))
    for kind in list(j.ratios) + ["nope"]:
        for c in tlat.CONTAINERS:
            assert t.factor(kind, c) == j.factor(kind, c)
    assert t.extra_factor() == j.extra_factor()
    assert t.overhead_factor() == j.overhead_factor()
    assert tm.DEFAULT_CALIBRATION_PATH.endswith(
        os.path.join("artifacts", "torch_latency_calibration.json"))


def test_table_roundtrip_and_defaults(tmp_path):
    t = tm.CalibrationTable(ratios={"mlp_up": {"int8": 2.0}},
                            extra={"attn": 1.4, "overhead": 1.4},
                            meta={"note": "x"})
    p = str(tmp_path / "calib.json")
    t.save(p)
    back = tm.load_calibration(p)
    assert back.ratios == t.ratios and back.meta == t.meta
    assert back.extra_factor() == back.overhead_factor() == 1.4
    assert back.factor("mlp_up", "raw") == back.factor("x", "int8") == 1.0
    with pytest.raises(FileNotFoundError, match="launch.calibrate"):
        tm.load_calibration(str(tmp_path / "missing.json"))


def test_fit_calibration_matches_jax():
    with open(JAX_CALIBRATION) as f:
        rows = json.load(f)["units"]
    rows = rows + [{"kind": "head", "container": "int8",
                    "ratio": float("inf")},
                   {"kind": "head", "container": "int8", "ratio": -1.0},
                   {"kind": "embed", "skipped": "whatever"}]
    j, t = jm.fit_calibration(rows), tm.fit_calibration(rows)
    assert set(t.ratios) == set(j.ratios)
    for kind, d in j.ratios.items():
        assert set(t.ratios[kind]) == set(d)
        for c, v in d.items():
            np.testing.assert_allclose(t.ratios[kind][c], v, rtol=1e-9)
    two = tm.fit_calibration([{"kind": "k", "container": "int8", "ratio": r}
                              for r in (2.0, 8.0)])
    assert two.factor("k", "int8") == pytest.approx(4.0)      # geomean


def test_fit_extra_factor_matches_jax():
    js, ts = _specs()
    ctx = LatencyContext(tokens=192, seq_ctx=48, mode="prefill", batch=4)
    tctx = tlat.LatencyContext(tokens=192, seq_ctx=48, mode="prefill",
                               batch=4)
    j = jm.CalibrationTable(ratios=_synth_ratios(js))
    t = tm.CalibrationTable(ratios=_synth_ratios(ts))
    jref_p, tref_p = jp.Policy.reference(js), tp.Policy.reference(ts)
    target = 2.5 * policy_latency(js, jref_p, V5E, ctx, calib=j).total_s
    jm.fit_extra_factor(j, js, jref_p, target, V5E, ctx)
    tm.fit_extra_factor(t, ts, tref_p, target, tlat.V5E, tctx)
    np.testing.assert_allclose(t.extra_factor(), j.extra_factor(),
                               rtol=1e-9)
    got = tlat.policy_latency(ts, tref_p, tlat.V5E, tctx, calib=t).total_s
    assert got == pytest.approx(target, rel=1e-9)


def test_calibrated_policy_latency_matches_jax():
    js, ts = _specs()
    j = jm.CalibrationTable.load(JAX_CALIBRATION)
    t = tm.CalibrationTable.load(JAX_CALIBRATION)
    rng = np.random.default_rng(0)
    for _ in range(8):
        pj, pt = jp.Policy.reference(js), tp.Policy.reference(ts)
        for i, (sj, st) in enumerate(zip(js, ts)):
            a = rng.random(3).astype(np.float32)
            pj.cmps[i] = jp.map_actions(sj, a, "pq")
            pt.cmps[i] = tp.map_actions(st, a, "pq")
        want = policy_latency(js, pj, V5E, LatencyContext(**CTX), calib=j)
        got = tlat.policy_latency(ts, pt, tlat.V5E,
                                  tlat.LatencyContext(**CTX), calib=t)
        np.testing.assert_allclose(got.total_s, want.total_s, rtol=1e-6)
        np.testing.assert_allclose([u.time_s for u in got.units],
                                   [u.time_s for u in want.units],
                                   rtol=1e-6)
        assert jm.policy_bits_by_name(js, pj) == \
            tm.policy_bits_by_name(ts, pt)


def test_container_for_bits_and_widest_wins():
    assert [tlat.container_for_bits(b) for b in (32, 9, 8, 5, 4, 2)] == \
        ["raw", "raw", "int8", "int8", "int4", "int4"]
    _, ts = _specs()
    pol = tm.uniform_policy(ts, "int8")
    idx = [i for i, s in enumerate(ts) if s.kind == "mlp_up"]
    pol.cmps[idx[0]] = tp.LayerCMP(keep=ts[idx[0]].prune_dim, mode="FP32")
    bits = tm.policy_bits_by_name(ts, pol)
    assert bits["w_up"] == 32 and bits["w_down"] == 8
    cm = tcompress.CompressibleLM(TArchConfig(**TINY),
                                  TM.init(TArchConfig(**TINY), seed=0,
                                          device="cpu"))
    qp = tm.deploy_policy_params(cm, pol)
    for layer in qp["blocks"]:            # one name, one container
        assert "w" in layer["mlp"]["w_up"]
        assert "w_q" in layer["mlp"]["w_down"]
    four = tm.deploy_policy_params(cm, tm.uniform_policy(ts, "int4"))
    assert "w_p" in four["blocks"][0]["attn"]["wq"]
    assert "w_q" in four["embed"]        # mix-unsupported: int8


# --------------------------------------------------------------------------
# Calibrated search fed the JAX draws; measured mode
# --------------------------------------------------------------------------

EPISODES, WARMUP, UPDATES, BATCH = 4, 2, 2, 16
SEARCH = {**TINY, "num_layers": 2}


def _synth_sensitivity(specs):
    """Seeded KLs for every probe of every unit, fed to both searches
    (the sensitivity analysis itself is held against the JAX package in
    ``test_torch_search.py``)."""
    rng = np.random.default_rng(7)
    return {s.name: {p: float(rng.random()) for p in tsens.FEATURE_PROBES}
            for s in specs}


@pytest.fixture(scope="module")
def calibrated_searches():
    cfg = ArchConfig(**SEARCH)
    params = M.init(cfg, jax.random.PRNGKey(0))
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3)
    ddpg = dict(warmup_episodes=WARMUP, updates_per_episode=UPDATES,
                batch_size=BATCH, buffer_size=200, hidden=(32, 24))
    reward = dict(target_ratio=0.5, beta=-3.0)
    with open(JAX_CALIBRATION) as f:
        table = json.load(f)
    jmodel = CompressibleLM(cfg, params)
    kls = _synth_sensitivity(jmodel.specs)
    js = CompressionSearch(
        jmodel, batch,
        SearchConfig(methods="pq", episodes=EPISODES, seed=0,
                     reward=RewardConfig(**reward), ddpg=DDPGConfig(**ddpg),
                     oracle_mode="calibrated"),
        LatencyContext(**CTX), sens=jsens.SensitivityResult(kls),
        calib=jm.CalibrationTable.from_dict(table))
    tcfg = TArchConfig(**SEARCH)
    tmodel = tcompress.CompressibleLM(
        tcfg, convert.lm_params(tcfg, jax.device_get(params), device="cpu"))
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    ts = tsearch.CompressionSearch(
        tmodel, tb,
        tsearch.SearchConfig(methods="pq", episodes=EPISODES, seed=0,
                             reward=treward.RewardConfig(**reward),
                             ddpg=tddpg.DDPGConfig(**ddpg),
                             oracle_mode="calibrated"),
        tlat.LatencyContext(**CTX),
        sens=tsens.SensitivityResult(kls),
        calib=tm.CalibrationTable.from_dict(table))
    ts.agent.state = convert.agent_state(jax.device_get(js.agent.state),
                                         device="cpu")

    fed = []
    j_chunk = js.agent.update_chunk

    def recording_chunk(replay, n):
        if n > 0 and len(replay) >= BATCH:
            _, keys = jddpg.chunk_sample_keys(js.agent.state.key, n)
            fed.append(np.stack([np.asarray(jax.random.randint(
                k, (BATCH,), 0, max(len(replay), 1))) for k in keys]))
        return j_chunk(replay, n)

    js.agent.update_chunk = recording_chunk
    jr = js.run()
    t_chunk = ts.agent.update_chunk

    def fed_chunk(replay, n):
        if n > 0 and len(replay) >= BATCH:
            return t_chunk(replay, n, indices=torch.as_tensor(fed.pop(0)))
        return t_chunk(replay, n)

    ts.agent.update_chunk = fed_chunk
    tr = ts.run()
    assert not fed
    return js, ts, jr, tr


def test_calibrated_search_records_match_jax(calibrated_searches):
    js, ts, jr, tr = calibrated_searches
    analytic = tlat.policy_latency(ts.specs, ts.ref_policy, ts.hw, ts.ctx)
    assert tr.ref_latency_s != analytic.total_s       # the table took hold
    np.testing.assert_allclose(tr.ref_latency_s, jr.ref_latency_s,
                               rtol=1e-6)
    assert tr.ref_accuracy == jr.ref_accuracy
    assert len(tr.history) == len(jr.history) == EPISODES
    for j, t in zip(jr.history, tr.history):
        jc = [(c.keep, c.mode, c.w_bits, c.a_bits) for c in j.policy.cmps]
        tc = [(c.keep, c.mode, c.w_bits, c.a_bits) for c in t.policy.cmps]
        assert tc == jc, f"episode {j.episode}: CMPs differ"
        assert t.accuracy == j.accuracy, f"episode {j.episode}"
        np.testing.assert_allclose(t.latency_s, j.latency_s, rtol=1e-6)
        np.testing.assert_allclose(t.latency_ratio, j.latency_ratio,
                                   rtol=1e-6)
        np.testing.assert_allclose(t.reward, j.reward, atol=1e-5)
    assert tr.measured is None and jr.measured is None


def test_search_rejects_unknown_oracle_mode():
    cfg = TArchConfig(**TINY)
    cm = tcompress.CompressibleLM(cfg, TM.init(cfg, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="oracle_mode"):
        tsearch.CompressionSearch(cm, None,
                                  tsearch.SearchConfig(oracle_mode="wall"),
                                  tlat.LatencyContext(**CTX))


def test_measured_mode_times_top_k_and_memoizes(monkeypatch):
    cfg = TArchConfig(**{**TINY, "num_layers": 2})
    cm = tcompress.CompressibleLM(cfg, TM.init(cfg, seed=0, device="cpu"))
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(5).integers(0, 128, (2, 16)),
        dtype=torch.int64)}
    scfg = tsearch.SearchConfig(
        methods="q", episodes=5, seed=0,
        reward=treward.RewardConfig(target_ratio=0.6),
        ddpg=tddpg.DDPGConfig(warmup_episodes=2, updates_per_episode=2,
                              batch_size=8, buffer_size=64),
        oracle_mode="measured", measure_top_k=2)
    res = tsearch.CompressionSearch(
        cm, batch, scfg, tlat.LatencyContext(**CTX),
        calib=tm.CalibrationTable(ratios=_synth_ratios(cm.specs))).run()
    assert len(res.measured) == 2
    for row in res.measured:
        assert row["measured_s"] > 0 and row["measured_ref_s"] > 0
        assert row["measured_ratio"] == pytest.approx(
            row["measured_s"] / row["measured_ref_s"])
        assert row["predicted_ratio"] == pytest.approx(
            row["predicted_s"] / res.ref_latency_s)
    assert res.measured[0]["reward"] >= res.measured[1]["reward"]
    # identical container signature -> memo hit, no re-deploy
    pol = tm.uniform_policy(cm.specs, "int8")
    mcfg = tm.MeasureConfig(warmup=1, repeats=1)
    t1 = tm.measure_policy(cm, pol, batch, mcfg)
    monkeypatch.setattr(tm, "quantize_params_for_deploy",
                        lambda *a, **k: pytest.fail("memo miss"))
    assert tm.measure_policy(cm, tm.uniform_policy(cm.specs, "int8"), batch,
                             mcfg) == t1


def _resnet_pair():
    """The tests' tiny ResNet (``tests/conftest.py``'s sizes) as a (JAX,
    port) adapter pair on the port's seeded weights, and a blob batch."""
    from repro.core.compress import CompressibleResNet
    from repro.data.pipeline import blob_images
    from repro.models import resnet as JR
    from repro_torch.data.pipeline import blob_images as tblob
    from repro_torch.models import resnet as TR
    args = dict(stages=(1, 1), widths=(8, 16), img_size=8, num_classes=4)
    tparams = TR.init(TR.ResNetConfig(**args), seed=0, device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tparams)
    return (CompressibleResNet(JR.ResNetConfig(**args), jparams),
            tcompress.CompressibleResNet(TR.ResNetConfig(**args), tparams),
            blob_images(4, 16, 8, seed=5), tblob(4, 16, 8, seed=5,
                                                 device="cpu"))


def test_deployed_resnet_forward_raw_matches_jax():
    """The deployed raw ResNet forward equals the JAX one (≤1e-5 of the
    largest logit), and ``measure_model_row`` times it."""
    jcm, tcm, jb, tb = _resnet_pair()
    want = np.asarray(jm._deployed_forward(jcm)(jcm.params, jb))
    got = tm._deployed_forward(tcm)(tcm.params, tb).numpy()
    assert got.shape == (16, 4)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    row = tm.measure_model_row(tcm, tb, "raw",
                               tm.MeasureConfig(warmup=1, repeats=1))
    assert row["container"] == "raw" and row["measured_s"] > 0


@pytest.mark.parametrize("container", ["int8", "int4"])
def test_deployed_resnet_forward_refuses_containers(container):
    """A ResNet tree with int8 or packed-int4 containers: the JAX
    package's deployed forward fails with ``KeyError: 'w'``
    (``resnet._conv`` reads ``p["w"]``); the port's raises ValueError
    naming that limitation."""
    jcm, tcm, jb, tb = _resnet_pair()
    cfg = tm.MeasureConfig(warmup=1, repeats=1)
    with pytest.raises(KeyError, match="'w'"):
        jm.measure_model_row(jcm, jb, container, cfg)
    with pytest.raises(ValueError, match=r"resnet\.py:49"):
        tm.measure_model_row(tcm, tb, container, cfg)


def test_calibration_path_on_cpu():
    """``launch.calibrate.run`` and ``chip_smoke.py``'s calibration and
    measured-search phases at a small size on the CPU (the plain versions
    stand in for the kernels): rows, fits and demo all present and
    finite, the measured search's rows and reference latency checked."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.configs.testbed import LM_CFG
    cfg = LM_CFG.replace(num_layers=1, d_ff=256)
    out = chip_smoke.run_calibration(cfg, "cpu", verbose=False)
    kinds = {r["kind"] for r in out["units"]}
    assert kinds == {"embed", "attn_qkv", "attn_out", "mlp_up", "mlp_down",
                     "head"}
    assert set(out["model"]) == set(tlat.CONTAINERS)
    assert [r["kernel"] for r in out["kernels"]] == [
        "dense_f32", "quant_matmul_int8", "quant_matmul_int4"]
    assert out["meta"]["backend"] == "cpu"
    assert all("roofline" not in r for r in out["model"].values())
    res = chip_smoke.run_measured_search(cfg, "cpu", out, episodes=3,
                                         warmup=2, updates=1, batch_size=8)
    assert len(res.measured) == 3
