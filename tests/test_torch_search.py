"""The slice as a whole: the port's pq ``CompressionSearch`` against the
JAX package's on the same tiny f32 LM.

Both searches get the same weights (``repro_torch.convert``) and the same
initial ``AgentState``; the port is fed the replay indices the JAX
update chunks draw (recomputed from the agent key as
``device_replay_sample`` draws them). Exploration needs no feeding: both
act on the host with ``np.random.default_rng(seed)``. Each search runs
its own sensitivity analysis.

Tolerances: CMPs and accuracy exact; ``latency_s`` ≤1e-6 relative;
reward ≤1e-5; sensitivity KLs ≤1e-6 (the bound the JAX package holds its
fused analysis to against its sequential one).

These exact equalities (CMPs and accuracy on the same policies) rest on
this test's draws: under a quantized policy a last-bit range difference
can move a whole fake-quant step and flip an argmax, so over many draws
the port's f32 accuracy is only within one token of JAX's
(``tests/test_torch_flips.py`` states the bound).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import ddpg as jddpg  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.ddpg import DDPGConfig  # noqa: E402
from repro.core.latency import LatencyContext  # noqa: E402
from repro.core.reward import RewardConfig  # noqa: E402
from repro.core.search import CompressionSearch, SearchConfig  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.models import model as M  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import latency as tlatency  # noqa: E402
from repro_torch.core import reward as treward  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
EPISODES, WARMUP, UPDATES, BATCH = 6, 2, 2, 16
CTX = dict(tokens=1, seq_ctx=512, mode="decode", batch=1)


def _tiny_cfg():
    return ArchConfig(name="t", num_layers=3, d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=128,
                      scan_layers=True, compute_dtype="float32")


def _port_cfg(cfg):
    return TArchConfig(**{k: getattr(cfg, k)
                          for k in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def searches():
    cfg = _tiny_cfg()
    params = M.init(cfg, jax.random.PRNGKey(0))
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3)
    ddpg = dict(warmup_episodes=WARMUP, updates_per_episode=UPDATES,
                batch_size=BATCH, buffer_size=200, hidden=(32, 24))
    reward = dict(target_ratio=0.5, beta=-3.0)

    js = CompressionSearch(
        CompressibleLM(cfg, params), batch,
        SearchConfig(methods="pq", episodes=EPISODES, seed=0,
                     reward=RewardConfig(**reward), ddpg=DDPGConfig(**ddpg)),
        LatencyContext(**CTX))
    tcfg = _port_cfg(cfg)
    tm = tcompress.CompressibleLM(
        tcfg, convert.lm_params(tcfg, jax.device_get(params), device="cpu"))
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    j_state = jax.device_get(js.agent.state)

    def port_search(sens=None):
        ts = tsearch.CompressionSearch(
            tm, tb,
            tsearch.SearchConfig(methods="pq", episodes=EPISODES, seed=0,
                                 reward=treward.RewardConfig(**reward),
                                 ddpg=tddpg.DDPGConfig(**ddpg)),
            tlatency.LatencyContext(**CTX), sens=sens)
        ts.agent.state = convert.agent_state(j_state, device="cpu")
        return ts

    ts = port_search()
    # the same search on the JAX package's sensitivity table, so that its
    # agent sees exactly the JAX states (the standardization divides
    # near-constant KL features by their tiny spread, which magnifies the
    # ≤1e-6 KL differences in the network inputs)
    ts_fed = port_search(tsens.SensitivityResult(dict(js.sens.table)))

    # record the replay indices of every JAX update chunk, feed them to
    # the port's chunks in the same order
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

    def feed(search):
        queue = list(fed)
        chunk = search.agent.update_chunk

        def fed_chunk(replay, n):
            if n > 0 and len(replay) >= BATCH:
                return chunk(replay, n, indices=torch.as_tensor(queue.pop(0)))
            return chunk(replay, n)

        search.agent.update_chunk = fed_chunk
        result = search.run()
        assert not queue          # every JAX chunk was replayed
        return result

    tr = feed(ts)
    feed(ts_fed)
    assert len(fed) == EPISODES - WARMUP
    return js, ts, ts_fed, jr, tr


def test_search_records_match_jax(searches):
    js, ts, _, jr, tr = searches
    assert tr.ref_accuracy == jr.ref_accuracy
    np.testing.assert_allclose(tr.ref_latency_s, jr.ref_latency_s,
                               rtol=1e-6)
    assert len(tr.history) == len(jr.history) == EPISODES
    for j, t in zip(jr.history, tr.history):
        jc = [(c.keep, c.mode, c.w_bits, c.a_bits) for c in j.policy.cmps]
        tc = [(c.keep, c.mode, c.w_bits, c.a_bits) for c in t.policy.cmps]
        assert tc == jc, f"episode {j.episode}: CMPs differ"
        assert t.accuracy == j.accuracy, f"episode {j.episode}"
        np.testing.assert_allclose(t.latency_s, j.latency_s, rtol=1e-6)
        np.testing.assert_allclose(t.reward, j.reward, atol=1e-5)
        assert t.sigma == j.sigma


def test_search_agent_state_after_updates(searches):
    """After 4 fed update chunks (on the JAX sensitivity table) the
    port's agent is where the JAX agent is: every network, moment and
    statistic leaf ≤1e-5."""
    js, _, ts, *_ = searches
    j = jax.device_get(js.agent.state)
    t = ts.agent.state
    for name in ("actor", "critic", "target_actor", "target_critic"):
        for jl, tl in zip(getattr(j, name), getattr(t, name)):
            for k in jl:
                np.testing.assert_allclose(tl[k].numpy(), jl[k], atol=1e-5,
                                           err_msg=f"{name}.{k}")
    for name in ("opt_a", "opt_c"):
        jo, to = getattr(j, name), getattr(t, name)
        assert to["t"] == int(jo["t"])
        for mom in ("m", "v"):
            for jl, tl in zip(jo[mom], to[mom]):
                for k in jl:
                    np.testing.assert_allclose(tl[k].numpy(), jl[k],
                                               atol=1e-5)
    np.testing.assert_allclose(float(t.reward_ma), float(j.reward_ma),
                               atol=1e-5)


def test_sensitivity_matches_jax_run_sensitivity(searches):
    """The port's per-probe analysis vs the JAX package's fused
    ``run_sensitivity``: every layer×probe KL ≤1e-6."""
    js, ts, *_ = searches
    assert set(ts.sens.table) == set(js.sens.table)
    for layer, row in js.sens.table.items():
        assert set(ts.sens.table[layer]) == set(row), layer
        for tag, kl in row.items():
            assert abs(ts.sens.table[layer][tag] - kl) <= 1e-6, (layer, tag)


def test_search_rejects_unported_oracle_modes(tmp_path):
    """Every oracle mode of the JAX package is ported: an unknown one is
    refused, and a calibrated or measured search without a table says
    how to measure one."""
    cfg = _port_cfg(_tiny_cfg())
    tm = tcompress.CompressibleLM(cfg, _port_params(cfg))
    with pytest.raises(ValueError, match="oracle_mode"):
        tsearch.CompressionSearch(
            tm, None, tsearch.SearchConfig(oracle_mode="wallclock"),
            tlatency.LatencyContext(**CTX))
    for mode in ("calibrated", "measured"):
        with pytest.raises(FileNotFoundError, match="launch.calibrate"):
            tsearch.CompressionSearch(
                tm, None, tsearch.SearchConfig(
                    oracle_mode=mode,
                    calibration_path=str(tmp_path / "none.json")),
                tlatency.LatencyContext(**CTX))


def _port_params(cfg):
    from repro_torch.models import model as TM
    return TM.init(cfg, seed=0, device="cpu")


def test_chip_smoke_main_path_on_cpu():
    """``chip_smoke.py``'s main-path phase at a small size on the CPU (the
    plain versions stand in for the kernels): records, checks and the
    plain-vs-plain agreement all pass."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.configs.testbed import LM_CFG
    cfg = LM_CFG.replace(num_layers=2, d_ff=512)
    search, history, _, _ = chip_smoke.run_main_path(
        cfg, "cpu", episodes=4, warmup=2, updates=2, batch_size=16,
        val_batch=4, val_seq=16, verbose=False)
    chip_smoke.check_main_path(search, history, cfg, 4)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the script exits non-zero and prints no result."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
