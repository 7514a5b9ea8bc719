"""The port's fleet (``core/search.py::FleetSearch``,
``launch/fleet.py``, ``distributed/sharding.py``) against the JAX
package's, on the CPU (mirrors ``tests/test_fleet.py``'s in-process
tests; its subprocess tests need eight forced host devices, which the
port's one-device fleet has no counterpart for).

  * the reference's rejections: members not in epoch mode, a mesh
    without a ``data`` axis, a checkpoint without a directory, episodes
    that are not whole batches; and the port's own: a mesh of several
    devices.
  * ``pad_members`` equal to JAX's; ``population_shardings`` the
    identity placement on one device.
  * a fleet (P 4, K 4, E 2, 16 episodes: two shared epochs, the first
    straddling warmup) against the JAX ``FleetSearch(mesh=None)`` on the
    tiny LM in f32, the JAX agents carried over, the JAX sensitivity
    table, and every member's JAX draws (its rollout key's batch keys)
    and replay indices (its agent key's chunk keys) fed in: the records
    at ``tests/test_torch_population.py``'s bounds (policies equal,
    accuracy 1e-6, latency 1e-6 relative, reward 1e-5), the rings'
    ptr/size equal, the logs "epoch" per epoch.
  * the manifest's ``extra`` of a port checkpoint: the JAX fleet
    checkpoint's keys, and the same cursor, seeds, methods and ring
    mirrors.
  * ``launch.fleet.main`` on the CPU: an uninterrupted run checkpointing
    every epoch, a run stopped after 2 epochs, and a fresh fleet that
    restores and finishes; the resumed tail's records, every agent and
    ring tensor, the norm mirrors and both generators' states equal the
    uninterrupted run's exactly, and the restore wrote into the fleet's
    own tensors (``data_ptr`` unchanged).
"""
import json
import os
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import ddpg as jddpg  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.reward import RewardConfig  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import model as M  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.distributed import sharding as tsharding  # noqa: E402
from repro_torch.launch import fleet as tfleet  # noqa: E402

from test_torch_fused import _cmps, _port_cfg, _sens_pair, _t, jax_draws  # noqa: E402,E501

P, K, E, EPISODES, BATCH = 4, 4, 2, 16, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    """The launcher's tiny LM in f32 on both sides (JAX's weights carried
    over), its bigram validation batch and one seeded KL table."""
    cfg = ArchConfig(**tfleet.TINY_FLEET_CFG, compute_dtype="float32")
    params = M.init(cfg, jax.random.PRNGKey(0))
    tcfg = _port_cfg(cfg)
    tm = tcompress.CompressibleLM(
        tcfg, convert.lm_params(tcfg, jax.device_get(params), device="cpu"))
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3)
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    jsens, tsn = _sens_pair(tm.specs, 17)
    return CompressibleLM(cfg, params), tm, batch, tb, jsens, tsn


def _jax_members(jcm, jb, jsens, n=P, epoch_batches=E):
    """``repro.launch.fleet.tiny_fleet``'s members on ``jcm``."""
    ctx = jlat.LatencyContext(**tfleet.FLEET_CTX)
    return [jsearch.FusedCompressionSearch(
        jcm, jb, jsearch.SearchConfig(
            methods="pq", episodes=64,
            reward=RewardConfig(target_ratio=0.5),
            ddpg=jddpg.DDPGConfig(warmup_episodes=4, updates_per_episode=2,
                                  batch_size=BATCH, buffer_size=256),
            seed=p),
        ctx, sens=jsens, batch_size=K, epoch_batches=epoch_batches)
        for p in range(n)]


def _port_members(lm, n=P, epoch_batches=E):
    _, tm, _, tb, _, tsn = lm
    return tfleet.tiny_fleet_members(tm, tb, members=n, batch_size=K,
                                     epoch_batches=epoch_batches, sens=tsn)


def _record_jax_draws(jfleet, T, A):
    """Wrap the JAX fleet's ``run_epoch`` to record, before each shared
    epoch, every member's draws and replay indices as its epoch scan
    derives them (``tests/test_torch_epoch.py``'s recording, member by
    member). Returns the per-member queues."""
    draws = [[] for _ in jfleet.members]
    fed = [[] for _ in jfleet.members]
    real = jfleet.run_epoch

    def recording(first, nb):
        for i, m in enumerate(jfleet.members):
            rk, key = m._rollout_key, m.agent.state.key
            size, cap = m.replay.size, m.replay.capacity
            for n in m._update_schedule(first, nb):
                rk, bk = jax.random.split(rk)
                draws[i].append(jax_draws(bk, T, K, A))
                size = min(size + T * K, cap)
                if n:
                    key, ks = jddpg.chunk_sample_keys(key, n)
                    fed[i].append(np.stack([np.asarray(jax.random.randint(
                        k, (BATCH,), 0, max(size, 1))) for k in ks]))
        return real(first, nb)

    jfleet.run_epoch = recording
    return draws, fed


@pytest.fixture(scope="module")
def fleets(lm, tmp_path_factory):
    """The JAX fleet and the port's, both checkpointing every epoch, the
    port fed the JAX draws and indices. Returns (JAX fleet, port fleet,
    JAX results, port results, JAX ckpt dir, port ckpt dir)."""
    jcm, tm, jb, tb, jsens, tsn = lm
    jdir = str(tmp_path_factory.mktemp("jax_fleet"))
    tdir = str(tmp_path_factory.mktemp("port_fleet"))
    jfleet = jsearch.FleetSearch(_jax_members(jcm, jb, jsens), mesh=None,
                                 ckpt_dir=jdir)
    members = _port_members(lm)
    for j, t in zip(jfleet.members, members):
        t.agent.state = convert.agent_state(jax.device_get(j.agent.state),
                                            device="cpu")
    T, A = len(members[0].steps), members[0].agent.cfg.action_dim
    draws, fed = _record_jax_draws(jfleet, T, A)
    jr = jfleet.run_fleet(EPISODES)
    tfl = tsearch.FleetSearch(members, mesh=None, ckpt_dir=tdir)
    for i, m in enumerate(tfl.members):
        def fed_draws(uniforms, normals, d=draws[i]):
            uni, nrm = d.pop(0)
            uniforms.copy_(_t(uni))
            normals.copy_(_t(nrm))

        def fed_indices(indices, size, q=fed[i]):
            idx = q.pop(0)
            assert idx.shape == tuple(indices.shape) and idx.max() < size
            indices.copy_(_t(idx))

        m._fill_draws, m._fill_indices = fed_draws, fed_indices
    tr = tfl.run_fleet(EPISODES)
    assert not any(draws) and not any(fed)
    return jfleet, tfl, jr, tr, jdir, tdir


# ------------------------------------------------------------ rejections

def test_fleet_rejects_non_epoch_members(lm):
    with pytest.raises(ValueError, match="epoch mode"):
        tsearch.FleetSearch(_port_members(lm, n=2, epoch_batches=0))


def test_fleet_rejects_mesh_without_data_axis_or_of_several_devices(lm):
    no_data = types.SimpleNamespace(axis_names=("model",),
                                    shape={"model": 1})
    with pytest.raises(ValueError, match="data"):
        tsearch.FleetSearch(_port_members(lm, n=2), mesh=no_data)
    wide = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="one device"):
        tsearch.FleetSearch(_port_members(lm, n=2), mesh=wide)
    one = types.SimpleNamespace(axis_names=("data", "model"),
                                shape={"data": 1, "model": 1})
    assert tsearch.FleetSearch(_port_members(lm, n=2), mesh=one).mesh is one


def test_fleet_checkpoint_requires_dir(lm):
    fleet = tsearch.FleetSearch(_port_members(lm, n=2))
    with pytest.raises(ValueError, match="ckpt_dir"):
        fleet.save_checkpoint()
    with pytest.raises(ValueError, match="directory"):
        fleet.restore_latest_checkpoint()


def test_fleet_episodes_must_be_whole_batches(lm):
    fleet = tsearch.FleetSearch(_port_members(lm, n=2))
    with pytest.raises(ValueError, match="multiple"):
        fleet.run_fleet(6)          # batch size is 4


def test_fleet_mesh_on_one_device():
    assert tfleet.fleet_mesh(4, data=0) is None
    assert tfleet.fleet_mesh(4, data=1) is None
    want = 1          # the largest power of two <= min(members, cards)
    while want * 2 <= min(4, torch.cuda.device_count()):
        want *= 2
    assert tfleet.fleet_data_axis(4) == want
    with pytest.raises(ValueError, match="one card"):
        tfleet.fleet_mesh(4, data=2)


# ---------------------------------------------------------- member axis

@pytest.mark.parametrize("n,data", [(1, 1), (3, 4), (4, 4), (5, 2), (2, 8)])
def test_pad_members_matches_jax(n, data):
    trees = [{"w": np.full((3, 2), i, np.float32)} for i in range(n)]
    got, want = tsharding.pad_members(trees, data), \
        jsharding.pad_members(trees, data)
    assert len(got) == len(want) and len(got) % data == 0
    assert all(a is b for a, b in zip(got, want))


def test_population_shardings_is_the_identity_on_one_device(lm):
    fleet = tsearch.FleetSearch(_port_members(lm, n=2))
    place = tsharding.population_shardings(fleet.state, None)
    assert type(place) is type(fleet.state)
    assert all(d == torch.device("cpu") for d in tddpg.state_leaves(place))
    assert tsharding.member_sharding(None, 2, "cpu") == torch.device("cpu")
    wide = types.SimpleNamespace(axis_names=("data",), shape={"data": 4})
    for fn in (lambda: tsharding.population_shardings(fleet.state, wide),
               lambda: tsharding.member_sharding(wide, 2, "cpu")):
        with pytest.raises(ValueError, match="one device"):
            fn()


# ------------------------------------------------------ against JAX

def test_fleet_records_match_jax(fleets):
    """Two shared epochs of four members: the records as the JAX
    fleet's, one "epoch" dispatch an epoch on every member, the same
    ring mirrors, cursors and epoch counts."""
    jfleet, tfl, jr, tr, _, _ = fleets
    assert tfl.epoch_cursor == jfleet.epoch_cursor == EPISODES
    assert tfl.epochs_run == jfleet.epochs_run == EPISODES // (K * E)
    for t, j, tm, jm in zip(tr, jr, tfl.members, jfleet.members):
        assert [r.episode for r in t.history] == list(range(EPISODES))
        for a, b in zip(t.history, j.history):
            assert _cmps(a.policy) == _cmps(b.policy), f"episode {b.episode}"
            np.testing.assert_allclose(a.accuracy, b.accuracy, atol=1e-6)
            np.testing.assert_allclose(a.latency_s, b.latency_s, rtol=1e-6)
            np.testing.assert_allclose(a.reward, b.reward, atol=1e-5)
            assert a.sigma == pytest.approx(b.sigma, rel=1e-6)
        assert tm.dispatch_log == jm.dispatch_log == ["epoch"] * 2
        assert (tm.replay.ptr, tm.replay.size) == (jm.replay.ptr,
                                                   jm.replay.size)
    assert tfl.readbacks == 2
    assert tfl.monitor.summary()["recorded"] == 2


def _extra(directory):
    with open(os.path.join(directory, "LATEST")) as f:
        step = f.read().strip()
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["extra"]


def test_manifest_extra_matches_jax(fleets):
    _, _, _, _, jdir, tdir = fleets
    jx, tx = _extra(jdir), _extra(tdir)
    assert sorted(tx) == sorted(jx) == sorted([
        "epoch_cursor", "epochs_run", "mesh_shape", "member_seeds",
        "member_methods", "ring_ptr", "ring_size", "monitor"])
    for key in ("epoch_cursor", "epochs_run", "mesh_shape", "member_seeds",
                "member_methods", "ring_ptr", "ring_size"):
        assert tx[key] == jx[key], key
    assert sorted(tx["monitor"]) == sorted(jx["monitor"])
    assert tx["monitor"]["recorded"] == jx["monitor"]["recorded"] == 2


# ------------------------------------------------------- launcher, resume

def _run(capsys, *args):
    out = tfleet.main(["--device", "cpu", "--data", "0", "--json", *args])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    printed = json.loads(line)
    assert printed == {k: v for k, v in json.loads(json.dumps(
        {k: v for k, v in out.items() if k != "fleet"})).items()}
    return out


def test_launcher_resume_is_bit_exact(capsys, tmp_path):
    """The uninterrupted run and stop / restore / finish through
    ``main``: the tail's records equal the uninterrupted run's; every
    agent, ring and generator state and the host mirrors too; the
    restore copied into the fleet's own tensors."""
    full = _run(capsys, "--ckpt-dir", str(tmp_path / "a"))
    head = _run(capsys, "--ckpt-dir", str(tmp_path / "b"),
                "--stop-after-epochs", "2")
    assert head["epoch_cursor"] == 16 and head["epochs_run"] == 2
    assert _extra(str(tmp_path / "b"))["epoch_cursor"] == 16
    # the restore happens inside main: watch its tensors' addresses
    seen = {}
    real = tsearch.FleetSearch.restore_latest_checkpoint

    def watched(self, directory=None):
        before = [t.data_ptr() for t in tddpg.state_leaves(self.state)
                  + list(self.ring)]
        extra = real(self, directory)
        seen["same"] = before == [t.data_ptr() for t in tddpg.state_leaves(
            self.state) + list(self.ring)]
        seen["views"] = all(
            mine.data_ptr() == stacked[i].data_ptr()
            for i, m in enumerate(self.members)
            for mine, stacked in zip(tddpg.state_leaves(m.agent.state),
                                     tddpg.state_leaves(self.state)))
        return extra

    tsearch.FleetSearch.restore_latest_checkpoint = watched
    try:
        tail = _run(capsys, "--ckpt-dir", str(tmp_path / "b"), "--resume")
    finally:
        tsearch.FleetSearch.restore_latest_checkpoint = real
    assert seen == {"same": True, "views": True}
    assert tail["epoch_cursor"] == 32 and tail["epochs_run"] == 4
    assert full["epochs_run"] == 4 and full["members"] == 4
    assert full["mesh"] is None and full["devices"] == 1
    for h, t, f in zip(head["records"], tail["records"], full["records"]):
        assert [r[0] for r in h + t] == list(range(32))
        assert h + t == f
    a, b = full["fleet"], tail["fleet"]
    for x, y in zip(tddpg.state_leaves(a.state) + list(a.ring),
                    tddpg.state_leaves(b.state) + list(b.ring)):
        assert torch.equal(x, y)
    for ma, mb in zip(a.members, b.members):
        assert (ma.replay.ptr, ma.replay.size) == (mb.replay.ptr,
                                                   mb.replay.size)
        assert ma.agent.norm.count == mb.agent.norm.count
        np.testing.assert_array_equal(ma.agent.norm.mean, mb.agent.norm.mean)
        np.testing.assert_array_equal(ma.agent.norm.var, mb.agent.norm.var)
        assert torch.equal(ma._rollout_gen.get_state(),
                           mb._rollout_gen.get_state())
        assert torch.equal(ma.agent.sample_gen.get_state(),
                           mb.agent.sample_gen.get_state())


def test_restore_refuses_another_member_count(capsys, tmp_path):
    _run(capsys, "--ckpt-dir", str(tmp_path), "--members", "2",
         "--episodes", "8")
    fleet = tfleet.tiny_fleet(members=3, data=0, ckpt_dir=str(tmp_path),
                              device="cpu")
    with pytest.raises(ValueError, match="members"):
        fleet.restore_latest_checkpoint()
    empty = tfleet.tiny_fleet(members=2, data=0, device="cpu",
                              ckpt_dir=str(tmp_path / "none"))
    assert empty.restore_latest_checkpoint() is None


# ------------------------------------------------ chip_smoke.py's phase

def test_chip_smoke_slice_fleet_phase_on_cpu():
    """``chip_smoke.py``'s slice and fleet phase at SMOKE widths on the
    CPU (plain versions in place of the kernels: nothing launches, and
    the steady epoch's count check is fed the counts a card run would
    make): the four prefills with sliced equal to masked, the SMOKE
    check, the CLI's resume bit for bit, and a two-member testbed-shaped
    fleet with its checkpoint restored in place; a wrong count is
    refused."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from repro_torch.configs.testbed import LM_CFG
    from repro_torch.core import sensitivity as tsens
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_config
    cfg = LM_CFG.replace(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=2, head_dim=16, d_ff=128)
    sens = tsens.SensitivityResult({s.name: {"w4": 0.01 * i} for i, s in
                                    enumerate(tcompress.lm_layer_specs(cfg))})
    counted = []
    real = chip_smoke.check_fused_launches
    chip_smoke.check_fused_launches = lambda got, want, what: counted.append(
        (what, want))
    launches = {}
    try:
        out = chip_smoke.slice_fleet_phase(
            "cpu", sens, {}, launches,
            slice_cfg=get_config("granite-3-8b", smoke=True), seq=256,
            smoke_seq=64, fleet_cfg=cfg, fleet_members=2, fleet_epochs=3,
            cli_argv=["--members", "2", "--episodes", "24"], updates=2,
            batch_size=16, val_batch=4, val_seq=16)
    finally:
        chip_smoke.check_fused_launches = real
    pre = out["prefill"]
    assert list(pre) == ["raw", "masked", "sliced", "sliced int8",
                         "sliced int4"]
    assert out["agree"]["argmax"] == 1.0 and out["agree"]["max_diff"] == 0
    assert pre["sliced"]["tflop"] < pre["raw"]["tflop"]
    assert all(chip_smoke.SLICE_KEEP[0] * 160 <= k <= chip_smoke.SLICE_KEEP[1]
               * 160 and k % 16 == 0 for k in out["keeps"])
    assert out["smoke"]["vs_masked"] <= chip_smoke.SLICE_SMOKE_TOL
    assert all(out["cli"]["same"].values()) and out["cli"]["resumed_at"] == 16
    assert out["cli"]["episodes"] == 24
    tb = out["testbed"]
    assert tb["ckpt_bytes"] > 0 and tb["k1"]["max_abs_err"] == 0.0
    assert tb["monitor"]["recorded"] == 4
    assert all(v == 0 for v in out["fleet_launches"].values())
    (what, want), = counted
    T = len(tcompress.lm_layer_specs(cfg))
    assert want["mlp3_members"] == 2 * T and want["adam_polyak"] == 0
    assert want["polyak"] == 2 * 2 * 8 * 2 and want["mlp3"] == 5 * 64
    with pytest.raises(AssertionError, match="polyak"):
        chip_smoke.check_fused_launches({**build.LAUNCHES, "polyak": 1},
                                        {"polyak": 2}, "a wrong count")
