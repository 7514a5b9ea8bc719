"""The port's production trainer on the CPU against the JAX package's:
the token pipeline (``data/pipeline.py``: ``DataConfig``,
``ShardedTokenDataset``, ``Prefetcher``), ``train/trainer.py::Trainer``
with its checkpoints, the launcher ``launch/train.py`` with its retry
loop, and the end-to-end example.

Tolerances, with what was found:
  * ``ShardedTokenDataset.batch_at``: bit-equal to JAX, synthetic and
    ``.npy`` shards (uint16 and uint32, two files), hosts 0 and 1 of 2.
  * ``Trainer`` on a tiny f32 config from the JAX weights, the same
    batches, 6 steps (checkpoints at 3 and 6): each logged loss within
    1e-5 of JAX's, every param within ``PARAM_TOL`` × the largest lr of
    the run (the units ``tests/test_torch_train.py`` holds steps in;
    found 0.014). Each package restores the other's step-3
    checkpoint and continues to the other's step 4-6 losses within 1e-5.
  * The launcher with one ``StepTimeout`` injected after step 4: the
    retry restores step 4 and its step 5-8 losses equal an
    uninterrupted run's (the CPU is deterministic: same ops, same
    inputs, an exact restore).
"""
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import checkpointing as C  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

TINY = dict(name="t-trainer", num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            scan_layers=True, compute_dtype="float32")
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=6, weight_decay=0.1)
DATA = dict(seq_len=16, global_batch=4)
PARAM_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# The token pipeline: tests/test_data_optim.py's four cases, then parity
# --------------------------------------------------------------------------

def test_bigram_table_stochastic():
    t = TD.make_bigram_table(64, seed=1)
    np.testing.assert_allclose(t.sum(1), 1.0, atol=1e-9)
    assert (t >= 0).all()


def test_batch_at_deterministic():
    ds = TD.ShardedTokenDataset("synthetic://128",
                                TD.DataConfig(seq_len=32, global_batch=8))
    a = ds.batch_at(17)["tokens"]
    b = ds.batch_at(17)["tokens"]
    np.testing.assert_array_equal(a, b)
    c = ds.batch_at(18)["tokens"]
    assert not np.array_equal(a, c)


def test_host_sharding_distinct():
    cfg = TD.DataConfig(seq_len=32, global_batch=8)
    d0 = TD.ShardedTokenDataset("synthetic://128", cfg, host_id=0,
                                num_hosts=2)
    d1 = TD.ShardedTokenDataset("synthetic://128", cfg, host_id=1,
                                num_hosts=2)
    assert d0.host_batch == 4
    assert not np.array_equal(d0.batch_at(0)["tokens"],
                              d1.batch_at(0)["tokens"])


def test_file_shards(tmp_path):
    toks = np.arange(10_000, dtype=np.int32) % 97
    np.save(tmp_path / "shard0.npy", toks)
    ds = TD.ShardedTokenDataset(str(tmp_path), TD.DataConfig(
        seq_len=16, global_batch=4))
    b = ds.batch_at(0)["tokens"]
    assert b.shape == (4, 16)


@pytest.mark.parametrize("source", ["synthetic", "shards"])
def test_batch_at_matches_jax(source, tmp_path):
    if source == "shards":
        rng = np.random.default_rng(3)
        np.save(tmp_path / "a.npy", rng.integers(0, 500, 3000, np.uint16))
        np.save(tmp_path / "b.npy", rng.integers(0, 70_000, 2000, np.uint32))
        path = str(tmp_path)
    else:
        path = "synthetic://96"
    for host, hosts in ((0, 1), (0, 2), (1, 2)):
        cfg = dict(seq_len=24, global_batch=6, shuffle_seed=5)
        jd = JD.ShardedTokenDataset(path, JD.DataConfig(**cfg), host, hosts)
        td = TD.ShardedTokenDataset(path, TD.DataConfig(**cfg), host, hosts)
        for step in (0, 1, 7, 1000):
            want, got = jd.batch_at(step)["tokens"], td.batch_at(step)["tokens"]
            assert got.dtype == np.int32 == want.dtype
            np.testing.assert_array_equal(got, want)


def test_prefetcher():
    """Batches reach the device as int64 tensors equal to the numpy
    batch, in order; iteration ends with the source; an error on the
    thread is raised to the consumer; ``stop`` drains the queue."""
    ds = TD.ShardedTokenDataset("synthetic://64", TD.DataConfig(**DATA))
    got = list(TD.Prefetcher(iter(ds.batch_at(s) for s in range(5)),
                             depth=2, device="cpu"))
    assert len(got) == 5
    for s, b in enumerate(got):
        assert b["tokens"].dtype == torch.int64
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      ds.batch_at(s)["tokens"])

    def broken():
        yield ds.batch_at(0)
        raise ValueError("bad shard")
    it = TD.Prefetcher(broken(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="bad shard"):
        next(it)
    pf = TD.Prefetcher(iter(ds), depth=2, device="cpu")
    next(pf)
    pf.stop()
    assert pf.q.qsize() <= 1


# --------------------------------------------------------------------------
# Trainer against the JAX Trainer, and checkpoints across the packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Trainer on TINY from ``PRNGKey(0)``: 6 steps of the
    synthetic stream, a loss logged every step, checkpoints at 3 and 6;
    its jitted step kept for the other JAX trainers of the file."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    jcfg = ArchConfig(**TINY)
    init = jax.device_get(jax.jit(JM.init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    tr = jtrainer.Trainer(jcfg, jopt.OptimizerConfig(**OPT), _tcfg(
        jtrainer.TrainerConfig, d), params=jax.tree.map(jax.numpy.asarray,
                                                       init))
    ds = JD.ShardedTokenDataset("synthetic://64", JD.DataConfig(**DATA))
    hist = tr.fit(ds.batch_at(s) for s in range(7))
    return dict(init=init, hist=hist, dir=str(d), trainer=tr,
                params=jax.device_get(tr.params))


def _tcfg(cls, d):
    return cls(total_steps=6, log_every=1, ckpt_every=3, ckpt_dir=str(d))


def _port_trainer(d, params=None):
    return ttrainer.Trainer(TArchConfig(**TINY), topt.OptimizerConfig(**OPT),
                            _tcfg(ttrainer.TrainerConfig, d), params=params,
                            device="cpu")


def _step3_only(src, dst):
    """A checkpoint dir holding only ``src``'s step 3."""
    shutil.copytree(f"{src}/step_3", f"{dst}/step_3")
    return str(dst)


def _losses(hist):
    return {r["step"]: r["loss"] for r in hist}


def test_trainer_matches_jax(jax_run, tmp_path):
    tcfg = TArchConfig(**TINY)
    start = convert.lm_params(tcfg, jax_run["init"], device="cpu")
    tr = _port_trainer(tmp_path, start)
    ds = TD.ShardedTokenDataset("synthetic://64", TD.DataConfig(**DATA))
    hist = tr.fit(ds.batch_at(s) for s in range(7))
    assert [r["step"] for r in hist] == list(range(1, 7))
    want = _losses(jax_run["hist"])
    for step, loss in _losses(hist).items():
        assert abs(loss - want[step]) <= 1e-5, (step, loss, want[step])
    lr_max = OPT["lr"]
    got = jax.tree.leaves(convert.to_jax_lm_params(tcfg, tr.params))
    err = max(float(np.abs(g - np.asarray(w)).max()) for g, w in zip(
        got, jax.tree.leaves(jax_run["params"])))
    assert err <= PARAM_TOL * lr_max, err / lr_max
    assert C.latest_step(str(tmp_path)) == 6
    for g, w in zip(jax.tree.leaves(convert.to_jax_lm_params(tcfg, start)),
                    jax.tree.leaves(jax_run["init"])):
        np.testing.assert_array_equal(g, np.asarray(w))    # not updated


def test_port_resumes_jax_checkpoint(jax_run, tmp_path):
    """The port Trainer (another init) restores JAX's step-3 checkpoint
    and continues to JAX's step 4-6 losses."""
    tr = _port_trainer(_step3_only(jax_run["dir"], tmp_path))
    tr.maybe_restore()
    assert tr.step == 3 and int(tr.opt_state["step"]) == 3
    ds = TD.ShardedTokenDataset("synthetic://64", TD.DataConfig(**DATA))
    hist = tr.fit(ds.batch_at(s) for s in range(3, 7))
    want = _losses(jax_run["hist"])
    assert sorted(_losses(hist)) == [4, 5, 6]
    for step, loss in _losses(hist).items():
        assert abs(loss - want[step]) <= 1e-5, (step, loss, want[step])


def test_jax_resumes_port_checkpoint(jax_run, tmp_path):
    """The JAX Trainer (another init) restores the port's step-3
    checkpoint and continues to the port's step 4-6 losses."""
    tcfg = TArchConfig(**TINY)
    port = _port_trainer(tmp_path / "port",
                         convert.lm_params(tcfg, jax_run["init"], "cpu"))
    ds = TD.ShardedTokenDataset("synthetic://64", TD.DataConfig(**DATA))
    want = _losses(port.fit(ds.batch_at(s) for s in range(7)))
    d = _step3_only(tmp_path / "port", tmp_path / "jax")
    jtr = jtrainer.Trainer(ArchConfig(**TINY), jopt.OptimizerConfig(**OPT),
                           _tcfg(jtrainer.TrainerConfig, d),
                           params=jax_run["trainer"].params)
    jtr.step_fn = jax_run["trainer"].step_fn       # one compile a file
    jtr.maybe_restore()
    assert jtr.step == 3
    jds = JD.ShardedTokenDataset("synthetic://64", JD.DataConfig(**DATA))
    hist = jtr.fit(jds.batch_at(s) for s in range(3, 7))
    for step, loss in _losses(hist).items():
        assert abs(loss - want[step]) <= 1e-5, (step, loss, want[step])


def test_trainer_qat_is_the_qat_step(tmp_path):
    """``Trainer(cspec=...)`` runs ``make_train_step(cfg, opt_cfg,
    cspec=cspec)``: under a seeded pq policy its losses and params equal
    those of the step called by hand on the same batches, bit for bit."""
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.policy import Policy, map_actions
    from repro_torch.models import model as TM
    from repro_torch.train.train_step import make_train_step
    cfg = TArchConfig(**TINY)
    init = TM.init(cfg, seed=3, device="cpu")
    cm = CompressibleLM(cfg, init)
    rng, pol = np.random.default_rng(2), Policy.reference(cm.specs)
    for i, spec in enumerate(cm.specs):
        pol.cmps[i] = map_actions(spec, rng.random(3).astype(np.float32),
                                  "pq")
    assert any(c.w_bits < 32 for c in pol.cmps)
    cspec = cm.build_cspec(pol)
    ds = TD.ShardedTokenDataset("synthetic://64", TD.DataConfig(**DATA))
    tr = ttrainer.Trainer(cfg, topt.OptimizerConfig(**OPT),
                          ttrainer.TrainerConfig(total_steps=3, log_every=1),
                          params=init, cspec=cspec, device="cpu")
    hist = tr.fit(ds.batch_at(s) for s in range(4))
    params = topt.tree_unflatten(init, [p.clone()
                                        for p in topt.tree_leaves(init)])
    state = topt.adamw_init(params, topt.OptimizerConfig(**OPT))
    step = make_train_step(cfg, topt.OptimizerConfig(**OPT), cspec=cspec)
    for s, row in zip(range(3), hist):
        params, state, m = step(params, state,
                                TD.to_device(ds.batch_at(s), "cpu"))
        assert float(m["loss"]) == row["loss"]
    for a, b in zip(topt.tree_leaves(params), topt.tree_leaves(tr.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The launcher's retry loop, and the end-to-end example
# --------------------------------------------------------------------------

def test_launcher_resumes_after_step_timeout(tmp_path, monkeypatch):
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "8",
            "--global-batch", "2", "--seq-len", "32", "--device", "cpu"]
    plain = tlaunch.main(argv)
    assert plain["attempts"] == 1

    fired = []

    class OneTimeout(ttrainer.StepMonitor):
        def record(self, step, dt):
            if step == 5 and not fired:
                fired.append(step)
                raise tlaunch.StepTimeout("injected after step 4")
            super().record(step, dt)
    monkeypatch.setattr(ttrainer, "StepMonitor", OneTimeout)
    out = tlaunch.main(argv + ["--ckpt-dir", str(tmp_path),
                               "--ckpt-every", "4"])
    assert fired == [5] and out["attempts"] == 2
    assert [r["step"] for r in out["history"]] == [5, 6, 7, 8]
    want = _losses(plain["history"])
    assert _losses(out["history"]) == {s: want[s] for s in (5, 6, 7, 8)}
    assert C.latest_step(str(tmp_path)) == 8
    assert out["trainer"].step == 8


def test_train_compress_serve_example_smoke():
    """``examples/train_compress_serve_torch.py --steps 2`` on the CPU:
    the four stages run, the served tokens are in the vocabulary."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "train_compress_serve_torch.py"
    spec = importlib.util.spec_from_file_location("e2e_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--steps", "2", "--device", "cpu"])
    try:
        assert len(out["history"]) == 2
        assert out["tokens"].shape == (4, out["serve_steps"] + 1)
        assert int(out["tokens"].min()) >= 0
        assert int(out["tokens"].max()) < out["vocab"]
        assert 0.0 <= out["qat_accuracy"] <= 1.0
        assert C.latest_step(out["ckpt_dir"]) == 2
    finally:
        shutil.rmtree(out["ckpt_dir"], ignore_errors=True)
