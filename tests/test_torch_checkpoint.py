"""The port's checkpoints (``checkpoint/checkpointing.py``) and fault
tolerance (``distributed/fault_tolerance.py``) on the CPU: every case of
the JAX package's ``tests/test_checkpoint.py`` and
``tests/test_fault_tolerance.py`` on the port, and the on-disk format
across the two packages.

Cross-format checks (exact):
  * a checkpoint the JAX ``save`` wrote (f32 leaves, a 0-d int32 step, a
    bfloat16 leaf) restores in the port, the bf16 leaf by the manifest's
    dtype; the port writes the same bytes for the same tree (the bf16
    file included, ``'<V2'`` descr and all);
  * a port-written f32 checkpoint restores through the JAX ``restore``;
  * ``AsyncCheckpointer.save`` at step k, then in-place steps while the
    writer is slowed: the checkpoint still holds step k's values.
"""
import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointing as JC  # noqa: E402

from repro_torch.checkpoint import checkpointing as C  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    FaultToleranceConfig, HealthLedger, StepMonitor, StepTimeout,
    elastic_data_axis)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.zeros((3,))},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "nested": [torch.ones((2,))]}}


def leaves(t):
    return list(C._flatten(t).values())


# --------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# --------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = tree()
    C.save(str(tmp_path), 10, t, extra={"data_step": 10})
    restored, extra = C.restore(str(tmp_path), 10, t, device="cpu")
    for a, b in zip(leaves(t), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert restored["opt"]["step"].dim() == 0
    assert extra["data_step"] == 10


def test_latest_pointer(tmp_path):
    t = tree()
    C.save(str(tmp_path), 5, t)
    C.save(str(tmp_path), 9, t)
    assert C.latest_step(str(tmp_path)) == 9
    restored, step, _ = C.restore_latest(str(tmp_path), t, device="cpu")
    assert step == 9


def test_gc_keeps_recent(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4, 5):
        C.save(str(tmp_path), s, t, keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_4", "step_5"]


def test_async_checkpointer(tmp_path):
    ck = C.AsyncCheckpointer(str(tmp_path))
    t = tree()
    ck.save(3, t)
    ck.wait()
    restored, step, _ = C.restore_latest(str(tmp_path), t, device="cpu")
    assert step == 3
    assert torch.equal(restored["params"]["w"], t["params"]["w"])


def test_restore_missing_returns_none(tmp_path):
    out, step, extra = C.restore_latest(str(tmp_path), tree(), device="cpu")
    assert out is None and step is None


def test_dangling_latest_falls_back_to_newest_intact(tmp_path):
    """A crash between step-dir GC and the pointer rewrite leaves LATEST
    naming a deleted step; restore must fall back to the newest intact
    manifest instead of raising."""
    t = tree()
    C.save(str(tmp_path), 5, t, extra={"mark": 5})
    C.save(str(tmp_path), 9, t, extra={"mark": 9})
    with open(tmp_path / "LATEST", "w") as f:
        f.write("12")                     # names a step that never landed
    assert C.latest_step(str(tmp_path)) == 9
    restored, step, extra = C.restore_latest(str(tmp_path), t, device="cpu")
    assert step == 9 and extra["mark"] == 9
    shutil.rmtree(tmp_path / "step_9")
    with open(tmp_path / "LATEST", "w") as f:
        f.write("9")
    restored, step, extra = C.restore_latest(str(tmp_path), t, device="cpu")
    assert step == 5 and extra["mark"] == 5
    with open(tmp_path / "LATEST", "w") as f:
        f.write("garbage")
    assert C.latest_step(str(tmp_path)) == 5
    os.makedirs(tmp_path / "step_7")
    assert C.latest_step(str(tmp_path)) == 5


def test_trainer_resume(tmp_path):
    """The port's Trainer checkpoints and resumes at the right step."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.data.pipeline import bigram_lm
    from repro_torch.optim.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = ArchConfig(name="ck", num_layers=1, d_model=32, num_heads=2,
                     num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    tcfg = TrainerConfig(total_steps=6, ckpt_every=3, log_every=2,
                         ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, ocfg, tcfg, seed=0, device="cpu")
    data = (bigram_lm(64, 4, 16, seed=i, device="cpu") for i in range(100))
    hist = tr.fit(data)
    assert [r["step"] for r in hist] == [2, 4, 6]
    assert C.latest_step(str(tmp_path)) == 6

    tr2 = Trainer(cfg, ocfg, tcfg, seed=1, device="cpu")   # other init
    tr2.maybe_restore()
    assert tr2.step == 6
    for a, b in zip(tree_leaves([tr.params, tr.opt_state]),
                    tree_leaves([tr2.params, tr2.opt_state])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(tr2.opt_state["step"]) == 6


# --------------------------------------------------------------------------
# tests/test_fault_tolerance.py on the port (a copy of a JAX-free module)
# --------------------------------------------------------------------------

def test_straggler_detection():
    mon = StepMonitor(FaultToleranceConfig(straggler_factor=2.0))
    for i in range(20):
        mon.record(i, 0.1)
    mon.record(20, 0.5)                 # 5x median -> straggler
    assert 20 in mon.stragglers
    mon.record(21, 0.11)
    assert 21 not in mon.stragglers
    assert mon.summary() == {"recorded": 22, "median_step_s": 0.1,
                             "stragglers": [20]}


def test_hard_timeout():
    mon = StepMonitor(FaultToleranceConfig(hard_timeout_s=1.0))
    for i in range(10):
        mon.record(i, 0.1)
    with pytest.raises(StepTimeout):
        mon.record(10, 2.0)


def test_health_ledger():
    cfg = FaultToleranceConfig(heartbeat_timeout_s=10.0)
    led = HealthLedger(4, cfg)
    now = 1000.0
    for h in range(4):
        led.heartbeat(h, now)
    led.heartbeat(0, now + 20)
    led.heartbeat(1, now + 20)
    led.heartbeat(2, now + 20)
    failed = led.failed_hosts(now + 21)
    assert failed == [3]
    led.exclude(failed)
    assert led.healthy == [0, 1, 2]
    assert led.failed_hosts(now + 21) == []


def test_elastic_data_axis():
    assert elastic_data_axis(64, 4, 16) == 16
    assert elastic_data_axis(61, 4, 16) == 8
    assert elastic_data_axis(1, 4, 16) == 1


# --------------------------------------------------------------------------
# The on-disk format across the two packages
# --------------------------------------------------------------------------

def _jax_tree():
    return {"params": {"w": jnp.arange(12.0).reshape(3, 4) / 7,
                       "blocks": [{"s": jnp.ones((2,)) * 0.25}],
                       "emb": (jnp.arange(6.0) / 3).astype(jnp.bfloat16)},
            "opt": {"step": jnp.int32(11)}}


def test_jax_checkpoint_restores_in_port(tmp_path):
    jt = _jax_tree()
    JC.save(str(tmp_path / "jax"), 4, jt, extra={"data_step": 4})
    like = jax.tree.map(lambda _: 0, jt)       # the structure
    got, step, extra = C.restore_latest(str(tmp_path / "jax"), like,
                                        device="cpu")
    assert step == 4 and extra == {"data_step": 4}
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32 \
        and got["opt"]["step"].dim() == 0 and int(got["opt"]["step"]) == 11
    for (path, want), leaf in zip(
            jax.tree_util.tree_flatten_with_path(jt)[0],
            jax.tree.leaves(got, is_leaf=lambda x: isinstance(
                x, torch.Tensor))):
        np.testing.assert_array_equal(
            leaf.float().numpy(), np.asarray(want, np.float32),
            err_msg=jax.tree_util.keystr(path))
    # the port writes the same files for the same tree
    C.save(str(tmp_path / "port"), 4, got, extra={"data_step": 4})
    a = json.load(open(tmp_path / "jax" / "step_4" / "manifest.json"))
    b = json.load(open(tmp_path / "port" / "step_4" / "manifest.json"))
    assert a == b
    for info in a["leaves"].values():
        assert (tmp_path / "jax" / "step_4" / info["file"]).read_bytes() == \
            (tmp_path / "port" / "step_4" / info["file"]).read_bytes()


def test_port_checkpoint_restores_in_jax(tmp_path):
    """An f32 checkpoint written by the port (tensors and one numpy
    leaf) restores through the JAX ``restore``, int32 step included."""
    jt = _jax_tree()
    jt["params"].pop("emb")                    # JAX cannot read bf16 back
    t = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jt)
    t["opt"]["step"] = torch.tensor(11, dtype=torch.int32)
    t["params"]["blocks"][0]["s"] = np.asarray(jt["params"]["blocks"][0]["s"])
    C.save(str(tmp_path), 2, t, extra={"data_step": 2})
    got, step, extra = JC.restore_latest(str(tmp_path), jt)
    assert step == 2 and extra == {"data_step": 2}
    assert got["opt"]["step"].dtype == jnp.int32
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_restore_of_bfloat16_leaf_fails(tmp_path):
    """The reference-side fault the port diverges from (ROADMAP.md,
    Queue 3): the JAX ``restore`` cannot read the bfloat16 leaf its own
    ``save`` wrote; the port reads it (above)."""
    jt = _jax_tree()
    JC.save(str(tmp_path), 1, jt)
    with pytest.raises(TypeError, match="V2"):
        JC.restore(str(tmp_path), 1, jt)


def test_async_snapshot_survives_in_place_steps(tmp_path, monkeypatch):
    """``AsyncCheckpointer.save`` at step k returns with a finished host
    copy: in-place updates of the params and moments while the writer is
    held back (and a CPU tensor's ``.numpy()`` would share its memory)
    leave the checkpoint with step k's values; then a second save waits
    for the first."""
    gate = threading.Event()
    write = C._write_leaf

    def slow(*a):
        gate.wait(10)
        write(*a)
    monkeypatch.setattr(C, "_write_leaf", slow)
    t = {"params": {"w": torch.arange(8.0), "h": torch.ones(3).bfloat16()},
         "opt": {"m": torch.zeros(8),
                 "step": torch.tensor(3, dtype=torch.int32)}}
    want = {k: v.clone() for k, v in C._flatten(t).items()}
    ck = C.AsyncCheckpointer(str(tmp_path))
    ck.save(3, t, extra={"data_step": 3})
    for _ in range(2):                         # the next steps, in place
        t["params"]["w"].add_(1.0)
        t["params"]["h"].mul_(2)
        t["opt"]["m"].add_(0.5)
        t["opt"]["step"].add_(1)
    time.sleep(0.05)
    gate.set()
    ck.wait()
    got, step, extra = C.restore_latest(str(tmp_path), t, device="cpu")
    assert step == 3 and extra["data_step"] == 3
    for k, v in C._flatten(got).items():
        assert torch.equal(v, want[k]), k
