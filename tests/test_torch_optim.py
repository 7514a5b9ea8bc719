"""The port's optimizer (``optim/optimizer.py``) and gradient compression
(``optim/grad_compression.py``) against the JAX package's, on the CPU,
on the same numpy-seeded trees.

Tolerances:
  * schedules (cosine, WSD, constant) at steps 0 … total + 1: ≤1e-6
    relative (both compute in f32; XLA's f32 ``cos`` is its own
    approximation, a few ulps from torch's: 2.5e-7 found).
  * ``adamw_update`` over 3 steps on a tree of 1-D and 2-D leaves (a
    dict, a nested dict and a list), with the clip active and inactive,
    each schedule, f32 and bf16 moments: params ≤1e-6 relative to their
    size (the same f32 ops in the same order; XLA may contract a
    multiply-add, and ``pow`` comes from another libm), f32 moments
    ≤1e-6 relative, bf16 moments equal (rounded from f32 values that
    agree to 1e-6, they can differ by a bf16 ulp only at a rounding
    tie, which these draws do not hit), ``grad_norm`` and ``lr`` ≤1e-6
    relative, ``step`` equal. The JAX side runs eagerly, op by op.
  * int8 and top-k compression, with and without error feedback, over
    two rounds (the residual of the first feeds the second): equal. The
    gradients have distinct magnitudes, so top-k has no ties; the JAX
    side runs eagerly (under ``jit`` XLA may take ``x / 127`` as ``x *
    (1/127)``).
  * ``param_count``: equal, on the SMOKE configs of the served families
    and the LM testbed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import grad_compression as jgc  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.testbed import LM_CFG  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import grad_compression as tgc  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of tiny CPU ops: with several test workers on one box,
    torch's intra-op pool makes each op wait for its threads. One
    thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed, scale=1.0):
    """1-D and 2-D leaves in a dict, a nested dict and a list; every
    magnitude distinct."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": leaf(8, 12), "b": leaf(12),
            "blk": {"norm": leaf(12), "proj": leaf(12, 6)},
            "layers": [leaf(6, 6), leaf(6)]}


def _t(tree):
    return convert._to_torch(tree, "cpu")


def _np(tree):
    return convert._to_numpy(tree)


def _close(got, want, rtol):
    for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol * max(np.abs(w).max(), 1e-30))


SCHED = dict(lr=2e-3, warmup_steps=3, total_steps=12, decay_frac=0.25)


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_matches_jax(schedule):
    jf = jopt.get_schedule(jopt.OptimizerConfig(schedule=schedule, **SCHED))
    tf = topt.get_schedule(topt.OptimizerConfig(schedule=schedule, **SCHED))
    for s in range(SCHED["total_steps"] + 2):
        got = tf(torch.tensor(s, dtype=torch.int32))
        want = np.float32(jf(jnp.int32(s)))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.5, 100.0])
@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_adamw_update_matches_jax(schedule, clip, moments):
    """Clip 0.5 is active (the gradients' norm is ~10), clip 100 is not."""
    kw = dict(schedule=schedule, grad_clip=clip, moment_dtype=moments,
              weight_decay=0.1, **SCHED)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jp = _tree(0)
    tp = _t(jp)
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for s in range(3):
        grads = _tree(10 + s)
        jp, js, jm = jopt.adamw_update(jp, grads, js, jcfg)
        tp, ts, tm = topt.adamw_update(tp, _t(grads), ts, tcfg)
        _close(_np(tp), jp, 1e-6)
        if moments == "float32":
            _close(_np(ts["m"]), js["m"], 1e-6)
            _close(_np(ts["v"]), js["v"], 1e-6)
        else:
            for k in ("m", "v"):
                for g, w in zip(topt.tree_leaves(ts[k]),
                                jax.tree.leaves(js[k])):
                    assert g.dtype == torch.bfloat16
                    np.testing.assert_array_equal(
                        g.float().numpy(), np.asarray(w, np.float32))
        assert int(ts["step"]) == int(js["step"]) == s + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)


def test_adamw_update_is_in_place():
    """The params and moments keep their tensors (the documented in-place
    update); the leaves decayed follow ``ndim >= 2`` unless a mask says
    otherwise."""
    cfg = topt.OptimizerConfig(lr=1e-2, weight_decay=0.5, grad_clip=0.0,
                               schedule="constant")
    tp = _t(_tree(0))
    st = topt.adamw_init(tp, cfg)
    before = [p.data_ptr() for p in topt.tree_leaves(tp)]
    zeros = topt.tree_unflatten(tp, [torch.zeros_like(p)
                                     for p in topt.tree_leaves(tp)])
    want = [p.clone() for p in topt.tree_leaves(tp)]
    tp2, st2, _ = topt.adamw_update(tp, zeros, st, cfg)
    assert [p.data_ptr() for p in topt.tree_leaves(tp2)] == before
    for p, w in zip(topt.tree_leaves(tp2), want):
        expect = w * (1 - np.float32(1e-2) * np.float32(0.5)) \
            if w.dim() >= 2 else w
        torch.testing.assert_close(p, expect, rtol=1e-6, atol=0)
    b = tp2["b"].clone()
    decay = topt.tree_unflatten(tp, [True] * len(before))
    topt.adamw_update(tp2, zeros, st2, cfg, decay=decay)
    torch.testing.assert_close(
        tp2["b"], b * (1 - np.float32(1e-2) * np.float32(0.5)), rtol=1e-6,
        atol=0)


@pytest.mark.parametrize("error_feedback", [True, False])
@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compress_grads_matches_jax(kind, error_feedback):
    jcfg = jgc.GradCompressionConfig(kind=kind, topk_frac=0.1,
                                     error_feedback=error_feedback)
    tcfg = tgc.GradCompressionConfig(kind=kind, topk_frac=0.1,
                                     error_feedback=error_feedback)
    params = _tree(0)
    jr, tr = jgc.init_residual(params), tgc.init_residual(_t(params))
    for s in range(2):
        grads = _tree(20 + s, 1e-2)
        jg, jr = jgc.compress_grads(grads, jr, jcfg)
        tg, tr = tgc.compress_grads(_t(grads), tr, tcfg)
        for got, want in ((tg, jg), (tr, jr)):
            for g, w in zip(topt.tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if kind == "topk":
            kept = sum(int((g != 0).sum()) for g in topt.tree_leaves(tg))
            assert 0 < kept < sum(g.numel() for g in topt.tree_leaves(tg))


def test_compress_grads_none_passes_through():
    grads = _t(_tree(1))
    res = tgc.init_residual(grads)
    out, r = tgc.compress_grads(grads, res, tgc.GradCompressionConfig())
    assert out is grads and r is res


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m",
                                  "recurrentgemma-2b", "testbed"])
def test_param_count_matches_jax(arch):
    if arch == "testbed":
        from benchmarks.common import LM_CFG as jcfg
        tcfg = LM_CFG
    else:
        jcfg = jreg.get_config(arch, smoke=True)
        tcfg = treg.get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda: JM.init(jcfg, jax.random.PRNGKey(0)))
    assert TM.param_count(TM.init(tcfg, 0, "cpu")) \
        == JM.param_count(shapes) > 0
