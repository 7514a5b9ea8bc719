"""The port's train and eval steps (``train/train_step.py``) and testbed
trainers (``train/trainer.py``) against the JAX package's, on the CPU,
from the JAX package's initial weights (carried over with
``repro_torch.convert``) and the same numpy-seeded batches; and the
autograd form of K6, K7 and K8 (a kernel forward, the plain chain's
gradient).

Model: qwen2-0.5b at its SMOKE widths in f32 (2 layers, d 64, qkv bias,
tied embeddings, vocab 256), JAX weights from ``PRNGKey(0)``, tokens
from ``np.random.default_rng``; the QAT cases under one seeded pq
policy (``CompressibleLM.build_cspec``: fake quantization and pruning
masks).

Tolerances, with what was found:
  * ``value_and_grad`` (raw): loss ≤1e-6 relative, every gradient leaf
    ≤5e-7 absolute (found 1.7e-7; the largest gradients are ~0.1: f32
    sums in other orders).
  * ``lm_loss`` and ``make_eval_step``: raw ≤1e-5 absolute (found
    ~1e-6); under the policy ≤1e-3 (found 1.7e-4). The JAX forward and
    the port's agree to ~1e-6 before the quantizers; a last-bit
    difference in a fake-quant range moves whole quantization steps
    (ROADMAP.md, Queue 3: log-probs up to 0.043 apart), and the loss, a
    mean over 124 positions, moves far less than that.
  * ``make_train_step``, 3 steps, each from the JAX step's state carried
    over (``convert.lm_params`` / ``convert.adamw_state``, so no
    difference compounds): raw and with int8 gradient compression, loss
    ≤1e-5 absolute, ``grad_norm`` ≤1e-5 relative, every updated param
    within 0.1 × that step's learning rate (found 0.028 raw, 0.043
    int8). The bound is in units of the step because Adam normalizes
    each element: the key bias's gradient is exactly zero in exact
    arithmetic (softmax is shift-invariant along the keys), so both
    sides hold rounding noise of ~3e-8 there, and ``m / (sqrt(v) +
    eps)`` maps noise of that size to a fraction of a whole step; an
    int8 code that sits on a rounding boundary flips the same way.
    Under the policy (QAT): loss ≤1e-3 and ``grad_norm`` ≤1e-3 relative
    (found 1.7e-4 and 3.1e-5), and at most 0.5% of the params beyond
    0.1 × the step (found 0.09%, in the step whose forward moved a
    quantization step: there a gradient element's sign can flip).
    With int8 compression the error-feedback residual is held too: at
    most 0.1% of its elements beyond 1e-6 (found 1–3 of 90,688: a code
    flipped at a rounding boundary moves that element by one int8 step,
    ≤1e-3).
  * ``make_train_step`` on mamba2-780m and recurrentgemma-2b (SMOKE,
    f32, 4 x 48 tokens, raw): gradients ≤1e-5 per leaf (found ≤1.9e-7),
    loss ≤1e-5, params in units of lr as above but with at most 0.01% of
    the elements beyond 0.1 and none beyond 0.5 (``FAMILY_STEP_MAX``).
  * K6, K7 and K8 under autograd (the kernel entry stood in by a
    counting plain version): one launch, its output, and the plain
    chain's gradients bit for bit.
  * ``train_testbed_lm`` on a tiny f32 config (8 steps, batch 4, seq
    16): params ≤1e-5 (its warm-up keeps each step ≤1.2e-3), validation
    accuracy equal.
  * ``train_testbed_resnet`` on ``RESNET_CFG`` (4 steps, batch 8, lr up
    to 4e-3): validation accuracy equal, each leaf's update (trained −
    initial) within 1% of JAX's in L2 norm (found ≤0.47%), every element
    within twice the summed learning rate (2e-3, the most two runs of
    normalized steps can part; found 5.4e-4). Not ≤1e-5: the gradients
    agree to ~1e-6 of each leaf's largest, but GroupNorm leaves many
    conv-weight gradients within a few ulps of zero, and Adam's
    normalization maps their relative difference onto a fraction of the
    step (2% of the elements beyond 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.policy import Policy, map_actions  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.optim import grad_compression as jgc  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.configs.testbed import RESNET_CFG  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import grad_compression as tgc  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

ARCH = "qwen2-0.5b"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
STEP_TOL = 0.1          # params per step, in units of that step's lr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of small CPU ops: with several test workers on one box,
    torch's intra-op pool makes each op wait for its threads. One
    thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    """The SMOKE model in f32 on both sides, three seeded batches and one
    seeded pq policy with its cspec on each side."""
    jcfg = jreg.get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    tcfg = treg.get_config(ARCH, smoke=True).replace(compute_dtype="float32")
    params = jax.jit(JM.init, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    host = jax.device_get(params)
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, jcfg.vocab_size, (4, 32)) for _ in range(3)]
    cm = CompressibleLM(jcfg, params)
    tcm = tcompress.CompressibleLM(
        tcfg, convert.lm_params(tcfg, host, device="cpu"))
    act = np.random.default_rng(5)
    pj, pt = Policy.reference(cm.specs), tp.Policy.reference(tcm.specs)
    for i, (sj, st) in enumerate(zip(cm.specs, tcm.specs)):
        a = act.random(3).astype(np.float32)
        pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
            tp.map_actions(st, a, "pq")
    assert any(c.w_bits < 32 for c in pt.cmps)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, host=host, toks=toks,
                cspecs={"raw": (None, None),
                        "qat": (cm.build_cspec(pj), tcm.build_cspec(pt))})


def _port_params(smoke, tree=None):
    return convert.lm_params(smoke["tcfg"], smoke["host"] if tree is None
                             else jax.device_get(tree), device="cpu")


def _leaf_errors(got, want):
    """(path, max |got - want|) over the leaves of two JAX-layout trees."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    return [(jax.tree_util.keystr(p), float(np.abs(
        np.asarray(w, np.float32) - g).max()))
        for (p, w), g in zip(paths, jax.tree.leaves(got))]


# --------------------------------------------------------------------------
# K6, K7 and K8 under autograd: the kernel forward, the plain backward
# --------------------------------------------------------------------------

def _autograd_cases():
    """(the ops module holding the kernel entry, its name, the autograd
    Function's call on fresh inputs, the plain chain its backward
    differentiates) per kernel, at small f32 shapes: K6 with GQA (4 over
    2 heads) causal and with a window, K7 with and without h0, K8 with a
    ragged last chunk, both outputs used and the final state unused."""
    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=g)
    return {
        "K6": (ops._fa, "flash_attention",
               lambda: [rand(2, 4, 40, 16), rand(2, 2, 40, 16),
                        rand(2, 2, 40, 16)],
               [(lambda q, k, v: ops._FlashAttention.apply(
                   q, k, v, True, w),
                 lambda q, k, v: ops._attention_plain(q, k, v, True, w))
                for w in (0, 8)]),
        "K7": (ops._rg, "rglru_scan",
               lambda: [rand(2, 24, 8), rand(2, 24, 8), rand(2, 8)],
               [(lambda a, b, h0: ops._RGLRUScan.apply(a, b, h0),
                 ref.rglru_scan_ref),
                (lambda a, b, h0: ops._RGLRUScan.apply(a, b, None),
                 lambda a, b, h0: ref.rglru_scan_ref(a, b))]),
        "K8": (ops._ssd, "ssd_scan",
               lambda: [rand(2, 20, 3, 4), -rand(2, 20, 3), rand(2, 20, 5),
                        rand(2, 20, 5)],
               [(lambda *x: ops._SSDScan.apply(*x, 8),
                 lambda *x: ref.ssd_chunked_ref(*x, 8)),
                (lambda *x: ops._SSDScan.apply(*x, 8)[0],
                 lambda *x: ref.ssd_chunked_ref(*x, 8)[0])]),
    }


@pytest.mark.parametrize("kernel", ["K6", "K7", "K8"])
def test_kernel_forward_plain_backward(kernel, monkeypatch):
    """On the CPU, the kernel entry stood in by a counting function (the
    plain version): the op's autograd Function launches it once in the
    forward and never in the backward, returns its output, and gives
    every input the gradient of the plain chain it recomputes
    (``attention_chunked``, ``ref.rglru_scan_ref``,
    ``ref.ssd_chunked_ref``), bit for bit, also for an output left
    unused. Under ``no_grad`` the public op is the bare entry."""
    module, name, inputs, calls = _autograd_cases()[kernel]
    entry, launches = getattr(module, name), []

    def counting(*a, **k):
        out = entry(*a, **k)
        launches.append((torch.is_grad_enabled(), out))
        return out
    monkeypatch.setattr(module, name, counting)
    for fn, plain in calls:
        xs = [x.requires_grad_(True) for x in inputs()]
        del launches[:]
        out = fn(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        assert [grad for grad, _ in launches] == [False]   # one, no graph
        want = launches[0][1]
        for o, w in zip(outs, want if isinstance(want, tuple) else (want,)):
            assert torch.equal(o.detach(), w)
        up = [torch.rand(o.shape, generator=torch.Generator().manual_seed(
            i + 1)) for i, o in enumerate(outs)]
        got = torch.autograd.grad(
            sum((o * u).sum() for o, u in zip(outs, up)), xs,
            allow_unused=True)
        assert len(launches) == 1                # none in the backward
        ys = [x.detach().requires_grad_(True) for x in xs]
        pouts = plain(*ys)
        pouts = pouts if isinstance(pouts, tuple) else (pouts,)
        ref_g = torch.autograd.grad(
            sum((o * u).sum() for o, u in zip(pouts, up)), ys,
            allow_unused=True)
        for a, b in zip(got, ref_g):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    if kernel == "K6":
        call = [lambda *x: ops.flash_attention(*x)]
    elif kernel == "K7":
        call = [lambda a, b, h0: ops.rglru_scan(a, b, h0)]
    else:
        call = [lambda *x: ops.ssd_scan(*x, chunk=8)[0]]
    with torch.no_grad():
        del launches[:]
        assert call[0](*[x.requires_grad_(True) for x in inputs()]) \
            .grad_fn is None and len(launches) == 1


# --------------------------------------------------------------------------
# Loss, eval step, gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["raw", "qat"])
def test_lm_loss_and_eval_step_match_jax(smoke, kind):
    cs_j, cs_t = smoke["cspecs"][kind]
    tparams = _port_params(smoke)
    tol = 1e-5 if kind == "raw" else 1e-3
    for toks in smoke["toks"][:2]:
        want = float(jax.jit(jstep.make_eval_step(smoke["jcfg"], cs_j))(
            smoke["params"], {"tokens": jnp.asarray(toks)}))
        batch = {"tokens": torch.from_numpy(toks)}
        got = tstep.make_eval_step(smoke["tcfg"], cs_t)(tparams, batch)
        assert got.dim() == 0 and not got.requires_grad
        assert abs(float(got) - want) <= tol
        assert float(tstep.lm_loss(smoke["tcfg"], tparams, batch, cs_t)) \
            == float(got)


def test_value_and_grad_matches_jax(smoke):
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    toks = smoke["toks"][0]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jstep.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)})))(
            smoke["params"])
    tparams = _port_params(smoke)
    tloss, tgrads = tstep.value_and_grad(
        lambda p: tstep.lm_loss(tcfg, p, {"tokens": torch.from_numpy(toks)}),
        tparams)
    assert not any(p.requires_grad for p in topt.tree_leaves(tparams))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    errs = _leaf_errors(convert.to_jax_lm_params(tcfg, tgrads),
                        jax.device_get(grads))
    assert max(e for _, e in errs) <= 5e-7, errs


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------

FAMILIES = ("mamba2-780m", "recurrentgemma-2b")
# The families' gradients on the CPU against JAX (SMOKE, f32): every leaf
# within FAMILY_GRAD_TOL absolute (found 1.0e-7 mamba2, 1.9e-7
# recurrentgemma; the largest gradients are ~1). mamba2's chunked scan
# is the same jnp chain on both sides; recurrentgemma's JAX model scans
# with ``associative_scan`` and the port walks the recurrence in order,
# so sums part in the last bits.
FAMILY_GRAD_TOL = 1e-5
# Their updated params, in units of the step's lr: at most FAMILY_BEYOND
# of the elements beyond STEP_TOL and none beyond FAMILY_STEP_MAX (found:
# mamba2 none beyond; recurrentgemma one embedding element of 126,528 x 3
# at 0.126, where the gradient is ~3e-10 rounding noise on both sides,
# and only when the mamba2 case ran first in the process).
FAMILY_STEP_MAX, FAMILY_BEYOND = 0.5, 1e-4


@pytest.fixture(scope="module")
def families():
    """The SMOKE mamba2-780m and recurrentgemma-2b in f32 on both sides,
    JAX weights from ``PRNGKey(0)``, three seeded 4 x 48 batches (two
    SSD chunks of 32, three RG-LRU windows of 16), made on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jreg.get_config(arch, smoke=True).replace(
                compute_dtype="float32")
            params = jax.jit(JM.init, static_argnums=0)(
                jcfg, jax.random.PRNGKey(0))
            rng = np.random.default_rng(1)
            cache[arch] = dict(
                jcfg=jcfg, params=params, host=jax.device_get(params),
                tcfg=treg.get_config(arch, smoke=True).replace(
                    compute_dtype="float32"),
                toks=[rng.integers(0, jcfg.vocab_size, (4, 48))
                      for _ in range(3)],
                cspecs={"raw": (None, None)})
        return cache[arch]
    return get


@pytest.mark.parametrize("kind", ["raw", "int8", "qat", *FAMILIES])
def test_train_step_matches_jax(smoke, families, kind):
    """qwen2-0.5b raw, with int8 gradient compression and under the
    policy (QAT); and mamba2-780m and recurrentgemma-2b raw, whose first
    batch's gradients are also held leaf by leaf (``FAMILY_GRAD_TOL``)."""
    if kind in FAMILIES:
        smoke = families(kind)
    jcfg, tcfg = smoke["jcfg"], smoke["tcfg"]
    cs_j, cs_t = smoke["cspecs"]["qat" if kind == "qat" else "raw"]
    gj = jgc.GradCompressionConfig(kind="int8") if kind == "int8" else None
    gt = tgc.GradCompressionConfig(kind="int8") if kind == "int8" else None
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt.OptimizerConfig(**OPT),
                                        gj, cs_j))
    tfn = tstep.make_train_step(tcfg, topt.OptimizerConfig(**OPT), gt, cs_t)
    jp = smoke["params"]
    js = jopt.adamw_init(jp, jopt.OptimizerConfig(**OPT))
    jr = jgc.init_residual(jp) if kind == "int8" else None
    loss_tol = 1e-3 if kind == "qat" else 1e-5
    beyond = 0
    if kind in FAMILIES:
        toks = smoke["toks"][0]
        _, grads = jax.jit(jax.value_and_grad(lambda p: jstep.lm_loss(
            jcfg, p, {"tokens": jnp.asarray(toks)})))(jp)
        _, tgrads = tstep.value_and_grad(lambda p: tstep.lm_loss(
            tcfg, p, {"tokens": torch.from_numpy(toks)}), _port_params(smoke))
        errs = _leaf_errors(convert.to_jax_lm_params(tcfg, tgrads),
                            jax.device_get(grads))
        assert max(e for _, e in errs) <= FAMILY_GRAD_TOL, errs
    for toks in smoke["toks"]:
        tparams = _port_params(smoke, jp)
        tstate = convert.adamw_state(tcfg, jax.device_get(js), "cpu")
        jb, tb = {"tokens": jnp.asarray(toks)}, \
            {"tokens": torch.from_numpy(toks)}
        if jr is None:
            jp, js, jm = jfn(jp, js, jb)
            tparams, tstate, tm = tfn(tparams, tstate, tb)
        else:
            tres = _port_params(smoke, jr)
            jp, js, jm, jr = jfn(jp, js, jb, jr)
            tparams, tstate, tm, tres = tfn(tparams, tstate, tb, tres)
            rd = np.concatenate([np.abs(g - np.asarray(w)).ravel() for g, w
                                 in zip(jax.tree.leaves(
                                     convert.to_jax_lm_params(tcfg, tres)),
                                     jax.tree.leaves(jax.device_get(jr)))])
            assert (rd > 1e-6).sum() <= 1e-3 * rd.size and rd.max() <= 1e-3
        assert int(tstate["step"]) == int(js["step"])
        lr = float(jm["lr"])
        np.testing.assert_allclose(float(tm["lr"]), lr, rtol=1e-6)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= loss_tol
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=loss_tol)
        got = jax.tree.leaves(convert.to_jax_lm_params(tcfg, tparams))
        want = jax.tree.leaves(jax.device_get(jp))
        for g, w in zip(got, want):
            d = np.abs(g - np.asarray(w)) / lr
            if kind == "qat":
                beyond += int((d > STEP_TOL).sum())
            elif kind in FAMILIES:
                beyond += int((d > STEP_TOL).sum())
                assert d.max() <= FAMILY_STEP_MAX, d.max()
            else:
                assert d.max() <= STEP_TOL, d.max()
    total = 3 * sum(np.size(w) for w in jax.tree.leaves(jp))
    if kind == "qat":
        assert beyond <= 0.005 * total, (beyond, total)
    elif kind in FAMILIES:
        assert beyond <= FAMILY_BEYOND * total, (beyond, total)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_state_round_trip(smoke, moments):
    """A JAX-layout AdamW state of the stacked SMOKE model (numpy moments
    of distinct values in the moment dtype) through
    ``convert.adamw_state`` and back through
    ``convert.to_jax_adamw_state``: equal, bf16 moments widened to f32
    (exact); the port's tree has one dict per layer and the moments'
    dtype."""
    dt = np.dtype(jnp.bfloat16) if moments == "bfloat16" else np.float32
    js = {"m": jax.tree.map(lambda x: (x * 0.5).astype(dt), smoke["host"]),
          "v": jax.tree.map(lambda x: (x * x).astype(dt), smoke["host"]),
          "step": np.int32(3)}
    st = convert.adamw_state(smoke["tcfg"], js, "cpu")
    assert len(st["m"]["blocks"]) == smoke["tcfg"].num_layers
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 3
    assert {x.dtype for x in topt.tree_leaves(st["v"])} \
        == {getattr(torch, moments)}
    back = convert.to_jax_adamw_state(smoke["tcfg"], st)
    for k in ("m", "v"):
        for g, w in zip(jax.tree.leaves(back[k]), jax.tree.leaves(js[k])):
            np.testing.assert_array_equal(g, np.asarray(w, np.float32))
    assert back["step"] == 3


def test_stack_layers_round_trip(smoke):
    """``stack_layers`` gives the JAX layout (the per-leaf rules of the
    JAX step see it); ``unstack_layers`` gives back views of it with the
    port's values; the weight-decay mask follows the JAX ``ndim >= 2``
    rule on that layout (every stacked block leaf, the embedding; not
    the final norm's scale)."""
    tcfg = smoke["tcfg"]
    tparams = _port_params(smoke)
    stacked = tstep.stack_layers(tcfg, tparams)
    want = jax.device_get(smoke["params"])
    for g, w in zip(jax.tree.leaves(convert._to_numpy(stacked)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    back = tstep.unstack_layers(tcfg, stacked)
    for g, w in zip(topt.tree_leaves(back), topt.tree_leaves(tparams)):
        assert torch.equal(g, w)
    mask = tstep.weight_decay_mask(tcfg, tparams)
    got = convert.to_jax_lm_params(tcfg, topt.tree_unflatten(
        mask, [torch.tensor(m) for m in topt.tree_leaves(mask)]))
    assert [bool(np.all(m)) for m in jax.tree.leaves(got)] \
        == [np.ndim(x) >= 2 for x in jax.tree.leaves(want)]


# --------------------------------------------------------------------------
# The testbed trainers
# --------------------------------------------------------------------------

TINY = dict(name="t-train", num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            scan_layers=True, compute_dtype="float32")


def _jitted_init(monkeypatch, module):
    """Run the JAX trainer's ``module.init`` jitted (eager JAX compiles
    each op of an init on its own: seconds) and keep what it returned:
    the initial weights to feed the port."""
    init, got = jax.jit(module.init, static_argnums=0), []

    def record(cfg, key):
        got.append(jax.device_get(init(cfg, key)))
        return got[-1]
    monkeypatch.setattr(module, "init", record)
    return got


def test_train_testbed_lm_matches_jax(monkeypatch):
    jcfg, tcfg = ArchConfig(**TINY), TArchConfig(**TINY)
    inits = _jitted_init(monkeypatch, JM)
    jparams, jval, jacc = jtrainer.train_testbed_lm(jcfg, steps=8, batch=4,
                                                    seq=16)
    init = inits[0]
    start = convert.lm_params(tcfg, init, device="cpu")
    tparams, tval, tacc = ttrainer.train_testbed_lm(
        tcfg, steps=8, batch=4, seq=16, params=start, device="cpu")
    np.testing.assert_array_equal(tval["tokens"].numpy(),
                                  np.asarray(jval["tokens"]))
    errs = _leaf_errors(convert.to_jax_lm_params(tcfg, tparams),
                        jax.device_get(jparams))
    assert max(e for _, e in errs) <= 1e-5, errs
    assert tacc == jacc
    for g, w in zip(jax.tree.leaves(convert.to_jax_lm_params(tcfg, start)),
                    jax.tree.leaves(init)):
        np.testing.assert_array_equal(g, np.asarray(w))    # not updated


def test_train_testbed_resnet_matches_jax(monkeypatch):
    jrcfg = JR.ResNetConfig(**dataclasses.asdict(RESNET_CFG))
    inits = _jitted_init(monkeypatch, JR)
    jparams, jval, jacc = jtrainer.train_testbed_resnet(jrcfg, steps=4,
                                                        batch=8)
    init = inits[0]
    tparams, tval, tacc = ttrainer.train_testbed_resnet(
        RESNET_CFG, steps=4, batch=8,
        params=convert.resnet_params(init, device="cpu"), device="cpu")
    np.testing.assert_array_equal(tval["labels"].numpy(),
                                  np.asarray(jval["labels"]))
    got = jax.tree.leaves(convert.to_jax_resnet_params(tparams))
    lr_sum = sum(1e-2 * t / 10 for t in range(1, 5))   # warmup 10
    for g, w, i in zip(got, jax.tree.leaves(jax.device_get(jparams)),
                       jax.tree.leaves(init)):
        upd, want = g - np.asarray(i), np.asarray(w) - np.asarray(i)
        assert np.linalg.norm(upd - want) <= 1e-2 * np.linalg.norm(want)
        assert np.abs(upd - want).max() <= 2 * lr_sum
    assert tacc == jacc
