"""The batched episode engine of the port against the JAX package's, on the
CPU (mirrors ``tests/test_batched.py``).

Pieces: the vectorized latency oracle (``policy_latency_batch``) against
the JAX one and against the port's scalar oracle, in three contexts and
under a calibration table; ``build_state_batch``; ``act_batch`` (the same
draws from the same seeded numpy generator); ``keep_mask_dynamic`` with
tied scores; the batched validation (``accuracy_policy_batch`` and
``accuracy_batch(stack_cspecs(...))``) against the JAX one and against
the port's scalar accuracy on the tiny LM and on SMOKE mamba2-780m and
recurrentgemma-2b; K1 over policy slots (its plain version, the only one
on the CPU) against ``fake_quant_ref`` slot by slot; and the whole
``BatchedCompressionSearch`` against the JAX engine, fed the JAX
sensitivity table and the JAX replay indices chunk by chunk.

Tolerances: the oracle ≤1e-6 relative (float64 sums in other orders);
state features ≤1e-6; actions, masks, CMPs, sigma and the K1 plain
version exact (the same numpy or f32 operations); accuracy ≤1e-6 (a mean
of 0/1 values: in effect exact, as ``test_batched.py`` holds the JAX
engine); reward ≤1e-5 and the replay ring exact up to the first update,
then ≤1e-5 (the agent-parity bound: the updated actor acts).

These exact equalities (CMPs and accuracy on the same policies) rest on
this test's draws: under a quantized policy a last-bit range difference
can move a whole fake-quant step and flip an argmax, so over many draws
the port's f32 accuracy is only within one token of JAX's
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
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.compress import lm_layer_specs  # noqa: E402
from repro.core.measure import CalibrationTable  # noqa: E402
from repro.core.policy import Policy, map_actions, stack_policies  # noqa: E402
from repro.core.reward import RewardConfig  # noqa: E402
from repro.core.search import (BatchedCompressionSearch,  # noqa: E402
                               SearchConfig)
from repro.core.sensitivity import SensitivityResult  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models.registry import get_config  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import measure as tmeasure  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.core import reward as treward  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402
from repro_torch.core import state as tstate  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fake_quant as tfq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import (fake_quant_ref,  # noqa: E402
                                     fake_quant_slots_ref,
                                     fake_quant_ste_ref)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

WIDE = dict(name="o", num_layers=4, d_model=256, num_heads=8,
            num_kv_heads=4, head_dim=32, d_ff=1024, vocab_size=512)
CTXS = (dict(tokens=1, seq_ctx=512, mode="decode", batch=1),
        dict(tokens=128, seq_ctx=512, mode="prefill", tp=4, chips=4),
        dict(tokens=4, seq_ctx=0, mode="train"))
CALIB = dict(ratios={"attn_qkv": {"raw": 1.7, "int8": 2.3, "int4": 3.1},
                     "mlp_down": {"raw": 0.6, "int8": 1.2},
                     "head": {"int4": 4.0}},
             extra={"attn": 1.4, "overhead": 2.5})
TINY = dict(name="t", num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=256, vocab_size=128, scan_layers=True)


def _port_cfg(cfg):
    return TArchConfig(**{k: getattr(cfg, k)
                          for k in cfg.__dataclass_fields__})


def _policies(specs_j, specs_t, n, seed, ref=True):
    """``n`` random pq policies (the first the reference when ``ref``),
    each as a (JAX, port) pair with the same CMPs."""
    out = []
    if ref:
        out.append((Policy.reference(specs_j),
                    tpolicy.Policy.reference(specs_t)))
    rng = np.random.default_rng(seed)
    while len(out) < n:
        a = rng.random((len(specs_j), 3)).astype(np.float32)
        out.append((Policy([map_actions(s, x, "pq")
                            for s, x in zip(specs_j, a)]),
                    tpolicy.Policy([tpolicy.map_actions(s, x, "pq")
                                    for s, x in zip(specs_t, a)])))
    return out


# ---------------------------------------------------------------- oracle

@pytest.mark.parametrize("ctx,calibrated", [(c, False) for c in CTXS]
                         + [(CTXS[0], True)])
def test_latency_batch_matches_jax_and_scalar(ctx, calibrated):
    """``policy_latency_batch`` equals the JAX package's and the port's
    scalar oracle per policy, ≤1e-6 relative, in the contexts of
    ``test_batched.py`` and under a calibration table."""
    cfg = ArchConfig(**WIDE)
    specs_j, specs_t = lm_layer_specs(cfg), tcompress.lm_layer_specs(
        _port_cfg(cfg))
    pols = _policies(specs_j, specs_t, 6, seed=3)
    jcal = CalibrationTable(**CALIB) if calibrated else None
    tcal = tmeasure.CalibrationTable(**CALIB) if calibrated else None
    jctx, tctx = jlat.LatencyContext(**ctx), tlat.LatencyContext(**ctx)
    jb = jlat.policy_latency_batch(specs_j, [p for p, _ in pols], jlat.V5E,
                                   jctx, calib=jcal)
    tb = tlat.policy_latency_batch(specs_t, [p for _, p in pols], tlat.V5E,
                                   tctx, calib=tcal)
    np.testing.assert_allclose(tb.total_s, jb.total_s, rtol=1e-6)
    np.testing.assert_allclose(tb.unit_time_s, jb.unit_time_s, rtol=1e-6)
    scalar = [tlat.policy_latency(specs_t, p, tlat.V5E, tctx,
                                  calib=tcal).total_s for _, p in pols]
    np.testing.assert_allclose(tb.total_s, scalar, rtol=1e-6)
    # the oracle is built once per (specs, hw, ctx, window, calib)
    assert tlat.get_batch_oracle(specs_t, tlat.V5E, tctx, 0, tcal) is \
        tlat.get_batch_oracle(specs_t, tlat.V5E, tctx, 0, tcal)


def test_decided_before_matches_jax():
    """``decided_before(t)`` at every t equals the JAX one (≤1e-6
    relative), and ``decided_before(L) + overhead`` is the total."""
    cfg = ArchConfig(**WIDE)
    specs_j, specs_t = lm_layer_specs(cfg), tcompress.lm_layer_specs(
        _port_cfg(cfg))
    pols = _policies(specs_j, specs_t, 4, seed=5)
    jb = jlat.policy_latency_batch(specs_j, [p for p, _ in pols], jlat.V5E,
                                   jlat.LatencyContext(**CTXS[0]))
    tb = tlat.policy_latency_batch(specs_t, [p for _, p in pols], tlat.V5E,
                                   tlat.LatencyContext(**CTXS[0]))
    assert tb.extra_time_s.shape == (4, cfg.num_layers)
    for t in range(len(specs_t) + 1):
        np.testing.assert_allclose(tb.decided_before(t),
                                   jb.decided_before(t), rtol=1e-6)
    np.testing.assert_allclose(
        tb.decided_before(len(specs_t)) + tb.overhead_s, tb.total_s,
        rtol=1e-12)


# ----------------------------------------------------------------- state

def test_build_state_batch_matches_jax():
    """Every step's (K, state_dim) states equal the JAX builder's (atol
    1e-6) on the same partial policies, previous actions and KL table,
    and each row equals the port's scalar ``build_state``."""
    cfg = ArchConfig(**WIDE)
    specs_j, specs_t = lm_layer_specs(cfg), tcompress.lm_layer_specs(
        _port_cfg(cfg))
    rng = np.random.default_rng(11)
    probes = tsens.FEATURE_PROBES
    table = {s.name: {p: float(rng.random()) for p in probes[:4]}
             for s in specs_t if s.quantizable}
    jsens, tsn = SensitivityResult(table), tsens.SensitivityResult(table)
    jctx, tctx = jlat.LatencyContext(**CTXS[0]), tlat.LatencyContext(
        **CTXS[0])
    jref = jlat.policy_latency(specs_j, Policy.reference(specs_j), jlat.V5E,
                               jctx)
    tref = tlat.policy_latency(specs_t, tpolicy.Policy.reference(specs_t),
                               tlat.V5E, tctx)
    pols = _policies(specs_j, specs_t, 3, seed=2, ref=False)
    prev = rng.random((3, 3)).astype(np.float32)
    jcur = jlat.policy_latency_batch(specs_j, [p for p, _ in pols], jlat.V5E,
                                     jctx)
    tcur = tlat.policy_latency_batch(specs_t, [p for _, p in pols], tlat.V5E,
                                     tctx)
    for t in range(len(specs_t)):
        got = tstate.build_state_batch(specs_t, t, tcur, tsn, prev, tref)
        want = jstate.build_state_batch(specs_j, t, jcur, jsens, prev, jref)
        assert got.shape == (3, tstate.state_dim(3))
        np.testing.assert_allclose(got, want, atol=1e-6)
        for j, (_, p) in enumerate(pols):
            np.testing.assert_allclose(
                got[j], tstate.build_state(specs_t, t, p, tsn, prev[j],
                                           tlat.V5E, tctx, tref), atol=1e-6)


# ----------------------------------------------------------------- actor

def _agent_pair(seed=0, state_dim=33, action_dim=3):
    jcfg = jddpg.DDPGConfig(state_dim=state_dim, action_dim=action_dim,
                            hidden=(32, 24))
    tcfg = tddpg.DDPGConfig(state_dim=state_dim, action_dim=action_dim,
                            hidden=(32, 24))
    ja = jddpg.DDPGAgent(jcfg, seed=seed)
    ta = tddpg.DDPGAgent(tcfg, seed=seed, device="cpu")
    ta.state = convert.agent_state(jax.device_get(ja.state), device="cpu")
    obs = np.random.default_rng(seed + 1).random((40, state_dim)).astype(
        np.float32)
    ja.observe_states(obs)
    ta.observe_states(obs)
    return ja, ta


@pytest.mark.parametrize("case", ["warmup", "live", "mixed", "sigma0",
                                  "wide_sigma"])
def test_act_batch_matches_jax(case):
    """The port's ``act_batch`` draws exactly what the JAX agent draws
    (same seed, states, norm and masks): the uniform block for warmup
    rows, the rejection passes over pending rows, the clipped fallback;
    and the generators end in the same state."""
    ja, ta = _agent_pair()
    K = 6
    states = np.random.default_rng(7).random((K, 33)).astype(np.float32)
    warm = {"warmup": np.ones(K, bool), "live": np.zeros(K, bool),
            "mixed": np.asarray([1, 0, 1, 0, 0, 1], bool),
            "sigma0": np.zeros(K, bool),
            "wide_sigma": np.zeros(K, bool)}[case]
    sig = {"sigma0": np.zeros(K), "wide_sigma": np.full(K, 3.0)}.get(
        case, np.linspace(0.5, 0.1, K))
    for _ in range(3):
        got = ta.act_batch(states, sig, warm)
        want = ja.act_batch(states, sig, warm)
        assert got.dtype == np.float32 and got.shape == (K, 3)
        np.testing.assert_array_equal(got, want)
    assert ta.np_rng.random() == ja.np_rng.random()


# ----------------------------------------------------------------- masks

def test_keep_mask_dynamic_matches_jax_and_keep_mask():
    """Masks for a vector of kept counts on scores with tied columns equal
    the JAX ``keep_mask_dynamic`` row by row and the port's scalar
    ``keep_mask`` (ties go to the lower index), exactly."""
    rng = np.random.default_rng(4)
    sc = rng.random(16).astype(np.float32)
    sc[[3, 9, 12]] = sc[5]
    sc[[0, 14]] = sc[7]
    keep = np.asarray([0, 1, 4, 5, 6, 7, 8, 15, 16, 17])
    got = tpruning.keep_mask_dynamic(torch.from_numpy(sc), keep)
    want = np.stack([np.asarray(jpruning.keep_mask_dynamic(
        jnp.asarray(sc), jnp.int32(k))) for k in keep])
    assert got.shape == (len(keep), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    for row, k in zip(got, keep):
        assert torch.equal(row, tpruning.keep_mask(torch.from_numpy(sc), k))


# ----------------------------------------------------- K1 over slots (plain)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("ste", [False, True])
def test_fake_quant_slots_plain_exact(dtype, ste):
    """K1 over policy slots on a CPU tensor (its plain version) equals
    ``fake_quant_ref`` / ``fake_quant_ste_ref`` slot by slot, exactly:
    different bits per slot, slots at 32 copied, each slot its own range;
    a shared input (slot stride 0) too. No launch is counted."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(6)
    bits = (4, 32, 1, 8, 31, 6, 32, 2)
    x = torch.from_numpy(rng.standard_normal((8, 37, 24)).astype(
        np.float32) * np.linspace(0.5, 4, 8)[:, None, None]).to(dt)
    w = torch.from_numpy(rng.standard_normal((37, 24)).astype(
        np.float32)).to(dt)
    fn = fake_quant_ste_ref if ste else fake_quant_ref
    before = dict(build.LAUNCHES)
    for xs, slot in ((x, lambda k: x[k]), (w.expand(8, 37, 24),
                                           lambda k: w)):
        got = tfq.fake_quant_slots(xs, bits, ste=ste)
        assert got.dtype == dt and got.shape == (8, 37, 24)
        for k, b in enumerate(bits):
            assert torch.equal(got[k], fn(slot(k), b)), (k, b)
        assert torch.equal(got, fake_quant_slots_ref(xs, bits, ste))
    assert dict(build.LAUNCHES) == before


def test_fake_quant_slots_one_range_per_slot():
    """Each slot's range is over its own rows only: a slot with a planted
    outlier quantizes differently from the same rows quantized over all
    the slots' rows at once (the fault the batched path must not have)."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 64, 8)).astype(np.float32))
    x[1, 0, 3] = 40.0
    got = tfq.fake_quant_slots(x, (4, 4))
    folded = fake_quant_ref(x.reshape(128, 8), 4).reshape(2, 64, 8)
    assert torch.equal(got[0], fake_quant_ref(x[0], 4))
    assert not torch.equal(got[0], folded[0])


def test_fake_quant_slots_op_reads_a_transposed_shared_view():
    """``ops.fake_quant_slots`` takes the tied head's ``embed.T`` expanded
    over the slots (channel stride not 1) and equals the scalar
    straight-through op slot by slot; the wrapper refuses a slot count
    that does not match the bits."""
    rng = np.random.default_rng(9)
    emb = torch.from_numpy(rng.standard_normal((48, 16)).astype(
        np.float32)).to(torch.bfloat16)
    bits = (3, 32, 7)
    got = tops.fake_quant_slots(emb.T.expand(3, 16, 48), bits)
    for k, b in enumerate(bits):
        want = emb.T if b >= 32 else tops.fake_quant_ste(emb.T, b)
        assert torch.equal(got[k], want)
    with pytest.raises(ValueError, match="slots"):
        tfq.fake_quant_slots(emb.expand(2, 48, 16), bits)


def test_fake_quant_slots_plan_fills_the_card_over_slots():
    """The slot plan cuts fewer slabs per slot as K grows (the slots fill
    the card), never fewer than one, and equals the one-tensor plan at
    K 1."""
    assert tfq.plan(3072, 256, 2, 1) == tfq.plan(3072, 256, 2)
    p1, p8 = tfq.plan(3072, 1024, 2, 1), tfq.plan(3072, 1024, 2, 8)
    assert p8.n_slabs <= p1.n_slabs
    assert p8.n_ctiles * p8.n_slabs * 8 >= tfq.TARGET_BLOCKS // 2
    assert tfq.plan(8, 256, 2, 64).n_slabs == 1


# ------------------------------------------------------ batched validation

def _lm_pair(jcfg, tcfg, tied_scores=False):
    params = M.init(jcfg, jax.random.PRNGKey(0))
    if tied_scores:
        # duplicated MLP columns in layer 1 force tied prune scores
        up = np.array(params["blocks"]["mlp"]["w_up"]["w"])
        gate = np.array(params["blocks"]["mlp"]["w_gate"]["w"])
        up[1, :, 5], gate[1, :, 5] = up[1, :, 3], gate[1, :, 3]
        params["blocks"]["mlp"]["w_up"]["w"] = jnp.asarray(up)
        params["blocks"]["mlp"]["w_gate"]["w"] = jnp.asarray(gate)
    tparams = convert.lm_params(tcfg, jax.device_get(params), device="cpu")
    return CompressibleLM(jcfg, params), tcompress.CompressibleLM(tcfg,
                                                                  tparams)


def _check_batched_accuracy(jcm, tcm, batch, pols):
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    jpb = stack_policies(jcm.specs, [p for p, _ in pols])
    tpb = tpolicy.stack_policies(tcm.specs, [p for _, p in pols])
    want = np.asarray(jcm.accuracy_policy_batch(batch, jpb))
    got = tcm.accuracy_policy_batch(tb, tpb).numpy()
    stacked = tcm.accuracy_batch(
        tb, tcompress.stack_cspecs([tcm.build_cspec(p) for _, p in pols]))
    scalar = [float(tcm.accuracy(tb, tcm.build_cspec(p))) for _, p in pols]
    assert got.shape == (len(pols),)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(stacked.numpy(), got, atol=1e-6)
    np.testing.assert_allclose(got, scalar, atol=1e-6)
    return got


def test_accuracy_policy_batch_matches_jax_and_scalar():
    """The tiny f32 LM (tied prune scores in layer 1), the reference and
    five random pq policies: the port's one-forward validation equals the
    JAX ``accuracy_policy_batch``, ``accuracy_batch`` of the stacked
    scalar cspecs and the port's scalar accuracy per policy."""
    jcfg = ArchConfig(**TINY, compute_dtype="float32")
    jcm, tcm = _lm_pair(jcfg, _port_cfg(jcfg), tied_scores=True)
    batch = bigram_lm(jcfg.vocab_size, 8, 32, seed=3)
    pols = _policies(jcm.specs, tcm.specs, 6, seed=21)
    accs = _check_batched_accuracy(jcm, tcm, batch, pols)
    assert len(set(accs.tolist())) > 1


def test_batched_cspec_equals_the_scalar_ones():
    """``cspec_builder`` on a ``PolicyBatch`` gives, slot by slot, the bits
    and masks of ``build_lm_cspec`` (and of ``stack_cspecs``), and the
    batched forward's logits are, slot by slot, the scalar forward's
    (f32 on the CPU, exactly)."""
    jcfg = ArchConfig(**TINY, compute_dtype="float32")
    _, tcm = _lm_pair(jcfg, _port_cfg(jcfg), tied_scores=True)
    pols = [p for _, p in _policies(tcm.specs, tcm.specs, 4, seed=13)]
    pb = tpolicy.stack_policies(tcm.specs, pols)
    built = tcm.cspec_builder()(pb.keep, pb.w_bits, pb.a_bits)
    stacked = tcm.build_cspec_batch(pols)
    assert built["slots"] == stacked["slots"] == 4

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    got, want = dict(leaves(built)), dict(leaves(stacked))
    assert got.keys() == want.keys()
    for key, v in got.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, want[key]), key
        else:
            assert v == want[key], key
    tokens = torch.as_tensor(np.array(bigram_lm(jcfg.vocab_size, 4, 16,
                                                seed=1)["tokens"]))
    logits = TM.forward(tcm.cfg, tcm.params, tokens, built)
    assert logits.shape == (4, 4, 16, jcfg.vocab_size)
    for k, p in enumerate(pols):
        assert torch.equal(logits[k], TM.forward(
            tcm.cfg, tcm.params, tokens, tcm.build_cspec(p)))


def test_decode_attention_takes_per_slot_head_masks():
    """``decode_attention`` with [K, H] head masks over K policies' rows
    folded into the batch equals the per-slot [H] masks."""
    rng = np.random.default_rng(12)
    K, B, H, KV, D, W = 3, 2, 4, 2, 8, 10
    q = torch.from_numpy(rng.standard_normal((K * B, 1, H, D)).astype(
        np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((K * B, W, KV, D))
                               .astype(np.float32)) for _ in range(2))
    masks = torch.from_numpy((rng.random((K, H)) > 0.4).astype(np.float32))
    got = TL.decode_attention(q, kc, vc, 7, head_mask=masks)
    for k in range(K):
        rows = slice(k * B, (k + 1) * B)
        assert torch.equal(got[rows], TL.decode_attention(
            q[rows], kc[rows], vc[rows], 7, head_mask=masks[k]))


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_accuracy_policy_batch_parity_archs(arch):
    """The SSM and RG-LRU families at SMOKE width in f32 (SSD heads and
    LRU channels pruned, the RG-LRU's input quantized once for both
    projections): the batched validation equals the JAX one and the
    port's scalar accuracy. The port refuses the MoE configs, so they
    have no case."""
    over = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = get_config(arch, smoke=True).replace(**over)
    tcfg = treg.get_config(arch, smoke=True).replace(**over)
    jcm, tcm = _lm_pair(jcfg, tcfg)
    batch = {"tokens": np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, 16), 0, jcfg.vocab_size))}
    pols = _policies(jcm.specs, tcm.specs, 3, seed=13)
    _check_batched_accuracy(jcm, tcm, {"tokens": jnp.asarray(
        batch["tokens"])}, pols)


# ------------------------------------------------------------- the engine

K_BATCH, EPISODES, WARMUP, UPDATES, BATCH = 4, 8, 2, 2, 16
CTX = dict(tokens=1, seq_ctx=512, mode="decode", batch=1)


@pytest.fixture(scope="module")
def engines():
    """The JAX and the port's ``BatchedCompressionSearch`` on the tiny f32
    LM (K 4, 8 episodes, warmup 2): the same weights and initial agent,
    the JAX sensitivity table fed to the port, and the replay indices of
    every JAX update chunk fed to the port's chunk in the same order."""
    cfg = ArchConfig(**TINY, compute_dtype="float32")
    params = M.init(cfg, jax.random.PRNGKey(0))
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3)
    ddpg = dict(warmup_episodes=WARMUP, updates_per_episode=UPDATES,
                batch_size=BATCH, buffer_size=200, hidden=(32, 24))
    reward = dict(target_ratio=0.5, beta=-3.0)
    js = BatchedCompressionSearch(
        CompressibleLM(cfg, params), batch,
        SearchConfig(methods="pq", episodes=EPISODES, seed=0,
                     reward=RewardConfig(**reward),
                     ddpg=jddpg.DDPGConfig(**ddpg)),
        jlat.LatencyContext(**CTX), batch_size=K_BATCH)
    tcfg = _port_cfg(cfg)
    tm = tcompress.CompressibleLM(
        tcfg, convert.lm_params(tcfg, jax.device_get(params), device="cpu"))
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    ts = tsearch.BatchedCompressionSearch(
        tm, tb,
        tsearch.SearchConfig(methods="pq", episodes=EPISODES, seed=0,
                             reward=treward.RewardConfig(**reward),
                             ddpg=tddpg.DDPGConfig(**ddpg)),
        tlat.LatencyContext(**CTX),
        sens=tsens.SensitivityResult(dict(js.sens.table)),
        batch_size=K_BATCH)
    ts.agent.state = convert.agent_state(jax.device_get(js.agent.state),
                                         device="cpu")

    fed, sizes = [], []
    j_chunk = js.agent.update_chunk

    def recording_chunk(replay, n):
        sizes.append(n)
        _, keys = jddpg.chunk_sample_keys(js.agent.state.key, n)
        fed.append(np.stack([np.asarray(jax.random.randint(
            k, (BATCH,), 0, max(len(replay), 1))) for k in keys]))
        return j_chunk(replay, n)

    js.agent.update_chunk = recording_chunk
    jr = js.run()

    queue = list(fed)
    t_chunk = ts.agent.update_chunk
    t_sizes = []

    def fed_chunk(replay, n):
        t_sizes.append(n)
        return t_chunk(replay, n, indices=torch.as_tensor(queue.pop(0)))

    ts.agent.update_chunk = fed_chunk
    tr = ts.run()
    assert not queue                  # every JAX chunk was replayed
    return js, ts, jr, tr, sizes, t_sizes


def test_batched_search_records_match_jax(engines):
    """Per episode: CMPs, accuracy and sigma exact, latency ≤1e-6
    relative, reward ≤1e-5."""
    _, _, jr, tr, *_ = engines
    assert tr.ref_accuracy == jr.ref_accuracy
    assert [r.episode for r in tr.history] == list(range(EPISODES))
    for j, t in zip(jr.history, tr.history):
        jc = [(c.keep, c.mode, c.w_bits, c.a_bits) for c in j.policy.cmps]
        tc = [(c.keep, c.mode, c.w_bits, c.a_bits) for c in t.policy.cmps]
        assert tc == jc, f"episode {j.episode}: CMPs differ"
        assert t.accuracy == j.accuracy, f"episode {j.episode}"
        np.testing.assert_allclose(t.latency_s, j.latency_s, rtol=1e-6)
        np.testing.assert_allclose(t.reward, j.reward, atol=1e-5)
        assert t.sigma == j.sigma


def test_batched_search_update_chunks_and_ring_match_jax(engines):
    """One update chunk per batch of ``updates × live episodes`` (4 then
    8), and the replay ring holds the JAX ring's transitions in the same
    slots (states T-major into the norm, K-major into the ring): exactly
    up to the first update; after it the actor equals the JAX actor
    within the update-parity bound, so actions (and the states that
    carry them as the previous action) within 1e-5."""
    js, ts, _, _, sizes, t_sizes = engines
    assert t_sizes == sizes == [UPDATES * 2, UPDATES * 4]
    assert ts._pending_updates == 0
    d = jax.device_get(js.replay.data)
    assert (ts.replay.ptr, ts.replay.size) == (js.replay.ptr,
                                               js.replay.size)
    first = K_BATCH * len(ts.steps)       # rows pushed before any update
    for name in ("states", "actions", "rewards", "next_states", "dones"):
        got = getattr(ts.replay, name).numpy()
        want = np.asarray(getattr(d, name))
        np.testing.assert_array_equal(got[:first], want[:first],
                                      err_msg=name)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(ts.agent.norm.mean, js.agent.norm.mean,
                               atol=1e-6)
    np.testing.assert_allclose(ts.agent.norm.var, js.agent.norm.var,
                               atol=1e-6)


def test_chip_smoke_batched_phase_on_cpu():
    """``chip_smoke.py``'s batched phase at a small size on the CPU (plain
    versions in place of the kernels, so no launch is counted): the
    records, the per-site K1 bookkeeping, the slot checks and the
    batched-vs-scalar agreement all pass, and a wrong launch count is
    refused."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from repro_torch.configs.testbed import LM_CFG
    cfg = LM_CFG.replace(num_layers=2, d_ff=512)
    small = dict(warmup=2, updates=2, batch_size=16, val_batch=4,
                 val_seq=16, verbose=False)
    search, *_ = chip_smoke.run_main_path(cfg, "cpu", episodes=2, **small)
    bsearch, hist, _ = chip_smoke.run_batched_path(
        cfg, "cpu", search.sens, episodes=6, slots=4, **small)
    assert [r.episode for r in hist] == list(range(6))
    cspecs = chip_smoke.batch_cspecs(bsearch, hist)
    assert [cs["slots"] for cs in cspecs] == [4, 2]
    sites = sum(len(chip_smoke.k1_calls(cfg, cs, 64)) for cs in cspecs)
    assert sites > 0
    launches = {"fake_quant_slots": sites, "fake_quant": 0, "mlp3": 40,
                "polyak": 8}
    out = chip_smoke.check_batched_path(bsearch, hist, cfg, 6, launches,
                                        {"mlp3": 5.0, "polyak": 1.0}, "cpu")
    assert out["sites"] == sites and out["argmax_agree"] == 1.0
    with pytest.raises(AssertionError, match="fake_quant_slots"):
        chip_smoke.check_batched_path(
            bsearch, hist, cfg, 6, {**launches, "fake_quant_slots": 1},
            {"mlp3": 5.0, "polyak": 1.0}, "cpu")
