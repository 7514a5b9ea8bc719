"""The port's MoE block and the two MoE configs (mixtral-8x22b, and
arctic-480b with its dense residual) against the JAX package on the same
inputs (made with numpy from a seed) and weights (carried over with
``repro_torch.convert``), on the CPU: ``moe_dispatch``, ``apply_moe``
(raw and under a cspec, with and without drops), the whole forward,
decode against prefill, the cspec (``moe_up`` scores, the dense
residual's mask), a train step, the batched validation, and the deployed
int8 / int4 forward.

Models: the SMOKE configs in f32 (2 layers, d 64, 4 / 2 heads of 16; 4
experts top-2 of d_ff 128 (mixtral) or 96 (arctic), capacity factor
1.5). Drops need more than 4,096 token-experts in a group: 2 x 1,024
tokens at E 4 with the capacity factor cut to 0.5 (512 slots for 1,024
choices per expert on average).

Tolerances, with what was found:
  * ``moe_dispatch``: the integer outputs (dispatch, slot, keep) exact,
    the renormalised gates ≤1e-6 (found 0). The seeded draws' top-k
    margin (the gap from the k-th to the (k+1)-th gate) is asserted
    above 1e-6, so the choices are not a near-tie that the two
    softmaxes could order differently.
  * ``apply_moe``: ≤1e-5 (found ≤1.6e-6), raw and under a cspec (4-8
    bit fake quantization and an ff mask; the dense residual's too).
  * forward: logits ≤1e-4 (found ~4e-6). Decode: each step's logits
    ≤1e-4 against JAX's decode and against the port's own prefill.
  * cspec bits and masks: exact.
  * train step (3 steps, each from JAX's state): loss ≤1e-5, updated
    params within 0.1 x that step's lr, as ``tests/test_torch_train.py``
    holds them.
  * ``accuracy_policy_batch``: port batched against port scalar ≤1e-6,
    and equal to JAX's on these draws (a flipped fake-quant step could
    move one token's argmax: ``tests/test_torch_flips.py``).
  * deployed forward: the int8 / packed-int4 codes and scales bit-equal
    to JAX's ``quantize_params_for_deploy`` (per expert), the logits
    ≤1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.core import deploy as jdeploy  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.policy import Policy, map_actions, stack_policies  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

ARCHS = ("mixtral-8x22b", "arctic-480b")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
STEP_TOL = 0.1          # params per step, in units of that step's lr
MARGIN = 1e-6           # the smallest top-k margin the draws must have


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair(arch, capacity_factor=None):
    """The SMOKE config in f32 on both sides (``capacity_factor`` replaced
    where given), JAX weights from ``PRNGKey(0)`` carried into the
    port."""
    over = dict(compute_dtype="float32")
    jcfg = jreg.get_config(arch, smoke=True).replace(**over)
    tcfg = treg.get_config(arch, smoke=True).replace(**over)
    if capacity_factor is not None:
        m = jcfg.moe
        kw = dict(num_experts=m.num_experts, top_k=m.top_k,
                  capacity_factor=capacity_factor,
                  dense_residual=m.dense_residual)
        jcfg, tcfg = jcfg.replace(moe=JMoE(**kw)), tcfg.replace(
            moe=TMoE(**kw))
    params = jax.jit(JM.init, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    host = jax.device_get(params)
    return jcfg, params, host, tcfg, convert.lm_params(tcfg, host, "cpu")


def _layer0_moe(arch, capacity_factor=None):
    jcfg, params, host, tcfg, tparams = _pair(arch, capacity_factor)
    return (jcfg, jax.tree.map(lambda x: x[0], params["blocks"]["moe"]),
            tcfg, tparams["blocks"][0]["moe"])


def _seeded_policy(jspecs, tspecs, seed):
    rng = np.random.default_rng(seed)
    pj, pt = Policy.reference(jspecs), tp.Policy.reference(tspecs)
    for i, (sj, st) in enumerate(zip(jspecs, tspecs)):
        a = rng.random(3).astype(np.float32)
        pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
            tp.map_actions(st, a, "pq")
    return pj, pt


def _gates(seed, T, E, skew=0.0):
    """Softmax gates [1, T, E] from seeded logits; ``skew`` favours expert
    0 (so that its slots overflow)."""
    logits = np.random.default_rng(seed).standard_normal(
        (1, T, E)).astype(np.float32)
    logits[..., 0] += skew
    return np.array(jax.nn.softmax(jnp.asarray(logits), -1))


def _margin(gates, K):
    s = np.sort(gates, -1)[..., ::-1]
    return float((s[..., K - 1] - s[..., K]).min())


# --------------------------------------------------------------------------
# Dispatch and the block
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T,skew,cf", [(40, 0.0, 1.5), (2048, 1.5, 1.25)],
                         ids=["no_drops", "drops"])
def test_moe_dispatch_matches_jax(T, skew, cf):
    E, K = 4, 2
    g = _gates(T, T, E, skew)
    assert _margin(g, K) > MARGIN, "a near-tie on this draw"
    cap = TB.moe_capacity(T, E, K, cf)
    if T * E > 4096:
        assert cap == max(4, -(-int(np.ceil(K * T / E * cf)) // 4) * 4)
    else:
        assert cap == T
    want = JB.moe_dispatch(jnp.asarray(g), E, K, cap)
    got = TB.moe_dispatch(torch.from_numpy(g), E, K, cap)
    for name, w, t in zip(("dispatch", "gates", "slot", "keep"), want, got):
        w = np.asarray(w)
        assert t.shape == w.shape, name
        if name == "gates":
            np.testing.assert_allclose(t.numpy(), w, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
    keep = got[3].numpy()
    assert keep.all() if skew == 0 else 0.05 < 1 - keep.mean() < 0.5


def test_dispatch_groups_on_one_device():
    assert TB.dispatch_groups(2048, 4) == 1
    assert TB.dispatch_groups(2048, 4, groups=8) == 8
    assert TB.dispatch_groups(24, 4, groups=8) == 1     # 3 a group < 16


def _moe_cspec(jcfg, rng, bits):
    """A hand cspec of the MoE entry: bits (w, a, w_down, a_down), an ff
    mask, and the dense residual's where the config has one."""
    ff = jcfg.d_ff
    mask = (rng.random(ff) > 0.3).astype(np.float32)
    dmask = (rng.random(ff) > 0.5).astype(np.float32)
    w, a, wd, ad = bits
    cs = {"up": {"w_bits": w, "a_bits": a},
          "down": {"w_bits": wd, "a_bits": ad}, "ff_mask": mask,
          "dense_up": None, "dense_down": None, "dense_ff_mask": None}
    if jcfg.moe.dense_residual:
        cs.update(dense_up={"w_bits": a, "a_bits": w},
                  dense_down={"w_bits": ad, "a_bits": wd},
                  dense_ff_mask=dmask)

    def to(lib):
        def leaf(v):
            if isinstance(v, np.ndarray):
                return jnp.asarray(v) if lib == "jax" \
                    else torch.from_numpy(v)
            return jnp.int32(v) if lib == "jax" else v
        return jax.tree.map(leaf, cs)
    return to("jax"), to("torch")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens,cf", [(40, None), (2048, 0.5)],
                         ids=["no_drops", "drops"])
@pytest.mark.parametrize("bits", [None, (4, 6, 5, 8)],
                         ids=["raw", "cspec"])
def test_apply_moe_matches_jax(arch, tokens, cf, bits):
    jcfg, jp, tcfg, tpp = _layer0_moe(arch, cf)
    rng = np.random.default_rng(tokens)
    x = rng.standard_normal((2, tokens // 2, jcfg.d_model)).astype(
        np.float32)
    jc, tc = (None, None) if bits is None else _moe_cspec(jcfg, rng, bits)
    want = np.asarray(JB.apply_moe(jp, jnp.asarray(x), jcfg, jc))
    build.reset_launches()
    got = TB.apply_moe(tpp, torch.from_numpy(x), tcfg, tc)
    assert sum(build.LAUNCHES.values()) == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if cf is not None:      # the drop case drops
        xt = torch.from_numpy(x).reshape(1, tokens, -1)
        assert not TB.moe_route(tpp, xt, tcfg)[3].all()


def test_apply_moe_counts_the_pad_rows_in_the_range(monkeypatch):
    """Empty capacity slots read the zero pad row, and the dispatched
    buffer's fake-quant range counts those rows (as the JAX package
    does): at 40 tokens every expert has 40 slots and far fewer choices,
    so the buffer the quantizer sees holds zero rows."""
    from repro_torch.models import blocks as blocks_mod
    jcfg, jp, tcfg, tpp = _layer0_moe("mixtral-8x22b")
    seen = []
    plain = blocks_mod.fake_quant_act

    def record(x, bits):
        seen.append(x.clone())
        return plain(x, bits)
    monkeypatch.setattr(blocks_mod, "fake_quant_act", record)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 40, jcfg.d_model))
                         .astype(np.float32))
    _, tc = _moe_cspec(jcfg, rng, (8, 4, 8, 8))
    TB.apply_moe(tpp, x, tcfg, tc)
    xe = seen[0]
    E = jcfg.moe.num_experts
    assert tuple(xe.shape) == (1, E, 40, jcfg.d_model)
    zero_rows = (xe.abs().sum(-1) == 0).sum().item()
    assert zero_rows == E * 40 - 40 * jcfg.moe.top_k


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_slots_route_each_policy_alone(arch):
    """A batched cspec of K 3 policies (their rows folded into the batch
    axis) equals the K scalar calls on the same rows, with drops: each
    policy dispatches its own tokens at its own capacity, with its own
    quantized experts."""
    jcfg, jp, tcfg, tpp = _layer0_moe(arch, 0.5)
    rng = np.random.default_rng(11)
    xs = [torch.from_numpy(rng.standard_normal((2, 1024, jcfg.d_model))
                           .astype(np.float32)) for _ in range(3)]
    bits = [(4, 6, 5, 8), (32, 32, 32, 32), (2, 8, 3, 4)]
    cspecs = [_moe_cspec(jcfg, np.random.default_rng(k), b)[1]
              for k, b in enumerate(bits)]
    stacked = tcompress.stack_cspecs(cspecs)
    got = TB.apply_moe(tpp, torch.cat(xs), tcfg, stacked)
    for k in range(3):
        want = TB.apply_moe(tpp, xs[k], tcfg, cspecs[k])
        torch.testing.assert_close(got[2 * k:2 * k + 2], want, atol=1e-6,
                                   rtol=0)


# --------------------------------------------------------------------------
# Forward, decode, cspec, convert
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, params, _, tcfg, tparams = _pair(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 40))
    want = np.asarray(JM.forward(jcfg, params, tokens=jnp.asarray(toks)))
    got = TM.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_prefill(arch):
    """12 decode steps from seeded tokens (past mixtral's SMOKE window of
    32 is not needed here: its ring is exercised by the attention
    tests): each step's logits against JAX's decode step and against
    the port's prefill over the same tokens."""
    jcfg, params, _, tcfg, tparams = _pair(arch)
    steps = 12
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (2, steps))
    jcache = JM.init_cache(jcfg, 2, 16)
    tcache = TM.init_cache(tcfg, 2, 16, device="cpu")
    jstep_fn = jax.jit(jstep.make_serve_step(jcfg))
    pre = TM.forward(tcfg, tparams, torch.from_numpy(toks))
    for pos in range(steps):
        tok = toks[:, pos:pos + 1]
        jl, jcache = jstep_fn(params, jcache, jnp.asarray(tok), pos)
        tl, tcache = TM.decode_step(tcfg, tparams, tcache,
                                    torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        torch.testing.assert_close(tl[:, 0], pre[:, pos], atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_cspec_matches_jax(arch):
    """``build_lm_cspec`` and the batched builder: the MoE entry's bits
    and masks (``moe_up`` scored over up and gate, the dense residual's
    own) equal JAX's, and the dense-residual mask defaults to ones."""
    jcfg, params, host, tcfg, tparams = _pair(arch)
    jcm = CompressibleLM(jcfg, params)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    kinds = {s.kind for s in tcm.specs}
    assert {"moe_up", "moe_down"} <= kinds
    for seed in (3, 4):
        pj, pt = _seeded_policy(jcm.specs, tcm.specs, seed)
        want = jax.device_get(jcm.build_cspec(pj))
        got = tcm.build_cspec(pt)
        for i in range(tcfg.num_layers):
            jm = jax.tree.map(lambda x: np.asarray(x)[i],
                              want["blocks"]["moe"])
            tm = got["blocks"][i]["moe"]
            assert set(tm) == set(jm)
            for key in ("up", "down", "dense_up", "dense_down"):
                if jm[key] is None:
                    assert tm[key] is None
                    continue
                assert {k: int(v) for k, v in jm[key].items()} == tm[key]
            for key in ("ff_mask", "dense_ff_mask"):
                if jm[key] is None:
                    assert tm[key] is None
                    continue
                np.testing.assert_array_equal(tm[key].numpy(), jm[key])
        batched = tcm.cspec_builder()(*(np.asarray(x)[None] for x in (
            [c.keep for c in pt.cmps], [c.w_bits for c in pt.cmps],
            [c.a_bits for c in pt.cmps])))
        for b, s in zip(batched["blocks"], got["blocks"]):
            np.testing.assert_array_equal(b["moe"]["ff_mask"][0].numpy(),
                                          s["moe"]["ff_mask"].numpy())
    ones = tcompress.build_lm_cspec(tcfg, tparams,
                                    tp.Policy.reference(tcm.specs),
                                    tcm.specs)
    m = ones["blocks"][0]["moe"]
    assert float(m["ff_mask"].min()) == 1.0
    if tcfg.moe.dense_residual:
        assert float(m["dense_ff_mask"].min()) == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    """The JAX tree (f32 router, the stacked [L, E, d, ff] experts, the
    dense residual's raw weights) into the port and back, leaf by
    leaf."""
    jcfg, _, host, tcfg, tparams = _pair(arch)
    moe = tparams["blocks"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["w_up"].shape) == (tcfg.moe.num_experts,
                                        tcfg.d_model, tcfg.d_ff)
    back = convert.to_jax_lm_params(tcfg, tparams)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_array_equal(g, np.asarray(w))


# --------------------------------------------------------------------------
# Training, batched validation, deployment
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """3 steps from JAX's state each time: loss ≤1e-5, every updated
    param within 0.1 x that step's lr; the weight-decay mask follows the
    JAX ``ndim >= 2`` rule on the stacked layout (the router and the
    [E, d, ff] stacks included)."""
    jcfg, params, host, tcfg, _ = _pair(arch)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt.OptimizerConfig(**OPT)))
    tfn = tstep.make_train_step(tcfg, topt.OptimizerConfig(**OPT))
    jp = params
    js = jopt.adamw_init(jp, jopt.OptimizerConfig(**OPT))
    rng = np.random.default_rng(4)
    tparams = convert.lm_params(tcfg, host, "cpu")
    decay = tstep.weight_decay_mask(tcfg, tparams)
    assert decay["blocks"][0]["moe"]["router"]
    assert decay["blocks"][0]["attn_norm"]["scale"]     # stacked: 2-D
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, (4, 24))
        tparams = convert.lm_params(tcfg, jax.device_get(jp), "cpu")
        tstate = convert.adamw_state(tcfg, jax.device_get(js), "cpu")
        jp, js, jm = jfn(jp, js, {"tokens": jnp.asarray(toks)})
        tparams, tstate, tm = tfn(tparams, tstate,
                                  {"tokens": torch.from_numpy(toks)})
        lr = float(jm["lr"])
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        for g, w in zip(jax.tree.leaves(convert.to_jax_lm_params(
                tcfg, tparams)), jax.tree.leaves(jax.device_get(jp))):
            assert (np.abs(g - np.asarray(w)) / lr).max() <= STEP_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_accuracy_policy_batch_matches_scalar_and_jax(arch):
    """``tests/test_batched.py::test_accuracy_policy_batch_parity_archs``'s
    draws on the port: batched against the port's scalar accuracy
    ≤1e-6, and against the JAX batched validation."""
    jcfg, params, host, tcfg, tparams = _pair(arch)
    jcm = CompressibleLM(jcfg, params)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 16))
    pols = [_seeded_policy(jcm.specs, tcm.specs, s) for s in (13, 14, 15)]
    want = np.asarray(jcm.accuracy_policy_batch(
        {"tokens": jnp.asarray(toks)},
        stack_policies(jcm.specs, [p for p, _ in pols])))
    batch = {"tokens": torch.from_numpy(toks)}
    got = tcm.accuracy_policy_batch(
        batch, tp.stack_policies(tcm.specs, [p for _, p in pols])).numpy()
    scalar = np.asarray([float(tcm.accuracy(batch, tcm.build_cspec(p)))
                         for _, p in pols])
    np.testing.assert_allclose(got, scalar, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_deployed_moe_forward_matches_jax(bits):
    """``quantize_params_for_deploy`` on arctic's tree: every expert
    stack gets per-expert scales [E, 1, out] and codes bit-equal to
    JAX's (run eagerly, as ``tests/test_torch_deploy.py`` holds them);
    the deployed forward dequantizes them (``materialize_weight`` on the
    3-D containers) within 1e-4 of JAX's."""
    jcfg, params, host, tcfg, tparams = _pair("arctic-480b")
    with jax.disable_jit():
        jq = jax.device_get(jdeploy.quantize_params_for_deploy(params,
                                                               bits))
    tq = tdeploy.quantize_params_for_deploy(tparams, bits)
    key = "w_q" if bits > 4 else "w_p"
    E = tcfg.moe.num_experts
    for i in range(tcfg.num_layers):
        for name in ("w_up", "w_gate", "w_down", "dense_w_up"):
            got = tq["blocks"][i]["moe"][name]
            want = jax.tree.map(lambda x: np.asarray(x)[i],
                                jq["blocks"]["moe"][name])
            np.testing.assert_array_equal(got[key].numpy(), want[key])
            np.testing.assert_array_equal(got["w_scale"].numpy(),
                                          want["w_scale"])
            if name != "dense_w_up":
                assert tuple(got["w_scale"].shape)[:2] == (E, 1)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 16))
    want = np.asarray(JM.forward(jcfg, jq, tokens=jnp.asarray(toks)))
    got = TM.forward(tcfg, tq, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
