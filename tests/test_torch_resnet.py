"""The ResNet testbed of the port against the JAX package's, on the CPU.

Pieces: the blob image data (bit-exact); ``layer_specs`` of the repo's
ResNet testbed, ResNet18 at CIFAR-10 widths and the tests' tiny config,
and the analytic oracle under the per-image context; XLA's "SAME" padding
at stride 2; the forward on carried weights (``convert.resnet_params``),
raw and under a quantized and pruned policy; the cspec's ℓ1 masks with
tied scores; the sensitivity analysis; the batched validation (one
forward over K policies: grouped convs over the slots' channels, K1 over
the slots); the whole scalar pq search fed the JAX draws; and a CPU
rehearsal of ``chip_smoke.py``'s ``[resnet path]`` phase.

Tolerances: data, specs, CMPs, masks and accuracy exact; the oracle
≤1e-6 relative; the stride-2 conv exact (the same products summed in
the same order on the CPU once XLA's asymmetric pad is applied); raw
logits ≤1e-5 relative to the largest logit (convs and GroupNorm sum in
other orders than XLA's); under a policy each quantized, masked conv
≤1e-5 relative on the JAX layer's own input (K1's plain version is
exact there), while the whole forward is held by its argmaxes and its
accuracy, exactly: a last-bit difference of a conv output can move a
later range by an ulp and an element by a whole quantization step (the
LM's compressed forwards behave the same way, ROADMAP Queue 3);
sensitivity KLs ≤1e-6; the search's latency ≤1e-6 relative and reward
≤1e-5.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro.core import ddpg as jddpg  # noqa: E402
from repro.core.compress import CompressibleResNet  # noqa: E402
from repro.core.ddpg import DDPGConfig  # noqa: E402
from repro.core.latency import LatencyContext, policy_latency  # noqa: E402
from repro.core.policy import Policy, map_actions, stack_policies  # noqa: E402
from repro.core.reward import RewardConfig  # noqa: E402
from repro.core.search import CompressionSearch, SearchConfig  # noqa: E402
from repro.core.sensitivity import run_sensitivity  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import resnet as JR  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import testbed  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import ddpg as tddpg  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import reward as treward  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import resnet as TR  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(stages=(1, 1), widths=(8, 16), img_size=8, num_classes=4)
IMG_CTX = dict(tokens=1, seq_ctx=0, mode="prefill", batch=1)
CFGS = {"tiny": TINY,
        "testbed": dict(name="testbed-resnet", stages=(2, 2, 2),
                        widths=(16, 32, 64), num_classes=10, img_size=16),
        "resnet18": dict(name="resnet18-cifar10", stages=(2, 2, 2, 2),
                         widths=(64, 128, 256, 512), num_classes=10,
                         in_channels=3, img_size=32)}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _pair(args, seed=0):
    """(JAX adapter, port adapter) on the same f32 weights: the port's
    seeded init (the JAX init's tree and scales; drawing them with
    ``jax.random`` compiles a program per shape), carried to the port
    through ``convert.resnet_params`` as JAX weights would be."""
    jcfg, tcfg = JR.ResNetConfig(**args), TR.ResNetConfig(**args)
    params = _to_jax(TR.init(tcfg, seed=seed, device="cpu"))
    assert jax.tree.structure(params) == jax.tree.structure(
        jax.eval_shape(lambda: JR.init(jcfg, jax.random.PRNGKey(0))))
    return (CompressibleResNet(jcfg, params), tcompress.CompressibleResNet(
        tcfg, convert.resnet_params(jax.device_get(params), device="cpu")))


def _batch(ncls, n, img, seed):
    return (jdata.blob_images(ncls, n, img, seed=seed),
            tdata.blob_images(ncls, n, img, seed=seed, device="cpu"))


def _policies(specs_j, specs_t, n, seed, ref=True):
    """``n`` pq policies (the first the reference when ``ref``), each as a
    (JAX, port) pair with the same CMPs."""
    out = [(Policy.reference(specs_j), tpolicy.Policy.reference(specs_t))
           ] if ref else []
    rng = np.random.default_rng(seed)
    while len(out) < n:
        a = rng.random((len(specs_j), 3)).astype(np.float32)
        out.append((Policy([map_actions(s, x, "pq")
                            for s, x in zip(specs_j, a)]),
                    tpolicy.Policy([tpolicy.map_actions(s, x, "pq")
                                    for s, x in zip(specs_t, a)])))
    return out


def _cmps(p):
    return [(c.keep, c.mode, c.w_bits, c.a_bits) for c in p.cmps]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def tiny():
    jcm, tcm = _pair(TINY)
    jb, tb = _batch(4, 16, 8, seed=5)
    return jcm, tcm, jb, tb


def test_blob_data_bit_exact():
    for args in ((4, 8, 3, 1234), (10, 32, 3, 7), (10, 16, 1, 1234)):
        np.testing.assert_array_equal(tdata.make_blob_protos(*args),
                                      jdata.make_blob_protos(*args))
    for ncls, n, img, seed in ((4, 16, 8, 5), (10, 256, 32, 11)):
        jb, tb = _batch(ncls, n, img, seed)
        assert tb["images"].dtype == torch.float32
        assert tb["labels"].dtype == torch.int64
        assert tuple(tb["images"].shape) == (n, img, img, 3)
        np.testing.assert_array_equal(tb["images"].numpy(),
                                      np.asarray(jb["images"]))
        np.testing.assert_array_equal(tb["labels"].numpy(),
                                      np.asarray(jb["labels"]))


@pytest.mark.parametrize("which", sorted(CFGS))
def test_layer_specs_and_oracle_match(which):
    """``layer_specs`` field by field, and ``policy_latency`` under the
    per-image context for the reference and three seeded policies."""
    import dataclasses
    args = CFGS[which]
    sj = JR.layer_specs(JR.ResNetConfig(**args))
    st = TR.layer_specs(TR.ResNetConfig(**args))
    assert [dataclasses.asdict(s) for s in st] == \
        [dataclasses.asdict(s) for s in sj]
    for pj, pt in _policies(sj, st, 4, seed=len(which)):
        lj = policy_latency(sj, pj, ctx=LatencyContext(**IMG_CTX))
        lt = tlat.policy_latency(st, pt, ctx=tlat.LatencyContext(**IMG_CTX))
        assert [u.name for u in lt.units] == [u.name for u in lj.units]
        np.testing.assert_allclose(lt.total_s, lj.total_s, rtol=1e-6)


def test_copied_configs_match():
    from benchmarks import common
    assert testbed.RESNET_CFG == TR.ResNetConfig(
        **{k: getattr(common.RESNET_CFG, k)
           for k in common.RESNET_CFG.__dataclass_fields__})
    assert testbed.IMG_CTX == tlat.LatencyContext(
        **{k: getattr(common.IMG_CTX, k)
           for k in common.IMG_CTX.__dataclass_fields__})
    specs = TR.layer_specs(testbed.RESNET18_CIFAR)
    assert len(specs) == 21 and sum(s.prunable for s in specs) == 8
    assert 11.1e6 < sum(s.weight_elems for s in specs) < 11.3e6
    macs = sum(s.flops_per_token for s in specs) / 2
    assert 0.55e9 < macs < 0.56e9


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding_exact(size):
    """XLA pads a 3x3 stride-2 SAME conv (0, 1) at an even size and (1, 1)
    at an odd one: the port's conv equals ``conv_general_dilated``
    exactly at both; ``padding=1`` at the even size does not."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 6)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = TR._conv({"w": torch.from_numpy(w)}, torch.from_numpy(x), 2)
    assert TR.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    np.testing.assert_array_equal(got.numpy(), want)
    naive = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                     padding=1).permute(0, 2, 3, 1).numpy()
    if size % 2 == 0:
        assert np.abs(naive - want).max() > 1.0
    else:
        np.testing.assert_allclose(naive, want, rtol=1e-5, atol=1e-5)
    assert TR.same_pads(size, 3, 1) == (1, 1)
    assert TR.same_pads(size, 1, 2) == (0, 0)


def test_forward_raw_matches_jax(tiny):
    jcm, tcm, jb, tb = tiny
    want = np.asarray(JR.forward(jcm.cfg, jcm.params, jb["images"]))
    got = TR.forward(tcm.cfg, tcm.params, tb["images"])
    assert tuple(got.shape) == (16, 4)
    assert _rel(got.numpy(), want) <= 1e-5


def test_resnet18_forward_raw_matches_jax():
    """ResNet18 at CIFAR-10 widths, batch 2, raw."""
    jcm, tcm = _pair(CFGS["resnet18"])
    jb, tb = _batch(10, 2, 32, seed=3)
    fwd = jax.jit(JR.forward, static_argnums=0)
    want = np.asarray(fwd(jcm.cfg, jcm.params, jb["images"]))
    got = TR.forward(tcm.cfg, tcm.params, tb["images"])
    assert tuple(got.shape) == (2, 10)
    assert _rel(got.numpy(), want) <= 1e-5


def test_forward_under_policy_matches_jax(tiny):
    """Three quantized and pruned policies: each conv, fed the same seeded
    input of its shape, within 1e-5 of the JAX conv under the same bits
    and mask; the whole forward's argmaxes and accuracy exact."""
    jcm, tcm, jb, tb = tiny
    convs = list(JR._iter_convs(jcm.cfg))
    rng = np.random.default_rng(4)
    quantized = masked = 0
    conv = jax.jit(JR._conv, static_argnums=2)
    logits = jax.jit(lambda cs: jcm.logits(jb, cs))
    for pj, pt in _policies(jcm.specs, tcm.specs, 3, seed=8, ref=False):
        cj, ct = jcm.build_cspec(pj), tcm.build_cspec(pt)
        for i, (name, _, _, _, stride, cin, _, _) in enumerate(convs):
            hw = int(round(np.sqrt(jcm.specs[i].extra["px"]))) * stride
            x = rng.standard_normal((4, hw, hw, cin)).astype(np.float32)
            want = np.asarray(conv({"w": jcm._conv_weight(i)},
                                   jnp.asarray(x), stride, cj[i]["qs"],
                                   cj[i]["mask"]))
            got = TR._conv({"w": tcm._conv_weight(i)}, torch.from_numpy(x),
                           stride, ct[i]["qs"], ct[i]["mask"])
            assert _rel(got.numpy(), want) <= 1e-5, name
            quantized += min(ct[i]["qs"].values()) < 32
            masked += ct[i]["mask"] is not None \
                and float(ct[i]["mask"].min()) == 0.0
        lj = np.asarray(logits(cj))
        lt = tcm.logits(tb, ct).numpy()
        np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))
        assert float(tcm.accuracy(tb, ct)) == float(jcm.accuracy(jb, cj))
    assert quantized and masked


def _tie_scores(jcm, tcm, conv_i):
    """Copy output channel 0 of a prunable conv's weight onto channel 1 in
    both adapters' params (tied ℓ1 scores); the adapters are rebuilt."""
    w = np.array(jcm._conv_weight(conv_i))
    w[..., 1] = w[..., 0]
    stage = jcm.params["stages"][0][0]
    params_j = {**jcm.params, "stages": [[{**stage, "conv1": {
        "w": jnp.asarray(w)}}] + jcm.params["stages"][0][1:]]
        + jcm.params["stages"][1:]}
    jcm2 = CompressibleResNet(jcm.cfg, params_j)
    tcm2 = tcompress.CompressibleResNet(tcm.cfg, convert.resnet_params(
        jax.device_get(params_j), device="cpu"))
    return jcm2, tcm2


def test_cspec_masks_and_accuracy_match_jax(tiny):
    """``build_cspec`` bits and masks equal the JAX adapter's (with tied
    ℓ1 scores in the first conv1: its output channels 0 and 1 equal), and
    the accuracy under each policy is exact."""
    jcm, tcm, jb, tb = tiny
    assert jcm.specs[1].name == "s0.b0.conv1" and jcm.specs[1].prunable
    jcm, tcm = _tie_scores(jcm, tcm, 1)
    sc = tcm._scores[1].numpy()
    assert sc[0] == sc[1]
    for pj, pt in _policies(jcm.specs, tcm.specs, 6, seed=3):
        cj, ct = jcm.build_cspec(pj), tcm.build_cspec(pt)
        assert len(cj) == len(ct) == len(jcm.specs)
        for ej, et in zip(cj, ct):
            assert et["qs"] == {k: int(v) for k, v in ej["qs"].items()}
            if ej["mask"] is None:
                assert et["mask"] is None
            else:
                np.testing.assert_array_equal(et["mask"].numpy(),
                                              np.asarray(ej["mask"]))
        assert float(tcm.accuracy(tb, ct)) == float(jcm.accuracy(jb, cj))
    # a keep that splits the tie keeps the lower channel, as JAX does
    pt = tpolicy.Policy.reference(tcm.specs)
    pj = Policy.reference(jcm.specs)
    sc_sorted = np.sort(sc)[::-1]
    keep = int(np.where(sc_sorted == sc[0])[0][0]) + 1
    pt.cmps[1].keep = pj.cmps[1].keep = keep
    mt = tcm.build_cspec(pt)[1]["mask"].numpy()
    np.testing.assert_array_equal(mt, np.asarray(jcm.build_cspec(pj)[1][
        "mask"]))
    assert mt[0] == 1.0 and mt[1] == 0.0


def test_sensitivity_matches_jax(tiny):
    """The port's per-probe analysis vs the JAX package's fused
    ``run_sensitivity``. Every weight and prune probe, and the stem's
    activation probes (its input, the images, is the same on both
    sides), ≤1e-6. The activation probes of the convs behind a GroupNorm
    within 1e-6 + 10% of the KL: their fake-quant input differs from
    XLA's in the last bits (GroupNorm's f32 sums and rsqrt round in
    other orders; the convs themselves are exact), and at 4 and 2 bits an
    element on a step boundary moves by a whole step (a 2-bit step is a
    third of the channel's range). Four seeds of this model put the
    worst of these at 6.4% of the KL."""
    jcm, tcm, jb, tb = tiny
    js = run_sensitivity(jcm, jb)
    ts = tsens.run_sensitivity(tcm, tb)
    assert set(ts.table) == set(js.table)
    behind_gn = 0
    for layer, row in js.table.items():
        assert set(ts.table[layer]) == set(row), layer
        for tag, kl in row.items():
            tol = 1e-6
            if tag.startswith("a") and layer not in ("stem", "head"):
                tol += 0.1 * kl
                behind_gn += 1
            assert abs(ts.table[layer][tag] - kl) <= tol, (layer, tag)
    assert behind_gn == 10


def test_accuracy_policy_batch_matches_jax_and_scalar(tiny):
    """The batched validation (grouped convs over the slots' channels, K1
    over the slots; tied ℓ1 scores in the first conv1) against the JAX
    ``accuracy_policy_batch`` and the port's scalar accuracy per policy:
    exact; ``stack_cspecs`` of the scalar cspecs gives the builder's
    cspec. Each slot's argmaxes equal its scalar forward's, and its
    logits are within 1e-3 of the largest: the grouped convs equal the
    per-slot convs bit for bit here, but the spatial mean (and GroupNorm)
    over the K slots' side-by-side channels sums in another order than
    over one slot's, and an element on a fake-quant step boundary then
    moves by a whole step (one int8 step of the head's input, 5.9e-4,
    for one of these policies)."""
    jcm, tcm, jb, tb = tiny
    jcm, tcm = _tie_scores(jcm, tcm, 1)
    pols = _policies(jcm.specs, tcm.specs, 6, seed=21)
    jpb = stack_policies(jcm.specs, [p for p, _ in pols])
    tpb = tpolicy.stack_policies(tcm.specs, [p for _, p in pols])
    want = np.asarray(jcm.accuracy_policy_batch(jb, jpb))
    got = tcm.accuracy_policy_batch(tb, tpb).numpy()
    scalar = [float(tcm.accuracy(tb, tcm.build_cspec(p))) for _, p in pols]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, scalar)
    assert len(set(got.tolist())) > 1
    built = tcm.cspec_builder()(tpb.keep, tpb.w_bits, tpb.a_bits)
    stacked = tcm.build_cspec_batch([p for _, p in pols])
    assert built["slots"] == stacked["slots"] == len(pols)
    for eb, es in zip(built["layers"], stacked["layers"]):
        assert eb["qs"] == es["qs"]
        assert (eb["mask"] is None) == (es["mask"] is None)
        if eb["mask"] is not None:
            assert torch.equal(eb["mask"], es["mask"])
    logits = tcm.logits(tb, built)
    assert tuple(logits.shape) == (len(pols), 16, 4)
    for k, (_, p) in enumerate(pols):
        one = tcm.logits(tb, tcm.build_cspec(p))
        assert torch.equal(logits[k].argmax(-1), one.argmax(-1)), k
        assert _rel(logits[k].numpy(), one.numpy()) <= 1e-3, k


@pytest.fixture(scope="module")
def searches(tiny):
    """The JAX pq ``CompressionSearch`` and the port's on the tiny ResNet
    under the per-image context, the port fed the JAX agent state, the
    JAX sensitivity table (the activation probes' KLs differ by the
    flips ``test_sensitivity_matches_jax`` bounds, and the agent's state
    standardization magnifies them) and the JAX replay indices."""
    jcm, tcm, jb, tb = tiny
    episodes, warmup, updates, batch = 6, 2, 2, 16
    ddpg = dict(warmup_episodes=warmup, updates_per_episode=updates,
                batch_size=batch, buffer_size=200, hidden=(32, 24))
    reward = dict(target_ratio=0.5, beta=-3.0)
    js = CompressionSearch(
        jcm, jb, SearchConfig(methods="pq", episodes=episodes, seed=0,
                              reward=RewardConfig(**reward),
                              ddpg=DDPGConfig(**ddpg)),
        LatencyContext(**IMG_CTX))
    ts = tsearch.CompressionSearch(
        tcm, tb, tsearch.SearchConfig(
            methods="pq", episodes=episodes, seed=0,
            reward=treward.RewardConfig(**reward),
            ddpg=tddpg.DDPGConfig(**ddpg)),
        tlat.LatencyContext(**IMG_CTX),
        sens=tsens.SensitivityResult(dict(js.sens.table)))
    ts.agent.state = convert.agent_state(jax.device_get(js.agent.state),
                                         device="cpu")
    fed = []
    j_chunk = js.agent.update_chunk

    def recording_chunk(replay, n):
        if n > 0 and len(replay) >= batch:
            _, keys = jddpg.chunk_sample_keys(js.agent.state.key, n)
            fed.append(np.stack([np.asarray(jax.random.randint(
                k, (batch,), 0, max(len(replay), 1))) for k in keys]))
        return j_chunk(replay, n)

    js.agent.update_chunk = recording_chunk
    jr = js.run()
    t_chunk = ts.agent.update_chunk

    def fed_chunk(replay, n):
        if n > 0 and len(replay) >= batch:
            return t_chunk(replay, n, indices=torch.as_tensor(fed.pop(0)))
        return t_chunk(replay, n)

    ts.agent.update_chunk = fed_chunk
    n_chunks = len(fed)
    tr = ts.run()
    assert n_chunks == episodes - warmup and not fed
    return jr, tr


def test_search_records_match_jax(searches):
    """CMPs and accuracy exact, latency ≤1e-6 relative, reward ≤1e-5,
    episode by episode."""
    jr, tr = searches
    assert tr.ref_accuracy == jr.ref_accuracy
    np.testing.assert_allclose(tr.ref_latency_s, jr.ref_latency_s,
                               rtol=1e-6)
    assert len(tr.history) == len(jr.history) == 6
    for j, t in zip(jr.history, tr.history):
        assert _cmps(t.policy) == _cmps(j.policy), f"episode {j.episode}"
        assert t.accuracy == j.accuracy, f"episode {j.episode}"
        np.testing.assert_allclose(t.latency_s, j.latency_s, rtol=1e-6)
        np.testing.assert_allclose(t.reward, j.reward, atol=1e-5)
        assert t.sigma == j.sigma
    assert len({tuple(_cmps(r.policy)) for r in tr.history}) > 1


def test_chip_smoke_resnet_phase_on_cpu():
    """``chip_smoke.py``'s ``[resnet path]`` functions at a small size on
    the CPU (the plain versions stand in for the kernels, so no launch
    is counted): the scalar and the batched search, their checks with
    the launch counts the card must show, the K1 site bookkeeping (each
    listed site is one call of the fake quant in a forward), and a wrong
    launch count refused."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.core.policy import Policy
    from repro_torch.kernels import ops
    cfg = TR.ResNetConfig(stages=(1, 1, 1), widths=(8, 16, 16),
                          img_size=8, num_classes=4)
    cm, val, scfg = chip_smoke.resnet_inputs(
        cfg, "cpu", episodes=3, warmup=2, updates=2, batch_size=16,
        val_batch=16)
    search, hist, _, _ = chip_smoke.run_search(
        cm, val, scfg, tlat.LatencyContext(**IMG_CTX), "cpu", episodes=3,
        verbose=False, reset_after_sensitivity=True)
    out = chip_smoke.check_resnet_main(search, hist, cfg, 3, "cpu")
    assert out["pairs"] > 0 and out["max_abs_err"] == 0.0
    assert chip_smoke.resnet_padded_convs(cfg) == 2

    # every listed site is one fake-quant call of the forward, in order
    seen = []
    real = ops.fused_fake_quant

    def recording(x, bits):
        seen.append((tuple(x.reshape(-1, x.shape[-1]).shape), bits))
        return real(x, bits)

    cs = chip_smoke.all_bits_cspec(cm)
    ops.fused_fake_quant = recording
    try:
        cm.logits(val, cs)
    finally:
        ops.fused_fake_quant = real
    calls = chip_smoke.resnet_k1_calls(cfg, cs, 16)
    assert sorted(seen) == sorted((shape, bits) for shape, bits, _ in calls)
    assert chip_smoke.resnet_k1_calls(
        cfg, cm.build_cspec(Policy.reference(cm.specs)), 16) == []
    # one copy per conv weight and per asymmetrically padded input, raw
    # and under a policy, and no other
    for c in (None, cs):
        p = chip_smoke.check_resnet_copies(cm, val, c, "cpu")
        assert sum(p["copies"].values()) == len(cm.specs) - 1 + 2

    bscfg = tsearch.SearchConfig(**{**scfg.__dict__, "episodes": 6})
    bsearch, bhist, _ = chip_smoke.run_batched_search(
        cm, val, bscfg, tlat.LatencyContext(**IMG_CTX), search.sens, "cpu",
        slots=4, verbose=False)
    cspecs = chip_smoke.batch_cspecs(bsearch, bhist)
    assert [c["slots"] for c in cspecs] == [4, 2]
    sites = sum(len(chip_smoke.resnet_k1_calls(cfg, c, 16)) for c in cspecs)
    assert sites > 0
    launches = {"fake_quant_slots": sites, "fake_quant": 0, "mlp3": 40,
                "polyak": 8}
    per_step = {"mlp3": 5.0, "polyak": 1.0}
    out = chip_smoke.check_resnet_batched(bsearch, bhist, cfg, 6, launches,
                                          per_step, "cpu")
    assert out["sites"] == sites and out["max_abs_err"] == 0.0
    with pytest.raises(AssertionError, match="fake_quant_slots"):
        chip_smoke.check_resnet_batched(
            bsearch, bhist, cfg, 6, {**launches, "fake_quant_slots": 1},
            per_step, "cpu")


def test_k1_reads_nhwc_and_hwio_in_place(monkeypatch):
    """A conv under a policy hands the fake quant's kernel wrapper its NHWC
    activation and its HWIO weight as they lie (the same storage: no copy
    before the launch), one tensor on the scalar forward, the slots'
    side-by-side channels and the shared weight over 4 slots on the
    batched one (``tests/test_torch_gpu.py`` holds the same on the
    card)."""
    from repro_torch.kernels import fake_quant as kfq
    seen = []
    for name in ("fake_quant_2d", "fake_quant_slots"):
        def record(x, *a, _real=getattr(kfq, name), **kw):
            seen.append(x.data_ptr())
            return _real(x, *a, **kw)
        monkeypatch.setattr(kfq, name, record)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((3, 3, 8, 16), generator=gen)
    x = torch.randn((2, 8, 8, 8), generator=gen)
    TR._conv({"w": w}, x, 2, {"w_bits": 4, "a_bits": 4})
    assert seen == [w.data_ptr(), x.data_ptr()]
    seen.clear()
    xb = torch.randn((2, 8, 8, 4 * 8), generator=gen)
    TR._conv({"w": w}, xb, 2, {"w_bits": (2, 4, 8, 32),
                               "a_bits": (3, 4, 6, 32)}, K=4)
    assert seen == [w.data_ptr(), xb.data_ptr()]
