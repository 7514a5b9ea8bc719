"""The port's Mamba-2 (SSD) serving path against the JAX package on the
same inputs (made with numpy from a seed) and weights (carried over with
``repro_torch.convert``): K8's plain versions (the sequential
``ref.ssd_scan_ref`` and the chunked ``ref.ssd_chunked_ref``), the op and
the model's ``blocks.ssd_chunked`` on CPU tensors, against the JAX
``ref.ssd_scan_ref``, the jnp ``blocks.ssd_chunked`` and the Pallas kernel
run in interpret mode (``ops.ssd_scan``, as ``tests/test_kernels.py``
runs it); the depthwise ``causal_conv1d``; ``apply_ssm``, the whole
forward, decode and the decode loop; the cspec; and a CPU rehearsal of
``chip_smoke.py``'s mamba2 phases.

Model: mamba2-780m at its SMOKE widths (2 layers, d 64, d_inner 128, 8
SSD heads of 16, state 16, chunk 32, vocab 256), and a copy at d 128 with
heads of 64 (4 heads, pruned in steps of 2) where pruning is the point.

Tolerances:
  * SSD scan: the JAX tests' 2e-4 (atol and rtol) on y and the final
    state, between every port version and every JAX one.
  * ``causal_conv1d``: exact (the same correctly rounded f32 products and
    sums in the same order, f32 or bf16 inputs).
  * f32 compute: ``apply_ssm`` ≤1e-5 and logits ≤1e-4 (prefill and
    decode; matmuls sum in other orders). Under a quantized, head-pruned
    cspec ``apply_ssm`` within 1e-5 on all but the elements a flipped
    fake-quant step moves (at most 1%), and the forward's accuracy equal,
    as in ``tests/test_torch_model.py``: the fake-quant floor turns
    last-bit range differences into whole steps.
  * bf16 compute: at most 3% of the next-token argmaxes flip.
  * decode against the port's own prefill: max |diff| / max |logit|
    < 1e-4 (the JAX package's ``test_decode_matches_prefill``); the
    decode loop's greedy tokens equal the JAX loop's.
  * cspec bits and masks: exact.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SSMConfig  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.policy import Policy, map_actions  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train.train_step import make_prefill_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import SSMConfig as TSSMConfig  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

ARCH = "mamba2-780m"
# The JAX tests' (B, S, H, P, N, chunk), and a ragged S.
SSD_SHAPES = [(2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
              (2, 96, 3, 8, 8, 32), (2, 100, 3, 16, 16, 32)]
# d 128 with SSD heads of 64: 4 heads, pruned in steps of 2.
WIDE = dict(d_model=128)


def _chip_smoke():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ssd_inputs(seed, B, S, H, P, N, max_decay=0.5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f32),
            -rng.uniform(0.0, max_decay, (B, S, H)).astype(f32),
            rng.standard_normal((B, S, N)).astype(f32),
            rng.standard_normal((B, S, N)).astype(f32))


def _pair(compute_dtype="float32", wide=False, seed=0):
    over = dict(compute_dtype=compute_dtype)
    jcfg = jreg.get_config(ARCH, smoke=True).replace(**over)
    tcfg = treg.get_config(ARCH, smoke=True).replace(**over)
    if wide:
        jcfg = jcfg.replace(**WIDE, ssm=SSMConfig(
            d_state=16, head_dim=64, expand=2, conv_width=4, chunk_size=32))
        tcfg = tcfg.replace(**WIDE, ssm=TSSMConfig(
            d_state=16, head_dim=64, expand=2, conv_width=4, chunk_size=32))
    params = JM.init(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.lm_params(tcfg, jax.device_get(params), device="cpu")
    return jcfg, params, tcfg, tparams


def _tokens(batch, seq, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq))


def _seeded_policies(specs_j, specs_t, seed):
    rng = np.random.default_rng(seed)
    pj, pt = Policy.reference(specs_j), tp.Policy.reference(specs_t)
    for i, (sj, st) in enumerate(zip(specs_j, specs_t)):
        a = rng.random(3).astype(np.float32)
        pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
            tp.map_actions(st, a, "pq")
    return pj, pt


# --------------------------------------------------------------------------
# K8's plain versions, the op and the model's chunked scan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_versions_match_jax(B, S, H, P, N, chunk):
    arrs = _ssd_inputs(S + H, B, S, H, P, N)
    ja = [jnp.asarray(a) for a in arrs]
    ta = [torch.from_numpy(a) for a in arrs]
    want = {"jax ref": jref.ssd_scan_ref(*ja),
            "jax chunked": JB.ssd_chunked(*ja, chunk),
            "jax pallas": jops.ssd_scan(*ja, chunk=chunk)}
    build.reset_launches()
    got = {"ref": tref.ssd_scan_ref(*ta),
           "chunked ref": tref.ssd_chunked_ref(*ta, chunk),
           "op": tops.ssd_scan(*ta, chunk=chunk),
           "model": TB.ssd_chunked(*ta, chunk)}
    assert build.LAUNCHES["ssd_scan"] == 0
    for gname, (gy, gf) in got.items():
        assert gy.shape == (B, S, H, P) and gf.shape == (B, H, P, N)
        for wname, (wy, wf) in want.items():
            np.testing.assert_allclose(gy.numpy(), np.asarray(wy),
                                       atol=2e-4, rtol=2e-4,
                                       err_msg=f"{gname} vs {wname}")
            np.testing.assert_allclose(gf.numpy(), np.asarray(wf),
                                       atol=2e-4, rtol=2e-4,
                                       err_msg=f"{gname} vs {wname}")


def test_ssd_chunked_from_an_initial_state_matches_jax():
    """The CPU branch carries a given initial state, as the jnp path does
    (on the card K8 refuses one: ``tests/test_torch_gpu.py``)."""
    arrs = _ssd_inputs(3, 2, 70, 3, 16, 8)
    s0 = np.random.default_rng(4).standard_normal((2, 3, 16, 8)).astype(
        np.float32)
    wy, wf = JB.ssd_chunked(*[jnp.asarray(a) for a in arrs], 32,
                            jnp.asarray(s0))
    gy, gf = TB.ssd_chunked(*[torch.from_numpy(a) for a in arrs], 32,
                            torch.from_numpy(s0))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=2e-4,
                               rtol=2e-4)


def test_segsum_matches_jax_and_never_exponentiates_upper_entries():
    a = -np.random.default_rng(5).uniform(0, 20, (3, 40)).astype(np.float32)
    want = np.asarray(JB._segsum(jnp.asarray(a)))
    got = tref.segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], atol=1e-4, rtol=0)
    assert np.all(np.exp(got) <= 1.0)


# --------------------------------------------------------------------------
# Depthwise causal conv
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_exact(dtype, with_state):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) / 4).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    js = jnp.asarray(st, jd) if with_state else None
    ts = torch.from_numpy(st).to(td) if with_state else None
    wy, wst = JL.causal_conv1d(jx, jnp.asarray(w), js)
    gy, gst = TL.causal_conv1d(tx, torch.from_numpy(w), ts)
    assert gy.dtype == td and gst.dtype == td and gst.shape == (2, 3, 24)
    np.testing.assert_array_equal(gy.float().numpy(),
                                  np.asarray(wy.astype(jnp.float32)))
    np.testing.assert_array_equal(gst.float().numpy(),
                                  np.asarray(wst.astype(jnp.float32)))


# --------------------------------------------------------------------------
# The SSM block and the model
# --------------------------------------------------------------------------

_japply_ssm = jax.jit(JB.apply_ssm, static_argnums=(2,))


def _block_input(cfg, seed=7, S=70):
    return np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)


def test_apply_ssm_matches_jax():
    jcfg, params, tcfg, tparams = _pair("float32")
    x = _block_input(jcfg)
    want = _japply_ssm(jax.tree.map(lambda a: a[0],
                                    params["blocks"]["ssm"]),
                       jnp.asarray(x), jcfg)
    got = TB.apply_ssm(tparams["blocks"][0]["ssm"], torch.from_numpy(x),
                       tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_apply_ssm_under_a_quantized_head_pruned_cspec():
    """8-bit input projection, 6/4-bit output projection, half the SSD
    heads pruned (the same ℓ1 head scores and keep mask on both sides)."""
    jcfg, params, tcfg, tparams = _pair("float32", wide=True)
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["ssm"])
    tp_ = tparams["blocks"][0]["ssm"]
    nheads = TB.ssm_dims(tcfg)[1]
    from repro.core import compress as jcompress
    from repro.core import pruning as jpr
    from repro_torch.core import pruning as tpr
    jsc = jcompress._unit_prune_scores(
        jcfg, {"ssm": jp}, "ssm_in")
    tsc = tcompress._unit_prune_scores(tcfg, {"ssm": tp_}, "ssm_in")
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
    jmask, tmask = jpr.keep_mask(jsc, nheads // 2), tpr.keep_mask(
        tsc, nheads // 2)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert float(tmask.sum()) == nheads // 2
    jcs = {"in": {"w_bits": jnp.int32(8), "a_bits": jnp.int32(8)},
           "out": {"w_bits": jnp.int32(4), "a_bits": jnp.int32(6)},
           "head_mask": jmask}
    tcs = {"in": {"w_bits": 8, "a_bits": 8},
           "out": {"w_bits": 4, "a_bits": 6}, "head_mask": tmask}
    x = _block_input(jcfg, seed=8)
    want = np.asarray(_japply_ssm(jp, jnp.asarray(x), jcfg, jcs))
    got = TB.apply_ssm(tp_, torch.from_numpy(x), tcfg, tcs).numpy()
    raw = TB.apply_ssm(tp_, torch.from_numpy(x), tcfg).numpy()
    assert np.abs(got - raw).max() > 0.01          # the cspec acts
    off = np.abs(got - want) > 1e-5
    assert off.mean() <= 0.01, f"{off.mean():.4f} of the outputs differ"


def test_forward_f32_logits_match():
    """The whole SMOKE forward at S 100 (three chunks of 32 and a ragged
    fourth)."""
    jcfg, params, tcfg, tparams = _pair("float32")
    toks = _tokens(2, 100, jcfg.vocab_size)
    want = np.asarray(jax.jit(make_prefill_step(jcfg))(params, toks))
    got = tstep.make_prefill_step(tcfg)(tparams, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_forward_bf16_argmax_flips_bounded():
    jcfg, params, tcfg, tparams = _pair("bfloat16")
    toks = _tokens(2, 300, jcfg.vocab_size, seed=1)
    want = np.asarray(jax.jit(make_prefill_step(jcfg))(params, toks))
    got = tstep.make_prefill_step(tcfg)(tparams, torch.from_numpy(toks))
    flips = int((want.argmax(-1) != got.numpy().argmax(-1)).sum())
    assert flips <= 0.03 * toks.size, f"{flips} of {toks.size} flip"


@pytest.mark.parametrize("seed", [5, 6])
def test_cspec_and_policy_forward_match(seed):
    """Seeded pq policies on the d-128 copy (SSD heads prunable in steps
    of 2): the CMPs, the cspec's bits and head masks equal the JAX
    package's, and the forward's next-token accuracy is equal."""
    jcfg, params, tcfg, tparams = _pair("float32", wide=True, seed=seed)
    cm = CompressibleLM(jcfg, params)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    pj, pt = _seeded_policies(cm.specs, tcm.specs, seed)
    assert [(c.keep, c.w_bits, c.a_bits) for c in pt.cmps] == \
        [(c.keep, c.w_bits, c.a_bits) for c in pj.cmps]
    jcs, tcs = cm.build_cspec(pj), tcm.build_cspec(pt)
    for i, tb in enumerate(tcs["blocks"]):
        jb = jax.tree.map(lambda a: np.asarray(a)[i], jcs["blocks"])
        assert set(tb) == set(jb) == {"ssm"}
        for unit in ("in", "out"):
            assert tb["ssm"][unit] == {k: int(v) for k, v in
                                       jb["ssm"][unit].items()}
        np.testing.assert_array_equal(tb["ssm"]["head_mask"].numpy(),
                                      jb["ssm"]["head_mask"])
    for key in ("embed_bits", "head_bits"):
        assert tcs.get(key) == (None if jcs.get(key) is None
                                else int(jcs[key]))
    toks = _tokens(2, 100, jcfg.vocab_size, seed=seed)
    want = np.asarray(jax.jit(make_prefill_step(jcfg, jcs))(params, toks))
    got = tstep.make_prefill_step(tcfg, tcs)(
        tparams, torch.from_numpy(toks)).numpy()

    def acc(lg):
        return float((lg[:, :-1].argmax(-1) == toks[:, 1:]).mean())
    assert acc(got) == acc(want)


def test_some_seeded_policy_prunes_ssd_heads():
    """The d-128 copy's ``ssm_in`` prunes heads under some seeded policy
    (the cspec tests above then hold a non-trivial mask)."""
    _, _, tcfg, tparams = _pair("float32", wide=True)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    nheads = TB.ssm_dims(tcfg)[1]
    kept = set()
    for seed in (5, 6):
        _, pt = _seeded_policies(tcm.specs, tcm.specs, seed)
        kept |= {c.keep for s, c in zip(tcm.specs, pt.cmps)
                 if s.kind == "ssm_in"}
    assert min(kept) < nheads


def test_convert_carries_the_raw_ssm_leaves():
    jcfg, params, tcfg, tparams = _pair("float32")
    assert "unembed" not in tparams
    for i, blk in enumerate(tparams["blocks"]):
        assert set(blk) == {"norm", "ssm"}
        for k, v in blk["ssm"].items():
            assert isinstance(v, torch.Tensor), k
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(params["blocks"]["ssm"][k][i]))


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def test_decode_step_logits_and_cache_match():
    """Eight steps from random tokens: logits ≤1e-4 every step, and the
    conv window and state the JAX cache's (≤1e-5)."""
    jcfg, params, tcfg, tparams = _pair("float32")
    B, steps = 3, 8
    jcache = JM.init_cache(jcfg, B, 16)
    tcache = TM.init_cache(tcfg, B, 16, device="cpu")
    toks = _tokens(B, steps, jcfg.vocab_size, seed=3)
    for pos in range(steps):
        want, jcache = JM.decode_step(jcfg, params, jcache,
                                      jnp.asarray(toks[:, pos:pos + 1]), pos)
        got, tcache = TM.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(toks[:, pos:pos + 1]),
                                     pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
    for i in range(tcfg.num_layers):
        for name in ("conv", "state"):
            np.testing.assert_allclose(tcache[i][name].numpy(),
                                       np.asarray(jcache[name][i]),
                                       atol=1e-5, rtol=1e-5)
    assert tcache[0]["state"].dtype == torch.float32


@pytest.mark.parametrize("cache_bits", [16, 8])
def test_decode_matches_prefill(cache_bits):
    """Token-by-token decode against one prefill forward over the same
    tokens (the JAX package's ``test_decode_matches_prefill``); the SSM
    cache ignores ``cache_bits``."""
    _, _, tcfg, tparams = _pair("float32", seed=1)
    B, S = 2, 40
    toks = torch.from_numpy(_tokens(B, S, tcfg.vocab_size, seed=2))
    full = TM.forward(tcfg, tparams, toks)
    cache = TM.init_cache(tcfg, B, S, cache_bits=cache_bits, device="cpu")
    assert cache[0]["conv"].dtype == torch.float32
    outs = []
    for t in range(S):
        lg, cache = TM.decode_step(tcfg, tparams, cache, toks[:, t:t + 1], t)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    rel = float((full - dec).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 1e-4


def test_decode_loop_tokens_match():
    jcfg, params, tcfg, tparams = _pair("float32")
    want, _ = jserve.decode_loop(jcfg, params, 2, 12, 32)
    got, dt = tserve.decode_loop(tcfg, tparams, 2, 12, 32)
    assert dt > 0 and got.shape == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_main_refuses_without_a_card():
    if not torch.cuda.is_available():
        assert tserve.main(["--arch", ARCH, "--smoke"]) == 2


# --------------------------------------------------------------------------
# chip_smoke.py's mamba2 phases, rehearsed on the CPU
# --------------------------------------------------------------------------

def test_chip_smoke_mamba2_phases_on_cpu():
    """``chip_smoke.py``'s K8 checks (small cases), mamba2 prefill and
    decode phases at the SMOKE widths on the CPU (the plain versions'
    rehearsal: nothing launches)."""
    chip_smoke = _chip_smoke()
    chip_smoke.check_ssd_scan("cpu", chip_smoke.SSD_CASES[:3]
                              + (((1, 300, 4, 16, 16), 64, 0.01),))
    cfg = treg.get_config(ARCH, smoke=True)
    cm = tcompress.CompressibleLM(cfg, TM.init(cfg, seed=0, device="cpu"))
    policy = chip_smoke.seeded_policy(cm, 0)
    cspec = cm.build_cspec(policy)
    build.reset_launches()
    pre = chip_smoke.run_prefill(cfg, cm.params, cspec, "cpu", 600, 128)
    assert set(pre) == {"uncompressed", "policy"}
    assert 0 < chip_smoke.oracle_prefill_ratio(cm, policy, 600) <= 1
    agree = chip_smoke.check_prefill_numerics(cfg, "cpu", 1100,
                                              min_agree=1.0)
    assert agree == {"uncompressed": 1.0, "policy": 1.0}
    dec = chip_smoke.run_decode(cfg, cm.params,
                                {"uncompressed": None, "policy": cspec},
                                batch=2, steps=4, max_len=8, requests=1,
                                cache_bits=(16,))
    assert sorted(dec) == ["policy/16", "uncompressed/16"]
    chip_smoke.check_decode_consistency(cfg, "cpu", steps=6)
    assert sum(build.LAUNCHES.values()) == 0
    assert chip_smoke.prefill_launches(
        treg.get_config(ARCH), None, 32768) == {
            "flash_attention": 0, "flash_attention_tc": 0, "ssd_scan": 48,
            "ssd_scan_tc": 48, "rglru_scan": 0, "fake_quant": 0}


def test_chip_smoke_checks_k8_on_the_paths_inputs(monkeypatch):
    """``chip_smoke.layer_ssd_inputs`` is exactly what layer 0 of the
    forward hands the chunked scan, and ``k1_calls`` lists exactly the
    K1 calls of a policy prefill and decode step (recorded at the plain
    versions on the CPU, SMOKE widths), in order."""
    chip_smoke = _chip_smoke()
    from repro_torch.kernels import fake_quant as tfq
    cfg = treg.get_config(ARCH, smoke=True)
    cm = tcompress.CompressibleLM(cfg, TM.init(cfg, seed=0, device="cpu"))
    cspec = cm.build_cspec(chip_smoke.seeded_policy(cm, 0))
    toks = chip_smoke.prefill_tokens(cfg, 2, 40, 0, "cpu")
    scans, calls = [], []
    plain_scan, plain_fq = TB.ssd_chunked, tfq.fake_quant_ref

    def record_scan(*args, **kw):
        scans.append(args[:4])
        return plain_scan(*args, **kw)

    def record_fq(x, bits):
        calls.append((tuple(x.shape), bits))
        return plain_fq(x, bits)

    monkeypatch.setattr(TB, "ssd_chunked", record_scan)
    monkeypatch.setattr(tfq, "fake_quant_ref", record_fq)
    tstep.make_prefill_step(cfg)(cm.params, toks)
    assert len(scans) == cfg.num_layers
    for got, want in zip(chip_smoke.layer_ssd_inputs(cfg, cm.params, toks),
                         scans[0]):
        assert torch.equal(got, want)
    calls.clear()
    tstep.make_prefill_step(cfg, cspec)(cm.params, toks)
    assert calls and calls == chip_smoke.k1_calls(cfg, cspec, 80)
    calls.clear()
    cache = TM.init_cache(cfg, 3, 8, device="cpu")
    tstep.make_serve_step(cfg, cspec=cspec)(cm.params, cache,
                                            toks[:1, :1].expand(3, 1), 0)
    assert calls == chip_smoke.k1_calls(cfg, cspec, 3)


def test_chip_smoke_ssd_work_counts_the_causal_products():
    chip_smoke = _chip_smoke()
    n_bytes, ops = chip_smoke.ssd_work(1, 32768, 48, 64, 128, 256)
    assert n_bytes == 4 * (2 * 32768 * 48 * 64 + 32768 * 48
                           + 2 * 32768 * 128 + 48 * 64 * 128)
    tri = 256 * 257 / 2
    assert ops == 128 * (2 * tri * 128 + 48 * (2 * tri * 64
                                                + 4 * 256 * 128 * 64))
    # a ragged last chunk counts its own rows only
    assert chip_smoke.ssd_work(1, 300, 1, 8, 8, 256)[1] == \
        chip_smoke.ssd_work(1, 256, 1, 8, 8, 256)[1] + \
        chip_smoke.ssd_work(1, 44, 1, 8, 8, 256)[1]


@pytest.mark.parametrize("max_decay", [0.01, 2.0])
def test_chip_smoke_k8_row_check_refuses_a_dropped_carry(max_decay):
    """``chip_smoke.py``'s per-row check of K8: the sequential and the
    chunked plain versions stay within ``K8_ROW_TOL`` of each other, and
    an output that drops the state carried into one chunk of the last
    quarter (that chunk's inter-chunk term) is refused, both at a slow
    decay and at a steep one, where the carried state matters only for
    the chunk's first rows."""
    chip_smoke = _chip_smoke()
    S, L = 1024, 64
    xh, dA, Bm, Cm = [torch.from_numpy(a)
                      for a in _ssd_inputs(9, 1, S, 4, 16, 16, max_decay)]
    y, _ = tref.ssd_chunked_ref(xh, dA, Bm, Cm, L)
    ys, _ = tref.ssd_scan_ref(xh, dA, Bm, Cm)
    assert chip_smoke.ssd_errors(y, ys)["row"] <= chip_smoke.K8_ROW_TOL
    c0 = (S // L) * 3 // 4 * L
    _, carried = tref.ssd_chunked_ref(xh[:, :c0], dA[:, :c0], Bm[:, :c0],
                                      Cm[:, :c0], L)
    acs = torch.cumsum(dA[:, c0:c0 + L], 1)
    faulty = y.clone()
    faulty[:, c0:c0 + L] -= torch.einsum("bln,bhpn,blh->blhp",
                                         Cm[:, c0:c0 + L], carried,
                                         torch.exp(acs))
    assert chip_smoke.ssd_errors(faulty, y)["row"] > \
        100 * chip_smoke.K8_ROW_TOL
