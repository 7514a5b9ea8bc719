"""The port's serving paths against the JAX package on the same weights
(carried over with ``repro_torch.convert``): the prefill forward at a
length that takes the chunked attention branch, single-token decode
against the KV cache (bf16/f32 and int8 storage, and the ring cache of a
sliding-window config), the greedy decode loop, the copied configs and
registry, and the useful-FLOPs counts.

Model: qwen2-0.5b at its SMOKE widths (2 layers, d 64, 4 heads over 2
KV heads of 16, qkv bias, tied embeddings, vocab 256), JAX weights from
``PRNGKey(0)``; tokens from ``np.random.default_rng``.

Tolerances:
  * f32 compute: logits ≤1e-4 (prefill and decode; matmuls sum in other
    orders). Under the seeded policy, accuracy equal (as in
    ``tests/test_torch_model.py``) on this test's draw: the fake-quant
    floor turns last-bit range differences into whole steps, so
    compressed logits are not held elementwise, and over many draws the
    accuracy is within one token, not equal
    (``tests/test_torch_flips.py`` states the bound).
  * bf16 compute: at most 3% of the next-token argmaxes flip (bf16
    rounds at other points in the two frameworks).
  * int8 KV cache: on the same K/V values, codes and scales exact
    against the JAX cache write run eagerly (under ``jit`` XLA takes
    ``x / 127`` as ``x * (1/127)``, one ulp off in some scales; the port
    keeps the correctly rounded quotient). Through the decode steps,
    where K/V come from matmuls summed in other orders, codes within one
    step and scales ≤1e-5 relative.
  * decode loop: the greedy tokens equal.
  * configs, registry and ``model_flops``: exact.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.policy import Policy, map_actions  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train.train_step import make_prefill_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import inputs as tinputs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

ARCH = "qwen2-0.5b"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pair(compute_dtype="float32", **over):
    jcfg = jreg.get_config(ARCH, smoke=True).replace(
        compute_dtype=compute_dtype, **over)
    tcfg = treg.get_config(ARCH, smoke=True).replace(
        compute_dtype=compute_dtype, **over)
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params(tcfg, jax.device_get(params), device="cpu")
    return jcfg, params, tcfg, tparams


def _tokens(batch, seq, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq))


def _seeded_policies(specs_j, specs_t, seed=5):
    """One legalized pq policy from seeded numpy actions, as a search
    episode maps them (``map_actions`` legalizes)."""
    rng = np.random.default_rng(seed)
    pj, pt = Policy.reference(specs_j), tp.Policy.reference(specs_t)
    for i, (sj, st) in enumerate(zip(specs_j, specs_t)):
        a = rng.random(3).astype(np.float32)
        pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
            tp.map_actions(st, a, "pq")
    return pj, pt


# --------------------------------------------------------------------------
# Prefill
# --------------------------------------------------------------------------

def test_prefill_f32_logits_match():
    jcfg, params, tcfg, tparams = _pair("float32")
    toks = _tokens(2, 1100, jcfg.vocab_size)
    want = np.asarray(jax.jit(make_prefill_step(jcfg))(params, toks))
    got = tstep.make_prefill_step(tcfg)(tparams, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_prefill_at_qwen2_head_shapes():
    """The full config's widths where they shape the attention (d 896,
    14 heads over 2 KV heads of 64, G = 7, qkv bias, tied unembedding),
    cut to one layer, d_ff 256 and a 1,024-token vocabulary: f32 logits
    ≤1e-4 at 600 tokens (the chunked branch)."""
    jcfg = jreg.get_config(ARCH).replace(num_layers=1, d_ff=256,
                                         vocab_size=1024,
                                         compute_dtype="float32")
    tcfg = treg.get_config(ARCH).replace(num_layers=1, d_ff=256,
                                         vocab_size=1024,
                                         compute_dtype="float32")
    params = JM.init(jcfg, jax.random.PRNGKey(1))
    tparams = convert.lm_params(tcfg, jax.device_get(params), device="cpu")
    assert "unembed" not in tparams and "b" in tparams["blocks"][0]["attn"][
        "wq"]
    toks = _tokens(1, 600, jcfg.vocab_size, seed=9)
    want = np.asarray(jax.jit(make_prefill_step(jcfg))(params, toks))
    got = tstep.make_prefill_step(tcfg)(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_prefill_bf16_argmax_flips_bounded():
    jcfg, params, tcfg, tparams = _pair("bfloat16")
    toks = _tokens(2, 1100, jcfg.vocab_size, seed=1)
    want = np.asarray(jax.jit(make_prefill_step(jcfg))(params, toks))
    got = tstep.make_prefill_step(tcfg)(tparams, torch.from_numpy(toks))
    flips = int((want.argmax(-1) != got.numpy().argmax(-1)).sum())
    assert flips <= 0.03 * toks.size, f"{flips} of {toks.size} flip"


def test_prefill_under_seeded_policy_accuracy_equal():
    jcfg, params, tcfg, tparams = _pair("float32")
    cm = CompressibleLM(jcfg, params)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    pj, pt = _seeded_policies(cm.specs, tcm.specs)
    assert [(c.keep, c.w_bits, c.a_bits) for c in pt.cmps] == \
        [(c.keep, c.w_bits, c.a_bits) for c in pj.cmps]
    assert any(c.w_bits < 32 for c in pt.cmps)
    toks = _tokens(2, 1100, jcfg.vocab_size, seed=2)
    want = np.asarray(jax.jit(make_prefill_step(
        jcfg, cm.build_cspec(pj)))(params, toks))
    got = tstep.make_prefill_step(tcfg, tcm.build_cspec(pt))(
        tparams, torch.from_numpy(toks)).numpy()

    def acc(lg):
        return float((lg[:, :-1].argmax(-1) == toks[:, 1:]).mean())
    assert acc(got) == acc(want)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def _jax_layer_cache(cache, i):
    return {k: np.asarray(v[i]) for k, v in cache.items()}


@pytest.mark.parametrize("cache_bits", [16, 8])
def test_decode_step_logits_and_cache_match(cache_bits):
    """Eight steps from random tokens; logits ≤1e-4 every step, and the
    cache JAX's (codes within one step, values and scales ≤1e-5)."""
    jcfg, params, tcfg, tparams = _pair("float32")
    B, W, steps = 3, 16, 8
    jcache = JM.init_cache(jcfg, B, W, cache_bits=cache_bits)
    tcache = TM.init_cache(tcfg, B, W, cache_bits=cache_bits, device="cpu")
    toks = _tokens(B, steps, jcfg.vocab_size, seed=3)
    with jax.disable_jit():
        for pos in range(steps):
            want, jcache = JM.decode_step(jcfg, params, jcache,
                                          jnp.asarray(toks[:, pos:pos + 1]),
                                          pos)
            got, tcache = TM.decode_step(
                tcfg, tparams, tcache, torch.from_numpy(toks[:, pos:pos + 1]),
                pos)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
    for i in range(tcfg.num_layers):
        want_c = _jax_layer_cache(jcache, i)
        for name, t in tcache[i].items():
            if t.dtype == torch.int8:
                # K/V reach the cache through f32 matmuls summed in other
                # orders, so a code may sit one step over
                diff = t.numpy().astype(np.int32) - want_c[name]
                assert np.abs(diff).max() <= 1, name
            else:
                np.testing.assert_allclose(t.numpy(), want_c[name],
                                           atol=1e-5, rtol=1e-5)
    if cache_bits == 8:
        assert tcache[0]["k"].dtype == torch.int8
        assert tcache[0]["k_s"].dtype == torch.float32


def test_int8_cache_write_codes_and_scales_exact():
    """The same K values (scales spread over four decades) written into
    slot 2 of an int8 cache: codes and scales equal the JAX write run
    eagerly, bit for bit; the other slots stay zero."""
    rng = np.random.default_rng(8)
    val = (rng.standard_normal((64, 1, 2, 64))
           * rng.uniform(0.01, 100.0, (64, 1, 2, 1))).astype(np.float32)
    val[0, 0, 0] = 0.0                  # an all-zero row: the 1e-8 floor
    jc = {"k": jnp.zeros((64, 4, 2, 64), jnp.int8),
          "k_s": jnp.zeros((64, 4, 2), jnp.float32)}
    want = JB._cache_write(jc, "k", jnp.asarray(val), 2)
    tc = {"k": torch.zeros((64, 4, 2, 64), dtype=torch.int8),
          "k_s": torch.zeros((64, 4, 2))}
    TB._cache_write(tc, "k", torch.from_numpy(val), 2)
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(tc["k_s"].numpy(),
                                  np.asarray(want["k_s"]))
    assert float(tc["k_s"][0, 2, 0]) == np.float32(1e-8)
    back = TB._cache_read(tc, "k", torch.float32)[:, 2:3]
    np.testing.assert_allclose(back.numpy(), val,
                               atol=float(np.abs(val).max()) / 127)


@pytest.mark.parametrize("cache_bits", [16, 8])
def test_decode_loop_tokens_match(cache_bits):
    """Greedy decode of 12 tokens from a zero prompt at batch 2: the
    port's ``decode_loop`` against the JAX loop (the JAX ``decode_loop``
    itself at 16-bit storage; its jitted serve step over an int8 cache
    at 8)."""
    jcfg, params, tcfg, tparams = _pair("float32")
    B, steps, max_len = 2, 12, 32
    if cache_bits == 16:
        want, _ = jserve.decode_loop(jcfg, params, B, steps, max_len)
    else:
        step = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t,
                                                           pos))
        cache = JM.init_cache(jcfg, B, max_len, cache_bits=8)
        toks = jnp.zeros((B, 1), jnp.int32)
        out = [toks]
        for pos in range(steps):
            logits, cache = step(params, cache, toks, pos)
            toks = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
            out.append(toks)
        want = jnp.concatenate(out, 1)
    got, dt = tserve.decode_loop(tcfg, tparams, B, steps, max_len,
                                 cache_bits=cache_bits)
    assert dt > 0 and got.shape == (B, steps + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_ring_cache_matches():
    """A sliding-window copy of the smoke config (window 5) decodes 9
    steps through a 5-slot ring: logits ≤1e-4 after the ring wraps."""
    jcfg, params, tcfg, tparams = _pair("float32", attention="sliding",
                                        window=5)
    B, max_len, steps = 2, 64, 9
    jcache = JM.init_cache(jcfg, B, max_len)
    tcache = TM.init_cache(tcfg, B, max_len, device="cpu")
    assert tcache[0]["k"].shape[1] == 5
    toks = _tokens(B, steps, jcfg.vocab_size, seed=4)
    for pos in range(steps):
        want, jcache = JM.decode_step(jcfg, params, jcache,
                                      jnp.asarray(toks[:, pos:pos + 1]), pos)
        got, tcache = TM.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(toks[:, pos:pos + 1]),
                                     pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)


def test_decode_attention_window_without_ring_matches():
    """``decode_attention`` with a window over a linear cache (the
    non-ring branch) against the JAX function."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
    for cache_len, window, ring in ((13, 4, False), (13, 0, False),
                                    (27, 0, True)):
        want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), cache_len,
                                   window=window, ring=ring)
        got = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc), cache_len,
                                  window=window, ring=ring)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


def test_decode_refuses_a_position_past_a_linear_cache():
    """JAX clamps the write slot silently; the port raises."""
    _, _, tcfg, tparams = _pair("float32")
    cache = TM.init_cache(tcfg, 1, 2, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    TM.decode_step(tcfg, tparams, cache, tok, 1)
    with pytest.raises(ValueError, match="past the cache"):
        TM.decode_step(tcfg, tparams, cache, tok, 2)


def test_sustained_throughput_and_serve_main_on_cpu():
    """``sustained_throughput`` runs its warm-up and requests on the
    params' device; ``main`` refuses to run without a card."""
    _, _, tcfg, tparams = _pair("float32")
    build.reset_launches()
    tok_s, times = tserve.sustained_throughput(tcfg, tparams, 2, 4, 8,
                                               requests=2, cache_bits=8)
    assert tok_s > 0 and len(times) == 2
    assert sum(build.LAUNCHES.values()) == 0
    if not torch.cuda.is_available():
        assert tserve.main(["--arch", ARCH, "--smoke"]) == 2


def test_unported_families_are_refused():
    """No family is refused any more: the MoE configs serve too (the
    last family's slice; ``tests/test_torch_moe.py`` holds them against
    JAX). Their greedy decode loop (f32, SMOKE, 16-bit and int8 KV
    caches) gives the tokens a prefill over the same tokens argmaxes:
    the cache path and the full-sequence path route each token to the
    same experts. Only the encoder's decode is refused (its own test,
    ``tests/test_torch_frontends.py``)."""
    for arch in ("mixtral-8x22b", "arctic-480b"):
        cfg = treg.get_config(arch, smoke=True).replace(
            compute_dtype="float32")
        params = TM.init(cfg, seed=1, device="cpu")
        for bits in (16, 8):
            toks, _ = tserve.decode_loop(cfg, params, 2, 12, 16,
                                         cache_bits=bits)
            with torch.no_grad():
                again = TM.forward(cfg, params, toks[:, :12]).argmax(-1)
            assert torch.equal(again, toks[:, 1:]), (arch, bits)


# --------------------------------------------------------------------------
# Configs, registry, FLOPs
# --------------------------------------------------------------------------

def test_registry_and_configs_match():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    for smoke in (False, True):
        tj, tt = jreg.all_configs(smoke), treg.all_configs(smoke)
        assert list(tt) == list(tj)
        for arch in tj:
            assert dataclasses.asdict(tt[arch]) == \
                dataclasses.asdict(tj[arch]), arch
            assert tt[arch].layer_kinds == tj[arch].layer_kinds
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True])
def test_model_flops_match(smoke):
    for arch in jreg.ARCH_IDS:
        jcfg, tcfg = jreg.get_config(arch, smoke), treg.get_config(arch,
                                                                   smoke)
        for js, ts in zip(jbase.ALL_SHAPES, tbase.ALL_SHAPES):
            assert ts == tbase.ShapeConfig(**dataclasses.asdict(js))
            assert tinputs.model_flops(tcfg, ts) == \
                jinputs.model_flops(jcfg, js), (arch, js.name)
        for ctx in (1, 4096):
            assert tinputs._fwd_flops_per_token_decode(tcfg, ctx) == \
                jinputs._fwd_flops_per_token_decode(jcfg, ctx)


def test_qwen2_prefill_attention_share():
    """The full config's prefill at 32,768 tokens: about 2.4 GFLOP per
    token, 59% of it attention (the 4·S·hd·H/2 term)."""
    cfg = treg.get_config(ARCH)
    shape = tbase.PREFILL_32K
    per_tok = tinputs.model_flops(cfg, shape) / (shape.global_batch
                                                 * shape.seq_len)
    attn = cfg.num_layers * 4.0 * shape.seq_len * cfg.head_dim \
        * cfg.num_heads * 0.5
    assert 2.3e9 < per_tok < 2.5e9
    assert 0.58 < attn / per_tok < 0.60
    specs = tcompress.lm_layer_specs(cfg)
    assert [s.kind for s in specs[:3]] == ["embed", "attn_qkv", "attn_out"]
    assert TB.ssm_dims(treg.get_config("mamba2-780m"))[1] > 0


def test_chip_smoke_prefill_and_decode_phases_on_cpu():
    """``chip_smoke.py``'s prefill and decode phases at the SMOKE widths
    on the CPU (the plain versions' rehearsal: nothing launches): the
    timed forwards, the device-vs-CPU numerics check, the oracle ratio,
    the decode variants and the decode/prefill consistency check."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = treg.get_config(ARCH, smoke=True)
    cm = tcompress.CompressibleLM(cfg, TM.init(cfg, seed=0, device="cpu"))
    policy = chip_smoke.seeded_policy(cm, 0)
    cspec = cm.build_cspec(policy)
    pre = chip_smoke.run_prefill(cfg, cm.params, cspec, "cpu", 600, 128)
    assert set(pre) == {"uncompressed", "policy"}
    assert pre["policy"]["seconds"] > 0
    assert 0 < chip_smoke.oracle_prefill_ratio(cm, policy, 600) <= 1
    agree = chip_smoke.check_prefill_numerics(cfg, "cpu", 600)
    assert agree == {"uncompressed": 1.0, "policy": 1.0}
    dec = chip_smoke.run_decode(cfg, cm.params,
                                {"uncompressed": None, "policy": cspec},
                                batch=2, steps=4, max_len=8, requests=1)
    assert sorted(dec) == ["policy/16", "policy/8", "uncompressed/16",
                           "uncompressed/8"]
    chip_smoke.check_decode_consistency(cfg, "cpu", steps=6)
    q, k, v = chip_smoke.layer_qkv(cfg, cm.params,
                                   chip_smoke.prefill_tokens(cfg, 1, 40, 0,
                                                             "cpu"))
    assert q.shape == (1, 40, 4, 16) and k.shape == v.shape == (1, 40, 2, 16)
    assert chip_smoke.attention_work(1, 14, 2, 32768, 64, 2) == (
        2 * (2 * 14 + 2 * 2) * 32768 * 64,
        4.0 * 14 * 64 * 32768 * 32769 / 2)


def test_chip_smoke_k1_calls_are_the_forwards(monkeypatch):
    """``chip_smoke.k1_calls`` — the (shape, bits) at which
    ``chip_smoke.py`` holds K1 against its plain version on the qwen2-0.5b
    path, and the launch count it demands there — lists exactly the calls
    a policy prefill and a policy decode step make (recorded at K1's plain
    version on the CPU, SMOKE widths), in order."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.kernels import fake_quant as tfq
    cfg = treg.get_config(ARCH, smoke=True)
    cm = tcompress.CompressibleLM(cfg, TM.init(cfg, seed=0, device="cpu"))
    cspec = cm.build_cspec(chip_smoke.seeded_policy(cm, 0))
    seen = []
    plain = tfq.fake_quant_ref

    def record(x, bits):
        seen.append((tuple(x.shape), bits))
        return plain(x, bits)

    monkeypatch.setattr(tfq, "fake_quant_ref", record)
    toks = chip_smoke.prefill_tokens(cfg, 2, 40, 0, "cpu")
    tstep.make_prefill_step(cfg, cspec)(cm.params, toks)
    assert seen == chip_smoke.k1_calls(cfg, cspec, 80)
    seen.clear()
    cache = TM.init_cache(cfg, 3, 8, device="cpu")
    tstep.make_serve_step(cfg, cspec=cspec)(cm.params, cache,
                                            toks[:1, :1].expand(3, 1), 0)
    assert seen == chip_smoke.k1_calls(cfg, cspec, 3)
    assert chip_smoke.k1_calls(cfg, None, 80) == []
    out = chip_smoke.check_fake_quant_path(cfg, cspec, (80, 3), "cpu")
    assert out["max_abs_err"] == 0.0 and out["pairs"] == len(
        set(chip_smoke.k1_calls(cfg, cspec, 80))
        | set(chip_smoke.k1_calls(cfg, cspec, 3)))
