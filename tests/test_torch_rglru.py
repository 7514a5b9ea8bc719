"""The port's RG-LRU (Griffin / RecurrentGemma) serving path against the
JAX package on the same inputs (made with numpy from a seed) and weights
(carried over with ``repro_torch.convert``): K7's plain version
(``ref.rglru_scan_ref``) and the op on CPU tensors against the JAX
``ref.rglru_scan_ref`` and the Pallas kernel run in interpret mode
(``ops.rglru_scan``, as ``tests/test_kernels.py`` runs it); the gates;
``apply_rglru``; the whole forward, decode and the decode loop of
recurrentgemma-2b (RG-LRU layers beside local attention with a ring KV
cache); the cspec; and a CPU rehearsal of ``chip_smoke.py``'s
recurrentgemma phases and its K7 and K6 checks.

Model: recurrentgemma-2b at its SMOKE widths (3 layers: rglru, rglru,
attn; d 64, lru_width 64, 4 / 1 heads of 16, window 16, d_ff 128, vocab
256), and a copy with lru_width and d_ff 256 where pruning is the point
(both prune in steps of 128).

Tolerances:
  * RG-LRU scan: the port's sequential plain version against the JAX
    one ≤1e-6 (the same multiply and add per step); the op against the
    Pallas kernel at the JAX tests' atol 2e-5.
  * gates: ≤1e-6.
  * ``apply_rglru`` in f32: each (token) row within 1e-5 relative. The
    JAX model scans with ``associative_scan``, the port with the
    sequential walk: the sums run in other orders (≤8e-7 row relative at
    S 600, C 64 in a CPU emulation; ≤2.3e-6 at S 32,768). Under a
    quantized, width-pruned cspec within 1e-5 on all but the elements a
    flipped fake-quant step moves (at most 1%).
  * f32 forward: logits ≤1e-4 (as ``tests/test_torch_model.py`` and
    ``test_torch_ssm.py``); under seeded policies the next-token accuracy
    equal on this test's draws (seeds 5 and 6). Over many draws up to
    ~3% of the argmaxes flip and the accuracy is within one token
    (``tests/test_torch_flips.py`` states the bound).
  * bf16 compute: at most 3% of the next-token argmaxes flip.
  * decode: logits ≤1e-4 and caches ≤1e-5 against JAX every step, past
    the window (the ring wraps); against the port's own prefill max
    |diff| / max |logit| < 1e-4; the decode loop's greedy tokens equal
    JAX's.
  * cspec bits and masks: exact.
"""
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compress as jcompress  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.policy import Policy, map_actions  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train.train_step import make_prefill_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.core import pruning as tpr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

ARCH = "recurrentgemma-2b"
# The JAX tests' (B, S, C) and their a ranges.
LRU_SHAPES = [(2, 64, 96), (1, 128, 32), (3, 48, 256)]
# lru_width and d_ff 256: the LRU width and the MLP prune in steps of 128.
WIDE = dict(lru_width=256, d_ff=256)


def _chip_smoke():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def _pair(compute_dtype="float32", wide=False, seed=0):
    over = dict(compute_dtype=compute_dtype, **(WIDE if wide else {}))
    jcfg = jreg.get_config(ARCH, smoke=True).replace(**over)
    tcfg = treg.get_config(ARCH, smoke=True).replace(**over)
    params = JM.init(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.lm_params(tcfg, jax.device_get(params), device="cpu")
    return jcfg, params, tcfg, tparams


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    """The JAX prefill with the cspec as an argument: one compilation
    serves every policy (bits and masks are traced values)."""
    return jax.jit(lambda p, t, cs: make_prefill_step(jcfg, cs)(p, t))


def _tokens(batch, seq, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq))


def _lru_inputs(seed, B, S, C, lo=0.4, hi=0.99):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (B, S, C)).astype(np.float32),
            rng.standard_normal((B, S, C)).astype(np.float32))


def _seeded_policies(specs_j, specs_t, seed):
    rng = np.random.default_rng(seed)
    pj, pt = Policy.reference(specs_j), tp.Policy.reference(specs_t)
    for i, (sj, st) in enumerate(zip(specs_j, specs_t)):
        a = rng.random(3).astype(np.float32)
        pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
            tp.map_actions(st, a, "pq")
    return pj, pt


def _row_rel(got, want):
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


# --------------------------------------------------------------------------
# K7's plain version and the op
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,C", LRU_SHAPES + [(2, 32, 64)])
def test_rglru_scan_ref_and_op_match_jax(B, S, C):
    """The JAX tests' shapes (a in [0.4, 0.99]) and their h0 case (2, 32,
    64; a in [0.5, 0.95])."""
    with_h0 = (B, S, C) == (2, 32, 64)
    a, b = _lru_inputs(S + C, B, S, C, *((0.5, 0.95) if with_h0
                                         else (0.4, 0.99)))
    h0 = np.random.default_rng(1).standard_normal((B, C)).astype(
        np.float32) if with_h0 else None
    ja = [None if t is None else jnp.asarray(t) for t in (a, b, h0)]
    ta = [None if t is None else torch.from_numpy(t) for t in (a, b, h0)]
    want = np.asarray(jref.rglru_scan_ref(*ja))
    build.reset_launches()
    got = tref.rglru_scan_ref(*ta)
    op = tops.rglru_scan(*ta)
    assert build.LAUNCHES["rglru_scan"] == 0
    assert got.shape == (B, S, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert torch.equal(op, got)
    np.testing.assert_allclose(op.numpy(), np.asarray(jops.rglru_scan(*ja)),
                               atol=2e-5, rtol=0)


def test_rglru_scan_ref_keeps_bf16():
    a, b = _lru_inputs(3, 1, 20, 16)
    ta, tb = (torch.from_numpy(t).bfloat16() for t in (a, b))
    got = tref.rglru_scan_ref(ta, tb)
    assert got.dtype == torch.bfloat16
    want = jref.rglru_scan_ref(jnp.asarray(a, jnp.bfloat16),
                               jnp.asarray(b, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# --------------------------------------------------------------------------
# The RG-LRU block
# --------------------------------------------------------------------------

def _block_input(cfg, seed=7, S=70):
    return np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)


def test_rglru_gates_match_jax():
    jcfg, params, tcfg, tparams = _pair()
    p = params["blocks"][0]["rglru"]
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 30, jcfg.lru_width)).astype(np.float32)
    # non-zero gate weights, so that r and i vary per channel and token
    gates = {k: rng.standard_normal(jcfg.lru_width).astype(np.float32)
             for k in ("w_a", "b_a", "w_i", "b_i")}
    jp = dict(p, **{k: jnp.asarray(v) for k, v in gates.items()})
    tp_ = dict(tparams["blocks"][0]["rglru"],
               **{k: torch.from_numpy(v) for k, v in gates.items()})
    for jpp, tpp in ((p, tparams["blocks"][0]["rglru"]), (jp, tp_)):
        wa, wb = JB._rglru_gates(jpp, jnp.asarray(u))
        ga, gb = TB._rglru_gates(tpp, torch.from_numpy(u))
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-6,
                                   rtol=0)
    a0 = np.asarray(wa)
    assert 0.4 < a0.min() and a0.max() < 1.0


def test_apply_rglru_matches_jax():
    jcfg, params, tcfg, tparams = _pair()
    x = _block_input(jcfg, S=600)
    want = np.asarray(jax.jit(JB.apply_rglru, static_argnums=(2,))(
        params["blocks"][0]["rglru"], jnp.asarray(x), jcfg))
    got = TB.apply_rglru(tparams["blocks"][0]["rglru"], torch.from_numpy(x),
                         tcfg).numpy()
    assert _row_rel(got, want) <= 1e-5


def test_rglru_inputs_are_what_the_scan_gets():
    """``blocks.rglru_inputs`` returns exactly the (a, b) of the JAX gates
    on the JAX conv output, and the gate branch y."""
    jcfg, params, tcfg, tparams = _pair()
    x = _block_input(jcfg, seed=9, S=40)
    jp = params["blocks"][0]["rglru"]
    xj = jnp.asarray(x)
    u, _ = JB.L.causal_conv1d(jnp.einsum("bsd,dw->bsw", xj, jp["w_x"]),
                              jp["conv_w"])
    wa, wb = JB._rglru_gates(jp, u)
    wy = jax.nn.gelu(jnp.einsum("bsd,dw->bsw", xj, jp["w_y"]))
    (a, b), (y, conv) = TB.rglru_inputs(tparams["blocks"][0]["rglru"],
                                        torch.from_numpy(x), tcfg, None)
    for g, w in ((a, wa), (b, wb), (y, wy)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    u_in = torch.einsum("bsd,dw->bsw", torch.from_numpy(x),
                        tparams["blocks"][0]["rglru"]["w_x"])
    assert torch.equal(conv, u_in[:, -3:])        # the last 3 conv inputs


def test_apply_rglru_under_a_quantized_width_pruned_cspec():
    """8-bit input projections, 6/4-bit output projection, half the LRU
    width pruned (the same ℓ1 scores over w_x and w_y and keep mask on
    both sides)."""
    jcfg, params, tcfg, tparams = _pair(wide=True)
    jp, tp_ = params["blocks"][0]["rglru"], tparams["blocks"][0]["rglru"]
    w = tcfg.lru_width
    jsc = jcompress._unit_prune_scores(jcfg, {"rglru": jp}, "rglru_in")
    tsc = tcompress._unit_prune_scores(tcfg, {"rglru": tp_}, "rglru_in")
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6)
    jmask, tmask = jpr.keep_mask(jsc, w // 2), tpr.keep_mask(tsc, w // 2)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert float(tmask.sum()) == w // 2
    jcs = {"in": {"w_bits": jnp.int32(8), "a_bits": jnp.int32(8)},
           "out": {"w_bits": jnp.int32(4), "a_bits": jnp.int32(6)},
           "width_mask": jmask}
    tcs = {"in": {"w_bits": 8, "a_bits": 8},
           "out": {"w_bits": 4, "a_bits": 6}, "width_mask": tmask}
    x = _block_input(jcfg, seed=8)
    want = np.asarray(jax.jit(JB.apply_rglru, static_argnums=(2,))(
        jp, jnp.asarray(x), jcfg, jcs))
    got = TB.apply_rglru(tp_, torch.from_numpy(x), tcfg, tcs).numpy()
    raw = TB.apply_rglru(tp_, torch.from_numpy(x), tcfg).numpy()
    assert np.abs(got - raw).max() > 0.01          # the cspec acts
    off = np.abs(got - want) > 1e-5
    assert off.mean() <= 0.01, f"{off.mean():.4f} of the outputs differ"


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [100, 600])
def test_forward_f32_logits_match(S):
    """The whole SMOKE forward: S 100 takes the dense attention branch,
    S 600 the chunked one (window 16 on both)."""
    jcfg, params, tcfg, tparams = _pair()
    toks = _tokens(2, S, jcfg.vocab_size)
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
    """Seeded pq policies on the wide copy: the CMPs, the cspec's bits
    and masks equal the JAX package's, and the forward's next-token
    accuracy is equal."""
    jcfg, params, tcfg, tparams = _pair(wide=True)
    cm = CompressibleLM(jcfg, params)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    pj, pt = _seeded_policies(cm.specs, tcm.specs, seed)
    assert [(c.keep, c.w_bits, c.a_bits) for c in pt.cmps] == \
        [(c.keep, c.w_bits, c.a_bits) for c in pj.cmps]
    jcs, tcs = cm.build_cspec(pj), tcm.build_cspec(pt)
    masks = {"attn": "head_mask", "mlp": "ff_mask", "rglru": "width_mask"}
    for kind, tb, jb in zip(tcfg.layer_kinds, tcs["blocks"], jcs["blocks"]):
        assert set(tb) == set(jb) == ({"attn", "mlp"} if kind == "attn"
                                      else {"rglru", "mlp"})
        for part in tb:
            units = ("qkv", "o") if part == "attn" else (
                ("up", "down") if part == "mlp" else ("in", "out"))
            for unit in units:
                assert tb[part][unit] == {k: int(v) for k, v in
                                          jb[part][unit].items()}
            np.testing.assert_array_equal(tb[part][masks[part]].numpy(),
                                          np.asarray(jb[part][masks[part]]))
    for key in ("embed_bits", "head_bits"):
        assert tcs.get(key) == (None if jcs.get(key) is None
                                else int(jcs[key]))
    toks = _tokens(2, 100, jcfg.vocab_size, seed=seed)
    want = np.asarray(_jax_forward(jcfg)(params, toks, jcs))
    got = tstep.make_prefill_step(tcfg, tcs)(
        tparams, torch.from_numpy(toks)).numpy()

    def acc(lg):
        return float((lg[:, :-1].argmax(-1) == toks[:, 1:]).mean())
    assert acc(got) == acc(want)


def test_some_seeded_policy_prunes_the_lru_width():
    """The wide copy's ``rglru_in`` prunes under a seeded policy of the
    cspec test above, so it holds a non-trivial width mask."""
    _, _, tcfg, tparams = _pair(wide=True)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    kept = set()
    for seed in (5, 6):
        _, pt = _seeded_policies(tcm.specs, tcm.specs, seed)
        kept |= {c.keep for s, c in zip(tcm.specs, pt.cmps)
                 if s.kind == "rglru_in"}
        cs = tcm.build_cspec(pt)
        assert all(float(b["rglru"]["width_mask"].sum()) == c.keep
                   for b, c in zip(
                       [b for b, k in zip(cs["blocks"], tcfg.layer_kinds)
                        if k == "rglru"],
                       [c for s, c in zip(tcm.specs, pt.cmps)
                        if s.kind == "rglru_in"]))
    assert min(kept) < tcfg.lru_width


def test_convert_carries_the_rglru_leaves():
    jcfg, params, tcfg, tparams = _pair()
    assert "unembed" not in tparams
    for kind, jb, tb in zip(tcfg.layer_kinds, params["blocks"],
                            tparams["blocks"]):
        if kind != "rglru":
            assert set(tb) == {"attn_norm", "attn", "mlp_norm", "mlp"}
            continue
        assert set(tb) == {"mix_norm", "rglru", "mlp_norm", "mlp"}
        assert set(tb["rglru"]) == set(jb["rglru"])
        for k, v in tb["rglru"].items():
            assert isinstance(v, torch.Tensor), k
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jb["rglru"][k]))


def test_model_refuses_moe_and_frontends_only():
    """The MoE family and the stub frontends are ported: their SMOKE
    configs init (an MoE layer's ``moe`` block, no ``embed`` for the
    audio encoder). What is still refused is decode for the encoder
    (hubert-xlarge has no decode step): ``init_cache`` and serving's
    ``decode_loop`` raise; a decoder's cache is made as before."""
    for arch in ("mixtral-8x22b", "hubert-xlarge", "internvl2-2b"):
        cfg = treg.get_config(arch, smoke=True)
        params = TM.init(cfg, device="cpu")
        assert len(params["blocks"]) == cfg.num_layers
        assert ("moe" in params["blocks"][0]) == (cfg.moe is not None)
        assert ("embed" in params) == (cfg.frontend != "audio_stub")
    hubert = treg.get_config("hubert-xlarge", smoke=True)
    with pytest.raises(ValueError, match="encoder"):
        TM.init_cache(hubert, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        tserve.decode_loop(hubert, TM.init(hubert, device="cpu"), 1, 2, 8)
    cfg = treg.get_config(ARCH, smoke=True)
    assert len(TM.init_cache(cfg, 1, 8, device="cpu")) == cfg.num_layers


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def test_decode_step_logits_and_cache_match():
    """20 steps from random tokens (past the window of 16: the attention
    layer's ring wraps): logits ≤1e-4 every step, and the RG-LRU state,
    conv window and ring KV cache the JAX cache's (≤1e-5)."""
    jcfg, params, tcfg, tparams = _pair()
    B, steps = 3, 20
    jstep = jax.jit(functools.partial(JM.decode_step, jcfg))
    jcache = JM.init_cache(jcfg, B, 32)
    tcache = TM.init_cache(tcfg, B, 32, device="cpu")
    toks = _tokens(B, steps, jcfg.vocab_size, seed=3)
    for pos in range(steps):
        want, jcache = jstep(params, jcache,
                             jnp.asarray(toks[:, pos:pos + 1]), pos)
        got, tcache = TM.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(toks[:, pos:pos + 1]),
                                     pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
    for kind, jc, tc in zip(tcfg.layer_kinds, jcache, tcache):
        assert set(tc) == set(jc)
        for name in tc:
            np.testing.assert_allclose(tc[name].float().numpy(),
                                       np.asarray(jc[name], np.float32),
                                       atol=1e-5, rtol=1e-5)
        if kind == "rglru":
            assert tc["state"].dtype == torch.float32
        else:
            assert tc["k"].shape[1] == tcfg.window


def test_decode_matches_prefill_past_the_window():
    """Token-by-token decode against one prefill forward over the same
    40 tokens (the JAX package's ``test_decode_matches_prefill``), past
    the SMOKE window of 16, with the 16-bit cache."""
    _, _, tcfg, tparams = _pair(seed=1)
    B, S = 2, 40
    toks = torch.from_numpy(_tokens(B, S, tcfg.vocab_size, seed=2))
    full = TM.forward(tcfg, tparams, toks)
    cache = TM.init_cache(tcfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = TM.decode_step(tcfg, tparams, cache, toks[:, t:t + 1], t)
        outs.append(lg)
    dec = torch.cat(outs, 1)
    rel = float((full - dec).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 1e-4


def test_decode_loop_tokens_match():
    jcfg, params, tcfg, tparams = _pair()
    want, _ = jserve.decode_loop(jcfg, params, 2, 20, 32)
    got, dt = tserve.decode_loop(tcfg, tparams, 2, 20, 32)
    assert dt > 0 and got.shape == (2, 21)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# chip_smoke.py's recurrentgemma phases and K7 / K6 checks, on the CPU
# --------------------------------------------------------------------------

def test_chip_smoke_recurrentgemma_phases_on_cpu():
    """``chip_smoke.py``'s K7 and D 256 K6 checks (small cases), the
    recurrentgemma prefill and decode phases at the SMOKE widths on the
    CPU (the plain versions' rehearsal: nothing launches)."""
    chip_smoke = _chip_smoke()
    chip_smoke.check_rglru_scan("cpu", chip_smoke.RGLRU_CASES[:4]
                                + (((1, 300, 300), "path", False),))
    chip_smoke.check_flash_attention(
        "cpu", (((1, 70, 2, 1, 256), "float32", 2e-5,
                 ((True, 0), (True, 16))),))
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
                                batch=2, steps=4, max_len=8, requests=1)
    assert sorted(dec) == ["policy/16", "policy/8", "uncompressed/16",
                           "uncompressed/8"]
    chip_smoke.check_decode_consistency(cfg, "cpu", steps=24)
    assert sum(build.LAUNCHES.values()) == 0
    assert chip_smoke.prefill_launches(treg.get_config(ARCH), None,
                                       32768) == {
        "flash_attention": 8, "flash_attention_tc": 8, "ssd_scan": 0,
        "ssd_scan_tc": 0, "rglru_scan": 18, "fake_quant": 0}


def test_chip_smoke_checks_k7_and_k6_on_the_paths_inputs(monkeypatch):
    """``chip_smoke.layer_rglru_inputs`` and ``layer_qkv`` are exactly
    what layer 0's scan and layer 2's attention receive in the forward,
    and ``k1_calls`` lists exactly the K1 calls of a policy prefill and
    decode step (recorded at the plain versions on the CPU, SMOKE
    widths), in order."""
    chip_smoke = _chip_smoke()
    from repro_torch.kernels import fake_quant as tfq
    from repro_torch.models import layers as TL
    cfg = treg.get_config(ARCH, smoke=True)
    cm = tcompress.CompressibleLM(cfg, TM.init(cfg, seed=0, device="cpu"))
    cspec = cm.build_cspec(chip_smoke.seeded_policy(cm, 0))
    toks = chip_smoke.prefill_tokens(cfg, 2, 40, 0, "cpu")
    scans, attns, calls = [], [], []
    plain_scan, plain_attn = tops.rglru_scan, TL.attention
    plain_fq = tfq.fake_quant_ref

    def record_scan(*args):
        scans.append(args)
        return plain_scan(*args)

    def record_attn(q, k, v, **kw):
        attns.append(((q, k, v), kw))
        return plain_attn(q, k, v, **kw)

    def record_fq(x, bits):
        calls.append((tuple(x.shape), bits))
        return plain_fq(x, bits)

    monkeypatch.setattr(tops, "rglru_scan", record_scan)
    monkeypatch.setattr(TL, "attention", record_attn)
    monkeypatch.setattr(tfq, "fake_quant_ref", record_fq)
    tstep.make_prefill_step(cfg)(cm.params, toks)
    assert len(scans) == 2 and len(attns) == 1
    assert attns[0][1]["window"] == cfg.window
    for got, want in zip(chip_smoke.layer_rglru_inputs(cfg, cm.params, toks),
                         scans[0]):
        assert torch.equal(got, want)
    for got, want in zip(chip_smoke.layer_qkv(cfg, cm.params, toks),
                         attns[0][0]):
        assert torch.equal(got, want)
    calls.clear()
    tstep.make_prefill_step(cfg, cspec)(cm.params, toks)
    assert calls and calls == chip_smoke.k1_calls(cfg, cspec, 80)
    assert ((80, cfg.d_model), cspec["blocks"][0]["rglru"]["in"]["a_bits"]) \
        in calls or cspec["blocks"][0]["rglru"]["in"]["a_bits"] >= 32
    calls.clear()
    cache = TM.init_cache(cfg, 3, 8, device="cpu")
    tstep.make_serve_step(cfg, cspec=cspec)(cm.params, cache,
                                            toks[:1, :1].expand(3, 1), 0)
    assert calls == chip_smoke.k1_calls(cfg, cspec, 3)


def test_chip_smoke_k7_wave_and_back_to_back_checks_on_cpu():
    """``chip_smoke.py``'s many-wave and back-to-back K7 checks at small
    shapes on the CPU (the plain versions' rehearsal: nothing launches),
    and the C off 16 bytes among its cases."""
    chip_smoke = _chip_smoke()
    build.reset_launches()
    chip_smoke.check_rglru_waves("cpu", (1, 600, 64), 8)
    chip_smoke.check_rglru_back_to_back("cpu", (1, 300, 64))
    assert ((2, 200, 99), (0.4, 0.99), False) in chip_smoke.RGLRU_CASES
    chip_smoke.check_rglru_scan("cpu", (((2, 200, 99), (0.4, 0.99),
                                         False),))
    assert chip_smoke.RGLRU_WAVES == ((1, 65536, 256), 16)
    assert sum(build.LAUNCHES.values()) == 0


def _two_pass(a, b, L, drop=None):
    """The two-pass chunked order of K7 on the CPU, f32: chunk-local
    walks from zero (end state and product of a), the carry pass, then
    each chunk walked again from its entering state; ``drop``: a chunk
    whose entering state is taken as zero (a dropped carry)."""
    B, S, C = a.shape
    nc = -(-S // L)
    ends, prods = [], []
    for k in range(nc):
        h, p = torch.zeros((B, C)), torch.ones((B, C))
        for t in range(k * L, min(S, (k + 1) * L)):
            h = a[:, t] * h + b[:, t]
            p = p * a[:, t]
        ends.append(h)
        prods.append(p)
    out, carry = torch.empty_like(a), torch.zeros((B, C))
    for k in range(nc):
        x = torch.zeros((B, C)) if k == drop else carry
        carry = prods[k] * carry + ends[k]
        for t in range(k * L, min(S, (k + 1) * L)):
            x = a[:, t] * x + b[:, t]
            out[:, t] = x
    return out


def test_chip_smoke_k7_row_check_refuses_a_dropped_carry():
    """``chip_smoke.py``'s per-row check of K7 at the path's slow decays
    (a = sqrt(linspace(0.9, 0.999)), b = sqrt(1 - a^2) 0.5 u): the
    two-pass order stays within ``K7_ROW_TOL`` of the sequential plain
    version, and the same order with the carry into one chunk of the
    last quarter dropped is refused by far."""
    chip_smoke = _chip_smoke()
    S, C, L = 2048, 256, 128
    a, b, _ = chip_smoke.lru_case(0, 1, S, C, "path", "cpu")
    want = tref.rglru_scan_ref(a, b)
    honest = chip_smoke.rglru_errors(_two_pass(a, b, L), want)
    assert honest["row"] <= chip_smoke.K7_ROW_TOL / 100
    drop = (S // L) * 3 // 4
    faulty = chip_smoke.rglru_errors(_two_pass(a, b, L, drop), want)
    assert faulty["row"] > 100 * chip_smoke.K7_ROW_TOL
    assert faulty["row_at"][1] // L == drop


@pytest.mark.parametrize("S,window", [(37, 0), (37, 5), (64, 16),
                                      (20, 64)])
def test_chip_smoke_attention_work_counts_the_kept_pairs(S, window):
    """``chip_smoke.attention_work`` against a brute-force count of the
    (query, key) pairs the mask keeps, causal and bidirectional."""
    chip_smoke = _chip_smoke()
    B, H, KV, D = 2, 4, 1, 8
    for causal in (True, False):
        pairs = sum(1 for q in range(S) for k in range(S)
                    if (not causal or k <= q)
                    and (window <= 0 or k > q - window))
        n_bytes, n_ops = chip_smoke.attention_work(B, H, KV, S, D, 2,
                                                   causal=causal,
                                                   window=window)
        assert n_ops == 4.0 * B * H * D * pairs
        assert n_bytes == 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
    full = chip_smoke.attention_work(1, 10, 1, 32768, 256, 2, window=2048)
    assert abs(full[1] / 0.6657e12 - 1) < 1e-3
    assert chip_smoke.rglru_work(1, 32768, 2560) == (
        12.0 * 32768 * 2560, 2.0 * 32768 * 2560)
