"""The port's stub frontends against the JAX package on the same inputs
(made with numpy from a seed) and weights (carried over with
``repro_torch.convert``), on the CPU: hubert-xlarge (an audio encoder:
frame embeddings in place of tokens, no ``embed``, bidirectional
attention at head dim 80, per-frame CE, no decode step) and internvl2-2b
(a VLM: patch embeddings over the first ``frontend_len`` positions, the
loss masked to the positions from the last patch on, an odd vocab of
92,553 at full width); and K6 at head dim 80.

Models: the SMOKE configs in f32 (2 layers, d 64, 4 heads of 16;
hubert 4 / 4 heads, vocab 64; internvl2 4 / 2 heads, 8 patch positions,
vocab 256).

Tolerances, with what was found:
  * K6 at D 80 (f32, the JAX tests' masks): the plain version and the op
    on a CPU tensor against the JAX reference and the interpreted Pallas
    kernel at the JAX tests' atol 2e-5.
  * forward: logits ≤1e-4 (found ≤4e-6); under seeded policies the
    cspec bits and masks exact and at most 24 of the 2 x 300 next-token
    (per-frame) argmaxes flipped, the dense-attention family's bound in
    ``tests/test_torch_flips.py`` (a last-bit range difference moves
    whole fake-quant steps; found up to 3 of 96 on a shorter draw).
  * ``lm_loss``: ≤1e-5 (the encoder's per-frame CE, the VLM's masked
    CE).
  * decode (internvl2, from tokens: the patches cover the prompt): each
    step's logits ≤1e-4 against JAX's and the port's prefill.
  * a batched cspec over K 3 policies with the frontends' embeddings:
    each slot equal to its scalar forward (≤1e-6).
  * train step (3 steps, each from JAX's state): loss ≤1e-5, updated
    params within 0.1 x that step's lr.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.policy import Policy, map_actions  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

ARCHS = ("hubert-xlarge", "internvl2-2b")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
STEP_TOL = 0.1          # params per step, in units of that step's lr
FLIP_BOUND = 24         # flipped argmaxes of 2 x 300 under a policy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    over = dict(compute_dtype="float32")
    jcfg = jreg.get_config(arch, smoke=True).replace(**over)
    tcfg = treg.get_config(arch, smoke=True).replace(**over)
    params = jax.jit(JM.init, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    host = jax.device_get(params)
    return jcfg, params, host, tcfg, convert.lm_params(tcfg, host, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    return jax.jit(lambda p, t, e, cs: JM.forward(jcfg, p, tokens=t,
                                                  embeds=e, cspec=cs))


def _batch(cfg, B, S, seed):
    """Numpy inputs: tokens (none for an audio encoder), the frontend's
    embeddings (frames [B, S, d] or patches [B, frontend_len, d]) and an
    encoder's per-frame labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend != "audio_stub":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    n = S if cfg.frontend == "audio_stub" else cfg.frontend_len
    out["embeds"] = rng.standard_normal((B, n, cfg.d_model)).astype(
        np.float32)
    if cfg.is_encoder:
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S))
    return out


def _to(batch, lib):
    if lib == "jax":
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _seeded_policy(jspecs, tspecs, seed):
    rng = np.random.default_rng(seed)
    pj, pt = Policy.reference(jspecs), tp.Policy.reference(tspecs)
    for i, (sj, st) in enumerate(zip(jspecs, tspecs)):
        a = rng.random(3).astype(np.float32)
        pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
            tp.map_actions(st, a, "pq")
    return pj, pt


# --------------------------------------------------------------------------
# K6 at head dim 80
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 96)])
def test_flash_attention_d80_matches_jax(causal, window):
    rng = np.random.default_rng(80)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 200, 80), (2, 4, 200, 80), (2, 4, 200, 80)))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    wants = (jref.attention_ref(jq, jk, jv, causal=causal, window=window),
             jops.flash_attention(jq, jk, jv, causal=causal, window=window))
    build.reset_launches()
    got_ref = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    got_op = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert build.LAUNCHES["flash_attention"] == 0
    assert torch.equal(got_op, got_ref)
    for want in wants:
        np.testing.assert_allclose(got_op.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)


# --------------------------------------------------------------------------
# Forward, loss, decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_no_embed_for_audio(arch):
    jcfg, _, host, tcfg, tparams = _pair(arch)
    own = TM.init(tcfg, seed=0, device="cpu")
    assert ("embed" in own) == (tcfg.frontend != "audio_stub")
    assert set(own) == set(tparams) == set(host)
    assert TM.device_of(own) == torch.device("cpu")
    back = convert.to_jax_lm_params(tcfg, tparams)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [40, 600], ids=["dense", "chunked"])
def test_forward_matches_jax(arch, S):
    """S 40: one dense attention block; S 600: the chunked branch."""
    jcfg, params, _, tcfg, tparams = _pair(arch)
    b = _batch(jcfg, 2, S, S)
    jb, tb = _to(b, "jax"), _to(b, "torch")
    want = _jax_forward(jcfg)(params, jb.get("tokens"), jb["embeds"], None)
    got = TM.forward(tcfg, tparams, tb.get("tokens"), embeds=tb["embeds"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_vision_embeds_cover_the_first_positions():
    """internvl2's patches replace the token embeddings at positions < P
    only: the logits there depend on the patches, the tokens there do
    not reach them (their embeddings are overwritten)."""
    _, _, _, tcfg, tparams = _pair("internvl2-2b")
    b = _to(_batch(tcfg, 1, 24, 1), "torch")
    P = tcfg.frontend_len
    other = b["tokens"].clone()
    other[:, :P] = (other[:, :P] + 1) % tcfg.vocab_size
    a = TM.forward(tcfg, tparams, b["tokens"], embeds=b["embeds"])
    c = TM.forward(tcfg, tparams, other, embeds=b["embeds"])
    torch.testing.assert_close(a, c, atol=0, rtol=0)
    d = TM.forward(tcfg, tparams, b["tokens"])
    assert float((a[:, :P] - d[:, :P]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_under_policy_matches_jax(arch):
    jcfg, params, _, tcfg, tparams = _pair(arch)
    jcm = CompressibleLM(jcfg, params)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    b = _batch(jcfg, 2, 300, 7)
    jb, tb = _to(b, "jax"), _to(b, "torch")
    flips = []
    for seed in (5, 6):
        pj, pt = _seeded_policy(jcm.specs, tcm.specs, seed)
        jcs, tcs = jcm.build_cspec(pj), tcm.build_cspec(pt)
        for i, blk in enumerate(tcs["blocks"]):
            for part in ("attn", "mlp"):
                for key, v in blk[part].items():
                    w = jax.tree.map(lambda x: np.asarray(x)[i],
                                     jcs["blocks"][part][key])
                    if isinstance(v, torch.Tensor):
                        np.testing.assert_array_equal(v.numpy(), w)
                    else:
                        assert v == {k: int(x) for k, x in w.items()}
        want = np.asarray(_jax_forward(jcfg)(params, jb.get("tokens"),
                                             jb["embeds"], jcs))
        got = TM.forward(tcfg, tparams, tb.get("tokens"), tcs,
                         embeds=tb["embeds"]).numpy()
        flips.append(int((got.argmax(-1) != want.argmax(-1)).sum()))
    assert max(flips) <= FLIP_BOUND, flips


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    """hubert: per-frame CE against ``labels``; internvl2: next-token CE
    over positions >= frontend_len - 1 only, summed over the batch and
    divided by the mask's sum, the count of one row's kept positions
    (the JAX mask is [1, S - 1])."""
    jcfg, params, _, tcfg, tparams = _pair(arch)
    b = _batch(jcfg, 2, 40, 9)
    want = float(jstep.lm_loss(jcfg, params, _to(b, "jax")))
    got = tstep.lm_loss(tcfg, tparams, _to(b, "torch"))
    assert abs(float(got) - want) <= 1e-5
    tb = _to(b, "torch")
    logits = TM.forward(tcfg, tparams, tb.get("tokens"),
                        embeds=tb["embeds"])
    if tcfg.is_encoder:
        manual = torch.nn.functional.cross_entropy(
            logits.reshape(-1, tcfg.vocab_size), tb["labels"].reshape(-1))
    else:
        nll = torch.nn.functional.cross_entropy(
            logits[:, :-1].transpose(1, 2), tb["tokens"][:, 1:],
            reduction="none")
        # the JAX mask is [1, S - 1]: the batch's sum over one row's count
        kept = nll[:, tcfg.frontend_len - 1:]
        manual = kept.sum() / kept.shape[1]
    assert abs(float(got) - float(manual)) <= 1e-5


def test_internvl2_decode_matches_jax_and_prefill():
    jcfg, params, _, tcfg, tparams = _pair("internvl2-2b")
    steps = 12
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             (2, steps))
    jcache = JM.init_cache(jcfg, 2, 16)
    tcache = TM.init_cache(tcfg, 2, 16, device="cpu")
    jfn = jax.jit(jstep.make_serve_step(jcfg))
    pre = TM.forward(tcfg, tparams, torch.from_numpy(toks))
    for pos in range(steps):
        tok = toks[:, pos:pos + 1]
        jl, jcache = jfn(params, jcache, jnp.asarray(tok), pos)
        tl, tcache = TM.decode_step(tcfg, tparams, tcache,
                                    torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        torch.testing.assert_close(tl[:, 0], pre[:, pos], atol=1e-4,
                                   rtol=0)


def test_encoder_serves_prefill_and_refuses_decode():
    """hubert-xlarge has no decode step (``configs.base.cell_supported``):
    ``init_cache``, ``decode_step`` and ``serve.decode_loop`` refuse it;
    ``serve.encode`` prefills seeded frames and ``make_prefill_step``
    takes them as ``embeds``."""
    _, _, _, tcfg, tparams = _pair("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder"):
        TM.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        TM.decode_step(tcfg, tparams, [], None, 0)
    with pytest.raises(ValueError, match="encoder"):
        tserve.decode_loop(tcfg, tparams, 2, 4, 8)
    classes, dt = tserve.encode(tcfg, tparams, 2, 24)
    assert tuple(classes.shape) == (2, 24) and dt >= 0
    assert int(classes.max()) < tcfg.vocab_size
    frames = torch.randn(1, 24, tcfg.d_model)
    logits = tstep.make_prefill_step(tcfg)(tparams, None, frames)
    assert tuple(logits.shape) == (1, 24, tcfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_cspec_with_embeds(arch):
    """A batched cspec of K 3 policies over one batch with the frontend's
    embeddings: each slot's logits equal its scalar forward's (the
    embeddings repeat for every slot; a VLM's slots gather from their
    own quantized tables)."""
    _, _, _, tcfg, tparams = _pair(arch)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    tb = _to(_batch(tcfg, 2, 24, 4), "torch")
    pols = [_seeded_policy(tcm.specs, tcm.specs, s)[1] for s in (1, 2, 3)]
    stacked = tcompress.stack_cspecs([tcm.build_cspec(p) for p in pols])
    got = TM.forward(tcfg, tparams, tb.get("tokens"), stacked,
                     embeds=tb["embeds"])
    assert got.shape[0] == 3
    for k, p in enumerate(pols):
        want = TM.forward(tcfg, tparams, tb.get("tokens"),
                          tcm.build_cspec(p), embeds=tb["embeds"])
        torch.testing.assert_close(got[k], want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    jcfg, params, _, tcfg, _ = _pair(arch)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt.OptimizerConfig(**OPT)))
    tfn = tstep.make_train_step(tcfg, topt.OptimizerConfig(**OPT))
    jp = params
    js = jopt.adamw_init(jp, jopt.OptimizerConfig(**OPT))
    for seed in range(3):
        b = _batch(jcfg, 2, 24, 20 + seed)
        tparams = convert.lm_params(tcfg, jax.device_get(jp), "cpu")
        tstate = convert.adamw_state(tcfg, jax.device_get(js), "cpu")
        jp, js, jm = jfn(jp, js, _to(b, "jax"))
        tparams, tstate, tm = tfn(tparams, tstate, _to(b, "torch"))
        lr = float(jm["lr"])
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        for g, w in zip(jax.tree.leaves(convert.to_jax_lm_params(
                tcfg, tparams)), jax.tree.leaves(jax.device_get(jp))):
            assert (np.abs(g - np.asarray(w)) / lr).max() <= STEP_TOL
