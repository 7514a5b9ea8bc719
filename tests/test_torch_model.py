"""The port's LM, pruning and cspec against the JAX package on the same
weights (carried over with ``repro_torch.convert``).

Tolerances:
  * ℓ1 scores ≤1e-6; keep masks exact, ties included (duplicated
    columns force tied scores; both sides keep the lower index).
  * f32 compute: accuracy exact on this test's draws (five policies on
    one batch). Over many draws the f32 argmaxes flip on a few positions
    under quantized policies and the accuracy is within one token of
    JAX's, not equal (``tests/test_torch_flips.py`` states the bound).
    Log-probs ≤1e-5 uncompressed (matmuls sum in other orders) and ≤0.1
    under compressed policies (found 0.043): a last-bit difference in a
    channel's range shifts s·x − z, and the floor turns that into whole
    quantization steps for the elements near a boundary.
  * bf16 compute: at most 3% of the 256 next-token argmaxes flip under
    the uncompressed and the all-INT8 policies (found 2 and 3), at most
    25% under the random mixed low-bit policies (found 47, 20 and 10 of
    256). bf16 rounds at other points in the two frameworks (XLA keeps
    excess precision inside fused elementwise chains), and a fake-quant
    floor turns a one-ulp difference into a whole step, so compressed
    bf16 outputs are only bounded, not matched.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import pruning as jpr  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.policy import Policy, map_actions  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.models import model as M  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.core import pruning as tpr  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

TINY = dict(name="t", num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=256, vocab_size=128, scan_layers=True)


# --------------------------------------------------------------------------
# Pruning
# --------------------------------------------------------------------------

def test_keep_mask_ties_follow_jax_order():
    """Duplicated weight columns give tied ℓ1 scores; the mask must keep
    the same (lower-index) channels as the JAX package."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 12)).astype(np.float32)
    w[:, 7] = w[:, 2]
    w[:, 9] = w[:, 2]
    w[:, 11] = -w[:, 4]                 # same ℓ1 norm, other sign
    w2 = rng.standard_normal((16, 12)).astype(np.float32)
    w2[:, [7, 9]] = w2[:, [2, 2]]
    w2[:, 11] = w2[:, 4]
    sj = jpr.l1_scores([jnp.asarray(w), jnp.asarray(w2)])
    st = tpr.l1_scores([torch.from_numpy(w), torch.from_numpy(w2)])
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    assert float(st[7]) == float(st[2]) == float(st[9])
    for keep in range(0, 13):
        np.testing.assert_array_equal(
            tpr.keep_mask(st, keep).numpy(),
            np.asarray(jpr.keep_mask(sj, keep)))
    # every score tied: the first `keep` channels survive
    flat = torch.ones(8)
    np.testing.assert_array_equal(
        tpr.keep_mask(flat, 3).numpy(),
        np.asarray(jpr.keep_mask(jnp.ones(8), 3)))


def test_head_scores_match():
    rng = np.random.default_rng(1)
    wq = rng.standard_normal((32, 4 * 8)).astype(np.float32)
    wq[:, 16:24] = wq[:, 0:8]           # head 2 duplicates head 0
    np.testing.assert_allclose(
        tpr.head_scores(torch.from_numpy(wq), 4).numpy(),
        np.asarray(jpr.head_scores(jnp.asarray(wq), 4)), rtol=1e-6)


# --------------------------------------------------------------------------
# The LM
# --------------------------------------------------------------------------

def _pair(compute_dtype):
    cfg = ArchConfig(**TINY, compute_dtype=compute_dtype)
    params = M.init(cfg, jax.random.PRNGKey(0))
    # duplicated MLP columns in layer 1 force tied prune scores
    up = np.array(params["blocks"]["mlp"]["w_up"]["w"])
    gate = np.array(params["blocks"]["mlp"]["w_gate"]["w"])
    up[1, :, 5], gate[1, :, 5] = up[1, :, 3], gate[1, :, 3]
    params["blocks"]["mlp"]["w_up"]["w"] = jnp.asarray(up)
    params["blocks"]["mlp"]["w_gate"]["w"] = jnp.asarray(gate)
    tcfg = TArchConfig(**TINY, compute_dtype=compute_dtype)
    tparams = convert.lm_params(tcfg, jax.device_get(params), device="cpu")
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3)
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    return (CompressibleLM(cfg, params), batch,
            tcompress.CompressibleLM(tcfg, tparams), tb)


def _policies(specs_j, specs_t):
    """Reference, all-INT8, and three random pq policies (legalized)."""
    out = [(Policy.reference(specs_j), tp.Policy.reference(specs_t))]
    pj, pt = copy.deepcopy(out[0])
    for i, (sj, st) in enumerate(zip(specs_j, specs_t)):
        a = np.asarray([0.0, 0.3, 0.3], np.float32)
        pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
            tp.map_actions(st, a, "pq")
    out.append((pj, pt))
    rng = np.random.default_rng(2)
    for _ in range(3):
        pj, pt = copy.deepcopy(out[0])
        for i, (sj, st) in enumerate(zip(specs_j, specs_t)):
            a = rng.random(3).astype(np.float32)
            pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
                tp.map_actions(st, a, "pq")
        out.append((pj, pt))
    return out


def test_lm_f32_accuracy_exact_and_log_probs_close():
    cm, batch, tcm, tb = _pair("float32")
    acc = jax.jit(lambda cs: cm.accuracy(batch, cs))
    lps = jax.jit(lambda cs: cm.log_probs(batch, cs))
    for pj, pt in _policies(cm.specs, tcm.specs):
        cj, ct = cm.build_cspec(pj), tcm.build_cspec(pt)
        for i in range(TINY["num_layers"]):
            np.testing.assert_array_equal(
                ct["blocks"][i]["mlp"]["ff_mask"].numpy(),
                np.asarray(cj["blocks"]["mlp"]["ff_mask"][i]))
            np.testing.assert_array_equal(
                ct["blocks"][i]["attn"]["head_mask"].numpy(),
                np.asarray(cj["blocks"]["attn"]["head_mask"][i]))
        assert float(tcm.accuracy(tb, ct)) == float(acc(cj))
        compressed = any(c.w_bits < 32 or c.keep < s.prune_dim
                         for c, s in zip(pt.cmps, tcm.specs))
        np.testing.assert_allclose(tcm.log_probs(tb, ct).numpy(),
                                   np.asarray(lps(cj)),
                                   atol=0.1 if compressed else 1e-5)


def test_lm_bf16_argmax_flips_bounded():
    cm, batch, tcm, tb = _pair("bfloat16")
    lps = jax.jit(lambda cs: cm.logits(batch, cs))
    n = tb["tokens"].numel()
    for k, (pj, pt) in enumerate(_policies(cm.specs, tcm.specs)):
        want = np.asarray(lps(cm.build_cspec(pj))).argmax(-1)
        got = tcm.logits(tb, tcm.build_cspec(pt)).numpy().argmax(-1)
        flips = int((want != got).sum())
        bound = 0.03 if k < 2 else 0.25
        assert flips <= bound * n, f"policy {k}: {flips} of {n} flip"


def test_lm_layout_and_init():
    """The port's own seeded init gives the JAX layout ([in, out]
    weights, one dict per layer) at the configured dtypes, and its
    forward gives finite f32 logits."""
    cfg = TArchConfig(**TINY)
    params = TM.init(cfg, seed=0, device="cpu")
    assert len(params["blocks"]) == cfg.num_layers
    attn = params["blocks"][0]["attn"]
    assert attn["wq"]["w"].shape == (64, 4 * 16)
    assert attn["wk"]["w"].shape == (64, 2 * 16)
    assert params["blocks"][0]["mlp"]["w_down"]["w"].shape == (256, 64)
    assert params["unembed"].shape == (64, 128)
    toks = torch.randint(0, 128, (2, 9))
    logits = TM.forward(cfg, params, toks)
    assert logits.dtype == torch.float32 and logits.shape == (2, 9, 128)
    assert bool(torch.isfinite(logits).all())
    again = TM.init(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"], params["embed"])
