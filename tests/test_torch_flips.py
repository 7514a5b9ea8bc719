"""How far the port's f32 next-token argmaxes move from the JAX
package's under compression policies: the bound that replaces "accuracy
equal" (the exact accuracies of ``tests/test_torch_model.py``,
``test_torch_rglru.py``, ``test_torch_serve.py`` and the search parity
tests rest on their own draws).

Setup: the SMOKE config of each served family in f32, JAX weights from
``PRNGKey(0)`` carried over with ``repro_torch.convert``, 2 x 300 seeded
tokens, 12 seeded random pq policies (legalized by ``map_actions``, as a
search episode maps its actions). Uncompressed, the logits agree within
1e-4 (the serving tests' bound; found ≤1.7e-5). Under a quantized policy
a last-bit difference in a channel's range (matmuls and reductions sum in
other orders) turns into whole fake-quant steps for the elements near a
step boundary, so the logits move by up to ~0.14 and some argmaxes flip.

Found on these draws, flips of 600 positions per policy (worst):
qwen2-0.5b 10, recurrentgemma-2b 19, mamba2-780m 0, olmo-1b 6; the
correct-token count never differed. An earlier check on other draws
found up to 7, 23, 0 and 7 flips and a one-token difference in the
correct count on three of 32 draws. The bounds below are those worst
counts with room (about twice the worst seen on any draws), and the
accuracy within one token of 600.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.compress import CompressibleLM  # noqa: E402
from repro.core.policy import Policy, map_actions  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.train.train_step import make_prefill_step  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

POLICIES, BATCH, SEQ = 12, 2, 300
# flips of the BATCH * SEQ argmaxes allowed per policy (module docstring)
FLIP_BOUND = {"qwen2-0.5b": 24, "recurrentgemma-2b": 48, "mamba2-780m": 6,
              "olmo-1b": 24}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run thousands of small CPU ops; with several test
    workers on one box, torch's intra-op thread pool makes each op wait
    for all its threads to be scheduled (a loaded box ran this module
    many times slower). One thread, restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _policy_pair(specs_j, specs_t, seed):
    rng = np.random.default_rng(1000 + seed)
    pj, pt = Policy.reference(specs_j), tp.Policy.reference(specs_t)
    for i, (sj, st) in enumerate(zip(specs_j, specs_t)):
        a = rng.random(3).astype(np.float32)
        pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
            tp.map_actions(st, a, "pq")
    return pj, pt


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    """The JAX prefill with the cspec as an argument: one compilation
    serves every policy."""
    return jax.jit(lambda p, t, cs: make_prefill_step(jcfg, cs)(p, t))


@pytest.mark.parametrize("arch", sorted(FLIP_BOUND))
def test_f32_argmax_flips_bounded_accuracy_within_one_token(arch):
    """Per policy: at most ``FLIP_BOUND[arch]`` of the 600 argmaxes flip
    and the correct-token count is within one of JAX's; uncompressed the
    logits agree within 1e-4. Some policy compresses each model."""
    jcfg = jreg.get_config(arch, smoke=True).replace(compute_dtype="float32")
    tcfg = treg.get_config(arch, smoke=True).replace(compute_dtype="float32")
    params = JM.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params(tcfg, jax.device_get(params), device="cpu")
    cm = CompressibleLM(jcfg, params)
    tcm = tcompress.CompressibleLM(tcfg, tparams)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (BATCH, SEQ))
    tt = torch.from_numpy(toks)
    want = np.asarray(jax.jit(make_prefill_step(jcfg))(params, toks))
    got = tstep.make_prefill_step(tcfg)(tparams, tt).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    compressed = 0
    for seed in range(POLICIES):
        pj, pt = _policy_pair(cm.specs, tcm.specs, seed)
        compressed += any(c.w_bits < 32 or c.a_bits < 32 for c in pt.cmps)
        want = np.asarray(_jax_forward(jcfg)(params, toks,
                                             cm.build_cspec(pj)))
        got = tstep.make_prefill_step(tcfg, tcm.build_cspec(pt))(
            tparams, tt).numpy()
        flips = int((want.argmax(-1) != got.argmax(-1)).sum())
        assert flips <= FLIP_BOUND[arch], f"policy {seed}: {flips} flip"
        correct = [int((lg[:, :-1].argmax(-1) == toks[:, 1:]).sum())
                   for lg in (got, want)]
        assert abs(correct[0] - correct[1]) <= 1, f"policy {seed}: {correct}"
    assert compressed == POLICIES
