"""Every config of the zoo on the port against the JAX package, one case
per config: the check that anchors the port's model to the reference
now that it runs all ten (dense attention, MoE, SSM, the RG-LRU hybrid
and the two stub frontends).

  * ``lm_layer_specs`` at FULL and SMOKE widths: every field equal; the
    V5E analytic ``policy_latency`` of the reference policy and of two
    seeded pq policies, prefill at 2,048 tokens and decode at batch 8
    against a 2,048 context: equal to 1e-12 relative (the same float
    arithmetic in the same order).
  * the SMOKE forward in f32 from JAX's weights (carried over with
    ``repro_torch.convert``) over 2 x 40 seeded tokens (and a frontend's
    seeded embeddings): logits ≤1e-4.
  * a 12-step greedy decode loop (batch 2, from the zero prompt) of each
    decoder: the tokens equal JAX's ``launch.serve.decode_loop``'s.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compress as jcompress  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core.policy import Policy, map_actions  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

ARCHS = jreg.ARCH_IDS
DECODERS = tuple(a for a in ARCHS if not jreg.get_config(a).is_encoder)
CTXS = (dict(tokens=2048, seq_ctx=2048, mode="prefill"),
        dict(tokens=8, seq_ctx=2048, mode="decode"))


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
    return jcfg, params, tcfg, convert.lm_params(tcfg, host, "cpu")


def test_the_zoo_is_ten_configs():
    assert treg.ARCH_IDS == jreg.ARCH_IDS and len(ARCHS) == 10
    assert len(DECODERS) == 9


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_latency_match(arch):
    for smoke in (False, True):
        specs_j = jcompress.lm_layer_specs(jreg.get_config(arch, smoke))
        specs_t = tcompress.lm_layer_specs(treg.get_config(arch, smoke))
        assert [dataclasses.asdict(s) for s in specs_t] == \
            [dataclasses.asdict(s) for s in specs_j]
        pols = [(Policy.reference(specs_j), tp.Policy.reference(specs_t))]
        rng = np.random.default_rng(len(specs_j))
        for _ in range(2):
            pj, pt = Policy.reference(specs_j), tp.Policy.reference(specs_t)
            for i, (sj, st) in enumerate(zip(specs_j, specs_t)):
                a = rng.random(3).astype(np.float32)
                pj.cmps[i], pt.cmps[i] = map_actions(sj, a, "pq"), \
                    tp.map_actions(st, a, "pq")
            pols.append((pj, pt))
        for ctx in CTXS:
            for pj, pt in pols:
                lj = jlat.policy_latency(specs_j, pj, jlat.V5E,
                                         jlat.LatencyContext(**ctx))
                lt = tlat.policy_latency(specs_t, pt, tlat.V5E,
                                         tlat.LatencyContext(**ctx))
                assert [u.name for u in lt.units] == \
                    [u.name for u in lj.units]
                np.testing.assert_allclose(lt.total_s, lj.total_s,
                                           rtol=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_matches_jax(arch):
    jcfg, params, tcfg, tparams = _pair(arch)
    rng = np.random.default_rng(40)
    toks = rng.integers(0, jcfg.vocab_size, (2, 40))
    n = {"audio_stub": 40, "vision_stub": jcfg.frontend_len}.get(
        jcfg.frontend, 0)
    emb = rng.standard_normal((2, n, jcfg.d_model)).astype(np.float32) \
        if n else None
    if jcfg.frontend == "audio_stub":
        toks = None
    want = JM.forward(jcfg, params,
                      tokens=None if toks is None else jnp.asarray(toks),
                      embeds=None if emb is None else jnp.asarray(emb))
    got = TM.forward(tcfg, tparams,
                     None if toks is None else torch.from_numpy(toks),
                     embeds=None if emb is None else torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("arch", DECODERS)
def test_greedy_decode_matches_jax(arch):
    jcfg, params, tcfg, tparams = _pair(arch)
    want, _ = jserve.decode_loop(jcfg, params, 2, 12, 16)
    got, _ = tserve.decode_loop(tcfg, tparams, 2, 12, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
