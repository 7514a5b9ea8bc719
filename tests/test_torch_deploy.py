"""The port's deployment containers (``core/deploy.py``) and deployed
forward against the JAX package's, on the CPU.

Inputs are made with numpy from a seed; JAX LM weights are carried over
with ``repro_torch.convert`` (a deployed JAX tree too: its stacked int8 /
packed-int4 leaves split into per-layer containers).

Tolerances:
  * codes, scales and packed bytes: exact (the same correctly rounded f32
    quotient and round-half-even on both sides).
  * ``materialize_weight`` of a carried-over JAX-deployed tree: exact in
    f32 (one product of an exact code and the shared scale).
  * deployed forward under an f32 config: next-token argmaxes equal, and
    log-probs within 1e-4 (found ≤3e-6; the matmuls sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import deploy as jd  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as M  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.core import deploy as td  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

SMALL = dict(name="dep", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=128,
             scan_layers=True, compute_dtype="float32")
WIDTHS = {"wq": 4, "wk": 4, "wv": 4, "wo": 8, "w_up": 8, "w_gate": 8,
          "w_down": 4, "embed": 8}


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def lm():
    cfg = ArchConfig(**SMALL)
    params = M.init(cfg, jax.random.PRNGKey(0))
    tcfg = TArchConfig(**SMALL)
    tparams = convert.lm_params(tcfg, jax.device_get(params), device="cpu")
    toks = np.random.default_rng(3).integers(0, 128, (2, 16)).astype(
        np.int32)
    return cfg, params, tcfg, tparams, toks


def _leaves(tree, prefix=""):
    """(path, numpy leaf) pairs of a port tree, lists indexed."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree.numpy()


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("shape", [(256, 128), (3, 64, 32)])
@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_quantize_weight_matches_jax(shape, bits):
    w = _normal(bits, shape) * 0.3
    want = jd.quantize_weight(jnp.asarray(w), bits)
    got = td.quantize_weight(torch.from_numpy(w), bits)
    assert set(got) == set(want) == {"w_p" if bits <= 4 else "w_q",
                                     "w_scale"}
    for k in want:
        assert got[k].dtype == (torch.int8 if k != "w_scale"
                                else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_unpack_int4_weight_matches_jax():
    packed = np.random.default_rng(0).integers(-128, 128, (3, 16, 24)) \
        .astype(np.int8)
    want = np.asarray(jd.unpack_int4_weight(jnp.asarray(packed)))
    got = td.unpack_int4_weight(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 32, 24) and got.min() >= -8 and got.max() <= 7


def test_odd_contraction_dim_refused_for_int4():
    w = torch.from_numpy(_normal(12, (5, 4)))
    with pytest.raises(ValueError, match="even contraction"):
        td.quantize_weight(w, 4)
    assert "w_q" in td.quantize_weight(w, 8)
    qp = td.quantize_params_for_deploy({"lin": {"w": w}, "w_up": w}, 4)
    assert "w" in qp["lin"] and "w_p" not in qp["lin"]
    assert isinstance(qp["w_up"], torch.Tensor)          # stayed raw
    assert "w_q" in td.quantize_params_for_deploy({"w_up": w}, 8)["w_up"]


@pytest.mark.parametrize("bits", [0, 1, 9, 32, 4.0, "8", None, True])
def test_invalid_bits_rejected(bits):
    with pytest.raises((ValueError, TypeError)):
        td.quantize_weight(torch.ones((4, 4)), bits)


def test_bits_for_per_name_deploy_matches_jax(lm):
    """Per-name widths on a JAX LM carried over to the port: the port's
    deploy of the carried-over raw params equals the JAX deploy carried
    over, container for container, code for code."""
    cfg, params, tcfg, tparams, _ = lm
    jq = jd.quantize_params_for_deploy(params, bits_for=WIDTHS.get)
    tq = td.quantize_params_for_deploy(tparams, bits_for=WIDTHS.get)
    assert "w_p" in tq["blocks"][1]["attn"]["wq"]
    assert "w_q" in tq["blocks"][0]["attn"]["wo"]
    assert "w_q" in tq["embed"]
    assert "w_p" in tq["blocks"][0]["mlp"]["w_down"]
    assert isinstance(tq["unembed"], torch.Tensor)        # unnamed: raw
    _assert_trees_equal(
        tq, convert.lm_params(tcfg, jax.device_get(jq), device="cpu"))
    assert td.deployed_bytes(tq) == jd.deployed_bytes(jq)


@pytest.mark.parametrize("bits", [8, 4])
def test_materialize_weight_matches_jax(lm, bits):
    cfg, params, tcfg, _, _ = lm
    jq = jd.quantize_params_for_deploy(params, bits)
    tq = convert.lm_params(tcfg, jax.device_get(jq), device="cpu")
    for i in range(cfg.num_layers):
        for sub, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_up"),
                          ("mlp", "w_down")):
            c = jax.tree.map(lambda a: a[i], jq["blocks"][sub][name])
            want = np.asarray(JL.materialize_weight(c, jnp.float32))
            got = TL.materialize_weight(tq["blocks"][i][sub][name],
                                        torch.float32).numpy()
            np.testing.assert_array_equal(got, want, err_msg=(i, name))
    for name in ("embed", "unembed"):
        np.testing.assert_array_equal(
            TL.getw(tq, name, torch.float32).numpy(),
            np.asarray(JL.getw(jq, name, jnp.float32)), err_msg=name)


@pytest.mark.parametrize("bits", [8, 4])
def test_deployed_forward_matches_jax(lm, bits):
    """The port's forward on the deployed containers against the JAX
    ``M.forward`` on the same deployed params: argmax equal, log-probs
    ≤1e-4; and the port's own deploy gives the same forward."""
    cfg, params, tcfg, tparams, toks = lm
    jq = jd.quantize_params_for_deploy(params, bits)
    want = np.asarray(jax.nn.log_softmax(
        M.forward(cfg, jq, tokens=jnp.asarray(toks)), -1))
    tt = torch.as_tensor(toks, dtype=torch.int64)
    carried = convert.lm_params(tcfg, jax.device_get(jq), device="cpu")
    got = torch.log_softmax(TM.forward(tcfg, carried, tt), -1).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-4)
    own = torch.log_softmax(TM.forward(
        tcfg, td.quantize_params_for_deploy(tparams, bits), tt), -1).numpy()
    np.testing.assert_array_equal(own, got)
    base = torch.log_softmax(TM.forward(tcfg, tparams, tt), -1).numpy()
    assert not np.array_equal(own, base)        # the containers took hold
