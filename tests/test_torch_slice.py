"""The port's deployment slicer (``core/compress.py::slice_lm_params``)
and its helpers (``core/pruning.py::slice_indices``,
``core/quantization.py::bits_for_mode``) against the JAX package's, on
the CPU in f32.

The same weights on both sides: JAX's SMOKE init, unrolled
(``scan_layers=False``, the deployment layout), carried over with
``repro_torch.convert.lm_params``; the same policies, built from one
seeded numpy stream. Tolerances:

  * ``slice_indices`` and ``bits_for_mode``: equal.
  * the cspec masks of both packages: equal (the same ℓ1 selection), so
    the slicers see the same kept indices.
  * ``slice_lm_params``: leaf for leaf, the same paths, shapes and
    values, exactly (it only gathers rows and columns), on granite-3-8b
    (SwiGLU, GQA, tied), qwen2-0.5b (``wq``'s bias) and recurrentgemma-2b
    (unrolled RG-LRU layers, left untouched), under an FF-only policy
    and a head-pruned one; the input tree is left as it was.
  * the sliced forward of an FF-only policy with per-layer keeps: ≤1e-5
    against JAX's sliced forward (f32 matmuls summed in other orders),
    and ≤1e-5 against the port's own masked forward, which adds the
    pruned channels as exact zeros (only the products' summation order
    differs); deployed into int8 / packed int4, the sliced model's
    logits within 1e-4 of JAX's deployed sliced model (the bound of
    ``tests/test_torch_deploy.py``).
  * a head-pruned sliced model does not run through ``forward`` on
    either side (``wk`` / ``wv`` stay whole: ROADMAP.md, Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compress as jcompress  # noqa: E402
from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import quantization as jquant  # noqa: E402
from repro.core.policy import Policy as JPolicy  # noqa: E402
from repro.core.spec import LayerCMP as JCMP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core import pruning as tpruning  # noqa: E402
from repro_torch.core import quantization as tquant  # noqa: E402
from repro_torch.core.policy import Policy as TPolicy  # noqa: E402
from repro_torch.core.spec import LayerCMP as TCMP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

ARCHS = ("granite-3-8b", "qwen2-0.5b", "recurrentgemma-2b")
OVER = dict(compute_dtype="float32", scan_layers=False)
FORWARD_TOL = 1e-5
DEPLOYED_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_PAIRS = {}


def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port params, JAX adapter, port
    adapter) of ``arch``'s SMOKE config, unrolled, in f32."""
    if arch not in _PAIRS:
        jcfg = jreg.get_config(arch, smoke=True).replace(**OVER)
        tcfg = treg.get_config(arch, smoke=True).replace(**OVER)
        params = JM.init(jcfg, jax.random.PRNGKey(0))
        tparams = convert.lm_params(tcfg, jax.device_get(params), "cpu")
        _PAIRS[arch] = (jcfg, params, tcfg, tparams,
                        jcompress.CompressibleLM(jcfg, params),
                        tcompress.CompressibleLM(tcfg, tparams))
    return _PAIRS[arch]


def _policies(specs, kind: str, seed: int):
    """The same policy in both packages: FF-only ("ff": every ``mlp_up``
    unit keeps a seeded count, layer by layer), or "heads" (every
    attention layer also keeps a seeded number of heads, every RG-LRU
    layer a seeded width); bits stay 32."""
    rng = np.random.default_rng(seed)
    keeps = {}
    for i, s in enumerate(specs):
        if s.kind == "mlp_up" or (kind == "heads" and s.kind in (
                "attn_qkv", "rglru_in")):
            keeps[i] = int(rng.integers(1, s.prune_dim))
    jp, tp = JPolicy.reference(specs), TPolicy.reference(specs)
    for i, k in keeps.items():
        jp.cmps[i] = JCMP(keep=k)
        tp.cmps[i] = TCMP(keep=k)
    return jp, tp


def _flat(tree, prefix=""):
    """{path: numpy array} of a params tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree)}


def _assert_same_tree(got, want):
    _assert_same_leaves(_flat(got), _flat(want))


def _assert_same_leaves(g, w):
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _masks(cs):
    return [(i, key, np.asarray(blk[part][key]))
            for i, blk in enumerate(cs["blocks"])
            for part in sorted(blk) for key in sorted(blk[part])
            if key.endswith("_mask")]


def _cspecs(arch, kind, seed=0):
    jcfg, params, tcfg, tparams, jcm, tcm = _pair(arch)
    jp, tp = _policies(tcm.specs, kind, seed)
    jcs, tcs = jcm.build_cspec(jp), tcm.build_cspec(tp)
    for (i, key, a), (_, _, b) in zip(_masks(jcs), _masks(tcs)):
        np.testing.assert_array_equal(b, a, err_msg=f"layer {i} {key}")
    return jcs, tcs


def test_slice_indices_and_bits_for_mode_match_jax():
    rng = np.random.default_rng(0)
    for n in (1, 7, 160, 12_800):
        mask = (rng.random(n) < 0.5).astype(np.float32)
        want = jpruning.slice_indices(jnp.asarray(mask))
        for m in (mask, torch.as_tensor(mask)):
            got = tpruning.slice_indices(m)
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for mode in ("FP32", "INT8", "MIX"):
        assert tquant.bits_for_mode(mode) == jquant.bits_for_mode(mode)
        assert tquant.bits_for_mode(mode, 3) == jquant.bits_for_mode(mode, 3)
    assert tquant.bits_for_mode("MIX") == 6
    with pytest.raises(KeyError):
        tquant.bits_for_mode("INT4")


@pytest.mark.parametrize("kind", ("ff", "heads"))
@pytest.mark.parametrize("arch", ARCHS)
def test_slice_lm_params_matches_jax_leaf_for_leaf(arch, kind):
    """The sliced trees equal JAX's exactly; pruned units really shrank
    (wq's columns and bias and wo's rows per kept head, the MLP by its
    kept channels), wk / wv and RG-LRU blocks whole."""
    jcfg, params, tcfg, tparams, _, _ = _pair(arch)
    jcs, tcs = _cspecs(arch, kind)
    want = jcompress.slice_lm_params(jcfg, params, jcs)
    got = tcompress.slice_lm_params(tcfg, tparams, tcs)
    _assert_same_tree(got, jax.device_get(want))
    hd = tcfg.head_dim
    for i, (blk, cs, orig) in enumerate(zip(got["blocks"], tcs["blocks"],
                                            tparams["blocks"])):
        ff = int(cs["mlp"]["ff_mask"].sum())
        assert blk["mlp"]["w_up"]["w"].shape[1] == ff
        assert blk["mlp"]["w_down"]["w"].shape[0] == ff
        assert ff < tcfg.d_ff
        if tcfg.layer_kinds[i] == "attn":
            heads = int(cs["attn"]["head_mask"].sum())
            assert blk["attn"]["wq"]["w"].shape[1] == heads * hd
            assert blk["attn"]["wo"]["w"].shape[0] == heads * hd
            assert (heads < tcfg.num_heads) == (kind == "heads")
            if "b" in orig["attn"]["wq"]:
                assert blk["attn"]["wq"]["b"].shape[0] == heads * hd
            for name in ("wk", "wv"):
                assert blk["attn"][name]["w"] is orig["attn"][name]["w"]
        else:
            assert all(a is b for a, b in zip(
                _leaves(blk["rglru"]), _leaves(orig["rglru"])))
    if arch == "qwen2-0.5b":
        assert "b" in tparams["blocks"][0]["attn"]["wq"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _containers(tree):
    """Every dict and list of a tree, by identity."""
    if isinstance(tree, dict):
        return [id(tree)] + [c for v in tree.values() for c in _containers(v)]
    if isinstance(tree, list):
        return [id(tree)] + [c for v in tree for c in _containers(v)]
    return []


def test_slice_leaves_the_input_tree_untouched():
    """After slicing, the input's containers and tensors are the same
    objects with the same values, and the result's blocks share no
    container with the input's (the other top-level entries are shared,
    as in the JAX package)."""
    _, _, tcfg, tparams, _, _ = _pair("granite-3-8b")
    _, tcs = _cspecs("granite-3-8b", "heads", seed=3)
    before = {k: v.copy() for k, v in _flat(tparams).items()}
    leaves, boxes = _leaves(tparams), _containers(tparams)
    out = tcompress.slice_lm_params(tcfg, tparams, tcs)
    assert all(a is b for a, b in zip(_leaves(tparams), leaves))
    assert _containers(tparams) == boxes
    _assert_same_leaves(_flat(tparams), before)
    assert not set(_containers(out["blocks"])) & set(boxes)


def test_slice_refuses_a_scanned_homogeneous_config():
    jcfg, params, tcfg, tparams, _, _ = _pair("granite-3-8b")
    _, tcs = _cspecs("granite-3-8b", "ff")
    msgs = []
    for fn, cfg in ((jcompress.slice_lm_params, jcfg),
                    (tcompress.slice_lm_params, tcfg)):
        with pytest.raises(ValueError, match="unrolled") as e:
            fn(cfg.replace(scan_layers=True), tparams, tcs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # recurrentgemma-2b is not homogeneous: scanning flag or not, it slices
    _, _, rcfg, rparams, _, _ = _pair("recurrentgemma-2b")
    _, rcs = _cspecs("recurrentgemma-2b", "ff")
    tcompress.slice_lm_params(rcfg.replace(scan_layers=True), rparams, rcs)


_jforward = jax.jit(JM.forward, static_argnums=0)


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (2, 24))


@pytest.mark.parametrize("arch", ARCHS)
def test_sliced_ff_forward_matches_jax_and_the_masked_model(arch):
    """FF-only, per-layer keeps: the port's sliced forward (the same
    config, no cspec) against JAX's sliced forward and against the port's
    masked forward; deployed int8 and packed int4 against JAX's deployed
    sliced model."""
    jcfg, params, tcfg, tparams, _, tcm = _pair(arch)
    jcs, tcs = _cspecs(arch, "ff", seed=5)
    keeps = {int(cs["mlp"]["ff_mask"].sum()) for cs in tcs["blocks"]}
    assert len(keeps) > 1                       # per-layer keeps
    toks = _tokens(tcfg)
    tt = torch.as_tensor(toks, dtype=torch.int64)
    jsliced = jcompress.slice_lm_params(jcfg, params, jcs)
    tsliced = tcompress.slice_lm_params(tcfg, tparams, tcs)
    want = np.asarray(_jforward(jcfg, jsliced, jnp.asarray(toks)))
    with torch.no_grad():
        got = TM.forward(tcfg, tsliced, tt).numpy()
        masked = TM.forward(tcfg, tparams, tt, tcs).numpy()
    np.testing.assert_allclose(got, want, atol=FORWARD_TOL, rtol=0)
    np.testing.assert_allclose(got, masked, atol=FORWARD_TOL, rtol=0)
    for bits in (8, 4):
        jdep = jdeploy.quantize_params_for_deploy(jsliced, bits)
        tdep = tdeploy.quantize_params_for_deploy(tsliced, bits)
        jlog = np.asarray(_jforward(jcfg, jdep, jnp.asarray(toks)))
        with torch.no_grad():
            tlog = TM.forward(tcfg, tdep, tt).numpy()
        np.testing.assert_allclose(tlog, jlog, atol=DEPLOYED_TOL, rtol=0)


def test_head_sliced_model_does_not_run_on_either_side():
    """The mirrored quirk: heads cut from wq / wo but not wk / wv, so the
    attention's reshape to the config's heads fails in both packages."""
    jcfg, params, tcfg, tparams, _, _ = _pair("granite-3-8b")
    jcs, tcs = _cspecs("granite-3-8b", "heads")
    toks = _tokens(tcfg)
    with pytest.raises(TypeError):
        JM.forward(jcfg, jcompress.slice_lm_params(jcfg, params, jcs),
                   jnp.asarray(toks))
    with pytest.raises(RuntimeError):
        TM.forward(tcfg, tcompress.slice_lm_params(tcfg, tparams, tcs),
                   torch.as_tensor(toks, dtype=torch.int64))
