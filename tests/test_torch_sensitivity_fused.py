"""The port's fused sensitivity analysis (``run_sensitivity``: the probe
plan in chunks of C policies, one batched forward a chunk) against its
per-probe path (``run_sensitivity_sequential``) and against the JAX
package's fused analysis, on the tiny f32 LM and the tiny ResNet, on the
CPU (mirrors ``tests/test_sensitivity.py``).

Tolerances: every layer × probe KL ≤1e-6 (the batched forward's
products and the KL's means sum in other orders than the per-probe
forward's and XLA's), except the ResNet's activation probes of the
convs behind a GroupNorm: within 1e-6 + 10% of the KL, the bound
``tests/test_torch_resnet.py`` states against XLA (their fake-quant input
differs in the last bits, and at 4 and 2 bits an element on a step
boundary moves by a whole step; the batched forward's GroupNorm over
the slots' side-by-side channels sums in another order again). The
chunk size (1, 3, 8, 1024) changes no KL on the CPU by more than 1e-9.
The memo hands every caller with the same (model, batch, params) the
same result object; ``full_sweep`` matches the JAX sweep at ≤1e-6.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.core.compress import CompressibleLM  # noqa: E402
from repro.data.pipeline import bigram_lm  # noqa: E402
from repro.models import model as M  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import compress as tcompress  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

from test_torch_fused import TINY, _port_cfg  # noqa: E402
from test_torch_resnet import TINY as RTINY  # noqa: E402
from test_torch_resnet import _batch, _pair  # noqa: E402


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


@pytest.fixture(scope="module")
def lm():
    cfg = ArchConfig(**TINY, compute_dtype="float32")
    params = M.init(cfg, jax.random.PRNGKey(0))
    tcfg = _port_cfg(cfg)
    tm = tcompress.CompressibleLM(
        tcfg, convert.lm_params(tcfg, jax.device_get(params), device="cpu"))
    batch = bigram_lm(cfg.vocab_size, 8, 32, seed=3)
    tb = {"tokens": torch.as_tensor(np.array(batch["tokens"]),
                                    dtype=torch.int64)}
    return CompressibleLM(cfg, params), tm, batch, tb


@pytest.fixture(scope="module")
def resnet():
    jcm, tcm = _pair(RTINY)
    jb, tb = _batch(4, 16, 8, seed=5)
    return jcm, tcm, jb, tb


def _tol(layer, tag, kl, resnet):
    """1e-6, plus 10% of the KL for a ResNet activation probe behind a
    GroupNorm (the module docstring)."""
    if resnet and tag.startswith("a") and layer not in ("stem", "head"):
        return 1e-6 + 0.1 * kl
    return 1e-6


def _check(got, want, resnet=False):
    assert set(got.table) == set(want.table)
    for layer, row in want.table.items():
        assert set(got.table[layer]) == set(row), layer
        for tag, kl in row.items():
            assert abs(got.table[layer][tag] - kl) <= _tol(
                layer, tag, kl, resnet), (layer, tag)


@pytest.mark.parametrize("which", ["lm", "resnet"])
def test_fused_matches_per_probe_and_jax(which, request):
    """The fused analysis (chunk 8) against the per-probe path and the
    JAX ``run_sensitivity``; the probes cover every layer."""
    jcm, tcm, jb, tb = request.getfixturevalue(which)
    fused = tsens.run_sensitivity(tcm, tb, memo=False)
    _check(fused, tsens.run_sensitivity_sequential(tcm, tb),
           which == "resnet")
    _check(fused, jsens.run_sensitivity(jcm, jb, memo=False),
           which == "resnet")
    assert sum(len(r) for r in fused.table.values()) > 2 * len(tcm.specs)


@pytest.mark.parametrize("chunk", [1, 3, 1024])
def test_chunk_size_changes_no_kl(lm, chunk):
    """Chunks of 1, 3 (padded with reference rows) and 1024 (one chunk:
    every distinct probe in one forward) against chunks of 8."""
    _, tcm, _, tb = lm
    want = tsens.run_sensitivity(tcm, tb, chunk=8, memo=False)
    got = tsens.run_sensitivity(tcm, tb, chunk=chunk, memo=False)
    for layer, row in want.table.items():
        for tag, kl in row.items():
            assert abs(got.table[layer][tag] - kl) <= 1e-9, (layer, tag)


def test_memo_shares_one_result(lm):
    """The same (model, batch, params) gives the same object, so engines
    built on one model share it (a shared rollout requires that); another
    batch object or new params give a new analysis (the memo keeps one
    entry a batch, as the JAX package's); ``memo=False`` never reads the
    memo."""
    _, tcm, _, tb = lm
    a = tsens.run_sensitivity(tcm, tb)
    assert tsens.run_sensitivity(tcm, tb) is a
    assert tsens.run_sensitivity(tcm, tb, memo=False) is not a
    other = {"tokens": tb["tokens"].clone()}
    assert tsens.run_sensitivity(tcm, other) is not a
    ctx = tlat.LatencyContext(tokens=1, seq_ctx=256, mode="decode")
    cfg = tsearch.SearchConfig(episodes=2)
    engines = [tsearch.BatchedCompressionSearch(tcm, tb, cfg, ctx, hw=hw,
                                                batch_size=2)
               for hw in (tlat.V5E, tlat.HardwareTarget(
                   name="other", peak_bf16=459e12, peak_int8=918e12,
                   hbm_bw=2765e9, ici_bw=90e9))]
    assert engines[0].sens is engines[1].sens is a
    params = tcm.params
    try:
        tcm.params = dict(params)
        assert tsens.run_sensitivity(tcm, tb) is not a
    finally:
        tcm.params = params
    # the entry for this batch now holds the other params' analysis: the
    # old params compute afresh, to the same values
    again = tsens.run_sensitivity(tcm, tb)
    assert again is not a and again.table == a.table


def test_full_sweep_matches_jax(lm):
    """The dense sweep (5 weight and 5 activation bit widths, 10 kept
    fractions per layer, legalized) over the same fused core: the JAX
    sweep's rows in the same order, KLs ≤1e-6; on the CPU no kernel
    launches."""
    jcm, tcm, jb, tb = lm
    build.reset_launches()
    got = tsens.full_sweep(tcm, tb)
    want = jsens.full_sweep(jcm, jb)
    assert [(r["layer"], r["method"], r["param"]) for r in got] == \
        [(r["layer"], r["method"], float(r["param"])) for r in want]
    np.testing.assert_allclose([r["kl"] for r in got],
                               [r["kl"] for r in want], atol=1e-6, rtol=0)
    assert all(v == 0 for v in build.LAUNCHES.values())
