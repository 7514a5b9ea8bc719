"""The port's host-side pieces against the JAX package: constraints,
policy mapping, reward, the analytic latency oracle, the agent state
features, the bigram data and the sensitivity probe plan; plus the rule
that ``repro_torch`` imports neither ``jax`` nor ``repro``.

Tolerances: integer outputs and CMPs exact; the latency oracle, state
features and rewards exact (the same numpy float64 / float32 code), held
at ≤1e-6 where a float crosses the frameworks.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ArchConfig  # noqa: E402
from repro.core import constraints as jc  # noqa: E402
from repro.core import policy as jp  # noqa: E402
from repro.core import reward as jr  # noqa: E402
from repro.core import sensitivity as jsens  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.core.compress import lm_layer_specs  # noqa: E402
from repro.core.latency import (V5E, LatencyContext,  # noqa: E402
                                policy_latency)
from repro.data import pipeline as jdata  # noqa: E402

from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.configs.testbed import LM_CFG  # noqa: E402
from repro_torch.core import constraints as tc  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import policy as tp  # noqa: E402
from repro_torch.core import reward as tr  # noqa: E402
from repro_torch.core import sensitivity as tsens  # noqa: E402
from repro_torch.core import state as tstate  # noqa: E402
from repro_torch.core.compress import lm_layer_specs as t_specs  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CTX = dict(tokens=1, seq_ctx=512, mode="decode", batch=1)
TINY = dict(name="t", num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=256, vocab_size=128)


def _cfgs():
    testbed = {k: getattr(LM_CFG, k) for k in LM_CFG.__dataclass_fields__}
    return [(ArchConfig(**TINY), TArchConfig(**TINY)),
            (ArchConfig(**testbed), TArchConfig(**testbed))]


def _cmp_tuple(c):
    return (c.keep, c.mode, c.w_bits, c.a_bits)


def _random_policies(specs_j, specs_t, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pj, pt = jp.Policy.reference(specs_j), tp.Policy.reference(specs_t)
        for i, (sj, st) in enumerate(zip(specs_j, specs_t)):
            a = rng.random(3).astype(np.float32)
            pj.cmps[i] = jp.map_actions(sj, a, "pq")
            pt.cmps[i] = tp.map_actions(st, a, "pq")
        out.append((pj, pt))
    return out


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 15 and len(examples) >= 3
    files += examples
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro", "flax",
                                    "ml_dtypes"), \
                    f"{f.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("which", [0, 1])
def test_layer_specs_match(which):
    cj, ct = _cfgs()[which]
    assert [dataclasses.asdict(s) for s in t_specs(ct)] == \
        [dataclasses.asdict(s) for s in lm_layer_specs(cj)]


@pytest.mark.parametrize("methods", ["p", "q", "pq"])
def test_map_actions_and_legalize_match(methods):
    cj, ct = _cfgs()[1]
    specs_j, specs_t = lm_layer_specs(cj), t_specs(ct)
    rng = np.random.default_rng(1)
    # include the Eq. 4 / Eq. 8 threshold edges
    edges = np.asarray([0.0, 0.2, 0.2000001, 0.5, 0.5000001, 1.0],
                       np.float32)
    for _ in range(60):
        a = rng.random(3).astype(np.float32)
        a[rng.random(3) < 0.2] = rng.choice(edges)
        for sj, st in zip(specs_j, specs_t):
            assert _cmp_tuple(tp.map_actions(st, a, methods)) == \
                _cmp_tuple(jp.map_actions(sj, a, methods))
    for sj, st in zip(specs_j, specs_t):
        assert tc.mix_allowed(st) == jc.mix_allowed(sj)
        for keep in (0, 1, 3, 7, 128, 300, 1023, 4096):
            assert tc.round_keep(st, keep) == jc.round_keep(sj, keep)


def test_policy_batch_round_trip_and_metrics():
    cj, ct = _cfgs()[1]
    specs_j, specs_t = lm_layer_specs(cj), t_specs(ct)
    pairs = _random_policies(specs_j, specs_t, 8, seed=2)
    bj = jp.stack_policies(specs_j, [p for p, _ in pairs])
    bt = tp.stack_policies(specs_t, [p for _, p in pairs])
    for a, b in ((bj.keep, bt.keep), (bj.w_bits, bt.w_bits),
                 (bj.a_bits, bt.a_bits)):
        np.testing.assert_array_equal(a, b)
    back = tp.policies_from_batch(specs_t, bt)
    for (pj, _), pb in zip(pairs, back):
        assert [_cmp_tuple(c) for c in pb.cmps] == \
            [_cmp_tuple(c) for c in pj.cmps]
        assert pb.macs_fraction(specs_t) == pj.macs_fraction(specs_j)
        assert pb.bops(specs_t) == pj.bops(specs_j)


@pytest.mark.parametrize("kind", ["absolute", "hard_exponential"])
def test_reward_matches(kind):
    rng = np.random.default_rng(3)
    cj = jr.RewardConfig(kind=kind, target_ratio=0.5)
    ct = tr.RewardConfig(kind=kind, target_ratio=0.5)
    for acc, lat in rng.random((50, 2)):
        assert tr.compute_reward(ct, acc, lat + 0.1, 1.0) == \
            jr.compute_reward(cj, acc, lat + 0.1, 1.0)


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("window", [0, 128])
def test_policy_latency_matches(which, window):
    cj, ct = _cfgs()[which]
    specs_j, specs_t = lm_layer_specs(cj), t_specs(ct)
    for pj, pt in _random_policies(specs_j, specs_t, 6, seed=which):
        for ctx in (dict(CTX), dict(tokens=64, seq_ctx=0, mode="prefill",
                                    tp=2)):
            lj = policy_latency(specs_j, pj, ctx=LatencyContext(**ctx),
                                window=window)
            lt = tlat.policy_latency(specs_t, pt,
                                     ctx=tlat.LatencyContext(**ctx),
                                     window=window)
            assert [u.name for u in lt.units] == [u.name for u in lj.units]
            np.testing.assert_allclose(lt.total_s, lj.total_s, rtol=1e-12)
            assert lt.dominant() == lj.dominant()


def _fake_sens(specs, seed):
    rng = np.random.default_rng(seed)
    table = {}
    for s in specs:
        row = {}
        if s.quantizable:
            row.update({k: float(rng.random()) for k in ("w4", "w2", "a4",
                                                         "a2")})
        if s.prunable:
            row.update({"p50": float(rng.random()),
                        "p25": float(rng.random())})
        table[s.name] = row
    return table


def test_build_state_matches():
    cj, ct = _cfgs()[1]
    specs_j, specs_t = lm_layer_specs(cj), t_specs(ct)
    table = _fake_sens(specs_j, 4)
    sj, st = jsens.SensitivityResult(table), tsens.SensitivityResult(table)
    ref_j = policy_latency(specs_j, jp.Policy.reference(specs_j),
                           ctx=LatencyContext(**CTX))
    ref_t = tlat.policy_latency(specs_t, tp.Policy.reference(specs_t),
                                ctx=tlat.LatencyContext(**CTX))
    assert tstate.state_dim(3) == jstate.state_dim(3) == 33
    rng = np.random.default_rng(5)
    (pj, pt), = _random_policies(specs_j, specs_t, 1, seed=6)
    for t in range(len(specs_j)):
        prev = rng.random(3).astype(np.float32)
        vj = jstate.build_state(specs_j, t, pj, sj, prev, V5E,
                                LatencyContext(**CTX), ref_j)
        vt = tstate.build_state(specs_t, t, pt, st, prev, tlat.V5E,
                                tlat.LatencyContext(**CTX), ref_t)
        assert vt.dtype == vj.dtype == np.float32
        np.testing.assert_array_equal(vt, vj)


def test_bigram_data_bit_exact():
    tab_j = jdata.make_bigram_table(64, seed=4)
    np.testing.assert_array_equal(tdata.make_bigram_table(64, seed=4), tab_j)
    np.testing.assert_array_equal(tdata.sample_bigram(tab_j, 5, 17, seed=9),
                                  jdata.sample_bigram(tab_j, 5, 17, seed=9))
    bj = jdata.bigram_lm(64, 4, 12, seed=2)
    bt = tdata.bigram_lm(64, 4, 12, seed=2, device="cpu")
    assert bt["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(bt["tokens"].numpy(),
                                  np.asarray(bj["tokens"]))


@pytest.mark.parametrize("which", [0, 1])
def test_probe_plan_matches(which):
    cj, ct = _cfgs()[which]
    pj = jsens.build_probe_plan(lm_layer_specs(cj))
    pt = tsens.build_probe_plan(t_specs(ct))
    assert [(e.spec_idx, e.layer, e.method, e.param, e.tag)
            for e in pt.entries] == \
        [(e.spec_idx, e.layer, e.method, e.param, e.tag) for e in pj.entries]
    for a, b in ((pt.keep, pj.keep), (pt.w_bits, pj.w_bits),
                 (pt.a_bits, pj.a_bits)):
        np.testing.assert_array_equal(a, b)
    table = _fake_sens(lm_layer_specs(cj), 7)
    for name in table:
        np.testing.assert_array_equal(
            tsens.SensitivityResult(table).feature_row(name),
            jsens.SensitivityResult(table).feature_row(name))
