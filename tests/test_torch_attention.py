"""The port's attention against the JAX package on the same inputs (made
with numpy from a seed): the chunked branch of ``layers.attention``
(S > 512), K6's plain version ``ref.attention_ref`` and the op
``ops.flash_attention`` on a CPU tensor, against the JAX ``layers``
chunked path, ``ref.attention_ref`` and the Pallas kernel run in
interpret mode on the CPU (as ``tests/test_kernels.py`` runs it).

Tolerances are the JAX package's own (``tests/test_kernels.py``): f32
atol 2e-5, bf16 atol 0.04. On the CPU the op takes the plain version and
K6's launch counter stays at 0.
"""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 0.04}
MASKS = [(True, 0), (False, 0), (True, 96)]


def _inputs(seed, q_shape, kv_shape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [600, 1100])
@pytest.mark.parametrize("causal,window", MASKS)
def test_chunked_attention_matches_jax(S, causal, window, dtype):
    """S 600: two q-chunks, one k-chunk; S 1100: three q-chunks, two
    k-chunks; both padded. GQA (4 q heads over 2) with a head mask."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(S, (2, S, 4, 16), (2, S, 2, 16),
                                         dtype)
    mask = np.asarray([1.0, 0.0, 1.0, 1.0], np.float32)
    want = JL.attention(jq, jk, jv, causal=causal, window=window,
                        head_mask=jnp.asarray(mask))
    build.reset_launches()
    got = TL.attention(tq, tk, tv, causal=causal, window=window,
                       head_mask=torch.from_numpy(mask))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert build.LAUNCHES["flash_attention"] == 0
    _close(got, want, dtype)
    assert float(got[:, :, 1].abs().max()) == 0.0


@pytest.mark.parametrize("S,H,KV,D", [(128, 4, 4, 32), (200, 8, 2, 16),
                                      (512, 4, 1, 64)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_matches_jax(S, H, KV, D, causal, window):
    """``tests/test_kernels.py``'s shapes, f32: the port's plain version
    and its op (on a CPU tensor) against the JAX reference and the JAX
    op (the Pallas kernel, interpreted)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(S, (2, H, S, D), (2, KV, S, D),
                                         "float32")
    want_ref = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    want_op = jops.flash_attention(jq, jk, jv, causal=causal, window=window)
    build.reset_launches()
    got_ref = tref.attention_ref(tq, tk, tv, causal=causal, window=window)
    got_op = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert build.LAUNCHES["flash_attention"] == 0
    assert torch.equal(got_op, got_ref)
    for got in (got_ref, got_op):
        for want in (want_ref, want_op):
            _close(got, want, "float32")


def test_flash_attention_bf16_matches_jax():
    """``tests/test_kernels.py``'s bf16 case: (1, 4/2, 128, 32), causal."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, (1, 4, 128, 32),
                                         (1, 2, 128, 32), "bfloat16")
    want_op = jops.flash_attention(jq, jk, jv)
    want_ref = jref.attention_ref(jq, jk, jv)
    got = tops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    for want in (want_ref, want_op):
        _close(got, want, "bfloat16")


def test_chunked_branch_agrees_with_the_dense_plain_version():
    """The chunked loop (K6's plain version at long S) and the dense
    ``attention_ref`` compute the same function: f32, S 1100, window 96,
    in the layer's [B,S,H,D] layout against the op's [B,H,S,D]."""
    _, (tq, tk, tv) = _inputs(3, (1, 1100, 4, 16), (1, 1100, 2, 16),
                              "float32")
    for causal, window in MASKS:
        got = TL.attention_chunked(tq, tk, tv, causal=causal, window=window)
        want = tref.attention_ref(tq.transpose(1, 2), tk.transpose(1, 2),
                                  tv.transpose(1, 2), causal=causal,
                                  window=window).transpose(1, 2)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_flash_attention_refuses_mixed_devices():
    """A CPU q with k or v elsewhere is refused, not computed."""
    q = torch.zeros((1, 2, 8, 16))
    kv = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CPU"):
        tops.flash_attention(q, kv, kv)


def _dense_bf16_rounded(q, k, v, mask):
    """Dense f32 attention (one KV head) under a [S, S] keep-mask, the
    output rounded to q's dtype."""
    s = torch.einsum("bhqd,bkd->bhqk", q.float(), k[:, 0].float()) \
        / q.shape[-1] ** 0.5
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    o = torch.einsum("bhqk,bkd->bhqd", torch.softmax(s, -1), v[:, 0].float())
    return o.to(q.dtype)


def test_chip_smoke_k6_row_check_refuses_a_dropped_key_tile():
    """``chip_smoke.py``'s per-row check of K6's bf16 output, at S 4096:
    the chunked plain branch stays within ``K6_CHUNKED_ROW_TOL`` of the
    dense plain version, ``attention_tail_ref`` is the dense plain
    version's last rows, and an output that drops one interior 64-key
    tile from the last four q tiles' rows is refused by the row check
    though it passes bf16's atol 0.04."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    S = 4096
    _, (q, k, v) = _inputs(11, (1, 2, S, 64), (1, 1, S, 64), "bfloat16")
    want = tref.attention_ref(q, k, v)
    mask = torch.ones((S, S), dtype=torch.bool).tril()
    torch.testing.assert_close(_dense_bf16_rounded(q, k, v, mask), want,
                               atol=0, rtol=0)
    for q0 in range(S - 4 * 64, S, 64):
        k0 = q0 // 2 // 64 * 64
        mask[q0:q0 + 64, k0:k0 + 64] = False
    faulty = _dense_bf16_rounded(q, k, v, mask)
    assert float((faulty.float() - want.float()).abs().max()) < 0.04
    assert chip_smoke.row_rel_err(faulty, want) > \
        4 * chip_smoke.K6_CHUNKED_ROW_TOL
    chunked = TL.attention_chunked(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
    assert chip_smoke.row_rel_err(chunked.transpose(1, 2), want) <= \
        chip_smoke.K6_CHUNKED_ROW_TOL
    fq, fk, fv = (t.float() for t in (q, k, v))
    torch.testing.assert_close(
        chip_smoke.attention_tail_ref(fq, fk, fv, 300),
        tref.attention_ref(fq, fk, fv)[:, :, -300:], atol=1e-6, rtol=0)


def test_flash_attention_route_by_dtype_and_head_dim():
    """The one place K6's route is decided: bf16 at head dims 64, 80,
    128 and 256 (every full-width config served, hubert-xlarge's 80
    included) takes the tensor cores; f32 (its 2e-5 parity) and bf16 at
    16 / 32 (the JAX tests' shapes only) the CUDA-core template."""
    from repro_torch.kernels import flash_attention as tfa
    for D in tfa.HEAD_DIMS:
        want = "tc" if D in (64, 80, 128, 256) else "simt"
        assert tfa.route(torch.bfloat16, D) == want
        assert tfa.route(torch.float32, D) == "simt"


def _bf16(shape, strides=None, offset=0):
    base = torch.zeros(offset + 4096 * 64, dtype=torch.bfloat16)
    if strides is None:
        return base[offset:offset + int(np.prod(shape))].view(shape)
    return base.as_strided(shape, strides, offset)


@pytest.mark.parametrize("shape,strides,offset", [
    ((1, 14, 64, 64), None, 0),                      # contiguous [B,H,S,D]
    ((1, 14, 64, 64), (14 * 64 * 64, 64, 14 * 64, 1), 0),   # layer view
    ((2, 1, 64, 256), (64 * 256, 7, 256, 1), 0),     # one kv head: free
    ((1, 2, 32, 128), None, 8),                      # base 16 bytes in
    ((1, 16, 64, 80), (64 * 16 * 80, 80, 16 * 80, 1), 0),   # hubert's layer
])
def test_tma_terms_accept_the_layouts_k6_is_given(shape, strides, offset):
    """``check_tma_terms`` passes the layer's transposed views, a size-1
    head dim with any stride and a base on a 16-byte boundary."""
    from repro_torch.kernels.flash_attention import check_tma_terms
    check_tma_terms(_bf16(shape, strides, offset), "q")


@pytest.mark.parametrize("shape,strides,offset,term", [
    ((1, 4, 64, 64), (4 * 64 * 64, 64, 1, 64), 0, "d-stride"),
    ((1, 4, 64, 64), (4 * 64 * 68, 68, 4 * 68, 1), 0, "dim 1 has stride 68"),
    ((1, 4, 64, 64), (4 * 64 * 64, 64, 4 * 64 + 4, 1), 0,
     "dim 2 has stride 260"),
    ((1, 4, 64, 64), None, 1, "16-byte aligned"),
    ((1, 4, 64, 80), (4 * 64 * 80, 80, 4 * 80 + 4, 1), 0,
     "dim 2 has stride 324"),
])
def test_tma_terms_refuse_what_tma_cannot_read(shape, strides, offset, term):
    """Each of TMA's terms that fails is named in the ValueError; the
    check neither copies nor re-routes."""
    from repro_torch.kernels.flash_attention import check_tma_terms
    t = _bf16(shape, strides, offset)
    with pytest.raises(ValueError, match=term):
        check_tma_terms(t, "k")
