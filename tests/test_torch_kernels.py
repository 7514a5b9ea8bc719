"""The port's kernel modules (K1 fake-quant, K2 fused 3-layer MLP, K3
Polyak) against the JAX package, and against their plain versions on a
card.

On the CPU each wrapper takes its plain version, so these tests hold the
plain versions (the functions the CUDA kernels compute) against the JAX
ops as the JAX package's own tests run them here: ``ops.fused_*`` in
Pallas interpret mode, and the jnp path of ``core.quantization``.
Inputs are made from a seed with numpy and kept above the subnormal range
(XLA on the CPU flushes subnormals; CUDA keeps them).

Tolerances:
  * fake_quant vs the JAX ``fake_quant`` (jnp path): exact.
  * fake_quant vs the JAX Pallas kernel: ≤2 ulp up to 8 bits. The Pallas
    kernel takes the scale as n / span, the jnp path (which the port
    follows) as n / ((min + span) - min); the two differ in the last bit
    of s. At 31 bits, ≤4 ulp of the offset z ~ 2^30 carried back through
    1/s: the f32 sum q + z + 0.5 drops the low bits on both sides.
  * K2 forward and backward vs ``ops.fused_mlp3``: ≤1e-5.
  * K3 vs ``ops.fused_polyak``: ≤1e-6, one network or both DDPG targets
    in one call.
  * K8's split TF32, emulated in torch f32 (operands rounded to 10
    mantissa bits), against the chunked plain branch: 2e-4, the JAX
    tests' bound; plain TF32 misses it.

The kernels themselves are held against their plain versions on a card
in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.quantization import fake_quant as j_fake_quant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import build, ops as tops  # noqa: E402
from repro_torch.kernels.fake_quant import (fake_quant_2d,  # noqa: E402
                                            fake_quant_slots)
from repro_torch.kernels import fake_quant as tfq  # noqa: E402
from repro_torch.kernels import mlp_fused as tmf  # noqa: E402
from repro_torch.kernels.mlp_fused import mlp3_plan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mlp_fused import mlp3, polyak_leaves  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_scan import (check_tma_terms,  # noqa: E402
                                          route as ssd_route, ssd_scan)
from repro_torch.kernels.ref import (attention_ref,  # noqa: E402
                                     fake_quant_ref, fake_quant_slots_ref,
                                     mlp3_ref,
                                     polyak_ref, quant_matmul_ref,
                                     rglru_scan_ref, ssd_chunked_ref)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --------------------------------------------------------------------------
# K1 fake-quant
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 32), (384, 256), (7, 257),
                                   (4, 6, 40)])
@pytest.mark.parametrize("bits", [1, 2, 4, 6, 8, 31, 32])
def test_fake_quant_matches_jax(shape, bits):
    x = _normal(bits, shape, scale=3.0)
    want = np.asarray(j_fake_quant(jnp.asarray(x), bits))
    got = tq.fake_quant(torch.from_numpy(x), bits).numpy()
    np.testing.assert_array_equal(got, want)
    if len(shape) == 2:
        kernel = np.asarray(jops.fused_fake_quant(jnp.asarray(x), bits))
        got = fake_quant_2d(torch.from_numpy(x), bits).numpy()
        if bits <= 8:
            np.testing.assert_array_max_ulp(got, kernel, maxulp=2)
        elif bits < 32:
            # 4 ulp of the offset z ~ 2^(b-1), carried back through 1/s
            inv_s = (x.max(0) - x.min(0)) / (2.0 ** bits - 1)
            tol = 4 * np.spacing(np.float32(2.0 ** (bits - 1))) * inv_s
            assert np.all(np.abs(got - kernel) <= tol)
        else:
            np.testing.assert_array_equal(got, kernel)


def test_fake_quant_bf16_and_ste():
    """bf16 activations are quantized in f32 and cast back, as in the
    JAX package (exact); the gradient is the identity (STE)."""
    x = _normal(0, (32, 48))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(j_fake_quant(xb, 4).astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = tq.fake_quant(tx, 4)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    (g,) = torch.autograd.grad(out.float().sum(), tx)
    np.testing.assert_array_equal(g.float().numpy(), np.ones_like(x))


def test_fake_quant_constant_channel():
    """A constant channel takes the 1e-8 span guard on both sides."""
    x = _normal(5, (16, 8))
    x[:, 3] = 0.75
    want = np.asarray(j_fake_quant(jnp.asarray(x), 4))
    np.testing.assert_array_equal(
        tq.fake_quant(torch.from_numpy(x), 4).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bits", [1, 4, 8, 31])
def test_fake_quant_ste_op_matches_jax(dtype, bits):
    """K1's straight-through op (``ops.fake_quant_ste``, the CUDA route of
    ``core.quantization.fake_quant``) on the CPU equals the JAX package's
    ``fake_quant`` bit for bit, in f32, bf16 and f16, with a constant channel
    (the 1e-8 span guard) among the others; its gradient is the
    identity, in x's dtype."""
    x = _normal(40 + bits, (3, 40, 24), scale=2.0)
    x[:, :, 7] = 0.375
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(j_fake_quant(jx, bits).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    out = tops.fake_quant_ste(tx, bits)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    np.testing.assert_array_equal(
        fake_quant_2d(tx.detach().reshape(-1, 24), bits, ste=True)
        .float().numpy(), want.reshape(-1, 24))
    (g,) = torch.autograd.grad((out.float() * 3.0).sum(), tx)
    assert g.dtype == tx.dtype
    np.testing.assert_array_equal(g.float().numpy(), np.full(x.shape, 3.0))


def test_fake_quant_plain_keeps_the_dtype():
    """K1's plain mode on bf16 is the f32 quantize-dequantize rounded to
    bf16 once (the TPU kernel's ``out.astype(o_ref.dtype)``)."""
    x = torch.from_numpy(_normal(9, (64, 40))).to(torch.bfloat16)
    got = fake_quant_2d(x, 4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fake_quant_ref(x.float(), 4).to(torch.bfloat16))
    assert torch.equal(fake_quant_2d(x, 32), x)


@pytest.mark.parametrize("R,C,itemsize", [
    (3072, 256, 4), (3072, 256, 2), (32768, 896, 2), (32768, 4864, 2),
    (32768, 4864, 4), (32768, 3072, 2), (2560, 256000, 4), (8, 896, 2),
    (3001, 257, 2), (7, 33, 4), (1, 5, 4), (100_003, 12, 2)])
def test_fake_quant_plan_covers_the_tensor(R, C, itemsize):
    """K1's grid: the slabs cover every row once (a ragged last slab
    included), the channel tiles every channel (C not a multiple of the
    vector included), the fold of pass 2 stays within an eighth of a
    slab's bytes, one slab means one fused launch, and the prefills'
    activations put at least two blocks on every SM."""
    p = tfq.plan(R, C, itemsize)
    tile = tfq.LANES * 16 // itemsize
    assert p.slab_rows % tfq.ROWS == 0
    assert (p.n_slabs - 1) * p.slab_rows < R <= p.n_slabs * p.slab_rows
    assert (p.n_ctiles - 1) * tile < C <= p.n_ctiles * tile
    assert p.n_slabs == 1 or 8 * p.n_slabs ** 2 <= R * itemsize / 8
    assert p.fused == (p.n_slabs == 1)
    if R >= 32768 and C >= 896:
        assert p.n_ctiles * p.n_slabs >= 2 * tfq.SMS


@pytest.mark.parametrize("B,S,C,chunk,itemsize", [
    (1, 32768, 2560, 128, 4), (1, 4096, 2560, 128, 4),
    (1, 65536, 256, 16, 4), (2, 1000, 2600, 16, 4), (3, 48, 99, 128, 2),
    (2, 300, 200, 32, 2), (1, 1, 1, 1, 4), (1, 4096, 2560, 256, 4),
    (1, 4096, 2560, 256, 2)])
def test_rglru_scan_plan_covers_the_scan(B, S, C, chunk, itemsize):
    """K7's one launch: the chunks cover every token once (a short last
    chunk included), the slabs every channel (a ragged last slab
    included), one block per (chunk, batch row, slab), a tile's a and b
    within a block's shared memory, one state word per (chunk but the
    last, batch row, channel); at the recurrentgemma-2b prefill 5,120
    tiles of 128 KB and 652,800 words (5.2 MB, against the three-pass
    kernel's 3 x B x NC x C floats)."""
    p = trg.plan(B, S, C, chunk, itemsize)
    assert p.slab % 32 == 0 and 32 <= p.slab <= trg.SLAB
    assert p.slab == trg.SLAB or 2 * chunk * (p.slab + 32) * itemsize \
        > trg.SMEM_BYTES
    assert (p.n_chunks - 1) * chunk < S <= p.n_chunks * chunk
    assert (p.n_slabs - 1) * p.slab < C <= p.n_slabs * p.slab
    assert p.tiles == p.n_chunks * B * p.n_slabs <= trg.MAX_TILES
    assert p.smem_bytes == 2 * chunk * p.slab * itemsize <= trg.SMEM_BYTES
    assert p.state_words == (p.n_chunks - 1) * B * C
    if (B, S, C) == (1, 32768, 2560):
        assert (p.tiles, p.smem_bytes, p.state_words) == (5120, 131072,
                                                          652800)
        assert 8 * p.state_words < 3 * 4 * B * p.n_chunks * C
    src = (build.CSRC / "rglru_scan.cu").read_text()
    assert "#define LRU_MAX_THREADS 256" in src and p.slab <= 256


def test_rglru_scan_plan_refuses_what_does_not_fit():
    """Slabs narrow (by 32 channels) to fit a longer chunk, down to 32;
    past that, or past the grid, the plan raises."""
    with pytest.raises(ValueError, match="chunk 0 < 1"):
        trg.plan(1, 64, 32, 0, 4)
    assert trg.plan(1, 4096, 2560, 226, 4).slab == 128
    assert trg.plan(1, 4096, 2560, 227, 4).slab == 96
    biggest = trg.SMEM_BYTES // (2 * 32 * 4)
    assert trg.plan(1, 4096, 2560, biggest, 4).slab == 32
    with pytest.raises(ValueError, match=f"chunk {biggest + 1} needs"):
        trg.plan(1, 4096, 2560, biggest + 1, 4)
    with pytest.raises(ValueError, match="tiles"):
        trg.plan(64, 2 ** 20, 2 ** 16, 1, 4)


def test_rglru_scan_workspace_takes_a_new_epoch_per_call():
    """The state words and the ticket are zeroed once, when the
    workspace is made or grown; every call then takes a new epoch, so no
    call needs a memset. One workspace per (device, stream)."""
    dev, key = torch.device("cpu"), (None, -1)
    trg._WORK.pop(key, None)
    try:
        w1, e1 = trg._workspace(dev, -1, 10)
        w2, e2 = trg._workspace(dev, -1, 4)
        assert w2 is w1 and (e1, e2) == (1, 2) and w1.numel() == 11
        assert not w1.any()
        w1[3] = (2 << 32) | 5
        w3, e3 = trg._workspace(dev, -1, 30)
        assert w3 is not w1 and e3 == 1 and w3.numel() == 31
        assert not w3.any()
        w4, e4 = trg._workspace(dev, -1, 31)
        assert w4.numel() == 62 and e4 == 1
        trg._WORK[key][1] = 2 ** 32 - 1
        w5, e5 = trg._workspace(dev, -1, 2)
        assert e5 == 1 and w5 is not w4 and not w5.any()
        w6, e6 = trg._workspace(dev, -2, 2)
        assert w6 is not w5 and e6 == 1
    finally:
        trg._WORK.pop(key, None)
        trg._WORK.pop((None, -2), None)


def test_fake_quant_vector_path_needs_aligned_rows():
    """16-byte loads only where x starts on 16 bytes and its width and
    row stride are multiples of the vector; other views take the
    kernels' scalar path."""
    wide = torch.zeros((16, 72), dtype=torch.bfloat16)
    assert tfq.vector_ok(wide[:, :64])
    assert tfq.vector_ok(wide[:, 8:72])
    assert not tfq.vector_ok(wide[:, 3:67])
    assert not tfq.vector_ok(wide[:, :60])
    assert not tfq.vector_ok(torch.zeros((16, 70))[:, :64])


@pytest.mark.parametrize("B,clusters", [
    (1, 1), (32, 4), (37, 5), (64, 8), (128, 16), (200, 25)])
@pytest.mark.parametrize("D1,D2", [(400, 300), (40, 30), (12, 7)])
def test_mlp3_plan_splits_rows_and_columns(B, clusters, D1, D2):
    """K2's cluster plan: row tiles of 8 covering B (a ragged last tile
    at B 1 and 37), and column slices that are multiples of 4 and cover
    D1 and D2 within the cluster's 8 CTAs."""
    n1, n2 = mlp3_plan(D1, D2)
    assert tmf.ROWS == 8 and -(-B // tmf.ROWS) == clusters
    assert (clusters - 1) * tmf.ROWS < B <= clusters * tmf.ROWS
    for d, n in ((D1, n1), (D2, n2)):
        assert n % 4 == 0 and n > 0
        assert d <= tmf.CLUSTER * n < d + 32


# --------------------------------------------------------------------------
# K2 fused 3-layer MLP
# --------------------------------------------------------------------------

def _mlp_params(seed, dims):
    rng = np.random.default_rng(seed)
    return [{"w": rng.uniform(-0.3, 0.3, (a, b)).astype(np.float32),
             "b": rng.uniform(-0.1, 0.1, (b,)).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])]


def _torch_params(params, grad=False):
    return [{k: torch.from_numpy(v.copy()).requires_grad_(grad)
             for k, v in l.items()} for l in params]


@pytest.mark.parametrize("B,dims,final", [
    (16, (33, 400, 300, 3), "sigmoid"),     # paper actor trunk (pq)
    (16, (36, 400, 300, 1), "linear"),      # paper critic trunk (pq)
    (13, (33, 32, 24, 3), "sigmoid"),       # the tests' hidden (32, 24)
    (13, (36, 32, 24, 1), "linear"),
])
def test_mlp3_forward_matches_jax(B, dims, final):
    params = _mlp_params(B, dims)
    x = _normal(B + 1, (B, dims[0]))
    want = np.asarray(jops.fused_mlp3(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), final=final))
    got = tops.fused_mlp3(_torch_params(params), torch.from_numpy(x),
                          final=final)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("final", ["linear", "sigmoid"])
def test_mlp3_backward_matches_jax(final):
    dims = (9, 40, 30, 3)
    params = _mlp_params(7, dims)
    x = _normal(8, (24, dims[0]))

    def loss(p, x):
        return jnp.sum(jops.fused_mlp3(p, x, final=final) ** 2)

    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = _torch_params(params, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tops.fused_mlp3(tp, tx, final=final)
    leaves = [tx] + [l[k] for l in tp for k in ("w", "b")]
    grads = torch.autograd.grad((y ** 2).sum(), leaves)
    want = [jg_x] + [jg_p[i][k] for i in range(3) for k in ("w", "b")]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_mlp3_backward_skips_unrequested_grads():
    """Frozen weights (the critic inside the actor loss) get no gradient,
    and the input's gradient is the one the full backward gives."""
    dims = (9, 40, 30, 1)
    params = _mlp_params(5, dims)
    x = _normal(6, (24, dims[0]))
    full = _torch_params(params, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    want = torch.autograd.grad(tops.fused_mlp3(full, tx).sum(), tx)[0]
    frozen = _torch_params(params, grad=False)
    tx2 = torch.from_numpy(x).requires_grad_(True)
    tops.fused_mlp3(frozen, tx2).sum().backward()
    assert torch.equal(tx2.grad, want)
    assert all(l[k].grad is None for l in frozen for k in ("w", "b"))


def test_mlp3_emits_hidden_activations():
    dims = (5, 12, 8, 2)
    params = _mlp_params(3, dims)
    x = torch.from_numpy(_normal(4, (6, 5)))
    flat = [torch.from_numpy(l[k]) for l in params for k in ("w", "b")]
    y, h1, h2 = mlp3(x, *flat, sigmoid=True)
    assert (y.shape, h1.shape, h2.shape) == ((6, 2), (6, 12), (6, 8))
    assert bool((h1 >= 0).all()) and bool((h2 >= 0).all())


# --------------------------------------------------------------------------
# K3 Polyak
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(33, 400, 300, 3), (36, 32, 24, 1)])
def test_polyak_matches_jax(dims):
    target, online = _mlp_params(1, dims), _mlp_params(2, dims)
    want = jops.fused_polyak(jax.tree.map(jnp.asarray, target),
                             jax.tree.map(jnp.asarray, online), 0.01)
    got = tops.fused_polyak(_torch_params(target), _torch_params(online),
                            0.01)
    for wl, gl in zip(want, got):
        for k in wl:
            assert gl[k].shape == wl[k].shape
            np.testing.assert_allclose(gl[k].numpy(), np.asarray(wl[k]),
                                       rtol=1e-6, atol=1e-6)


def test_polyak_both_networks_in_one_call_match_jax():
    """The DDPG update's target actor and critic (the paper's widths, pq
    state and actions) through one ``fused_polyak_nets`` call, each leaf
    against the JAX ``ops.fused_polyak`` of its own network."""
    dims = {"actor": (33, 400, 300, 3), "critic": (36, 400, 300, 1)}
    targets = [_mlp_params(10 + i, d) for i, d in enumerate(dims.values())]
    onlines = [_mlp_params(20 + i, d) for i, d in enumerate(dims.values())]
    got = tops.fused_polyak_nets([_torch_params(t) for t in targets],
                                 [_torch_params(o) for o in onlines], 0.01)
    assert len(got) == 2
    for net, t, o in zip(got, targets, onlines):
        want = jops.fused_polyak(jax.tree.map(jnp.asarray, t),
                                 jax.tree.map(jnp.asarray, o), 0.01)
        for wl, gl in zip(want, net):
            assert sorted(gl) == sorted(wl)
            for k in wl:
                assert gl[k].shape == wl[k].shape
                np.testing.assert_allclose(gl[k].numpy(), np.asarray(wl[k]),
                                           rtol=1e-6, atol=1e-6)


def test_polyak_leaves_on_the_cpu_are_the_plain_version_per_leaf():
    """A CPU leaf takes the plain version, leaf by leaf (the flat buffer
    of the old path gave the same numbers: the update is elementwise),
    and nothing launches."""
    build.reset_launches()
    shapes = [(7,), (3, 5), (1,), (33, 400), (2, 2, 2)]
    t = [torch.from_numpy(_normal(30 + i, sh)) for i, sh in enumerate(shapes)]
    p = [torch.from_numpy(_normal(40 + i, sh)) for i, sh in enumerate(shapes)]
    got = polyak_leaves(t, p, 0.3)
    flat = polyak_ref(torch.cat([x.reshape(-1) for x in t]),
                      torch.cat([x.reshape(-1) for x in p]), 0.3)
    off = 0
    for g, a, b in zip(got, t, p):
        assert torch.equal(g, polyak_ref(a, b, 0.3))
        assert torch.equal(g.reshape(-1), flat[off:off + a.numel()])
        off += a.numel()
    assert build.LAUNCHES["polyak"] == 0


def test_polyak_leaves_refuse_other_devices_and_bad_tables():
    meta = [torch.empty(4, device="meta")]
    with pytest.raises(ValueError, match="CUDA"):
        polyak_leaves(meta, meta, 0.1)
    with pytest.raises(ValueError, match="leaves"):
        polyak_leaves(meta * 33, meta * 33, 0.1)
    with pytest.raises(ValueError, match="online"):
        polyak_leaves(meta * 2, meta, 0.1)


# --------------------------------------------------------------------------
# Routing: a CPU tensor takes the plain version, nothing else does
# --------------------------------------------------------------------------

def test_wrappers_route_cpu_to_plain_without_launching():
    build.reset_launches()
    x = torch.from_numpy(_normal(0, (8, 4)))
    assert torch.equal(fake_quant_2d(x, 4), fake_quant_ref(x, 4))
    xs = x.expand(3, 8, 4)
    assert torch.equal(fake_quant_slots(xs, (4, 32, 2)),
                       fake_quant_slots_ref(xs, (4, 32, 2)))
    from repro_torch.kernels.fake_quant import fake_quant_slots_dev
    assert torch.equal(fake_quant_slots_dev(xs, torch.tensor(
        [4, 32, 2], dtype=torch.int32)), fake_quant_slots_ref(xs, (4, 32, 2)))
    t, p = torch.ones(10), torch.zeros(10)
    assert torch.equal(polyak_leaves([t], [p], 0.5)[0],
                       polyak_ref(t, p, 0.5))
    params = _mlp_params(0, (4, 6, 5, 2))
    flat = [torch.from_numpy(l[k]) for l in params for k in ("w", "b")]
    for a, b in zip(mlp3(x, *flat, sigmoid=False),
                    mlp3_ref(x, *flat, False)):
        assert torch.equal(a, b)
    xq = torch.ones((8, 6), dtype=torch.int8)
    s8, s4 = torch.ones(8), torch.ones(4)
    for packed, rows in ((False, 6), (True, 3)):
        wq = torch.ones((rows, 4), dtype=torch.int8)
        assert torch.equal(
            quant_matmul(xq, wq, s8, s8, s4, s4, packed=packed),
            quant_matmul_ref(xq, wq, s8, s8, s4, s4, packed=packed))
    q = torch.from_numpy(_normal(1, (1, 4, 8, 16)))
    kv = torch.from_numpy(_normal(2, (1, 2, 8, 16)))
    assert torch.equal(flash_attention(q, kv, kv), attention_ref(q, kv, kv))
    xh, dA = torch.from_numpy(_normal(3, (1, 8, 2, 4))), -torch.ones(1, 8, 2)
    bc = torch.from_numpy(_normal(4, (1, 8, 4)))
    for a, b in zip(ssd_scan(xh, dA, bc, bc, chunk=4),
                    ssd_chunked_ref(xh, dA, bc, bc, 4)):
        assert torch.equal(a, b)
    a = torch.from_numpy(_normal(5, (2, 8, 4))).sigmoid()
    h0 = torch.from_numpy(_normal(6, (2, 4)))
    assert torch.equal(rglru_scan(a, bc[:, :, :4].expand(2, 8, 4), h0),
                       rglru_scan_ref(a, bc[:, :, :4].expand(2, 8, 4), h0))
    assert build.LAUNCHES == {"fake_quant": 0, "fake_quant_slots": 0,
                              "fake_quant_slots_dev": 0,
                              "mlp3": 0, "mlp3_members": 0, "polyak": 0,
                              "adam_polyak": 0,
                              "quant_matmul_int8": 0,
                              "quant_matmul_int4": 0, "quant_matmul_tc": 0,
                              "flash_attention": 0,
                              "flash_attention_tc": 0, "ssd_scan": 0,
                              "ssd_scan_tc": 0, "rglru_scan": 0}


def test_wrappers_refuse_other_devices():
    """A tensor off the CPU never takes the plain version: a non-CUDA
    device (here ``meta``) is refused before any launch."""
    x = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fake_quant_2d(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fake_quant_slots(x.expand(2, 8, 4), (4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        polyak_leaves([torch.empty(4, device="meta")],
                      [torch.empty(4, device="meta")], 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        mlp3(x, *[torch.empty(s, device="meta") for s in
                  ((4, 6), (6,), (6, 5), (5,), (5, 2), (2,))])
    with pytest.raises(ValueError, match="CUDA"):
        quant_matmul(torch.empty((8, 4), dtype=torch.int8, device="meta"),
                     torch.empty((4, 2), dtype=torch.int8, device="meta"),
                     *[torch.empty(n, device="meta") for n in (8, 8, 2, 2)])
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(x[None], x[None])


def test_flash_attention_takes_head_dims_up_to_256():
    """K6 is built for head dims 16 to 256; 256 is recurrentgemma-2b's
    (its own 32 x 32 tile instantiation in ``csrc/flash_attention.cu``),
    80 hubert-xlarge's (the CUDA-core template, f32 and bf16)."""
    assert HEAD_DIMS == (16, 32, 64, 80, 128, 256)
    src = (build.CSRC / "flash_attention.cu").read_text()
    for d in HEAD_DIMS:
        assert f"case {d}: return launch<T, {d}>" in src


def test_kernel_sources_carry_their_notes():
    # the fused Adam + Polyak pass has no Pallas counterpart (the JAX
    # package computes it with jnp); its note says so and names the pass
    no_pallas = {"adam_polyak": "src/repro/core/ddpg.py: _fused_adam_polyak"}
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        if name in no_pallas:
            assert "Replaces: no Pallas kernel" in src, name
            assert no_pallas[name] in src, name
        else:
            assert "Replaces: src/repro/kernels/" in src, name
        assert "Bound on the H100" in src, name
        assert "Design:" in src, name
        assert 'extern "C" int' in src, name
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


# --------------------------------------------------------------------------
# K4/K5's routes and the tensor-core route's plan
# --------------------------------------------------------------------------

# (M, K, N, packed, route): the calibration's 256³, the testbed's units at
# 192 tokens, granite-3-8b's MLP, ragged M and N on aligned strides, a K
# past a whole number of K tiles; the JAX tests' ragged N and K, an odd K
# padded for int4 (302 codes) and an empty K on the CUDA-core route.
QM_ROUTES = [
    (256, 256, 256, False, "tc"), (256, 256, 256, True, "tc"),
    (192, 256, 512, False, "tc"), (192, 256, 2048, True, "tc"),
    (192, 1024, 256, False, "tc"), (32, 4096, 25600, True, "tc"),
    (4096, 4096, 25600, False, "tc"), (200, 512, 144, False, "tc"),
    (64, 4112, 256, True, "tc"), (33, 512, 257, False, "simt"),
    (200, 300, 130, True, "simt"), (64, 301, 96, False, "simt"),
    (64, 302, 96, True, "simt"), (8, 0, 16, False, "simt")]


@pytest.mark.parametrize("M,K,N,packed,want", QM_ROUTES)
def test_quant_matmul_route_is_chosen_by_shape(M, K, N, packed, want):
    assert tqm.route(M, K, N, packed) == want


def test_quant_matmul_route_takes_misaligned_views_to_the_cuda_cores():
    """Contiguous codes whose base is off 16 bytes cannot feed TMA: the
    CUDA-core route takes them (nothing is copied)."""
    xq = torch.zeros(1 + 64 * 256, dtype=torch.int8)
    wq = torch.zeros(1 + 256 * 128, dtype=torch.int8)
    aligned = (xq[:64 * 256].view(64, 256), wq[:256 * 128].view(256, 128))
    shifted = (xq[1:].view(64, 256), wq[1:].view(256, 128))
    assert aligned[0].data_ptr() % 16 == 0
    assert aligned[1].data_ptr() % 16 == 0
    assert tqm.route(64, 256, 128, False, *aligned) == "tc"
    assert tqm.route(64, 256, 128, False, shifted[0], aligned[1]) == "simt"
    assert tqm.route(64, 256, 128, False, aligned[0], shifted[1]) == "simt"


# (M, K, N, packed) -> (split, stages, blocks): splits only where the
# tiles leave the card idle and a block saves >= SPLIT_COST K tiles; the
# deepest load ring that fits where a block walks many K tiles.
QM_PLANS = [
    ((256, 256, 256, False), (1, 2, 4)),
    ((192, 256, 512, True), (1, 2, 8)),
    ((192, 256, 2048, False), (1, 2, 32)),
    ((192, 1024, 256, False), (8, 2, 32)),
    ((32, 4096, 25600, False), (1, 5, 200)),
    ((32, 4096, 25600, True), (1, 6, 200)),
    ((4096, 4096, 25600, False), (1, 5, 6400)),
    ((4096, 4096, 25600, True), (1, 6, 6400)),
    ((200, 512, 144, False), (4, 2, 16)),
    ((64, 4112, 256, True), (8, 5, 16))]


@pytest.mark.parametrize("shape,want", QM_PLANS)
def test_quant_matmul_plan_at_the_path_shapes(shape, want):
    p = tqm.plan(*shape)
    assert (p.split, p.stages, p.blocks) == want
    M, K, N, _ = shape
    assert (p.tiles_m, p.tiles_n, p.k_tiles) == (
        -(-M // 128), -(-N // 128), -(-K // 128))


@pytest.mark.parametrize("M,N", [(1, 16), (32, 4096), (200, 144),
                                 (1024, 1024), (4096, 25600)])
@pytest.mark.parametrize("K", [16, 256, 1040, 4096, 16384, 131_056])
def test_quant_matmul_plan_keeps_its_terms(M, K, N):
    """Whatever the shape: a split in SPLITS, at most the K tiles (no
    block without one) and only within one wave; the load ring within
    2 .. MAX_STAGES; one block per (tile, split)."""
    for packed in (False, True):
        p = tqm.plan(M, K, N, packed)
        assert p.split in tqm.SPLITS and p.split <= p.k_tiles
        assert p.split == 1 or p.blocks <= tqm.SMS
        assert 2 <= p.stages <= tqm.MAX_STAGES[packed]
        assert p.blocks == p.tiles_m * p.tiles_n * p.split


def test_quant_matmul_plan_refuses_k_past_the_int32_accumulator():
    assert tqm.plan(1, tqm.MAX_K, 16).k_tiles == 1024
    with pytest.raises(ValueError, match="overflow"):
        tqm.plan(1, tqm.MAX_K + 16, 16)


def test_quant_matmul_plan_refuses_splits_it_cannot_run():
    assert tqm.plan(64, 1024, 256, split=8).split == 8
    with pytest.raises(ValueError, match="split"):
        tqm.plan(64, 1024, 256, split=3)
    with pytest.raises(ValueError, match="split"):
        tqm.plan(64, 256, 256, split=4)      # 2 K tiles


# --------------------------------------------------------------------------
# K8's routes and its split TF32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("P,N,chunk,want", [
    (64, 128, 256, "tc"), (64, 64, 128, "tc"), (64, 128, 64, "tc"),
    (64, 128, 100, "simt"), (64, 32, 256, "simt"), (64, 256, 256, "simt"),
    (32, 128, 256, "simt"), (16, 8, 16, "simt"), (8, 8, 32, "simt")])
def test_ssd_route_is_chosen_by_shape(P, N, chunk, want):
    """mamba2's full-width heads (P 64, N 128, chunk 256) take the
    tensor-core route; the JAX tests' small shapes the CUDA cores."""
    assert ssd_route(P, N, chunk) == want


def test_ssd_tma_terms_refuse_views_tma_cannot_read():
    wide = torch.zeros((2, 40, 2 * 128 + 8))
    check_tma_terms(wide[..., 8:136], "Bm")          # strides 264, 10560
    with pytest.raises(ValueError, match="multiples of 4"):
        check_tma_terms(torch.zeros((2, 40, 130))[..., 2:130], "Bm")
    with pytest.raises(ValueError, match="aligned"):
        check_tma_terms(wide[..., 9:137], "Cm")
    with pytest.raises(ValueError, match="last stride"):
        check_tma_terms(wide.transpose(1, 2)[:, :40, :40], "Cm")


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest) by masking."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, split):
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def _ssd_tf32(xh, dA, Bm, Cm, L, split):
    """``ref.ssd_chunked_ref`` (S a multiple of L, zero initial state)
    with K8's four products, C·Bᵀ, scores·X, (B ⊙ decay)ᵀ·X and
    C·stateᵀ, on TF32 operands: split (hi·hi + lo·hi + hi·lo, as the
    tensor-core route) or plain."""
    b, s, h, p = xh.shape
    n, c = Bm.shape[-1], s // L
    X = xh.reshape(b, c, L, h, p).permute(0, 3, 1, 2, 4)      # [b,h,c,l,p]
    A = dA.reshape(b, c, L, h).permute(0, 3, 1, 2)             # [b,h,c,l]
    Bc, Cc = Bm.reshape(b, c, L, n), Cm.reshape(b, c, L, n)
    A_cum = torch.cumsum(A, -1)
    CB = _tf32_matmul(Cc, Bc.transpose(-1, -2), split)         # [b,c,l,l]
    y_diag = _tf32_matmul(CB[:, None] * torch.exp(tref.segsum(A)), X, split)
    dec = torch.exp(A_cum[..., -1:] - A_cum)
    states = _tf32_matmul((Bc[:, None] * dec[..., None]).transpose(-1, -2),
                          X, split)                            # [b,h,c,n,p]
    prev, prevs = torch.zeros_like(states[:, :, 0]), []
    for ci in range(c):
        prevs.append(prev)
        prev = states[:, :, ci] + torch.exp(
            A_cum[:, :, ci, -1])[..., None, None] * prev
    y_off = _tf32_matmul(Cc[:, None], torch.stack(prevs, 2), split) \
        * torch.exp(A_cum)[..., None]
    return (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(b, s, h, p)


def test_split_tf32_holds_k8_to_2e4_where_plain_tf32_misses():
    """Why the tensor-core route splits every operand: at the magnitudes
    of ``chip_smoke.py``'s slow-decay check (mamba2's head dim 64 and
    state 128, dA in [-0.01, 0], the state carried over chunks, y up to
    ~5 x 10^2), K8's four products on split TF32 operands stay within
    the JAX tests' 2e-4 of the chunked plain branch; on plain TF32
    operands (10 mantissa bits) they miss it by three orders."""
    rng = np.random.default_rng(11)
    S, H = 1024, 2
    xh, Bm, Cm = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((1, S, H, 64), (1, S, 128), (1, S, 128)))
    dA = torch.from_numpy(-rng.uniform(0, 0.01, (1, S, H)).astype(
        np.float32))
    want, _ = ssd_chunked_ref(xh, dA, Bm, Cm, 256)
    assert float(want.abs().max()) > 100
    split = _ssd_tf32(xh, dA, Bm, Cm, 256, True)
    plain = _ssd_tf32(xh, dA, Bm, Cm, 256, False)
    torch.testing.assert_close(split, want, atol=2e-4, rtol=2e-4)
    assert not torch.allclose(plain, want, atol=2e-4, rtol=2e-4)
    assert float((plain - want).abs().max()) > 100 * float(
        (split - want).abs().max())


def test_ptxas_summary_gives_each_kernel_its_own_spills():
    """ptxas prints a function's spills before its register count; the
    summary matches them to the function by name, so one kernel's spills
    are never given to the kernel compiled before it."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1aPf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 1024 bytes smem",
        "ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1bPf",
        "    48 bytes stack frame, 48 bytes spill stores, 48 bytes spill "
        "loads",
        "ptxas info    : Used 168 registers"])
    assert build._ptxas_summary(log) == [
        {"kernel": "_Z1aPf", "registers": 40, "smem_bytes": 1024,
         "spill_store_bytes": 0},
        {"kernel": "_Z1bPf", "registers": 168, "smem_bytes": 0,
         "spill_store_bytes": 48}]
