"""The hand-written CUDA kernels against their plain PyTorch versions, on
a card. Every test here carries the ``gpu`` marker and skips without
CUDA (decided in a fixture, never at import).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch. There, skip the repo's ``conftest.py``
(it imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: K1 (fake-quant, f32 and bf16, plain and straight-through;
one tensor or K policy slots, each slot against the plain version of
its own slice), K3 (Polyak) and the fused Adam + Polyak pass exact — the
plain versions run the same correctly rounded f32 operations, one
PyTorch kernel each; K2's member form bit-equal to one-network launches
on each member's slices;
K2 (3-layer MLP) forward and backward ≤1e-5 at the DDPG init's scales
(f32 sums in another order; no TF32); K4/K5 (quantized matmul) exact —
integer products are exact on both sides and the epilogue is the same
correctly rounded f32 steps in the same order; K6 (flash attention)
against the dense ``attention_ref`` at the JAX package's tolerances,
f32 atol 2e-5 and bf16 atol 0.04 (online vs one-pass softmax, sums in
other orders, p rounded to bf16 before P.V); in bf16 also each output
row within 2^-6 relative (``chip_smoke.py``'s ``K6_ROW_TOL``: 0.04 alone
is near the size of a late row's values at S 4096); K8 (SSD scan) at the
JAX tests' 2e-4 (atol and rtol) on y and the final state against both
plain versions where the decays are mild (dA in [-0.5, 0]) and against
the chunked plain version at a slow decay (dA in [-0.01, 0], the state
carried over 16 chunks), and there each (token, head) row within 2^-10
relative of the sequential one (``chip_smoke.py``'s ``K8_ROW_TOL``); K7
(RG-LRU scan) exact against the sequential plain version where S fits one
chunk (the same correctly rounded multiply and add per step), and where
the state is carried between chunks at the JAX tests' atol 2e-5 (the
carried state is rounded in another order), at the path's slow decay (a
in [0.9487, 0.9995]) each (token, 256-channel block) row within 2^-12
relative (``chip_smoke.py``'s ``K7_ROW_TOL``), in bf16 within one bf16
rounding (2^-8 relative) of the f32 plain version; and everywhere bit for
bit equal to the former three-launch kernel at the same chunk
(``tools/k7_three_pass.cu``: the same steps in the same order). The
training path: K1 under autograd exact in its forward, its gradient the
upstream one bit for bit; one qwen2-0.5b SMOKE train step (f32) on the
card against the CPU's plain route, loss 1e-5, gradients 1e-6 (f32 sums
in other orders), updated leaves 1e-5, and the QAT step's loss within
``chip_smoke.QAT_LOSS_TOL``. The trainer path: K6, K7 and K8 under
autograd, the forward bit-equal to the no-grad launch and each gradient
the plain chain's on the same tensors (bit-equal, or within
``chip_smoke.AUTOGRAD_REL_TOL`` of the largest element). The slicer
and the fleet: granite-3-8b's SMOKE sliced forward (f32) within
``chip_smoke.SLICE_SMOKE_TOL`` of the masked one on the card and in
argmax agreement >= 0.99 with the CPU's; a fleet resumed on the card
bit for bit equal to its uninterrupted run.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops as tops  # noqa: E402
from repro_torch.kernels.fake_quant import fake_quant_2d  # noqa: E402
from repro_torch.kernels.fake_quant import fake_quant_slots  # noqa: E402
from repro_torch.kernels.fake_quant import plan as fake_quant_plan  # noqa: E402
from repro_torch.kernels.fake_quant import (  # noqa: E402
    vector_ok as fake_quant_vector_ok)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.mlp_fused import mlp3, polyak_leaves  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.quant_matmul import route as qm_route  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import route as ssd_route  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ref import (fake_quant_ref,  # noqa: E402
                                     fake_quant_slots_ref,
                                     fake_quant_ste_ref, mlp3_ref,
                                     polyak_ref)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _mlp_params(seed, dims):
    """The DDPG init's scales (±1/sqrt(fan-in), final layer ±3e-3) with
    small random biases. At these scales a pre-activation that rounds to
    the other side of 0 in one version (a flipped relu mask, which moves
    a whole gradient entry) changes the gradients by less than 1e-5."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        lim = 3e-3 if i == len(dims) - 2 else 1 / np.sqrt(a)
        out.append({"w": rng.uniform(-lim, lim, (a, b)).astype(np.float32),
                    "b": rng.uniform(-0.1, 0.1, (b,)).astype(np.float32)})
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; on the card run "
                    "python3 chip_smoke.py or this file with -m gpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3072, 256), (3072, 1024), (256, 128),
                                   (1024, 256), (7, 33)])
@pytest.mark.parametrize("bits", [2, 4, 6, 8, 32])
def test_gpu_fake_quant_kernel_exact(cuda, shape, bits):
    x = torch.from_numpy(_normal(bits, shape)).to(cuda)
    before = build.LAUNCHES["fake_quant"]
    got = fake_quant_2d(x, bits)
    assert build.LAUNCHES["fake_quant"] == before + 1
    assert torch.equal(got, fake_quant_ref(x, bits))


def _planted_range(x, dtype):
    """x with channel 5's minimum in its first row and its maximum in its
    last (different slabs of K1's plan), both outside every other value:
    a dropped or misplaced partial moves the whole channel."""
    x = x.clone()
    x[0, 5], x[-1, 5] = -9.0, 11.0
    return x.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3072, 256), (3001, 896), (32768, 896),
                                   (4096, 257), (8, 896), (2560, 4099)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bits", [1, 4, 8, 31, 32])
def test_gpu_fake_quant_dtypes_and_ste_exact(cuda, shape, dtype, bits):
    """K1 in f32, bf16 and f16, plain and straight-through, bit for bit its
    plain versions, at shapes of several slabs (a ragged last slab, C not
    a multiple of the vector: the scalar path) and of one (the fused
    launch); the straight-through mode equals the chain of
    ``core.quantization.fake_quant``, ``(xf + (xq - xf)).to(dtype)``."""
    dt = getattr(torch, dtype)
    x = _planted_range(torch.from_numpy(_normal(bits, shape)).to(cuda), dt)
    p = fake_quant_plan(*shape, x.element_size())
    assert p.fused == (shape[0] <= 256)
    before = build.LAUNCHES["fake_quant"]
    got = fake_quant_2d(x, bits)
    ste = fake_quant_2d(x, bits, ste=True)
    assert build.LAUNCHES["fake_quant"] == before + 2
    assert got.dtype == ste.dtype == dt
    assert torch.equal(got, fake_quant_ref(x, bits))
    xf = x.float()
    chain = x.clone() if bits >= 32 else \
        (xf + (fake_quant_ref(xf, bits) - xf)).to(dt)
    assert torch.equal(ste, chain)
    assert torch.equal(ste, fake_quant_ste_ref(x, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("offset,width", [(8, 896), (3, 896), (0, 893)])
def test_gpu_fake_quant_reads_row_views_in_place(cuda, dtype, offset, width):
    """A view of rows with a longer row stride is read in place: 16-byte
    loads where its start and stride allow them, the scalar path where
    its start is off 16 bytes or its width is ragged; both exact."""
    dt = getattr(torch, dtype)
    wide = torch.from_numpy(_normal(3, (3001, 904))).to(cuda).to(dt)
    x = wide[:, offset:offset + width]
    assert fake_quant_vector_ok(x) == (offset == 8)
    for ste in (False, True):
        got = fake_quant_2d(x, 4, ste=ste)
        want = (fake_quant_ste_ref if ste else fake_quant_ref)(
            x.contiguous(), 4)
        assert torch.equal(got, want)


SLOT_BITS = (1, 4, 32, 8, 31, 2, 6, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("K,R,C", [(8, 3072, 256), (8, 3072, 1024),
                                   (8, 256, 1024), (3, 7, 33), (8, 8, 896),
                                   (64, 96, 64), (2, 3001, 257)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shared", [False, True])
def test_gpu_fake_quant_slots_exact(cuda, K, R, C, dtype, shared):
    """K1 over K policy slots, plain and straight-through, one launch each,
    bit for bit the plain version slot by slot: each slot its own bits
    (some 32: copied) and its own range (a planted outlier in a different
    channel per slot), several slabs or one, ragged widths; and a weight
    shared by every slot (slot stride 0)."""
    dt = getattr(torch, dtype)
    bits = tuple(SLOT_BITS[k % len(SLOT_BITS)] for k in range(K))
    if shared:
        x = _planted_range(torch.from_numpy(_normal(K, (R, C))).to(cuda),
                           dt).expand(K, R, C)
    else:
        x = torch.from_numpy(_normal(K, (K, R, C))).to(cuda)
        for k in range(K):
            x[k, k % R, k % C] = 9.0 + k
        x = x.to(dt)
    for ste in (False, True):
        before = build.LAUNCHES["fake_quant_slots"]
        got = fake_quant_slots(x, bits, ste=ste)
        assert build.LAUNCHES["fake_quant_slots"] == before + 1
        assert got.dtype == dt and got.shape == (K, R, C)
        assert torch.equal(got, fake_quant_slots_ref(x, bits, ste))
        fn = fake_quant_ste_ref if ste else fake_quant_ref
        for k in (0, K - 1):
            assert torch.equal(got[k], fn(x[k], bits[k]))


# (rows, channels) of the ResNet path's K1 sites at 256 images: the stem's
# input (3 channels), stage 0's activations, the stages' widths, the head's
# pooled input and weight (10 classes), the widest weight, the testbed's
# 16-channel stage; C 3 and 10 are not multiples of the 4-float vector
# (the kernels' scalar path).
RESNET_SITES = [(262144, 3), (262144, 64), (65536, 128), (16384, 256),
                (4096, 512), (256, 512), (512, 10), (4608, 512), (27, 64),
                (65536, 16), (256, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,C", RESNET_SITES)
def test_gpu_fake_quant_resnet_sites_exact(cuda, R, C):
    """K1 at the ResNet's channel counts (3, 10, 16, 64, 512) and row
    counts up to 262,144, f32, plain and straight-through, bit for bit
    its plain versions: one tensor, and over 8 slots in the batched
    path's layouts (each slot's channels side by side in [R, 8·C] rows,
    read as the [8, R, C] view; a tensor shared by the slots)."""
    x = torch.from_numpy(_normal(C, (R, C))).to(cuda)
    x[0, C // 2], x[-1, C // 2] = -9.0, 11.0     # in different slabs
    for ste in (False, True):
        fn = fake_quant_ste_ref if ste else fake_quant_ref
        for bits in (2, 4, 8):
            assert torch.equal(fake_quant_2d(x, bits, ste=ste), fn(x, bits))
    bits = SLOT_BITS
    side = torch.from_numpy(_normal(C + 1, (R, 8, C))).to(cuda)
    for xs in (side.transpose(0, 1), x.expand(8, R, C)):
        for ste in (False, True):
            got = fake_quant_slots(xs, bits, ste=ste)
            assert torch.equal(got, fake_quant_slots_ref(xs, bits, ste))


@pytest.mark.gpu
def test_gpu_resnet_k1_reads_nhwc_and_hwio_in_place(cuda, monkeypatch):
    """A ResNet conv under a policy hands K1 its NHWC activation and its
    HWIO weight as they lie (the same storage, no copy before the
    launch): one tensor on the scalar forward, the slots' side-by-side
    channels and the shared weight over 8 slots on the batched one."""
    from repro_torch.kernels import fake_quant as kfq
    from repro_torch.models import resnet as R
    seen = []
    for name in ("fake_quant_2d", "fake_quant_slots"):
        def record(x, *a, _real=getattr(kfq, name), **kw):
            seen.append(x.data_ptr())
            return _real(x, *a, **kw)
        monkeypatch.setattr(kfq, name, record)
    w = torch.from_numpy(_normal(1, (3, 3, 64, 128))).to(cuda)
    x = torch.from_numpy(_normal(2, (16, 32, 32, 64))).to(cuda)
    R._conv({"w": w}, x, 2, {"w_bits": 4, "a_bits": 4})
    assert seen == [w.data_ptr(), x.data_ptr()]
    seen.clear()
    xb = torch.from_numpy(_normal(3, (16, 32, 32, 8 * 64))).to(cuda)
    R._conv({"w": w}, xb, 2, {"w_bits": SLOT_BITS, "a_bits": SLOT_BITS},
            K=8)
    assert seen == [w.data_ptr(), xb.data_ptr()]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_fake_quant_slots_reads_views_in_place(cuda, dtype):
    """Slots of a row-sliced view (16-byte loads where its start and
    strides allow, the scalar path where its start is off 16 bytes), and
    the tied head's ``embed.T`` expanded over the slots through
    ``ops.fake_quant_slots`` (copied once): all exact. Every slot at 32
    copies; more than 64 slots (a population's P·K policies) are cut into
    launches of at most 64, exact."""
    dt = getattr(torch, dtype)
    wide = torch.from_numpy(_normal(5, (4, 300, 136))).to(cuda).to(dt)
    bits = (4, 32, 2, 8)
    for offset in (8, 3):
        x = wide[:, :, offset:offset + 128]
        assert fake_quant_vector_ok(x) == (offset == 8)
        assert torch.equal(fake_quant_slots(x, bits, ste=True),
                           fake_quant_slots_ref(x.contiguous(), bits, True))
    emb = torch.from_numpy(_normal(6, (256, 256))).to(cuda).to(dt)
    head = emb.T.expand(4, 256, 256)
    assert torch.equal(tops.fake_quant_slots(head, bits),
                       fake_quant_slots_ref(head, bits, True))
    assert torch.equal(fake_quant_slots(wide, (32,) * 4), wide)
    before = build.LAUNCHES["fake_quant_slots"]
    many = tuple(range(2, 9)) * 9 + (32, 4)
    got = fake_quant_slots(emb.expand(65, 256, 256), many, ste=True)
    assert build.LAUNCHES["fake_quant_slots"] == before + 2
    assert torch.equal(got, fake_quant_slots_ref(emb.expand(65, 256, 256),
                                                 many, True))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_gpu_fake_quant_ste_op_one_launch_identity_grad(cuda, dtype):
    """``core.quantization.fake_quant`` on a CUDA activation [2, 1536, 896]
    takes K1's straight-through mode, one launch, bit for bit the CPU
    chain's values on the card, with the identity gradient."""
    from repro_torch.core.quantization import fake_quant
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_normal(4, (2, 1536, 896))).to(cuda).to(dt)
    x.requires_grad_(True)
    before = build.LAUNCHES["fake_quant"]
    out = fake_quant(x, 4)
    assert build.LAUNCHES["fake_quant"] == before + 1
    xf = x.detach().float()
    want = (xf + (fake_quant_ref(xf.reshape(-1, 896), 4).reshape(xf.shape)
                  - xf)).to(dt)
    assert out.dtype == dt and torch.equal(out.detach(), want)
    (g,) = torch.autograd.grad(out.float().sum(), x)
    assert torch.equal(g, torch.ones_like(x))


@pytest.mark.gpu
@pytest.mark.parametrize("B,dims,final", [
    (64, (33, 400, 300, 3), "sigmoid"), (64, (36, 400, 300, 1), "linear"),
    (37, (9, 40, 30, 3), "sigmoid"),
    (1, (33, 400, 300, 3), "sigmoid"), (1, (36, 400, 300, 1), "linear"),
    (37, (33, 400, 300, 3), "sigmoid"), (37, (36, 400, 300, 1), "linear"),
    (128, (33, 400, 300, 3), "sigmoid"), (128, (36, 400, 300, 1), "linear"),
    (200, (36, 400, 300, 1), "linear")])
def test_gpu_mlp3_kernel(cuda, B, dims, final):
    params = _mlp_params(B, dims)
    tp = [{k: torch.from_numpy(v).to(cuda).requires_grad_(True)
           for k, v in l.items()} for l in params]
    x = torch.from_numpy(_normal(B + 1, (B, dims[0]))).to(cuda)
    x.requires_grad_(True)
    flat = [l[k] for l in tp for k in ("w", "b")]
    for g, w in zip(mlp3(x, *flat, sigmoid=final == "sigmoid"),
                    mlp3_ref(x, *flat, final == "sigmoid")):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    yk = tops.fused_mlp3(tp, x, final=final)
    yr = mlp3_ref(x, *flat, final == "sigmoid")[0]
    gk = torch.autograd.grad((yk ** 2).sum(), [x] + flat)
    gr = torch.autograd.grad((yr ** 2).sum(), [x] + flat)
    for a, b in zip(gk, gr):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_gpu_mlp3_refuses_widths_past_shared_memory(cuda):
    """Activation tiles over a block's 227 KB are refused at launch with
    an error that names the limit, and the next launch still runs."""
    def flat(dims):
        return [torch.from_numpy(l[k]).to(cuda)
                for l in _mlp_params(0, dims) for k in ("w", "b")]

    x = torch.from_numpy(_normal(1, (16, 33))).to(cuda)
    before = build.LAUNCHES["mlp3"]
    with pytest.raises(RuntimeError, match="227 KB"):
        mlp3(x, *flat((33, 4000, 300, 1)))
    assert build.LAUNCHES["mlp3"] == before
    ok = flat((33, 400, 300, 1))
    torch.testing.assert_close(mlp3(x, *ok)[0], mlp3_ref(x, *ok, False)[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [134_803, 135_401, 1, 257])
def test_gpu_polyak_kernel_exact(cuda, n):
    t = torch.from_numpy(_normal(1, (n,))).to(cuda)
    p = torch.from_numpy(_normal(2, (n,))).to(cuda)
    assert torch.equal(polyak_leaves([t], [p], 0.01)[0],
                       polyak_ref(t, p, 0.01))


def _ddpg_leaf_shapes(S=33, A=3, hidden=(400, 300)):
    out = []
    for d0, d3 in ((S, A), (S + A, 1)):
        dims = (d0,) + hidden + (d3,)
        for a, b in zip(dims[:-1], dims[1:]):
            out += [(b,), (a, b)]
    return out


@pytest.mark.gpu
def test_gpu_polyak_both_networks_one_launch_exact(cuda):
    """The 12 leaves of the DDPG target actor and critic in one launch,
    read where they lie, bit for bit the plain version per leaf."""
    shapes = _ddpg_leaf_shapes()
    t = [torch.from_numpy(_normal(i, sh)).to(cuda)
         for i, sh in enumerate(shapes)]
    p = [torch.from_numpy(_normal(50 + i, sh)).to(cuda)
         for i, sh in enumerate(shapes)]
    before = build.LAUNCHES["polyak"]
    got = polyak_leaves(t, p, 0.01)
    assert build.LAUNCHES["polyak"] == before + 1
    for g, a, b in zip(got, t, p):
        assert g.shape == a.shape
        assert torch.equal(g, polyak_ref(a, b, 0.01))


@pytest.mark.gpu
def test_gpu_polyak_leaves_off_16_bytes_exact(cuda):
    """Leaves whose starts are not 16-byte aligned (views into one
    buffer at odd offsets) and whose sizes are not multiples of 4 take
    the element-by-element path of the same launch, exactly."""
    wide_t = torch.from_numpy(_normal(1, (70_010,))).to(cuda)
    wide_p = torch.from_numpy(_normal(2, (70_010,))).to(cuda)
    spans = ((1, 4_099), (4_101, 7), (9_003, 30_001), (40_000, 30_000),
             (3, 1))
    t = [wide_t[a:a + n] for a, n in spans]
    p = [wide_p[a + 2:a + 2 + n] for a, n in spans]
    assert any(x.data_ptr() % 16 for x in t + p)
    before = build.LAUNCHES["polyak"]
    got = polyak_leaves(t, p, 0.3)
    assert build.LAUNCHES["polyak"] == before + 1
    for g, a, b in zip(got, t, p):
        assert torch.equal(g, polyak_ref(a, b, 0.3))


@pytest.mark.gpu
def test_gpu_ddpg_step_launches_polyak_once(cuda):
    """One ``ddpg_step`` updates both target networks with one K3
    launch."""
    from repro_torch.core import ddpg
    cfg = ddpg.DDPGConfig(state_dim=33, action_dim=3, batch_size=16)
    st = ddpg.agent_init(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    rng = np.random.default_rng(0)
    batch = tuple(torch.from_numpy(a).to(cuda) for a in (
        rng.standard_normal((16, 33)).astype(np.float32),
        rng.random((16, 3)).astype(np.float32),
        rng.standard_normal(16).astype(np.float32),
        rng.standard_normal((16, 33)).astype(np.float32),
        np.zeros(16, np.float32)))
    before = build.LAUNCHES["polyak"]
    out = ddpg.ddpg_step(cfg, st.actor, st.critic, st.target_actor,
                         st.target_critic, st.opt_a, st.opt_c, batch)
    assert build.LAUNCHES["polyak"] == before + 1
    for got, target, online in ((out[2], st.target_actor, out[0]),
                                (out[3], st.target_critic, out[1])):
        for gl, tl, ol in zip(got, target, online):
            for k in tl:
                assert torch.equal(gl[k], polyak_ref(tl[k], ol[k], cfg.tau))


# the calibration's kernel shape, the testbed's unit shapes at 192 tokens,
# the JAX tests' ragged shapes and an odd K, granite-3-8b's MLP at 32 and
# 4,096 tokens, ragged M and N on aligned strides, and a K that is neither
# a multiple of the 128-code K tile nor of the cluster's split (33 tiles
# over 8 blocks)
QM_SHAPES = [(256, 256, 256), (192, 256, 512), (192, 256, 2048),
             (192, 1024, 256), (33, 512, 257), (200, 300, 130),
             (64, 301, 96), (32, 4096, 25600), (4096, 4096, 25600),
             (200, 512, 144), (64, 4112, 256)]


def _codes(x, w, packed):
    """What ``ops.quantized_matmul`` hands the wrapper."""
    return tops.quantize_operands(x, w, 4 if packed else 8)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", QM_SHAPES)
@pytest.mark.parametrize("packed", [False, True])
def test_gpu_quant_matmul_kernel_exact(cuda, M, K, N, packed):
    """Bit-equal to the plain version, one launch on the route
    ``quant_matmul.route`` names: the tensor-core route where K and N are
    multiples of 16, the CUDA-core route at the ragged shapes."""
    x = torch.from_numpy(_normal(M, (M, K))).to(cuda)
    w = torch.from_numpy(_normal(N, (K, N))).to(cuda)
    args = _codes(x, w, packed)
    tc = qm_route(M, args[0].shape[1], N, packed, args[0], args[1]) == "tc"
    assert tc == (K % 16 == 0 and N % 16 == 0)
    name = "quant_matmul_int4" if packed else "quant_matmul_int8"
    before = dict(build.LAUNCHES)
    got = quant_matmul(*args, packed=packed, k_true=K)
    assert build.LAUNCHES[name] == before[name] + 1
    assert build.LAUNCHES["quant_matmul_tc"] == \
        before["quant_matmul_tc"] + int(tc)
    assert torch.equal(got, ref.quant_matmul_ref(*args, packed=packed,
                                                 k_true=K))


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_gpu_quant_matmul_misaligned_views_take_the_cuda_core_route(
        cuda, packed):
    """Contiguous codes on a base off 16 bytes: TMA cannot read them, so
    the CUDA-core route runs (never a copy), bit-equal all the same."""
    M, K, N = 64, 256, 128
    args = list(_codes(torch.from_numpy(_normal(60, (M, K))).to(cuda),
                       torch.from_numpy(_normal(61, (K, N))).to(cuda),
                       packed))
    for i in (0, 1):
        buf = torch.empty(args[i].numel() + 1, dtype=torch.int8,
                          device=cuda)
        view = buf[1:].view(args[i].shape)
        view.copy_(args[i])
        args[i] = view
    assert qm_route(M, K, N, packed, args[0], args[1]) == "simt"
    before = build.LAUNCHES["quant_matmul_tc"]
    got = quant_matmul(*args, packed=packed, k_true=K)
    assert build.LAUNCHES["quant_matmul_tc"] == before
    assert torch.equal(got, ref.quant_matmul_ref(*args, packed=packed,
                                                 k_true=K))


@pytest.mark.gpu
def test_gpu_quant_matmul_refuses_k_past_the_int32_accumulator(cuda):
    """|acc| <= K * 2^14 stays below 2^31 only up to K = 131,071."""
    K = 131_088
    xq = torch.zeros((1, K), dtype=torch.int8, device=cuda)
    wq = torch.zeros((K, 16), dtype=torch.int8, device=cuda)
    ones = [torch.ones(n, device=cuda) for n in (1, 1, 16, 16)]
    with pytest.raises(ValueError, match="overflow"):
        quant_matmul(xq, wq, *ones)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_gpu_quant_matmul_asymmetric(cuda, packed):
    """Shifted data (x + 3, w − 1): large zero-point terms; the kernel
    equals its plain version and the dequantized truth, and the SUBTRACT
    convention misses."""
    x = torch.from_numpy(_normal(20, (64, 128)) + 3.0).to(cuda)
    w = torch.from_numpy(_normal(21, (128, 96)) - 1.0).to(cuda)
    xq, wq, sx, zx, sw, zw = _codes(x, w, packed)
    before = build.LAUNCHES["quant_matmul_tc"]
    got = quant_matmul(xq, wq, sx, zx, sw, zw, packed=packed)
    assert build.LAUNCHES["quant_matmul_tc"] == before + 1
    assert torch.equal(got, ref.quant_matmul_ref(xq, wq, sx, zx, sw, zw,
                                                 packed=packed))
    codes = ref.unpack_int4_ref(wq) if packed else wq
    truth = ref.dequant_matmul_ref(xq, codes, sx, zx, sw, zw)
    torch.testing.assert_close(got, truth, rtol=1e-3, atol=0.1)
    fp = x @ w
    rel = float((truth - fp).norm() / fp.norm())
    wrong = ref.int8_matmul_ref(xq, codes, sx, -zx, sw, -zw)
    assert float((wrong - fp).norm() / fp.norm()) > 10 * rel


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_gpu_quant_matmul_k_true(cuda, packed):
    """K zero-padded from 300 to 512: with k_true the kernel gives the
    unpadded truth (exactly its plain version), without it it is off."""
    x = torch.from_numpy(_normal(50, (32, 300)) + 1.0).to(cuda)
    w = torch.from_numpy(_normal(51, (300, 64))).to(cuda)
    xq, sx, zx = ref.quantize_rows(x, 8)
    wq, sw, zw = ref.quantize_cols(w, 4 if packed else 8)
    truth = ref.dequant_matmul_ref(xq, wq, sx, zx, sw, zw)
    xq_p = torch.zeros((32, 512), dtype=torch.int8, device=cuda)
    xq_p[:, :300] = xq
    wq_p = torch.zeros((512, 64), dtype=torch.int8, device=cuda)
    wq_p[:300] = wq
    wq_p = ref.pack_int4(wq_p) if packed else wq_p
    before = build.LAUNCHES["quant_matmul_tc"]
    got = quant_matmul(xq_p, wq_p, sx, zx, sw, zw, packed=packed,
                       k_true=300)
    assert build.LAUNCHES["quant_matmul_tc"] == before + 1
    assert torch.equal(got, ref.quant_matmul_ref(
        xq_p, wq_p, sx, zx, sw, zw, packed=packed, k_true=300))
    torch.testing.assert_close(got, truth, rtol=1e-3, atol=0.1)
    bad = quant_matmul(xq_p, wq_p, sx, zx, sw, zw, packed=packed)
    assert float((bad - truth).abs().max()) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("w_bits", [8, 4])
def test_gpu_quantized_matmul_op_equals_cpu(cuda, w_bits):
    """The whole op on the card (quantization steps, then K4/K5) equals
    the same op on the CPU (plain version): the quotients are correctly
    rounded on both sides."""
    x, w = _normal(7, (200, 301)), _normal(8, (301, 130))
    got = tops.quantized_matmul(torch.from_numpy(x).to(cuda),
                                torch.from_numpy(w).to(cuda), w_bits)
    want = tops.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 w_bits)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_gpu_quant_matmul_refuses_bad_operands(cuda):
    xq = torch.zeros((8, 6), dtype=torch.int8, device=cuda)
    s = torch.ones(8, device=cuda)
    sn = torch.ones(4, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        quant_matmul(xq.float(), torch.zeros((6, 4), dtype=torch.int8,
                                             device=cuda), s, s, sn, sn)
    with pytest.raises(ValueError, match="expected"):
        quant_matmul(xq, torch.zeros((6, 4), dtype=torch.int8, device=cuda),
                     s, s, sn, sn, packed=True)
    with pytest.raises(ValueError, match="even K"):
        quant_matmul(xq[:, :5].contiguous(), torch.zeros(
            (2, 4), dtype=torch.int8, device=cuda), s, s, sn, sn,
            packed=True)


# --- K6: flash attention ----------------------------------------------------
# The JAX tests' shapes (B 2, f32) and bf16 case, qwen2-0.5b's heads (14
# over 2 KV heads of 64) at S 4096 in bf16, and head dim 256 (MQA, as
# recurrentgemma-2b's 10 over 1).
FA_SHAPES = [(2, 128, 4, 4, 32), (2, 200, 8, 2, 16), (2, 512, 4, 1, 64),
             (1, 300, 4, 2, 128), (2, 300, 4, 1, 256)]
FA_MASKS = [(True, 0), (False, 0), (True, 96)]


def _qkv(seed, B, S, H, KV, D, dtype, cuda):
    return [torch.from_numpy(_normal(seed + i, shape)).to(cuda, dtype)
            for i, shape in enumerate(((B, H, S, D), (B, KV, S, D),
                                       (B, KV, S, D)))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D", FA_SHAPES)
@pytest.mark.parametrize("causal,window", FA_MASKS)
def test_gpu_flash_attention_f32(cuda, B, S, H, KV, D, causal, window):
    q, k, v = _qkv(S, B, S, H, KV, D, torch.float32, cuda)
    before = build.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert build.LAUNCHES["flash_attention"] == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D", [(1, 128, 4, 2, 32),
                                        (1, 4096, 14, 2, 64),
                                        (1, 4096, 10, 1, 256)])
@pytest.mark.parametrize("causal,window", FA_MASKS + [(True, 2048)])
def test_gpu_flash_attention_bf16(cuda, B, S, H, KV, D, causal, window):
    q, k, v = _qkv(D, B, S, H, KV, D, torch.bfloat16, cuda)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=0.04, rtol=0)
    rel = (got.float() - want.float()).norm(dim=-1) \
        / want.float().norm(dim=-1)
    assert float(rel.max()) <= 2.0 ** -6


@pytest.mark.gpu
def test_gpu_flash_attention_reads_strided_views(cuda):
    """The layer's [B,S,H,D] tensors seen through transpose(1, 2): the
    kernel reads the strides (no copy) and writes the output in q's
    layout; the chunked layer branch on the card goes through it."""
    from repro_torch.models import layers as TL
    B, S, H, KV, D = 1, 1100, 4, 2, 64
    q, k, v = [t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _qkv(9, B, S, H, KV, D, torch.float32, cuda)]
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True, window=0)
    assert got.stride() == q.stride()
    want = ref.attention_ref(q, k, v)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    before = build.LAUNCHES["flash_attention"]
    lay = TL.attention(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=True)
    assert build.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(lay, want.transpose(1, 2), atol=2e-5,
                               rtol=0)
    chunked = TL.attention_chunked(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=True)
    torch.testing.assert_close(lay, chunked, atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_gpu_flash_attention_refuses_bad_operands(cuda):
    q, k, v = _qkv(0, 1, 64, 4, 2, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(q, k, v)
    q, k, v = _qkv(0, 1, 64, 4, 2, 64, torch.float32, cuda)
    before = build.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="CPU"):
        flash_attention(q.cpu(), k, v)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(q, k.half(), v)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q[:, :3], k, v)
    assert build.LAUNCHES["flash_attention"] == before


# --- K6's tensor-core route: bf16 at head dims 64, 128, 256 ----------------
# The same tolerances as the bf16 cases above (atol 0.04 and each row
# within 2^-6 of the dense plain version). Every call must count one
# launch in both ``flash_attention`` and ``flash_attention_tc``.

def _k6_tc(q, k, v, **mask):
    before = (build.LAUNCHES["flash_attention"],
              build.LAUNCHES["flash_attention_tc"])
    got = flash_attention(q, k, v, **mask)
    assert (build.LAUNCHES["flash_attention"],
            build.LAUNCHES["flash_attention_tc"]) == (before[0] + 1,
                                                      before[1] + 1)
    return got


def _assert_bf16_close(got, want):
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=0.04, rtol=0)
    rel = (got.float() - want.float()).norm(dim=-1) \
        / want.float().norm(dim=-1)
    assert float(rel.max()) <= 2.0 ** -6


def _layer_qkv(seed, B, S, H, KV, D, cuda):
    """q, k, v as the attention layer holds them ([B,S,H,D] memory) seen
    as [B,H,S,D] through transpose(1, 2), the views K6 receives."""
    return [torch.from_numpy(_normal(seed + i, shape)).to(cuda, torch.bfloat16)
            .transpose(1, 2) for i, shape in enumerate(((B, S, H, D),
                                                         (B, S, KV, D),
                                                         (B, S, KV, D)))]


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV,D,window", [(14, 2, 64, 0), (10, 1, 256, 2048),
                                           (16, 16, 80, 0)])
def test_gpu_flash_attention_tc_reads_the_layers_views(cuda, H, KV, D,
                                                       window):
    """qwen2-0.5b's, recurrentgemma-2b's and hubert-xlarge's heads at S
    1,100 in the layer's [B,S,H,D] layout (hubert's strides (…, 1280, 80,
    1)): TMA reads the views in place, the output comes back in q's
    layout, and the layer's chunked branch on the card launches the same
    kernel."""
    from repro_torch.models import layers as TL
    q, k, v = _layer_qkv(11, 1, 1100, H, KV, D, cuda)
    assert not q.is_contiguous()
    got = _k6_tc(q, k, v, causal=True, window=window)
    assert got.stride() == q.stride()
    _assert_bf16_close(got, ref.attention_ref(q, k, v, causal=True,
                                              window=window))
    before = build.LAUNCHES["flash_attention_tc"]
    lay = TL.attention(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal=True, window=window)
    assert build.LAUNCHES["flash_attention_tc"] == before + 1
    assert torch.equal(lay, got.transpose(1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 37, 300, 4097])
@pytest.mark.parametrize("H,KV,D,causal,window", [
    (14, 2, 64, True, 0), (10, 1, 256, True, 2048), (4, 2, 128, False, 0),
    (4, 1, 64, False, 96), (16, 16, 80, False, 0), (4, 2, 80, True, 96)])
def test_gpu_flash_attention_tc_ragged_s(cuda, S, H, KV, D, causal, window):
    """S that is a multiple of neither the 64 · NC q rows nor the 64 /
    96 / 128 keys of a tile, down to one row (one key tile, boxes taller than
    S): TMA zero-fills the ragged loads and drops the ragged output rows;
    the mask keeps kpos < S. D 80 (both of its boxes) bidirectional as
    hubert-xlarge runs it, and causal with a window."""
    q, k, v = _qkv(S + D, 1, S, H, KV, D, torch.bfloat16, cuda)
    got = _k6_tc(q, k, v, causal=causal, window=window)
    _assert_bf16_close(got, ref.attention_ref(q, k, v, causal=causal,
                                              window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV", [(14, 2), (10, 1)])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_gpu_flash_attention_tc_grouped_heads(cuda, H, KV, D):
    """GQA with groups of 7 (qwen2-0.5b's 14 over 2) and MQA (10 over
    1), batch 2, at every head dim of the route, causal and with a
    window."""
    q, k, v = _qkv(H + D, 2, 640, H, KV, D, torch.bfloat16, cuda)
    for causal, window in ((True, 0), (True, 100)):
        got = _k6_tc(q, k, v, causal=causal, window=window)
        _assert_bf16_close(got, ref.attention_ref(q, k, v, causal=causal,
                                                  window=window))


@pytest.mark.gpu
def test_gpu_flash_attention_tc_refuses_views_tma_cannot_read(cuda):
    """A bf16 view that breaks one of TMA's terms is refused with a
    ValueError naming it, before any launch: d-stride other than 1, a
    stride that is no multiple of 8 elements, a base off 16 bytes."""
    q, k, v = _qkv(3, 1, 256, 4, 2, 64, torch.bfloat16, cuda)
    d_major = q.transpose(2, 3).contiguous().transpose(2, 3)
    padded = torch.zeros((1, 256, 4, 68), dtype=torch.bfloat16,
                         device=cuda)[..., :64].transpose(1, 2)
    shifted = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(q.shape)
    before = dict(build.LAUNCHES)
    for bad, term in ((d_major, "d-stride"), (padded, "multiples of 8"),
                      (shifted, "16-byte aligned")):
        with pytest.raises(ValueError, match=term):
            flash_attention(bad, k, v)
    assert dict(build.LAUNCHES) == before


@pytest.mark.gpu
def test_gpu_flash_attention_tc_d80_refuses_views_tma_cannot_read(cuda):
    """At D 80 too a bf16 view outside TMA's terms raises ValueError and
    launches nothing (no fallback to the CUDA cores): [B,S,H,D] rows
    padded to 84 (a stride of 4 · 84 elements, no multiple of 8) and a
    base off 16 bytes."""
    q, k, v = _qkv(4, 1, 256, 4, 4, 80, torch.bfloat16, cuda)
    padded = torch.zeros((1, 256, 4, 84), dtype=torch.bfloat16,
                         device=cuda)[..., :80].transpose(1, 2)
    shifted = torch.zeros(k.numel() + 4, dtype=torch.bfloat16,
                          device=cuda)[4:].view(k.shape)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_attention(padded, k, v, causal=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, shifted, v, causal=False)
    assert dict(build.LAUNCHES) == before


# --- K8: SSD chunked scan -----------------------------------------------------
# The JAX tests' shapes (B, S, H, P, N, chunk), a ragged S at each chunk
# size of the two configs, and mamba2-780m's heads (48 of 64, state 128).
SSD_SHAPES = [(2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
              (2, 96, 3, 8, 8, 32), (2, 100, 3, 16, 16, 32),
              (1, 1100, 4, 64, 128, 256), (2, 700, 3, 64, 64, 128)]


def _ssd_inputs(seed, B, S, H, P, N, max_decay, cuda):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return [torch.from_numpy(a).to(cuda) for a in (
        rng.standard_normal((B, S, H, P)).astype(f32),
        -rng.uniform(0.0, max_decay, (B, S, H)).astype(f32),
        rng.standard_normal((B, S, N)).astype(f32),
        rng.standard_normal((B, S, N)).astype(f32))]


def _row_rel(got, want, eps=1e-6):
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(eps)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_gpu_ssd_scan(cuda, B, S, H, P, N, chunk):
    xh, dA, Bm, Cm = _ssd_inputs(S, B, S, H, P, N, 0.5, cuda)
    before = (build.LAUNCHES["ssd_scan"], build.LAUNCHES["ssd_scan_tc"])
    y, fin = ssd_scan(xh, dA, Bm, Cm, chunk=chunk)
    tc = ssd_route(P, N, chunk) == "tc"
    assert (build.LAUNCHES["ssd_scan"], build.LAUNCHES["ssd_scan_tc"]) == \
        (before[0] + 1, before[1] + tc)
    for want_y, want_f in (ref.ssd_scan_ref(xh, dA, Bm, Cm),
                           ref.ssd_chunked_ref(xh, dA, Bm, Cm, chunk)):
        torch.testing.assert_close(y, want_y, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(fin, want_f, atol=2e-4, rtol=2e-4)


@pytest.mark.gpu
def test_gpu_ssd_scan_slow_decay_carries_the_state(cuda):
    """mamba2-780m's head shape at S 4096 with dA in [-0.01, 0]: the state
    entering a chunk dominates its output, so a wrong carry shows."""
    xh, dA, Bm, Cm = _ssd_inputs(7, 1, 4096, 48, 64, 128, 0.01, cuda)
    before = build.LAUNCHES["ssd_scan_tc"]
    y, fin = ssd_scan(xh, dA, Bm, Cm, chunk=256)
    assert build.LAUNCHES["ssd_scan_tc"] == before + 1
    yc, fc = ref.ssd_chunked_ref(xh, dA, Bm, Cm, 256)
    torch.testing.assert_close(y, yc, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(fin, fc, atol=2e-4, rtol=2e-4)
    ys, fs = ref.ssd_scan_ref(xh, dA, Bm, Cm)
    assert _row_rel(y, ys) <= 2.0 ** -10
    assert _row_rel(fin, fs) <= 2.0 ** -10


@pytest.mark.gpu
def test_gpu_ssd_scan_reads_strided_b_and_c(cuda):
    """B and C as the SSM block makes them in f32: views into one wider
    tensor, read with their strides."""
    B, S, H, P, N = 2, 300, 4, 16, 32
    xh, dA, _, _ = _ssd_inputs(3, B, S, H, P, N, 0.5, cuda)
    wide = torch.from_numpy(_normal(4, (B, S, 2 * N + 8))).to(cuda)
    Bm, Cm = wide[..., 8:8 + N], wide[..., 8 + N:]
    assert not Bm.is_contiguous()
    y, fin = ssd_scan(xh, dA, Bm, Cm, chunk=64)
    want_y, want_f = ref.ssd_chunked_ref(xh, dA, Bm.contiguous(),
                                         Cm.contiguous(), 64)
    torch.testing.assert_close(y, want_y, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(fin, want_f, atol=2e-4, rtol=2e-4)


@pytest.mark.gpu
def test_gpu_ssd_scan_tc_reads_strided_b_and_c(cuda):
    """The tensor-core route reads B and C through TMA tensor maps with
    the views' own strides (mamba2's heads, a ragged last chunk)."""
    B, S, H, P, N = 2, 600, 3, 64, 128
    xh, dA, _, _ = _ssd_inputs(8, B, S, H, P, N, 0.5, cuda)
    wide = torch.from_numpy(_normal(9, (B, S, 2 * N + 8))).to(cuda)
    Bm, Cm = wide[..., 8:8 + N], wide[..., 8 + N:]
    assert not Bm.is_contiguous()
    before = build.LAUNCHES["ssd_scan_tc"]
    y, fin = ssd_scan(xh, dA, Bm, Cm, chunk=256)
    assert build.LAUNCHES["ssd_scan_tc"] == before + 1
    for want_y, want_f in (
            ref.ssd_scan_ref(xh, dA, Bm, Cm),
            ref.ssd_chunked_ref(xh, dA, Bm.contiguous(), Cm.contiguous(),
                                256)):
        torch.testing.assert_close(y, want_y, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(fin, want_f, atol=2e-4, rtol=2e-4)


@pytest.mark.gpu
def test_gpu_ssd_scan_tc_refuses_views_tma_cannot_read(cuda):
    """A tensor-core shape whose B view TMA cannot read (a token stride
    that is not a multiple of 16 bytes) raises; it is never copied and
    never sent to the other route."""
    B, S, H, P, N = 1, 300, 2, 64, 128
    xh, dA, Bm, Cm = _ssd_inputs(10, B, S, H, P, N, 0.5, cuda)
    odd = torch.from_numpy(_normal(11, (B, S, N + 2))).to(cuda)[..., :N]
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="TMA"):
        ssd_scan(xh, dA, odd, Cm, chunk=256)
    assert dict(build.LAUNCHES) == before


@pytest.mark.gpu
def test_gpu_ssd_chunked_refuses_an_initial_state(cuda):
    """The model's chunked scan goes through K8 on the card, which starts
    from a zero state; no path passes one, so a call with one raises."""
    from repro_torch.models import blocks as TB
    xh, dA, Bm, Cm = _ssd_inputs(5, 1, 64, 2, 16, 16, 0.5, cuda)
    before = build.LAUNCHES["ssd_scan"]
    y, fin = TB.ssd_chunked(xh, dA, Bm, Cm, 32)
    assert build.LAUNCHES["ssd_scan"] == before + 1
    with pytest.raises(ValueError, match="initial state"):
        TB.ssd_chunked(xh, dA, Bm, Cm, 32, init_state=fin)


@pytest.mark.gpu
def test_gpu_ssd_scan_refuses_bad_operands(cuda):
    xh, dA, Bm, Cm = _ssd_inputs(6, 1, 64, 2, 16, 16, 0.5, cuda)
    before = build.LAUNCHES["ssd_scan"]
    with pytest.raises(ValueError, match="head dim"):
        ssd_scan(xh.repeat(1, 1, 1, 5), dA, Bm, Cm)
    with pytest.raises(ValueError, match="state"):
        ssd_scan(xh, dA, Bm[..., :6], Cm[..., :6])
    with pytest.raises(ValueError, match="CPU"):
        ssd_scan(xh.cpu(), dA, Bm, Cm)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(xh, dA.cpu(), Bm, Cm)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan(xh, dA, Bm.double(), Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(xh.transpose(1, 2).contiguous().transpose(1, 2), dA, Bm,
                 Cm)
    assert build.LAUNCHES["ssd_scan"] == before


# --- K7: RG-LRU scan ----------------------------------------------------------
# The JAX tests' shapes (a in [0.4, 0.99]), at the default chunk of 128
# (one chunk: no carry) and at chunk 16 (the state is carried between
# chunks), a ragged S and C, and a C off 16 bytes (the scalar copy).
LRU_SHAPES = [(2, 64, 96), (1, 128, 32), (3, 48, 256), (2, 1000, 2600),
              (2, 200, 99)]


def _three_pass(a, b, h0=None, chunk=128):
    """The former three-launch K7, built from ``tools/k7_three_pass.cu``
    (``chip_smoke.k7_three_pass``)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke.k7_three_pass(a, b, h0, chunk)


def _lru_inputs(seed, B, S, C, lo, hi, cuda, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (B, S, C)).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    return [torch.from_numpy(t).to(cuda, dtype) for t in (a, b)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,C", LRU_SHAPES)
@pytest.mark.parametrize("chunk", [128, 16])
def test_gpu_rglru_scan(cuda, B, S, C, chunk):
    a, b = _lru_inputs(S + C, B, S, C, 0.4, 0.99, cuda)
    before = build.LAUNCHES["rglru_scan"]
    got = rglru_scan(a, b, chunk=chunk)
    assert build.LAUNCHES["rglru_scan"] == before + 1
    want = ref.rglru_scan_ref(a, b)
    if S <= chunk:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert torch.equal(got, _three_pass(a, b, chunk=chunk))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 8])
def test_gpu_rglru_scan_initial_state(cuda, chunk):
    a, b = _lru_inputs(1, 2, 32, 64, 0.5, 0.95, cuda)
    h0 = torch.from_numpy(_normal(2, (2, 64))).to(cuda)
    got = rglru_scan(a, b, h0, chunk=chunk)
    want = ref.rglru_scan_ref(a, b, h0)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert float((got - ref.rglru_scan_ref(a, b)).abs().max()) > 1e-3
    assert torch.equal(got, _three_pass(a, b, h0, chunk))


def _block_row_rel(got, want, block=256):
    """max over (batch, token, channel block) of ||got - want|| /
    ||want|| over the block's channels."""
    B, S, C = want.shape
    g = got.float().reshape(B, S, C // block, block)
    w = want.float().reshape(B, S, C // block, block)
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


@pytest.mark.gpu
def test_gpu_rglru_scan_slow_decay_carries_the_state(cuda):
    """recurrentgemma-2b's width at S 4096 with its init's decays (a =
    sqrt(linspace(0.9, 0.999)) per channel, r = 0.5) and b = sqrt(1 - a^2)
    0.5 u: the state carries over ~2,000 steps, across 32 chunks."""
    S, C = 4096, 2560
    rng = np.random.default_rng(3)
    a = np.sqrt(np.linspace(0.9, 0.999, C, dtype=np.float32))
    a = np.tile(a, (1, S, 1))
    b = (np.sqrt(1 - a * a) * 0.5
         * rng.standard_normal((1, S, C))).astype(np.float32)
    a, b = (torch.from_numpy(t).to(cuda) for t in (a, b))
    got = rglru_scan(a, b)
    want = ref.rglru_scan_ref(a, b)
    assert _block_row_rel(got, want) <= 2.0 ** -12
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert torch.equal(got, _three_pass(a, b))


def _path_decays(seed, S, C):
    rng = np.random.default_rng(seed)
    a = np.tile(np.sqrt(np.linspace(0.9, 0.999, C, dtype=np.float32)),
                (1, S, 1))
    b = (np.sqrt(1 - a * a) * 0.5
         * rng.standard_normal((1, S, C))).astype(np.float32)
    return a, b


@pytest.mark.gpu
def test_gpu_rglru_scan_many_waves(cuda):
    """(1, 65536, 256) at chunk 16: 32,768 tiles, far more than the card
    holds at once, so chunks wait on chunks that blocks of earlier waves
    published; at the path's decays."""
    a, b = (torch.from_numpy(t).to(cuda) for t in _path_decays(7, 65536,
                                                                256))
    got = rglru_scan(a, b, chunk=16)
    want = ref.rglru_scan_ref(a, b)
    assert _block_row_rel(got, want) <= 2.0 ** -12
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    assert torch.equal(got, _three_pass(a, b, chunk=16))


@pytest.mark.gpu
def test_gpu_rglru_scan_back_to_back_is_one_kernel_each(cuda):
    """Two calls on one stream with no sync between them, on other
    inputs: the second takes none of the first's state words (a new
    epoch) and finds the ticket back at zero; each call is one kernel
    (no memset beside it)."""
    from torch.profiler import ProfilerActivity, profile
    a1, b1 = (torch.from_numpy(t).to(cuda) for t in _path_decays(8, 4096,
                                                                  2560))
    a2, b2 = _lru_inputs(9, 1, 4096, 2560, 0.4, 0.99, cuda)
    rglru_scan(a1, b1)
    torch.cuda.synchronize()
    before = build.LAUNCHES["rglru_scan"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h1 = rglru_scan(a1, b1)
        h2 = rglru_scan(a2, b2)
        torch.cuda.synchronize()
    assert build.LAUNCHES["rglru_scan"] == before + 2
    kernels = [e.key for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", None))
               for _ in range(e.count)]
    assert len(kernels) <= 2 and all("lru_chained" in k
                                     for k in kernels), kernels
    for a, b, h in ((a1, b1, h1), (a2, b2, h2)):
        want = ref.rglru_scan_ref(a, b)
        assert _block_row_rel(h, want) <= 2.0 ** -12
        assert torch.equal(h, _three_pass(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [128, 32])
def test_gpu_rglru_scan_bf16(cuda, chunk):
    a, b = _lru_inputs(4, 2, 300, 200, 0.4, 0.99, cuda, torch.bfloat16)
    got = rglru_scan(a, b, chunk=chunk)
    assert got.dtype == torch.bfloat16
    want = ref.rglru_scan_ref(a.float(), b.float())
    err = (got.float() - want).abs()
    assert bool((err <= 2.0 ** -8 * want.abs() + 2e-5).all())
    assert torch.equal(got, _three_pass(a, b, chunk=chunk))


@pytest.mark.gpu
def test_gpu_apply_rglru_goes_through_k7(cuda):
    """The RG-LRU block on the card launches K7 once and agrees with the
    same block on the CPU (the sequential plain version) in f32."""
    from repro_torch.configs.recurrentgemma_2b import SMOKE
    from repro_torch.models import blocks as TB
    cfg = SMOKE.replace(compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = TB.init_rglru(gen, cfg, torch.float32, "cpu")
    x = torch.from_numpy(_normal(5, (2, 300, cfg.d_model)))
    want = TB.apply_rglru(p, x, cfg)
    before = build.LAUNCHES["rglru_scan"]
    got = TB.apply_rglru({k: v.to(cuda) for k, v in p.items()}, x.to(cuda),
                         cfg)
    assert build.LAUNCHES["rglru_scan"] == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_gpu_rglru_scan_refuses_bad_operands(cuda):
    a, b = _lru_inputs(6, 1, 64, 32, 0.4, 0.99, cuda)
    before = build.LAUNCHES["rglru_scan"]
    with pytest.raises(ValueError, match="CPU"):
        rglru_scan(a.cpu(), b)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(a, b.cpu())
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a, b.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="expected"):
        rglru_scan(a, b[:, :32])
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a, b, torch.zeros((1, 32), device=cuda,
                                     dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="chunk"):
        rglru_scan(a, b, chunk=0)
    with pytest.raises(ValueError, match="chunk 4096 needs"):
        rglru_scan(a, b, chunk=4096)
    assert build.LAUNCHES["rglru_scan"] == before


# ------------------------------------------- the fused engine's graphs

# K1 sites of the LM testbed (3,072 token rows, d 256, d_ff 1024, vocab
# 256) and of ResNet18 at CIFAR-10 widths over 16 images (its channel
# widths, rows cut from 256 images'): (R, C, slot stride 0 = shared).
DEV_BITS_SITES = [(3072, 256, False), (3072, 1024, False), (256, 256, True),
                  (256, 128, True), (256, 1024, True), (1024, 256, True),
                  (16384, 3, True), (16384, 64, False), (4096, 128, False),
                  (1024, 256, False), (256, 512, False), (16, 512, False),
                  (27, 64, True), (576, 64, True), (4608, 512, True),
                  (512, 10, True)]
DEV_BITS = [(32,) * 8, (2, 4, 32, 8, 6, 32, 3, 5), (4,) * 8,
            (1, 31, 32, 33, 8, 2, 7, 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,C,shared", DEV_BITS_SITES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_fake_quant_slots_dev_equals_host_bits(cuda, R, C, shared,
                                                   dtype):
    """K1's device-bits entry is bit-equal to its host-bits slot form
    (and to the plain version) at every bits vector, all slots at 32
    included (copied by the kernel), plain and straight-through; one
    launch a call."""
    from repro_torch.kernels.fake_quant import fake_quant_slots_dev
    K = 8
    g = torch.Generator(device=cuda).manual_seed(R + C)
    x = torch.randn((R, C) if shared else (K, R, C), generator=g,
                    device=cuda).to(getattr(torch, dtype))
    if shared:
        x = x.expand(K, R, C)
    for bits in DEV_BITS:
        dev = torch.tensor(bits, dtype=torch.int32, device=cuda)
        for ste in (False, True):
            before = build.LAUNCHES["fake_quant_slots_dev"]
            got = fake_quant_slots_dev(x, dev, ste=ste)
            assert build.LAUNCHES["fake_quant_slots_dev"] == before + 1
            assert torch.equal(got, fake_quant_slots(x, bits, ste=ste))
            assert torch.equal(got, fake_quant_slots_ref(x, bits, ste))


def _small_fused(cuda, epoch_batches):
    from repro_torch.configs.testbed import LM_CFG, SERVE_CTX
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.reward import RewardConfig
    from repro_torch.core.search import FusedCompressionSearch, SearchConfig
    from repro_torch.core.sensitivity import SensitivityResult
    from repro_torch.data.pipeline import make_bigram_table, sample_bigram
    from repro_torch.models import model as M
    cfg = LM_CFG.replace(num_layers=2, compute_dtype="float32")
    cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=cuda))
    val = {"tokens": torch.as_tensor(sample_bigram(
        make_bigram_table(cfg.vocab_size, 0), 8, 32, 7), device=cuda)}
    scfg = SearchConfig(methods="pq", episodes=16, seed=0,
                        reward=RewardConfig(target_ratio=0.5),
                        ddpg=DDPGConfig(warmup_episodes=2,
                                        updates_per_episode=4,
                                        batch_size=32, buffer_size=512))
    table = {s.name: {"w4": 0.1 * i, "a4": 0.05 * i}
             for i, s in enumerate(cm.specs)}
    return FusedCompressionSearch(cm, val, scfg, SERVE_CTX,
                                  sens=SensitivityResult(table),
                                  batch_size=4,
                                  epoch_batches=epoch_batches)


@pytest.mark.gpu
@pytest.mark.parametrize("epoch_batches", [0, 2])
def test_gpu_fused_graphs_equal_eager(cuda, epoch_batches):
    """The fused engine's replayed graphs (rollout and update per batch,
    or the epoch) give, bit for bit, the records, the agent's tensors
    and the ring of the same pure functions run eagerly on the card;
    after the run, a chunk replays without capturing: one rollout and
    one update replay a batch, or one epoch replay and one readback."""
    from repro_torch.core import graphs
    from repro_torch.core.ddpg import state_leaves
    graphs.reset_counts()
    a = _small_fused(cuda, epoch_batches)
    ha = a.run().history
    b = _small_fused(cuda, epoch_batches)
    call = graphs.Graph.__call__
    graphs.Graph.__call__ = lambda self: self.fn()
    try:
        hb = b.run().history
    finally:
        graphs.Graph.__call__ = call
    for x, y in zip(ha, hb):
        assert (x.reward, x.accuracy, x.latency_s) == \
            (y.reward, y.accuracy, y.latency_s)
    for x, y in zip(state_leaves(a.agent.state) + list(a.replay.data),
                    state_leaves(b.agent.state) + list(b.replay.data)):
        assert torch.equal(x, y)
    assert sum(c["captures"] for c in graphs.COUNTS.values()) > 0
    graphs.reset_counts()
    k, reads = a._chunk_size(), a.readbacks
    a._run_chunk(16, k)
    if epoch_batches:
        assert dict(graphs.COUNTS) == {"epoch": {"captures": 0,
                                                 "replays": 1}}
        assert a.readbacks == reads + 1
    else:
        assert dict(graphs.COUNTS) == {
            "rollout": {"captures": 0, "replays": 1},
            "update": {"captures": 0, "replays": 1}}


# ---------------------------------------------------------------------------
# The population engine: K2's member form, the fused Adam + Polyak pass,
# the population's graphs
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("rows", [8, 64])
@pytest.mark.parametrize("dims,final", [((33, 400, 300, 3), "sigmoid"),
                                        ((36, 400, 300, 1), "linear")])
def test_gpu_mlp3_members_equals_solo_launches(cuda, P, rows, dims, final):
    """Each member's (y, h1, h2) bit-equal to the one-network K2 on its
    slices, one launch for all; within 1e-5 of the plain version."""
    from repro_torch.kernels.mlp_fused import mlp3_members
    nets = [_mlp_params(10 * P + i, dims) for i in range(P)]
    flat = [torch.from_numpy(np.stack([net[i // 2]["wb"[i % 2]]
                                       for net in nets])).to(cuda)
            for i in range(6)]
    x = torch.from_numpy(_normal(rows, (P, rows, dims[0]))).to(cuda)
    sig = final == "sigmoid"
    before = build.LAUNCHES["mlp3_members"]
    got = mlp3_members(x, *flat, sigmoid=sig)
    assert build.LAUNCHES["mlp3_members"] == before + 1
    for p in range(P):
        solo = mlp3(x[p], *(t[p] for t in flat), sigmoid=sig)
        for g, w in zip(got, solo):
            assert torch.equal(g[p], w)
    for g, w in zip(got, ref.mlp3_members_ref(x, *flat, sig)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 3, 8])
def test_gpu_adam_polyak_exact(cuda, P):
    """The fused Adam + Polyak pass over the critic's stacked leaves (step
    counts 0 to ~10^3): one launch, p, m, v and the target bit-equal to
    the plain version in place, the step counts advanced."""
    from repro_torch.kernels.adam_polyak import adam_polyak_
    rng = np.random.default_rng(P)
    dims = (36, 400, 300, 1)
    leaves = []
    for a, b in zip(dims[:-1], dims[1:]):
        for sh in ((b,), (a, b)):
            p, m, v, g, tg = (rng.standard_normal((P, *sh)) * s
                              for s in (0.05, 1e-3, 1e-3, 1e-2, 0.05))
            leaves.append(tuple(torch.from_numpy(x.astype(np.float32))
                                .to(cuda) for x in (p, m, v * v, g, tg)))
    t = torch.from_numpy(rng.integers(0, 1000, P).astype(np.int32)).to(cuda)
    want, t_want = ref.fused_adam_polyak_ref(leaves, t, 1e-3, 0.01)
    before = build.LAUNCHES["adam_polyak"]
    adam_polyak_(leaves, t, 1e-3, 0.01)
    assert build.LAUNCHES["adam_polyak"] == before + 1
    assert torch.equal(t, t_want)
    for leaf, upd in zip(leaves, want):
        for a, b in zip(leaf[:3] + leaf[4:], upd):
            assert torch.equal(a, b)


def _small_population(cuda, kind):
    """A population on the 2-layer f32 testbed: p / q / pq batched
    members, or two fused members (V5E and tpu-v5p) in epoch mode."""
    from repro_torch.configs.testbed import LM_CFG, SERVE_CTX
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.latency import V5E, HardwareTarget
    from repro_torch.core.reward import RewardConfig
    from repro_torch.core.search import (BatchedCompressionSearch,
                                         FusedCompressionSearch,
                                         PopulationSearch, SearchConfig)
    from repro_torch.core.sensitivity import SensitivityResult
    from repro_torch.data.pipeline import make_bigram_table, sample_bigram
    from repro_torch.models import model as M
    cfg = LM_CFG.replace(num_layers=2, compute_dtype="float32")
    cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=cuda))
    val = {"tokens": torch.as_tensor(sample_bigram(
        make_bigram_table(cfg.vocab_size, 0), 8, 32, 7), device=cuda)}
    table = {s.name: {"w4": 0.1 * i, "a4": 0.05 * i}
             for i, s in enumerate(cm.specs)}
    sens = SensitivityResult(table)

    def scfg(methods):
        return SearchConfig(methods=methods, episodes=16, seed=0,
                            reward=RewardConfig(target_ratio=0.5),
                            ddpg=DDPGConfig(warmup_episodes=2,
                                            updates_per_episode=4,
                                            batch_size=32, buffer_size=512,
                                            action_dim=3))

    if kind == "batched":
        return PopulationSearch([BatchedCompressionSearch(
            cm, val, scfg(m), SERVE_CTX, sens=sens, batch_size=4)
            for m in ("p", "q", "pq")])
    v5p = HardwareTarget(name="tpu-v5p", peak_bf16=459e12, peak_int8=918e12,
                         hbm_bw=2765e9, ici_bw=90e9)
    return PopulationSearch([FusedCompressionSearch(
        cm, val, scfg("pq"), SERVE_CTX, hw=hw, sens=sens, batch_size=4,
        epoch_batches=2) for hw in (V5E, v5p)], fuse_rollouts=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["batched", "epoch"])
def test_gpu_population_graphs_equal_eager(cuda, kind):
    """The population's replayed graphs (shared megabatched updates, or
    shared epochs) give, bit for bit, the records, agent states and rings
    of the same functions run eagerly on the card; the members' tensors
    stay views of the stack; a steady chunk replays without capturing:
    one update replay a batch, or one epoch replay and one readback."""
    from repro_torch.core import graphs
    from repro_torch.core.ddpg import state_leaves
    graphs.reset_counts()
    a = _small_population(cuda, kind)
    ra = a.run()
    b = _small_population(cuda, kind)
    call = graphs.Graph.__call__
    graphs.Graph.__call__ = lambda self: self.fn()
    try:
        rb = b.run()
    finally:
        graphs.Graph.__call__ = call
    for x, y in zip(ra, rb):
        assert [(r.reward, r.accuracy, r.latency_s) for r in x.history] == \
            [(r.reward, r.accuracy, r.latency_s) for r in y.history]
    for x, y in zip(state_leaves(a.state) + list(a.ring),
                    state_leaves(b.state) + list(b.ring)):
        assert torch.equal(x, y)
    for i, m in enumerate(a.members):
        assert m.agent.state.actor[0]["w"].data_ptr() == \
            a.state.actor[0]["w"][i].data_ptr()
        assert m.replay.states.data_ptr() == a.ring.states[i].data_ptr()
    assert sum(c["captures"] for c in graphs.COUNTS.values()) > 0
    graphs.reset_counts()
    reads = a.readbacks
    for m in a.members:
        m._defer_updates = True
    k = a.members[0]._chunk_size()
    if kind == "epoch":
        a._run_epoch_chunk(16, k)
        assert dict(graphs.COUNTS) == {"epoch": {"captures": 0,
                                                 "replays": 1}}
        assert a.readbacks == reads + 1
    else:
        for m in a.members:
            m._run_chunk(16, k)
        a._dispatch_updates()
        assert dict(graphs.COUNTS) == {"update": {"captures": 0,
                                                  "replays": 1}}



# ---------------------------------------------------------------------------
# The training path: K1 under autograd, the train step against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3072, 256), (4096, 896), (7, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_gpu_fake_quant_ste_gradient_is_identity(cuda, shape, dtype, bits):
    """K1's straight-through route under autograd, as a QAT forward runs
    it (``core.quantization.fake_quant`` on a card tensor): the forward
    equals the plain chain exactly and ``x.grad`` is the upstream
    gradient bit for bit."""
    from repro_torch.core.quantization import fake_quant
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_normal(1, shape)).to(cuda).to(dt)
    x.requires_grad_(True)
    build.reset_launches()
    y = fake_quant(x, bits)
    assert build.LAUNCHES["fake_quant"] == 1 and y.grad_fn is not None
    xf = x.detach().float()
    chain = (xf + (fake_quant_ref(xf, bits) - xf)).to(dt)
    assert torch.equal(y.detach(), chain)
    gy = torch.from_numpy(_normal(2, shape)).to(cuda).to(dt)
    y.backward(gy)
    assert torch.equal(x.grad, gy)


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu(cuda):
    """``chip_smoke.py``'s ``[training path]`` b: qwen2-0.5b SMOKE in f32,
    one train step on the card against the CPU's plain route (loss 1e-5,
    gradients 1e-6, updated leaves 1e-5), then one QAT step with
    ``k1_calls``' count of K1 launches and its loss within
    ``QAT_LOSS_TOL`` (``check_train_device_vs_cpu`` raises otherwise)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    out = chip_smoke.check_train_device_vs_cpu(cuda)
    assert out["qat"] <= chip_smoke.QAT_LOSS_TOL


# ---------------------------------------------------------------------------
# The trainer path: K6, K7 and K8 under autograd
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", range(7))
def test_gpu_kernels_under_autograd(cuda, case):
    """``chip_smoke.py``'s ``[trainer path]`` a at the JAX tests' shapes:
    K6 (f32 causal and windowed, bf16), K7 (with and without h0), K8 (two
    chunks): the forward bit-equal to the no-grad launch, one launch and
    none in the backward, each input's gradient the plain chain's
    (``check_kernel_grad`` raises otherwise)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    cases = chip_smoke.kernel_grad_cases(cuda)
    assert len(cases) == 7
    kind, xs, extra, what = cases[case]
    out = chip_smoke.check_kernel_grad(kind, xs, extra, what)
    assert out["equal"] or out["rel"] <= chip_smoke.AUTOGRAD_REL_TOL


# ---------------------------------------------------------------------------
# The MoE and frontend slice: K6 at head dim 80, K1 on expert stacks
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H", [(200, 4), (4096, 16)])
@pytest.mark.parametrize("causal,window", FA_MASKS)
def test_gpu_flash_attention_d80(cuda, dtype, S, H, causal, window):
    """hubert-xlarge's head dim 80 (MHA: 16 / 16 heads at S 4096, and a
    ragged S): bf16 takes the tensor-core route (one ``flash_attention``
    and one ``flash_attention_tc`` launch), f32 the CUDA-core route (no
    ``flash_attention_tc`` launch); against the dense plain version at
    f32's 2e-5, bf16's 0.04 and each row within 2^-6."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(80 + S, 1, S, H, H, 80, dt, cuda)
    before = (build.LAUNCHES["flash_attention"],
              build.LAUNCHES["flash_attention_tc"])
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert (build.LAUNCHES["flash_attention"],
            build.LAUNCHES["flash_attention_tc"]) == (
        before[0] + 1, before[1] + int(dt == torch.bfloat16))
    assert got.dtype == dt
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    if dt == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        return
    torch.testing.assert_close(got.float(), want.float(), atol=0.04, rtol=0)
    rel = (got.float() - want.float()).norm(dim=-1) \
        / want.float().norm(dim=-1)
    assert float(rel.max()) <= 2.0 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("E,R,C", [(8, 768, 2048), (128, 56, 608),
                                   (4, 64, 97)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_fake_quant_expert_stack_view(cuda, E, R, C, dtype):
    """An MoE layer's expert stack [E, d, ff] quantized the way the block
    quantizes it on the card (``core.quantization.fake_quant_weight``:
    K1 straight-through on its [E·d, ff] view, read in place, one
    launch), bit for bit the plain version on that view (one range per
    channel over the experts and rows together); and the slot form over
    the stack shared by 4 policies (one at 32 bits), each slot exact."""
    from repro_torch.core.quantization import (fake_quant_weight,
                                               fake_quant_weight_slots)
    dt = getattr(torch, dtype)
    w = torch.from_numpy(_normal(E + C, (E, R, C))).to(cuda, dt)
    before = build.LAUNCHES["fake_quant"]
    got = fake_quant_weight(w, 4)
    assert build.LAUNCHES["fake_quant"] == before + 1
    assert got.shape == w.shape and got.dtype == dt
    view = w.reshape(E * R, C)
    assert view.data_ptr() == w.data_ptr()
    assert torch.equal(got.reshape(E * R, C), fake_quant_ste_ref(view, 4))
    bits = (2, 4, 8, 32)
    before = build.LAUNCHES["fake_quant_slots"]
    slots = fake_quant_weight_slots(view, bits)
    assert build.LAUNCHES["fake_quant_slots"] == before + 1
    assert torch.equal(slots, fake_quant_slots_ref(
        view.expand(len(bits), *view.shape), bits, True))


# ---------------------------------------------------------------------------
# The deployment slicer and the fleet
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_gpu_sliced_smoke_forward(cuda):
    """``chip_smoke.py``'s ``[slice and fleet path]`` SMOKE check:
    granite-3-8b's SMOKE config in f32 under a seeded FF-only policy, the
    sliced forward on the card against the masked one (within
    ``SLICE_SMOKE_TOL``) and against the CPU's sliced forward (argmax
    agreement >= 0.99; ``check_slice_smoke`` raises otherwise)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    out = chip_smoke.check_slice_smoke(cuda, seq=600)
    assert out["vs_masked"] <= chip_smoke.SLICE_SMOKE_TOL
    assert out["argmax_vs_cpu"] >= 0.99


@pytest.mark.gpu
def test_gpu_fleet_resume_is_bit_exact(cuda, tmp_path):
    """``launch.fleet.main`` on the card, two members, 24 episodes: the
    run stopped after 2 epochs and resumed by a fresh fleet equals the
    uninterrupted run bit for bit (records, agent and ring tensors, host
    mirrors, generators; ``fleet_cli_resume`` raises otherwise)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    out = chip_smoke.fleet_cli_resume(cuda, str(tmp_path), [
        "--members", "2", "--episodes", "24"])
    assert all(out["same"].values()) and out["resumed_at"] == 16
