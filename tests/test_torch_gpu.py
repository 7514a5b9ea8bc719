"""The hand-written CUDA kernels against their plain PyTorch versions, on
a card. Every test here carries the ``gpu`` marker and skips without
CUDA (decided in a fixture, never at import).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch. There, skip the repo's ``conftest.py``
(it imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: K1 (fake-quant) and K3 (Polyak) exact — the plain versions
run the same correctly rounded f32 operations, one PyTorch kernel each;
K2 (3-layer MLP) forward and backward ≤1e-5 at the DDPG init's scales
(f32 sums in another order; no TF32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops as tops  # noqa: E402
from repro_torch.kernels.fake_quant import fake_quant_2d  # noqa: E402
from repro_torch.kernels.mlp_fused import mlp3, polyak_flat  # noqa: E402
from repro_torch.kernels.ref import (fake_quant_ref, mlp3_ref,  # noqa: E402
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


@pytest.mark.gpu
@pytest.mark.parametrize("B,dims,final", [
    (64, (33, 400, 300, 3), "sigmoid"), (64, (36, 400, 300, 1), "linear"),
    (37, (9, 40, 30, 3), "sigmoid")])
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
    assert torch.equal(polyak_flat(t, p, 0.01), polyak_ref(t, p, 0.01))
