"""The testbeds of the Galen search: the JAX package's ``LM_CFG``,
``SERVE_CTX``, ``RESNET_CFG`` and ``IMG_CTX`` (``benchmarks/common.py``),
copied so the port's entry points need nothing of that package, and the
paper's own model at its CIFAR-10 widths, ``RESNET18_CIFAR``.

4 layers, d_model 256, 8 heads / 4 KV heads of 32, d_ff 1024, vocab 256,
bf16 compute: every unit is 256-aligned, so the MIX (int4) option is legal
everywhere and the paper's full action space is reachable. The oracle's
context is single-stream decode at a 512-token context (batch 1).
"""
from __future__ import annotations

from ..core.latency import LatencyContext
from ..models.resnet import ResNetConfig
from .base import ArchConfig

LM_CFG = ArchConfig(name="testbed-lm", num_layers=4, d_model=256,
                    num_heads=8, num_kv_heads=4, head_dim=32, d_ff=1024,
                    vocab_size=256, scan_layers=True)

SERVE_CTX = LatencyContext(tokens=1, seq_ctx=512, mode="decode", batch=1)

# The JAX trainer's validation batch: 64 sequences of 48 tokens.
VAL_BATCH, VAL_SEQ = 64, 48

# The JAX package's ResNet testbed (``benchmarks/search_setup.py``'s
# ``resnet_search``): 3 stages of 2 blocks, widths 16 / 32 / 64, 16 x 16
# images, 10 classes. The oracle's context is per-image latency at batch 1.
RESNET_CFG = ResNetConfig(name="testbed-resnet", stages=(2, 2, 2),
                          widths=(16, 32, 64), num_classes=10, img_size=16)

IMG_CTX = LatencyContext(tokens=1, seq_ctx=0, mode="prefill", batch=1)

# ResNet18 at CIFAR-10 shape (He et al., arXiv:1512.03385, the CIFAR
# variant: a 3x3 stem at stride 1, no max-pool), the model of the paper's
# headline result: 20 convs (the stem, 16 block convs, 3 1x1 skips) and a
# head, ~11.2 M parameters, ~0.56 GMAC per image. GroupNorm in place of
# BatchNorm, as in the JAX package's model.
RESNET18_CIFAR = ResNetConfig(name="resnet18-cifar10", stages=(2, 2, 2, 2),
                              widths=(64, 128, 256, 512), num_classes=10,
                              in_channels=3, img_size=32)

# The JAX trainer's ResNet validation batch: 256 images.
IMG_VAL_BATCH = 256
