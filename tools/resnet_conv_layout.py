#!/usr/bin/env python3
"""What the ResNet forward's conv layouts cost on one GPU.

    python3 tools/resnet_conv_layout.py

ResNet18 at CIFAR-10 widths (``RESNET18_CIFAR``, seeded f32 weights) on
256 seeded blob images, raw, as ``chip_smoke.py``'s ``[resnet path]``
validates it. The port keeps activations NHWC (so K1 reads them in
place) and hands cuDNN ``x.permute(0, 3, 1, 2)`` with the weight copied
into OIHW channels-last memory. Arms, each one forward's device time
(CUDA events, ``chip_smoke.cuda_ms``: queued ahead, and paced by the
host) and one profiled forward's kernels by class (cuDNN convs, cuDNN's
NHWC <-> NCHW layout transforms, PyTorch's copies):

* ``shipped``: the port as committed (run first and last);
* ``oihw``: the weight copied into plain (contiguous) OIHW instead;
* ``benchmark``: ``torch.backends.cudnn.benchmark = True`` (cuDNN times
  its algorithms and keeps the fastest);
* ``tf32``: ``torch.backends.cudnn.allow_tf32 = True`` (the search keeps
  it off, so that the card's forward matches the plain f32 one);
* ``nchw``: the activations kept NCHW-contiguous around each conv
  (``x.permute(0, 3, 1, 2).contiguous()`` in, the output back to NHWC
  with a copy): what a PyTorch-native model would hand cuDNN.

Prints the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch
    import torch.nn.functional as F
    import chip_smoke as C
    from repro_torch.configs.testbed import IMG_VAL_BATCH, RESNET18_CIFAR
    from repro_torch.core.compress import CompressibleResNet
    from repro_torch.data.pipeline import blob_images
    from repro_torch.models import resnet as R

    if not torch.cuda.is_available():
        print("resnet_conv_layout: needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    device = torch.device("cuda", 0)
    cfg = RESNET18_CIFAR
    cm = CompressibleResNet(cfg, R.init(cfg, seed=0, device=device))
    val = blob_images(cfg.num_classes, IMG_VAL_BATCH, cfg.img_size, seed=7,
                      device=device)
    shipped_oihw, shipped_conv2d = R._oihw, F.conv2d

    def oihw_plain(w, qs, K):
        return shipped_oihw(w, qs, K).contiguous()

    def conv2d_nchw(x, w, **kw):
        y = shipped_conv2d(x.contiguous(), w.contiguous(), **kw)
        return y.contiguous(memory_format=torch.channels_last)

    arms = {
        "shipped": {},
        "oihw": {"oihw": oihw_plain},
        "benchmark": {"benchmark": True},
        "tf32": {"tf32": True},
        "nchw": {"conv2d": conv2d_nchw},
    }
    want = cm.logits(val)
    rows = []
    for name in list(arms) + ["shipped"]:
        arm = arms[name]
        R._oihw = arm.get("oihw", shipped_oihw)
        R.F.conv2d = arm.get("conv2d", shipped_conv2d)
        torch.backends.cudnn.benchmark = arm.get("benchmark", False)
        torch.backends.cudnn.allow_tf32 = arm.get("tf32", False)
        try:
            got = cm.logits(val)
            err = float((got - want).abs().max() / want.abs().max())
            ms, paced = C.cuda_ms(lambda: cm.logits(val), 10, 3)
            prof = C.profile_resnet_forward(cm, val, None)
        finally:
            R._oihw, R.F.conv2d = shipped_oihw, shipped_conv2d
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.allow_tf32 = False
        cls = prof["classes"]
        rows.append((name, ms, paced, err, cls))
        print(f"{name:9s} {ms:8.3f} ms device, {paced:8.3f} ms paced; "
              f"max |logit - shipped| / max |logit| {err:.3g}; " + ", ".join(
                  f"{c} {us / 1e3:.3f} ms / {n}"
                  for c, (us, n) in sorted(cls.items())) + f"; {C.CARD}",
              flush=True)
        for k, n in sorted(prof["kernels"].items()):
            print(f"    {n:4d} x {k}")
    print(C.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main())
