"""Small ResNet, the paper's own testbed family (ResNet18 / CIFAR-10), with
channel-prunable, quantizable convs: the counterpart of the JAX package's
``models/resnet.py``. GroupNorm replaces BatchNorm, as there.

Layouts are the JAX package's: weights [kh, kw, cin, cout] (HWIO) and
activations NHWC, so the fake quant reduces over the same axes and K1
reads both in place: a weight as its row-major [kh·kw·cin, cout] view
(one range per output channel), an activation as its [B·H·W, C] view.
Each conv is one cuDNN call on the channels-last view of x
(``x.permute(0, 3, 1, 2)``, free), with the weight turned OIHW in
channels-last memory (``_oihw``: the one copy of each conv's weight per
forward); the output comes back to NHWC with ``permute(0, 2, 3, 1)``,
also free. XLA's "SAME" padding is asymmetric where the stride leaves a
remainder (stride 2, 3x3, an even size pads (0, 1)); cuDNN takes only
symmetric pads, so those convs pad x explicitly (``F.pad``, a copy) and
the others pass their pad to the conv. GroupNorm is written in NHWC
(``_gn``), with no layout copy.

``cspec`` is a list (one entry per conv, in ``layer_specs`` order, then
the head) of ``{"qs": {"w_bits", "a_bits"} | None, "mask": [C_out] |
None}``. A batched cspec ``{"layers": [...], "slots": K}`` holds K
policies (bits as K-tuples, or [K] int32 device tensors in the fused
engine's epoch graph; masks [K, C_out]; what the JAX package gets from
``vmap`` over stacked cspecs). Its forward keeps the K slots'
channels side by side (activations [B, H, W, K·C]): each conv is one
grouped cuDNN call (``groups=K``), GroupNorm takes K·g groups, each
fake-quant site is one K1 launch over the slots (``fake_quant_act_slots``
reads the [K, B·H·W, C] view in place), and ``forward`` returns
[K, B, classes].
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.quantization import (fake_quant_act, fake_quant_act_slots,
                                 fake_quant_weight, fake_quant_weight_slots,
                                 slotted)
from ..core.spec import LayerSpec
from .layers import product_slots

# The JAX package's ResNet forward reads ``p["w"]`` of every conv and of
# the head, so a tree with deployed int8 / packed-int4 containers fails
# there with a KeyError; the port's forward refuses such a tree up front.
RAW_ONLY = ("the ResNet forward takes raw weights only: the JAX package's "
            "resnet._conv reads p['w'] (src/repro/models/resnet.py:49, the "
            "head at :167) and fails with KeyError on an int8 or packed-int4 "
            "container, so the port deploys no ResNet container either")


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet-tiny"
    stages: Tuple[int, ...] = (2, 2, 2, 2)     # blocks per stage (ResNet18: 2,2,2,2)
    widths: Tuple[int, ...] = (16, 32, 64, 128)
    num_classes: int = 10
    in_channels: int = 3
    img_size: int = 16
    gn_groups: int = 8


def _conv_init(gen, kh, kw, cin, cout, device):
    fan = kh * kw * cin
    return {"w": torch.randn((kh, kw, cin, cout), generator=gen,
                             device=device) * math.sqrt(2.0 / fan)}


def init(cfg: ResNetConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded random f32 weights from the port's own ``torch.Generator``
    (a different stream from the JAX package's keys: to hold the two
    against each other, carry the JAX weights over with
    ``repro_torch.convert.resnet_params``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {"stem": _conv_init(gen, 3, 3, cfg.in_channels, cfg.widths[0],
                                 device)}
    stages = []
    cin = cfg.widths[0]
    for si, (n, w) in enumerate(zip(cfg.stages, cfg.widths)):
        blocks = []
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            blk = {"conv1": _conv_init(gen, 3, 3, cin, w, device),
                   "conv2": _conv_init(gen, 3, 3, w, w, device)}
            if stride != 1 or cin != w:
                blk["skip"] = _conv_init(gen, 1, 1, cin, w, device)
            blocks.append(blk)
            cin = w
        stages.append(blocks)
    params["stages"] = stages
    params["head"] = {
        "w": torch.randn((cin, cfg.num_classes), generator=gen,
                         device=device) / math.sqrt(cin),
        "b": torch.zeros((cfg.num_classes,), device=device)}
    return params


def _iter_convs(cfg: ResNetConfig):
    """Yield (name, stage_idx, block_idx, which, stride, cin, cout,
    prunable)."""
    yield ("stem", -1, -1, "stem", 1, cfg.in_channels, cfg.widths[0], False)
    cin = cfg.widths[0]
    for si, (n, w) in enumerate(zip(cfg.stages, cfg.widths)):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            # conv1 output channels are free to prune (internal dim)
            yield (f"s{si}.b{bi}.conv1", si, bi, "conv1", stride, cin, w, True)
            # conv2 feeds the residual sum — dependency, not prunable
            yield (f"s{si}.b{bi}.conv2", si, bi, "conv2", 1, w, w, False)
            if stride != 1 or cin != w:
                yield (f"s{si}.b{bi}.skip", si, bi, "skip", stride, cin, w,
                       False)
            cin = w


def layer_specs(cfg: ResNetConfig) -> list[LayerSpec]:
    specs = []
    hw = cfg.img_size
    idx = 0
    for (name, si, bi, which, stride, cin, cout, prunable) in _iter_convs(cfg):
        if which == "conv1" and bi == 0 and si > 0:
            hw = max(1, hw // 2)
        k = 1 if which == "skip" else 3
        px = hw * hw
        specs.append(LayerSpec(
            name=name, kind="conv", layer_idx=idx, in_dim=cin, out_dim=cout,
            prunable=prunable, prune_dim=cout if prunable else 0,
            prune_granularity=8,  # TPU sublane multiple for conv channels
            dep_group="" if prunable else "residual",
            quantizable=True, mix_supported=(which != "stem"),
            flops_per_token=2.0 * k * k * cin * cout * px,
            weight_elems=k * k * cin * cout,
            act_elems_per_token=cin * px,
            extra={"px": px}))
        idx += 1
    specs.append(LayerSpec(
        name="head", kind="head", layer_idx=idx,
        in_dim=cfg.widths[-1], out_dim=cfg.num_classes,
        prunable=False, quantizable=True, mix_supported=False,
        flops_per_token=2.0 * cfg.widths[-1] * cfg.num_classes,
        weight_elems=cfg.widths[-1] * cfg.num_classes,
        act_elems_per_token=cfg.widths[-1]))
    return specs


def same_pads(size: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding of one spatial dim: (low, high), the odd pixel
    on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _gn(x: torch.Tensor, groups: int, slots: int = 1) -> torch.Tensor:
    """GroupNorm without affine in NHWC, x [B, H, W, slots·C]: per slot
    ``gcd(groups, C)`` groups of adjacent channels, each normalized by
    its mean and population variance over (H, W, the group's channels),
    eps 1e-5. Reads x in place (a reshape of the NHWC layout)."""
    B, H, W, C = x.shape
    g = math.gcd(groups, C // slots) * slots
    xr = x.reshape(B, H * W, g, C // g)
    var, mu = torch.var_mean(xr, dim=(1, 3), unbiased=False, keepdim=True)
    return ((xr - mu) * torch.rsqrt(var + 1e-5)).reshape(B, H, W, C)


def _raw(p: dict) -> torch.Tensor:
    if "w" not in p:
        raise ValueError(f"{RAW_ONLY}; got a container with {sorted(p)}")
    return p["w"]


def _quant_act(x: torch.Tensor, qs: Optional[dict], K: int,
               shared: bool = False) -> torch.Tensor:
    """x [..., K·C] (``shared``: [..., C], one input of every slot) ->
    each slot's channels fake-quantized at its ``a_bits``, [..., K·C].
    One K1 launch (over the K slots in a batched forward, reading x's
    [K, rows, C] view in place); the result comes back side by side, one
    copy."""
    if qs is None and not (shared and K > 1):
        return x
    bits = (32,) * K if qs is None else qs["a_bits"]
    if not slotted(bits):
        return fake_quant_act(x, bits)
    C = x.shape[-1] if shared else x.shape[-1] // K
    rows = x.reshape(-1, C)
    xs = rows.expand(K, *rows.shape) if shared else \
        x.reshape(-1, K, C).transpose(0, 1)
    out = fake_quant_act_slots(xs, bits).transpose(0, 1)
    return out.reshape(*x.shape[:-1], K * C)


def _oihw(w: torch.Tensor, qs: Optional[dict], K: int) -> torch.Tensor:
    """An HWIO weight [kh, kw, cin, cout], fake-quantized at each slot's
    ``w_bits`` (per output channel, on its [kh·kw·cin, cout] view), as
    the OIHW [K·cout, cin, kh, kw] weight of a conv with ``groups=K``, in
    channels-last memory: the one copy of the weight."""
    kh, kw, cin, cout = w.shape
    flat = w.reshape(-1, cout)
    bits = None if qs is None else qs["w_bits"]
    if bits is None:
        ws = flat.expand(K, *flat.shape)
    elif not slotted(bits):
        ws = fake_quant_weight(flat, bits)[None]
    else:
        ws = fake_quant_weight_slots(flat, bits)
    return (ws.reshape(K, kh, kw, cin, cout).permute(0, 4, 1, 2, 3)
            .contiguous().reshape(K * cout, kh, kw, cin).permute(0, 3, 1, 2))


def _conv(p: dict, x: torch.Tensor, stride: int, qs=None, mask=None,
          K: int = 1, shared: bool = False) -> torch.Tensor:
    """One (grouped, K slots) conv of NHWC x under ``qs``, SAME-padded as
    XLA pads, then the pruning mask on its output channels."""
    w = _raw(p)
    k = w.shape[0]
    wt = _oihw(w, qs, K)
    xc = _quant_act(x, qs, K, shared).permute(0, 3, 1, 2)
    (top, bottom), (left, right) = (same_pads(n, k, stride)
                                    for n in xc.shape[2:])
    if (top, left) == (bottom, right):
        pad = (top, left)
    else:
        xc, pad = F.pad(xc, (left, right, top, bottom)), 0
    y = F.conv2d(xc, wt, stride=stride, padding=pad, groups=K)
    y = y.permute(0, 2, 3, 1)
    if mask is not None:
        y = y * mask.reshape(-1).to(y.dtype)
    return y


def forward(cfg: ResNetConfig, params, x: torch.Tensor, cspec=None
            ) -> torch.Tensor:
    """x: [B, H, W, C] -> logits [B, num_classes]; under a batched cspec
    of K policies, [K, B, num_classes]."""
    K = 1
    layers = cspec
    if isinstance(cspec, dict):
        K, layers = cspec["slots"], cspec["layers"]

    def entry(i):
        e = (layers[i] if layers is not None else None) or {}
        return e.get("qs") or None, e.get("mask")

    i = 0
    qs, mask = entry(i)
    h = _conv(params["stem"], x, 1, qs, mask, K, shared=True)
    h = torch.relu(_gn(h, cfg.gn_groups, K))
    i += 1
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            qs, mask = entry(i)
            y = _conv(blk["conv1"], h, stride, qs, mask, K)
            y = torch.relu(_gn(y, cfg.gn_groups, K))
            i += 1
            qs, mask = entry(i)
            y = _conv(blk["conv2"], y, 1, qs, mask, K)
            y = _gn(y, cfg.gn_groups, K)
            i += 1
            if "skip" in blk:
                qs, mask = entry(i)
                h = _conv(blk["skip"], h, stride, qs, mask, K)
                i += 1
            h = torch.relu(h + y)
    h = torch.mean(h, dim=(1, 2))
    w, b = _raw(params["head"]), params["head"]["b"]
    qs, _ = entry(i)
    if not isinstance(cspec, dict):
        if qs is not None:
            h = fake_quant_act(h, qs["a_bits"])
            w = fake_quant_weight(w, qs["w_bits"])
        return h @ w + b
    hs = h.reshape(-1, K, w.shape[0]).transpose(0, 1)        # [K, B, C]
    ws = w.expand(K, *w.shape)
    if qs is not None:
        hs = fake_quant_act_slots(hs, qs["a_bits"])
        ws = fake_quant_weight_slots(w, qs["w_bits"])
    return product_slots(hs, ws, h.dtype) + b
