"""Apply a compression policy to a model: LayerSpec enumeration, cspec
building (quant bits + ℓ1 pruning masks), and the model adapters the
search and the sensitivity analysis call (``CompressibleLM``,
``CompressibleResNet``), and the deployment step that slices pruned
channels out of an unrolled LM (``slice_lm_params``).

Bits in a cspec are host ints (the scalar engine builds one cspec per
policy on the host); masks are float tensors on the model's device.

A batched cspec holds K policies for one forward (the batched engine's
validation): ``"slots": K``, bits as K-tuples of host ints, masks [K, n]
(a ResNet's: ``{"layers": [...], "slots": K}``).
``make_lm_cspec_builder`` / ``make_resnet_cspec_builder`` build it from
(K, L) keep / w_bits / a_bits arrays; ``stack_cspecs`` from K scalar
cspecs. Both give the same masks and bits as the scalar cspecs policy by
policy. Given (K, L) int tensors on the device (the fused engine's epoch
graph, whose policies never leave the card), the builders make the
device form: each site's bits a [K] int32 tensor that K1 reads
(``kernels.fake_quant.fake_quant_slots_dev``), each mask from the device
kept counts; a site that no spec makes quantizable keeps static 32-bit
tuples and launches nothing. ``accuracy_policy_fn`` is that validator,
(K, L) int32 tensors -> (K,) accuracies, read without a sync.
``log_probs_batch`` gives a batched cspec's [K, ...] log-probs (the fused
sensitivity analysis's probe chunks).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import blocks as B
from ..models import model as M
from ..models import resnet as R
from . import pruning
from .policy import Policy, PolicyBatch
from .spec import LayerCMP, LayerSpec, effective_bits


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def _head_granularity(head_dim: int, lane: int = 128) -> int:
    return _lcm(lane, head_dim) // head_dim if head_dim else 1


def lm_layer_specs(cfg: ArchConfig) -> List[LayerSpec]:
    """The compressible units of an LM of any family, in the JAX
    package's order: embed, then per layer its units, then head. Pure
    shape arithmetic (the oracle and ``launch.inputs.model_flops`` read
    it for every config)."""
    specs: List[LayerSpec] = []
    d = cfg.d_model
    if cfg.frontend != "audio_stub":
        specs.append(LayerSpec(
            name="embed", kind="embed", layer_idx=-1, in_dim=cfg.vocab_size,
            out_dim=d, quantizable=True, mix_supported=False,
            weight_elems=cfg.vocab_size * d, act_elems_per_token=1))
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == "attn":
            H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            specs.append(LayerSpec(
                name=f"L{i}.attn_qkv", kind="attn_qkv", layer_idx=i,
                in_dim=d, out_dim=(H + 2 * KV) * hd,
                prunable=True, prune_dim=H,
                prune_granularity=_head_granularity(hd),
                flops_per_token=2.0 * d * (H + 2 * KV) * hd,
                weight_elems=d * (H + 2 * KV) * hd,
                act_elems_per_token=d,
                extra={"head_dim": hd, "kv_heads": KV}))
            specs.append(LayerSpec(
                name=f"L{i}.attn_out", kind="attn_out", layer_idx=i,
                in_dim=H * hd, out_dim=d, dep_group=f"L{i}.heads",
                flops_per_token=2.0 * H * hd * d,
                weight_elems=H * hd * d, act_elems_per_token=H * hd))
            if cfg.moe is not None:
                E, K, ff = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_ff
                gated = 2
                specs.append(LayerSpec(
                    name=f"L{i}.moe_up", kind="moe_up", layer_idx=i,
                    in_dim=d, out_dim=ff, prunable=True, prune_dim=ff,
                    prune_granularity=128,
                    flops_per_token=2.0 * K * d * ff * gated,
                    weight_elems=E * d * ff * gated, act_elems_per_token=K * d,
                    extra={"experts": E, "top_k": K}))
                specs.append(LayerSpec(
                    name=f"L{i}.moe_down", kind="moe_down", layer_idx=i,
                    in_dim=ff, out_dim=d, dep_group=f"L{i}.moe_ff",
                    flops_per_token=2.0 * K * ff * d,
                    weight_elems=E * ff * d, act_elems_per_token=K * ff,
                    extra={"experts": E, "top_k": K}))
                if cfg.moe.dense_residual:
                    specs.append(LayerSpec(
                        name=f"L{i}.dense_up", kind="mlp_up", layer_idx=i,
                        in_dim=d, out_dim=ff, prunable=True, prune_dim=ff,
                        prune_granularity=128,
                        flops_per_token=2.0 * d * ff * gated,
                        weight_elems=d * ff * gated, act_elems_per_token=d,
                        extra={"dense_residual": True}))
                    specs.append(LayerSpec(
                        name=f"L{i}.dense_down", kind="mlp_down", layer_idx=i,
                        in_dim=ff, out_dim=d, dep_group=f"L{i}.dense_ff",
                        flops_per_token=2.0 * ff * d,
                        weight_elems=ff * d, act_elems_per_token=ff,
                        extra={"dense_residual": True}))
            else:
                ff = cfg.d_ff
                gated = 2 if cfg.mlp in ("swiglu", "geglu") else 1
                specs.append(LayerSpec(
                    name=f"L{i}.mlp_up", kind="mlp_up", layer_idx=i,
                    in_dim=d, out_dim=ff, prunable=True, prune_dim=ff,
                    prune_granularity=128,
                    flops_per_token=2.0 * d * ff * gated,
                    weight_elems=d * ff * gated, act_elems_per_token=d))
                specs.append(LayerSpec(
                    name=f"L{i}.mlp_down", kind="mlp_down", layer_idx=i,
                    in_dim=ff, out_dim=d, dep_group=f"L{i}.ff",
                    flops_per_token=2.0 * ff * d,
                    weight_elems=ff * d, act_elems_per_token=ff))
        elif kind == "ssm":
            d_inner, nheads, conv_dim = B.ssm_dims(cfg)
            d_proj = 2 * d_inner + 2 * cfg.ssm.d_state + nheads
            specs.append(LayerSpec(
                name=f"L{i}.ssm_in", kind="ssm_in", layer_idx=i,
                in_dim=d, out_dim=d_proj, prunable=True, prune_dim=nheads,
                prune_granularity=_head_granularity(cfg.ssm.head_dim),
                flops_per_token=2.0 * d * d_proj,
                weight_elems=d * d_proj, act_elems_per_token=d,
                extra={"head_dim": cfg.ssm.head_dim,
                       "d_state": cfg.ssm.d_state}))
            specs.append(LayerSpec(
                name=f"L{i}.ssm_out", kind="ssm_out", layer_idx=i,
                in_dim=d_inner, out_dim=d, dep_group=f"L{i}.ssm_heads",
                flops_per_token=2.0 * d_inner * d,
                weight_elems=d_inner * d, act_elems_per_token=d_inner))
        elif kind == "rglru":
            w = cfg.lru_width
            specs.append(LayerSpec(
                name=f"L{i}.rglru_in", kind="rglru_in", layer_idx=i,
                in_dim=d, out_dim=2 * w, prunable=True, prune_dim=w,
                prune_granularity=128,
                flops_per_token=2.0 * d * 2 * w,
                weight_elems=d * 2 * w, act_elems_per_token=d))
            specs.append(LayerSpec(
                name=f"L{i}.rglru_out", kind="rglru_out", layer_idx=i,
                in_dim=w, out_dim=d, dep_group=f"L{i}.lru",
                flops_per_token=2.0 * w * d,
                weight_elems=w * d, act_elems_per_token=w))
            ff = cfg.d_ff
            gated = 2 if cfg.mlp in ("swiglu", "geglu") else 1
            specs.append(LayerSpec(
                name=f"L{i}.mlp_up", kind="mlp_up", layer_idx=i,
                in_dim=d, out_dim=ff, prunable=True, prune_dim=ff,
                prune_granularity=128,
                flops_per_token=2.0 * d * ff * gated,
                weight_elems=d * ff * gated, act_elems_per_token=d))
            specs.append(LayerSpec(
                name=f"L{i}.mlp_down", kind="mlp_down", layer_idx=i,
                in_dim=ff, out_dim=d, dep_group=f"L{i}.ff",
                flops_per_token=2.0 * ff * d,
                weight_elems=ff * d, act_elems_per_token=ff))
    specs.append(LayerSpec(
        name="head", kind="head", layer_idx=cfg.num_layers,
        in_dim=d, out_dim=cfg.vocab_size, quantizable=True,
        mix_supported=False,
        flops_per_token=2.0 * d * cfg.vocab_size,
        weight_elems=d * cfg.vocab_size, act_elems_per_token=d))
    return specs


# ===========================================================================
# cspec building (quant bits + ℓ1 masks)
# ===========================================================================

def _qs(cmp: Optional[LayerCMP]) -> dict:
    """QS dict; a missing CMP is FP32 pass-through."""
    w, a = effective_bits(cmp) if cmp is not None else (32, 32)
    return {"w_bits": w, "a_bits": a}


def _unit_prune_scores(cfg: ArchConfig, p_l, kind: str) -> torch.Tensor:
    """ℓ1 scores of one unit's prunable dim. ``moe_up``: the expert
    stacks ``w_up`` and ``w_gate`` [E, d, ff] reduced over the experts
    and rows; in an MoE layer ``mlp_up`` is the dense residual's."""
    if kind == "attn_qkv":
        return pruning.head_scores(p_l["attn"]["wq"]["w"], cfg.num_heads)
    if kind == "moe_up":
        return pruning.l1_scores([p_l["moe"]["w_up"], p_l["moe"]["w_gate"]])
    if kind == "mlp_up" and "moe" in p_l:
        return pruning.l1_scores([p_l["moe"]["dense_w_up"],
                                  p_l["moe"]["dense_w_gate"]])
    if kind == "mlp_up":
        ws = [p_l["mlp"]["w_up"]["w"]]
        if "w_gate" in p_l["mlp"]:
            ws.append(p_l["mlp"]["w_gate"]["w"])
        return pruning.l1_scores(ws)
    if kind == "ssm_in":
        d_inner, nheads, _ = B.ssm_dims(cfg)
        return pruning.head_scores(
            p_l["ssm"]["in_proj"][:, d_inner:2 * d_inner], nheads)
    if kind == "rglru_in":
        return pruning.l1_scores([p_l["rglru"]["w_x"], p_l["rglru"]["w_y"]])
    raise ValueError(kind)


def prune_kinds(cfg: ArchConfig, layer_kind: str) -> tuple:
    """The prunable units of a layer of ``layer_kind``, whose ℓ1 scores a
    cspec reads: an attention layer's heads and its MLP's (or its MoE
    experts' and dense residual's) hidden channels, an SSM layer's heads,
    an RG-LRU layer's width and its MLP's hidden channels."""
    if layer_kind == "attn" and cfg.moe is not None:
        return ("attn_qkv", "moe_up") + (
            ("mlp_up",) if cfg.moe.dense_residual else ())
    return {"attn": ("attn_qkv", "mlp_up"), "ssm": ("ssm_in",),
            "rglru": ("rglru_in", "mlp_up")}[layer_kind]


def _moe_cspec(cfg: ArchConfig, qs, mask) -> dict:
    """An MoE layer's ``"moe"`` entry from a builder's ``qs(unit)`` and
    ``mask(unit, dim)``: the experts' bits and ff mask, and the dense
    residual's (``None`` where the config has none), as the JAX package
    lays it out."""
    moe = {"up": qs("moe_up"), "down": qs("moe_down"),
           "ff_mask": mask("moe_up", cfg.d_ff),
           "dense_up": None, "dense_down": None, "dense_ff_mask": None}
    if cfg.moe.dense_residual:
        moe.update(dense_up=qs("mlp_up"), dense_down=qs("mlp_down"),
                   dense_ff_mask=mask("mlp_up", cfg.d_ff))
    return moe


def build_lm_cspec(cfg: ArchConfig, params, policy: Policy,
                   specs: Sequence[LayerSpec], scores=None) -> dict:
    """The cspec of ``policy``: per attention layer ``{"attn": {"qkv",
    "o", "head_mask"}, "mlp": {"up", "down", "ff_mask"}}`` (an MoE
    layer ``"moe"`` in place of ``"mlp"``: ``_moe_cspec``), per SSM layer
    ``{"ssm": {"in", "out", "head_mask"}}`` (SSD heads pruned at the
    ``ssm_in`` unit), per RG-LRU layer ``{"rglru": {"in", "out",
    "width_mask"}, "mlp": {...}}`` (LRU channels pruned at the
    ``rglru_in`` unit), plus the embed and head bits. Masks are always
    present (ones when unpruned), as in the JAX package. ``scores`` may
    hold precomputed ``(layer, kind) -> ℓ1 scores``; they do not depend
    on the policy."""
    by_layer: dict[int, dict[str, LayerCMP]] = {}
    embed_bits = head_bits = None
    for s, c in zip(specs, policy.cmps):
        if s.kind == "embed":
            embed_bits = effective_bits(c)[0]
        elif s.kind == "head":
            head_bits = effective_bits(c)[0]
        else:
            by_layer.setdefault(s.layer_idx, {})[s.kind] = c

    device = M.device_of(params)

    def mask(i, kind, cmp, dim):
        if cmp is None or cmp.keep >= dim:
            return torch.ones((dim,), dtype=torch.float32, device=device)
        sc = scores.get((i, kind)) if scores is not None else None
        if sc is None:
            sc = _unit_prune_scores(cfg, params["blocks"][i], kind)
        return pruning.keep_mask(sc, cmp.keep)

    layer_cspecs = []
    for i, kind in enumerate(cfg.layer_kinds):
        cm = by_layer.get(i, {})
        if kind == "ssm":
            ci, co = cm.get("ssm_in"), cm.get("ssm_out")
            layer_cspecs.append({"ssm": {
                "in": _qs(ci), "out": _qs(co),
                "head_mask": mask(i, "ssm_in", ci, B.ssm_dims(cfg)[1])}})
            continue
        if kind == "attn":
            cq, co = cm.get("attn_qkv"), cm.get("attn_out")
            cs = {"attn": {"qkv": _qs(cq), "o": _qs(co),
                           "head_mask": mask(i, "attn_qkv", cq,
                                             cfg.num_heads)}}
        elif kind == "rglru":
            ci, co = cm.get("rglru_in"), cm.get("rglru_out")
            cs = {"rglru": {"in": _qs(ci), "out": _qs(co),
                            "width_mask": mask(i, "rglru_in", ci,
                                               cfg.lru_width)}}
        else:
            raise ValueError(f"layer {i}: no cspec for kind {kind!r}")
        if kind == "attn" and cfg.moe is not None:
            cs["moe"] = _moe_cspec(
                cfg, lambda unit: _qs(cm.get(unit)),
                lambda unit, dim: mask(i, unit, cm.get(unit), dim))
        else:
            cu, cd = cm.get("mlp_up"), cm.get("mlp_down")
            cs["mlp"] = {"up": _qs(cu), "down": _qs(cd),
                         "ff_mask": mask(i, "mlp_up", cu, cfg.d_ff)}
        layer_cspecs.append(cs)
    out: dict[str, Any] = {"blocks": layer_cspecs}
    if embed_bits is not None:
        out["embed_bits"] = embed_bits
    if head_bits is not None:
        out["head_bits"] = head_bits
    return out


def _lm_prune_scores(cfg: ArchConfig, params,
                     specs: Sequence[LayerSpec]) -> dict:
    """spec index -> ℓ1 scores of its prunable dim (the selection of
    ``build_lm_cspec``, for every prunable unit)."""
    return {idx: _unit_prune_scores(cfg, params["blocks"][s.layer_idx],
                                    s.kind)
            for idx, s in enumerate(specs) if s.prunable and s.prune_dim}


def make_lm_cspec_builder(cfg: ArchConfig, params,
                          specs: Sequence[LayerSpec]):
    """Returns ``build(keep, w_bits, a_bits) -> batched cspec`` for (K, L)
    arrays (a ``PolicyBatch``'s, or int tensors on the device: the module
    docstring): per unit the K bits, per mask the K
    ``pruning.keep_mask_dynamic`` masks [K, dim] from the ℓ1 scores
    computed (and sorted) here once. Policy by policy it gives
    ``build_lm_cspec``'s bits and masks (the same scores and ties)."""
    scores = _lm_prune_scores(cfg, params, specs)
    ranked = _sorted(scores)
    device = M.device_of(params)
    pos: dict = {}
    for idx, s in enumerate(specs):
        pos[s.kind if s.kind in ("embed", "head")
            else (s.layer_idx, s.kind)] = idx

    def build(keep, w_bits, a_bits) -> dict:
        keep, w_bits, a_bits, bits = _policy_columns(keep, w_bits, a_bits)
        K = keep.shape[0]

        def qs(key):
            i = pos.get(key)
            if i is None:
                return {"w_bits": (32,) * K, "a_bits": (32,) * K}
            return {"w_bits": bits(w_bits, i), "a_bits": bits(a_bits, i)}

        def mask(key, dim):
            i = pos.get(key)
            if i is None or i not in scores:
                return torch.ones((K, dim), dtype=torch.float32,
                                  device=device)
            return pruning.keep_mask_dynamic(scores[i], keep[:, i],
                                             ranked[i])

        layer_cspecs = []
        for i, kind in enumerate(cfg.layer_kinds):
            if kind == "ssm":
                layer_cspecs.append({"ssm": {
                    "in": qs((i, "ssm_in")), "out": qs((i, "ssm_out")),
                    "head_mask": mask((i, "ssm_in"), B.ssm_dims(cfg)[1])}})
                continue
            if kind == "attn":
                cs = {"attn": {"qkv": qs((i, "attn_qkv")),
                               "o": qs((i, "attn_out")),
                               "head_mask": mask((i, "attn_qkv"),
                                                 cfg.num_heads)}}
            elif kind == "rglru":
                cs = {"rglru": {"in": qs((i, "rglru_in")),
                                "out": qs((i, "rglru_out")),
                                "width_mask": mask((i, "rglru_in"),
                                                   cfg.lru_width)}}
            else:
                raise ValueError(f"layer {i}: no cspec for kind {kind!r}")
            if kind == "attn" and cfg.moe is not None:
                cs["moe"] = _moe_cspec(
                    cfg, lambda unit: qs((i, unit)),
                    lambda unit, dim: mask((i, unit), dim))
            else:
                cs["mlp"] = {"up": qs((i, "mlp_up")),
                             "down": qs((i, "mlp_down")),
                             "ff_mask": mask((i, "mlp_up"), cfg.d_ff)}
            layer_cspecs.append(cs)
        out: dict[str, Any] = {"blocks": layer_cspecs, "slots": K}
        if "embed" in pos:
            out["embed_bits"] = bits(w_bits, pos["embed"])
        if "head" in pos:
            out["head_bits"] = bits(w_bits, pos["head"])
        return out

    return build


def _sorted(scores: dict) -> dict:
    """Each unit's ℓ1 scores sorted once, for ``keep_mask_dynamic``."""
    return {i: torch.sort(v).values for i, v in scores.items()}


def _policy_columns(keep, w_bits, a_bits):
    """A builder's (K, L) inputs as (keep, w_bits by site, a_bits by site,
    bits of a site): host arrays give each site's K-tuple of host ints;
    tensors stay on the device, each site's bits a contiguous [K] int32
    row of the transposed (L, K) tensor (what K1 reads)."""
    if isinstance(keep, torch.Tensor):
        return (keep, *(x.to(torch.int32).t().contiguous()
                        for x in (w_bits, a_bits)), lambda col, i: col[i])
    return (np.asarray(keep), np.asarray(w_bits).T, np.asarray(a_bits).T,
            lambda col, i: tuple(int(b) for b in col[i]))


def _resnet_prune_scores(cmodel: "CompressibleResNet") -> dict:
    """spec index -> ℓ1 scores of a prunable conv's output channels."""
    scores, conv_i = {}, 0
    for idx, s in enumerate(cmodel.specs):
        if s.kind == "conv":
            if s.prunable:
                scores[idx] = pruning.l1_scores([cmodel._conv_weight(conv_i)])
            conv_i += 1
    return scores


def make_resnet_cspec_builder(cmodel: "CompressibleResNet"):
    """The ResNet analogue of ``make_lm_cspec_builder``: ``build(keep,
    w_bits, a_bits) -> {"layers": [...], "slots": K}`` for (K, L) arrays
    (host arrays, or int tensors on the device: the module docstring),
    per entry the K bits and, for a prunable conv, the K
    ``pruning.keep_mask_dynamic`` masks [K, cout] from the ℓ1 scores of
    ``cmodel``, sorted once here."""
    specs = cmodel.specs
    scores = _resnet_prune_scores(cmodel)
    ranked = _sorted(scores)

    def build(keep, w_bits, a_bits) -> dict:
        keep, w_bits, a_bits, bits = _policy_columns(keep, w_bits, a_bits)
        layers = []
        for idx, s in enumerate(specs):
            entry: dict[str, Any] = {"qs": None, "mask": None}
            if s.quantizable:
                entry["qs"] = {"w_bits": bits(w_bits, idx),
                               "a_bits": bits(a_bits, idx)}
            if idx in scores:
                entry["mask"] = pruning.keep_mask_dynamic(
                    scores[idx], keep[:, idx], ranked[idx])
            layers.append(entry)
        return {"layers": layers, "slots": keep.shape[0]}

    return build


def stack_cspecs(cspecs: Sequence) -> dict:
    """K scalar cspecs as one batched cspec: bits as K-tuples, masks
    stacked into [K, n]. Their structure does not depend on the policy
    (masks always present, bits always set; see ``build_lm_cspec``), so
    they stack leaf by leaf. K ResNet cspecs (lists) stack into
    ``{"layers": [...], "slots": K}``."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        if isinstance(xs[0], list):
            return [stack(*leaves) for leaves in zip(*xs)]
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        if xs[0] is None:           # a ResNet conv that prunes nothing
            return None
        return tuple(int(x) for x in xs)

    out = stack(*cspecs)
    if isinstance(out, list):       # a ResNet's cspec is a list of entries
        out = {"layers": out}
    out["slots"] = len(cspecs)
    return out


# ===========================================================================
# Model adapter (the interface of the search / sensitivity analysis)
# ===========================================================================

class _BatchedAccuracyMixin:
    """The batched validation shared by both adapters (the JAX package's
    mixin of the same name): the batched-cspec builder, made once per
    params object, the (K,) accuracies of a ``PolicyBatch`` from one
    forward over its K policies (``accuracy_policy_batch``, through
    ``accuracy_batch``, per adapter), and the device validator of the
    fused engine's epoch graph (``accuracy_policy_fn``)."""

    def cspec_builder(self):
        """``_make_cspec_builder()`` for the current params, made once per
        params object."""
        cached = getattr(self, "_builder_cache", None)
        if cached is None or cached[0] is not self.params:
            self._builder_cache = (self.params, self._make_cspec_builder())
        return self._builder_cache[1]

    def build_cspec_batch(self, policies: Sequence[Policy]) -> dict:
        return stack_cspecs([self.build_cspec(p) for p in policies])

    def accuracy_policy_batch(self, batch: dict,
                              pbatch: PolicyBatch) -> torch.Tensor:
        """(K,) accuracies straight from a ``PolicyBatch``'s arrays: the
        batched cspec of ``cspec_builder`` and one forward."""
        return self.accuracy_batch(batch, self.cspec_builder()(
            pbatch.keep, pbatch.w_bits, pbatch.a_bits))

    def accuracy_policy_fn(self, batch: dict):
        """The device validator the fused engine's epoch graph runs:
        ``fn(keep, w_bits, a_bits)`` on (K, L) int32 tensors on the
        model's device -> (K,) accuracies, every bit and mask built on the
        device (``cspec_builder``'s device form), so nothing in it reads
        the policies back. Equal to ``accuracy_policy_batch`` on the same
        policies."""
        build = self.cspec_builder()
        return lambda keep, w_bits, a_bits: self.accuracy_batch(
            batch, build(keep, w_bits, a_bits))


@dataclass
class CompressibleLM(_BatchedAccuracyMixin):
    """Adapter: ArchConfig LM + params -> the search interface (scalar
    ``accuracy``, batched ``accuracy_policy_batch``, the fused engine's
    device validator ``accuracy_policy_fn``). All work runs on the device
    the params live on."""
    cfg: ArchConfig
    params: Any
    _scores: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        self.specs = lm_layer_specs(self.cfg)
        for i, layer_kind in enumerate(self.cfg.layer_kinds):
            for kind in prune_kinds(self.cfg, layer_kind):
                self._scores[(i, kind)] = _unit_prune_scores(
                    self.cfg, self.params["blocks"][i], kind)

    @property
    def device(self) -> torch.device:
        return M.device_of(self.params)

    def build_cspec(self, policy: Policy) -> dict:
        return build_lm_cspec(self.cfg, self.params, policy, self.specs,
                              self._scores)

    def _make_cspec_builder(self):
        return make_lm_cspec_builder(self.cfg, self.params, self.specs)

    @torch.no_grad()
    def accuracy_batch(self, batch: dict, stacked_cspec) -> torch.Tensor:
        """(K,) next-token top-1 accuracies of the K policies of a batched
        cspec, from one forward over all of them (a tensor on the
        device)."""
        lg = M.forward(self.cfg, self.params, batch["tokens"],
                       stacked_cspec)[:, :, :-1]
        tgt = batch["tokens"][None, :, 1:]
        return torch.mean((torch.argmax(lg, -1) == tgt).float(), (1, 2))

    @torch.no_grad()
    def logits(self, batch: dict, cspec=None) -> torch.Tensor:
        return M.forward(self.cfg, self.params, batch["tokens"], cspec)

    def log_probs(self, batch: dict, cspec=None) -> torch.Tensor:
        return torch.log_softmax(self.logits(batch, cspec), -1)

    @torch.no_grad()
    def log_probs_batch(self, batch: dict, stacked_cspec) -> torch.Tensor:
        """[C, B, S, V] log-probs of the C policies of a batched cspec,
        from one forward over all of them (the fused sensitivity's probe
        chunk)."""
        return torch.log_softmax(M.forward(
            self.cfg, self.params, batch["tokens"], stacked_cspec), -1)

    def accuracy(self, batch: dict, cspec=None) -> torch.Tensor:
        """Next-token top-1 accuracy (a 0-d tensor on the device)."""
        lg = self.logits(batch, cspec)[:, :-1]
        tgt = batch["tokens"][:, 1:]
        return torch.mean((torch.argmax(lg, -1) == tgt).float())


@dataclass
class CompressibleResNet(_BatchedAccuracyMixin):
    """Adapter: ResNetConfig + params -> the search interface (scalar
    ``accuracy``, batched ``accuracy_policy_batch``, the fused engine's
    device validator ``accuracy_policy_fn``), scored by top-1 accuracy
    over ``batch["labels"]``. All work runs on the device the params
    live on."""
    cfg: R.ResNetConfig
    params: Any
    _scores: dict = field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        self.specs = R.layer_specs(self.cfg)
        self._scores = _resnet_prune_scores(self)

    @property
    def device(self) -> torch.device:
        return self.params["stem"]["w"].device

    def build_cspec(self, policy: Policy) -> list:
        """One entry per spec: ``{"qs": bits, "mask": [cout] | None}``; a
        prunable conv's mask always present (ones when unpruned), as in
        the JAX package."""
        cspec = []
        for idx, (s, c) in enumerate(zip(self.specs, policy.cmps)):
            cspec.append({
                "qs": _qs(c) if s.quantizable else None,
                "mask": pruning.keep_mask(self._scores[idx], c.keep)
                if idx in self._scores else None})
        return cspec

    def _make_cspec_builder(self):
        return make_resnet_cspec_builder(self)

    def _conv_weight(self, idx: int) -> torch.Tensor:
        """The weight of the idx-th conv in ``layer_specs`` order."""
        if idx == 0:
            return self.params["stem"]["w"]
        i = 1
        for blocks in self.params["stages"]:
            for blk in blocks:
                for key in ("conv1", "conv2", "skip"):
                    if key in blk:
                        if i == idx:
                            return blk[key]["w"]
                        i += 1
        raise IndexError(idx)

    @torch.no_grad()
    def logits(self, batch: dict, cspec=None) -> torch.Tensor:
        return R.forward(self.cfg, self.params, batch["images"], cspec)

    def log_probs(self, batch: dict, cspec=None) -> torch.Tensor:
        return torch.log_softmax(self.logits(batch, cspec), -1)

    def log_probs_batch(self, batch: dict, stacked_cspec) -> torch.Tensor:
        """[C, B, classes] log-probs of the C policies of a batched cspec,
        from one forward over all of them (the fused sensitivity's probe
        chunk)."""
        return torch.log_softmax(self.logits(batch, stacked_cspec), -1)

    def accuracy(self, batch: dict, cspec=None) -> torch.Tensor:
        """Top-1 accuracy (a 0-d tensor on the device)."""
        lg = self.logits(batch, cspec)
        return torch.mean((torch.argmax(lg, -1) == batch["labels"]).float())

    def accuracy_batch(self, batch: dict, stacked_cspec) -> torch.Tensor:
        """(K,) top-1 accuracies of the K policies of a batched cspec, from
        one forward over all of them (a tensor on the device)."""
        lg = self.logits(batch, stacked_cspec)
        return torch.mean((torch.argmax(lg, -1) == batch["labels"][None])
                          .float(), 1)


# ===========================================================================
# Deployment: materialize truly sliced weights (unrolled LMs)
# ===========================================================================

def _containers(tree):
    """``tree`` with new dicts and lists at every level and the same
    tensors (the JAX package's ``jax.tree.map(lambda x: x, ...)``)."""
    if isinstance(tree, dict):
        return {k: _containers(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_containers(v) for v in tree]
    return tree


def _take(w: torch.Tensor, dim: int, idx: np.ndarray) -> torch.Tensor:
    return torch.index_select(w, dim, torch.as_tensor(idx, device=w.device))


def slice_lm_params(cfg: ArchConfig, params, cspec) -> Any:
    """Slice pruned channels out for deployment (unrolled models only).
    Returns a new params tree with reduced shapes; ``params`` is left as
    it was (new dicts at every level, the kept tensors shared).

    As the JAX package's: an attention layer with a ``head_mask`` keeps
    ``wq``'s columns (and bias) and ``wo``'s rows of its kept heads and
    leaves ``wk`` / ``wv`` whole, so only FF-only pruning gives a model
    that ``models.model.forward`` runs with the same config (ROADMAP.md,
    Queue 3); an ``ff_mask`` slices ``w_up``, ``w_gate`` and
    ``w_down``; MoE, SSD and RG-LRU blocks and an MoE layer's dense
    residual are left as they are. The port's blocks are always a list
    of per-layer dicts; the scanned-config check follows the JAX
    package, whose scanned blocks are one stacked tree."""
    if cfg.scan_layers and cfg.homogeneous:
        raise ValueError("slice requires an unrolled model; set "
                         "scan_layers=False for deployment")
    new = {k: v for k, v in params.items() if k != "blocks"}
    new_blocks = []
    for i, (p_l, cs) in enumerate(zip(params["blocks"], cspec["blocks"])):
        p_l = _containers(p_l)
        kind = cfg.layer_kinds[i]
        if kind == "attn" and cs.get("attn", {}).get("head_mask") is not None:
            idx = pruning.slice_indices(cs["attn"]["head_mask"])
            hd = cfg.head_dim
            cols = np.concatenate([np.arange(h * hd, (h + 1) * hd)
                                   for h in idx])
            a = p_l["attn"]
            a["wq"]["w"] = _take(a["wq"]["w"], 1, cols)
            if "b" in a["wq"]:
                a["wq"]["b"] = _take(a["wq"]["b"], 0, cols)
            a["wo"]["w"] = _take(a["wo"]["w"], 0, cols)
        mlp_cs = cs.get("mlp")
        if mlp_cs is not None and mlp_cs.get("ff_mask") is not None:
            idx = pruning.slice_indices(mlp_cs["ff_mask"])
            m = p_l["mlp"]
            m["w_up"]["w"] = _take(m["w_up"]["w"], 1, idx)
            if "w_gate" in m:
                m["w_gate"]["w"] = _take(m["w_gate"]["w"], 1, idx)
            m["w_down"]["w"] = _take(m["w_down"]["w"], 0, idx)
        new_blocks.append(p_l)
    new["blocks"] = new_blocks
    return new
