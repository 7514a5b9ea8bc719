#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Device: requires CUDA (no CPU fallback); prints the card.
2. Build: compiles the hand-written kernels (K1 fake-quant, K2 fused
   3-layer MLP, K3 Polyak, K4/K5 int8 and packed-int4 quantized matmul,
   K6 flash attention, K7 RG-LRU scan, K8 SSD scan) from
   ``src/repro_torch/kernels/csrc``, one nvcc
   per source, all at once, and prints nvcc's registers / shared memory
   per kernel. ``cuobjdump -sass`` of K6's and K8's libraries must show
   tensor-core products (``HGMMA``) and TMA loads (``UTMALDG``), and of
   K4/K5's library integer ones (``IGMMA``) and TMA loads: their counts
   are printed, and 0 of either fails.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, with its tolerance, and timed with CUDA
   events (kernel, plain version, one library call where one computes
   the same function) beside its bound. K6 has two routes, chosen by
   its wrapper (``kernels.flash_attention.route``): bf16 at head dim 64,
   80, 128 or 256 on the tensor cores (wgmma on TMA-fed tiles, counted in
   ``flash_attention_tc`` as well as ``flash_attention``), f32 at every
   head dim and bf16 at 16 / 32 on the CUDA cores; each K6 line prints its
   route and TFLOP/s, and each call must have counted a launch of its
   route.
   K1 runs f32 and bf16 (and f16 at the testbed's shapes), plain and
   straight-through (against the chain of
   ``core.quantization.fake_quant``), exact, at every shape it meets
   (here and at each serving model's ``k1_calls``); it is timed at
   [3072, 256] (straight-through in the compute dtype, the search's
   call) and, per serving model, at its largest shape and its most
   launched activation. K1 over 8 policy slots (``fake_quant_slots``)
   runs exact at every (shape, bits vector) of the batched validation
   under 8 seeded policies (two of them the reference: slots at 32),
   per-slot activations and weights shared by the slots, f32 and bf16,
   plain and straight-through; timed at [8, 3072, 256] and [8, 3072,
   1024] bf16 straight-through beside 8 launches of the one-tensor
   K1. K2 runs the actor and the critic at B 64 and
   128 (the critic timed at both). K3 updates the 12 leaves of both DDPG
   target networks in one launch, read in place (and leaves that start
   off 16 bytes), exact; its line times the whole update beside ``torch._foreach_lerp`` over the same
   leaves (its library call) and ``torch.lerp`` on one flat buffer of
   the same size. K4/K5 at the calibration's and the testbed's shapes
   and at granite-3-8b's MLP (M 32 and 4,096), each on the tensor-core
   route (``quant_matmul_tc`` counts it; the JAX tests' ragged shapes on
   the CUDA-core route), timed beside the CUDA-core kernel at the same
   shape (through its launch symbol); also the asymmetric
   zero-point case with its SUBTRACT-convention canary, a padded K with
   ``k_true``, and ``torch._int_mm`` on the same codes as a yardstick for
   the int8 product alone. K6 against the dense ``attention_ref`` at the
   JAX tests' shapes (f32, causal / bidirectional / window 96) and bf16
   case, and at qwen2-0.5b's heads at S 4096 (bf16), with
   ``scaled_dot_product_attention`` timed as its yardstick.
4. Main path: the joint ("pq") ``CompressionSearch`` on the full-width LM
   testbed (seeded random weights, bf16 compute, analytic oracle):
   sensitivity analysis, then episodes of rollout, validation, reward and
   DDPG updates. The launch counts are reset just before and read just
   after; K1-K3 must have launched, K3 exactly once per DDPG step. The
   best policy's validation is checked against the plain CPU path on a
   small batch. ``[time]``: an episode's host-clock split and the
   device's busy share.
5. Batched path: the pq ``BatchedCompressionSearch`` on the same model,
   validation batch, seeds and sensitivity table, K 8 episodes per
   batch, 16 episodes (warmup 4, 16 updates per live episode). Launch
   counts are reset just before the episodes and read just after: K1
   over slots exactly once per fake-quant site of each batched
   validation (``k1_calls`` of the batch's batched cspec), the
   one-tensor K1 never, K2 and K3 per DDPG step as in phase 4. Records
   finite, in episode order, on the sigma schedule; K1 over slots exact
   at every (shape, bits vector) the batches gave it; on a small batch
   the last batch's forward through the kernel equals the plain version
   in place (f32), each slot's f32 accuracy is within 3% of its scalar
   engine's and its bf16 argmaxes agree with its scalar forward's on
   >= 97%. Episodes/s beside phase 4's and the same ``[time]`` split.
6. ResNet path: the pq ``CompressionSearch`` (12 episodes, warmup 4, 16
   updates per episode) and ``BatchedCompressionSearch`` (K 8, 16
   episodes, the scalar phase's seeds and sensitivity table) on ResNet18
   at CIFAR-10 widths (``RESNET18_CIFAR``: seeded f32 weights, 256
   seeded blob images, the per-image oracle context ``IMG_CTX``). Launch
   counts reset after the sensitivity analysis and read after the
   episodes: the one-tensor K1 exactly once per fake-quant site of each
   validation (``resnet_k1_calls``), K3 once per DDPG step, K2 launched;
   on the batched engine K1 over slots once per site, the one-tensor K1
   never. K1 exact at every (shape, bits) the episodes gave it (over
   slots in the batched path's layouts); on 8 images the kernel path
   equals the plain path bit for bit (cuDNN deterministic for that
   check), the device's uncompressed forward agrees with the CPU path,
   each batched slot's accuracy is within 3% of its scalar engine's.
   Then ms per validation forward (raw and under a seeded policy, with K1
   launches per forward), a profiled forward's copy kernels (exactly one
   per conv weight turned OIHW plus one per input padded for XLA's
   asymmetric SAME), K1's µs at each site shape beside its bound, and
   the deployed raw forward at batch 1.
7. Fused path: ``FusedCompressionSearch`` on the LM testbed (K 8, the
   batched path's seeds and KL table): per batch 16 episodes (the
   rollout and the update chunk each one CUDA-graph replay, validation
   eager on host bits), then epoch mode (E 2) 32 episodes (E whole
   batches one replay and one readback, validation on device bits:
   K1's device-bits entry); then both on ResNet18 at CIFAR-10 widths
   (256 images, the ResNet path's seeds and KL table). Each run is held
   bit for bit to the same engine with its graphs' functions run
   eagerly on the card (records, agent and ring tensors), and epoch mode
   to the per-batch records on the same draws. K1's device-bits entry
   exact at every (shape, bits vector) of the epoch runs' validations
   (all-32 sites included) and equal to the host-bits form; timed at
   [8, 3072, 256] bf16 beside it. In steady state (every episode live,
   every graph captured) a chunk must capture nothing, replay the
   rollout and the update graph once a batch or the epoch graph once
   with one readback, and launch K2 once per rollout step and 5 times
   per DDPG step, K3 once per DDPG step, and K1 once per validation
   site (over slots on host bits, or its device-bits entry). Episodes/s
   and the ``[time]`` split beside the scalar and batched engines'.
8. Population path: ``PopulationSearch`` on ResNet18 at CIFAR-10 widths
   (the paper's p, q and pq agents as ``BatchedCompressionSearch``
   members, action_dim padded to 3, K 8, 16 episodes, warmup 4, 16
   updates per live episode): the updates shared, one megabatched
   chunk a batch as one graph replay (products over the members by
   bmm, a hand-written backward, the fused Adam + Polyak kernel once a
   network a step); each chunk run again eagerly step by step, the
   replay equal to it, each step within 1e-5 of the per-member steps
   from the same state (the whole chunk's per-member trajectory
   reported). Then on the LM testbed two ``FusedCompressionSearch``
   members in epoch mode (E 2, K 8, 32 episodes), V5E and the JAX
   tests' tpu-v5p, ``fuse_rollouts=True``: each epoch of both members
   one replay and one readback (the rollout's actor one launch of K2's
   member form a step, the P·K policies validated in one forward, K1's
   device-bits entry once a site), held bit for bit to the same
   population with its graphs run eagerly, and each member's records
   compared with it run alone (the first batch's must be equal); K1
   exact at every site of the last shared validation. Steady chunks:
   one update replay a batch (ResNet) or one epoch replay and one
   readback (LM), launches counted exactly (K2's member form, fused
   Adam + Polyak, K1, K2 and K3), member-episodes/s and the device's
   busy share beside the members run alone; the fused sensitivity
   against the per-probe path on both models (seconds, KL differences
   within 1e-6, ResNet activation probes behind a GroupNorm within
   10%). ``[kernels]`` also holds K2's member form bit-equal to its
   one-network launches (P 1 to 3, the DDPG batch and the rollout's
   rows), the fused Adam + Polyak pass exact against its plain version
   (P 1, 3, 8: the paper trunk's leaves) and K1 over 80 slots (two
   launches) exact.
9. Calibration path: ``repro_torch.launch.calibrate.run`` at full width
   (unit, kernel and whole-model deploy-path timings, the fitted table,
   the int8/int4 demo rows), launch counts reset before and read after;
   K4 and K5 must have launched, all on the tensor-core route, and every
   time must be finite.
10. Measured search: a pq ``CompressionSearch`` with
   ``oracle_mode="measured"`` on the fitted table; its top-K rows
   (predicted vs measured ratio) must be finite and its reference
   latency the calibrated oracle's.
11. Training path (``[training path]``, before the serving phases while
   the card's memory is free; the LM testbed's trainer also runs on the
   CPU's plain route in a child process from here until after phase 13,
   where its accuracy is checked):
   a. K1 under autograd (``core.quantization.fake_quant`` on a card
      tensor, as every QAT forward calls it) at the testbed's [3072,
      256] and qwen2's [4096, 896] bf16, 2 / 4 / 8 bits: the forward
      exact against the plain chain, ``x.grad`` equal to the upstream
      gradient bit for bit, one launch per call.
   b. qwen2-0.5b at its SMOKE widths in f32, the same seeded params and
      batch on the card and on the CPU: loss within 1e-5, every gradient
      leaf within 1e-6, one train step's loss and updated leaves within
      1e-5; one QAT step under a seeded pq policy with exactly
      ``k1_calls``' count of K1 launches, its loss within
      ``QAT_LOSS_TOL``.
   c. ``train_testbed_lm(LM_CFG, steps=220, batch=16, seq=48)`` and
      ``train_testbed_resnet(RESNET18_CIFAR, steps=250, batch=64)`` on
      the card from seeded weights: ms per step, the device's busy share
      (a profiled window of the same step), the validation loss before
      and after (it must fall) and the accuracy (gates ``LM_ACC_MIN``,
      ``RESNET_ACC_MIN``); the LM's within ``LM_CPU_MARGIN`` of the same
      trainer on the CPU.
   d. The paper's pipeline on the trained LM: the fused sensitivity, the
      fused engine in epoch mode (K 8, E 2, 32 episodes), then a 60-step
      QAT retrain under the best policy (``benchmarks/
      agent_comparison.py``'s: lr 1e-3, warmup 5, no weight decay, 16 x
      48 bigram batches, seeds 777,000 + s); the accuracy clean and
      under the policy before and after QAT; K1 launched on every QAT
      step, exactly ``k1_calls``' count.
   e. ``make_train_step`` on qwen2-0.5b at full width (seeded weights)
      at B 8 x S 512 (the dense attention block), raw and under a seeded
      pq policy: every gradient leaf finite and not all zero, 2 warm-up
      and 5 timed steps (ms, tokens/s, MFU against 989 TFLOP/s, peak
      memory), K1 launches per QAT step equal to ``k1_calls``' count,
      the loss after the steps below its first value.
12. Trainer path (``[trainer path]``, after phase 11 while the card's
   memory is free):
   a. K6, K7 and K8 under autograd (``kernels/ops.py``: the kernel's
      forward, the backward the plain chain recomputed from the saved
      inputs and differentiated), at the JAX tests' shapes and at one
      full-width layer at training length from the seeded init:
      qwen2-0.5b's q/k/v at 4 x 2048 (bf16), mamba2-780m layer 0's
      (xh_dt, dA, B, C) at 4 x 512 (the tensor-core route),
      recurrentgemma-2b layer 0's (a, b) at 1 x 2048: the forward
      bit-equal to the no-grad launch, one launch and none in the
      backward, every input's gradient against autograd through the
      plain chain on the same tensors (bit-equal, or within
      ``AUTOGRAD_REL_TOL``).
   b. ``launch.train.main`` on qwen2-0.5b at full width, 4 x 2048, 8
      steps over seeded token shards (24 K6 launches a forward): once
      uninterrupted, once with ``--ckpt-every 4`` and one ``StepTimeout``
      injected after step 4, whose retry restores step 4 and reaches the
      uninterrupted run's losses at steps 5-8 within ``RESUME_LOSS_TOL``;
      ms per step, tokens/s, MFU against 989 TFLOP/s, peak memory, and
      seconds and bytes per checkpoint (snapshot, write, restore); then
      one profiled step of the same shape (the device's busy share, the
      device ms under K6's backward, the top kernels). The checkpoint
      directory is removed at the end.
   c. ``Trainer`` on mamba2-780m at full width, 4 x 512, 4 steps (48 K8
      launches a forward, every gradient leaf finite, the loss falling;
      ms per step, peak memory); recurrentgemma-2b at its SMOKE widths in
      f32, 2 x 600 tokens, card against the CPU (loss within 1e-5,
      gradients within ``RG_GRAD_TOL``, K7 2 and K6 1 launches).
   d. ``examples/train_compress_serve_torch.py`` at its default 200
      steps: its four stage lines, the training loss falling, the served
      tokens in the vocabulary.
13. Prefill: ``make_prefill_step`` on qwen2-0.5b at full width (24
   layers, d 896, vocab 151,936; seeded random weights) over 1 x 32,768
   seeded tokens, uncompressed and under a seeded pq policy. First K6 on
   one layer's q/k/v at that shape against the chunked plain branch
   (bf16, atol 0.04), timed beside the plain branch and SDPA; then one
   warm-up forward at 2,048 tokens each and one timed forward each, the
   launch counts reset before and read after each (24 K6 launches per
   forward, all 24 on the tensor-core route). Prints ms, tokens/s, MFU
   against 989 TFLOP/s, K6's share, one profiled raw forward's top
   kernels and the oracle's predicted compressed/reference ratio beside
   the measured one. The whole prefill at the SMOKE widths and 1,100
   tokens (f32) must agree with the plain CPU path.
14. Decode: ``decode_loop`` and ``sustained_throughput`` on the same
   model, batch 8, 32 steps, max_len 256, KV cache 16 and 8 bits, raw
   and under the policy; tok/s per variant, then one profiled 8-step
   decode each (device busy share, kernels per step). At the SMOKE
   widths (f32) the greedy tokens must be the prefill forward's
   argmaxes.
15. Mamba-2 prefill: ``make_prefill_step`` on mamba2-780m at full width
   (48 SSD layers, d 1536, d_inner 3072, 48 heads of 64, state 128,
   vocab 50,280; seeded random weights) over 1 x 32,768 tokens, raw and
   under a seeded pq policy (SSD heads pruned at ``ssm_in``). First K8
   on layer 0's (xh_dt, dA, B, C) at that shape against the chunked
   plain branch (each (token, head) row within ``K8_ROW_TOL``, the final
   state within 2e-4), timed beside it and its bounds (f32 on the CUDA
   cores, split TF32 on the tensor cores), its route and its four
   kernels' times (profiler); then, as in phase 13, a warm-up and one
   timed forward each, with exactly 48 K8 launches, all 48 on the
   tensor-core route, and ``k1_calls``' count of K1 launches per
   forward. At the SMOKE
   widths (f32, 2 x 1,100 tokens, chunk 32: a ragged last chunk) the
   device forward's argmaxes equal the plain CPU path's.
16. Mamba-2 decode: ``decode_loop`` and ``sustained_throughput``, batch 8,
   32 steps, the conv and state cache (no KV cache, so no int8 variant),
   raw and under the policy; one profiled 8-step decode each. At the
   SMOKE widths (f32) the greedy tokens are the prefill's argmaxes.
17. RecurrentGemma prefill: ``make_prefill_step`` on recurrentgemma-2b at
   full width (26 layers in a (rglru, rglru, attn) pattern: 18 RG-LRU
   layers of width 2,560 and 8 local-attention layers, 10 / 1 heads of
   256, window 2,048; d 2,560, GeGLU d_ff 7,680, vocab 256,000; seeded
   random weights) over 1 x 32,768 tokens, raw and under a seeded pq
   policy, after the earlier models are freed. First K1 exact at every
   (shape, bits) of the policy, K7 on layer 0's own (a, b) against the
   sequential plain version (each (token, 256-channel) row within
   ``K7_ROW_TOL``, the worst row's place printed) and bit for bit
   against the former three-launch kernel (``tools/k7_three_pass.cu``)
   at the same chunk, and K6 on layer 2's
   q/k/v (window 2,048) against the chunked plain branch and the dense
   tail rows, each timed beside its bound; then, as in phase 13, a warm-up
   and one timed forward each, with exactly 18 K7, 8 K6 (all 8 on the
   tensor-core route) and ``k1_calls``' count of K1 launches per
   forward; a profiled raw forward, with the device ms of layer 0's
   RG-LRU block split into its gate passes, K7, the GEMMs and the rest;
   the phase's peak device memory; at the SMOKE widths (f32, 2 x 1,100
   tokens) the device forward's argmaxes equal the plain CPU path's.
18. RecurrentGemma decode: ``decode_loop`` and ``sustained_throughput``,
   batch 8, 32 steps, the RG-LRU state and the ring KV cache (16 and 8
   bits), raw and under the policy; one profiled 8-step decode each. At
   the SMOKE widths (f32, window 16) 24 greedy steps (the ring wraps) are
   the prefill's argmaxes.
19. MoE and frontend path (``[moe and frontend path]``, after the earlier
   models are freed): mixtral-8x22b (4 of 56 layers, ``MOE_DEPTH``: 8
   experts top-2, window 4,096, 48 / 8 heads of 128) and arctic-480b (1
   of 35 layers: 128 experts top-2 and a dense residual, 56 / 8 heads)
   at full width, internvl2-2b (24 layers, 16 / 8 heads of 128, vocab
   92,553, the first 256 positions seeded patch embeddings) and
   hubert-xlarge (48 layers, 16 / 16 heads of 80, bidirectional, seeded
   frame embeddings in place of tokens) at full width and depth; seeded
   weights, each raw and under a seeded pq policy. Per model: K1 exact
   at every (shape, bits) of the policy (``k1_calls``: an MoE layer's
   dispatched [E·C, d] and [E·C, ff] buffers, its expert stacks as
   [E·d, ff] / [E·ff, d] views; past ``K1_CHUNKED`` elements against the
   plain version block by block, on layer 0's own stacks: arctic's
   4.46 G-element views), timed at its largest shape and most launched
   activation; K6 on the first attention layer's q/k/v at 1 x 32,768
   against the chunked plain branch and the dense tail rows (D 128, and
   hubert's D 80 bidirectional, on the tensor cores),
   timed beside the plain branch, SDPA and the bound; an MoE layer's
   dropped share of top-k choices at 32K; a warm-up and one timed
   prefill each (ms, tokens/s, MFU), the launches reset before and read
   after: K6 once an attention layer on its route, K1 exactly
   ``k1_calls``' count; a decode at batch 8 for 32 steps each, raw and
   under the policy (not hubert: ``init_cache`` refuses an encoder); the
   peak device memory. Then at the SMOKE widths: the whole prefill (f32,
   2 x 1,100 tokens, frontends' embeddings included) against the CPU,
   decode against prefill, the MoE configs' batched validation (K 8:
   each slot's accuracy equal to its scalar forward's, K1 over slots
   once a site) and one train step of each family, card against CPU.
20. Slice and fleet path (``[slice and fleet path]``, last): granite-3-8b
   at full width (40 layers, d 4,096, 32 / 8 heads of 128, SwiGLU d_ff
   12,800, vocab 49,155, tied; seeded bf16 weights, unrolled) under a
   seeded pruning-only policy (each layer keeps 25-75% of its ff
   channels on the 128-channel grid; heads whole, bits 32): K6 on layer
   0's q/k/v at 1 x 32,768 against the chunked plain branch, then four
   prefills of 1 x 32,768 tokens, each warmed at that shape and timed
   (ms, MFU from the FLOPs of the weights it multiplies, peak memory):
   raw, masked (the full-width model under the cspec), sliced
   (``core.compress.slice_lm_params``, no cspec), and the sliced model
   deployed into int8 and packed-int4 containers; each launches K6 once
   a layer on the tensor-core route and nothing else. Sliced against
   masked: argmax agreement over the 32,768 rows >= ``SLICE_ARGMAX_MIN``
   and the largest logit difference over 256 rows <= ``SLICE_LOGIT_TOL``;
   the oracle's predicted ratio beside the measured one. At the SMOKE
   widths (f32) sliced against masked on the card and against the CPU.
   Then the fleet: ``launch.fleet.main`` at the reference's defaults (P
   4, K 4, E 2, 32 episodes) uninterrupted, stopped after 2 epochs, and
   resumed by a fresh fleet, bit for bit equal (records, agent and ring
   tensors, host mirrors, generators); a P 4 pq ``FleetSearch`` on the
   LM testbed (K 8, E 2, 4 epochs, the first all warmup, 16 updates per
   live episode, checkpointing every epoch), one more
   steady epoch with its launches counted exactly (K1's device-bits
   entry once a validation site, K2's member form once a rollout step,
   K2 and K3 per DDPG step, the fused Adam + Polyak never: epoch mode
   runs each member's updates as solo chunks), K1 exact at the last
   validation's sites, member-episodes/s, the monitor's summary, a
   checkpoint's bytes and snapshot / write / restore seconds (restored
   bit-equal into the fleet's own tensors).
21. Lines before the last: the script's seconds in all (``[done]``), the
   kernels as JSON, then ``nvidia-smi``'s name and power limit. Last
   line: ``{"ok": true, "device": {...}}``.

K8 (SSD scan) joins phase 3: against the sequential ``ssd_scan_ref`` and
the chunked plain version at the JAX tests' shapes (dA in [-0.5, 0]), a
ragged S 1,100 at mamba2's heads and B and C as strided views of one
wider tensor (atol and rtol 2e-4 on y and the final state), and at a
slow decay (dA in [-0.01, 0], mamba2's 48 heads, S 4,096, 16 chunks)
against the chunked one at 2e-4 and the sequential one within
``K8_ROW_TOL`` per row; timed there beside its bound. Its route
(``kernels.ssd_scan.route``: mamba2's head dim 64 and state 128 on the
tensor cores, the JAX tests' small shapes on the CUDA cores) is printed
per case, and each call must have counted a launch of its route. K7 (RG-LRU
scan) too: at the JAX tests' shapes (a in [0.4, 0.99], with and without
h0) at atol 2e-5, at the default chunk and at chunk 16 (the state is
carried between chunks), a ragged S and C, a C off 16 bytes (the scalar
copy), and recurrentgemma-2b's width at S 4,096 with its init's slow
decays, each (token, 256-channel) row within ``K7_ROW_TOL``, and each bit
for bit equal to the former three-launch kernel at the same chunk; timed
at S 4,096 beside its bound. Then a case whose tiles outnumber what the
card holds at once ((1, 65536, 256) at chunk 16: chunks wait on chunks of
earlier waves) and two calls on one stream with no sync between them
(other inputs: the second takes none of the first's state words). And K6
at head dim 256 (MQA, 10 over 1 heads) against the dense plain version:
f32 at atol 2e-5, bf16 at S 128 and 4,096, causal and window 2,048, at
atol 0.04 and ``K6_ROW_TOL``; the S 4,096 window case timed beside SDPA
with the window as a boolean mask.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # f32 outside the tensor cores
TF32_FLOPS = 495e12            # TF32 tensor cores, dense
INT8_OPS = 1979e12             # int8 tensor cores, dense
BF16_FLOPS = 989e12            # bf16 tensor cores, dense

KERNELS = {
    "fake_quant": {"source": "src/repro_torch/kernels/csrc/fake_quant.cu",
                   "replaces": "src/repro/kernels/fake_quant.py:22"},
    "fake_quant_slots": {
        "source": "src/repro_torch/kernels/csrc/fake_quant.cu",
        "replaces": "src/repro/kernels/fake_quant.py:22"},
    "fake_quant_slots_dev": {
        "source": "src/repro_torch/kernels/csrc/fake_quant.cu",
        "replaces": "src/repro/kernels/fake_quant.py:22"},
    "mlp3": {"source": "src/repro_torch/kernels/csrc/mlp3.cu",
             "replaces": "src/repro/kernels/mlp_fused.py:32"},
    "polyak": {"source": "src/repro_torch/kernels/csrc/polyak.cu",
               "replaces": "src/repro/kernels/mlp_fused.py:85"},
    "quant_matmul_int8": {
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:53"},
    "quant_matmul_int4": {
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:90"},
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29"},
    "ssd_scan": {"source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "replaces": "src/repro/kernels/ssd_scan.py:28"},
    "flash_attention_d256": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29"},
    "flash_attention_d80": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29"},
    "flash_attention_d128": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29"},
    "rglru_scan": {"source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "replaces": "src/repro/kernels/rglru_scan.py:25"},
    "mlp3_members": {"source": "src/repro_torch/kernels/csrc/mlp3.cu",
                     "replaces": "src/repro/kernels/mlp_fused.py:32"},
    "adam_polyak": {"source": "src/repro_torch/kernels/csrc/adam_polyak.cu",
                    "replaces": "no Pallas counterpart (the JAX package's "
                                "jnp pass src/repro/core/ddpg.py:435)"},
}
MAIN_PATH_KERNELS = ("fake_quant", "mlp3", "polyak")
CALIBRATION_KERNELS = ("quant_matmul_int8", "quant_matmul_int4")
PREFILL_SEQ, PREFILL_WARM_SEQ = 32_768, 2048
# K6's bf16 checks also bound each output row: ||kernel - plain|| /
# ||plain|| over the row's D values. Against the dense f32 plain version
# only two roundings of the output to bf16 (2^-9 each) and the kernel's
# rounding of p to bf16 lie between them, so 2^-6 leaves 4x headroom over
# 2^-8. The chunked plain branch also rounds its scores to bf16 (as the
# JAX package's jnp path does), hence 2^-5 against it. A fault that drops
# one 64-key tile of a row moves that row by far more (PERF.md).
K6_ROW_TOL = 2.0 ** -6
K6_CHUNKED_ROW_TOL = 2.0 ** -5
K6_TAIL_ROWS = 1024
# K8 also bounds each (token, head) row of y over its P values (and each
# (head, p) row of the final state over N): ||kernel - plain|| /
# max(||plain||, K8_ROW_EPS). Against the chunked plain version the
# kernel does the same arithmetic (cumsum, differences of cumulative
# decays, exp) in other orders. At mamba2's init the decays reach -61
# per step, so a steep head's cumulative sum runs to -10^3 and beyond
# within a chunk, where one f32 ulp is 6e-5 or more, and the difference
# of two such sums cancels: a row moves by ~1e-4 to ~5e-4 (the largest
# at a chunk's last rows; PERF.md has the card's reading). 2^-10
# (9.8e-4) leaves room for that; a kernel that drops one chunk's carried
# state moves the first rows of that chunk by ~1. K8_ROW_EPS is far
# below the row norms of these inputs (the smallest is printed).
K8_ROW_TOL = 2.0 ** -10
K8_ROW_EPS = 1e-6
K8_TOL = 2e-4           # rtol and atol, as the JAX tests hold K8
# K7 also bounds each (token, 256-channel block) row of h: ||kernel -
# plain|| / max(||plain||, K8_ROW_EPS). The chunked kernel rounds the
# state carried into each chunk in another order than the sequential
# plain version. At recurrentgemma-2b's init the decays are slow (a in
# [0.9487, 0.9995]: the state carries over ~2,000 steps), and a CPU
# emulation of the two orders in f32 at S 32,768 put the rows within
# 4.8e-7; 2^-12 (2.4e-4) leaves ~500x room, and dropping the carry into
# one chunk moves its rows by ~1 (PERF.md).
K7_ROW_TOL = 2.0 ** -12
K7_BLOCK = 256
K7_TOL = 2e-5           # atol, as the JAX tests hold K7
# 32 steps: the decode phases are host-bound (up to ~0.1 s a step on a
# loaded host), and the script's time limit has to hold every phase
DECODE = dict(batch=8, steps=32, max_len=256)
CARD = "no card"                # nvidia-smi's name and power limit


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> tuple:
    """(device ms, paced ms) per call of ``fn``, both from CUDA events
    around ``iters`` back-to-back calls after a warm-up. For the device
    time a sleep kernel first holds the stream while the host queues all
    the calls, so the events bracket the calls' device work alone; the
    paced time lets the host issue them as it goes, so it also counts
    launch gaps (what a host-driven loop such as the search sees)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for ahead in (True, False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(50_000_000)     # tens of ms at H100 clocks
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return tuple(out)


def bound_ms(n_bytes: float, n_ops: float, peak: float = F32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_counts(name: str, ops=("HGMMA", "UTMALDG")) -> dict:
    """How many of each SASS instruction ``cuobjdump -sass`` finds in the
    built library of ``csrc/<name>.cu``."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run(
        [tool if os.path.exists(tool) else "cuobjdump", "-sass",
         str(build._lib_path(name))], capture_output=True, text=True,
        timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def fake_quant_errors(x, bits) -> float:
    """Largest |kernel - plain| of K1 on x (f32, bf16 or f16) in both modes:
    plain against ``fake_quant_ref`` and straight-through against the
    chain of ``core.quantization.fake_quant``, ``(xf + (xq - xf))`` in
    x's dtype."""
    from repro_torch.kernels.fake_quant import fake_quant_2d
    from repro_torch.kernels.ref import fake_quant_ref
    xf = x.float()
    chain = x.clone() if bits >= 32 else \
        (xf + (fake_quant_ref(xf, bits) - xf)).to(x.dtype)
    err = 0.0
    for got, want in ((fake_quant_2d(x, bits), fake_quant_ref(x, bits)),
                      (fake_quant_2d(x, bits, ste=True), chain)):
        if got.dtype != x.dtype:
            raise AssertionError(f"fake_quant returned {got.dtype} for "
                                 f"{x.dtype}")
        err = max(err, float((got.float() - want.float()).abs().max()))
    return err


def time_fake_quant(x, bits, ste: bool, iters: int = 20,
                    plain: bool = True) -> dict:
    """K1 on x (device and host-paced ms) beside its plain version (with
    ``plain``: its f32 temporaries must fit) and its bound: each element
    read once and written once in x's dtype, against 10 f32 operations
    an element (min, max, scale, subtract, floor, clip twice, two adds,
    divide) and 2 more straight-through."""
    from repro_torch.kernels.fake_quant import fake_quant_2d
    from repro_torch.kernels.ref import fake_quant_ref, fake_quant_ste_ref
    plain_fn = fake_quant_ste_ref if ste else fake_quant_ref
    ms, paced = cuda_ms(lambda: fake_quant_2d(x, bits, ste=ste), iters, 3)
    if plain:
        plain, _ = cuda_ms(lambda: plain_fn(x, bits), max(2, iters // 4), 1)
    n = x.numel()
    bound, by = bound_ms(2.0 * x.element_size() * n,
                         (12.0 if ste else 10.0) * n)
    mode = "straight-through" if ste else "plain"
    log(f"    {list(x.shape)} {str(x.dtype)[6:]} {bits} bits {mode}: "
        f"{ms * 1e3:.2f} us kernel ({paced * 1e3:.2f} paced), "
        f"{'not timed' if plain is False else f'{plain * 1e3:.2f} us'} "
        f"plain, bound {bound * 1e3:.3f} us ({by}); {CARD}")
    plain = None if plain is False else plain
    return dict(shape=list(x.shape), dtype=str(x.dtype)[6:], bits=bits,
                ste=ste, ms=ms, paced_ms=paced, plain_ms=plain,
                bound_ms=bound, bound_by=by)


def check_fake_quant(cfg, device) -> dict:
    """K1 at the activation shapes ([64*48, 256] and [64*48, 1024]) and
    every weight shape of the testbed, f32, bf16 and f16, plain and
    straight-through; tolerance: exact (the plain versions on the card
    run the same correctly rounded f32 ops). Times [3072, 256] at 4 bits
    in the compute dtype, straight-through: the call the search's
    quantized linears make, which the kernels line's row times; and f32
    plain beside it (``f32_plain``, the mode earlier rows timed)."""
    import torch
    from repro_torch.configs.testbed import VAL_BATCH, VAL_SEQ
    rows = VAL_BATCH * VAL_SEQ
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    shapes = [(rows, d), (rows, ff), (cfg.vocab_size, d),
              (d, cfg.num_heads * hd), (d, cfg.num_kv_heads * hd),
              (d, ff), (ff, d)]
    gen = torch.Generator(device=device).manual_seed(1)
    err, out = 0.0, {}
    for shape in dict.fromkeys(shapes):
        x = torch.randn(shape, generator=gen, device=device)
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for bits in (2, 4, 6, 8, 32):
                err = max(err, fake_quant_errors(x.to(dtype), bits))
        log(f"  fake_quant {shape}: max |kernel - plain| so far {err:.3g}")
        if shape == (rows, d):
            out.update(time_fake_quant(
                x.to(getattr(torch, cfg.compute_dtype)), 4, True, 50))
            out["f32_plain"] = time_fake_quant(x, 4, False, 50)
    out.update(max_abs_err=err, tolerance=0.0, library_ms=None)
    if err > 0.0:
        raise AssertionError(f"fake_quant disagrees with its plain version: "
                             f"max abs err {err}")
    return out


def k1_calls(cfg, cspec, rows: int) -> list:
    """(shape, bits) of each K1 launch that one forward over ``rows``
    tokens makes under ``cspec``, in launch order: the embedding table,
    then per layer each quantized linear's input [rows, d_in] and weight
    [d_in, d_out] (q, k and v each quantize their input; a gated MLP's up
    and gate too; an SSM layer's ``in_proj`` and ``out_proj`` once each;
    an RG-LRU layer's input once for ``w_x`` and ``w_y``, then its
    output projection; an MoE layer's dispatched tokens [E·C, d] once
    for ``w_up`` and ``w_gate``, its expert stacks as their [E·d, ff]
    and [E·ff, d] views, its hidden [E·C, ff], then a dense residual as
    an MLP), then the head weight (the tied embedding's transpose; none
    for an audio encoder, which has no embedding either). ``bits >= 32``
    launches nothing. For a batched cspec of
    K policies (``rows`` per policy) each entry's bits are the site's
    K-tuple and the entries are K1's launches over the K slots: a site
    launches once if any slot quantizes there. A device cspec's bits
    ([K] int32 tensors, ``cspec_builder`` on device tensors) launch K1's
    device-bits entry at every such site, whatever the bits: their
    entries carry the bits as a tuple."""
    from repro_torch.models.blocks import ssm_dims
    if cspec is None:
        return []
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    ups = (ff, ff) if cfg.mlp in ("swiglu", "geglu") else (ff,)
    calls = []

    def add(shape, bits):
        if hasattr(bits, "tolist"):
            calls.append((shape, tuple(int(b) for b in bits.tolist())))
        elif bits is not None and min(
                bits if isinstance(bits, tuple) else (bits,)) < 32:
            calls.append((shape, bits))

    def linear(qs, d_in, d_outs):
        for d_out in d_outs if qs is not None else ():
            add((rows, d_in), qs["a_bits"])
            add((d_in, d_out), qs["w_bits"])

    add((V, d), cspec.get("embed_bits"))
    for kind, b in zip(cfg.layer_kinds, cspec["blocks"]):
        if kind == "ssm":
            d_inner, nheads, _ = ssm_dims(cfg)
            linear(b["ssm"]["in"], d,
                   (2 * d_inner + 2 * cfg.ssm.d_state + nheads,))
            linear(b["ssm"]["out"], d_inner, (d,))
            continue
        if kind == "rglru":
            w, qs = cfg.lru_width, b["rglru"]["in"]
            add((rows, d), qs["a_bits"])         # the input, once
            add((d, w), qs["w_bits"])            # w_x
            add((d, w), qs["w_bits"])            # w_y
            linear(b["rglru"]["out"], w, (d,))
        else:
            linear(b["attn"]["qkv"], d, (H * D, KV * D, KV * D))
            linear(b["attn"]["o"], H * D, (d,))
        if "moe" in b:
            mo, E = b["moe"], cfg.moe.num_experts
            slots = moe_rows(cfg, rows)
            add((slots, d), mo["up"]["a_bits"])     # once for up and gate
            add((E * d, ff), mo["up"]["w_bits"])    # w_up
            add((E * d, ff), mo["up"]["w_bits"])    # w_gate
            add((slots, ff), mo["down"]["a_bits"])
            add((E * ff, d), mo["down"]["w_bits"])
            if mo["dense_up"] is not None:
                linear(mo["dense_up"], d, ups)
                linear(mo["dense_down"], ff, (d,))
            continue
        linear(b["mlp"]["up"], d, ups)
        linear(b["mlp"]["down"], ff, (d,))
    add((d, V), cspec.get("head_bits"))
    return calls


def moe_rows(cfg, rows: int) -> int:
    """The rows E·C of an MoE layer's dispatched buffer for a forward over
    ``rows`` tokens (one dispatch group): every expert's capacity."""
    from repro_torch.models.blocks import moe_capacity
    m = cfg.moe
    return m.num_experts * moe_capacity(rows, m.num_experts, m.top_k,
                                        m.capacity_factor)


def k1_is_activation(cfg, shape, rows: int) -> bool:
    """Whether the K1 call at ``shape`` in a forward over ``rows`` tokens
    quantizes an activation (the tokens, or an MoE layer's dispatched
    buffer) rather than a weight."""
    return shape[0] == rows or (cfg.moe is not None
                                and shape[0] == moe_rows(cfg, rows))


def k1_call_dtype(cfg, shape, rows: int):
    """The dtype K1 receives at ``shape`` in a forward over ``rows``
    tokens: an activation [rows, d_in] comes in the compute dtype, a
    weight in the parameter dtype."""
    import torch
    return getattr(torch, cfg.compute_dtype if k1_is_activation(
        cfg, shape, rows) else cfg.param_dtype)


def fake_quant_errors_chunked(x, bits, rows: int = 1 << 15) -> float:
    """``fake_quant_errors`` for an x whose plain version's f32
    temporaries would not fit beside the model (an expert stack's view,
    4.46 G elements at arctic-480b's width): K1's output in each mode
    against the arithmetic of ``core.quantization.quantize`` /
    ``dequantize`` applied to blocks of ``rows`` rows, with each
    channel's range taken over all rows first (min and max are exact in
    any order, so every block sees the whole tensor's range)."""
    import torch
    from repro_torch.core.quantization import dequantize
    from repro_torch.kernels.fake_quant import fake_quant_2d
    if bits >= 32:
        return fake_quant_errors(x[:rows], bits)
    b = min(max(int(bits), 1), 31)
    n = 2.0 ** b - 1.0
    blocks = x.split(rows)
    x_min = torch.stack([t.amin(0) for t in blocks]).amin(0).float()
    x_max = torch.stack([t.amax(0) for t in blocks]).amax(0).float()
    x_max = x_min + torch.clamp_min(x_max - x_min, 1e-8)
    s = torch.full_like(x_min, n) / (x_max - x_min)
    z = torch.floor(s * x_min) + 2.0 ** (b - 1.0)
    err = 0.0
    for ste in (False, True):
        got = fake_quant_2d(x, bits, ste=ste)
        if got.dtype != x.dtype or got.shape != x.shape:
            raise AssertionError(f"fake_quant returned {got.dtype} "
                                 f"{tuple(got.shape)} for {x.dtype}")
        for g, t in zip(got.split(rows), blocks):
            xf = t.float()
            xq = dequantize(torch.clamp(torch.floor(s * xf - z), -n, n),
                            s, z)
            want = (xf + (xq - xf)) if ste else xq
            err = max(err, float((g.float() - want.to(x.dtype).float())
                                 .abs().max()))
        del got
    return err


K1_CHUNKED = 1 << 28    # elements past which K1 is held block by block


def check_fake_quant_path(cfg, cspec, rows: tuple, device,
                          views=None) -> dict:
    """K1 at every (shape, bits) that a forward over each count of
    ``rows`` tokens gives it under ``cspec`` (``k1_calls``: the prefill's
    [32768, 896] and [32768, 4864] activations, the layer weights, the
    head weight [896, 151936], decode's [8, 896] activations), f32 and
    bf16, plain and straight-through; tolerance: exact, as
    ``check_fake_quant``. A shape past ``K1_CHUNKED`` elements (an MoE
    layer's expert stacks and dispatched buffers) runs in the dtype the
    path gives it, against the plain version block by block
    (``fake_quant_errors_chunked``), on the model's own tensor where
    ``views`` maps the shape to one (layer 0's expert stacks as K1 reads
    them). On the card the largest shape is timed in f32 (the widest
    call; in its path dtype, kernel alone, past ``K1_CHUNKED``) and the
    activation launched most often in the path's dtype, straight-through
    (the layers' call), each beside its bound."""
    import torch
    gen = torch.Generator(device=device).manual_seed(2)
    views = views or {}
    calls = {r: k1_calls(cfg, cspec, r) for r in rows}
    pairs = sorted({c for cs in calls.values() for c in cs})
    if not pairs:
        raise AssertionError("the policy quantizes nothing: K1 never runs")

    def path_input(shape):
        if shape in views:
            return views[shape]
        act = any(k1_is_activation(cfg, shape, r) for r in rows)
        return torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, cfg.compute_dtype if act else cfg.param_dtype))

    err, out = 0.0, {}
    for shape, bits in pairs:
        if shape[0] * shape[1] > K1_CHUNKED:
            x = path_input(shape)
            e = fake_quant_errors_chunked(x, bits)
            what = "the layer's own tensor" if shape in views else "seeded"
            log(f"  fake_quant {list(shape)} {bits} bits, "
                f"{str(x.dtype)[6:]} ({what}), plain and straight-through, "
                f"against the plain version block by block: max |kernel - "
                f"plain| {e:.3g}")
            del x
        else:
            x = torch.randn(shape, generator=gen, device=device)
            e = max(fake_quant_errors(x.to(dtype), bits)
                    for dtype in (torch.float32, torch.bfloat16))
            log(f"  fake_quant {list(shape)} {bits} bits, f32 and bf16, "
                f"plain and straight-through: max |kernel - plain| {e:.3g}")
        err = max(err, e)
    if torch.device(device).type == "cuda":
        big, bits = max(pairs, key=lambda c: c[0][0] * c[0][1])
        if big[0] * big[1] > K1_CHUNKED:
            out["largest"] = time_fake_quant(path_input(big), bits, False,
                                             10, plain=False)
        else:
            x = torch.randn(big, generator=gen, device=device)
            out["largest"] = time_fake_quant(x, bits, False, 10)
        acts = [c for c in calls[rows[0]]
                if k1_is_activation(cfg, c[0], rows[0])]
        shape, bits = max(set(acts), key=acts.count)
        x = torch.randn(shape, generator=gen, device=device).to(
            k1_call_dtype(cfg, shape, rows[0]))
        out["activation"] = time_fake_quant(
            x, bits, True, 10, plain=x.numel() <= K1_CHUNKED)
        out["activation"]["launches"] = acts.count((shape, bits))
    out.update(pairs=len(pairs), max_abs_err=err)
    if err > 0.0:
        raise AssertionError(f"fake_quant disagrees with its plain version "
                             f"at the path's shapes: max abs err {err}")
    return out


def check_fake_quant_slot_calls(cfg, cspec, rows: int, device) -> dict:
    """K1 over the K policy slots of a batched ``cspec`` at every (shape,
    bits vector) of ``k1_calls(cfg, cspec, rows)``: activations [K, rows,
    d_in] (each slot its own values), weights [d_in, d_out] shared by
    every slot (slot stride 0); in f32 and the path's dtype, plain and
    straight-through; tolerance exact, against ``fake_quant_slots_ref``
    (the plain version slot by slot)."""
    import torch
    from repro_torch.kernels.fake_quant import fake_quant_slots
    from repro_torch.kernels.ref import fake_quant_slots_ref
    K = cspec["slots"]
    gen = torch.Generator(device=device).manual_seed(3)
    pairs = sorted(set(k1_calls(cfg, cspec, rows)))
    err = 0.0
    for shape, bits in pairs:
        act = k1_is_activation(cfg, shape, rows)
        base = torch.randn((K,) + shape if act else shape, generator=gen,
                           device=device)
        for dtype in {torch.float32, k1_call_dtype(cfg, shape, rows)}:
            x = base.to(dtype) if act else base.to(dtype).expand(K, *shape)
            for ste in (False, True):
                got = fake_quant_slots(x, bits, ste=ste)
                want = fake_quant_slots_ref(x, bits, ste)
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"fake_quant_slots returned "
                                         f"{got.dtype} {tuple(got.shape)}")
                err = max(err, float((got.float() - want.float())
                                     .abs().max()))
    if err > 0.0:
        raise AssertionError(f"K1 over policy slots disagrees with its "
                             f"plain version: max abs err {err}")
    return {"pairs": len(pairs), "max_abs_err": err}


def time_fake_quant_slots(x, bits, iters: int = 20) -> dict:
    """K1 over K policy slots, straight-through, on x [K, R, C] (device and
    host-paced ms), beside K launches of the one-tensor K1 on the same
    slots (what the batched path would launch without the slot axis), the
    plain version and the bound: each element read once and written once,
    against 12 f32 operations an element."""
    from repro_torch.kernels.fake_quant import fake_quant_2d, fake_quant_slots
    from repro_torch.kernels.ref import fake_quant_slots_ref
    ms, paced = cuda_ms(lambda: fake_quant_slots(x, bits, ste=True),
                        iters, 3)
    looped, looped_paced = cuda_ms(lambda: [
        fake_quant_2d(x[k], b, ste=True) for k, b in enumerate(bits)],
        iters, 3)
    plain, _ = cuda_ms(lambda: fake_quant_slots_ref(x, bits, True),
                       max(2, iters // 4), 1)
    n = x.numel()
    bound, by = bound_ms(2.0 * x.element_size() * n, 12.0 * n)
    log(f"    {list(x.shape)} {str(x.dtype)[6:]} bits {list(bits)} "
        f"straight-through: {ms * 1e3:.2f} us kernel ({paced * 1e3:.2f} "
        f"paced), {len(bits)} one-tensor K1 launches {looped * 1e3:.2f} us "
        f"({looped_paced * 1e3:.2f} paced), {plain * 1e3:.2f} us plain, "
        f"bound {bound * 1e3:.3f} us ({by}); {CARD}")
    return dict(shape=list(x.shape), ms=ms, paced_ms=paced, plain_ms=plain,
                bound_ms=bound, bound_by=by)


SLOTS = 8                   # policies per batch on the batched path


def seeded_slot_cspec(cm, slots: int = SLOTS):
    """The batched cspec of ``slots`` seeded pq policies (seeds 0..K-1)
    with slots 2 and 5 the reference policy, so every site has slots at
    32 beside quantized ones."""
    from repro_torch.core.policy import Policy, stack_policies
    pols = [Policy.reference(cm.specs) if k in (2, 5)
            else seeded_policy(cm, k) for k in range(slots)]
    pb = stack_policies(cm.specs, pols)
    return cm.cspec_builder()(pb.keep, pb.w_bits, pb.a_bits)


def check_fake_quant_slots(cfg, device) -> dict:
    """K1 over 8 policy slots at every (shape, bits vector) of the
    batched validation under 8 seeded testbed policies (two of them the
    reference: slots at 32 at every site), f32 and bf16, plain and
    straight-through, shared weights and per-slot activations; exact.
    Timed at [8, 3072, 256] and [8, 3072, 1024] bf16 straight-through
    (the batched path's activations; the row times the first, the one it
    launches most), each beside 8 launches of the one-tensor K1."""
    import torch
    from repro_torch.configs.testbed import VAL_BATCH, VAL_SEQ
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.models import model as M
    rows = VAL_BATCH * VAL_SEQ
    cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=device))
    out = check_fake_quant_slot_calls(cfg, seeded_slot_cspec(cm), rows,
                                      device)
    log(f"  fake_quant_slots: {out['pairs']} (shape, bits vector) sites of "
        f"8 seeded policies, f32 and bf16, plain and straight-through: max "
        f"|kernel - plain| {out['max_abs_err']:.3g} (tol 0)")
    gen = torch.Generator(device=device).manual_seed(4)
    bits = (2, 3, 4, 5, 6, 8, 4, 6)
    dtype = getattr(torch, cfg.compute_dtype)
    time_fake_quant_slots(torch.randn(
        (SLOTS, rows, cfg.d_ff), generator=gen, device=device).to(dtype),
        bits)
    out.update(time_fake_quant_slots(torch.randn(
        (SLOTS, rows, cfg.d_model), generator=gen, device=device).to(dtype),
        bits, 50))
    out.update(tolerance=0.0, library_ms=None)
    return out


def check_mlp3(state_dim, action_dim, hidden, batches, device) -> dict:
    """K2 forward (y, h1, h2) and autograd backward for the actor and the
    critic at each DDPG batch in ``batches``; tolerance 1e-5 (f32,
    summation order). The critic is timed at each batch; the row keeps
    the first."""
    import torch
    from repro_torch.core.ddpg import _mlp_init
    from repro_torch.kernels import ops
    from repro_torch.kernels.mlp_fused import mlp3
    from repro_torch.kernels.ref import mlp3_ref
    gen = torch.Generator(device=device).manual_seed(2)
    err, out = 0.0, {}
    for batch in batches:
        for name, d0, d3, final in (
                ("actor", state_dim, action_dim, "sigmoid"),
                ("critic", state_dim + action_dim, 1, "linear")):
            params = _mlp_init(gen, (d0,) + tuple(hidden) + (d3,), device)
            x = torch.randn((batch, d0), generator=gen, device=device)
            flat = [l[k] for l in params for k in ("w", "b")]
            sig = final == "sigmoid"
            got = mlp3(x, *flat, sigmoid=sig)
            want = mlp3_ref(x, *flat, sig)
            for g, w in zip(got, want):
                err = max(err, float((g - w).abs().max()))
            leaves_k = [t.clone().requires_grad_(True) for t in [x] + flat]
            leaves_r = [t.clone().requires_grad_(True) for t in [x] + flat]
            pk = [{"w": leaves_k[1 + 2 * i], "b": leaves_k[2 + 2 * i]}
                  for i in range(3)]
            yk = ops.fused_mlp3(pk, leaves_k[0], final=final)
            yr = mlp3_ref(leaves_r[0], *leaves_r[1:], sig)[0]
            gk = torch.autograd.grad((yk ** 2).sum(), leaves_k)
            gr = torch.autograd.grad((yr ** 2).sum(), leaves_r)
            for a, b in zip(gk, gr):
                err = max(err, float((a - b).abs().max()))
            log(f"  mlp3 {name} [{batch},{d0}]->{hidden}->{d3}: max |kernel"
                f" - plain| so far {err:.3g}")
            if name != "critic":
                continue
            ms, paced = cuda_ms(lambda: mlp3(x, *flat, sigmoid=sig))
            plain, _ = cuda_ms(lambda: mlp3_ref(x, *flat, sig))
            d1, d2 = hidden
            w_elems = sum(t.numel() for t in flat)
            n_bytes = 4.0 * (x.numel() + w_elems + batch * (d1 + d2 + d3))
            n_ops = 2.0 * batch * (d0 * d1 + d1 * d2 + d2 * d3)
            bound, by = bound_ms(n_bytes, n_ops)
            log(f"    critic at B {batch}: {ms * 1e3:.2f} us kernel "
                f"({paced * 1e3:.2f} paced), {plain * 1e3:.2f} us plain, "
                f"bound {bound * 1e3:.3f} us ({by}); {CARD}")
            row = dict(ms=ms, paced_ms=paced, plain_ms=plain,
                       bound_ms=bound, bound_by=by,
                       shape=[batch, d0, d1, d2, d3])
            if not out:
                out.update(row)
            out[f"critic_b{batch}"] = row
    out.update(max_abs_err=err, tolerance=1e-5, library_ms=None)
    if err > 1e-5:
        raise AssertionError(f"mlp3 disagrees with its plain version: "
                             f"max abs err {err}")
    return out


def ddpg_leaf_shapes(state_dim, action_dim, hidden) -> list:
    """The leaves of the DDPG target networks as ``ddpg_step`` hands them
    to K3 (actor, then critic; per layer "b" then "w")."""
    out = []
    for d0, d3 in ((state_dim, action_dim), (state_dim + action_dim, 1)):
        dims = (d0,) + tuple(hidden) + (d3,)
        for a, b in zip(dims[:-1], dims[1:]):
            out += [(b,), (a, b)]
    return out


def check_polyak(shapes, tau, device) -> dict:
    """K3 over the leaves of both target networks (``shapes``) in one
    launch, and over leaves that start off 16 bytes with sizes that are
    not multiples of 4 (views into one buffer); tolerance: exact (the
    same two products and sum, each correctly rounded). Times the whole
    update beside its plain version (per leaf), ``torch._foreach_lerp``
    over the same leaves (one PyTorch call computing the same update:
    the library time) and ``torch.lerp`` on one flat buffer of the same
    total size."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.mlp_fused import polyak_leaves
    from repro_torch.kernels.ref import polyak_ref
    gen = torch.Generator(device=device).manual_seed(3)
    t = [torch.randn(sh, generator=gen, device=device) for sh in shapes]
    p = [torch.randn(sh, generator=gen, device=device) for sh in shapes]
    before = build.LAUNCHES["polyak"]
    got = polyak_leaves(t, p, tau)
    if build.LAUNCHES["polyak"] != before + 1:
        raise AssertionError("K3 took more than one launch for the update")
    err = max(float((g - polyak_ref(a, b, tau)).abs().max())
              for g, a, b in zip(got, t, p))
    wide_t = torch.randn(70_010, generator=gen, device=device)
    wide_p = torch.randn(70_010, generator=gen, device=device)
    spans = ((1, 4_099), (4_101, 7), (9_003, 30_001), (40_000, 30_000))
    tm = [wide_t[a:a + n] for a, n in spans]
    pm = [wide_p[a + 2:a + 2 + n] for a, n in spans]
    err = max([err] + [float((g - polyak_ref(a, b, tau)).abs().max())
                       for g, a, b in zip(polyak_leaves(tm, pm, tau), tm,
                                          pm)])
    n = sum(x.numel() for x in t)
    off16 = sum(x.data_ptr() % 16 != 0 for x in tm + pm)
    log(f"  polyak, both networks in one call: {len(shapes)} leaves, {n} "
        f"elements, 1 launch, no torch.cat; {len(spans)} leaves off 16 "
        f"bytes ({off16} pointers); max |kernel - plain| {err:.3g}")
    flat_t, flat_p = torch.cat([x.reshape(-1) for x in t]), \
        torch.cat([x.reshape(-1) for x in p])
    out = {"leaves": len(shapes), "shape": [n]}
    out["ms"], out["paced_ms"] = cuda_ms(lambda: polyak_leaves(t, p, tau))
    out["plain_ms"], _ = cuda_ms(
        lambda: [polyak_ref(a, b, tau) for a, b in zip(t, p)])
    out["library_ms"], _ = cuda_ms(lambda: torch._foreach_lerp(t, p, tau))
    out["lerp_ms"], _ = cuda_ms(lambda: torch.lerp(flat_t, flat_p, tau))
    out["bound_ms"], out["bound_by"] = bound_ms(12.0 * n, 3.0 * n)
    out.update(max_abs_err=err, tolerance=0.0)
    log(f"    whole update, {CARD}: {out['ms'] * 1e3:.2f} us kernel (1 "
        f"launch), {out['plain_ms'] * 1e3:.2f} us plain (per leaf), "
        f"{out['library_ms'] * 1e3:.2f} us torch._foreach_lerp, "
        f"{out['lerp_ms'] * 1e3:.2f} us torch.lerp on one flat buffer, "
        f"bound {out['bound_ms'] * 1e3:.3f} us ({out['bound_by']})")
    if err > 0.0:
        raise AssertionError(f"polyak disagrees with its plain version: "
                             f"max abs err {err}")
    return out


def check_mlp3_members(state_dim, action_dim, hidden, rollout_rows,
                       members, timed, device) -> dict:
    """K2's member form (``mlp3_members``) for the actor and the critic
    at [P, 64, ·] (the DDPG batch) and the actor at the shared rollout's
    [P, K, S] for each P of ``members``: (y, h1, h2) bit-equal to P
    launches of the one-network K2 on each member's slices (the same
    arithmetic per member), and within 1e-5 of its plain version (f32,
    summation order). Timed at the rollout's [P, K, S] for P = ``timed``
    (the population path's) beside P one-network launches, the plain
    version and the bound."""
    import torch
    from repro_torch.core.ddpg import _mlp_init
    from repro_torch.kernels import build
    from repro_torch.kernels.mlp_fused import mlp3, mlp3_members
    from repro_torch.kernels.ref import mlp3_members_ref
    gen = torch.Generator(device=device).manual_seed(12)
    err, out, cases = 0.0, {}, 0
    for P in members:
        for name, d0, d3, sig, rows in (
                ("actor", state_dim, action_dim, True, 64),
                ("critic", state_dim + action_dim, 1, False, 64),
                ("actor", state_dim, action_dim, True, rollout_rows)):
            dims = (d0,) + tuple(hidden) + (d3,)
            nets = [_mlp_init(gen, dims, device) for _ in range(P)]
            flat = [torch.stack([net[i // 2]["wb"[i % 2]] for net in nets])
                    for i in range(6)]
            x = torch.randn((P, rows, d0), generator=gen, device=device)
            before = build.LAUNCHES["mlp3_members"]
            got = mlp3_members(x, *flat, sigmoid=sig)
            if build.LAUNCHES["mlp3_members"] != before + 1:
                raise AssertionError("mlp3_members took more than one "
                                     "launch")
            for p in range(P):
                solo = mlp3(x[p], *(t[p] for t in flat), sigmoid=sig)
                for g, s in zip(got, solo):
                    if not torch.equal(g[p], s):
                        raise AssertionError(
                            f"mlp3_members member {p} of {P} differs from "
                            f"its one-network launch ({name}, {rows} rows)")
            for g, w in zip(got, mlp3_members_ref(x, *flat, sig)):
                err = max(err, float((g - w).abs().max()))
            cases += 1
            if name == "actor" and rows == rollout_rows and P == timed:
                ms, paced = cuda_ms(lambda: mlp3_members(x, *flat,
                                                         sigmoid=sig))
                solo_ms, _ = cuda_ms(lambda: [mlp3(
                    x[p], *(t[p] for t in flat), sigmoid=sig)
                    for p in range(P)])
                plain, _ = cuda_ms(lambda: mlp3_members_ref(x, *flat, sig))
                d1, d2 = hidden
                n_bytes = 4.0 * (x.numel() + sum(t.numel() for t in flat)
                                 + P * rows * (d1 + d2 + d3))
                n_ops = 2.0 * P * rows * (d0 * d1 + d1 * d2 + d2 * d3)
                bound, by = bound_ms(n_bytes, n_ops)
                out.update(ms=ms, paced_ms=paced, plain_ms=plain,
                           solo_launches_ms=solo_ms, bound_ms=bound,
                           bound_by=by, shape=[P, rows, d0, d1, d2, d3])
    log(f"  mlp3_members: {cases} cases (P in {list(members)}; actor and "
        f"critic at 64 rows, the actor at the rollout's {rollout_rows}), "
        f"each member bit-equal to its one-network launch; max |kernel - "
        f"plain| {err:.3g} (tol 1e-5)")
    log(f"    actor {out['shape']}: {out['ms'] * 1e3:.2f} us kernel "
        f"({out['paced_ms'] * 1e3:.2f} paced), {out['shape'][0]} "
        f"one-network launches {out['solo_launches_ms'] * 1e3:.2f} us, "
        f"{out['plain_ms'] * 1e3:.2f} us plain, bound "
        f"{out['bound_ms'] * 1e3:.3f} us ({out['bound_by']}); {CARD}")
    out.update(max_abs_err=err, tolerance=1e-5, library_ms=None)
    if err > 1e-5:
        raise AssertionError(f"mlp3_members disagrees with its plain "
                             f"version: max abs err {err}")
    return out


def ddpg_network_shapes(state_dim, action_dim, hidden) -> dict:
    """Each DDPG network's leaves as ``_fused_adam_polyak`` hands them to
    the kernel (per layer "b" then "w")."""
    out = {}
    for name, d0, d3 in (("actor", state_dim, action_dim),
                         ("critic", state_dim + action_dim, 1)):
        dims = (d0,) + tuple(hidden) + (d3,)
        out[name] = [sh for a, b in zip(dims[:-1], dims[1:])
                     for sh in ((b,), (a, b))]
    return out


def check_adam_polyak(state_dim, action_dim, hidden, lr, tau, members,
                      device) -> dict:
    """The fused Adam + Polyak pass over each network's stacked leaves of
    the paper's trunk for each P of ``members`` (step counts from 1 to
    ~10^3, second moments non-negative): one launch a network, exact
    against ``fused_adam_polyak_ref`` (the same correctly rounded f32
    steps, lr_t / eps_t from ``powf`` as PyTorch's pow). Timed for both
    networks at P = 3 (the paper's p/q/pq population) beside the plain
    version, ``torch._fused_adam_`` + ``torch._foreach_lerp_`` on the same
    leaves (the library's fused Adam, its bias correction in the step,
    then the soft update) and the bytes bound (36 B an element)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.adam_polyak import adam_polyak_
    from repro_torch.kernels.ref import fused_adam_polyak_ref
    gen = torch.Generator(device=device).manual_seed(13)
    nets = ddpg_network_shapes(state_dim, action_dim, hidden)
    err, timed, n_el = 0.0, {}, 0

    def leaves_for(P, shapes):
        out = []
        for sh in shapes:
            r = lambda s=1.0: torch.randn((P, *sh), generator=gen,
                                          device=device) * s
            out.append((r(0.05), r(1e-3), r(1e-3) ** 2, r(1e-2), r(0.05)))
        t = torch.randint(0, 1000, (P,), generator=gen, device=device,
                          dtype=torch.int32)
        return out, t

    for P in members:
        for name, shapes in nets.items():
            leaves, t = leaves_for(P, shapes)
            want, t_want = fused_adam_polyak_ref(leaves, t, lr, tau)
            got = [tuple(x.clone() for x in leaf) for leaf in leaves]
            t_got = t.clone()
            before = build.LAUNCHES["adam_polyak"]
            adam_polyak_(got, t_got, lr, tau)
            if build.LAUNCHES["adam_polyak"] != before + 1:
                raise AssertionError("adam_polyak took more than one launch")
            if not torch.equal(t_got, t_want):
                raise AssertionError("adam_polyak: step counts differ")
            for g, w in zip(got, want):
                for a, b in zip(g[:3] + g[4:], w):
                    err = max(err, float((a - b).abs().max()))
            if P == 3:
                timed[name] = (leaves, t)
                n_el += sum(leaf[0].numel() for leaf in leaves)
    flat = {k: [[x for x in leaf] for leaf in leaves]
            for k, (leaves, _) in timed.items()}

    def kernel():
        for name, (leaves, t) in timed.items():
            adam_polyak_(flat[name], t, lr, tau)

    def plain():
        for name, (leaves, t) in timed.items():
            fused_adam_polyak_ref(flat[name], t, lr, tau)

    steps = {k: [torch.ones((), device=device) for _ in leaves]
             for k, (leaves, _) in timed.items()}

    def library():
        for name, leaves in flat.items():
            p, m, v, g, tg = (list(z) for z in zip(*leaves))
            torch._fused_adam_(p, g, m, v, [], steps[name], lr=lr,
                               beta1=0.9, beta2=0.999, weight_decay=0.0,
                               eps=1e-8, amsgrad=False, maximize=False)
            torch._foreach_lerp_(tg, p, tau)

    out = {"shape": [3, n_el // 3]}
    out["ms"], out["paced_ms"] = cuda_ms(kernel)
    out["plain_ms"], _ = cuda_ms(plain)
    out["library_ms"], _ = cuda_ms(library)
    out["bound_ms"], out["bound_by"] = bound_ms(36.0 * n_el, 14.0 * n_el)
    out.update(max_abs_err=err, tolerance=0.0)
    log(f"  adam_polyak: P in {list(members)}, actor and critic of the "
        f"paper trunk, one launch a network; max |kernel - plain| "
        f"{err:.3g} (tol 0), step counts equal")
    log(f"    both networks at P 3 ({n_el} elements, 2 launches), {CARD}: "
        f"{out['ms'] * 1e3:.2f} us kernel ({out['paced_ms'] * 1e3:.2f} "
        f"paced), {out['plain_ms'] * 1e3:.2f} us plain, "
        f"{out['library_ms'] * 1e3:.2f} us torch._fused_adam_ + "
        f"torch._foreach_lerp_, bound {out['bound_ms'] * 1e3:.3f} us "
        f"({out['bound_by']})")
    if err > 0.0:
        raise AssertionError(f"adam_polyak disagrees with its plain "
                             f"version: max abs err {err}")
    return out


def check_fake_quant_slot_split(device, K: int = 80) -> dict:
    """K1 over more than ``MAX_SLOTS`` policy slots (a population's P·K
    policies): the wrappers cut the slots into launches of at most 64
    (2 for 80), host bits and device bits, per-slot activations and a
    weight shared by the slots, f32 and bf16, straight-through: exact
    against the plain version slot by slot."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.fake_quant import (MAX_SLOTS, fake_quant_slots,
                                                fake_quant_slots_dev,
                                                launches)
    from repro_torch.kernels.ref import fake_quant_slots_ref
    gen = torch.Generator(device=device).manual_seed(14)
    bits = tuple(int(b) for b in torch.randint(
        2, 9, (K,), generator=gen, device=device).tolist())
    bits = (32,) + bits[1:]
    dev_bits = torch.tensor(bits, dtype=torch.int32, device=device)
    want_launches = len(launches(K))
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for x in (torch.randn((K, 512, 64), generator=gen,
                              device=device).to(dtype),
                  torch.randn((256, 128), generator=gen, device=device)
                  .to(dtype).expand(K, 256, 128)):
            want = fake_quant_slots_ref(x, bits, True)
            for key, fn, b in (
                    ("fake_quant_slots", fake_quant_slots, bits),
                    ("fake_quant_slots_dev", fake_quant_slots_dev,
                     dev_bits)):
                before = build.LAUNCHES[key]
                got = fn(x, b, ste=True)
                if build.LAUNCHES[key] != before + want_launches:
                    raise AssertionError(f"{key} over {K} slots took "
                                         f"{build.LAUNCHES[key] - before} "
                                         f"launches, not {want_launches}")
                err = max(err, float((got.float() - want.float()).abs()
                                     .max()))
    log(f"  K1 over {K} slots (more than {MAX_SLOTS}): {want_launches} "
        f"launches a call, host and device bits, f32 and bf16; max |kernel"
        f" - plain| {err:.3g} (tol 0)")
    if err > 0.0:
        raise AssertionError(f"K1 split over {K} slots disagrees with its "
                             f"plain version: max abs err {err}")
    return {"slots": K, "launches": want_launches, "max_abs_err": err}


# granite-3-8b's MLP at full width (configs/granite_3_8b.py: d 4,096,
# SwiGLU d_ff 12,800; up and gate folded into n 25,600 as
# core/measure.py::_unit_dims charges them) at 32 tokens (decode-like:
# bound by streaming the weights) and 4,096 (bound by the int8 products)
GRANITE_MLP = ((32, 4096, 25600), (4096, 4096, 25600))


def quant_matmul_shapes(cfg) -> tuple:
    """(M, K, N) of K4/K5's checks, as (timed, checked only): the
    ``measure_kernel_rows`` shape, every unit (k, n) of the testbed at
    the calibration's tokens and ``GRANITE_MLP``, all on the tensor-core
    route; the JAX tests' ragged shapes and one odd K, on the CUDA-core
    route."""
    from repro_torch.configs.testbed import VAL_SEQ
    from repro_torch.core.compress import lm_layer_specs
    from repro_torch.core.measure import _unit_dims
    from repro_torch.launch.calibrate import CALIB_SEQS
    m = CALIB_SEQS * VAL_SEQ
    timed = [(256, 256, 256)] + [(m,) + _unit_dims(s)
                                 for s in lm_layer_specs(cfg)]
    return (list(dict.fromkeys(timed + list(GRANITE_MLP))),
            [(33, 512, 257), (200, 300, 130), (64, 301, 96)])


def quant_matmul_simt(args, packed: bool, K: int):
    """K4/K5's CUDA-core kernel at any shape, through its launch symbol
    (the parent of the tensor-core route, timed beside it)."""
    import torch
    from repro_torch.kernels import build
    xq, wq = args[0], args[1]
    M, N = xq.shape[0], wq.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    name = "quant_matmul_int4" if packed else "quant_matmul_int8"
    err = getattr(build.lib("quant_matmul"), f"{name}_launch")(
        *(t.data_ptr() for t in args), out.data_ptr(), M, N, K, K,
        torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, f"{name} (CUDA-core route)")
    return out


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def check_quant_matmul(cfg, device) -> dict:
    """K4 and K5 against their plain version on the card; tolerance: exact
    (int32 products are exact in both, and the epilogue is the same
    correctly rounded f32 steps in the same order). At every shape of
    ``quant_matmul_shapes`` with k_true = K, each call counted on the
    route ``kernels.quant_matmul.route`` names (the timed shapes on the
    tensor-core route, the ragged ones not); the timed shapes timed with
    the plain version, ``torch._int_mm``, the CUDA-core kernel (the
    parent) and the bound. Then the asymmetric case (x + 3, w − 1) with
    the SUBTRACT-convention canary, and a K padded from 300 to 512 with
    k_true = 300, both on the tensor-core route. ``ops.quantized_matmul``
    must stay within the JAX tests' bounds of the f32 product (0.03
    relative at int8, 0.2 at int4)."""
    import torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.quant_matmul import plan, quant_matmul
    gen = torch.Generator(device=device).manual_seed(4)
    timed, ragged = quant_matmul_shapes(cfg)
    out = {}
    for bits, name in ((8, "quant_matmul_int8"), (4, "quant_matmul_int4")):
        packed = bits == 4
        err, units, res = 0.0, [], {}
        for (M, K, N) in timed + ragged:
            x = torch.randn((M, K), generator=gen, device=device)
            w = torch.randn((K, N), generator=gen, device=device)
            args, _ = ops.quantize_operands(x, w, bits)
            tc0 = build.LAUNCHES["quant_matmul_tc"]
            got = quant_matmul(*args, packed=packed, k_true=K)
            tc = build.LAUNCHES["quant_matmul_tc"] - tc0
            want = ref.quant_matmul_ref(*args, packed=packed, k_true=K)
            err = max(err, float((got - want).abs().max()))
            del got, want
            if err > 0.0:
                raise AssertionError(f"{name} ({M}, {K}, {N}) disagrees with "
                                     f"its plain version: max abs err {err}")
            rel = _rel(ops.quantized_matmul(x, w, w_bits=bits), x @ w)
            big = (M, K, N) in GRANITE_MLP
            log(f"  {name} ({M}, {K}, {N}), route {'tc' if tc else 'simt'}"
                f": max |kernel - plain| so far {err:.3g}; |quantized - f32|"
                f" / |f32| = {rel:.4f}")
            if rel > (0.2 if packed else 0.03):
                raise AssertionError(f"{name} ({M}, {K}, {N}): quantized "
                                     f"product off the f32 one by {rel}")
            if tc != ((M, K, N) in timed):
                raise AssertionError(f"{name} ({M}, {K}, {N}) took the "
                                     f"{'tensor' if tc else 'CUDA'}-core "
                                     f"route")
            del x, w
            if (M, K, N) not in timed:
                continue
            iters = (5, 1) if big else (50, 5)
            ms, paced = cuda_ms(lambda: quant_matmul(*args, packed=packed,
                                                     k_true=K), *iters)
            parent, _ = cuda_ms(lambda: quant_matmul_simt(args, packed, K),
                                *((2, 1) if big else iters))
            plain, _ = cuda_ms(lambda: ref.quant_matmul_ref(
                *args, packed=packed, k_true=K), *iters)
            codes = ref.unpack_int4_ref(args[1]) if packed else args[1]
            int_mm, _ = cuda_ms(lambda: torch._int_mm(args[0], codes),
                                *iters)
            del codes
            n_bytes = (M * K + (K * N // 2 if packed else K * N)
                       + 4 * M * N + 8 * (M + N))
            bound, by = bound_ms(n_bytes, 2.0 * M * N * K, INT8_OPS)
            p = plan(M, K, N, packed)
            row = dict(shape=[M, K, N], ms=ms, paced_ms=paced, plain_ms=plain,
                       int_mm_ms=int_mm, parent_ms=parent, bound_ms=bound,
                       bound_by=by, split=p.split, stages=p.stages)
            log(f"    {[M, K, N]}: {ms * 1e3:.2f} us kernel (tc, split "
                f"{p.split}, {p.stages} stages), {parent * 1e3:.2f} us the "
                f"CUDA-core kernel, {plain * 1e3:.2f} us plain, "
                f"{int_mm * 1e3:.2f} us torch._int_mm (the int8 product "
                f"alone), bound {bound * 1e3:.3f} us ({by}); {CARD}")
            if not ms < parent:
                raise AssertionError(f"{name} {[M, K, N]}: the tensor-core "
                                     f"route ({ms * 1e3:.2f} us) is not "
                                     f"faster than the CUDA-core kernel "
                                     f"({parent * 1e3:.2f} us)")
            if (M, K, N) == (256, 256, 256):
                res.update(row)
            else:
                units.append(row)
            del args
            torch.cuda.empty_cache()
        res.update(units=units, library_ms=None)

        # asymmetric zero points: large correction terms, so a sign slip
        # in the epilogue is a gross miss
        x = torch.randn((64, 128), generator=gen, device=device) + 3.0
        w = torch.randn((128, 96), generator=gen, device=device) - 1.0
        (xq, wq, sx, zx, sw, zw), _ = ops.quantize_operands(x, w, bits)
        tc0 = build.LAUNCHES["quant_matmul_tc"]
        got = quant_matmul(xq, wq, sx, zx, sw, zw, packed=packed)
        if build.LAUNCHES["quant_matmul_tc"] != tc0 + 1:
            raise AssertionError(f"{name}: the asymmetric case did not take "
                                 f"the tensor-core route")
        err = max(err, float((got - ref.quant_matmul_ref(
            xq, wq, sx, zx, sw, zw, packed=packed)).abs().max()))
        codes = ref.unpack_int4_ref(wq) if packed else wq
        truth = ref.dequant_matmul_ref(xq, codes, sx, zx, sw, zw)
        torch.testing.assert_close(got, truth, rtol=1e-3, atol=0.1)
        rel = _rel(truth, x @ w)
        wrong = _rel(ref.int8_matmul_ref(xq, codes, sx, -zx, sw, -zw), x @ w)
        log(f"  {name} asymmetric (64, 128, 96): |kernel - dequantized "
            f"truth| ok; rel vs f32 {rel:.4f}, SUBTRACT convention {wrong:.3g}")
        if not rel < (0.2 if packed else 0.03) or not wrong > 10 * rel:
            raise AssertionError(f"{name}: asymmetric case rel {rel}, "
                                 f"SUBTRACT canary {wrong}")

        # K padded 300 -> 512 with zero codes; k_true keeps the true count
        x = torch.randn((32, 300), generator=gen, device=device) + 1.0
        w = torch.randn((300, 64), generator=gen, device=device)
        xq, sx, zx = ref.quantize_rows(x, 8)
        codes, sw, zw = ref.quantize_cols(w, bits)
        truth = ref.dequant_matmul_ref(xq, codes, sx, zx, sw, zw)
        xq_p = torch.zeros((32, 512), dtype=torch.int8, device=device)
        xq_p[:, :300] = xq
        wq_p = torch.zeros((512, 64), dtype=torch.int8, device=device)
        wq_p[:300] = codes
        wq_p = ref.pack_int4(wq_p) if packed else wq_p
        tc0 = build.LAUNCHES["quant_matmul_tc"]
        got = quant_matmul(xq_p, wq_p, sx, zx, sw, zw, packed=packed,
                           k_true=300)
        if build.LAUNCHES["quant_matmul_tc"] != tc0 + 1:
            raise AssertionError(f"{name}: the k_true case did not take "
                                 f"the tensor-core route")
        err = max(err, float((got - ref.quant_matmul_ref(
            xq_p, wq_p, sx, zx, sw, zw, packed=packed, k_true=300)
        ).abs().max()))
        torch.testing.assert_close(got, truth, rtol=1e-3, atol=0.1)
        bad = float((quant_matmul(xq_p, wq_p, sx, zx, sw, zw, packed=packed)
                     - truth).abs().max())
        log(f"  {name} K padded 300 -> 512: k_true ok; without it off by "
            f"{bad:.3g}")
        if not bad > 1.0:
            raise AssertionError(f"{name}: k_true has no effect ({bad})")

        res.update(max_abs_err=err, tolerance=0.0)
        if err > 0.0:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"max abs err {err}")
        out[name] = res
    return out


def attention_work(B, H, KV, S, D, itemsize, causal=True, window=0):
    """(bytes, operations) K6 must at least move and do: q, k, v read and
    the output written once; two products of D multiply-adds for every
    (query, key) pair the mask keeps per head: S(S+1)/2 causal; with a
    window w, row q keeps min(q + 1, w) keys causal and S - max(0, q - w
    + 1) otherwise."""
    w = min(window, S) if window > 0 else S
    if causal:
        pairs = w * (w + 1) / 2 + (S - w) * w
    else:
        pairs = S * S - (S - w) * (S - w + 1) / 2
    return (itemsize * (2 * B * H * S * D + 2 * B * KV * S * D),
            4.0 * B * H * D * pairs)


def row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the rows (last axis) of
    two attention outputs, in f32."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-30)).max())


def attention_tail_ref(q, k, v, rows: int, window: int = 0,
                       causal: bool = True):
    """``ref.attention_ref``'s arithmetic (dense f32 softmax, causal or
    not, ``window`` keys when > 0) for the last ``rows`` query rows of q
    [B,H,S,D] only, in q's dtype: at the prefill length the whole score
    matrix would not fit, its last rows (the q tiles with the most keys)
    do."""
    import torch
    B, H, S, D = q.shape
    KV = k.shape[1]
    qq = q[:, :, S - rows:].reshape(B, KV, H // KV, rows, D)
    s = torch.einsum("bkgqd,bkld->bkgql", qq.float(),
                     k.float()) / math.sqrt(D)
    qpos = torch.arange(S - rows, S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    keep = kpos <= qpos if causal else torch.ones_like(kpos >= 0)
    if window > 0:
        keep &= kpos > qpos - window
    s = torch.where(keep, s, torch.full_like(s, -1e30))
    o = torch.einsum("bkgql,bkld->bkgqd", torch.softmax(s, -1), v.float())
    return o.reshape(B, H, rows, D).to(q.dtype)


def sdpa(q, k, v, causal=True):
    """The library yardstick for K6 (timed only; the port never calls
    it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def sdpa_window(q, k, v, window: int):
    """The library yardstick for K6 with a causal window: SDPA has no
    window argument, so the window is an explicit boolean [S, S] mask,
    over k and v repeated to q's heads (SDPA's memory-efficient kernel
    takes a mask but no grouped heads). Returns a function of no
    arguments to time (the mask and the repeat are made once, here)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    S = q.shape[2]
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    g = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(g, 1) for t in (k, v))

    def run():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)
    return run


FA_MASKS = ((True, 0), (False, 0), (True, 96))
# (B, S, H, KV, D), dtype, atol, masks: the JAX tests' shapes in f32
# (causal, bidirectional, window 96) and their bf16 case, qwen2-0.5b's
# heads (14 over 2 of 64) at S 4096 in bf16; head dim 256 as
# recurrentgemma-2b has it (MQA, 10 over 1 heads): f32 at a ragged S, bf16
# at S 128 and at S 4,096 with its window of 2,048; head dim 80 as
# hubert-xlarge has it: f32 at a ragged S (the CUDA-core route), bf16 (the
# tensor-core route: a 64-column and a 16-column box a row) at S 128, at a
# ragged S over grouped heads (8 over 2), and its 16 / 16 heads
# bidirectional at S 4,096.
FA_CASES = (((2, 128, 4, 4, 32), "float32", 2e-5, FA_MASKS),
            ((2, 200, 8, 2, 16), "float32", 2e-5, FA_MASKS),
            ((2, 512, 4, 1, 64), "float32", 2e-5, FA_MASKS),
            ((1, 128, 4, 2, 32), "bfloat16", 0.04, FA_MASKS),
            ((1, 4096, 14, 2, 64), "bfloat16", 0.04, FA_MASKS),
            ((2, 300, 4, 1, 256), "float32", 2e-5, FA_MASKS),
            ((1, 128, 10, 1, 256), "bfloat16", 0.04,
             ((True, 0), (True, 2048), (True, 96))),
            ((1, 4096, 10, 1, 256), "bfloat16", 0.04,
             ((True, 0), (True, 2048))),
            ((2, 200, 4, 4, 80), "float32", 2e-5, FA_MASKS),
            ((1, 128, 4, 4, 80), "bfloat16", 0.04, FA_MASKS),
            ((2, 300, 8, 2, 80), "bfloat16", 0.04, FA_MASKS),
            ((1, 4096, 16, 16, 80), "bfloat16", 0.04,
             ((False, 0), (True, 0))))
# (head dim, window) of the S 4096 masks timed: qwen2's causal heads and
# recurrentgemma's window.
FA_TIMED = ((64, 0), (256, 2048))


def k6_launch(call, dtype, head_dim: int):
    """``call()`` (one K6 call) and the route it must have taken: on the
    card it must count one ``flash_attention`` launch, and one
    ``flash_attention_tc`` launch exactly when ``route`` says "tc"; on
    the CPU none. Returns (output, route)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import route
    before = dict(build.LAUNCHES)
    got = call()
    path = route(dtype, head_dim)
    on_card = got.is_cuda
    want = (int(on_card), int(on_card and path == "tc"))
    seen = tuple(build.LAUNCHES[k] - before[k]
                 for k in ("flash_attention", "flash_attention_tc"))
    if seen != want:
        raise AssertionError(f"K6 launches (all, tc) {seen}, {want} "
                             f"expected on route {path}")
    return got, path


def check_flash_attention(device, cases=FA_CASES) -> dict:
    """K6 against the dense plain version ``attention_ref`` at each case's
    masks: f32 at atol 2e-5, bf16 at atol 0.04 and each row within
    ``K6_ROW_TOL``; each call on the route ``k6_launch`` checks. On the
    card the S 4096 masks of ``FA_TIMED`` are timed beside the plain
    version and SDPA (a window as a boolean mask, ``sdpa_window``).
    Returns those rows by head dim (each with the shape's worst errors
    over its masks); the rows of the prefill shapes come from
    ``check_flash_attention_prefill``."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(5)
    out = {}
    for (B, S, H, KV, D), dtype, tol, masks in cases:
        dtype = getattr(torch, dtype)
        q, k, v = [torch.randn(shape, generator=gen, device=device).to(dtype)
                   for shape in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]
        worst = (0.0, 0.0)          # the shape's max over the masks
        for causal, window in masks:
            got, path = k6_launch(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window), dtype, D)
            want = ref.attention_ref(q, k, v, causal=causal, window=window)
            err = float((got.float() - want.float()).abs().max())
            rel = row_rel_err(got, want)
            rel_tol = K6_ROW_TOL if dtype == torch.bfloat16 else math.inf
            log(f"  flash_attention {(B, H, KV, S, D)} {str(dtype)[6:]} "
                f"causal={causal} window={window}, route {path}: max "
                f"|kernel - plain| {err:.3g} (tol {tol}), max row rel "
                f"{rel:.3g} (tol {rel_tol:.3g})")
            if not (err <= tol and rel <= rel_tol):
                raise AssertionError(f"flash_attention disagrees with its "
                                     f"plain version: {err} > {tol} or "
                                     f"{rel} > {rel_tol}")
            worst = (max(worst[0], err), max(worst[1], rel))
        for d, w in FA_TIMED:
            if (S, D) != (4096, d) or not q.is_cuda:
                continue
            ms, paced = cuda_ms(lambda: ops.flash_attention(
                q, k, v, window=w), 10, 2)
            plain, _ = cuda_ms(lambda: ref.attention_ref(q, k, v, window=w),
                               3, 1)
            lib, _ = cuda_ms(sdpa_window(q, k, v, w) if w else
                             (lambda: sdpa(q, k, v)), 10, 2)
            n_bytes, n_ops = attention_work(B, H, KV, S, D, 2, window=w)
            bound, by = bound_ms(n_bytes, n_ops, BF16_FLOPS)
            out[D] = dict(shape=[B, H, KV, S, D] + ([w] if w else []),
                          ms=ms, paced_ms=paced, plain_ms=plain,
                          library_ms=lib, bound_ms=bound, bound_by=by,
                          max_abs_err=worst[0], tolerance=tol,
                          row_rel_err=worst[1], route=path,
                          tflops=n_ops / ms / 1e9)
            log(f"    S 4096 D {D} window {w} bf16, route {path}, {CARD}: "
                f"{ms:.3f} ms "
                f"kernel ({n_ops / ms / 1e9:.1f} TFLOP/s), {plain:.3f} ms "
                f"plain (dense), {lib:.3f} ms SDPA"
                f"{' (boolean window mask)' if w else ''}, bound "
                f"{bound:.4f} ms ({by})")
    return out


def ssd_work(B, S, H, P, N, L):
    """(bytes, operations) K8 must at least move and do: x, dA, B and C
    read and y and the final state written once (f32); per chunk of Lc
    tokens, C Bᵀ on its lower triangle once (shared by the heads), and
    per (chunk, head) the masked product with X on the triangle, C ·
    stateᵀ and the chunk's state (2 operations per multiply-add)."""
    n_bytes = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * N
                   + B * H * P * N)
    ops = 0.0
    for c0 in range(0, S, L):
        lc = min(L, S - c0)
        tri = lc * (lc + 1) / 2
        ops += 2 * tri * N + H * (2 * tri * P + 4 * lc * N * P)
    return n_bytes, B * ops


def ssd_errors(got, want) -> dict:
    """max |got - want|, the largest ||got - want|| / max(||want||,
    K8_ROW_EPS) over the rows (last axis), where that row is (its index
    over the leading axes) and its norm, and the smallest row norm of
    want."""
    g, w = got.float(), want.float()
    norm = w.norm(dim=-1)
    rel = (g - w).norm(dim=-1) / norm.clamp_min(K8_ROW_EPS)
    worst = int(rel.argmax())
    at = []
    for n in reversed(rel.shape):
        at.insert(0, worst % n)
        worst //= n
    return {"abs": float((g - w).abs().max()), "row": float(rel.max()),
            "row_at": at, "row_norm": float(norm[tuple(at)]),
            "min_norm": float(norm.min())}


def ssd_case(seed, B, S, H, P, N, max_decay, device, views=False):
    """Seeded inputs: x, B, C standard normal, dA uniform in
    [-max_decay, 0]; with ``views`` B and C are strided views into one
    wider tensor, as the SSM block makes them in f32."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x, dA = (rng.standard_normal((B, S, H, P)).astype(f32),
             -rng.uniform(0.0, max_decay, (B, S, H)).astype(f32))
    if views:
        wide = torch.from_numpy(rng.standard_normal(
            (B, S, 2 * N + 8)).astype(f32)).to(device)
        return [torch.from_numpy(x).to(device),
                torch.from_numpy(dA).to(device), wide[..., 8:8 + N],
                wide[..., 8 + N:]]
    return [torch.from_numpy(a).to(device) for a in (
        x, dA, rng.standard_normal((B, S, N)).astype(f32),
        rng.standard_normal((B, S, N)).astype(f32))]


# (B, S, H, P, N), chunk, max decay[, B and C as views]: the JAX tests'
# shapes (the CUDA-core route), a ragged S at mamba2's heads, its B and C
# as views of one wider tensor, the slow decay at its 48 heads (the
# tensor-core route).
SSD_CASES = (((2, 64, 4, 16, 8), 16, 0.5), ((1, 128, 2, 32, 16), 32, 0.5),
             ((2, 96, 3, 8, 8), 32, 0.5), ((1, 1100, 4, 64, 128), 256, 0.5),
             ((2, 600, 3, 64, 128), 256, 0.5, True),
             ((1, 4096, 48, 64, 128), 256, 0.01))
SSD_TIMED_S = 4096


def check_ssd_scan(device, cases=SSD_CASES) -> dict:
    """K8 against its plain versions: the sequential ``ssd_scan_ref`` and
    the chunked ``ssd_chunked_ref``. At the JAX tests' shapes and a
    ragged S 1,100 at mamba2's heads (dA in [-0.5, 0]) y and the final
    state within 2e-4 (atol and rtol) of both; at the slow decay (dA in
    [-0.01, 0], 48 heads of 64, state 128, S 4,096: the state carries
    over 16 chunks) within 2e-4 of the chunked one and, as everywhere,
    each row within ``K8_ROW_TOL`` of both. Times the slow-decay case
    beside the chunked plain version and the bound; returns that row."""
    import torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.ssd_scan import route
    out = {}
    for i, ((B, S, H, P, N), chunk, decay, *views) in enumerate(cases):
        xh, dA, Bm, Cm = ssd_case(10 + i, B, S, H, P, N, decay, device,
                                  views=bool(views))
        path = route(P, N, min(chunk, S))
        before = build.LAUNCHES["ssd_scan_tc"]
        y, fin = ops.ssd_scan(xh, dA, Bm, Cm, chunk=chunk)
        if xh.is_cuda and build.LAUNCHES["ssd_scan_tc"] != \
                before + (path == "tc"):
            raise AssertionError(f"ssd_scan at {(B, S, H, P, N)} did not "
                                 f"take its {path} route")
        ok = True
        for name, (wy, wf) in (
                ("sequential", ref.ssd_scan_ref(xh, dA, Bm, Cm)),
                ("chunked", ref.ssd_chunked_ref(xh, dA, Bm, Cm, chunk))):
            ey, ef = ssd_errors(y, wy), ssd_errors(fin, wf)
            close = torch.allclose(y, wy, K8_TOL, K8_TOL) and \
                torch.allclose(fin, wf, K8_TOL, K8_TOL)
            held = decay > 0.01 or name == "chunked"
            log(f"  ssd_scan {(B, S, H, P, N)} chunk {chunk} route {path}"
                f"{' (B, C views)' if views else ''} dA in "
                f"[-{decay}, 0] vs {name}: y max abs {ey['abs']:.3g}, max "
                f"row rel {ey['row']:.3g} (min row norm "
                f"{ey['min_norm']:.3g}); final state max abs "
                f"{ef['abs']:.3g}, max row rel {ef['row']:.3g}; allclose "
                f"2e-4 {close}{'' if held else ' (not held)'}")
            ok &= ey["row"] <= K8_ROW_TOL and ef["row"] <= K8_ROW_TOL
            ok &= close or not held
            if name == "chunked":
                err = max(ey["abs"], ef["abs"])
                row = max(ey["row"], ef["row"])
        if not ok:
            raise AssertionError(f"ssd_scan disagrees with its plain "
                                 f"versions at {(B, S, H, P, N)}")
        if S == SSD_TIMED_S and xh.is_cuda:
            ms, paced = cuda_ms(lambda: ops.ssd_scan(xh, dA, Bm, Cm,
                                                     chunk=chunk), 10, 2)
            plain, _ = cuda_ms(lambda: ref.ssd_chunked_ref(xh, dA, Bm, Cm,
                                                           chunk), 3, 1)
            n_bytes, n_ops = ssd_work(B, S, H, P, N, chunk)
            bound, by = bound_ms(n_bytes, n_ops)
            tc_bound, tc_by = bound_ms(n_bytes, 3 * n_ops, TF32_FLOPS)
            out = dict(shape=[B, S, H, P, N, chunk], ms=ms, paced_ms=paced,
                       plain_ms=plain, library_ms=None, bound_ms=bound,
                       bound_by=by, tc_bound_ms=tc_bound, max_abs_err=err,
                       tolerance=K8_TOL, row_rel_err=row, route=path)
            log(f"    S 4096, route {path}, {CARD}: {ms * 1e3:.1f} us "
                f"kernel ({n_ops / ms / 1e9:.2f} TFLOP/s), {plain * 1e3:.1f}"
                f" us chunked plain, bound {bound * 1e3:.1f} us f32 ({by}),"
                f" {tc_bound * 1e3:.1f} us split TF32 ({tc_by}); no "
                f"library call computes this function")
    return out


def rglru_work(B, S, C, itemsize=4):
    """(bytes, operations) K7 must at least move and do: a and b read
    and h written once; one multiply and one add per element."""
    return 3.0 * itemsize * B * S * C, 2.0 * B * S * C


def rglru_errors(got, want) -> dict:
    """max |got - want|; the largest ||got - want|| / max(||want||,
    K8_ROW_EPS) over the (batch, token, ``K7_BLOCK``-channel block) rows
    (a ragged last block padded with zeros), where that row is and its
    norm, and the smallest row norm of want."""
    import torch.nn.functional as F
    g, w = got.float(), want.float()
    pad = (-w.shape[-1]) % K7_BLOCK
    blocks = w.shape[:-1] + (-1, K7_BLOCK)
    gb = F.pad(g, (0, pad)).reshape(blocks)
    wb = F.pad(w, (0, pad)).reshape(blocks)
    norm = wb.norm(dim=-1)
    rel = (gb - wb).norm(dim=-1) / norm.clamp_min(K8_ROW_EPS)
    at = [int(i) for i in divmod(int(rel.argmax()), rel.shape[-1])]
    at = list(divmod(at[0], rel.shape[1])) + at[1:]
    return {"abs": float((g - w).abs().max()), "row": float(rel.max()),
            "row_at": at, "row_norm": float(norm[tuple(at)]),
            "min_norm": float(norm.min())}


def lru_case(seed, B, S, C, a_range, device, with_h0=False):
    """Seeded inputs: b standard normal; a uniform in ``a_range``, or
    ``"path"``: recurrentgemma-2b's init, a = linspace(0.9, 0.999)^r per
    channel at its gate r = sigmoid(0) = 0.5, with b = sqrt(1 - a^2) 0.5
    u (the input gate i = 0.5);
    h0 standard normal [B, C] or None."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    f32 = np.float32
    u = rng.standard_normal((B, S, C)).astype(f32)
    if a_range == "path":
        a = np.sqrt(np.linspace(0.9, 0.999, C, dtype=f32))
        a = np.tile(a, (B, S, 1))
        b = (np.sqrt(1 - a * a) * 0.5 * u).astype(f32)
    else:
        a = rng.uniform(*a_range, (B, S, C)).astype(f32)
        b = u
    h0 = rng.standard_normal((B, C)).astype(f32) if with_h0 else None
    return [None if t is None else torch.from_numpy(t).to(device)
            for t in (a, b, h0)]


# (B, S, C), a's range, with h0: the JAX tests' shapes and their h0 case,
# a ragged S and C, recurrentgemma-2b's width at S 4,096 with its init's
# slow decays.
RGLRU_CASES = (((2, 64, 96), (0.4, 0.99), False),
               ((1, 128, 32), (0.4, 0.99), False),
               ((3, 48, 256), (0.4, 0.99), False),
               ((2, 32, 64), (0.5, 0.95), True),
               ((2, 1000, 2600), (0.4, 0.99), False),
               ((2, 200, 99), (0.4, 0.99), False),
               ((1, 4096, 2560), "path", False))
RGLRU_TIMED_S = 4096
# (B, S, C), chunk: tiles (4,096 chunks x 8 slabs) far past what the card
# holds at once.
RGLRU_WAVES = ((1, 65536, 256), 16)


def k7_three_pass(a, b, h0=None, chunk: int = 128):
    """The former three-launch K7 (``tools/k7_three_pass.cu``, built at
    first use) on CUDA tensors: the chained kernel equals it bit for bit
    at the same chunk."""
    import importlib.util
    mod = sys.modules.get("k7_ablation")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "k7_ablation", os.path.join(ROOT, "tools", "k7_ablation.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules["k7_ablation"] = mod
        spec.loader.exec_module(mod)
    return mod.three_pass(a, b, h0, chunk)


def rglru_held(got, want, a, b, h0, chunk, what: str) -> dict:
    """K7's output ``got`` held against the sequential plain version
    ``want`` (atol, each row within ``K7_ROW_TOL``, bit-equal where S fits
    one chunk) and, on the card, bit for bit against the three-pass
    kernel at ``chunk``; logs one line, raises on a miss."""
    import torch
    e = rglru_errors(got, want)
    exact = bool((got == want).all())
    three = (torch.equal(got, k7_three_pass(a, b, h0, chunk))
             if got.is_cuda else None)
    log(f"  rglru_scan {what}, chunk {chunk}: max |kernel - plain| "
        f"{e['abs']:.3g} (tol {K7_TOL}), max row rel {e['row']:.3g} (tol "
        f"{K7_ROW_TOL:.3g}; min row norm {e['min_norm']:.3g}); bit-equal "
        f"{exact}; bit-equal to the three-pass kernel "
        f"{'-' if three is None else three}")
    if not (e["abs"] <= K7_TOL and e["row"] <= K7_ROW_TOL
            and (exact or a.shape[1] > chunk) and three is not False):
        raise AssertionError(f"rglru_scan disagrees with its plain version "
                             f"or the three-pass kernel ({what}, chunk "
                             f"{chunk}): {e}, three-pass equal {three}")
    return e


def check_rglru_scan(device, cases=RGLRU_CASES) -> dict:
    """K7 against its sequential plain version ``rglru_scan_ref``, at the
    default chunk and at chunk 16 (more chunks: the state carried between
    them matters): atol 2e-5 as the JAX tests hold it, each (token,
    256-channel) row within ``K7_ROW_TOL``, bit-equal where S fits one
    chunk (the same correctly rounded multiply and add per step), and on
    the card bit for bit equal to the three-pass kernel at the same
    chunk. The S 4,096 case is timed beside the plain version and the
    bound; returns that row."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rglru_scan import CHUNK, rglru_scan
    out = {}
    for i, ((B, S, C), a_range, with_h0) in enumerate(cases):
        a, b, h0 = lru_case(20 + i, B, S, C, a_range, device, with_h0)
        want = ref.rglru_scan_ref(a, b, h0)
        for chunk in (CHUNK, 16):
            got = rglru_scan(a, b, h0, chunk=chunk)
            rglru_held(got, want, a, b, h0, chunk,
                       f"{(B, S, C)} a in {a_range}"
                       f"{' with h0' if with_h0 else ''}")
        if S == RGLRU_TIMED_S and a.is_cuda:
            ms, paced = cuda_ms(lambda: ops.rglru_scan(a, b), 20, 3)
            plain, _ = cuda_ms(lambda: ref.rglru_scan_ref(a, b), 1, 1)
            n_bytes, n_ops = rglru_work(B, S, C)
            bound, by = bound_ms(n_bytes, n_ops)
            g = ops.rglru_scan(a, b)
            e = rglru_errors(g, want)
            out = dict(shape=[B, S, C], ms=ms, paced_ms=paced,
                       plain_ms=plain, library_ms=None, bound_ms=bound,
                       bound_by=by, max_abs_err=e["abs"], tolerance=K7_TOL,
                       row_rel_err=e["row"])
            log(f"    S 4096 C {C}, {CARD}: {ms * 1e3:.1f} us kernel "
                f"({n_bytes / ms / 1e6:.0f} GB/s of the bound's bytes), "
                f"{plain:.3f} ms plain (sequential), bound "
                f"{bound * 1e3:.1f} us ({by}); no library call computes "
                f"this function")
    return out


def check_rglru_waves(device, shape=RGLRU_WAVES[0],
                      chunk=RGLRU_WAVES[1]) -> None:
    """K7 where its tiles outnumber the blocks the card holds at once,
    so chunks wait on chunks that a block of an earlier wave published:
    held as ``rglru_held`` holds it, at the path's slow decays."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import plan, rglru_scan
    B, S, C = shape
    a, b, _ = lru_case(40, B, S, C, "path", device)
    p = plan(B, S, C, chunk, a.element_size())
    what = f"{(B, S, C)}, {p.tiles} tiles of {p.smem_bytes} bytes"
    if a.is_cuda:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        per_sm = min(32, 2048 // p.slab, 233472 // (p.smem_bytes + 1024))
        what += f" (the card holds at most {sms * per_sm} at once)"
        if p.tiles <= sms * per_sm:
            raise AssertionError(f"the many-wave case fits one wave: {what}")
    rglru_held(rglru_scan(a, b, chunk=chunk), ref.rglru_scan_ref(a, b), a,
               b, None, chunk, what)


def check_rglru_back_to_back(device, shape=(1, 4096, 2560)) -> None:
    """Two K7 calls on one stream with no sync between them, on other
    inputs (the path's decays, then a in [0.4, 0.99]): the second must
    take none of the first's state words and find the ticket back at
    zero. Each held as ``rglru_held`` holds it. On the card every kernel
    the profiler records must be K7's, at most two (no memset or fill
    beside them)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import CHUNK, rglru_scan
    B, S, C = shape
    first = lru_case(41, B, S, C, "path", device)
    second = lru_case(42, B, S, C, (0.4, 0.99), device)
    cuda = first[0].is_cuda
    if cuda:
        rglru_scan(first[0], first[1])
        torch.cuda.synchronize()
    with (profile(activities=[ProfilerActivity.CUDA]) if cuda
          else contextlib.nullcontext()) as prof:
        h1 = rglru_scan(first[0], first[1])
        h2 = rglru_scan(second[0], second[1])
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        kernels = device_kernels(prof)
        log(f"  rglru_scan, two calls back to back: kernels on the card "
            f"(profiler) {kernels or 'not measured (none recorded)'}")
        if len(kernels) > 2 or not all("lru_chained" in k
                                        for k in kernels):
            raise AssertionError(f"two K7 calls ran {kernels}, not two "
                                 f"lru_chained kernels")
    for n, (a, b, _), got in ((1, first, h1), (2, second, h2)):
        rglru_held(got, ref.rglru_scan_ref(a, b), a, b, None, CHUNK,
                   f"{(B, S, C)}, call {n} of 2 back to back")


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path, scalar and batched
# ---------------------------------------------------------------------------

def search_inputs(cfg, device, *, episodes: int, warmup: int,
                  updates: int, batch_size: int, val_batch: int,
                  val_seq: int, seed: int = 0):
    """The main path's model (seeded random weights), validation batch
    (seeded bigram tokens) and search config, shared by the scalar and
    the batched engine's phases."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.reward import RewardConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.pipeline import make_bigram_table, sample_bigram
    from repro_torch.models import model as M
    cm = CompressibleLM(cfg, M.init(cfg, seed=seed, device=device))
    table = make_bigram_table(cfg.vocab_size, seed)
    val = {"tokens": torch.as_tensor(
        sample_bigram(table, val_batch, val_seq, seed + 7),
        dtype=torch.int64, device=device)}
    scfg = SearchConfig(
        methods="pq", episodes=episodes, seed=seed,
        reward=RewardConfig(target_ratio=0.5, beta=-3.0),
        ddpg=DDPGConfig(warmup_episodes=warmup, updates_per_episode=updates,
                        batch_size=batch_size, buffer_size=2000))
    return cm, val, scfg


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def log_record(rec) -> None:
    bits = " ".join(f"{c.w_bits}/{c.a_bits}" for c in rec.policy.cmps)
    log(f"  ep {rec.episode:2d} reward={rec.reward:+.4f} "
        f"acc={rec.accuracy:.4f} lat_ratio={rec.latency_ratio:.4f} "
        f"sigma={rec.sigma:.3f} w/a bits: {bits}")


def run_search(cm, val, scfg, ctx, device, *, episodes: int,
               verbose: bool = True, reset_after_sensitivity: bool = False):
    """Sensitivity + ``episodes`` of the scalar pq search on ``cm``
    (validation batch ``val``, config ``scfg``, oracle context ``ctx``).
    Returns (search, history, sensitivity seconds, episode seconds); the
    host clock brackets work that ends in a device sync. With
    ``reset_after_sensitivity`` the launch counts are reset between the
    analysis and the episodes."""
    from repro_torch.core.search import CompressionSearch
    from repro_torch.core.sensitivity import run_sensitivity
    from repro_torch.kernels import build

    _sync(device)
    t0 = time.perf_counter()
    sens = run_sensitivity(cm, val)
    _sync(device)
    t_sens = time.perf_counter() - t0
    if verbose:
        log(f"  launches after the sensitivity analysis: "
            f"{dict(build.LAUNCHES)}")
    search = CompressionSearch(cm, val, scfg, ctx, sens=sens)
    _sync(device)
    if reset_after_sensitivity:
        build.reset_launches()
    t0 = time.perf_counter()
    history = []
    for e in range(episodes):
        rec = search.run_episode(e)
        history.append(rec)
        if verbose:
            log_record(rec)
    _sync(device)
    t_eps = time.perf_counter() - t0
    return search, history, t_sens, t_eps


def run_main_path(cfg, device, *, episodes: int, warmup: int, updates: int,
                  batch_size: int, val_batch: int, val_seq: int,
                  seed: int = 0, verbose: bool = True):
    """Sensitivity + ``episodes`` of the pq search on ``cfg`` with seeded
    random weights (``run_search``)."""
    from repro_torch.configs.testbed import SERVE_CTX
    cm, val, scfg = search_inputs(
        cfg, device, episodes=episodes, warmup=warmup, updates=updates,
        batch_size=batch_size, val_batch=val_batch, val_seq=val_seq,
        seed=seed)
    return run_search(cm, val, scfg, SERVE_CTX, device, episodes=episodes,
                      verbose=verbose)


def run_batched_search(cm, val, scfg, ctx, sens, device, *, slots: int,
                       verbose: bool = True):
    """The pq ``BatchedCompressionSearch`` (``slots`` episodes per batch,
    ``scfg.episodes`` in all) on ``cm`` with the sensitivity table
    ``sens``. The launch counts are reset just before the episodes.
    Returns (search, history, episode seconds)."""
    from repro_torch.core.search import BatchedCompressionSearch
    from repro_torch.kernels import build
    search = BatchedCompressionSearch(cm, val, scfg, ctx, sens=sens,
                                      batch_size=slots)
    _sync(device)
    build.reset_launches()
    t0 = time.perf_counter()
    history = search.run().history
    _sync(device)
    t_eps = time.perf_counter() - t0
    if verbose:
        for rec in history:
            log_record(rec)
    return search, history, t_eps


def run_batched_path(cfg, device, sens, *, episodes: int, warmup: int,
                     updates: int, batch_size: int, slots: int,
                     val_batch: int, val_seq: int, seed: int = 0,
                     verbose: bool = True):
    """``episodes`` of the pq ``BatchedCompressionSearch`` on the main
    path's model, validation batch, config and sensitivity table
    (``run_batched_search``)."""
    from repro_torch.configs.testbed import SERVE_CTX
    cm, val, scfg = search_inputs(
        cfg, device, episodes=episodes, warmup=warmup, updates=updates,
        batch_size=batch_size, val_batch=val_batch, val_seq=val_seq,
        seed=seed)
    return run_batched_search(cm, val, scfg, SERVE_CTX, sens, device,
                              slots=slots, verbose=verbose)


def batch_cspecs(search, history) -> list:
    """The batched cspec of each batch of ``history``'s policies, as the
    engine validated them."""
    from repro_torch.core.policy import stack_policies
    k = search.batch_size
    out = []
    for i in range(0, len(history), k):
        pb = stack_policies(search.specs,
                            [r.policy for r in history[i:i + k]])
        out.append(search.cmodel.cspec_builder()(pb.keep, pb.w_bits,
                                                 pb.a_bits))
    return out


def check_batch_records(search, history, episodes: int) -> None:
    """The batched engine's records: finite, in episode order, on the
    sigma schedule."""
    import numpy as np
    if [r.episode for r in history] != list(range(episodes)):
        raise AssertionError("records out of episode order")
    for r in history:
        vals = (r.reward, r.accuracy, r.latency_s, r.latency_ratio)
        if not all(math.isfinite(v) for v in vals) \
                or not 0.0 <= r.accuracy <= 1.0:
            raise AssertionError(f"bad record {r}")
        if r.sigma != float(np.float32(search.agent.sigma_at(r.episode))):
            raise AssertionError(f"episode {r.episode} off the sigma "
                                 f"schedule: {r.sigma}")


def check_batched_path(search, history, cfg, episodes: int,
                       launches: dict, per_step: dict, device) -> dict:
    """The batched phase's checks. Records: finite, in episode order, on
    the sigma schedule. Launches over the episodes: K1 over policy slots
    exactly once per fake-quant site of each batch's validation
    (``k1_calls`` of its batched cspec) and the one-tensor K1 never; K2
    and K3 per DDPG step as the scalar phase launched them (``per_step``).
    Then K1 over slots exact at every (shape, bits vector) the batches
    gave it, and on a small batch, for the last batch's policies: (1)
    under f32 compute the batched forward through the kernel equals, bit
    for bit, the same forward with the plain version in place; (2) each
    slot's accuracy is within the repo's bf16 bound (3%) of the scalar
    engine's ``accuracy(build_cspec(policy))`` under f32 compute, and its
    argmaxes agree with the scalar forward's on >= 97% under the path's
    bf16. The products over the slots are one bmm, which sums in another
    order than the scalar path's 2-D product in f32, so the f32 logits'
    difference and argmax agreement are printed, not held."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.policy import stack_policies
    from repro_torch.kernels import fake_quant as kfq
    from repro_torch.kernels.ref import fake_quant_slots_ref
    from repro_torch.models import model as M
    check_batch_records(search, history, episodes)
    cspecs = batch_cspecs(search, history)
    rows = search.val_batch["tokens"].shape[0] * (
        search.val_batch["tokens"].shape[1])
    sites = sum(len(k1_calls(cfg, cs, rows)) for cs in cspecs)
    cfg_ddpg = search.agent.cfg
    steps = cfg_ddpg.updates_per_episode * sum(
        r.episode >= cfg_ddpg.warmup_episodes for r in history)
    want = {"fake_quant_slots": sites, "fake_quant": 0,
            **{k: round(v * steps) for k, v in per_step.items()}}
    log(f"  launches {launches}; wanted {want} ({len(cspecs)} batched "
        f"validations, {sites} fake-quant sites in all)")
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"{k} launched {launches[k]} times on the "
                                 f"batched path, wanted {v}")
    err = 0.0
    for cs in cspecs:
        err = max(err, check_fake_quant_slot_calls(cfg, cs, rows,
                                                   device)["max_abs_err"])
    log(f"  K1 over slots at every (shape, bits vector) of the "
        f"{len(cspecs)} batches, f32 and bf16, plain and straight-through:"
        f" max |kernel - plain| {err:.3g} (tol 0)")

    f32 = cfg.replace(compute_dtype="float32")
    cm = CompressibleLM(f32, search.cmodel.params)
    small = {"tokens": search.val_batch["tokens"][:8]}
    pols = [r.policy for r in history[-search.batch_size:]]
    pb = stack_policies(cm.specs, pols)
    bcs = cm.cspec_builder()(pb.keep, pb.w_bits, pb.a_bits)
    with torch.no_grad():
        lg_kernel = M.forward(f32, cm.params, small["tokens"], bcs)
        launch = kfq.fake_quant_slots
        kfq.fake_quant_slots = lambda x, bits, ste=False: \
            fake_quant_slots_ref(x, bits, ste)
        try:
            lg_plain = M.forward(f32, cm.params, small["tokens"], bcs)
        finally:
            kfq.fake_quant_slots = launch
    if not torch.isfinite(lg_kernel).all() or tuple(lg_kernel.shape) != (
            len(pols),) + tuple(small["tokens"].shape) + (cfg.vocab_size,):
        raise AssertionError(f"bad batched logits {tuple(lg_kernel.shape)}")
    diff = float((lg_kernel - lg_plain).abs().max())
    log(f"  last batch's {len(pols)} policies, f32, small batch: max "
        f"|logit through K1 over slots - through its plain version| = "
        f"{diff:.3g}")
    if diff != 0.0:
        raise AssertionError("the batched kernel path and its plain "
                             "version differ")
    accs_b = cm.accuracy_batch(small, bcs).cpu().tolist()
    worst, bf16 = 0.0, 1.0
    cm16 = CompressibleLM(cfg, search.cmodel.params)
    lg16 = M.forward(cfg, cm16.params, small["tokens"],
                     cm16.cspec_builder()(pb.keep, pb.w_bits, pb.a_bits))
    for k, p in enumerate(pols):
        lg_s = cm.logits(small, cm.build_cspec(p))
        diff = float((lg_s - lg_kernel[k]).abs().max())
        a32 = float((lg_s.argmax(-1) == lg_kernel[k].argmax(-1)).float()
                    .mean())
        agree = float((cm16.logits(small, cm16.build_cspec(p)).argmax(-1)
                       == lg16[k].argmax(-1)).float().mean())
        acc_s = float(cm.accuracy(small, cm.build_cspec(p)))
        worst, bf16 = max(worst, abs(accs_b[k] - acc_s)), min(bf16, agree)
        log(f"    slot {k}: f32 accuracy batched {accs_b[k]:.4f}, scalar "
            f"{acc_s:.4f}, max |logit diff| {diff:.3g}, argmax agreement "
            f"{a32:.4f}; {cfg.compute_dtype} argmax agreement {agree:.4f}")
    if worst > 0.03:
        raise AssertionError(f"a batched policy's f32 accuracy is "
                             f"{worst:.4f} from its scalar accuracy")
    if bf16 < 0.97:
        raise AssertionError(f"a batched policy's {cfg.compute_dtype} "
                             f"argmaxes agree with its scalar forward on "
                             f"only {bf16:.4f}")
    return {"sites": sites, "max_abs_err": err, "argmax_agree": bf16}


def check_main_path(search, history, cfg, episodes: int) -> None:
    """Finite records of the expected count, then two agreements on a
    small batch under f32 compute: (1) the best policy's validation
    through the kernels equals, bit for bit, the same forward with the
    plain fake-quant in place of K1 on the same device; (2) the
    uncompressed forward on the device agrees with the plain CPU path
    (>= 99% of the next-token argmaxes; the matmuls sum in other
    orders)."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.policy import Policy
    from repro_torch.kernels import fake_quant as kfq
    from repro_torch.kernels.ref import fake_quant_ref, fake_quant_ste_ref
    if len(history) != episodes:
        raise AssertionError(f"{len(history)} records, wanted {episodes}")
    for r in history:
        vals = (r.reward, r.accuracy, r.latency_s, r.latency_ratio)
        if not all(math.isfinite(v) for v in vals) \
                or not 0.0 <= r.accuracy <= 1.0:
            raise AssertionError(f"bad record {r}")
    best = max(history, key=lambda r: r.reward)
    f32 = cfg.replace(compute_dtype="float32")
    cm = CompressibleLM(f32, search.cmodel.params)
    small = {"tokens": search.val_batch["tokens"][:8]}
    cspec = cm.build_cspec(best.policy)
    lp_kernel = cm.log_probs(small, cspec)
    launch = kfq.fake_quant_2d
    kfq.fake_quant_2d = lambda x, bits, ste=False: (
        fake_quant_ste_ref if ste else fake_quant_ref)(x, bits)
    try:
        lp_plain = cm.log_probs(small, cspec)
    finally:
        kfq.fake_quant_2d = launch
    if not torch.isfinite(lp_kernel).all() or tuple(lp_kernel.shape) != \
            tuple(small["tokens"].shape) + (cfg.vocab_size,):
        raise AssertionError(f"bad log-probs {tuple(lp_kernel.shape)}")
    diff = float((lp_kernel - lp_plain).abs().max())
    log(f"  best policy (episode {best.episode}), f32: max |log-prob through "
        f"K1 - through the plain fake-quant| = {diff:.3g}")
    if diff != 0.0:
        raise AssertionError("the kernel path and the plain path differ")

    ref = Policy.reference(cm.specs)
    cpu = CompressibleLM(f32, _to(search.cmodel.params, "cpu"))
    lp_dev = cm.log_probs(small, cm.build_cspec(ref)).cpu()
    lp_cpu = cpu.log_probs({"tokens": small["tokens"].cpu()},
                           cpu.build_cspec(ref))
    agree = float((lp_dev.argmax(-1) == lp_cpu.argmax(-1)).float().mean())
    log(f"  uncompressed, f32: argmax agreement device vs plain CPU path "
        f"{agree:.4f}, max |log-prob diff| "
        f"{float((lp_dev - lp_cpu).abs().max()):.3g}")
    if agree < 0.99:
        raise AssertionError(f"the device forward disagrees with the CPU "
                             f"path: {agree:.4f} of argmaxes agree")


def profile_episodes(search, first: int, n: int) -> dict:
    """Where an episode's time goes, from ``n`` more chunks of the engine
    (one episode each for the scalar engine, ``batch_size`` for the
    batched one; not in the launch counts): host-clock split of rollout
    (the actor: ``act`` / ``act_batch``) / validation (``accuracy`` /
    ``accuracy_policy_batch``) / update (each ended by a device sync) /
    other host (oracle, states, CMPs, ring writes), per episode; then one
    ``torch.profiler`` pass over ``n`` more chunks for the device's busy
    share and the kernels that take most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    split = {"rollout": 0.0, "validation": 0.0, "update": 0.0}
    agent, cm = search.agent, search.cmodel
    wrapped = [(agent, "update_chunk", "update"), (agent, "act", "rollout"),
               (agent, "act_batch", "rollout"),
               (cm, "accuracy", "validation"),
               (cm, "accuracy_policy_batch", "validation")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in wrapped]
    k = search._chunk_size()

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            return out
        return run

    for (obj, name, key), (_, _, fn) in zip(wrapped, saved):
        setattr(obj, name, timed(key, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(n):
            search._run_chunk(first + c * k, k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    eps = n * k
    split = {key: v / eps for key, v in split.items()}
    split["other host"] = wall / eps - sum(split.values())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in range(n, 2 * n):
            search._run_chunk(first + c * k, k)
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    rows = [(getattr(ev, "self_device_time_total", 0.0), ev.key)
            for ev in prof.key_averages()
            if getattr(ev, "device_type", None) is not None
            and "CUDA" in str(ev.device_type)]
    busy_s = sum(t for t, _ in rows) * 1e-6
    return {"episode_s": wall / eps, "episodes": eps, "split_s": split,
            "profiled_wall_s": wall_prof, "device_busy_s": busy_s / eps,
            "top": sorted(rows, reverse=True)[:8]}


def log_profile(prof: dict) -> None:
    """The ``[time]`` lines of ``profile_episodes``' result."""
    log(f"[time] {prof['episode_s'] * 1e3:.1f} ms per episode (host clock, "
        f"syncs at phase ends): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in prof["split_s"].items())
        + f"; {CARD}")
    if prof["device_busy_s"] > 0:
        busy, n = prof["device_busy_s"], prof["episodes"]
        log(f"  profiler: device busy {busy * 1e3:.1f} ms per episode, "
            f"{busy / prof['episode_s']:.1%} of the unprofiled episode "
            f"({1 - busy / prof['episode_s']:.1%} idle; the profiled "
            f"wall, {prof['profiled_wall_s'] * 1e3:.0f} ms for {n}, is "
            f"mostly tracing); top device time over {n} episodes (us):")
        for t, key in prof["top"]:
            log(f"    {t:10.1f}  {key[:90]}")
    else:
        log("  profiler: no device time recorded (device busy share not "
            "measured)")


# ---------------------------------------------------------------------------
# Phase 6: the ResNet path (ResNet18 at CIFAR-10 widths)
# ---------------------------------------------------------------------------

# Kernels whose names mark PyTorch's copies of a tensor, cuDNN's own
# layout transforms (NHWC <-> NCHW around an NCHW kernel), and the fill
# of F.pad's border.
COPY_KERNEL = re.compile(r"copy", re.IGNORECASE)
LAYOUT_KERNEL = re.compile(r"nchwToNhwc|nhwcToNchw|transpose",
                           re.IGNORECASE)
FILL_KERNEL = re.compile(r"fill", re.IGNORECASE)


def resnet_inputs(cfg, device, *, episodes: int, warmup: int, updates: int,
                  batch_size: int, val_batch: int, seed: int = 0):
    """The ResNet path's model (seeded random f32 weights), validation
    batch (seeded blob images, NHWC, as the JAX trainer draws its
    validation batch) and pq search config."""
    from repro_torch.core.compress import CompressibleResNet
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.reward import RewardConfig
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.pipeline import blob_images
    from repro_torch.models import resnet as R
    cm = CompressibleResNet(cfg, R.init(cfg, seed=seed, device=device))
    val = blob_images(cfg.num_classes, val_batch, cfg.img_size,
                      seed=seed + 7, device=device)
    scfg = SearchConfig(
        methods="pq", episodes=episodes, seed=seed,
        reward=RewardConfig(target_ratio=0.5, beta=-3.0),
        ddpg=DDPGConfig(warmup_episodes=warmup, updates_per_episode=updates,
                        batch_size=batch_size, buffer_size=2000))
    return cm, val, scfg


def resnet_conv_inputs(cfg) -> list:
    """(which, stride, input size, kernel size) of each conv in
    ``layer_specs`` order: a block's conv1 and skip read the block's
    input, its conv2 conv1's output."""
    from repro_torch.models import resnet as R
    out, block_in, hw = [], cfg.img_size, cfg.img_size
    for _, _, _, which, stride, _, _, _ in R._iter_convs(cfg):
        if which == "conv1":
            block_in, hw = hw, -(-hw // stride)
        out.append((which, stride, hw if which == "conv2" else block_in,
                    1 if which == "skip" else 3))
    return out


def resnet_k1_calls(cfg, cspec, images: int) -> list:
    """(shape, bits, kind) of each K1 launch of one ResNet forward over
    ``images`` images under ``cspec`` (scalar, or batched: bits as
    K-tuples), in launch order: per conv its weight [kh·kw·cin, cout]
    ("weight"), then its input [images·H·W, cin] ("act"; "shared" for
    the stem's, the images every slot shares), then the head's pooled
    input [images, C] and its weight. ``bits >= 32`` launches nothing; a
    batched entry launches once if any slot quantizes there; a device
    cspec's ([K] int32 bits) at every quantizable site, its bits given
    as a tuple."""
    from repro_torch.models import resnet as R
    if cspec is None:
        return []
    layers = cspec["layers"] if isinstance(cspec, dict) else cspec
    calls = []

    def add(shape, bits, kind):
        if hasattr(bits, "tolist"):
            calls.append((shape, tuple(int(b) for b in bits.tolist()),
                          kind))
        elif min(bits if isinstance(bits, tuple) else (bits,)) < 32:
            calls.append((shape, bits, kind))

    for (which, _, hw, k), (_, _, _, _, _, cin, cout, _), e in zip(
            resnet_conv_inputs(cfg), R._iter_convs(cfg), layers):
        qs = e["qs"]
        if qs is not None:
            add((k * k * cin, cout), qs["w_bits"], "weight")
            add((images * hw * hw, cin), qs["a_bits"],
                "shared" if which == "stem" else "act")
    qs = layers[-1]["qs"]
    if qs is not None:
        C = cfg.widths[-1]
        add((images, C), qs["a_bits"], "act")
        add((C, cfg.num_classes), qs["w_bits"], "weight")
    return calls


def resnet_slot_input(shape, kind: str, K: int, gen, device):
    """A [K, R, C] input of K1 over K slots as the ResNet path hands it:
    an activation as the [K, R, C] view of the slots' side-by-side
    channels ([R, K·C] rows: slot stride C, row stride K·C), the shared
    stem input and a weight as one [R, C] tensor at slot stride 0."""
    import torch
    R, C = shape
    if kind == "act":
        return torch.randn((R, K, C), generator=gen,
                           device=device).transpose(0, 1)
    return torch.randn(shape, generator=gen, device=device).expand(K, R, C)


def check_resnet_slot_calls(calls, K: int, device) -> dict:
    """K1 over K slots exact against ``fake_quant_slots_ref`` at every
    (shape, bits vector, kind) of ``calls``, in the path's layouts
    (``resnet_slot_input``), f32, plain and straight-through."""
    import torch
    from repro_torch.kernels.fake_quant import fake_quant_slots
    from repro_torch.kernels.ref import fake_quant_slots_ref
    gen = torch.Generator(device=device).manual_seed(5)
    sites = sorted(set(calls))
    err = 0.0
    for shape, bits, kind in sites:
        x = resnet_slot_input(shape, kind, K, gen, device)
        for ste in (False, True):
            got = fake_quant_slots(x, bits, ste=ste)
            want = fake_quant_slots_ref(x, bits, ste)
            if got.shape != want.shape:
                raise AssertionError(f"fake_quant_slots returned "
                                     f"{tuple(got.shape)}")
            err = max(err, float((got - want).abs().max()))
    if err > 0.0:
        raise AssertionError(f"K1 over policy slots disagrees with its "
                             f"plain version at the ResNet's sites: max abs "
                             f"err {err}")
    return {"pairs": len(sites), "max_abs_err": err}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to its deterministic algorithms, so that two forwards
    that differ only in a kernel's wrapper run the same convolutions."""
    import torch
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def check_resnet_main(search, history, cfg, episodes: int, device) -> dict:
    """The scalar ResNet phase's checks: finite records of the expected
    count; K1 exact at every (shape, bits) the episodes' policies gave it
    (f32, plain and straight-through, tolerance 0); on 8 images, the best
    policy's logits through K1 equal, bit for bit, the same forward with
    the plain fake-quant in place of K1 (cuDNN held to its deterministic
    algorithms for this check alone); and the uncompressed forward on
    the device agrees with the plain CPU path on 64 images (logits
    within 1e-4 of the largest, argmaxes all equal: cuDNN sums in other
    orders)."""
    import torch
    from repro_torch.core.compress import CompressibleResNet
    from repro_torch.core.policy import Policy
    from repro_torch.kernels import fake_quant as kfq
    from repro_torch.kernels.ref import fake_quant_ref, fake_quant_ste_ref
    if len(history) != episodes:
        raise AssertionError(f"{len(history)} records, wanted {episodes}")
    for r in history:
        vals = (r.reward, r.accuracy, r.latency_s, r.latency_ratio)
        if not all(math.isfinite(v) for v in vals) \
                or not 0.0 <= r.accuracy <= 1.0:
            raise AssertionError(f"bad record {r}")
    cm, val = search.cmodel, search.val_batch
    images = val["images"].shape[0]
    pairs = sorted({(shape, bits) for r in history for shape, bits, _ in
                    resnet_k1_calls(cfg, cm.build_cspec(r.policy), images)})
    gen = torch.Generator(device=device).manual_seed(6)
    err = max((fake_quant_errors(torch.randn(shape, generator=gen,
                                             device=device), bits)
               for shape, bits in pairs), default=0.0)
    log(f"  K1 at the {len(pairs)} (shape, bits) of the {episodes} "
        f"episodes' policies, f32, plain and straight-through: max |kernel "
        f"- plain| {err:.3g} (tol 0)")
    if not pairs or err > 0.0:
        raise AssertionError(f"K1 at the ResNet's sites: {len(pairs)} "
                             f"pairs, max abs err {err}")

    best = max(history, key=lambda r: r.reward)
    small = {"images": val["images"][:8], "labels": val["labels"][:8]}
    cspec = cm.build_cspec(best.policy)
    with deterministic_cudnn():
        lg_kernel = cm.logits(small, cspec)
        launch = kfq.fake_quant_2d
        kfq.fake_quant_2d = lambda x, bits, ste=False: (
            fake_quant_ste_ref if ste else fake_quant_ref)(x, bits)
        try:
            lg_plain = cm.logits(small, cspec)
        finally:
            kfq.fake_quant_2d = launch
    if not torch.isfinite(lg_kernel).all() or tuple(lg_kernel.shape) != (
            8, cfg.num_classes):
        raise AssertionError(f"bad logits {tuple(lg_kernel.shape)}")
    diff = float((lg_kernel - lg_plain).abs().max())
    log(f"  best policy (episode {best.episode}), 8 images: max |logit "
        f"through K1 - through the plain fake-quant| = {diff:.3g} (cuDNN "
        f"deterministic for this check)")
    if diff != 0.0:
        raise AssertionError("the ResNet's kernel path and plain path "
                             "differ")

    ref = Policy.reference(cm.specs)
    cpu = CompressibleResNet(cfg, _to(cm.params, "cpu"))
    few = {"images": val["images"][:64], "labels": val["labels"][:64]}
    lg_dev = cm.logits(few, cm.build_cspec(ref)).cpu()
    lg_cpu = cpu.logits(_to(few, "cpu"), cpu.build_cspec(ref))
    rel = float((lg_dev - lg_cpu).abs().max() / lg_cpu.abs().max())
    agree = float((lg_dev.argmax(-1) == lg_cpu.argmax(-1)).float().mean())
    log(f"  uncompressed, 64 images: device vs plain CPU path max |logit "
        f"diff| / max |logit| {rel:.3g}, argmax agreement {agree:.4f}")
    if rel > 1e-4 or agree < 1.0:
        raise AssertionError(f"the ResNet's device forward disagrees with "
                             f"the CPU path: {rel:.3g}, {agree:.4f}")
    return {"pairs": len(pairs), "max_abs_err": err}


def check_resnet_batched(search, history, cfg, episodes: int,
                         launches: dict, per_step: dict, device) -> dict:
    """The batched ResNet phase's checks. Records as
    ``check_batch_records``. Launches over the episodes: K1 over slots
    exactly once per fake-quant site of each batched validation
    (``resnet_k1_calls`` of its batched cspec), the one-tensor K1 never,
    K2 and K3 per DDPG step as the scalar phase launched them. K1 over
    slots exact at every (shape, bits vector) the batches gave it. Then
    for the last batch's policies: on 8 images the forward through K1
    over slots equals, bit for bit, the same forward with its plain
    version in place (cuDNN deterministic); on the whole validation
    batch each slot's accuracy is within 3% of its scalar engine's
    ``accuracy(build_cspec(policy))`` (the grouped conv, the spatial
    mean and GroupNorm over the slots' side-by-side channels sum in other
    orders than the scalar forward's, and a last-bit difference moves
    whole fake-quant steps; the logits' difference and the argmax
    agreement are printed, not held)."""
    import torch
    from repro_torch.core.policy import stack_policies
    from repro_torch.kernels import fake_quant as kfq
    from repro_torch.kernels.ref import fake_quant_slots_ref
    check_batch_records(search, history, episodes)
    cm, val = search.cmodel, search.val_batch
    images = val["images"].shape[0]
    cspecs = batch_cspecs(search, history)
    calls = [resnet_k1_calls(cfg, cs, images) for cs in cspecs]
    sites = sum(len(c) for c in calls)
    cfg_ddpg = search.agent.cfg
    steps = cfg_ddpg.updates_per_episode * sum(
        r.episode >= cfg_ddpg.warmup_episodes for r in history)
    want = {"fake_quant_slots": sites, "fake_quant": 0,
            **{k: round(v * steps) for k, v in per_step.items()}}
    log(f"  launches {launches}; wanted {want} ({len(cspecs)} batched "
        f"validations, {sites} fake-quant sites in all)")
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"{k} launched {launches[k]} times on the "
                                 f"ResNet's batched path, wanted {v}")
    err = 0.0
    for cs, c in zip(cspecs, calls):
        err = max(err, check_resnet_slot_calls(c, cs["slots"], device)[
            "max_abs_err"])
    log(f"  K1 over slots at every (shape, bits vector) of the "
        f"{len(cspecs)} batches, in the path's layouts, f32, plain and "
        f"straight-through: max |kernel - plain| {err:.3g} (tol 0)")

    pols = [r.policy for r in history[-search.batch_size:]]
    pb = stack_policies(cm.specs, pols)
    bcs = cm.cspec_builder()(pb.keep, pb.w_bits, pb.a_bits)
    small = {"images": val["images"][:8], "labels": val["labels"][:8]}
    with deterministic_cudnn():
        lg_kernel = cm.logits(small, bcs)
        launch = kfq.fake_quant_slots
        kfq.fake_quant_slots = lambda x, bits, ste=False: \
            fake_quant_slots_ref(x, bits, ste)
        try:
            lg_plain = cm.logits(small, bcs)
        finally:
            kfq.fake_quant_slots = launch
    if not torch.isfinite(lg_kernel).all() or tuple(lg_kernel.shape) != (
            len(pols), 8, cfg.num_classes):
        raise AssertionError(f"bad batched logits {tuple(lg_kernel.shape)}")
    diff = float((lg_kernel - lg_plain).abs().max())
    log(f"  last batch's {len(pols)} policies, 8 images: max |logit through "
        f"K1 over slots - through its plain version| = {diff:.3g}")
    if diff != 0.0:
        raise AssertionError("the ResNet's batched kernel path and its "
                             "plain version differ")
    accs_b = cm.accuracy_batch(val, bcs).cpu().tolist()
    lg_b = cm.logits(val, bcs)
    worst = 0.0
    for k, p in enumerate(pols):
        lg_s = cm.logits(val, cm.build_cspec(p))
        acc_s = float(cm.accuracy(val, cm.build_cspec(p)))
        agree = float((lg_s.argmax(-1) == lg_b[k].argmax(-1)).float().mean())
        worst = max(worst, abs(accs_b[k] - acc_s))
        log(f"    slot {k}: accuracy batched {accs_b[k]:.4f}, scalar "
            f"{acc_s:.4f}, max |logit diff| "
            f"{float((lg_s - lg_b[k]).abs().max()):.3g}, argmax agreement "
            f"{agree:.4f}")
    if worst > 0.03:
        raise AssertionError(f"a batched ResNet policy's accuracy is "
                             f"{worst:.4f} from its scalar accuracy")
    return {"sites": sites, "max_abs_err": err, "worst_acc_diff": worst}


def resnet_padded_convs(cfg) -> int:
    """How many of the model's convs pad their input explicitly: those
    whose SAME padding XLA makes asymmetric (stride 2, 3x3, even size)."""
    from repro_torch.models import resnet as R
    return sum(len(set(R.same_pads(hw, k, stride))) > 1
               for _, stride, hw, k in resnet_conv_inputs(cfg))


def all_bits_cspec(cm, bits: int = 4) -> list:
    """A cspec quantizing every site (weights and inputs at ``bits``; the
    stem and the head, which take no MIX, at 8) and pruning nothing: the
    one that reaches every K1 site of the model once."""
    from repro_torch.core.policy import Policy
    pol = Policy.reference(cm.specs)
    for s, c in zip(cm.specs, pol.cmps):
        c.mode, c.w_bits, c.a_bits = ("MIX", bits, bits) \
            if s.mix_supported else ("INT8", 8, 8)
    return cm.build_cspec(pol)


def time_resnet_sites(cm, images: int, device) -> list:
    """K1 (one tensor, f32, straight-through: the call the search makes)
    at every distinct site shape of one forward over ``images`` images,
    beside its plain version and bytes bound; and K1 over 8 slots at
    the widest activation and the stem's shared input, in the batched
    path's layouts."""
    import torch
    gen = torch.Generator(device=device).manual_seed(8)
    calls = resnet_k1_calls(cm.cfg, all_bits_cspec(cm), images)
    rows = []
    for shape, bits, kind in dict.fromkeys(calls):
        x = torch.randn(shape, generator=gen, device=device)
        r = time_fake_quant(x, bits, True, 20)
        r.update(kind=kind, launches=sum(c[0] == shape for c in calls))
        rows.append(r)
    widest = max((c for c in calls if c[2] == "act"),
                 key=lambda c: c[0][0] * c[0][1])
    stem = next(c for c in calls if c[2] == "shared")
    for (shape, _, kind), bits in ((widest, (2, 3, 4, 5, 6, 8, 4, 6)),
                                   (stem, (8,) * SLOTS)):
        r = time_fake_quant_slots(resnet_slot_input(shape, kind, SLOTS, gen,
                                                    device), bits, 10)
        r.update(kind=f"slots {kind}")
        rows.append(r)
    return rows


def profile_resnet_forward(cm, batch: dict, cspec) -> dict:
    """One profiled forward. ``copies``: PyTorch's tensor copies by shape,
    read from the host-side ops, which name the tensors (``aten::copy_``
    of a non-scalar: a conv weight turned OIHW is a 5-D [1, cout, kh, kw,
    cin] copy, a padded input a 4-D one). On the card also ``classes``:
    device µs and launches by kernel class (cuDNN convs, K1, PyTorch's
    copies, cuDNN's layout transforms, fills, the rest), and the names of
    the copy and transform kernels."""
    from torch.profiler import ProfilerActivity, profile
    on_card = cm.device.type == "cuda"
    cm.logits(batch, cspec)
    _sync(cm.device)
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []),
            record_shapes=True) as prof:
        cm.logits(batch, cspec)
        _sync(cm.device)
    copies = {}
    for ev in prof.events():
        if ev.name == "aten::copy_" and ev.input_shapes \
                and ev.input_shapes[0]:
            shape = tuple(ev.input_shapes[0])
            copies[shape] = copies.get(shape, 0) + 1
    classes, kernels = {}, {}
    for ev in prof.key_averages() if on_card else ():
        if "CUDA" not in str(getattr(ev, "device_type", None)):
            continue
        name = ev.key
        if re.search(r"\bfq_", name):
            c = "K1"
        elif COPY_KERNEL.search(name) or LAYOUT_KERNEL.search(name):
            c = "layout" if LAYOUT_KERNEL.search(name) else "copy"
            kernels[name[:100]] = kernels.get(name[:100], 0) + ev.count
        elif FILL_KERNEL.search(name):
            c = "fill"
        elif re.search(r"conv|cudnn|xmma|implicit|gemm|sm90|winograd",
                       name, re.IGNORECASE):
            c = "conv"
        else:
            c = "rest"
        us, n = classes.get(c, (0.0, 0))
        classes[c] = (us + getattr(ev, "self_device_time_total", 0.0),
                      n + ev.count)
    return {"copies": copies, "classes": classes, "kernels": kernels}


def check_resnet_copies(cm, batch: dict, cspec, name: str) -> dict:
    """A profiled forward's tensor copies: exactly one per conv weight (the
    5-D copy that turns it OIHW) and one per input padded for XLA's
    asymmetric SAME, and no other (K1 reads NHWC activations and HWIO
    weights in place). cuDNN's own layout transforms are printed, not
    held."""
    p = profile_resnet_forward(cm, batch, cspec)
    n_convs = len(cm.specs) - 1
    n_pads = resnet_padded_convs(cm.cfg)
    by_rank = {r: sum(n for s, n in p["copies"].items() if len(s) == r)
               for r in {len(s) for s in p["copies"]}}
    log(f"    {name}: tensor copies by rank {by_rank} ({n_convs} conv "
        f"weights turned OIHW, 5-D; {n_pads} inputs padded for XLA's "
        f"asymmetric SAME, stride 2, 3x3, even size, 4-D)")
    if p["classes"]:
        log("    profiled device time: " + ", ".join(
            f"{c} {us / 1e3:.3f} ms in {n} launches"
            for c, (us, n) in sorted(p["classes"].items())))
        log(f"    copy and layout kernels: {p['kernels']}")
    if by_rank != {5: n_convs, 4: n_pads}:
        raise AssertionError(f"{name} forward: tensor copies {p['copies']}, "
                             f"wanted {n_convs} 5-D and {n_pads} 4-D")
    return p


def resnet_phase(device, batch_size: int) -> dict:
    """Phase 6, ``[resnet path]``: the scalar and the batched pq search on
    ResNet18 at CIFAR-10 widths (seeded weights, 256 seeded blob images,
    the per-image context), their checks, the forwards' and K1's times,
    a profiled forward's copies, and the deployed raw forward at batch
    1. Returns the launch counts of the scalar and the batched search."""
    import dataclasses

    from repro_torch.configs.testbed import (IMG_CTX, IMG_VAL_BATCH,
                                             RESNET18_CIFAR as cfg)
    from repro_torch.core.measure import measure_model_row
    from repro_torch.kernels import build
    from repro_torch.models import resnet as R
    episodes, warmup, updates, b_eps = 12, 4, 16, 16
    cm_specs = R.layer_specs(cfg)
    n_convs = len(cm_specs) - 1
    log(f"[resnet path] pq CompressionSearch on {cfg.name} (stages "
        f"{cfg.stages}, widths {cfg.widths}, {cfg.img_size}x{cfg.img_size} "
        f"x {cfg.in_channels}, {cfg.num_classes} classes: {n_convs} convs "
        f"and a head, {sum(s.weight_elems for s in cm_specs) / 1e6:.2f} M "
        f"weights, f32, seeded), {IMG_VAL_BATCH} blob images, per-image "
        f"oracle context; {episodes} episodes, warmup {warmup}, {updates} "
        f"updates/episode, DDPG batch {batch_size}; {CARD}")
    t_phase = time.perf_counter()
    cm, val, scfg = resnet_inputs(
        cfg, device, episodes=episodes, warmup=warmup, updates=updates,
        batch_size=batch_size, val_batch=IMG_VAL_BATCH)
    build.reset_launches()
    search, history, t_sens, t_eps = run_search(
        cm, val, scfg, IMG_CTX, device, episodes=episodes,
        reset_after_sensitivity=True)
    launches = dict(build.LAUNCHES)
    log(f"  sensitivity {t_sens:.3f} s; {episodes} episodes in {t_eps:.3f} "
        f"s = {episodes / t_eps:.3f} episodes/s; launches {launches}")
    steps = (episodes - warmup) * updates
    sites = sum(len(resnet_k1_calls(cfg, cm.build_cspec(r.policy),
                                    IMG_VAL_BATCH)) for r in history)
    want = {"fake_quant": sites, "polyak": steps, "fake_quant_slots": 0}
    log(f"  wanted {want}, K2 > 0 ({episodes} validations, {sites} "
        f"fake-quant sites)")
    if launches["mlp3"] == 0 or any(launches[k] != v
                                    for k, v in want.items()):
        raise AssertionError(f"the ResNet's scalar path launched "
                             f"{launches}, wanted {want} and K2 > 0")
    check_resnet_main(search, history, cfg, episodes, device)
    prof = profile_episodes(search, episodes, 2)
    log_profile(prof)
    per_step = {k: launches[k] / steps for k in ("mlp3", "polyak")}

    log(f"  [batched] pq BatchedCompressionSearch, K {SLOTS} episodes per "
        f"batch, {b_eps} episodes, the scalar phase's seeds and "
        f"sensitivity table")
    bsearch, bhist, t_b = run_batched_search(
        cm, val, dataclasses.replace(scfg, episodes=b_eps), IMG_CTX,
        search.sens, device, slots=SLOTS)
    b_launches = dict(build.LAUNCHES)
    log(f"  {b_eps} episodes in {t_b:.3f} s = {b_eps / t_b:.3f} episodes/s "
        f"(scalar: {episodes / t_eps:.3f}, {episodes} episodes with "
        f"{warmup} warmup); {CARD}")
    check_resnet_batched(bsearch, bhist, cfg, b_eps, b_launches, per_step,
                         device)
    b_prof = profile_episodes(bsearch, b_eps, 1)
    log_profile(b_prof)
    log(f"  steady state (every episode live): batched "
        f"{1 / b_prof['episode_s']:.3f} episodes/s, scalar "
        f"{1 / prof['episode_s']:.3f}: "
        f"{prof['episode_s'] / b_prof['episode_s']:.3f}x; {CARD}")
    del bsearch

    policy_cs = cm.build_cspec(seeded_policy(cm, 0))
    for name, cs in (("raw", None), ("seeded pq policy", policy_cs)):
        build.reset_launches()
        cm.logits(val, cs)
        n_k1 = build.LAUNCHES["fake_quant"]
        if n_k1 != len(resnet_k1_calls(cfg, cs, IMG_VAL_BATCH)):
            raise AssertionError(f"{name} forward: {n_k1} K1 launches")
        ms, paced = cuda_ms(lambda: cm.logits(val, cs), 5, 2)
        log(f"  validation forward, {name}, {IMG_VAL_BATCH} images: "
            f"{paced:.3f} ms (paced by the host), {ms:.3f} ms device; "
            f"{n_k1} K1 launches per forward; {CARD}")
        check_resnet_copies(cm, val, cs, name)

    log("  K1 at each of the ResNet's site shapes (f32, straight-through, "
        f"{IMG_VAL_BATCH} images):")
    time_resnet_sites(cm, IMG_VAL_BATCH, device)

    one = {"images": val["images"][:1], "labels": val["labels"][:1]}
    row = measure_model_row(cm, one, "raw")
    log(f"  deployed raw forward at batch 1 (measure_model_row): "
        f"{row['measured_s'] * 1e3:.4f} ms (host clock, best of 5); {CARD}")
    log(f"  {time.perf_counter() - t_phase:.1f} s for the ResNet phase")
    sens = search.sens
    del search, cm
    release_cached_memory(device)
    return {"launches": launches, "slot_launches": b_launches,
            "sens": sens, "profile": prof, "batched_profile": b_prof}


# ---------------------------------------------------------------------------
# Phase 7: the fused path (the fused and epoch engines as CUDA graphs)
# ---------------------------------------------------------------------------

FUSED_E = 2                 # batches per epoch on the fused path


@contextlib.contextmanager
def eager_graphs():
    """The fused engine's graphs run their pure functions eagerly on the
    card instead of capturing and replaying them: the reference that a
    graph's replay is held to."""
    from repro_torch.core import graphs
    call = graphs.Graph.__call__
    graphs.Graph.__call__ = lambda self: self.fn()
    try:
        yield
    finally:
        graphs.Graph.__call__ = call


def run_fused_search(cm, val, scfg, ctx, sens, device, *, slots: int,
                     epoch_batches: int = 0, eager: bool = False):
    """``FusedCompressionSearch`` (``slots`` episodes a batch; epoch mode
    with ``epoch_batches``) over ``scfg.episodes`` on ``cm`` with the
    sensitivity table ``sens``; launch and graph counts reset just before
    the episodes. ``eager``: the graphs' functions run eagerly (the
    reference). Returns (search, history, seconds, launches, counts)."""
    from repro_torch.core import graphs
    from repro_torch.core.search import FusedCompressionSearch
    from repro_torch.kernels import build
    search = FusedCompressionSearch(cm, val, scfg, ctx, sens=sens,
                                    batch_size=slots,
                                    epoch_batches=epoch_batches)
    _sync(device)
    build.reset_launches()
    graphs.reset_counts()
    t0 = time.perf_counter()
    with eager_graphs() if eager else contextlib.nullcontext():
        history = search.run().history
    _sync(device)
    return (search, history, time.perf_counter() - t0, dict(build.LAUNCHES),
            {k: dict(v) for k, v in graphs.COUNTS.items()})


def _cmps(policy) -> list:
    return [(c.keep, c.w_bits, c.a_bits) for c in policy.cmps]


def check_fused_equal(got, want, search_got, search_want, what: str) -> None:
    """Two fused runs on the same seeds bit for bit: every record (reward,
    accuracy, latency, policy), every agent tensor and the ring."""
    import torch
    from repro_torch.core.ddpg import state_leaves
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} records, {len(want)}")
    for a, b in zip(got, want):
        if (a.reward, a.accuracy, a.latency_s, _cmps(a.policy)) != (
                b.reward, b.accuracy, b.latency_s, _cmps(b.policy)):
            raise AssertionError(f"{what}: episode {a.episode} differs: "
                                 f"{a.reward} vs {b.reward}, {a.accuracy} "
                                 f"vs {b.accuracy}")
    tensors = list(zip(state_leaves(search_got.agent.state)
                       + list(search_got.replay.data),
                       state_leaves(search_want.agent.state)
                       + list(search_want.replay.data)))
    worst = max(float((x.double() - y.double()).abs().max())
                for x, y in tensors)
    log(f"  {what}: {len(got)} records equal; max |difference| over the "
        f"{len(tensors)} agent and ring tensors {worst:.3g} (tol 0)")
    if worst != 0.0 or not all(torch.equal(x, y) for x, y in tensors):
        raise AssertionError(f"{what}: agent or ring tensors differ")


def check_fused_launches(launches: dict, want: dict, what: str) -> None:
    log(f"  {what}: launches {launches}; wanted {want}")
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"{what}: {k} launched {launches[k]} "
                                 f"times, wanted {v}")


def fused_steady(search, first: int, chunks: int, sites) -> dict:
    """``chunks`` more chunks after a run (every episode live, every graph
    captured): zero captures; per batch one rollout and one update replay,
    or per epoch one epoch replay and one readback; launches K2 once per
    rollout step and 5 times per DDPG step, K3 once per DDPG step, K1
    over slots (host bits) or its device-bits entry once per validation
    site (``sites(history)`` of the chunks' records)."""
    from repro_torch.core import graphs
    from repro_torch.kernels import build
    K, T = search.batch_size, len(search.steps)
    k = search._chunk_size()
    _sync(search.device)
    build.reset_launches()
    graphs.reset_counts()
    reads = search.readbacks
    hist = []
    for c in range(chunks):
        hist += search._run_chunk(first + c * k, k)
    _sync(search.device)
    counts = {key: dict(v) for key, v in graphs.COUNTS.items()}
    batches = chunks * k // K
    steps = batches * K * search.agent.cfg.updates_per_episode
    epoch = search.epoch_batches > 0
    want_counts = ({"epoch": {"captures": 0, "replays": chunks}} if epoch
                   else {"rollout": {"captures": 0, "replays": batches},
                         "update": {"captures": 0, "replays": batches}})
    log(f"  steady state, {chunks} more chunk(s) of {k}: graphs {counts}, "
        f"{search.readbacks - reads} readback(s)")
    if search.device.type != "cuda":
        want_counts = {}            # the CPU runs the functions: no graphs
    if counts != want_counts or search.readbacks - reads != (
            chunks if epoch else 0):
        raise AssertionError(f"steady state: graphs {counts}, wanted "
                             f"{want_counts}")
    n_sites = sites(hist)
    check_fused_launches(dict(build.LAUNCHES), {
        "mlp3": batches * T + 5 * steps, "polyak": steps,
        "fake_quant_slots_dev" if epoch else "fake_quant_slots": n_sites,
        "fake_quant_slots" if epoch else "fake_quant_slots_dev": 0,
        "fake_quant": 0}, "steady state")
    return {"records": hist}


def profile_fused(search, first: int, chunks: int) -> dict:
    """Where a fused episode's time goes, from ``chunks`` more chunks (not
    in the launch counts): host-clock split of the graph replays by label
    (rollout, update, or the whole epoch) and the validation (each ended
    by a device sync) and the rest (other host: records, reads, ring
    writes); then, on the card, one ``torch.profiler`` pass over as many
    chunks for the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import graphs
    device = search.device
    split = {"rollout": 0.0, "validation": 0.0, "update": 0.0, "epoch": 0.0}
    call, acc = graphs.Graph.__call__, search.cmodel.accuracy_policy_batch

    def timed(key, fn):
        def run(*a, **kw):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(device)
            split[key or a[0].label] += time.perf_counter() - t0
            return out
        return run

    graphs.Graph.__call__ = timed(None, call)
    search.cmodel.accuracy_policy_batch = timed("validation", acc)
    k = search._chunk_size()
    try:
        _sync(device)
        t0 = time.perf_counter()
        for c in range(chunks):
            search._run_chunk(first + c * k, k)
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        graphs.Graph.__call__ = call
        del search.cmodel.accuracy_policy_batch
    eps = chunks * k
    split = {key: v / eps for key, v in split.items() if v > 0}
    split["other host"] = wall / eps - sum(split.values())
    out = {"episode_s": wall / eps, "episodes": eps, "split_s": split,
           "profiled_wall_s": 0.0, "device_busy_s": 0.0, "top": []}
    if device.type != "cuda":
        return out
    _sync(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in range(chunks, 2 * chunks):
            search._run_chunk(first + c * k, k)
        _sync(device)
    rows = [(getattr(ev, "self_device_time_total", 0.0), ev.key)
            for ev in prof.key_averages()
            if getattr(ev, "device_type", None) is not None
            and "CUDA" in str(ev.device_type)]
    out.update(profiled_wall_s=time.perf_counter() - t0,
               device_busy_s=sum(t for t, _ in rows) * 1e-6 / eps,
               top=sorted(rows, reverse=True)[:8])
    return out


def check_fake_quant_dev_calls(calls, make_input, dtypes, device) -> dict:
    """K1's device-bits entry at every (shape, bits vector, ...) of
    ``calls`` (all-32 sites included: the entry copies them), inputs from
    ``make_input(call, dtype)`` in the path's layout, plain and
    straight-through: exact against ``fake_quant_slots_ref`` and equal to
    the host-bits slot form."""
    import torch
    from repro_torch.kernels.fake_quant import (fake_quant_slots,
                                                fake_quant_slots_dev)
    from repro_torch.kernels.ref import fake_quant_slots_ref
    sites = sorted(set(calls))
    err = 0.0
    for call in sites:
        bits = call[1]
        dev = torch.tensor(bits, dtype=torch.int32, device=device)
        for dtype in dtypes(call):
            x = make_input(call, dtype)
            for ste in (False, True):
                got = fake_quant_slots_dev(x, dev, ste=ste)
                want = fake_quant_slots_ref(x, bits, ste)
                if got.dtype != x.dtype or got.shape != want.shape:
                    raise AssertionError(f"fake_quant_slots_dev returned "
                                         f"{got.dtype} {tuple(got.shape)}")
                err = max(err, float((got.float() - want.float()).abs()
                                     .max()))
                if not torch.equal(got, fake_quant_slots(x, bits, ste=ste)):
                    raise AssertionError(f"K1's device-bits entry differs "
                                         f"from its host-bits form at "
                                         f"{call}")
    if err > 0.0:
        raise AssertionError(f"K1's device-bits entry disagrees with its "
                             f"plain version: max abs err {err}")
    return {"pairs": len(sites), "max_abs_err": err}


def time_fake_quant_slots_dev(x, bits, iters: int = 50) -> dict:
    """K1's device-bits entry, straight-through, on x [K, R, C] (device
    and host-paced ms) beside the host-bits slot form at the same bits,
    the plain version and the bound (``time_fake_quant_slots``')."""
    import torch
    from repro_torch.kernels.fake_quant import (fake_quant_slots,
                                                fake_quant_slots_dev)
    from repro_torch.kernels.ref import fake_quant_slots_ref
    dev = torch.tensor(bits, dtype=torch.int32, device=x.device)
    ms, paced = cuda_ms(lambda: fake_quant_slots_dev(x, dev, ste=True),
                        iters, 3)
    host, _ = cuda_ms(lambda: fake_quant_slots(x, bits, ste=True), iters, 3)
    plain, _ = cuda_ms(lambda: fake_quant_slots_ref(x, bits, True), 5, 1)
    n = x.numel()
    bound, by = bound_ms(2.0 * x.element_size() * n, 12.0 * n)
    log(f"    {list(x.shape)} {str(x.dtype)[6:]} bits {list(bits)} "
        f"straight-through, device bits: {ms * 1e3:.2f} us kernel "
        f"({paced * 1e3:.2f} paced), host-bits slot form "
        f"{host * 1e3:.2f} us, {plain * 1e3:.2f} us plain, bound "
        f"{bound * 1e3:.3f} us ({by}); {CARD}")
    return dict(shape=list(x.shape), ms=ms, paced_ms=paced, plain_ms=plain,
                host_bits_ms=host, bound_ms=bound, bound_by=by,
                library_ms=None, tolerance=0.0)


def device_cspecs(search, history) -> list:
    """The device cspec (``cspec_builder`` on device int tensors) of each
    batch of ``history``'s policies, as the epoch graph built them."""
    import torch
    from repro_torch.core.policy import stack_policies
    k, out = search.batch_size, []
    for i in range(0, len(history), k):
        pb = stack_policies(search.specs,
                            [r.policy for r in history[i:i + k]])
        out.append(search.cmodel.cspec_builder()(*(
            torch.as_tensor(x, dtype=torch.int32, device=search.device)
            for x in (pb.keep, pb.w_bits, pb.a_bits))))
    return out


def fused_runs(name, make, device, episodes: int, sites_host, sites_dev,
               check_sites) -> dict:
    """The fused path on one model: per batch over ``episodes``, then
    epoch mode (E ``FUSED_E``) over twice as many on the same seeds; each
    held to its eager reference on the card bit for bit, epoch mode to
    the per-batch records, then timed in steady state (``[time]``) with
    the graph and launch counts checked. ``make(episodes)`` gives (cm,
    val, scfg, ctx, sens)."""
    from repro_torch.kernels import build
    out = {}
    runs = {}
    for mode, E, eps in (("fused", 0, episodes),
                         ("epoch", FUSED_E, 2 * episodes)):
        t0 = time.perf_counter()
        cm, val, scfg, ctx, sens = make(eps)
        search, hist, secs, launches, counts = run_fused_search(
            cm, val, scfg, ctx, sens, device, slots=SLOTS,
            epoch_batches=E)
        check_batch_records(search, hist, eps)
        log(f"  {name} {mode}: {eps} episodes in {secs:.3f} s = "
            f"{eps / secs:.3f} episodes/s (captures included); graphs "
            f"{counts}; readbacks {search.readbacks}; launches {launches};"
            f" {CARD}")
        ref, ref_hist, ref_secs, _, _ = run_fused_search(
            cm, val, scfg, ctx, sens, device, slots=SLOTS, epoch_batches=E,
            eager=True)
        check_fused_equal(hist, ref_hist, search, ref,
                          f"{mode} graphs vs the same functions eager "
                          f"({ref_secs:.3f} s)")
        del ref
        runs[mode] = (search, hist)
        out[mode] = {"launches": launches, "seconds": secs}
        log(f"  {time.perf_counter() - t0:.1f} s for the {name} {mode} runs")
    (fused, f_hist), (epoch, e_hist) = runs["fused"], runs["epoch"]
    worst = max(abs(a.reward - b.reward) for a, b in zip(f_hist, e_hist))
    same = sum(_cmps(a.policy) == _cmps(b.policy)
               for a, b in zip(f_hist, e_hist))
    log(f"  epoch vs per batch, episodes 0-{episodes - 1} on the same "
        f"draws: {same}/{episodes} policies equal, max |reward diff| "
        f"{worst:.3g} (tol 0)")
    if same != episodes or worst != 0.0:
        raise AssertionError("epoch mode differs from the per-batch fused "
                             "engine on the same draws")
    err = check_sites(sum((sites_dev(cs) for cs in device_cspecs(
        epoch, e_hist)), []))
    log(f"  K1 device bits at the {err['pairs']} (shape, bits vector) sites"
        f" of the epoch run's validations: max |kernel - plain| "
        f"{err['max_abs_err']:.3g} (tol 0), equal to the host-bits form")
    out["dev_check"] = err
    for mode, (search, hist) in runs.items():
        first = len(hist)
        sites = sites_dev if mode == "epoch" else sites_host
        fused_steady(search, first, 1, lambda h, s=search, f=sites: sum(
            len(f(cs)) for cs in (device_cspecs(s, h) if s.epoch_batches
                                  else batch_cspecs(s, h))))
        first += search._chunk_size()
        prof = profile_fused(search, first, 1)
        log(f"  {name} {mode}, steady state:")
        log_profile(prof)
        out[mode]["profile"] = prof
    build.reset_launches()
    return out


def log_engines(name: str, profiles: dict) -> None:
    """The engines' steady-state profiles side by side: episodes/s, the
    ``[time]`` split (ms per episode) and the device's busy share."""
    keys = ("rollout", "validation", "update", "epoch", "other host")
    log(f"  [time] {name}, steady state, ms per episode ({CARD}):")
    log("    engine    episodes/s  " + "  ".join(f"{k:>10}" for k in keys)
        + "  device busy")
    for engine, p in profiles.items():
        busy = p["device_busy_s"]
        log(f"    {engine:8s}  {1 / p['episode_s']:10.3f}  " + "  ".join(
            f"{p['split_s'].get(k, 0.0) * 1e3:10.2f}" for k in keys)
            + (f"  {busy * 1e3:.2f} ({busy / p['episode_s']:.1%})" if busy
               else "  not measured"))


def fused_phase(device, lm_sens, resnet_sens, batch_size: int,
                baselines: dict) -> dict:
    """Phase 7, ``[fused path]``: ``FusedCompressionSearch`` per batch
    and in epoch mode on the LM testbed (K 8, the batched path's seeds
    and KL table) and on ResNet18 at CIFAR-10 widths (256 images, the
    ResNet path's), each held to the eager run of its graphs and epoch
    mode to per batch; K1's device-bits entry at every site; episodes/s
    and the ``[time]`` split beside the scalar and batched engines'
    (``baselines``). Returns the LM's and ResNet's results and K1's
    device-bits row."""
    import dataclasses

    import torch
    from repro_torch.configs.testbed import (IMG_CTX, IMG_VAL_BATCH,
                                             LM_CFG, RESNET18_CIFAR,
                                             SERVE_CTX, VAL_BATCH, VAL_SEQ)
    t_phase = time.perf_counter()
    episodes, warmup, updates = 16, 4, 16
    rows = VAL_BATCH * VAL_SEQ
    log(f"[fused path] FusedCompressionSearch on {LM_CFG.name}, K {SLOTS} "
        f"episodes per batch: per batch {episodes} episodes, then epoch "
        f"mode (E {FUSED_E}) {2 * episodes} episodes, warmup {warmup}, "
        f"{updates} updates per live episode, DDPG batch {batch_size}; the "
        f"batched path's seeds and sensitivity table; {CARD}")

    def make_lm(eps):
        cm, val, scfg = search_inputs(
            LM_CFG, device, episodes=eps, warmup=warmup, updates=updates,
            batch_size=batch_size, val_batch=VAL_BATCH, val_seq=VAL_SEQ)
        return cm, val, scfg, SERVE_CTX, lm_sens

    gen = torch.Generator(device=device).manual_seed(6)

    def lm_input(call, dtype):
        (R, C), bits = call
        if R == rows:
            return torch.randn((SLOTS, R, C), generator=gen,
                               device=device).to(dtype)
        return torch.randn((R, C), generator=gen, device=device).to(
            dtype).expand(SLOTS, R, C)

    lm = fused_runs(
        LM_CFG.name, make_lm, device, episodes,
        lambda cs: k1_calls(LM_CFG, cs, rows),
        lambda cs: k1_calls(LM_CFG, cs, rows),
        lambda calls: check_fake_quant_dev_calls(
            calls, lm_input, lambda c: {torch.float32, k1_call_dtype(
                LM_CFG, c[0], rows)}, device))
    log_engines(LM_CFG.name, {
        "scalar": baselines["scalar"], "batched": baselines["batched"],
        "fused": lm["fused"]["profile"], "epoch": lm["epoch"]["profile"]})

    log("  K1's device-bits entry, timed (the LM's activation, 8 slots):")
    dev_row = time_fake_quant_slots_dev(
        torch.randn((SLOTS, rows, LM_CFG.d_model), generator=gen,
                    device=device).to(getattr(torch, LM_CFG.compute_dtype)),
        (2, 3, 4, 5, 6, 8, 4, 6))
    dev_row["max_abs_err"] = lm["dev_check"]["max_abs_err"]
    release_cached_memory(device)

    cfg = RESNET18_CIFAR
    log(f"  [fused path] {cfg.name}, {IMG_VAL_BATCH} blob images, K {SLOTS}"
        f": per batch {episodes} episodes, epoch mode (E {FUSED_E}) "
        f"{2 * episodes}; the ResNet path's seeds and sensitivity table")

    def make_resnet(eps):
        cm, val, scfg = resnet_inputs(
            cfg, device, episodes=eps, warmup=warmup, updates=updates,
            batch_size=batch_size, val_batch=IMG_VAL_BATCH)
        return cm, val, dataclasses.replace(scfg, episodes=eps), IMG_CTX, \
            resnet_sens

    def resnet_input(call, dtype):
        (shape, bits, kind) = call
        return resnet_slot_input(shape, kind, SLOTS, gen, device).to(dtype)

    resnet = fused_runs(
        cfg.name, make_resnet, device, episodes,
        lambda cs: resnet_k1_calls(cfg, cs, IMG_VAL_BATCH),
        lambda cs: resnet_k1_calls(cfg, cs, IMG_VAL_BATCH),
        lambda calls: check_fake_quant_dev_calls(
            calls, resnet_input, lambda c: {torch.float32}, device))
    log_engines(cfg.name, {
        "scalar": baselines["resnet_scalar"],
        "batched": baselines["resnet_batched"],
        "fused": resnet["fused"]["profile"],
        "epoch": resnet["epoch"]["profile"]})
    log(f"  {time.perf_counter() - t_phase:.1f} s for the fused phase")
    release_cached_memory(device)
    return {"lm": lm, "resnet": resnet, "dev_row": dev_row}


# ---------------------------------------------------------------------------
# Phase 8: the population path (PopulationSearch, shared dispatches)
# ---------------------------------------------------------------------------

V5P = dict(name="tpu-v5p", peak_bf16=459e12, peak_int8=918e12,
           hbm_bw=2765e9, ici_bw=90e9)      # the JAX tests' second target


def _state_err(a, b) -> float:
    """Largest |difference| over the leaves of two agent states."""
    from repro_torch.core.ddpg import state_leaves
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(state_leaves(a), state_leaves(b)))


def check_shared_updates(pop) -> list:
    """Hold every shared update chunk of ``pop`` (one graph replay of the
    megabatched chunk) against the per-member path on the same indices:
    the chunk is run again eagerly one megabatched step at a time from a
    copy of the stacked state taken just before the replay, and each step
    is held against the P solo ``update_step``s from the same state
    (``population_update_chunk_vmap`` of one step) within 1e-5 (the JAX
    tests' bound between the megabatched and the vmapped path); the
    replay must equal the eager steps bit for bit. The whole chunk's
    trajectory is also run the per-member way and its distance from the
    replay reported, not held: over tens of Adam steps an ulp of
    difference in a near-zero gradient flips that element's normalized
    step (a jump of ~lr), and the two trajectories part (``PERF.md``).
    The comparison's own launches are taken back out of the counts.
    Returns per chunk (steps, worst step error, trajectory distance),
    filled as the population runs."""
    import torch
    from repro_torch.core.ddpg import (_tree_map,
                                       population_update_chunk_megabatched,
                                       population_update_chunk_vmap)
    from repro_torch.kernels import build
    real, rows = pop._update_graph, []
    clone = lambda st: _tree_map(torch.clone, st)

    def update_graph(n):
        graph, idx = real(n)

        def checked():
            cfg = pop.members[0].agent.cfg
            before = clone(pop.state)
            out = graph()
            launches = dict(build.LAUNCHES)
            eager, step_err = clone(before), 0.0
            for i in range(n):
                one = clone(eager)
                ii = idx[:, i:i + 1].clone()
                population_update_chunk_megabatched(cfg, eager, pop.ring, 1,
                                                    ii)
                population_update_chunk_vmap(cfg, one, pop.ring, 1, ii)
                step_err = max(step_err, _state_err(eager, one))
            replay_err = _state_err(pop.state, eager)
            population_update_chunk_vmap(cfg, before, pop.ring, n,
                                         idx.clone())
            traj = _state_err(pop.state, before)
            build.LAUNCHES.update(launches)
            rows.append((n, step_err, traj))
            if step_err > 1e-5 or replay_err != 0.0:
                raise AssertionError(
                    f"shared update chunk of {n} steps: a megabatched step "
                    f"differs from the per-member step by {step_err} (tol "
                    f"1e-5), the replay from the eager steps by "
                    f"{replay_err} (tol 0)")
            return out

        checked.label = graph.label
        return checked, idx

    pop._update_graph = update_graph
    return rows


def pop_steady(pop, first: int, alone=None) -> dict:
    """A chunk of every member after a run (every episode live, every
    graph captured), timed on the host clock ended by a sync (ms per
    member-episode; its launch counts, graph counts, readbacks and
    records returned), then one more profiled for the device's busy
    share. With ``alone`` (engines of the population's configs, each with
    its run behind it) those engines run the timed chunk one after
    another, each with its own dispatches, and nothing is profiled (the
    trace of their eager or per-member updates takes tens of seconds to
    sum; ``PERF.md`` §5 has those engines' busy shares)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import graphs
    from repro_torch.kernels import build
    ms = alone or pop.members
    k = ms[0]._chunk_size()

    def chunk(c):
        if alone:
            return [m._run_chunk(first + c * k, k) for m in ms]
        if pop.fuse_rollouts and pop._epochs_fusable():
            recs = pop._run_epoch_chunk(first + c * k, k)
        else:
            recs = [m._run_chunk(first + c * k, k) for m in ms]
        pop._dispatch_updates()
        return recs

    saved = [m._defer_updates for m in ms]
    for m in ms:
        m._defer_updates = not alone
    try:
        _sync(pop.device)
        build.reset_launches()
        graphs.reset_counts()
        reads = pop.readbacks
        t0 = time.perf_counter()
        recs = chunk(0)
        _sync(pop.device)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        counts = {key: dict(v) for key, v in graphs.COUNTS.items()}
        reads = pop.readbacks - reads
        busy, t0 = 0.0, time.perf_counter()
        if pop.device.type == "cuda" and not alone:   # the CPU has none
            # device activity alone: the busy share needs only the
            # kernels, and the host ops of an eager update multiply the
            # trace (its summary took tens of seconds)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                chunk(1)
                _sync(pop.device)
            busy = sum(getattr(ev, "self_device_time_total", 0.0)
                       for ev in prof.key_averages()
                       if getattr(ev, "device_type", None) is not None
                       and "CUDA" in str(ev.device_type)) * 1e-6
        profiled = time.perf_counter() - t0
    finally:
        for m, flag in zip(ms, saved):
            m._defer_updates = flag
    build.reset_launches()
    eps = k * len(ms)
    return {"member_episode_s": wall / eps, "device_busy_s": busy / eps,
            "member_episodes": eps, "launches": launches, "records": recs,
            "graphs": counts, "readbacks": reads, "profiled_s": profiled}


def log_pop_speed(name: str, shared: dict, alone: dict) -> None:
    for what, r in (("population", shared), ("members alone", alone)):
        busy = r["device_busy_s"]
        log(f"  [time] {name} {what}, steady state: "
            f"{1 / r['member_episode_s']:.3f} member-episodes/s "
            f"({r['member_episode_s'] * 1e3:.2f} ms each), device busy "
            + (f"{busy * 1e3:.2f} ms a member-episode "
               f"({busy / r['member_episode_s']:.1%}; the profiled chunk "
               f"{r['profiled_s']:.1f} s)" if busy else "not measured")
            + f"; {CARD}")
    log(f"    population / alone: "
        f"{alone['member_episode_s'] / shared['member_episode_s']:.3f}x")


def check_fused_sensitivity(name, cm, batch, activation_bound: bool) -> dict:
    """The fused analysis (``run_sensitivity``, chunks of 8 probe policies)
    against the per-probe path on the card: seconds each (host clock,
    ended by the analysis' readback) and the worst KL difference; every
    probe within 1e-6, the activation probes of a ResNet's convs behind a
    GroupNorm (``activation_bound``) within 1e-6 + 10% of the KL (the
    bound the CPU tests hold the port to against XLA)."""
    from repro_torch.core.sensitivity import (run_sensitivity,
                                              run_sensitivity_sequential)
    from repro_torch.kernels import build
    launches = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    fused = run_sensitivity(cm, batch, memo=False)
    t_fused = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = run_sensitivity_sequential(cm, batch)
    t_seq = time.perf_counter() - t0
    build.LAUNCHES.update(launches)
    worst, worst_rel, over = 0.0, 0.0, []
    for layer, row in seq.table.items():
        for tag, kl in row.items():
            d = abs(fused.table[layer][tag] - kl)
            tol = 1e-6
            if activation_bound and tag.startswith("a") and \
                    layer not in ("stem", "head"):
                tol += 0.1 * kl
                worst_rel = max(worst_rel, d / max(kl, 1e-30))
            else:
                worst = max(worst, d)
            if d > tol:
                over.append((layer, tag, kl, d))
    n = sum(len(r) for r in seq.table.values())
    log(f"  fused sensitivity, {name}: {t_fused:.3f} s fused (chunks of 8) "
        f"vs {t_seq:.3f} s per probe ({n} probes); worst |KL diff| "
        f"{worst:.3g} (tol 1e-6)" + (f", activation probes behind a "
                                      f"GroupNorm {worst_rel:.2%} of the KL"
                                      f" (tol 10%)" if activation_bound
                                      else "") + f"; {CARD}")
    if over:
        raise AssertionError(f"fused sensitivity off the per-probe path: "
                             f"{over[:5]}")
    return {"fused_s": t_fused, "per_probe_s": t_seq, "probes": n,
            "max_kl_diff": worst, "max_activation_rel": worst_rel}


def pop_device_cspecs(members, histories) -> list:
    """The device cspec of each batch of a shared epoch's validation: the
    P*K policies of the members' batch, member by member, as the epoch
    graph stacks them (``cspec_builder`` on device int tensors)."""
    import torch
    from repro_torch.core.policy import stack_policies
    m0, k = members[0], members[0].batch_size
    out = []
    for i in range(0, len(histories[0]), k):
        pb = stack_policies(m0.specs, [r.policy for h in histories
                                       for r in h[i:i + k]])
        out.append(m0.cmodel.cspec_builder()(*(
            torch.as_tensor(x, dtype=torch.int32, device=m0.device)
            for x in (pb.keep, pb.w_bits, pb.a_bits))))
    return out


def check_shared_validation_k1(cfg, members, histories, rows: int,
                               device) -> dict:
    """K1's device-bits entry exact at every site of a shared epoch's last
    validation (one forward over the members' P*K policies), in the
    path's dtypes, and equal to the host-bits form."""
    import torch
    calls = k1_calls(cfg, pop_device_cspecs(members, [
        h[-members[0].batch_size:] for h in histories])[0], rows)
    gen = torch.Generator(device=device).manual_seed(16)

    def lm_input(call, dtype):
        (R, C), bits = call
        x = torch.randn((len(bits), R, C) if R == rows else (R, C),
                        generator=gen, device=device).to(dtype)
        return x if R == rows else x.expand(len(bits), R, C)

    t0 = time.perf_counter()
    err = check_fake_quant_dev_calls(calls, lm_input, lambda c: {
        k1_call_dtype(cfg, c[0], rows)}, device)
    log(f"  K1 device bits over the P*K = "
        f"{len(members) * members[0].batch_size} slots at the "
        f"{err['pairs']} (shape, bits vector) sites of the last shared "
        f"validation, in the path's dtypes: max |kernel - plain| "
        f"{err['max_abs_err']:.3g} (tol 0), equal to the host-bits form "
        f"({time.perf_counter() - t0:.1f} s)")
    return err


def population_phase(device, lm_sens, resnet_sens, batch_size: int, *,
                     lm_cfg=None, resnet_cfg=None, val_batch=None,
                     val_seq=None, images=None, episodes: int = 16,
                     warmup: int = 4, updates: int = 16) -> dict:
    """Phase 8, ``[population path]``: ``PopulationSearch`` on ResNet18 at
    CIFAR-10 widths (the paper's p / q / pq agents as batched members,
    action_dim padded to 3, sharing megabatched updates, each step of
    every shared chunk held to the per-member steps from the same state,
    ``check_shared_updates``) and on the LM testbed (two
    fused members in epoch mode, V5E and tpu-v5p, sharing rollouts and
    whole epochs: held to the same population run eagerly, bit for bit,
    and to each member run alone); steady-state member-episodes/s beside
    the members run alone in turn; the fused sensitivity against the
    per-probe path. Returns the launch counts of each population run. The
    keywords cut the configs and sizes for a rehearsal on the CPU."""
    import dataclasses

    import torch
    from repro_torch.configs.testbed import (IMG_CTX, IMG_VAL_BATCH,
                                             LM_CFG, RESNET18_CIFAR,
                                             SERVE_CTX, VAL_BATCH, VAL_SEQ)
    from repro_torch.core import graphs
    from repro_torch.core.latency import V5E, HardwareTarget
    from repro_torch.core.search import (BatchedCompressionSearch,
                                         FusedCompressionSearch,
                                         PopulationSearch)
    from repro_torch.kernels import build
    LM_CFG = lm_cfg or LM_CFG
    VAL_BATCH, VAL_SEQ = val_batch or VAL_BATCH, val_seq or VAL_SEQ
    IMG_VAL_BATCH = images or IMG_VAL_BATCH
    device = torch.device(device)
    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    out = {}

    # ResNet18: the paper's three agents as batched members
    cfg = resnet_cfg or RESNET18_CIFAR
    log(f"[population path] PopulationSearch on {cfg.name}: batched "
        f"members p, q and pq (action_dim padded to 3), K {SLOTS}, "
        f"{episodes} episodes, warmup {warmup}, {updates} updates per live "
        f"episode, DDPG batch {batch_size}; updates shared (megabatched, "
        f"one replay per update count); the ResNet path's seeds and "
        f"sensitivity table; {CARD}")
    cm, val, scfg = resnet_inputs(cfg, device, episodes=episodes,
                                  warmup=warmup, updates=updates,
                                  batch_size=batch_size,
                                  val_batch=IMG_VAL_BATCH)
    ddpg3 = dataclasses.replace(scfg.ddpg, action_dim=3)
    members = [BatchedCompressionSearch(
        cm, val, dataclasses.replace(scfg, methods=m, ddpg=ddpg3), IMG_CTX,
        sens=resnet_sens, batch_size=SLOTS) for m in ("p", "q", "pq")]
    pop = PopulationSearch(members)
    worst = check_shared_updates(pop)
    _sync(device)
    build.reset_launches()
    graphs.reset_counts()
    t0 = time.perf_counter()
    res = pop.run()
    _sync(device)
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    counts = {k: dict(v) for k, v in graphs.COUNTS.items()}
    for m, r in zip(members, res):
        check_batch_records(m, r.history, episodes)
    steps = updates * (episodes - warmup)
    log(f"  {episodes} episodes x 3 members in {secs:.3f} s (captures and "
        f"the chunk checks included); graphs {counts}; launches {launches}")
    for n, step_err, traj in worst:
        log(f"  shared update chunk of {n} steps: replay equal to the eager "
            f"megabatched steps; each step vs the per-member steps from the "
            f"same state: max |difference| {step_err:.3g} (tol 1e-5); the "
            f"whole chunk run the per-member way ends {traj:.3g} away "
            f"(reported, not held)")
    # every update count is captured at its first use, and the capture's
    # warm-up runs the chunk once more: 2 launches a step, twice
    want = {"adam_polyak": 4 * steps, "mlp3_members": 0, "mlp3": 0,
            "polyak": 0, "fake_quant": 0}
    check_fused_launches(launches, want, "ResNet population")
    live = sum(b + SLOTS > warmup for b in range(0, episodes, SLOTS))
    if len(worst) != live or on_card and counts.get("update", {}).get(
            "replays") != live:
        raise AssertionError(f"ResNet population: {counts}, {len(worst)} "
                             f"checked chunks; wanted one update replay "
                             f"a batch after warmup")
    out["resnet"] = {"launches": launches, "seconds": secs,
                     "chunk_errs": worst}
    del pop._update_graph
    shared = pop_steady(pop, episodes)
    sites = sum(len(resnet_k1_calls(cfg, cs, IMG_VAL_BATCH))
                for m, recs in zip(members, shared["records"])
                for cs in batch_cspecs(m, recs))
    log(f"  steady chunk, shared: graphs {shared['graphs']}")
    check_fused_launches(shared["launches"], {
        "adam_polyak": 2 * SLOTS * updates, "fake_quant_slots": sites,
        "mlp3": 0, "mlp3_members": 0, "polyak": 0, "fake_quant": 0},
        "ResNet population, steady chunk")
    if on_card and shared["graphs"] != {"update": {"captures": 0,
                                                    "replays": 1}}:
        raise AssertionError("ResNet population: a steady chunk is not one "
                             "update replay")
    alone = pop_steady(pop, episodes + 2 * SLOTS, alone=members)
    log_pop_speed(cfg.name, shared, alone)
    out["resnet"].update(shared=shared, alone=alone)
    out["resnet_sens"] = check_fused_sensitivity(cfg.name, cm, val, True)
    del pop, members, cm, val
    release_cached_memory(device)

    # LM testbed: two targets, shared epochs
    log(f"  {time.perf_counter() - t_phase:.1f} s for the ResNet population")
    t_lm = time.perf_counter()
    E, lm_eps = FUSED_E, 2 * episodes
    log(f"  [population path] {LM_CFG.name}: two FusedCompressionSearch "
        f"members in epoch mode (E {E}), targets V5E and tpu-v5p, K "
        f"{SLOTS}, {lm_eps} episodes, fuse_rollouts=True; the batched "
        f"path's seeds and sensitivity table")
    v5p = HardwareTarget(**V5P)

    def lm_pop(eager=False, alone=False):
        cm, val, scfg = search_inputs(
            LM_CFG, device, episodes=lm_eps, warmup=warmup,
            updates=updates, batch_size=batch_size, val_batch=VAL_BATCH,
            val_seq=VAL_SEQ)
        ms = [FusedCompressionSearch(cm, val, scfg, SERVE_CTX, hw=hw,
                                     sens=lm_sens, batch_size=SLOTS,
                                     epoch_batches=E) for hw in (V5E, v5p)]
        _sync(device)
        build.reset_launches()
        graphs.reset_counts()
        t0 = time.perf_counter()
        with eager_graphs() if eager else contextlib.nullcontext():
            if alone:
                hist = [m.run().history for m in ms]
                p = None
            else:
                p = PopulationSearch(ms, fuse_rollouts=True)
                hist = [r.history for r in p.run()]
        _sync(device)
        return (p, ms, hist, time.perf_counter() - t0, dict(build.LAUNCHES),
                {k: dict(v) for k, v in graphs.COUNTS.items()})

    pop, ms, hist, secs, launches, counts = lm_pop()
    for m, h in zip(ms, hist):
        check_batch_records(m, h, lm_eps)
        if m.dispatch_log != ["epoch"] * (lm_eps // (E * SLOTS)):
            raise AssertionError(f"dispatch log {m.dispatch_log}")
    log(f"  {lm_eps} episodes x 2 members in {secs:.3f} s (captures "
        f"included); graphs {counts}; readbacks {pop.readbacks}; launches "
        f"{launches}; dispatch logs {[m.dispatch_log for m in ms]}")
    if pop.readbacks != lm_eps // (E * SLOTS) or on_card and counts.get(
            "epoch", {}).get("replays") != lm_eps // (E * SLOTS):
        raise AssertionError("LM population: not one epoch replay and one "
                             "readback per shared epoch")
    if on_card and (launches["mlp3_members"] == 0
                    or launches["adam_polyak"] != 0):
        raise AssertionError(f"LM population launches {launches}")
    ref = lm_pop(eager=True)
    for a, b, ma, mb in zip(hist, ref[2], ms, ref[1]):
        check_fused_equal(a, b, ma, mb, f"population graphs vs the same "
                          f"functions eager ({ref[3]:.3f} s)")
    del ref
    solo = lm_pop(alone=True)
    log(f"  the members alone, same seeds, in turn: {solo[3]:.3f} s "
        f"(captures included); launches {solo[4]}")
    for i, (a, b) in enumerate(zip(hist, solo[2])):
        same = [_cmps(x.policy) == _cmps(y.policy) and x.reward == y.reward
                and x.accuracy == y.accuracy for x, y in zip(a, b)]
        first = same.index(False) if not all(same) else None
        log(f"  member {i} vs run alone on the same seed: {sum(same)}/"
            f"{len(same)} records equal (policy, accuracy, reward)" + (
                "" if first is None else
                f"; first difference at episode {first}: accuracy "
                f"{a[first].accuracy} vs {b[first].accuracy}, reward "
                f"{a[first].reward} vs {b[first].reward}"))
        if not all(same[:SLOTS]):
            raise AssertionError("the shared rollout of the first batch "
                                 "differs from the member's own")
    out["lm"] = {"launches": launches, "seconds": secs}
    rows, P = VAL_BATCH * VAL_SEQ, len(ms)
    err = check_shared_validation_k1(LM_CFG, ms, hist, rows, device)
    shared = pop_steady(pop, lm_eps)
    T = len(ms[0].steps)
    sites = sum(len(k1_calls(LM_CFG, cs, rows))
                for cs in pop_device_cspecs(ms, shared["records"]))
    log(f"  steady chunk, shared: graphs {shared['graphs']}, "
        f"{shared['readbacks']} readback(s)")
    check_fused_launches(shared["launches"], {
        "mlp3_members": E * T, "mlp3": 5 * P * E * SLOTS * updates,
        "polyak": P * E * SLOTS * updates, "fake_quant_slots_dev": sites,
        "adam_polyak": 0, "fake_quant_slots": 0, "fake_quant": 0},
        "LM population, steady chunk")
    if on_card and shared["graphs"] != {"epoch": {"captures": 0,
                                                   "replays": 1}} or \
            shared["readbacks"] != 1:
        raise AssertionError("LM population: a steady chunk is not one "
                             "epoch replay and one readback")
    alone = pop_steady(pop, lm_eps, alone=solo[1])
    log_pop_speed(LM_CFG.name, shared, alone)
    out["lm"].update(shared=shared, alone=alone, dev_check=err)
    out["lm_sens"] = check_fused_sensitivity(LM_CFG.name, ms[0].cmodel,
                                             ms[0].val_batch, False)
    del pop, ms, solo
    release_cached_memory(device)
    log(f"  {time.perf_counter() - t_lm:.1f} s for the LM population")
    log(f"  {time.perf_counter() - t_phase:.1f} s for the population phase")
    return out


# ---------------------------------------------------------------------------
# Phases 9 and 10: the calibration path and the measured search
# ---------------------------------------------------------------------------

def _positive(x) -> bool:
    return isinstance(x, float) and math.isfinite(x) and x > 0


def run_calibration(cfg, device, verbose: bool = True) -> dict:
    """``launch.calibrate.run`` (no file written); prints its rows and
    fails on a time that is not finite and positive."""
    from repro_torch.launch import calibrate
    out = calibrate.run(out_path=None, device=device, cfg=cfg,
                        verbose=False)
    for r in out["units"]:
        if "skipped" in r:
            log(f"  unit {r['kind']:9s} {r['container']:4s} skipped: "
                f"{r['skipped']}")
            continue
        if verbose:
            log(f"  unit {r['kind']:9s} {r['container']:4s} m={r['m']} "
                f"k={r['k']} n={r['n']}: {r['measured_s'] * 1e6:.2f} us "
                f"measured, {r['analytic_s'] * 1e6:.4f} us analytic, "
                f"ratio {r['ratio']:.4g}")
        if not (_positive(r["measured_s"]) and _positive(r["ratio"])):
            raise AssertionError(f"bad unit row {r}")
    for r in out["kernels"]:
        log(f"  kernel row {r['kernel']} {r['M']}x{r['K']}x{r['N']}: "
            f"{r['measured_s'] * 1e6:.2f} us (host clock, quantization "
            f"steps included, best of 5)")
    for c, r in out["model"].items():
        log(f"  model {c}: {r['measured_s'] * 1e3:.4f} ms per deployed "
            f"forward ({out['meta']['ctx']['batch']} x "
            f"{out['meta']['ctx']['seq_ctx']} tokens)")
    for k, d in sorted(out["ratios"].items()):
        log(f"  ratio {k:9s} " + " ".join(
            f"{c}={v:.4g}" for c, v in sorted(d.items())))
    log(f"  extra (attention / overhead) factor "
        f"{out['extra']['attn']:.4g}")
    for r in out["demo"]:
        log(f"  demo {r['container']}: predicted_ratio "
            f"{r['predicted_ratio']:.4f}, measured_ratio "
            f"{r['measured_ratio']:.4f}, within_tol={r['within_tol']} "
            f"(tolerance {r['tolerance']}; a finding, not a check)")
    times = [r["measured_s"] for r in out["kernels"]] + \
        [r["measured_s"] for r in out["model"].values()] + \
        [r["predicted_s"] for r in out["demo"]]
    if not all(_positive(t) for t in times) \
            or not math.isfinite(out["extra"]["attn"]):
        raise AssertionError("a calibration time is not finite and positive")
    return out


def run_measured_search(cfg, device, table_dict: dict, *, episodes: int,
                        warmup: int, updates: int, batch_size: int):
    """A pq search in ``oracle_mode="measured"`` on the fitted table, at
    the table's own context and token batch (so that the predicted and
    the measured ratios describe the same forward). Checks the top-K rows
    and that the reference latency is the calibrated oracle's."""
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.latency import V5E, LatencyContext, policy_latency
    from repro_torch.core.measure import CalibrationTable
    from repro_torch.core.policy import Policy
    from repro_torch.core.reward import RewardConfig
    from repro_torch.core.search import CompressionSearch, SearchConfig
    from repro_torch.launch.calibrate import SEED, calibration_batch
    from repro_torch.models import model as M

    top_k = 3
    table = CalibrationTable.from_dict(table_dict)
    ctx = LatencyContext(**table.meta["ctx"])
    batch = calibration_batch(cfg, device)
    cm = CompressibleLM(cfg, M.init(cfg, seed=SEED, device=device))
    scfg = SearchConfig(
        methods="pq", episodes=episodes, seed=SEED,
        reward=RewardConfig(target_ratio=0.5, beta=-3.0),
        ddpg=DDPGConfig(warmup_episodes=warmup, updates_per_episode=updates,
                        batch_size=batch_size, buffer_size=2000),
        oracle_mode="measured", measure_top_k=top_k)
    search = CompressionSearch(cm, batch, scfg, ctx, calib=table)
    result = search.run()
    want = policy_latency(cm.specs, Policy.reference(cm.specs), V5E, ctx,
                          calib=table).total_s
    if search.ref_lat.total_s != want:
        raise AssertionError(f"reference latency {search.ref_lat.total_s} "
                             f"is not the calibrated oracle's {want}")
    rows = result.measured or []
    if len(rows) != min(top_k, episodes):
        raise AssertionError(f"{len(rows)} measured rows, wanted {top_k}")
    for r in rows:
        if not all(_positive(float(r[k])) for k in (
                "predicted_s", "predicted_ratio", "measured_s",
                "measured_ref_s", "measured_ratio")):
            raise AssertionError(f"bad measured row {r}")
    return result


# ---------------------------------------------------------------------------
# Phase 11: the training path (train and QAT steps, the testbed trainers)
# ---------------------------------------------------------------------------

K1_GRAD_SHAPES = ((3072, 256), (4096, 896))  # testbed; qwen2 at 8 x 512
LM_TRAIN = dict(steps=220, batch=16, seq=48)     # benchmarks/common.py:52
RESNET_TRAIN = dict(steps=250, batch=64)
QAT_RETRAIN = dict(steps=60, lr=1e-3, warmup=5, batch=16, seq=48,
                   seed=777_000)             # benchmarks/agent_comparison.py
QWEN_TRAIN = dict(batch=8, seq=512, warmup=2, timed=5)
# Gates of the phase. The QAT loss on the card against the CPU: the two
# forwards agree to ~1e-6 before the quantizers, and a last-bit
# difference in a fake-quant range moves whole quantization steps
# (ROADMAP.md, Queue 3: log-probs up to 0.043 apart under f32); the
# loss, a mean over 504 positions, moves far less (the CPU tests hold
# the same QAT loss against the JAX package at 1e-3).
QAT_LOSS_TOL = 1e-3
# The testbeds must beat chance (1/256 tokens, 1/10 classes) by far:
# the trained LM's next-token accuracy at least 0.25 and ResNet18's at
# least 0.5; the LM trained on the card within 0.05 of the same trainer
# on the CPU's plain route (bf16 rounds at other points on the two, so
# the runs part after the first steps).
LM_ACC_MIN, RESNET_ACC_MIN, LM_CPU_MARGIN = 0.25, 0.5, 0.05

# The CPU run of the LM testbed's trainer: a child process (at a low
# priority, on the cores this process does not use) that runs while the
# card trains and serves qwen2-0.5b's prefill, and prints its result as
# one JSON line. On an H100 machine whose CPU has no bf16 instructions
# it takes ~90 s, longer than the training phase itself.
CPU_LM_CHILD = """
import json, os, sys, time
os.nice(10)
import torch
torch.set_num_threads(int(sys.argv[1]))
from repro_torch.configs.testbed import LM_CFG
from repro_torch.train.trainer import train_testbed_lm
t0 = time.perf_counter()
_, _, acc = train_testbed_lm(LM_CFG, steps=int(sys.argv[2]),
                             batch=int(sys.argv[3]), seq=int(sys.argv[4]),
                             device="cpu")
print(json.dumps({"acc": acc, "seconds": time.perf_counter() - t0}))
"""


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def start_cpu_lm_trainer() -> subprocess.Popen:
    """The LM testbed's trainer on the CPU (plain route), in a child
    process that sees no card, on all but two of the cores this process
    may use; stopped at exit whatever happens in between."""
    import atexit
    import tempfile
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    threads = max(1, len(os.sched_getaffinity(0)) - 2)
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", CPU_LM_CHILD, str(threads),
         *(str(LM_TRAIN[k]) for k in ("steps", "batch", "seq"))],
        stdout=subprocess.PIPE, stderr=err, text=True, env=env)
    proc.err_log = err
    atexit.register(_stop, proc)
    log(f"  the LM trainer on the CPU: a child process, {threads} threads")
    return proc


def finish_cpu_lm_trainer(proc: subprocess.Popen, card_acc: float) -> dict:
    """Wait for the CPU trainer; its accuracy must be within
    ``LM_CPU_MARGIN`` of the card's."""
    t0 = time.perf_counter()
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        _stop(proc)
    if proc.returncode != 0:
        proc.err_log.seek(0)
        raise AssertionError(f"the CPU trainer failed: "
                             f"{proc.err_log.read()[-2000:]}")
    cpu = json.loads(out.strip().splitlines()[-1])
    log(f"[training path, c, continued] the same LM trainer on the CPU's "
        f"plain route ({cpu['seconds']:.1f} s, waited "
        f"{time.perf_counter() - t0:.1f} s for it here): accuracy "
        f"{cpu['acc']:.4f}, the card's {card_acc:.4f} (gate: within "
        f"{LM_CPU_MARGIN})")
    if abs(cpu["acc"] - card_acc) > LM_CPU_MARGIN:
        raise AssertionError("the LM trained on the card is not within "
                             f"{LM_CPU_MARGIN} of the CPU's accuracy")
    return cpu


def check_k1_autograd(device) -> dict:
    """K1's straight-through route under autograd, as every QAT forward
    runs it (``core.quantization.fake_quant`` on a card tensor): at the
    testbed's activation [3072, 256] and qwen2's [4096, 896] (8 x 512
    rows), bf16, 2 / 4 / 8 bits, the forward equals the plain chain
    ``(xf + (xq - xf)).to(bf16)`` exactly and ``x.grad`` equals the
    upstream gradient bit for bit; one K1 launch per call."""
    import torch
    from repro_torch.core.quantization import fake_quant
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import fake_quant_ref
    gen = torch.Generator(device=device).manual_seed(11)
    err, calls = 0.0, 0
    build.reset_launches()
    for shape in K1_GRAD_SHAPES:
        for bits in (2, 4, 8):
            x = torch.randn(shape, generator=gen, device=device).to(
                torch.bfloat16).requires_grad_(True)
            y = fake_quant(x, bits)
            calls += 1
            xf = x.detach().float()
            chain = (xf + (fake_quant_ref(xf, bits) - xf)).to(x.dtype)
            err = max(err, float((y.detach().float() - chain.float())
                                 .abs().max()))
            gy = torch.randn(shape, generator=gen, device=device).to(
                torch.bfloat16)
            y.backward(gy)
            if y.grad_fn is None or not torch.equal(x.grad, gy):
                raise AssertionError(f"K1's straight-through gradient at "
                                     f"{shape}, {bits} bits is not the "
                                     f"upstream gradient")
    if err > 0.0:
        raise AssertionError(f"K1 under autograd disagrees with the plain "
                             f"chain: {err}")
    if build.LAUNCHES["fake_quant"] != calls:
        raise AssertionError(f"K1 launched {build.LAUNCHES['fake_quant']} "
                             f"times for {calls} calls under autograd")
    log(f"  a. K1 under autograd at {list(K1_GRAD_SHAPES)} bf16, 2/4/8 "
        f"bits: forward exact against the plain chain, x.grad equal to "
        f"the upstream gradient bit for bit, {calls} launches")
    return {"max_abs_err": err, "calls": calls}


def _max_leaf_diff(a, b) -> float:
    from repro_torch.optim.optimizer import tree_leaves
    return max(float((x.detach().cpu().float() - y.detach().cpu().float())
                     .abs().max()) for x, y in zip(tree_leaves(a),
                                                   tree_leaves(b)))


def check_train_device_vs_cpu(device, seq: int = 64, batch: int = 4
                              ) -> dict:
    """qwen2-0.5b at its SMOKE widths in f32, the same seeded params and
    batch on the card and on the CPU's plain route: the loss within
    1e-5 and every gradient leaf within 1e-6 (f32 sums in other orders;
    the largest gradients are ~0.1); one plain train step, the loss and
    every updated leaf within 1e-5 (the QAT retrain's optimizer: lr
    2e-4 at step 1); then one QAT step under a seeded pq policy: K1
    launched exactly ``k1_calls``' count for the forward, the loss within
    ``QAT_LOSS_TOL``."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import (lm_loss, make_train_step,
                                              value_and_grad)
    cfg = get_config("qwen2-0.5b", smoke=True).replace(
        compute_dtype="float32")
    host = M.init(cfg, 0, "cpu")
    toks = prefill_tokens(cfg, batch, seq, 3, "cpu")
    on = {"cpu": (host, {"tokens": toks}),
          "card": (_to(host, device), {"tokens": toks.to(device)})}
    grads = {}
    for name, (p, b) in on.items():
        grads[name] = value_and_grad(lambda q: lm_loss(cfg, q, b), p)
    d_loss = abs(float(grads["cpu"][0]) - float(grads["card"][0]))
    d_grad = _max_leaf_diff(grads["cpu"][1], grads["card"][1])
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=60,
                           weight_decay=0.0)
    out = {}
    for name, (p, b) in on.items():
        q = _to(p, p["embed"].device)
        st = adamw_init(q, ocfg)
        q, st, m = make_train_step(cfg, ocfg)(q, st, b)
        out[name] = (q, float(m["loss"]), float(m["lr"]))
    d_step = _max_leaf_diff(out["cpu"][0], out["card"][0])
    log(f"  b. {cfg.name} f32, {batch} x {seq} tokens, card against the "
        f"CPU: loss {d_loss:.3g} apart, gradients {d_grad:.3g} (tol 1e-6);"
        f" one train step at lr {out['card'][2]:.3g}: loss "
        f"{abs(out['cpu'][1] - out['card'][1]):.3g}, updated leaves "
        f"{d_step:.3g} (tol 1e-5)")
    if d_loss > 1e-5 or d_grad > 1e-6 or d_step > 1e-5 \
            or abs(out["cpu"][1] - out["card"][1]) > 1e-5:
        raise AssertionError("the train step on the card disagrees with "
                             "the CPU's plain route")
    cms = {name: CompressibleLM(cfg, p) for name, (p, _) in on.items()}
    policy = seeded_policy(cms["cpu"], 4)
    losses, k1 = {}, None
    for name, (p, b) in on.items():
        cspec = cms[name].build_cspec(policy)
        q = _to(p, p["embed"].device)
        step = make_train_step(cfg, ocfg, cspec=cspec)
        build.reset_launches()
        _, _, m = step(q, adamw_init(q, ocfg), b)
        losses[name] = float(m["loss"])
        if name == "card":
            k1 = (build.LAUNCHES["fake_quant"],
                  len(k1_calls(cfg, cspec, batch * seq)))
    d_qat = abs(losses["cpu"] - losses["card"])
    log(f"  b. one QAT step under a seeded pq policy: K1 {k1[0]} launches "
        f"(k1_calls: {k1[1]}), loss {d_qat:.3g} apart (tol "
        f"{QAT_LOSS_TOL})")
    if k1[0] != k1[1] or k1[1] == 0 or d_qat > QAT_LOSS_TOL:
        raise AssertionError(f"QAT step on the card: K1 {k1}, loss "
                             f"{losses}")
    return {"loss": d_loss, "grad": d_grad, "step": d_step, "qat": d_qat}


def profiled_steps(step, n: int) -> dict:
    """``n`` calls of ``step`` (one train step each, warm) timed on the
    host clock (ended by a sync), then ``n`` more under
    ``torch.profiler`` (device activity only: recording the host's ops
    too cost seconds a window on an H100 machine): ms per step, the
    device's busy share (kernel time over the unprofiled wall time) and
    the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = [(getattr(ev, "self_device_time_total", 0.0) * 1e-3 / n, ev.key,
             ev.count / n) for ev in prof.key_averages()
            if getattr(ev, "device_type", None) is not None
            and "CUDA" in str(ev.device_type)]
    busy = sum(t for t, _, _ in rows) * 1e-3
    return {"step_ms": wall * 1e3, "busy_ms": busy * 1e3,
            "busy_share": busy / wall, "kernels": sum(c for *_, c in rows),
            "top": sorted(rows, reverse=True)[:6]}


def log_top(prof: dict) -> None:
    log(f"     {prof['kernels']:.0f} kernels a step; top device time "
        f"(ms a step):")
    for t, key, n in prof["top"]:
        log(f"     {t:9.3f}  x{n:<5g} {key[:90]}")


def train_lm_testbed(device) -> dict:
    """``train_testbed_lm(LM_CFG, steps=220, batch=16, seq=48)`` on the
    card from the port's seeded init: ms per step, the validation loss
    before and after, the accuracy; a profiled window of the same step
    on a copy for the device's busy share."""
    import torch
    from repro_torch.configs.testbed import LM_CFG
    from repro_torch.data.pipeline import make_bigram_table, sample_bigram
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_eval_step, make_train_step
    from repro_torch.train.trainer import train_testbed_lm
    steps = LM_TRAIN["steps"]
    table = make_bigram_table(LM_CFG.vocab_size, 0)
    val = {"tokens": torch.as_tensor(sample_bigram(
        table, 64, LM_TRAIN["seq"], steps + 7), device=device).long()}
    init = M.init(LM_CFG, 0, device)
    evaluate = make_eval_step(LM_CFG)
    before = float(evaluate(init, val))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, tval, acc = train_testbed_lm(LM_CFG, **LM_TRAIN, params=init,
                                         device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not torch.equal(tval["tokens"], val["tokens"]):
        raise AssertionError("the trainer's validation batch moved")
    after = float(evaluate(params, val))
    copy = _to(params, device)
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=steps,
                           weight_decay=0.0)
    st = [adamw_init(copy, ocfg)]
    step = make_train_step(LM_CFG, ocfg)
    batch = {"tokens": torch.as_tensor(sample_bigram(
        table, LM_TRAIN["batch"], LM_TRAIN["seq"], 10 ** 6),
        device=device).long()}

    def one():
        st[0] = step(copy, st[0], batch)[1]
    one()
    prof = profiled_steps(one, 3)
    log(f"  c. {LM_CFG.name} trained {steps} steps of "
        f"{LM_TRAIN['batch']} x {LM_TRAIN['seq']}: "
        f"{seconds / steps * 1e3:.2f} ms per step over the run (batches "
        f"drawn on the host included), {prof['step_ms']:.2f} ms per step "
        f"alone, device busy {prof['busy_ms']:.2f} ms "
        f"({prof['busy_share']:.1%}); validation loss {before:.4f} -> "
        f"{after:.4f}, accuracy {acc:.4f} (gate >= {LM_ACC_MIN}); {CARD}")
    log_top(prof)
    if not after < before or acc < LM_ACC_MIN:
        raise AssertionError(f"the LM testbed did not train: loss {before}"
                             f" -> {after}, accuracy {acc}")
    return {"params": params, "val": val, "acc": acc, "loss": (before, after),
            "ms_per_step": seconds / steps * 1e3, **prof}


def train_resnet_testbed(device) -> dict:
    """``train_testbed_resnet(RESNET18_CIFAR, steps=250, batch=64)`` on
    the card from the port's seeded init: as ``train_lm_testbed``."""
    import torch
    from repro_torch.configs.testbed import RESNET18_CIFAR as cfg
    from repro_torch.data.pipeline import blob_images
    from repro_torch.models import model as M
    from repro_torch.models import resnet as R
    from repro_torch.optim.optimizer import (OptimizerConfig, adamw_init,
                                             adamw_update)
    from repro_torch.train.train_step import value_and_grad
    from repro_torch.train.trainer import resnet_loss, train_testbed_resnet
    steps = RESNET_TRAIN["steps"]
    val = blob_images(cfg.num_classes, 256, cfg.img_size, seed=steps + 7,
                      device=device)
    init = R.init(cfg, 0, device)
    with torch.no_grad():
        before = float(resnet_loss(cfg, init, val))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, tval, acc = train_testbed_resnet(cfg, **RESNET_TRAIN,
                                             params=init, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not torch.equal(tval["labels"], val["labels"]):
        raise AssertionError("the trainer's validation batch moved")
    with torch.no_grad():
        after = float(resnet_loss(cfg, params, val))
    copy = _to(params, device)
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=10, total_steps=steps,
                           weight_decay=1e-4)
    st = [adamw_init(copy, ocfg)]
    batch = blob_images(cfg.num_classes, RESNET_TRAIN["batch"],
                        cfg.img_size, seed=10 ** 6, device=device)

    def one():
        _, g = value_and_grad(lambda p: resnet_loss(cfg, p, batch), copy)
        st[0] = adamw_update(copy, g, st[0], ocfg)[1]
    one()
    prof = profiled_steps(one, 3)
    log(f"  c. {cfg.name} ({M.param_count(params) / 1e6:.2f} M params) "
        f"trained {steps} steps of {RESNET_TRAIN['batch']} images: "
        f"{seconds / steps * 1e3:.2f} ms per step over the run, "
        f"{prof['step_ms']:.2f} ms per step alone, device busy "
        f"{prof['busy_ms']:.2f} ms ({prof['busy_share']:.1%}); validation "
        f"loss {before:.4f} -> {after:.4f}, accuracy {acc:.4f} (gate >= "
        f"{RESNET_ACC_MIN}); {CARD}")
    log_top(prof)
    if not after < before or acc < RESNET_ACC_MIN:
        raise AssertionError(f"ResNet18 did not train: loss {before} -> "
                             f"{after}, accuracy {acc}")
    return {"acc": acc, "loss": (before, after),
            "ms_per_step": seconds / steps * 1e3, **prof}


def qat_pipeline(device, params, val) -> dict:
    """The paper's pipeline on the trained LM testbed: the fused
    sensitivity analysis, the fused engine in epoch mode (K 8, E 2, 32
    episodes, the fused path's agent settings), then a 60-step QAT
    retrain under the best policy as ``benchmarks/agent_comparison.py``
    retrains (lr 1e-3, warmup 5, no weight decay, bigram batches of 16 x
    48 drawn with seeds 777,000 + s); the policy's accuracy before and
    after beside the clean one. K1 must launch on every QAT step, exactly
    ``k1_calls``' count of the forward."""
    import torch
    from repro_torch.configs.testbed import LM_CFG, SERVE_CTX
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.reward import RewardConfig
    from repro_torch.core.search import FusedCompressionSearch, SearchConfig
    from repro_torch.core.sensitivity import run_sensitivity
    from repro_torch.data.pipeline import make_bigram_table, sample_bigram
    from repro_torch.kernels import build
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    cm = CompressibleLM(LM_CFG, params)
    t0 = time.perf_counter()
    sens = run_sensitivity(cm, val)
    scfg = SearchConfig(
        methods="pq", episodes=32, seed=0,
        reward=RewardConfig(target_ratio=0.5, beta=-3.0),
        ddpg=DDPGConfig(warmup_episodes=4, updates_per_episode=16,
                        batch_size=64, buffer_size=2000))
    search = FusedCompressionSearch(cm, val, scfg, SERVE_CTX, sens=sens,
                                    batch_size=SLOTS,
                                    epoch_batches=FUSED_E)
    res = search.run()
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    policy = res.best.policy
    clean = float(cm.accuracy(val))
    before = float(cm.accuracy(val, cm.build_cspec(policy)))
    q = QAT_RETRAIN
    cspec = cm.build_cspec(policy)
    want = len(k1_calls(LM_CFG, cspec, q["batch"] * q["seq"]))
    if want == 0:
        raise AssertionError("the best policy quantizes nothing: no QAT "
                             "path to check")
    ocfg = OptimizerConfig(lr=q["lr"], warmup_steps=q["warmup"],
                           total_steps=q["steps"], weight_decay=0.0)
    trained = _to(params, device)
    st = adamw_init(trained, ocfg)
    step = make_train_step(LM_CFG, ocfg, cspec=cspec)
    table = make_bigram_table(LM_CFG.vocab_size, 0)
    per_step = []
    t0 = time.perf_counter()
    for s in range(q["steps"]):
        batch = {"tokens": torch.as_tensor(sample_bigram(
            table, q["batch"], q["seq"], q["seed"] + s),
            device=device).long()}
        build.reset_launches()
        trained, st, _ = step(trained, st, batch)
        per_step.append(build.LAUNCHES["fake_quant"])
    torch.cuda.synchronize()
    t_qat = time.perf_counter() - t0
    retrained = CompressibleLM(LM_CFG, trained)
    after = float(retrained.accuracy(val, retrained.build_cspec(policy)))
    log(f"  d. the pipeline on the trained {LM_CFG.name}: sensitivity and "
        f"{scfg.episodes} fused epoch-mode episodes in {t_search:.2f} s, "
        f"best episode {res.best.episode} (reward {res.best.reward:+.4f}, "
        f"latency ratio {res.best.latency_ratio:.4f}); QAT {q['steps']} "
        f"steps in {t_qat:.2f} s ({t_qat / q['steps'] * 1e3:.2f} ms each),"
        f" K1 {min(per_step)}-{max(per_step)} launches a step (k1_calls: "
        f"{want}); accuracy clean {clean:.4f}, under the policy "
        f"{before:.4f} before QAT, {after:.4f} after; {CARD}")
    log("     policy (keep, w/a bits): " + " ".join(
        f"{s.name}:{c.keep}/{c.w_bits}/{c.a_bits}"
        for s, c in zip(cm.specs, policy.cmps)
        if c.w_bits < 32 or (s.prune_dim and c.keep < s.prune_dim)))
    if any(n != want for n in per_step):
        raise AssertionError(f"K1 launches per QAT step {per_step}, not "
                             f"{want} each")
    return {"clean": clean, "before": before, "after": after,
            "k1_per_step": want, "search_s": t_search,
            "qat_ms": t_qat / q["steps"] * 1e3}


def train_qwen2_full(device) -> dict:
    """``make_train_step`` on qwen2-0.5b at full width (24 layers, d 896,
    vocab 151,936; seeded random weights, f32 params, bf16 compute) at
    B 8 x S 512 (the dense attention block, as the JAX model takes for
    S <= 512), raw and under a seeded pq policy (QAT): every gradient
    leaf finite and not all zero; 2 warm-up and 5 timed steps on one
    batch (ms per step, tokens/s, MFU, peak memory), K1 launches per QAT
    step equal to ``k1_calls``' count, the loss after the 5 steps below
    its first value."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.kernels import build
    from repro_torch.launch.inputs import model_flops
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    from repro_torch.optim.optimizer import (OptimizerConfig, adamw_init,
                                             tree_leaves)
    from repro_torch.train.train_step import (lm_loss, make_eval_step,
                                              make_train_step,
                                              value_and_grad)
    cfg = get_config("qwen2-0.5b")
    B, S = QWEN_TRAIN["batch"], QWEN_TRAIN["seq"]
    flops = model_flops(cfg, ShapeConfig("train_8x512", S, B, "train"))
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=1000)
    out = {}
    for name in ("raw", "qat"):
        release_cached_memory(device)
        torch.cuda.reset_peak_memory_stats(device)
        cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=device))
        params = cm.params
        batch = {"tokens": prefill_tokens(cfg, B, S, 5, device)}
        cspec = cm.build_cspec(seeded_policy(cm, 0)) if name == "qat" \
            else None
        del cm
        _, grads = value_and_grad(lambda p: lm_loss(cfg, p, batch, cspec),
                                  params)
        leaves = tree_leaves(grads)
        ok = torch.stack([torch.isfinite(g).all() & (g != 0).any()
                          for g in leaves])
        if not bool(ok.all()):
            raise AssertionError(f"{name}: {int((~ok).sum())} of "
                                 f"{len(leaves)} gradient leaves not finite "
                                 f"or all zero")
        del grads, leaves
        state = adamw_init(params, ocfg)
        step = make_train_step(cfg, ocfg, cspec=cspec)
        first = None
        for _ in range(QWEN_TRAIN["warmup"]):
            params, state, m = step(params, state, batch)
            first = float(m["loss"]) if first is None else first
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(QWEN_TRAIN["timed"]):
            params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / QWEN_TRAIN["timed"]
        k1 = build.LAUNCHES["fake_quant"] / QWEN_TRAIN["timed"]
        want = len(k1_calls(cfg, cspec, B * S))
        last = float(make_eval_step(cfg, cspec)(params, batch))
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        log(f"  e. {cfg.name} train step, {name}, {B} x {S} tokens: "
            f"{dt * 1e3:.2f} ms per step, {B * S / dt:.0f} tokens/s, MFU "
            f"{flops / dt / BF16_FLOPS:.1%} ({flops / 1e12:.2f} TFLOP a "
            f"step: model_flops in train mode, 3 x the forward), peak "
            f"{peak:.2f} GiB; loss {first:.4f} at step 1 -> {last:.4f} "
            f"after {QWEN_TRAIN['warmup'] + QWEN_TRAIN['timed']}; K1 "
            f"{k1:g} launches a step (k1_calls: {want}); {CARD}")
        if k1 != want or (name == "qat") != (want > 0) or not last < first:
            raise AssertionError(f"{name}: K1 {k1} a step for {want}, loss "
                                 f"{first} -> {last}")
        box = [params, state]

        def one():
            box[0], box[1], _ = step(box[0], box[1], batch)
        prof = profiled_steps(one, 1)
        log(f"     profiled: {prof['step_ms']:.2f} ms a step, device busy "
            f"{prof['busy_ms']:.2f} ms ({prof['busy_share']:.1%})")
        log_top(prof)
        del box
        out[name] = {"step_ms": dt * 1e3, "tokens_s": B * S / dt,
                     "mfu": flops / dt / BF16_FLOPS, "peak_gib": peak,
                     "loss": (first, last), "k1": k1}
        del params, state, step, batch, cspec
    release_cached_memory(device)
    return out


def training_phase(device) -> dict:
    """Phase 11, ``[training path]``: a-e of the module docstring. The
    CPU run of the LM trainer starts after b (the phase's own CPU work);
    ``out["cpu_lm"]`` is its process, for ``finish_cpu_lm_trainer`` after
    the qwen2 prefill."""
    from repro_torch.configs.testbed import LM_CFG
    t_phase = time.perf_counter()
    log(f"[training path] K1 under autograd; {LM_CFG.name} and ResNet18 "
        f"trained on the card; the search and a QAT retrain on the trained"
        f" LM; qwen2-0.5b's full-width train and QAT steps; {CARD}")
    out, seconds = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
    part("k1", check_k1_autograd, device)
    part("smoke", check_train_device_vs_cpu, device)
    out["cpu_lm"] = start_cpu_lm_trainer()
    part("lm", train_lm_testbed, device)
    part("resnet", train_resnet_testbed, device)
    part("pipeline", qat_pipeline, device, out["lm"].pop("params"),
         out["lm"].pop("val"))
    release_cached_memory(device)
    part("qwen2", train_qwen2_full, device)
    log(f"  {time.perf_counter() - t_phase:.1f} s for the training phase "
        f"(by part: {seconds})")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the trainer path (K6 / K7 / K8 under autograd, the launcher
# with its checkpoints and a resume, the other families, the example)
# ---------------------------------------------------------------------------

# The launcher on qwen2-0.5b at full width: global batch x sequence,
# steps, checkpoint cadence, and the step after which one StepTimeout is
# injected (the retry restores that step's checkpoint).
LAUNCH_TRAIN = dict(batch=4, seq=2048, steps=8, ckpt_every=4, fail_after=4)
# Token shards the launcher reads (``--data``): seeded uniform tokens.
LAUNCH_SHARDS = dict(files=2, tokens=1 << 20)
# The resumed run's losses at the steps after the restore against the
# uninterrupted run's (~12.4 each). A development run on the card found
# them bit-equal, as were two uninterrupted runs: no reduction on this
# path raced there (the embedding's backward sorts its indices; the CE's
# gather backward writes one element a position). The gate leaves room
# for a card or library whose reductions are not reproducible, where
# Adam turns last-bit gradient differences into fractions of a step.
RESUME_LOSS_TOL = 1e-3
MAMBA_TRAIN = dict(batch=4, seq=512, steps=4)
RG_TRAIN = dict(batch=2, seq=600)      # SMOKE widths: K6 past 512 tokens
# recurrentgemma-2b's SMOKE gradients, card against the CPU (f32): K6's
# online softmax and K7's chunked walk round the forward in other orders
# than the CPU's plain versions (~1e-6 of a value), and the backward
# recomputes the plain chain from inputs that carry that difference (a
# development run on the card found 6.6e-7).
RG_GRAD_TOL = 1e-5
# K6 / K7 / K8 under autograd: the gradient is the plain chain's,
# differentiated on the same card tensors. Bit-equal is expected (the
# same kernels on the same inputs); where a library kernel picks another
# algorithm between the two runs the gate is AUTOGRAD_REL_TOL of the
# largest gradient element.
AUTOGRAD_REL_TOL = 1e-6


def kernel_grad_calls(kind: str, extra):
    """(the public op, the plain chain its backward differentiates, the
    launch counter) of K6 ((causal, window)), K7 or K8 (chunk)."""
    from repro_torch.kernels import ops, ref
    if kind == "K6":
        causal, window = extra
        return (lambda q, k, v: ops.flash_attention(
            q, k, v, causal=causal, window=window),
            lambda q, k, v: ops._attention_plain(q, k, v, causal, window),
            "flash_attention")
    if kind == "K7":
        return ops.rglru_scan, ref.rglru_scan_ref, "rglru_scan"
    return (lambda *x: ops.ssd_scan(*x, chunk=extra),
            lambda *x: ref.ssd_chunked_ref(*x, extra), "ssd_scan")


def check_kernel_grad(kind: str, inputs, extra, what: str,
                      seed: int = 0) -> dict:
    """One kernel under autograd on card tensors: the forward bit-equal
    to the bare (no-grad) launch, one launch in the forward and none in
    the backward, and each input's gradient against autograd through the
    plain chain on the same tensors with the same upstream gradient
    (bit-equal, or within ``AUTOGRAD_REL_TOL``)."""
    import torch
    from repro_torch.kernels import build
    call, plain, counter = kernel_grad_calls(kind, extra)

    def tup(x):
        return x if isinstance(x, tuple) else (x,)
    with torch.no_grad():
        want = tup(call(*inputs))
    xs = [x.detach().requires_grad_(True) for x in inputs]
    device = inputs[0].device
    build.reset_launches()
    outs = tup(call(*xs))
    fwd = build.LAUNCHES[counter]
    gen = torch.Generator(device=inputs[0].device).manual_seed(seed)
    ups = [torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
           for o in outs]
    grads = torch.autograd.grad(outs, xs, ups, allow_unused=True)
    bwd = build.LAUNCHES[counter] - fwd
    # timed once more, warm (host clock, each part ended by a sync)
    _sync(device)
    t0 = time.perf_counter()
    again = tup(call(*xs))
    _sync(device)
    t_fwd = time.perf_counter() - t0
    torch.autograd.grad(again, xs, ups, allow_unused=True)
    _sync(device)
    t_bwd = time.perf_counter() - t0 - t_fwd
    del again
    ys = [x.detach().requires_grad_(True) for x in inputs]
    with torch.enable_grad():
        pouts = tup(plain(*ys))
    pgrads = torch.autograd.grad(pouts, ys, ups, allow_unused=True)
    fwd_equal = all(torch.equal(o.detach(), w) for o, w in zip(outs, want))
    equal, rel = True, 0.0
    for g, p in zip(grads, pgrads):
        if g is None or p is None:
            equal &= g is None and p is None
            continue
        equal &= torch.equal(g, p)
        scale = float(p.abs().max()) or 1.0
        rel = max(rel, float((g.float() - p.float()).abs().max()) / scale)
    shape = "x".join(str(s) for s in inputs[0].shape)
    log(f"  a. {kind} under autograd, {what} [{shape}] "
        f"{str(inputs[0].dtype).replace('torch.', '')}: forward "
        f"{'bit-equal' if fwd_equal else 'DIFFERS'} to the no-grad launch, "
        f"launches {fwd} forward / {bwd} backward; gradients "
        f"{'bit-equal' if equal else f'max rel {rel:.3g}'} against the "
        f"plain chain's; warm: {t_fwd * 1e3:.2f} ms forward, "
        f"{t_bwd * 1e3:.2f} ms backward (the plain chain recomputed and "
        f"differentiated)")
    if not fwd_equal or fwd != 1 or bwd != 0 or (
            not equal and rel > AUTOGRAD_REL_TOL):
        raise AssertionError(f"{kind} under autograd at {what}: forward "
                             f"equal {fwd_equal}, launches {fwd}/{bwd}, "
                             f"gradients rel {rel}")
    return {"equal": equal, "rel": rel, "fwd_ms": t_fwd * 1e3,
            "bwd_ms": t_bwd * 1e3}


def kernel_grad_cases(device) -> list:
    """(kind, inputs, extra, what) at the JAX tests' shapes: K6 f32 (2,
    128, 4 over 4, 32) causal and (2, 200, 8 over 2, 16) with a window
    of 96, bf16 (1, 128, 4 over 2, 32); K7 (2, 64, 96) and (2, 32, 64)
    with h0; K8 (2, 64, 4, 16, 8) at chunk 16 and (1, 128, 2, 32, 16) at
    32."""
    import numpy as np
    import torch
    cases = []
    for (B, S, H, KV, D), dtype, mask in (
            ((2, 128, 4, 4, 32), torch.float32, (True, 0)),
            ((2, 200, 8, 2, 16), torch.float32, (True, 96)),
            ((1, 128, 4, 2, 32), torch.bfloat16, (True, 0))):
        rng = np.random.default_rng(B * S + D)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(device, dtype)
            for s in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))
        cases.append(("K6", [q, k, v], mask, "the JAX tests' shape"))
    for (B, S, C), h0 in (((2, 64, 96), False), ((2, 32, 64), True)):
        a, b, h = lru_case(S, B, S, C, (0.4, 0.99), device, h0)
        cases.append(("K7", [a, b] + ([h] if h0 else []), None,
                      "the JAX tests' shape" + (", h0" if h0 else "")))
    for shape, chunk in (((2, 64, 4, 16, 8), 16), ((1, 128, 2, 32, 16), 32)):
        cases.append(("K8", ssd_case(chunk, *shape, 0.5, device), chunk,
                      f"the JAX tests' shape, chunk {chunk}"))
    return cases


def layer0_inputs(name: str, batch: int, seq: int, device):
    """Layer 0's kernel inputs at full width from the seeded init, the
    model cut to one layer (the init draws the embedding, then the layers
    in order, so layer 0's weights are the full model's): qwen2-0.5b's
    q, k, v as [B,H,S,D] views (the layout K6 is handed), mamba2-780m's
    (xh_dt, dA, B, C), recurrentgemma-2b's (a, b)."""
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    cfg = get_config(name).replace(num_layers=1)
    params = M.init(cfg, seed=0, device=device)
    toks = prefill_tokens(cfg, batch, seq, 9, device)
    if name == "qwen2-0.5b":
        return [x.transpose(1, 2) for x in layer_qkv(cfg, params, toks)]
    if name == "mamba2-780m":
        return list(layer_ssd_inputs(cfg, params, toks)), cfg.ssm.chunk_size
    return list(layer_rglru_inputs(cfg, params, toks))


def check_autograd_kernels(device) -> dict:
    """Part a: K6, K7 and K8 under autograd at the JAX tests' shapes and
    at one full-width layer at training length."""
    import torch
    out = {}
    for kind, xs, extra, what in kernel_grad_cases(device):
        out[f"{kind} {what}"] = check_kernel_grad(kind, xs, extra, what)
    B, S = LAUNCH_TRAIN["batch"], LAUNCH_TRAIN["seq"]
    out["K6 qwen2"] = check_kernel_grad(
        "K6", layer0_inputs("qwen2-0.5b", B, S, device), (True, 0),
        f"qwen2-0.5b layer 0 at {B} x {S}")
    xs, chunk = layer0_inputs("mamba2-780m", MAMBA_TRAIN["batch"],
                              MAMBA_TRAIN["seq"], device)
    from repro_torch.kernels.ssd_scan import route
    if route(xs[0].shape[-1], xs[2].shape[-1], chunk) != "tc":
        raise AssertionError("mamba2's layer 0 left K8's tensor-core route")
    out["K8 mamba2"] = check_kernel_grad(
        "K8", xs, chunk, f"mamba2-780m layer 0 at {MAMBA_TRAIN['batch']} x "
        f"{MAMBA_TRAIN['seq']}, chunk {chunk}, route tc")
    out["K7 recurrentgemma"] = check_kernel_grad(
        "K7", layer0_inputs("recurrentgemma-2b", 1, 2048, device), None,
        "recurrentgemma-2b layer 0 at 1 x 2048")
    release_cached_memory(device)
    return out


def write_token_shards(directory: str, vocab: int) -> None:
    """``LAUNCH_SHARDS`` seeded uniform uint32 token shards (``*.npy``),
    the launcher's ``--data``: the synthetic bigram source would build a
    vocab x vocab table, 185 GB at qwen2's vocab of 151,936."""
    import numpy as np
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(17)
    for i in range(LAUNCH_SHARDS["files"]):
        np.save(os.path.join(directory, f"shard{i}.npy"),
                rng.integers(0, vocab, LAUNCH_SHARDS["tokens"], np.uint32))


@contextlib.contextmanager
def trainer_probes(fail_after=None):
    """Patches for one launcher run: stamps of each ``StepMonitor.record``
    (the host clock after a step is queued; with the loss read back each
    step, consecutive stamps are one whole step apart), one injected
    ``StepTimeout`` after step ``fail_after``, and the seconds of each
    checkpoint's snapshot (the host copy ``AsyncCheckpointer.save``
    waits for), write (the thread) and restore."""
    from repro_torch.checkpoint import checkpointing as C
    from repro_torch.distributed.fault_tolerance import StepTimeout
    from repro_torch.train import trainer as TT
    rec = {"stamps": [], "fired": [], "snapshot_s": [], "write_s": [],
           "restore_s": [], "dirs": []}
    base, save, snap, restore = (TT.StepMonitor, C.save,
                                 C.AsyncCheckpointer.save, C.restore)

    class Monitor(base):
        def record(self, step, dt):
            rec["stamps"].append((step, time.perf_counter()))
            if step == (fail_after or 0) + 1 and fail_after \
                    and not rec["fired"]:
                rec["fired"].append(step)
                raise StepTimeout(f"injected after step {fail_after}")
            super().record(step, dt)

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec[key].append(time.perf_counter() - t0)
            if key == "write_s":
                rec["dirs"].append(os.path.join(a[0], f"step_{a[1]}"))
            return out
        return run
    TT.StepMonitor = Monitor
    C.save = timed("write_s", save)
    C.AsyncCheckpointer.save = timed("snapshot_s", snap)
    C.restore = timed("restore_s", restore)
    try:
        yield rec
    finally:
        TT.StepMonitor, C.save = base, save
        C.AsyncCheckpointer.save, C.restore = snap, restore


def step_ms(stamps) -> float:
    """Median ms between consecutive steps' stamps of one attempt, the
    first two steps (allocations, library handles) left out."""
    gaps = [(t1 - t0) * 1e3 for (s0, t0), (s1, t1) in zip(stamps, stamps[1:])
            if s1 == s0 + 1 and s0 >= 2]
    return sorted(gaps)[len(gaps) // 2]


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def profile_train_step(cfg, batch: int, seq: int, device) -> dict:
    """Where the launcher's step goes: ``make_train_step`` (what
    ``Trainer`` runs) on ``cfg``'s seeded init at ``batch`` x ``seq``, two
    warm-up steps, one timed (host clock ended by a sync) and one under
    ``torch.profiler`` (device activity only: recording the host's ops
    too cost ~40 s for this step's ~21,600 kernels) with CUDA events
    around each call of K6's backward: the device's busy share, the
    device ms those calls span (the chunked plain chain recomputed and
    differentiated) beside K6's forward kernel, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    release_cached_memory(device)
    params = M.init(cfg, seed=0, device=device)
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=8)
    box = [params, adamw_init(params, ocfg)]
    step = make_train_step(cfg, ocfg)
    toks = {"tokens": prefill_tokens(cfg, batch, seq, 23, device)}

    def one():
        box[0], box[1], _ = step(box[0], box[1], toks)
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    backward, spans = ops._FlashAttention.backward, []

    def timed(ctx, g):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = backward(ctx, g)
        ev[1].record()
        spans.append(ev)
        return out
    ops._FlashAttention.backward = staticmethod(timed)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
    finally:
        ops._FlashAttention.backward = staticmethod(backward)
    rows = [(getattr(ev, "self_device_time_total", 0.0) * 1e-3, ev.key,
             ev.count) for ev in prof.key_averages()
            if getattr(ev, "device_type", None) is not None
            and "CUDA" in str(ev.device_type)]
    busy = sum(t for t, _, _ in rows)
    del box
    release_cached_memory(device)
    return {"step_ms": wall * 1e3, "busy_ms": busy,
            "busy_share": busy / (wall * 1e3),
            "attn_bwd_ms": sum(a.elapsed_time(b) for a, b in spans),
            "attn_bwd_calls": len(spans),
            "k6_ms": sum(t for t, key, _ in rows if "flash_attention" in key),
            "kernels": sum(n for *_, n in rows),
            "top": sorted(rows, reverse=True)[:6]}


def launcher_qwen2(device) -> dict:
    """Part b: ``launch.train.main`` on qwen2-0.5b at full width,
    ``LAUNCH_TRAIN``'s batch x sequence (K6 on every layer, 24 launches a
    forward, none in the backward) over seeded token shards, first
    uninterrupted with no checkpoint directory, then with ``--ckpt-every
    4`` and one ``StepTimeout`` injected after step 4: the retry restores
    step 4 and its losses at steps 5-8 are the uninterrupted run's within
    ``RESUME_LOSS_TOL``."""
    import shutil
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch import train as LT
    from repro_torch.launch.inputs import model_flops
    from repro_torch.models.registry import get_config
    arch = "qwen2-0.5b"
    cfg = get_config(arch)
    L = LAUNCH_TRAIN
    work = os.path.join(ROOT, "build", "trainer_path")
    shards, ckpt = os.path.join(work, "tokens"), os.path.join(work, "ckpt")
    shutil.rmtree(work, ignore_errors=True)
    write_token_shards(shards, cfg.vocab_size)
    argv = ["--arch", arch, "--steps", str(L["steps"]), "--global-batch",
            str(L["batch"]), "--seq-len", str(L["seq"]), "--data", shards,
            "--device", str(device)]
    flops = model_flops(cfg, ShapeConfig("train_4x2048", L["seq"],
                                         L["batch"], "train"))
    try:
        release_cached_memory(device)
        torch.cuda.reset_peak_memory_stats(device)
        build.reset_launches()
        with trainer_probes() as rec:
            plain = LT.main(argv)
        k6 = (build.LAUNCHES["flash_attention"],
              build.LAUNCHES["flash_attention_tc"])
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        ms = step_ms(rec["stamps"])
        want_k6 = cfg.num_layers * L["steps"]
        log(f"  b. launch.train on {cfg.name} at full width, {L['batch']} x "
            f"{L['seq']} tokens, {L['steps']} steps, no checkpoints: "
            f"{ms:.2f} ms per step (median of steps 3-{L['steps']}, the "
            f"loss read back each step), {L['batch'] * L['seq'] / ms * 1e3:.0f}"
            f" tokens/s, MFU {flops / (ms * 1e-3) / BF16_FLOPS:.1%} "
            f"({flops / 1e12:.2f} TFLOP a step: model_flops in train mode), "
            f"peak {peak:.2f} GiB; K6 {k6[0]} launches ({k6[1]} on the "
            f"tensor-core route) for {L['steps']} forwards of "
            f"{cfg.num_layers} layers; losses "
            + " ".join(f"{r['loss']:.4f}" for r in plain["history"])
            + f"; {CARD}")
        if k6 != (want_k6, want_k6):
            raise AssertionError(f"K6 launched {k6} times, not "
                                 f"{cfg.num_layers} per forward")
        del plain["trainer"]
        release_cached_memory(device)
        build.reset_launches()
        with trainer_probes(L["fail_after"]) as res:
            out = LT.main(argv + ["--ckpt-dir", ckpt, "--ckpt-every",
                                  str(L["ckpt_every"])])
        k6r = build.LAUNCHES["flash_attention"]
        sizes = [dir_bytes(d) for d in res["dirs"] if os.path.isdir(d)]
        want = {r["step"]: r["loss"] for r in plain["history"]}
        got = {r["step"]: r["loss"] for r in out["history"]}
        diff = max(abs(got[s] - want[s]) for s in got)
        log(f"  b. the same with --ckpt-every {L['ckpt_every']} and a "
            f"StepTimeout injected after step {L['fail_after']}: "
            f"{out['attempts']} attempts, resumed at step "
            f"{out['trainer'].step - len(got)}; losses at steps "
            f"{sorted(got)}: " + " ".join(f"{got[s]:.4f}" for s in sorted(got))
            + f", {diff:.3g} from the uninterrupted run's (tol "
            f"{RESUME_LOSS_TOL}); checkpoints: snapshot "
            + ", ".join(f"{t:.2f}" for t in res["snapshot_s"]) + " s, write "
            + ", ".join(f"{t:.2f}" for t in res["write_s"]) + " s, "
            + ", ".join(f"{b / 1e9:.3f}" for b in sizes) + " GB, restore "
            + ", ".join(f"{t:.2f}" for t in res["restore_s"])
            + f" s; K6 {k6r} launches")
        if res["fired"] != [L["fail_after"] + 1] or out["attempts"] != 2 \
                or sorted(got) != list(range(L["fail_after"] + 1,
                                             L["steps"] + 1)) \
                or diff > RESUME_LOSS_TOL \
                or k6r != cfg.num_layers * (L["steps"] + 1):
            raise AssertionError(f"the resumed run: fired {res['fired']}, "
                                 f"attempts {out['attempts']}, losses {got} "
                                 f"vs {want}, K6 {k6r}")
        del out
        prof = profile_train_step(cfg, L["batch"], L["seq"], device)
        log(f"  b. one train step of the launcher's profiled: "
            f"{prof['step_ms']:.2f} ms unprofiled, device busy "
            f"{prof['busy_ms']:.2f} ms ({prof['busy_share']:.1%}); K6's "
            f"backward (the chunked plain chain) spans "
            f"{prof['attn_bwd_ms']:.2f} ms of the device's time over its "
            f"{prof['attn_bwd_calls']} calls, K6's forward kernel "
            f"{prof['k6_ms']:.2f} ms")
        log_top(prof)
        return {"step_ms": ms, "tokens_s": L["batch"] * L["seq"] / ms * 1e3,
                "mfu": flops / (ms * 1e-3) / BF16_FLOPS, "peak_gib": peak,
                "k6": k6[0] + k6r, "resume_diff": diff,
                "snapshot_s": res["snapshot_s"], "write_s": res["write_s"],
                "restore_s": res["restore_s"], "ckpt_bytes": sizes,
                "profile": prof}
    finally:
        shutil.rmtree(work, ignore_errors=True)
        release_cached_memory(device)


def trainer_mamba2(device) -> dict:
    """Part c: ``Trainer`` on mamba2-780m at full width (48 SSD layers,
    seeded weights), ``MAMBA_TRAIN``'s steps on one seeded batch: every
    gradient leaf finite, K8 48 launches a forward and none in the
    backward (all on the tensor-core route), the loss finite and falling;
    ms per step and peak memory."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models.registry import get_config
    from repro_torch.optim.optimizer import OptimizerConfig, tree_leaves
    from repro_torch.train.train_step import lm_loss, value_and_grad
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_config("mamba2-780m")
    B, S, n = MAMBA_TRAIN["batch"], MAMBA_TRAIN["seq"], MAMBA_TRAIN["steps"]
    release_cached_memory(device)
    torch.cuda.reset_peak_memory_stats(device)
    batch = {"tokens": prefill_tokens(cfg, B, S, 21, device)}
    with trainer_probes() as rec:
        tr = Trainer(cfg, OptimizerConfig(lr=3e-4, warmup_steps=2,
                                          total_steps=1000),
                     TrainerConfig(total_steps=n, log_every=1), seed=0,
                     device=device)
        build.reset_launches()
        _, grads = value_and_grad(lambda p: lm_loss(cfg, p, batch),
                                  tr.params)
        bad = sum(not bool(torch.isfinite(g).all())
                  for g in tree_leaves(grads))
        k8_grad = build.LAUNCHES["ssd_scan"]
        del grads
        build.reset_launches()
        hist = tr.fit(iter([batch] * (n + 1)))
    k8 = (build.LAUNCHES["ssd_scan"], build.LAUNCHES["ssd_scan_tc"])
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    stamps = rec["stamps"]
    ms = (stamps[-1][1] - stamps[1][1]) / (len(stamps) - 2) * 1e3
    losses = [r["loss"] for r in hist]
    log(f"  c. Trainer on {cfg.name} at full width ({cfg.num_layers} SSD "
        f"layers), {B} x {S} tokens, {n} steps on one batch: {ms:.2f} ms "
        f"per step (steps 3-{n}), peak {peak:.2f} GiB; losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; gradient leaves not finite: {bad}; K8 {k8_grad} launches in a "
        f"value_and_grad, {k8[0]} in {n} steps ({k8[1]} on the tensor-core "
        f"route); {CARD}")
    if bad or k8_grad != cfg.num_layers or k8 != (cfg.num_layers * n,) * 2 \
            or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"mamba2 training: {bad} bad leaves, K8 "
                             f"{k8_grad}/{k8}, losses {losses}")
    del tr
    release_cached_memory(device)
    return {"step_ms": ms, "peak_gib": peak, "losses": losses,
            "k8": k8[0] + k8_grad}


def train_rg_device_vs_cpu(device) -> dict:
    """Part c: recurrentgemma-2b at its SMOKE widths in f32 (3 layers:
    two RG-LRU, one local attention), ``RG_TRAIN``'s tokens (K6 past 512
    positions), the same seeded params and batch on the card and on the
    CPU: the loss within 1e-5, every gradient leaf within
    ``RG_GRAD_TOL``, K7 2 and K6 1 launches in the card's forward and
    none in its backward."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    from repro_torch.train.train_step import lm_loss, value_and_grad
    cfg = get_config("recurrentgemma-2b", smoke=True).replace(
        compute_dtype="float32")
    host = M.init(cfg, 0, "cpu")
    toks = prefill_tokens(cfg, RG_TRAIN["batch"], RG_TRAIN["seq"], 4, "cpu")
    want = value_and_grad(lambda p: lm_loss(cfg, p, {"tokens": toks}), host)
    dev = _to(host, device)
    build.reset_launches()
    got = value_and_grad(lambda p: lm_loss(
        cfg, p, {"tokens": toks.to(device)}), dev)
    launches = {k: build.LAUNCHES[k] for k in ("rglru_scan",
                                               "flash_attention")}
    kinds = cfg.layer_kinds
    d_loss = abs(float(want[0]) - float(got[0]))
    d_grad = _max_leaf_diff(want[1], got[1])
    log(f"  c. {cfg.name} f32, {RG_TRAIN['batch']} x {RG_TRAIN['seq']} "
        f"tokens, card against the CPU: loss {d_loss:.3g} apart (tol 1e-5), "
        f"gradients {d_grad:.3g} (tol {RG_GRAD_TOL}); launches {launches}")
    if d_loss > 1e-5 or d_grad > RG_GRAD_TOL or launches != {
            "rglru_scan": kinds.count("rglru"),
            "flash_attention": kinds.count("attn")}:
        raise AssertionError(f"recurrentgemma SMOKE training: loss "
                             f"{d_loss}, gradients {d_grad}, {launches}")
    return {"loss": d_loss, "grad": d_grad, **launches}


def run_example(device) -> dict:
    """Part d: ``examples/train_compress_serve_torch.py`` at its default
    200 steps on the card (its four stage lines print here): the
    training loss falls, the served tokens come back in the vocabulary."""
    import importlib.util
    import shutil
    from repro_torch.kernels import build
    path = os.path.join(ROOT, "examples", "train_compress_serve_torch.py")
    spec = importlib.util.spec_from_file_location("e2e_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    build.reset_launches()
    t0 = time.perf_counter()
    out = mod.main(["--device", str(device)])
    seconds = time.perf_counter() - t0
    shutil.rmtree(out["ckpt_dir"], ignore_errors=True)
    losses = [r["loss"] for r in out["history"]]
    toks = out["tokens"]
    ok = (losses[-1] < losses[0]
          and tuple(toks.shape) == (4, out["serve_steps"] + 1)
          and 0 <= int(toks.min()) and int(toks.max()) < out["vocab"])
    log(f"  d. the example: {seconds:.1f} s; logged losses "
        + " ".join(f"{x:.4f}" for x in losses)
        + f"; served tokens {tuple(toks.shape)}; QAT accuracy "
        f"{out['qat_accuracy']:.4f} (clean {out['ref_accuracy']:.4f}); "
        f"launches {dict((k, v) for k, v in build.LAUNCHES.items() if v)}")
    if not ok:
        raise AssertionError(f"the example: losses {losses}, tokens "
                             f"{tuple(toks.shape)}")
    return {"seconds": seconds, "losses": losses}


def trainer_phase(device) -> dict:
    """Phase 12, ``[trainer path]``: a-d of the module docstring."""
    t_phase = time.perf_counter()
    log(f"[trainer path] K6 / K7 / K8 under autograd; launch.train on "
        f"qwen2-0.5b at full width with a checkpoint and a resume; "
        f"mamba2-780m through Trainer; recurrentgemma-2b card vs CPU; the "
        f"end-to-end example; {CARD}")
    out, seconds = {}, {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
    part("autograd", check_autograd_kernels, device)
    part("launcher", launcher_qwen2, device)
    part("mamba2", trainer_mamba2, device)
    part("recurrentgemma", train_rg_device_vs_cpu, device)
    part("example", run_example, device)
    log(f"  {time.perf_counter() - t_phase:.1f} s for the trainer phase "
        f"(by part: {seconds})")
    return out


# ---------------------------------------------------------------------------
# Phases 13 and 14: prefill and decode of qwen2-0.5b
# ---------------------------------------------------------------------------

def seeded_policy(cm, seed: int):
    """A legalized pq policy from seeded numpy actions, as one search
    episode maps them (``map_actions`` legalizes)."""
    import numpy as np
    from repro_torch.core.policy import Policy, map_actions
    rng = np.random.default_rng(seed)
    pol = Policy.reference(cm.specs)
    for i, s in enumerate(cm.specs):
        pol.cmps[i] = map_actions(s, rng.random(3).astype(np.float32), "pq")
    return pol


def frontend_request(cfg, batch: int, seq: int, seed: int, device):
    """(tokens, embeds) of a seeded prefill request: tokens [batch, seq]
    for a decoder (``prefill_tokens``; none for an audio encoder) and a
    stub frontend's embeddings, standard normal from a numpy seed, in the
    compute dtype: an audio encoder's frames [batch, seq, d], a VLM's
    patches [batch, frontend_len, d] (none without a frontend)."""
    import numpy as np
    import torch
    tokens = None if cfg.frontend == "audio_stub" else \
        prefill_tokens(cfg, batch, seq, seed, device)
    n = {"audio_stub": seq, "vision_stub": cfg.frontend_len}.get(
        cfg.frontend, 0)
    embeds = torch.as_tensor(np.random.default_rng(seed + 1000)
                             .standard_normal((batch, n, cfg.d_model),
                                              dtype=np.float32),
                             device=device).to(
        getattr(torch, cfg.compute_dtype)) if n else None
    return tokens, embeds


def prefill_tokens(cfg, batch: int, seq: int, seed: int, device):
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, seq))
    return torch.as_tensor(toks, dtype=torch.int64, device=device)


def layer_input(cfg, params, tokens, kind: str, embeds=None):
    """(index, its params, input x, positions) of the first layer of
    ``kind`` in the uncompressed forward: the embedding (or a frontend's
    ``embeds``), then every earlier layer."""
    import torch
    from repro_torch.models import model as M
    i = cfg.layer_kinds.index(kind)
    with torch.no_grad():
        x = M._embed_inputs(cfg, params, tokens, None, embeds)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        for j in range(i):
            x = M._apply_block(cfg.layer_kinds[j], params["blocks"][j], x,
                               cfg, None, pos)
    return i, params["blocks"][i], x, pos


def layer_qkv(cfg, params, tokens, embeds=None):
    """q, k, v [B,S,H,D] / [B,S,KV,D] as the first attention layer of the
    uncompressed forward hands them to the attention: its input, its
    input norm, then ``blocks._qkv_rope``, which ``apply_attention``
    calls."""
    import torch
    from repro_torch.models import blocks as MB
    from repro_torch.models import layers as ML
    _, p, x, pos = layer_input(cfg, params, tokens, "attn", embeds)
    with torch.no_grad():
        h = ML.apply_norm(cfg.norm, p["attn_norm"], x)
        return MB._qkv_rope(p["attn"], h, cfg, None, pos)


def layer_rglru_inputs(cfg, params, tokens):
    """(a, b) as the first RG-LRU layer of the uncompressed forward hands
    them to K7: its input, its ``mix_norm``, then ``blocks.rglru_inputs``,
    which ``apply_rglru`` calls."""
    import torch
    from repro_torch.models import blocks as MB
    from repro_torch.models import layers as ML
    _, p, x, _ = layer_input(cfg, params, tokens, "rglru")
    with torch.no_grad():
        h = ML.apply_norm(cfg.norm, p["mix_norm"], x)
        return MB.rglru_inputs(p["rglru"], h, cfg, None)[0]


def check_flash_attention_prefill(q, k, v, window: int = 0,
                                  causal: bool = True) -> dict:
    """K6 at the prefill shape on one layer's q/k/v (causal or not,
    ``window`` keys when > 0) against the chunked plain branch (the
    dense plain version would need S² scores): bf16's atol 0.04 and each
    row within ``K6_CHUNKED_ROW_TOL``; its last ``K6_TAIL_ROWS`` rows
    also against the dense plain version (``attention_tail_ref``) within
    ``K6_ROW_TOL``. Timed beside the plain branch and SDPA (with a
    window: the window as a boolean mask, ``sdpa_window``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as ML
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got, path = k6_launch(lambda: ops.flash_attention(
        qt, kt, vt, causal=causal, window=window), q.dtype, q.shape[-1])
    tail = row_rel_err(got[:, :, -K6_TAIL_ROWS:], attention_tail_ref(
        qt, kt, vt, K6_TAIL_ROWS, window, causal))
    got = got.transpose(1, 2)
    # the check's own call of the plain branch is its timing (one call of
    # seconds; a second would only repeat it)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    want = ML.attention_chunked(q, k, v, causal=causal, window=window)
    t1.record()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    rel = row_rel_err(got, want)
    del want, got
    B, S, H, D = q.shape
    log(f"  flash_attention {(B, H, k.shape[2], S, D)} "
        f"{str(q.dtype)[6:]} {'causal' if causal else 'bidirectional'}, "
        f"window {window}, route {path}, the first attention layer's "
        f"q/k/v: max |kernel - "
        f"chunked plain| {err:.3g} (tol 0.04), max row rel {rel:.3g} (tol "
        f"{K6_CHUNKED_ROW_TOL:.3g}); last {K6_TAIL_ROWS} rows vs the dense "
        f"plain version: max row rel {tail:.3g} (tol {K6_ROW_TOL:.3g})")
    if not (err <= 0.04 and rel <= K6_CHUNKED_ROW_TOL
            and tail <= K6_ROW_TOL):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"versions: {err}, {rel}, {tail}")
    return time_flash_attention(qt, kt, vt, window, causal, dict(
        max_abs_err=err, tolerance=0.04, row_rel_err=rel,
        tail_row_rel_err=tail, route=path), t0.elapsed_time(t1))


def time_flash_attention(qt, kt, vt, window: int, causal: bool, row: dict,
                         plain: float) -> dict:
    """K6 on qt [B,H,S,D], kt, vt [B,KV,S,D] timed (CUDA events) beside
    SDPA (with a window: the window as a boolean mask, ``sdpa_window``)
    and its bound; ``row`` (the errors) and ``plain`` (the plain
    branch's ms) completed into a kernels-line row."""
    from repro_torch.kernels import ops
    B, H, S, D = qt.shape
    KV = kt.shape[1]
    ms, paced = cuda_ms(lambda: ops.flash_attention(
        qt, kt, vt, causal=causal, window=window), 3, 1)
    lib, _ = cuda_ms(sdpa_window(qt, kt, vt, window) if window else
                     (lambda: sdpa(qt, kt, vt, causal)), 5, 2)
    n_bytes, n_ops = attention_work(B, H, KV, S, D, 2, causal=causal,
                                    window=window)
    bound, by = bound_ms(n_bytes, n_ops, BF16_FLOPS)
    log(f"    {CARD}: {ms:.3f} ms kernel ({n_ops / ms / 1e9:.1f} TFLOP/s), "
        f"{plain:.3f} ms chunked plain, {lib:.3f} ms SDPA"
        f"{' (boolean window mask)' if window else ''}, bound {bound:.4f} "
        f"ms ({by})")
    return dict(row, shape=[B, H, KV, S, D]
                + ([window] if window else []), ms=ms, paced_ms=paced,
                plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                tflops=n_ops / ms / 1e9)


def check_rglru_prefill(a, b) -> dict:
    """K7 at the prefill shape on one layer's (a, b) against the
    sequential plain version: each (token, 256-channel) row within
    ``K7_ROW_TOL`` (the worst row's place printed). Timed beside the
    plain version (a few calls: it walks the tokens from the host) and
    the bound."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rglru_scan import CHUNK, plan
    got = ops.rglru_scan(a, b)
    want = ref.rglru_scan_ref(a, b)
    e = rglru_errors(got, want)
    three = torch.equal(got, k7_three_pass(a, b))
    del got, want
    B, S, C = a.shape
    p = plan(B, S, C, CHUNK, a.element_size())
    log(f"  rglru_scan {(B, S, C)}, the first RG-LRU layer's (a, b) (a in "
        f"[{float(a.min()):.4f}, {float(a.max()):.4f}]) vs the sequential "
        f"plain version: max abs {e['abs']:.3g}, max row rel {e['row']:.3g}"
        f" (tol {K7_ROW_TOL:.3g}; at token {e['row_at'][1]}, chunk "
        f"{e['row_at'][1] // CHUNK}, channels {e['row_at'][2] * K7_BLOCK}.."
        f"{(e['row_at'][2] + 1) * K7_BLOCK - 1}, row norm "
        f"{e['row_norm']:.3g}; min row norm {e['min_norm']:.3g}); "
        f"bit-equal to the three-pass kernel {three}; one launch of "
        f"{p.tiles} tiles ({p.n_chunks} chunks of {CHUNK} x {p.n_slabs} "
        f"slabs of {p.slab} channels, {p.smem_bytes} bytes each)")
    if e["row"] > K7_ROW_TOL or not three:
        raise AssertionError(f"rglru_scan disagrees with its plain version "
                             f"or the three-pass kernel at the prefill "
                             f"shape: {e}, three-pass equal {three}")
    ms, paced = cuda_ms(lambda: ops.rglru_scan(a, b), 10, 2)
    plain, _ = cuda_ms(lambda: ref.rglru_scan_ref(a, b), 1, 1)
    n_bytes, n_ops = rglru_work(B, S, C)
    bound, by = bound_ms(n_bytes, n_ops)
    log(f"    {CARD}: {ms:.4f} ms kernel ({n_bytes / ms / 1e6:.0f} GB/s of "
        f"the bound's bytes), {plain:.1f} ms plain (sequential), bound "
        f"{bound:.4f} ms ({by})")
    return dict(shape=[B, S, C], ms=ms, paced_ms=paced, plain_ms=plain,
                library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=e["abs"], tolerance=K7_ROW_TOL,
                row_rel_err=e["row"])


def layer_ssd_inputs(cfg, params, tokens):
    """(xh_dt, dA, Bm, Cm) as the first SSM layer of the uncompressed
    forward hands them to K8: its input, its input norm, then
    ``blocks.ssd_inputs``, which ``apply_ssm`` calls."""
    import torch
    from repro_torch.models import blocks as MB
    from repro_torch.models import layers as ML
    _, p, x, _ = layer_input(cfg, params, tokens, "ssm")
    with torch.no_grad():
        h = ML.apply_norm(cfg.norm, p["norm"], x)
        return MB.ssd_inputs(p["ssm"], h, cfg, None, None)[0]


def check_ssd_prefill(xh, dA, Bm, Cm, chunk: int) -> dict:
    """K8 at the prefill shape on layer 0's inputs against the chunked
    plain branch (the sequential reference parts from both by the
    cancellation in the init's steep decays): each (token, head) row of
    y and each row of the final state within ``K8_ROW_TOL``, the final
    state within 2e-4 (atol and rtol). Timed beside the plain branch and
    the bound."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import route
    y, fin = ops.ssd_scan(xh, dA, Bm, Cm, chunk=chunk)
    wy, wf = ref.ssd_chunked_ref(xh, dA, Bm, Cm, chunk)
    ey, ef = ssd_errors(y, wy), ssd_errors(fin, wf)
    close = torch.allclose(fin, wf, K8_TOL, K8_TOL)
    del wy, wf, y, fin
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    path = route(P, N, chunk)
    log(f"  ssd_scan {(B, S, H, P, N)} chunk {chunk} route {path}, layer "
        f"0's inputs "
        f"(dA in [{float(dA.min()):.3g}, {float(dA.max()):.3g}]) vs the "
        f"chunked plain branch: y max abs {ey['abs']:.3g}, max row rel "
        f"{ey['row']:.3g} (tol {K8_ROW_TOL:.3g}; at token "
        f"{ey['row_at'][1]}, offset {ey['row_at'][1] % chunk} in its chunk,"
        f" head {ey['row_at'][2]}, row norm {ey['row_norm']:.3g}; min row "
        f"norm {ey['min_norm']:.3g}); final state max abs {ef['abs']:.3g}, "
        f"max row rel {ef['row']:.3g}, allclose 2e-4 {close}")
    if not (ey["row"] <= K8_ROW_TOL and ef["row"] <= K8_ROW_TOL and close):
        raise AssertionError(f"ssd_scan disagrees with the chunked plain "
                             f"branch at the prefill shape: {ey}, {ef}")
    ms, paced = cuda_ms(lambda: ops.ssd_scan(xh, dA, Bm, Cm, chunk=chunk),
                        5, 1)
    plain, _ = cuda_ms(lambda: ref.ssd_chunked_ref(xh, dA, Bm, Cm, chunk),
                       1, 1)
    n_bytes, n_ops = ssd_work(B, S, H, P, N, chunk)
    bound, by = bound_ms(n_bytes, n_ops)
    tc_bound, tc_by = bound_ms(n_bytes, 3 * n_ops, TF32_FLOPS)
    log(f"    route {path}, {CARD}: {ms:.3f} ms kernel ({n_ops / ms / 1e9:.2f}"
        f" TFLOP/s), {plain:.3f} ms chunked plain, bound {bound:.4f} ms f32 "
        f"({by}), {tc_bound:.4f} ms split TF32 ({tc_by})")
    passes = kernel_times_us(
        lambda: ops.ssd_scan(xh, dA, Bm, Cm, chunk=chunk), 3)
    log("    its kernels (profiler, us per launch): " + (", ".join(
        f"{k} {v:.1f}" for k, v in passes.items()) or "not measured (the "
        "profiler recorded no device time)"))
    return dict(shape=[B, S, H, P, N, chunk], ms=ms, paced_ms=paced,
                plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by,
                tc_bound_ms=tc_bound, max_abs_err=max(ey["abs"], ef["abs"]),
                tolerance=K8_ROW_TOL, row_rel_err=max(ey["row"], ef["row"]),
                route=path, passes_us=passes)


def device_kernels(prof) -> list:
    """The name of every kernel a ``torch.profiler`` run recorded on the
    card, once per launch. The profiler may miss launches (a CUDA-only
    run after a CPU and CUDA one has recorded none), so a count read here
    bounds from below."""
    return [e.key for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", None))
            for _ in range(e.count)]


def kernel_times_us(fn, calls: int) -> dict:
    """Device time per launch of each kernel that ``fn`` launches, by
    kernel name (template arguments and parameters cut), from the
    profiler over ``calls`` calls, averaged over the launches it
    recorded of each; empty when it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if t > 0:
            name = re.sub(r"^void |[<(].*$", "", e.key)
            total[name] = total.get(name, 0.0) + t
            count[name] = count.get(name, 0) + e.count
    return {k: total[k] / count[k] for k in total}


def prefill_launches(cfg, cspec, seq: int) -> dict:
    """The launches one prefill forward over ``seq`` tokens must make on
    the card: K6 once per attention layer (its chunked branch), all of
    them on the tensor-core route where ``route`` gives it the config's
    compute dtype and head dim (bf16 at 64, 80, 128, 256), K8 once per SSM
    layer (on the tensor-core route where ``ssd_scan.route`` gives it the
    config's head dim, state and chunk), K7 once per RG-LRU layer, K1 as
    ``k1_calls`` counts."""
    import torch
    from repro_torch.kernels.flash_attention import route
    from repro_torch.kernels.ssd_scan import route as ssd_route
    kinds = cfg.layer_kinds
    k6 = kinds.count("attn") if seq > 512 else 0
    tc = route(getattr(torch, cfg.compute_dtype), cfg.head_dim) == "tc"
    k8 = kinds.count("ssm")
    k8_tc = k8 if cfg.ssm is not None and ssd_route(
        cfg.ssm.head_dim, cfg.ssm.d_state,
        min(cfg.ssm.chunk_size, seq)) == "tc" else 0
    return {"flash_attention": k6, "flash_attention_tc": k6 if tc else 0,
            "ssd_scan": k8, "ssd_scan_tc": k8_tc,
            "rglru_scan": kinds.count("rglru"),
            "fake_quant": len(k1_calls(cfg, cspec, seq))}


def release_cached_memory(device) -> None:
    """Hand the caching allocator's free blocks back to the card before a
    forward over a new pattern of tensors. recurrentgemma-2b's prefill
    holds 10.7 GB of f32 params beside 16.8 GB of bf16 and 33.6 GB of f32
    logits (a 61 GB peak): a later forward's smaller tensors would split
    the cached 33.6 GB block, and its logits would then find no block of
    that size (fragmentation, not a lack of memory)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()


def timed_prefill(cfg, params, tokens, cspec=None, embeds=None,
                  on_logits=None) -> tuple:
    """One ``make_prefill_step`` forward (over a frontend's ``embeds``
    too): (seconds on the host clock, ended by a device sync, and the
    launches it made). Fails on logits that are not finite or not [B, S,
    vocab]; ``on_logits``, if given, is called with them after that
    check (to keep what a comparison needs)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.train.train_step import make_prefill_step
    step = make_prefill_step(cfg, cspec)
    x = embeds if tokens is None else tokens
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    logits = step(params, tokens, embeds)
    sync()
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    # isfinite takes an f32 copy (abs) and two masks of its input: by
    # rows, so that 32,768 x 256,000 f32 logits (33.6 GB) get no twin.
    finite = all(bool(torch.isfinite(rows).all())
                 for rows in logits.flatten(0, 1).split(2048))
    if tuple(logits.shape) != tuple(x.shape[:2]) + (cfg.vocab_size,) \
            or not finite:
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    if on_logits is not None:
        on_logits(logits)
    return dt, launches


def check_prefill_numerics(cfg, device, seq: int, seed: int = 0,
                           min_agree: float = 0.99) -> dict:
    """The whole prefill at ``cfg`` (f32 compute) on ``device`` against
    the plain CPU path (chunked branches, plain fake-quant): next-token
    argmax agreement >= ``min_agree`` uncompressed, >= 95% under the
    seeded policy."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.models import model as M
    from repro_torch.train.train_step import make_prefill_step
    f32 = cfg.replace(compute_dtype="float32")
    cpu_params = M.init(f32, seed=seed, device="cpu")
    dev_params = _to(cpu_params, device)
    toks, embeds = frontend_request(f32, 2, seq, seed + 1, "cpu")
    on_card = [None if t is None else t.to(device) for t in (toks, embeds)]
    cms = [CompressibleLM(f32, p) for p in (cpu_params, dev_params)]
    agree = {}
    for name, cspecs in (("uncompressed", (None, None)),
                         ("policy", [cm.build_cspec(seeded_policy(cm, seed))
                                     for cm in cms])):
        want = make_prefill_step(f32, cspecs[0])(cpu_params, toks, embeds)
        got = make_prefill_step(f32, cspecs[1])(dev_params,
                                                *on_card).cpu()
        agree[name] = float((got.argmax(-1) == want.argmax(-1)).float()
                            .mean())
        log(f"  {f32.name} {name}, f32, 2 x {seq} tokens: argmax agreement "
            f"device vs plain CPU path {agree[name]:.4f}, max |logit diff| "
            f"{float((got - want).abs().max()):.3g}")
    # Under the policy a last-bit difference in a channel's range moves
    # whole fake-quant steps (ROADMAP Queue 3), so the bound is looser.
    if agree["uncompressed"] < min_agree or agree["policy"] < 0.95:
        raise AssertionError(f"the device prefill disagrees with the CPU "
                             f"path: argmax agreement {agree}")
    return agree


def run_prefill(cfg, params, cspec, device, seq: int, warm_seq: int,
                seed: int = 0) -> dict:
    """The first layer of each kind's kernel inputs through its kernel
    and the plain branch (q/k/v through K6, (xh_dt, dA, B, C) through K8,
    (a, b) through K7), then warm-up and timed prefill forwards,
    uncompressed and under ``cspec``. On the card each timed forward
    must launch each kernel exactly as ``prefill_launches`` counts (K6,
    K8 or K7 once per layer of its kind, K1 under the policy as
    ``k1_calls`` counts); on the CPU nothing may launch."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.inputs import model_flops
    tokens, embeds = frontend_request(cfg, 1, seq, seed, device)
    x = embeds if tokens is None else tokens
    out = {}
    if x.is_cuda and "attn" in cfg.layer_kinds:
        out["k6"] = check_flash_attention_prefill(
            *layer_qkv(cfg, params, tokens, embeds),
            window=cfg.window if cfg.attention == "sliding" else 0,
            causal=not cfg.is_encoder)
    if x.is_cuda and cfg.moe is not None:
        out["capacity"], out["dropped"] = moe_drop_share(cfg, params,
                                                         tokens)
        log(f"  MoE dispatch of the first layer at {seq} tokens: "
            f"{cfg.moe.num_experts} experts x {out['capacity']} slots, "
            f"{out['dropped']:.2%} of the top-{cfg.moe.top_k} choices "
            f"dropped")
    if tokens is not None and tokens.is_cuda and "ssm" in cfg.layer_kinds:
        out["k8"] = check_ssd_prefill(*layer_ssd_inputs(cfg, params, tokens),
                                      cfg.ssm.chunk_size)
    if tokens is not None and tokens.is_cuda and "rglru" in cfg.layer_kinds:
        out["k7"] = check_rglru_prefill(*layer_rglru_inputs(cfg, params,
                                                            tokens))
    flops = model_flops(cfg, ShapeConfig("prefill", seq, 1, "prefill"))
    warm = [None if t is None else t if t is embeds and tokens is not None
            else t[:, :warm_seq] for t in (tokens, embeds)]
    for name, cs in (("uncompressed", None), ("policy", cspec)):
        release_cached_memory(x.device)
        timed_prefill(cfg, params, warm[0], cs, warm[1])
        dt, launches = timed_prefill(cfg, params, tokens, cs, embeds)
        log(f"  {name}: {dt * 1e3:.1f} ms per forward of 1 x {seq} tokens, "
            f"{seq / dt:.0f} tokens/s, MFU {flops / dt / BF16_FLOPS:.4f} "
            f"(model_flops {flops / 1e12:.2f} TFLOP over 989 TFLOP/s; "
            f"{CARD}); launches {launches}")
        want = prefill_launches(cfg, cs, seq)
        if not x.is_cuda:               # the plain versions' rehearsal
            if any(launches.values()):
                raise AssertionError(f"kernels launched on the CPU: "
                                     f"{launches}")
        elif name == "policy" and launches["fake_quant"] == 0:
            raise AssertionError("the compressed forward never launched K1")
        elif any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"launches {launches} in a "
                                 f"{cfg.num_layers}-layer forward, "
                                 f"{want} expected")
        out[name] = dict(seconds=dt, launches=launches)
    if x.is_cuda:
        torch.cuda.synchronize()
    return out


def oracle_prefill_ratio(cm, policy, seq: int) -> float:
    """The analytic oracle's compressed / reference latency for a prefill
    of ``seq`` tokens at a ``seq`` context (V5E reference data)."""
    from repro_torch.core.latency import V5E, LatencyContext, policy_latency
    from repro_torch.core.policy import Policy
    ctx = LatencyContext(tokens=seq, seq_ctx=seq, mode="prefill")
    ref = policy_latency(cm.specs, Policy.reference(cm.specs), V5E, ctx)
    return policy_latency(cm.specs, policy, V5E, ctx).total_s / ref.total_s


def run_decode(cfg, params, cspecs: dict, *, batch: int, steps: int,
               max_len: int, requests: int = 2,
               cache_bits: tuple = (16, 8)) -> dict:
    """``decode_loop`` then ``sustained_throughput`` (with ``requests``)
    per (cspec, cache bits); tok/s of each. Fails on tokens out of the
    vocabulary, and on
    the card when a ``decode_loop`` launches K1 other than ``k1_calls``
    times per step, or any other kernel."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import decode_loop, sustained_throughput
    out = {}
    for name, cs in cspecs.items():
        for bits in cache_bits:
            build.reset_launches()
            toks, dt = decode_loop(cfg, params, batch, steps, max_len, cs,
                                   cache_bits=bits)
            k1 = build.LAUNCHES["fake_quant"]
            want = steps * len(k1_calls(cfg, cs, batch)) if toks.is_cuda \
                else 0
            if k1 != want or sum(build.LAUNCHES.values()) != k1:
                raise AssertionError(f"{dict(build.LAUNCHES)} launches in "
                                     f"{steps} decode steps, {want} K1 "
                                     f"launches expected")
            if tuple(toks.shape) != (batch, steps + 1) or \
                    int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
                raise AssertionError(f"bad decode tokens {tuple(toks.shape)}")
            cache = f"{bits}-bit KV cache" if "attn" in cfg.layer_kinds \
                else "conv/state cache"
            tok_s, times = sustained_throughput(
                cfg, params, batch, steps, max_len, cs, requests, bits) \
                if requests else (None, None)
            tail = (f"; sustained {tok_s:.1f} tok/s over {requests} "
                    f"requests ({min(times):.3f}-{max(times):.3f} s each; "
                    f"{CARD})") if requests else f"; {CARD}"
            log(f"  {name}, {cache}: decode_loop "
                f"{batch * steps / dt:.1f} tok/s ({dt * 1e3:.1f} ms for "
                f"{steps} steps x batch {batch}, {k1} K1 launches){tail}")
            out[f"{name}/{bits}"] = dict(loop_tok_s=batch * steps / dt,
                                         sustained_tok_s=tok_s,
                                         k1_launches=k1)
    return out


def profile_decode(cfg, params, cspec, *, batch: int, steps: int,
                   max_len: int) -> dict:
    """Where a decode step's time goes: one ``decode_loop`` of ``steps``
    steps under ``torch.profiler`` after an unprofiled one of the same
    length; the device's busy time per step (sum of kernel times) against
    the unprofiled step's wall time, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import decode_loop
    _, wall = decode_loop(cfg, params, batch, steps, max_len, cspec)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_loop(cfg, params, batch, steps, max_len, cspec)
        torch.cuda.synchronize()
    rows = [(getattr(ev, "self_device_time_total", 0.0), ev.key,
             ev.count) for ev in prof.key_averages()
            if getattr(ev, "device_type", None) is not None
            and "CUDA" in str(ev.device_type)]
    busy = sum(t for t, _, _ in rows) * 1e-6 / steps
    return {"step_s": wall / steps, "device_busy_s": busy,
            "kernels_per_step": sum(n for _, _, n in rows) / steps,
            "top": sorted(rows, reverse=True)[:5]}


def profile_prefill(cfg, params, tokens, cspec=None) -> dict:
    """Where a prefill forward's time goes: one ``make_prefill_step``
    forward under ``torch.profiler`` (after the unprofiled ones of
    ``run_prefill``); the device's busy time (sum of kernel times)
    against the profiled wall, the kernels, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.train_step import make_prefill_step
    step = make_prefill_step(cfg, cspec)
    release_cached_memory(tokens.device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, tokens)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(getattr(ev, "self_device_time_total", 0.0), ev.key,
             ev.count) for ev in prof.key_averages()
            if getattr(ev, "device_type", None) is not None
            and "CUDA" in str(ev.device_type)]
    return {"wall_s": wall, "device_busy_s": sum(t for t, _, _ in rows)
            * 1e-6, "kernels": sum(n for _, _, n in rows),
            "top": sorted(rows, reverse=True)[:8]}


def log_prefill_profile(cfg, params, device) -> None:
    """One profiled uncompressed forward over ``PREFILL_SEQ`` seeded
    tokens (``profile_prefill``): the device's busy share and the top
    kernels by device time."""
    prof = profile_prefill(cfg, params, prefill_tokens(cfg, 1, PREFILL_SEQ,
                                                       0, device))
    busy = prof["device_busy_s"]
    log(f"  uncompressed, profiled: {prof['wall_s'] * 1e3:.1f} ms wall, "
        f"device busy {busy * 1e3:.1f} ms ({busy / prof['wall_s']:.1%}), "
        f"{prof['kernels']} kernels; top device time (us; {CARD}):")
    for t, key, n in prof["top"]:
        log(f"    {t:12.1f}  x{n:<5d} {key[:80]}")
    if "rglru" in cfg.layer_kinds:
        log_rglru_block(cfg, params, device)


def rglru_block_split(cfg, params, tokens) -> dict:
    """Device ms of the first RG-LRU layer's block (``blocks.apply_rglru``,
    uncompressed) on its own input, and of its parts on the same tensors:
    the gate passes (``blocks._rglru_gates`` on the conv output), K7 on
    their (a, b), and the GEMMs (x w_x, x w_y, the output projection);
    the rest (the conv, gelu, h y, casts) is the block less those. CUDA
    events with the host queued ahead (``cuda_ms``); the gate passes'
    kernel count from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import blocks as MB
    from repro_torch.models import layers as ML
    _, p, x, _ = layer_input(cfg, params, tokens, "rglru")
    with torch.no_grad():
        xin = ML.apply_norm(cfg.norm, p["mix_norm"], x)
        rp = p["rglru"]
        w_x, w_y, w_out = (ML.getw(rp, n, xin.dtype).to(xin.dtype)
                           for n in ("w_x", "w_y", "w_out"))
        u, _ = ML.causal_conv1d(torch.einsum("bsd,dw->bsw", xin, w_x),
                                rp["conv_w"], None)
        a, b = MB._rglru_gates(rp, u)

        def gemms():
            torch.einsum("bsd,dw->bsw", xin, w_x)
            torch.einsum("bsd,dw->bsw", xin, w_y)
            torch.einsum("bsw,wd->bsd", u, w_out)

        out = {"block": cuda_ms(lambda: MB.apply_rglru(rp, xin, cfg), 5, 1),
               "gates": cuda_ms(lambda: MB._rglru_gates(rp, u), 5, 1),
               "k7": cuda_ms(lambda: ops.rglru_scan(a, b), 5, 1),
               "gemms": cuda_ms(gemms, 5, 1)}
        out = {k: v[0] for k, v in out.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            MB._rglru_gates(rp, u)
            torch.cuda.synchronize()
        out["gate_kernels"] = len(device_kernels(prof))
    out["rest"] = out["block"] - out["gates"] - out["k7"] - out["gemms"]
    out["shape"] = list(u.shape)
    return out


def log_rglru_block(cfg, params, device) -> None:
    """``rglru_block_split`` over ``PREFILL_SEQ`` seeded tokens, logged
    with what fusing the gates into K7 could at most save: the gates and
    K7 now against one pass that reads u (its dtype) and writes h (f32)
    at the bytes bound."""
    import torch
    r = rglru_block_split(cfg, params, prefill_tokens(cfg, 1, PREFILL_SEQ,
                                                      0, device))
    B, S, C = r["shape"]
    fused, _ = bound_ms(
        B * S * C * (getattr(torch, cfg.compute_dtype).itemsize + 4), 0.0)
    log(f"  RG-LRU block (layer 0, {tuple(r['shape'])}; device ms, CUDA "
        f"events; {CARD}): block {r['block']:.3f} = gate passes "
        f"{r['gates']:.3f} ({r['gate_kernels']} kernels) + K7 "
        f"{r['k7']:.3f} + GEMMs {r['gemms']:.3f} + rest {r['rest']:.3f}; "
        f"the gates fused into K7 would read u and write h once: bound "
        f"{fused:.3f} ms against {r['gates'] + r['k7']:.3f} now, at most "
        f"{r['gates'] + r['k7'] - fused:.3f} ms a layer, "
        f"{(r['gates'] + r['k7'] - fused) * cfg.layer_kinds.count('rglru'):.1f}"
        f" ms a forward")


def check_decode_consistency(cfg, device, steps: int = 16,
                             seed: int = 0) -> None:
    """At ``cfg`` with f32 compute, the greedy tokens of ``decode_loop``
    (16-bit cache) are the argmaxes of one prefill forward over the same
    tokens: the cache path and the full-sequence path agree."""
    import torch
    from repro_torch.launch.serve import decode_loop
    from repro_torch.models import model as M
    f32 = cfg.replace(compute_dtype="float32")
    params = M.init(f32, seed=seed, device=device)
    toks, _ = decode_loop(f32, params, 4, steps, 2 * steps)
    with torch.no_grad():
        again = M.forward(f32, params, toks[:, :steps]).argmax(-1)
    agree = float((again == toks[:, 1:]).float().mean())
    log(f"  {f32.name}, f32: decode tokens equal the prefill argmaxes at "
        f"{agree:.4f} of {toks[:, 1:].numel()} positions")
    if agree < 1.0:
        raise AssertionError("decode and prefill disagree")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to(tree, device):
    """A copy of a tree of tensors on ``device`` (a copy on the same
    device too: the train steps update their params in place); other
    leaves (a cspec's bits) as they are."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device, copy=True) if hasattr(tree, "to") else tree


# ---------------------------------------------------------------------------

def recurrentgemma_phases(device, results: dict, launches: dict) -> None:
    """Phases 17 and 18 on the card: recurrentgemma-2b's prefill and
    decode (the earlier models freed first). Adds the K6 (D 256) and K7
    rows to ``results`` and their launch counts to ``launches``."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    rg = get_config("recurrentgemma-2b")
    kinds = rg.layer_kinds
    log(f"[recurrentgemma prefill] make_prefill_step on {rg.name} "
        f"({rg.num_layers} layers: {kinds.count('rglru')} RG-LRU of width "
        f"{rg.lru_width}, {kinds.count('attn')} local attention with "
        f"{rg.num_heads}/{rg.num_kv_heads} heads of {rg.head_dim}, window "
        f"{rg.window}; d={rg.d_model}, {rg.mlp} d_ff {rg.d_ff}, vocab "
        f"{rg.vocab_size}, {rg.compute_dtype} compute, {rg.param_dtype} "
        f"params), seeded random weights, 1 x {PREFILL_SEQ} tokens, "
        f"uncompressed and under a seeded pq policy; {CARD}")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cm = CompressibleLM(rg, M.init(rg, seed=0, device=device))
    log(f"  params {sum(t.numel() for t in _leaves(cm.params)) / 1e9:.3f} B "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card)")
    policy = seeded_policy(cm, 0)
    r_cspec = cm.build_cspec(policy)
    log("  policy (keep, w/a bits): " + " ".join(
        f"{s.name}:{c.keep}/{c.w_bits}/{c.a_bits}"
        for s, c in zip(cm.specs, policy.cmps)
        if c.w_bits < 32 or (s.prune_dim and c.keep < s.prune_dim)))
    k1_r = check_fake_quant_path(rg, r_cspec,
                                 (PREFILL_SEQ, DECODE["batch"]), device)
    log(f"  K1 at the {k1_r['pairs']} (shape, bits) of the policy's "
        f"prefill and decode: max |kernel - plain| "
        f"{k1_r['max_abs_err']:.3g} (tol 0)")
    pre_r = run_prefill(rg, cm.params, r_cspec, device, PREFILL_SEQ,
                        PREFILL_WARM_SEQ)
    results["flash_attention_d256"] = pre_r["k6"]
    results["rglru_scan"] = pre_r["k7"]
    for name, kernel in (("flash_attention_d256", "flash_attention"),
                         ("rglru_scan", "rglru_scan")):
        launches[name] = sum(pre_r[n]["launches"][kernel]
                             for n in ("uncompressed", "policy"))
    for n in ("uncompressed", "policy"):
        k7_ms = pre_r["k7"]["ms"] * kinds.count("rglru")
        k6_ms = pre_r["k6"]["ms"] * kinds.count("attn")
        log(f"  {n}: K7 {kinds.count('rglru')} x {pre_r['k7']['ms']:.3f} ms"
            f" = {k7_ms:.1f} ms ({k7_ms / 1e3 / pre_r[n]['seconds']:.1%}), "
            f"K6 {kinds.count('attn')} x {pre_r['k6']['ms']:.2f} ms = "
            f"{k6_ms:.1f} ms ({k6_ms / 1e3 / pre_r[n]['seconds']:.1%}) of "
            f"the forward")
    log_prefill_profile(rg, cm.params, device)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak device memory of the phase: {peak:.2f} GB "
        f"(torch.cuda.max_memory_allocated; {CARD})")
    predicted = oracle_prefill_ratio(cm, policy, PREFILL_SEQ)
    measured = pre_r["policy"]["seconds"] / pre_r["uncompressed"]["seconds"]
    log(f"  compressed / reference: predicted {predicted:.4f} (analytic "
        f"oracle, V5E reference data), measured {measured:.4f} ({CARD})")
    check_prefill_numerics(get_config("recurrentgemma-2b", smoke=True),
                           device, 1100, min_agree=1.0)
    log(f"  {time.perf_counter() - t0:.1f} s for the recurrentgemma prefill "
        f"phase")

    log(f"[recurrentgemma decode] decode_loop and sustained_throughput on "
        f"{rg.name}, batch {DECODE['batch']}, {DECODE['steps']} steps, "
        f"max_len {DECODE['max_len']}: the RG-LRU state and conv window, "
        f"the attention layers' ring KV cache; {CARD}")
    t0 = time.perf_counter()
    run_decode(rg, cm.params, {"uncompressed": None, "policy": r_cspec},
               **DECODE)
    for name, cs in (("uncompressed", None), ("policy", r_cspec)):
        prof = profile_decode(rg, cm.params, cs, batch=DECODE["batch"],
                              steps=8, max_len=DECODE["max_len"])
        busy = prof["device_busy_s"]
        log(f"  {name}, 16-bit cache, profiled: {prof['step_s'] * 1e3:.2f} "
            f"ms per step (unprofiled), device busy {busy * 1e3:.2f} ms "
            f"({busy / prof['step_s']:.1%}), "
            f"{prof['kernels_per_step']:.0f} kernels per step; top device "
            f"time over 8 steps (us):")
        for t, key, n in prof["top"]:
            log(f"    {t:10.1f}  x{n:<6d} {key[:80]}")
    check_decode_consistency(get_config("recurrentgemma-2b", smoke=True),
                             device, steps=24)
    log(f"  {time.perf_counter() - t0:.1f} s for the recurrentgemma decode "
        f"phase")


# Depth of the MoE configs on one 80 GB card, every width as published:
# a mixtral-8x22b layer holds 5.0 GB of bf16 weights (8 experts x 3 x
# 6,144 x 16,384, and 88 M of attention), 56 of them 280 GB; an
# arctic-480b layer 26.8 GB (128 experts x 3 x 7,168 x 4,864, its dense
# residual and attention besides), 35 of them 940 GB. 4 and 1 layers
# leave room for one layer's fake-quantized stack (a bf16 copy of one of
# its three) and the 32K activations.
MOE_DEPTH = {"mixtral-8x22b": 4, "arctic-480b": 1}
FRONTEND_ARCHS = ("mixtral-8x22b", "arctic-480b", "internvl2-2b",
                  "hubert-xlarge")
TRAIN_SMOKE_TOL = 1e-5      # card vs CPU: loss and every gradient leaf


def moe_drop_share(cfg, params, tokens) -> tuple:
    """(capacity, share of the top-k choices dropped) of the first MoE
    layer's dispatch (``blocks.moe_route``, one group) on its own input
    in the uncompressed forward over ``tokens``."""
    import torch
    from repro_torch.models import blocks as MB
    from repro_torch.models import layers as ML
    _, p, x, pos = layer_input(cfg, params, tokens, "attn")
    with torch.no_grad():
        h = ML.apply_norm(cfg.norm, p["attn_norm"], x)
        x = x + MB.apply_attention(p["attn"], h, cfg, None, pos)
        h = ML.apply_norm(cfg.norm, p["mlp_norm"], x)
        dispatch, _, _, keep = MB.moe_route(
            p["moe"], h.reshape(1, -1, h.shape[-1]), cfg)
    return dispatch.shape[-1], 1.0 - float(keep.float().mean())


def expert_views(params) -> dict:
    """Layer 0's expert stacks as K1 reads them ([E·d, ff], [E·ff, d]
    views, no copy), by shape (``w_up`` for the shape it shares with
    ``w_gate``)."""
    moe = params["blocks"][0]["moe"]
    return {tuple(v.shape): v for v in (
        moe[n].reshape(-1, moe[n].shape[-1])
        for n in ("w_gate", "w_down", "w_up"))}


def check_moe_slots(arch: str, device) -> dict:
    """The batched validation of an MoE config at its SMOKE widths (bf16
    compute, f32 params): ``accuracy_policy_batch`` over 8 seeded
    policies (two of them the reference) on 2 x 1,100 tokens (past the
    capacity's 4,096 token-experts: tokens drop) against each policy's
    scalar forward, ``accuracy``: equal slot by slot (each policy
    routes its own tokens at its own capacity). K1 over slots must have
    launched once per site of ``k1_calls`` and the one-tensor K1 never."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.core.policy import Policy, stack_policies
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    cfg = get_config(arch, smoke=True)
    cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=device))
    pols = [Policy.reference(cm.specs) if k in (2, 5)
            else seeded_policy(cm, k) for k in range(SLOTS)]
    pb = stack_policies(cm.specs, pols)
    batch = {"tokens": prefill_tokens(cfg, 2, 1100, 7, device)}
    build.reset_launches()
    got = cm.accuracy_policy_batch(batch, pb).tolist()
    launched = dict(build.LAUNCHES)
    want = [float(cm.accuracy(batch, cm.build_cspec(p))) for p in pols]
    sites = len(k1_calls(cfg, cm.cspec_builder()(pb.keep, pb.w_bits,
                                                 pb.a_bits), 2 * 1100)) \
        if torch.device(device).type == "cuda" else 0
    log(f"  {cfg.name} batched validation, K {SLOTS}, 2 x 1100 tokens: "
        f"slot accuracies {[round(a, 4) for a in got]}, scalar forwards "
        f"{[round(a, 4) for a in want]}; K1 over slots "
        f"{launched['fake_quant_slots']} launches ({sites} sites), "
        f"one-tensor K1 {launched['fake_quant']}")
    if got != want or launched["fake_quant_slots"] != sites \
            or launched["fake_quant"]:
        raise AssertionError(f"{cfg.name}: the batched validation "
                             f"disagrees with the scalar forwards or "
                             f"launched {launched}")
    return {"slots": got, "scalar": want}


def smoke_train_batch(cfg, batch: int, seq: int, seed: int, device) -> dict:
    """A seeded train batch: tokens for a decoder, frames and per-frame
    labels for an audio encoder, patches besides for a VLM."""
    import numpy as np
    import torch
    tokens, embeds = frontend_request(cfg, batch, seq, seed, device)
    out = {"tokens": tokens, "embeds": embeds}
    if cfg.is_encoder:
        out["labels"] = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (batch, seq)), device=device)
    return {k: v for k, v in out.items() if v is not None}


def check_train_smoke(arch: str, device, batch: int = 2,
                      seq: int = 64) -> dict:
    """One train step of ``arch`` at its SMOKE widths in f32, the same
    seeded params and batch on the card and on the CPU's plain route:
    the loss and every gradient leaf within ``TRAIN_SMOKE_TOL``, the
    step's updated leaves within 0.1 x its learning rate (Adam's
    normalized step turns rounding-noise gradients into fractions of a
    step, so the update is held in units of the step)."""
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import (lm_loss, make_train_step,
                                              value_and_grad)
    cfg = get_config(arch, smoke=True).replace(compute_dtype="float32")
    host = M.init(cfg, 0, "cpu")
    b = smoke_train_batch(cfg, batch, seq, 3, "cpu")
    on = {"cpu": (host, b), "card": (_to(host, device), _to(b, device))}
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=60,
                           weight_decay=0.0)
    out = {}
    for name, (p, bb) in on.items():
        loss, g = value_and_grad(lambda q: lm_loss(cfg, q, bb), p)
        q = _to(p, M.device_of(p))
        q, _, m = make_train_step(cfg, ocfg)(q, adamw_init(q, ocfg), bb)
        out[name] = (float(loss), g, q, float(m["lr"]))
    d_loss = abs(out["cpu"][0] - out["card"][0])
    d_grad = _max_leaf_diff(out["cpu"][1], out["card"][1])
    d_step = _max_leaf_diff(out["cpu"][2], out["card"][2]) / out["card"][3]
    log(f"  {cfg.name} f32, {batch} x {seq}, one train step card against "
        f"the CPU: loss {out['card'][0]:.5f}, {d_loss:.3g} apart, "
        f"gradients {d_grad:.3g} (tol {TRAIN_SMOKE_TOL}), updated leaves "
        f"{d_step:.3g} x lr {out['card'][3]:.3g} (tol 0.1)")
    if max(d_loss, d_grad) > TRAIN_SMOKE_TOL or d_step > 0.1:
        raise AssertionError(f"{cfg.name}: the train step on the card "
                             f"disagrees with the CPU's plain route")
    return {"loss": d_loss, "grad": d_grad, "step": d_step}


def moe_frontend_phase(device, results: dict, launches: dict) -> dict:
    """Phase 19 on the card: mixtral-8x22b and arctic-480b at full width
    (depth ``MOE_DEPTH``), internvl2-2b and hubert-xlarge at full width
    and depth, each raw and under a seeded pq policy: K1 exact at every
    (shape, bits) of the policy (an expert stack's view block by block),
    K6 on the first attention layer's q/k/v at 1 x 32,768 (D 128, and
    hubert's D 80 bidirectional, on the tensor cores), a
    prefill of 1 x 32,768 (internvl2's first 256 positions seeded patch
    embeddings, hubert's seeded frames) with K6 and K1 counted per
    forward, a decode at batch 8 for 32 steps (not hubert: an encoder);
    then at the SMOKE widths the whole prefill against the CPU, decode
    against prefill, the MoE configs' batched validation and one train
    step of each family card against CPU. Adds the D 80 and D 128 K6
    rows to ``results`` and their launches to ``launches``."""
    import torch
    from repro_torch.core.compress import CompressibleLM
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    out = {}
    t_phase = time.perf_counter()
    for arch in FRONTEND_ARCHS:
        full = get_config(arch)
        cfg = full.replace(num_layers=MOE_DEPTH.get(arch, full.num_layers))
        what = (f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of d_ff "
                f"{cfg.d_ff}, capacity factor {cfg.moe.capacity_factor}"
                f"{', a dense residual' if cfg.moe.dense_residual else ''}"
                if cfg.moe else f"{cfg.mlp} d_ff {cfg.d_ff}")
        log(f"[moe and frontend path] {cfg.name}: {cfg.num_layers} of "
            f"{full.num_layers} layers, d={cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim} "
            f"({cfg.attention}"
            f"{f', window {cfg.window}' if cfg.attention == 'sliding' else ''}"
            f"), {what}, vocab {cfg.vocab_size}, frontend {cfg.frontend}, "
            f"{cfg.compute_dtype} compute, {cfg.param_dtype} params; seeded "
            f"random weights, 1 x {PREFILL_SEQ} prefill"
            f"{'' if cfg.is_encoder else ', decode batch 8 x 32 steps'}, "
            f"raw and under a seeded pq policy; {CARD}")
        t0 = time.perf_counter()
        release_cached_memory(device)
        torch.cuda.reset_peak_memory_stats()
        cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=device))
        log(f"  params {M.param_count(cm.params) / 1e9:.3f} B "
            f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card), "
            f"init {time.perf_counter() - t0:.1f} s")
        policy = seeded_policy(cm, 0)
        cspec = cm.build_cspec(policy)
        log("  policy (keep, w/a bits): " + " ".join(
            f"{s.name}:{c.keep}/{c.w_bits}/{c.a_bits}"
            for s, c in zip(cm.specs, policy.cmps)
            if c.w_bits < 32 or (s.prune_dim and c.keep < s.prune_dim)))
        rows = (PREFILL_SEQ,) + (() if cfg.is_encoder
                                 else (DECODE["batch"],))
        k1 = check_fake_quant_path(cfg, cspec, rows, device,
                                   expert_views(cm.params) if cfg.moe
                                   else None)
        log(f"  K1 at the {k1['pairs']} (shape, bits) of the policy's "
            f"prefill{'' if cfg.is_encoder else ' and decode'}: max "
            f"|kernel - plain| {k1['max_abs_err']:.3g} (tol 0)")
        pre = run_prefill(cfg, cm.params, cspec, device, PREFILL_SEQ,
                          PREFILL_WARM_SEQ)
        n_attn = cfg.layer_kinds.count("attn")
        for n in ("uncompressed", "policy"):
            k6_ms = pre["k6"]["ms"] * n_attn
            log(f"  {n}: K6 {n_attn} x {pre['k6']['ms']:.3f} ms = "
                f"{k6_ms:.1f} ms, {k6_ms / 1e3 / pre[n]['seconds']:.1%} of "
                f"the forward; K1 {pre[n]['launches']['fake_quant']} "
                f"launches")
        row = {80: "flash_attention_d80", 128: "flash_attention_d128"}[
            cfg.head_dim]
        if arch in ("internvl2-2b", "hubert-xlarge"):
            results[row] = pre["k6"]
        launches[row] = launches.get(row, 0) + sum(
            pre[n]["launches"]["flash_attention"]
            for n in ("uncompressed", "policy"))
        rec = {"prefill_s": {n: pre[n]["seconds"]
                             for n in ("uncompressed", "policy")},
               "k6": pre["k6"], "k1": k1, "dropped": pre.get("dropped")}
        if cfg.is_encoder:
            try:
                M.init_cache(cfg, 1, 8, device=device)
            except ValueError:
                pass
            else:
                raise AssertionError(f"{cfg.name}: an encoder got a cache")
        else:
            rec["decode"] = run_decode(
                cfg, cm.params, {"uncompressed": None, "policy": cspec},
                **DECODE, requests=0, cache_bits=(16,))
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  peak device memory: {rec['peak_gb']:.2f} GB "
            f"(torch.cuda.max_memory_allocated; {CARD}); "
            f"{time.perf_counter() - t0:.1f} s for {cfg.name}")
        out[arch] = rec
        del cm, cspec
    release_cached_memory(device)
    t0 = time.perf_counter()
    log(f"[moe and frontend path] SMOKE widths: the whole prefill against "
        f"the CPU, decode against prefill, the MoE batched validation, "
        f"one train step card against CPU; {CARD}")
    for arch in FRONTEND_ARCHS:
        smoke = get_config(arch, smoke=True)
        check_prefill_numerics(smoke, device, 1100)
        if not smoke.is_encoder:
            check_decode_consistency(smoke, device)
        if smoke.moe is not None:
            out[arch]["slots"] = check_moe_slots(arch, device)
        out[arch]["train"] = check_train_smoke(arch, device)
    log(f"  {time.perf_counter() - t0:.1f} s for the SMOKE checks; "
        f"{time.perf_counter() - t_phase:.1f} s for the phase")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the deployment slicer and the fleet
# ---------------------------------------------------------------------------

SLICE_ARCH = "granite-3-8b"
SLICE_KEEP = (0.25, 0.75)   # a layer's kept share of its ff channels
SLICE_SAMPLE_ROWS = 256     # rows whose whole logits are compared
# Sliced against masked at full width (bf16): the two forwards multiply
# the same kept channels; the masked one also adds the pruned channels'
# exact zeros, so the down projections sum in another order (cuBLAS
# picks its kernel by K), and every layer's output may round to bf16
# differently by an ulp (2^-8 relative); over 40 layers that moves a
# random-weight model's logits by a few hundredths and flips the argmax
# of rows whose top two logits lie that close. The bounds leave room
# over what the card showed (PERF.md, Findings); a model whose weights
# are far off agrees on few rows (the sliced model deployed with every
# weight at 4 bits agreed with it on 1.3% of the argmaxes).
SLICE_ARGMAX_MIN = 0.9
SLICE_LOGIT_TOL = 0.5
# The SMOKE config in f32: sliced against masked on the card (the same
# products summed in other orders), and against the CPU's plain route.
SLICE_SMOKE_TOL = 1e-4
FLEET_MEMBERS, FLEET_EPOCHS = 4, 4


def slice_policy(cm, seed: int, grid: int = 128):
    """A seeded pruning-only policy: each layer's ``mlp_up`` keeps a
    seeded share of its ff channels in ``SLICE_KEEP`` on the ``grid``;
    heads whole, every bit width 32."""
    import numpy as np
    from repro_torch.core.policy import Policy
    from repro_torch.core.spec import LayerCMP
    rng = np.random.default_rng(seed)
    pol = Policy.reference(cm.specs)
    for i, s in enumerate(cm.specs):
        if s.kind == "mlp_up":
            units = s.prune_dim // grid
            lo = math.ceil(SLICE_KEEP[0] * units)
            hi = math.floor(SLICE_KEEP[1] * units)
            pol.cmps[i] = LayerCMP(keep=grid * int(rng.integers(lo, hi + 1)))
    return pol


def ff_keeps(cspec) -> list:
    return [int(cs["mlp"]["ff_mask"].sum()) for cs in cspec["blocks"]]


def sliced_prefill_flops(cfg, cspec, seq: int) -> float:
    """``model_flops`` of a prefill with each layer's MLP products cut to
    its kept ff channels (the weights a sliced model multiplies);
    ``cspec`` None: the whole model."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.compress import lm_layer_specs
    from repro_torch.launch.inputs import model_flops
    full = model_flops(cfg, ShapeConfig("prefill", seq, 1, "prefill"))
    if cspec is None:
        return full
    keeps = ff_keeps(cspec)
    cut = sum(s.flops_per_token * (1.0 - keeps[s.layer_idx] / cfg.d_ff)
              for s in lm_layer_specs(cfg)
              if s.kind in ("mlp_up", "mlp_down"))
    return full - cut * seq


def slice_prefill(name, cfg, params, tokens, flops, keep=None,
                  cspec=None) -> dict:
    """A prefill timed as the other prefill phases time theirs, warmed at
    the timed shape: host ms ended by a sync, MFU (``flops`` over 989
    TFLOP/s), the peak device memory of the timed forward, and the
    launches: on the card K6 once a layer on the tensor-core route and no
    other kernel; on the CPU none. ``keep``: a dict that receives the
    argmax of every row and the whole logits of ``SLICE_SAMPLE_ROWS``
    evenly spaced rows. ``cspec``: the masked model's (bits 32: K1 never
    launches)."""
    import torch
    device = tokens.device
    seq = tokens.shape[1]
    rows = torch.arange(0, seq, max(1, seq // SLICE_SAMPLE_ROWS),
                        device=device)

    def digest(logits):
        flat = logits.flatten(0, 1)
        keep["argmax"] = flat.argmax(-1)
        keep["sample"] = flat.index_select(0, rows)

    release_cached_memory(device)
    timed_prefill(cfg, params, tokens, cspec)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dt, launches = timed_prefill(cfg, params, tokens, cspec,
                                 on_logits=None if keep is None else digest)
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if device.type == "cuda" else 0.0
    want = prefill_launches(cfg, cspec, seq)
    if device.type != "cuda":
        if any(launches.values()):
            raise AssertionError(f"kernels launched on the CPU: {launches}")
    elif any(launches[k] != n for k, n in want.items()) or \
            sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"{name} prefill launched {launches}, "
                             f"{want} expected")
    out = {"ms": dt * 1e3, "mfu": flops / dt / BF16_FLOPS, "peak_gb": peak,
           "tflop": flops / 1e12, "launches": launches}
    log(f"  {name}: {out['ms']:.1f} ms per forward of 1 x {seq} tokens, "
        f"MFU {out['mfu']:.4f} ({out['tflop']:.1f} TFLOP of the weights it "
        f"multiplies, over 989 TFLOP/s), peak {peak:.2f} GB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; {CARD}")
    return out


def compare_sliced(masked: dict, sliced: dict) -> dict:
    """Argmax agreement over every row and the largest |logit
    difference| over the sampled rows, with the sample's largest |logit|
    as scale."""
    return {"argmax": float((masked["argmax"] == sliced["argmax"])
                            .float().mean()),
            "max_diff": float((masked["sample"] - sliced["sample"])
                              .abs().max()),
            "scale": float(masked["sample"].abs().max())}


def check_slice_smoke(device, seq: int = 1100, seed: int = 0) -> dict:
    """granite-3-8b's SMOKE config in f32, unrolled, under a seeded
    FF-only policy (keeps on a 16-channel grid, the masks taken on the
    CPU): on ``device`` the sliced forward against the masked one (within
    ``SLICE_SMOKE_TOL``), and against the same sliced forward on the
    CPU's plain route (argmax agreement >= 0.99, as the other SMOKE
    checks hold the card to the CPU)."""
    import torch
    from repro_torch.core.compress import CompressibleLM, slice_lm_params
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    from repro_torch.train.train_step import make_prefill_step
    cfg = get_config(SLICE_ARCH, smoke=True).replace(
        compute_dtype="float32", scan_layers=False)
    cpu_params = M.init(cfg, seed=seed, device="cpu")
    dev_params = _to(cpu_params, device)
    cm = CompressibleLM(cfg, cpu_params)
    cspec = cm.build_cspec(slice_policy(cm, seed, grid=16))
    dev_cspec = _to(cspec, device)
    toks = prefill_tokens(cfg, 2, seq, seed + 1, "cpu")
    step = make_prefill_step(cfg)
    want = step(slice_lm_params(cfg, cpu_params, cspec), toks)
    got = step(slice_lm_params(cfg, dev_params, dev_cspec),
               toks.to(device)).cpu()
    masked = make_prefill_step(cfg, dev_cspec)(dev_params,
                                               toks.to(device)).cpu()
    out = {"keeps": ff_keeps(cspec),
           "vs_masked": float((got - masked).abs().max()),
           "vs_cpu": float((got - want).abs().max()),
           "argmax_vs_cpu": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean()),
           "argmax_vs_masked": float((got.argmax(-1) == masked.argmax(-1))
                                     .float().mean())}
    log(f"  {cfg.name}, f32, 2 x {seq} tokens, ff keeps {out['keeps']} of "
        f"{cfg.d_ff}: sliced vs masked on {device} max |logit diff| "
        f"{out['vs_masked']:.3g} (tol {SLICE_SMOKE_TOL}), argmax agreement "
        f"{out['argmax_vs_masked']:.4f}; vs the CPU's sliced forward "
        f"{out['vs_cpu']:.3g}, argmax agreement {out['argmax_vs_cpu']:.4f} "
        f"(>= 0.99)")
    if out["vs_masked"] > SLICE_SMOKE_TOL or out["argmax_vs_cpu"] < 0.99:
        raise AssertionError(f"the SMOKE sliced forward disagrees: {out}")
    return out


def _fleet_state(fleet) -> list:
    from repro_torch.core.ddpg import state_leaves
    return state_leaves(fleet.state) + list(fleet.ring)


def fleet_cli_resume(device, root: str, argv=()) -> dict:
    """``launch.fleet.main`` at the reference's defaults (P 4, K 4, E 2,
    32 episodes; ``argv`` appended): an uninterrupted run checkpointing
    every epoch, a run stopped after 2 epochs, then a fresh fleet that
    restores and finishes. The resumed tail's records, every agent and
    ring tensor, the host mirrors and both generators of every member
    must equal the uninterrupted run's bit for bit."""
    import torch
    from repro_torch.launch import fleet as F
    base = ["--device", str(device), "--data", "0", *argv]
    t0 = time.perf_counter()
    full = F.main(base + ["--ckpt-dir", os.path.join(root, "a")])
    t_full = time.perf_counter() - t0
    head = F.main(base + ["--ckpt-dir", os.path.join(root, "b"),
                          "--stop-after-epochs", "2"])
    t1 = time.perf_counter()
    tail = F.main(base + ["--ckpt-dir", os.path.join(root, "b"),
                          "--resume"])
    t_tail = time.perf_counter() - t1
    a, b = full["fleet"], tail["fleet"]
    same = {
        "records": all(h + t == f for h, t, f in zip(
            head["records"], tail["records"], full["records"])),
        "tensors": all(torch.equal(x, y) for x, y in
                       zip(_fleet_state(a), _fleet_state(b))),
        "mirrors": all(
            (ma.replay.ptr, ma.replay.size, ma.agent.norm.count)
            == (mb.replay.ptr, mb.replay.size, mb.agent.norm.count)
            and (ma.agent.norm.mean == mb.agent.norm.mean).all()
            and (ma.agent.norm.var == mb.agent.norm.var).all()
            for ma, mb in zip(a.members, b.members)),
        "generators": all(
            torch.equal(ma._rollout_gen.get_state(),
                        mb._rollout_gen.get_state())
            and torch.equal(ma.agent.sample_gen.get_state(),
                            mb.agent.sample_gen.get_state())
            for ma, mb in zip(a.members, b.members))}
    out = {"same": same, "episodes": full["epoch_cursor"],
           "members": full["members"], "epochs": full["epochs_run"],
           "resumed_at": head["epoch_cursor"], "full_s": t_full,
           "tail_s": t_tail, "eps_per_s": full["eps_per_s"],
           "monitor": full["monitor"]}
    log(f"  launch.fleet.main: {out['members']} members x "
        f"{out['episodes']} episodes in {out['epochs']} epochs, "
        f"{t_full:.2f} s uninterrupted ({out['eps_per_s']} member-episodes"
        f"/s with captures); stopped after 2 epochs at episode "
        f"{out['resumed_at']}, restored by a fresh fleet and finished in "
        f"{t_tail:.2f} s: bit for bit equal to the uninterrupted run {same}"
        f"; {CARD}")
    if not all(same.values()) or not tail["records"][0] or \
            head["epoch_cursor"] + len(tail["records"][0]) != \
            full["epoch_cursor"]:
        raise AssertionError(f"the resumed fleet differs or ran nothing: "
                             f"{same}")
    return out


def testbed_fleet(device, lm_sens, cfg, root: str, *, members: int,
                  epochs: int, warmup: int, updates: int, batch_size: int,
                  val_batch: int, val_seq: int) -> dict:
    """A P-member pq ``FleetSearch`` (seeds 0..P-1) on ``cfg`` (the LM
    testbed), K ``SLOTS``, E ``FUSED_E``, checkpointing every epoch, for
    ``epochs`` epochs; then one steady epoch with its launches counted
    exactly; member-episodes/s, the monitor's summary, a checkpoint's
    bytes, snapshot and write seconds, and a restore into the fleet's own
    tensors (bit-equal, addresses kept)."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs.testbed import SERVE_CTX
    from repro_torch.core import graphs
    from repro_torch.core.search import FleetSearch, FusedCompressionSearch
    from repro_torch.kernels import build
    E, K = FUSED_E, SLOTS
    per_epoch = E * K
    cm, val, scfg = search_inputs(
        cfg, device, episodes=(epochs + 1) * per_epoch, warmup=warmup,
        updates=updates, batch_size=batch_size, val_batch=val_batch,
        val_seq=val_seq)
    ms = [FusedCompressionSearch(cm, val, dataclasses.replace(scfg, seed=p),
                                 SERVE_CTX, sens=lm_sens, batch_size=K,
                                 epoch_batches=E) for p in range(members)]
    fleet = FleetSearch(ms, ckpt_dir=root, ckpt_every=1)
    _sync(device)
    build.reset_launches()
    graphs.reset_counts()
    t0 = time.perf_counter()
    res = fleet.run_fleet(epochs * per_epoch)
    _sync(device)
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for m, r in zip(ms, res):
        check_batch_records(m, r.history, epochs * per_epoch)
        if m.dispatch_log != ["epoch"] * epochs:
            raise AssertionError(f"dispatch log {m.dispatch_log}")
    if fleet.readbacks != epochs:
        raise AssertionError(f"{fleet.readbacks} readbacks in {epochs} "
                             f"epochs")
    times = list(fleet.monitor.times)
    steady_s = statistics.median(times[2:]) if len(times) > 2 else times[-1]
    log(f"  {cfg.name} fleet: {members} pq members (seeds 0-"
        f"{members - 1}), K {K}, E {E}, {epochs} epochs of "
        f"{per_epoch} episodes in {secs:.3f} s (captures included); epoch "
        f"seconds {[round(t, 4) for t in times]}; steady "
        f"{members * per_epoch / steady_s:.2f} member-episodes/s; monitor "
        f"{fleet.monitor.summary()}; launches {launches}; {CARD}")
    # one more epoch, counted exactly
    rows, T = val_batch * val_seq, len(ms[0].steps)
    _sync(device)
    build.reset_launches()
    graphs.reset_counts()
    t0 = time.perf_counter()
    tail = fleet.run_fleet((epochs + 1) * per_epoch)
    _sync(device)
    step_s = time.perf_counter() - t0
    sites = sum(len(k1_calls(cfg, cs, rows)) for cs in pop_device_cspecs(
        ms, [r.history for r in tail]))
    n = updates * E * K
    check_fused_launches(dict(build.LAUNCHES), {
        "mlp3_members": E * T, "mlp3": 5 * members * n,
        "polyak": members * n, "fake_quant_slots_dev": sites,
        "adam_polyak": 0, "fake_quant_slots": 0, "fake_quant": 0},
        f"{cfg.name} fleet, a steady epoch (and its checkpoint)")
    counts = {k: dict(v) for k, v in graphs.COUNTS.items()}
    if device.type == "cuda" and counts != {"epoch": {"captures": 0,
                                                      "replays": 1}}:
        raise AssertionError(f"a steady fleet epoch is not one replay: "
                             f"{counts}")
    k1 = check_shared_validation_k1(cfg, ms, [r.history for r in tail],
                                    rows, device)
    # a checkpoint of the carry: host copy, write, restore in place
    t0 = time.perf_counter()
    fleet.save_checkpoint()
    snap_s = time.perf_counter() - t0
    fleet._ckpt.wait()
    write_s = time.perf_counter() - t0 - snap_s
    step_dir = os.path.join(root, f"step_{fleet.epochs_run}")
    n_bytes = dir_bytes(step_dir)
    before = [t.clone() for t in _fleet_state(fleet)]
    ptrs = [t.data_ptr() for t in _fleet_state(fleet)]
    _sync(device)
    t0 = time.perf_counter()
    extra = fleet.restore_latest_checkpoint()
    _sync(device)
    restore_s = time.perf_counter() - t0
    exact = all(torch.equal(a, b) for a, b in
                zip(before, _fleet_state(fleet)))
    in_place = ptrs == [t.data_ptr() for t in _fleet_state(fleet)]
    out = {"member_episodes_per_s": members * per_epoch / step_s,
           "steady_epoch_s": step_s, "run_s": secs, "epoch_s": times,
           "launches": launches, "monitor": fleet.monitor.summary(),
           "ckpt_bytes": n_bytes, "snapshot_s": snap_s, "write_s": write_s,
           "restore_s": restore_s, "k1": k1}
    log(f"  a counted steady epoch: {step_s:.4f} s = "
        f"{out['member_episodes_per_s']:.2f} member-episodes/s (its "
        f"checkpoint included: run_fleet waits for the write at its "
        f"end); checkpoint {n_bytes} bytes "
        f"({len(extra['member_seeds'])} members' agents, rings and "
        f"generators), snapshot {snap_s:.4f} s, write {write_s:.4f} s, "
        f"restore {restore_s:.4f} s: bit-equal {exact}, in place "
        f"{in_place}; {CARD}")
    if not (exact and in_place) or extra["epoch_cursor"] != \
            (epochs + 1) * per_epoch:
        raise AssertionError("the fleet's restore is not its own carry, in "
                             "place")
    return out


def slice_fleet_phase(device, lm_sens, results: dict, launches: dict, *,
                      slice_cfg=None, seq: int = PREFILL_SEQ,
                      smoke_seq: int = 1100, fleet_cfg=None,
                      fleet_members: int = FLEET_MEMBERS,
                      fleet_epochs: int = FLEET_EPOCHS, cli_argv=(),
                      warmup: int = FUSED_E * SLOTS, updates: int = 16,
                      batch_size: int = 64, val_batch=None,
                      val_seq=None) -> dict:
    """Phase 20: granite-3-8b at full width (``slice_cfg``; seeded
    weights, unrolled) under a seeded pruning-only policy: four prefills
    of 1 x ``seq`` tokens (raw, masked, sliced by ``slice_lm_params``,
    the sliced model deployed into int8 and packed int4), sliced held to
    masked; the SMOKE slice check; then the fleet: ``launch.fleet.main``'s
    resume bit for bit and a P-member pq fleet on the LM testbed
    (``fleet_cfg``; ``warmup`` one epoch by default, so the first epoch's
    graph has no updates and only the steady epoch's capture runs its
    updates eagerly once). Launch counts are reset before each part and
    read after. Adds the prefills' K6 launches and the fleet's K1 / K2 / K3
    launches to ``launches``."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs.testbed import LM_CFG, VAL_BATCH, VAL_SEQ
    from repro_torch.core.compress import CompressibleLM, slice_lm_params
    from repro_torch.core.deploy import quantize_params_for_deploy
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    device = torch.device(device)
    t_phase = time.perf_counter()
    cfg = (slice_cfg or get_config(SLICE_ARCH)).replace(scan_layers=False)
    log(f"[slice and fleet path] {cfg.name}: {cfg.num_layers} layers, "
        f"d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, {cfg.mlp} d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
        f", tied {cfg.tie_embeddings}, {cfg.compute_dtype}; seeded random "
        f"weights, unrolled; a seeded pruning-only policy (ff keeps "
        f"{SLICE_KEEP[0]:.0%}-{SLICE_KEEP[1]:.0%} a layer), 1 x {seq} "
        f"prefills: raw, masked, sliced, sliced int8 / int4; {CARD}")
    release_cached_memory(device)
    t0 = time.perf_counter()
    cm = CompressibleLM(cfg, M.init(cfg, seed=0, device=device))
    grid = 128 if cfg.d_ff % 128 == 0 else 16
    policy = slice_policy(cm, 0, grid)
    cspec = cm.build_cspec(policy)
    keeps = ff_keeps(cspec)
    log(f"  params {M.param_count(cm.params) / 1e9:.3f} B, init "
        f"{time.perf_counter() - t0:.1f} s; ff keeps {keeps} (mean "
        f"{sum(keeps) / len(keeps) / cfg.d_ff:.3f} of {cfg.d_ff})")
    tokens = prefill_tokens(cfg, 1, seq, 0, device)
    out = {"keeps": keeps}
    if device.type == "cuda":
        out["k6"] = check_flash_attention_prefill(
            *layer_qkv(cfg, cm.params, tokens), causal=True)
    flops_raw = sliced_prefill_flops(cfg, None, seq)
    flops_cut = sliced_prefill_flops(cfg, cspec, seq)
    masked, sliced_keep = {}, {}
    predicted = oracle_prefill_ratio(cm, policy, seq)
    pre = {"raw": slice_prefill("raw", cfg, cm.params, tokens, flops_raw)}
    # the masked model multiplies every weight: its MFU counts them all
    pre["masked"] = slice_prefill("masked", cfg, cm.params, tokens,
                                  flops_raw, masked, cspec)
    t0 = time.perf_counter()
    sliced = slice_lm_params(cfg, cm.params, cspec)
    slice_s = time.perf_counter() - t0
    del cm
    pre["sliced"] = slice_prefill("sliced", cfg, sliced, tokens, flops_cut,
                                  sliced_keep)
    agree = compare_sliced(masked, sliced_keep)
    log(f"  sliced vs masked: argmax agreement {agree['argmax']:.4f} over "
        f"{seq} rows (>= {SLICE_ARGMAX_MIN}), max |logit diff| "
        f"{agree['max_diff']:.4g} over {SLICE_SAMPLE_ROWS} rows (<= "
        f"{SLICE_LOGIT_TOL}; their largest |logit| {agree['scale']:.4g}); "
        f"slice_lm_params {slice_s:.2f} s")
    if agree["argmax"] < SLICE_ARGMAX_MIN or \
            agree["max_diff"] > SLICE_LOGIT_TOL:
        raise AssertionError(f"the sliced model disagrees with the masked "
                             f"one: {agree}")
    del masked
    for bits in (8, 4):
        dep = quantize_params_for_deploy(sliced, bits)
        name = f"sliced int{bits}"
        keep = {}
        pre[name] = slice_prefill(name, cfg, dep, tokens, flops_cut, keep)
        pre[name]["argmax_vs_sliced"] = float(
            (keep["argmax"] == sliced_keep["argmax"]).float().mean())
        del dep, keep
    del sliced, sliced_keep
    release_cached_memory(device)
    measured = pre["sliced"]["ms"] / pre["raw"]["ms"]
    log(f"  sliced / raw: measured {measured:.4f}, the analytic oracle's "
        f"prediction {predicted:.4f} (V5E reference data); masked / raw "
        f"{pre['masked']['ms'] / pre['raw']['ms']:.4f}; int8 / sliced "
        f"{pre['sliced int8']['ms'] / pre['sliced']['ms']:.4f} (argmax vs "
        f"sliced {pre['sliced int8']['argmax_vs_sliced']:.4f}), int4 / "
        f"sliced {pre['sliced int4']['ms'] / pre['sliced']['ms']:.4f} "
        f"({pre['sliced int4']['argmax_vs_sliced']:.4f}); {CARD}")
    out.update(prefill=pre, agree=agree, predicted=predicted,
               measured=measured)
    launches["flash_attention_d128"] = launches.get(
        "flash_attention_d128", 0) + sum(
        p["launches"]["flash_attention"] for p in pre.values())
    out["smoke"] = check_slice_smoke(device, smoke_seq)
    log(f"  {time.perf_counter() - t_phase:.1f} s for the slicer")

    t_fleet = time.perf_counter()
    root = tempfile.mkdtemp(prefix="fleet_")
    try:
        build.reset_launches()
        out["cli"] = fleet_cli_resume(device, os.path.join(root, "cli"),
                                      cli_argv)
        cli_launches = dict(build.LAUNCHES)
        log(f"  launches of the three CLI runs: "
            f"{ {k: v for k, v in cli_launches.items() if v} }")
        out["testbed"] = testbed_fleet(
            device, lm_sens, fleet_cfg or LM_CFG, os.path.join(root, "lm"),
            members=fleet_members, epochs=fleet_epochs, warmup=warmup,
            updates=updates, batch_size=batch_size,
            val_batch=val_batch or VAL_BATCH, val_seq=val_seq or VAL_SEQ)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fleet_launches = {k: cli_launches[k] + out["testbed"]["launches"][k]
                      for k in cli_launches}
    if device.type == "cuda":
        missing = [k for k in ("fake_quant_slots_dev", "mlp3_members",
                               "mlp3", "polyak") if fleet_launches[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the fleet "
                                 f"path: {missing}")
    for k in ("fake_quant_slots_dev", "mlp3_members", "mlp3", "polyak"):
        launches[k] = launches.get(k, 0) + fleet_launches[k]
    out["fleet_launches"] = fleet_launches
    log(f"  {time.perf_counter() - t_fleet:.1f} s for the fleet; "
        f"{time.perf_counter() - t_phase:.1f} s for the phase")
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a GPU only", file=sys.stderr)
        return 2
    from repro_torch.configs.testbed import LM_CFG, VAL_BATCH, VAL_SEQ
    from repro_torch.core.ddpg import DDPGConfig
    from repro_torch.core.policy import n_actions
    from repro_torch.core.state import state_dim
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    global CARD
    CARD = smi

    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s for "
        f"{sorted(report) or 'nothing (cached)'}")
    for name, r in sorted(report.items()):
        for row in r["ptxas"]:
            log(f"  {name}: {row}")
    for name, mma in (("flash_attention", "HGMMA"), ("ssd_scan", "HGMMA"),
                      ("quant_matmul", "IGMMA")):
        sass = sass_counts(name, (mma, "UTMALDG"))
        log(f"  {name} SASS (cuobjdump -sass): {sass[mma]} {mma} "
            f"(wgmma), {sass['UTMALDG']} UTMALDG (TMA loads)")
        if not all(sass.values()):
            raise AssertionError(f"{name}'s tensor-core route compiled to "
                                 f"no wgmma or no TMA load: {sass}")

    log("[kernels] each kernel against its plain version on the card")
    A = n_actions("pq")
    S = state_dim(A)
    ddpg = DDPGConfig(state_dim=S, action_dim=A)
    batch = 64
    results = {
        "fake_quant": check_fake_quant(LM_CFG, device),
        "fake_quant_slots": check_fake_quant_slots(LM_CFG, device),
        "mlp3": check_mlp3(S, A, ddpg.hidden, (batch, ddpg.batch_size),
                           device),
        "polyak": check_polyak(ddpg_leaf_shapes(S, A, ddpg.hidden),
                               ddpg.tau, device),
        "mlp3_members": check_mlp3_members(S, A, ddpg.hidden, SLOTS,
                                           (1, 2, 3), 2, device),
        "adam_polyak": check_adam_polyak(S, A, ddpg.hidden, ddpg.critic_lr,
                                         ddpg.tau, (1, 3, 8), device),
        **check_quant_matmul(LM_CFG, device),
    }
    check_fake_quant_slot_split(device)
    k6_4096 = check_flash_attention(device)
    k8_4096 = check_ssd_scan(device)
    k7_4096 = check_rglru_scan(device)
    check_rglru_waves(device)
    check_rglru_back_to_back(device)
    for name, r in results.items():
        lib_ms = r["library_ms"]
        log(f"  {name} {r['shape']}: {r['ms'] * 1e3:.2f} us kernel "
            f"({r['paced_ms'] * 1e3:.2f} us per call paced by the host), "
            f"{r['plain_ms'] * 1e3:.2f} us plain, "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'} library,"
            f" bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}); "
            f"max err {r['max_abs_err']:.3g} (tol {r['tolerance']})")

    episodes, warmup, updates = 12, 4, 16
    log(f"[main path] pq CompressionSearch on {LM_CFG.name} "
        f"({LM_CFG.num_layers}L d={LM_CFG.d_model} {LM_CFG.compute_dtype}), "
        f"{episodes} episodes, warmup {warmup}, {updates} updates/episode, "
        f"DDPG batch {batch}")
    build.reset_launches()
    search, history, t_sens, t_eps = run_main_path(
        LM_CFG, device, episodes=episodes, warmup=warmup, updates=updates,
        batch_size=batch, val_batch=VAL_BATCH, val_seq=VAL_SEQ)
    launches = dict(build.LAUNCHES)
    log(f"  sensitivity {t_sens:.3f} s; {episodes} episodes in {t_eps:.3f} s "
        f"= {episodes / t_eps:.3f} episodes/s; launches {launches}")
    missing = [k for k in MAIN_PATH_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    steps = (episodes - warmup) * updates
    log(f"  K3: {launches['polyak']} launches for {steps} DDPG steps "
        f"({launches['polyak'] / steps:.2f} per step, both target networks "
        f"in each)")
    if launches["polyak"] != steps:
        raise AssertionError(f"K3 launched {launches['polyak']} times for "
                             f"{steps} DDPG steps, not once per step")
    check_main_path(search, history, LM_CFG, episodes)

    prof = profile_episodes(search, episodes, 2)
    log_profile(prof)
    per_step = {k: launches[k] / steps for k in ("mlp3", "polyak")}

    b_eps = 16
    log(f"[batched path] pq BatchedCompressionSearch on {LM_CFG.name}, "
        f"K {SLOTS} episodes per batch, {b_eps} episodes, warmup {warmup}, "
        f"{updates} updates per live episode, DDPG batch {batch}; the "
        f"scalar phase's seeds and sensitivity table")
    bsearch, bhist, t_b = run_batched_path(
        LM_CFG, device, search.sens, episodes=b_eps, warmup=warmup,
        updates=updates, batch_size=batch, slots=SLOTS,
        val_batch=VAL_BATCH, val_seq=VAL_SEQ)
    b_launches = dict(build.LAUNCHES)
    log(f"  {b_eps} episodes in {t_b:.3f} s = {b_eps / t_b:.3f} episodes/s "
        f"(scalar phase: {episodes / t_eps:.3f}, {episodes} episodes with "
        f"{warmup} warmup); {CARD}")
    b_check = check_batched_path(bsearch, bhist, LM_CFG, b_eps, b_launches,
                                 per_step, device)
    launches["fake_quant_slots"] = b_launches["fake_quant_slots"]
    b_prof = profile_episodes(bsearch, b_eps, 1)
    log_profile(b_prof)
    log(f"  steady state (every episode live): batched "
        f"{1 / b_prof['episode_s']:.3f} episodes/s, scalar "
        f"{1 / prof['episode_s']:.3f}: {prof['episode_s'] / b_prof['episode_s']:.3f}x; "
        f"{CARD}")
    del bsearch, b_check

    resnet = resnet_phase(device, batch)
    log(f"  ResNet launches: scalar {resnet['launches']}, batched "
        f"{resnet['slot_launches']}")

    fused = fused_phase(device, search.sens, resnet["sens"], batch, {
        "scalar": prof, "batched": b_prof, "resnet_scalar":
        resnet["profile"], "resnet_batched": resnet["batched_profile"]})
    results["fake_quant_slots_dev"] = fused["dev_row"]
    launches["fake_quant_slots_dev"] = fused["lm"]["epoch"]["launches"][
        "fake_quant_slots_dev"]
    if launches["fake_quant_slots_dev"] == 0:
        raise AssertionError("K1's device-bits entry never launched on the "
                             "fused path")

    pop = population_phase(device, search.sens, resnet["sens"], batch)
    launches["mlp3_members"] = pop["lm"]["launches"]["mlp3_members"]
    launches["adam_polyak"] = pop["resnet"]["launches"]["adam_polyak"]
    for name in ("mlp3_members", "adam_polyak"):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on the population "
                                 f"path")
    del pop

    log(f"[calibration path] launch.calibrate.run on {LM_CFG.name} at full "
        f"width (deploy-path units, K4/K5 kernel rows, raw/int8/int4 "
        f"deployed forwards, fit)")
    build.reset_launches()
    t0 = time.perf_counter()
    calib = run_calibration(LM_CFG, device)
    calib_launches = dict(build.LAUNCHES)
    log(f"  {time.perf_counter() - t0:.2f} s; launches {calib_launches}")
    missing = [k for k in CALIBRATION_KERNELS if calib_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the calibration "
                             f"path: {missing}")
    if calib_launches["quant_matmul_tc"] != sum(
            calib_launches[k] for k in CALIBRATION_KERNELS):
        raise AssertionError(f"K4/K5 left the tensor-core route on the "
                             f"calibration path: {calib_launches}")
    launches.update({k: calib_launches[k] for k in CALIBRATION_KERNELS})

    m_eps, m_warm = 8, 4
    log(f"[measured search] pq CompressionSearch, oracle_mode='measured' on "
        f"the fitted table, {m_eps} episodes, warmup {m_warm}, top 3 "
        f"re-timed")
    build.reset_launches()
    t0 = time.perf_counter()
    res = run_measured_search(LM_CFG, device, calib, episodes=m_eps,
                              warmup=m_warm, updates=4, batch_size=batch)
    log(f"  {time.perf_counter() - t0:.2f} s; reference latency "
        f"{res.ref_latency_s * 1e3:.4f} ms (calibrated oracle); launches "
        f"{dict(build.LAUNCHES)}")
    for r in res.measured:
        log(f"  top-K episode {r['episode']} reward {r['reward']:+.4f}: "
            f"predicted {r['predicted_s'] * 1e3:.4f} ms (ratio "
            f"{r['predicted_ratio']:.4f}), measured "
            f"{r['measured_s'] * 1e3:.4f} ms vs reference "
            f"{r['measured_ref_s'] * 1e3:.4f} ms (ratio "
            f"{r['measured_ratio']:.4f})")

    release_cached_memory(device)
    train = training_phase(device)
    release_cached_memory(device)
    trainer = trainer_phase(device)

    from repro_torch.core.compress import CompressibleLM
    from repro_torch.models import blocks as MB
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    qwen = get_config("qwen2-0.5b")
    log(f"[prefill] make_prefill_step on {qwen.name} ({qwen.num_layers}L "
        f"d={qwen.d_model} {qwen.num_heads}/{qwen.num_kv_heads} heads of "
        f"{qwen.head_dim}, vocab {qwen.vocab_size}, {qwen.compute_dtype}), "
        f"seeded random weights, 1 x {PREFILL_SEQ} tokens, uncompressed "
        f"and under a seeded pq policy")
    t0 = time.perf_counter()
    cm = CompressibleLM(qwen, M.init(qwen, seed=0, device=device))
    policy = seeded_policy(cm, 0)
    cspec = cm.build_cspec(policy)
    log("  policy (keep, w/a bits): " + " ".join(
        f"{s.name}:{c.keep}/{c.w_bits}/{c.a_bits}"
        for s, c in zip(cm.specs, policy.cmps)
        if c.w_bits < 32 or (s.prune_dim and c.keep < s.prune_dim)))
    k1_path = check_fake_quant_path(qwen, cspec,
                                    (PREFILL_SEQ, DECODE["batch"]), device)
    log(f"  K1 at the {k1_path['pairs']} (shape, bits) of the policy's "
        f"prefill and decode: max |kernel - plain| "
        f"{k1_path['max_abs_err']:.3g} (tol 0)")
    pre = run_prefill(qwen, cm.params, cspec, device, PREFILL_SEQ,
                      PREFILL_WARM_SEQ)
    results["flash_attention"] = pre["k6"]
    launches["flash_attention"] = sum(
        pre[n]["launches"]["flash_attention"] for n in ("uncompressed",
                                                         "policy"))
    k6_ms = pre["k6"]["ms"] * qwen.num_layers
    for n in ("uncompressed", "policy"):
        log(f"  {n}: K6 {qwen.num_layers} x {pre['k6']['ms']:.3f} ms = "
            f"{k6_ms:.1f} ms, {k6_ms / 1e3 / pre[n]['seconds']:.1%} of "
            f"the forward")
    log_prefill_profile(qwen, cm.params, device)
    predicted = oracle_prefill_ratio(cm, policy, PREFILL_SEQ)
    measured = pre["policy"]["seconds"] / pre["uncompressed"]["seconds"]
    log(f"  compressed / reference: predicted {predicted:.4f} (analytic "
        f"oracle, V5E reference data), measured {measured:.4f}")
    check_prefill_numerics(get_config("qwen2-0.5b", smoke=True), device,
                           1100)
    log(f"  {time.perf_counter() - t0:.1f} s for the prefill phase")
    finish_cpu_lm_trainer(train["cpu_lm"], train["lm"]["acc"])

    log(f"[decode] decode_loop and sustained_throughput on {qwen.name}, "
        f"batch {DECODE['batch']}, {DECODE['steps']} steps, max_len "
        f"{DECODE['max_len']}")
    t0 = time.perf_counter()
    run_decode(qwen, cm.params, {"uncompressed": None, "policy": cspec},
               **DECODE)
    for name, cs in (("uncompressed", None), ("policy", cspec)):
        prof = profile_decode(qwen, cm.params, cs, batch=DECODE["batch"],
                              steps=8, max_len=DECODE["max_len"])
        busy = prof["device_busy_s"]
        log(f"  {name}, 16-bit cache, profiled: {prof['step_s'] * 1e3:.2f} "
            f"ms per step (unprofiled), device busy {busy * 1e3:.2f} ms "
            f"({busy / prof['step_s']:.1%}), "
            f"{prof['kernels_per_step']:.0f} kernels per step; top device "
            f"time over 8 steps (us):")
        for t, key, n in prof["top"]:
            log(f"    {t:10.1f}  x{n:<6d} {key[:80]}")
    check_decode_consistency(get_config("qwen2-0.5b", smoke=True), device)
    log(f"  {time.perf_counter() - t0:.1f} s for the decode phase")

    mamba = get_config("mamba2-780m")
    d_inner, nheads, _ = MB.ssm_dims(mamba)
    log(f"[mamba2 prefill] make_prefill_step on {mamba.name} "
        f"({mamba.num_layers} SSD layers, d={mamba.d_model}, d_inner "
        f"{d_inner}, {nheads} heads of {mamba.ssm.head_dim}, state "
        f"{mamba.ssm.d_state}, chunk {mamba.ssm.chunk_size}, vocab "
        f"{mamba.vocab_size}, {mamba.compute_dtype}), seeded random weights,"
        f" 1 x {PREFILL_SEQ} tokens, uncompressed and under a seeded pq "
        f"policy; {CARD}")
    t0 = time.perf_counter()
    del cm
    cm = CompressibleLM(mamba, M.init(mamba, seed=0, device=device))
    policy = seeded_policy(cm, 0)
    m_cspec = cm.build_cspec(policy)
    log("  policy (keep, w/a bits): " + " ".join(
        f"{s.name}:{c.keep}/{c.w_bits}/{c.a_bits}"
        for s, c in zip(cm.specs, policy.cmps)
        if c.w_bits < 32 or (s.prune_dim and c.keep < s.prune_dim)))
    k1_m = check_fake_quant_path(mamba, m_cspec,
                                 (PREFILL_SEQ, DECODE["batch"]), device)
    log(f"  K1 at the {k1_m['pairs']} (shape, bits) of the policy's "
        f"prefill and decode: max |kernel - plain| "
        f"{k1_m['max_abs_err']:.3g} (tol 0)")
    pre_m = run_prefill(mamba, cm.params, m_cspec, device, PREFILL_SEQ,
                        PREFILL_WARM_SEQ)
    results["ssd_scan"] = pre_m["k8"]
    launches["ssd_scan"] = sum(
        pre_m[n]["launches"]["ssd_scan"] for n in ("uncompressed",
                                                    "policy"))
    k8_ms = pre_m["k8"]["ms"] * mamba.num_layers
    for n in ("uncompressed", "policy"):
        log(f"  {n}: K8 {mamba.num_layers} x {pre_m['k8']['ms']:.3f} ms = "
            f"{k8_ms:.1f} ms, {k8_ms / 1e3 / pre_m[n]['seconds']:.1%} of the"
            f" forward")
    log_prefill_profile(mamba, cm.params, device)
    predicted = oracle_prefill_ratio(cm, policy, PREFILL_SEQ)
    measured = pre_m["policy"]["seconds"] / pre_m["uncompressed"]["seconds"]
    log(f"  compressed / reference: predicted {predicted:.4f} (analytic "
        f"oracle, V5E reference data), measured {measured:.4f} ({CARD})")
    check_prefill_numerics(get_config("mamba2-780m", smoke=True), device,
                           1100, min_agree=1.0)
    log(f"  {time.perf_counter() - t0:.1f} s for the mamba2 prefill phase")

    log(f"[mamba2 decode] decode_loop and sustained_throughput on "
        f"{mamba.name}, batch {DECODE['batch']}, {DECODE['steps']} steps, "
        f"conv/state cache; {CARD}")
    t0 = time.perf_counter()
    run_decode(mamba, cm.params, {"uncompressed": None, "policy": m_cspec},
               **DECODE, cache_bits=(16,))
    for name, cs in (("uncompressed", None), ("policy", m_cspec)):
        prof = profile_decode(mamba, cm.params, cs, batch=DECODE["batch"],
                              steps=8, max_len=DECODE["max_len"])
        busy = prof["device_busy_s"]
        log(f"  {name}, profiled: {prof['step_s'] * 1e3:.2f} ms per step "
            f"(unprofiled), device busy {busy * 1e3:.2f} ms "
            f"({busy / prof['step_s']:.1%}), "
            f"{prof['kernels_per_step']:.0f} kernels per step; top device "
            f"time over 8 steps (us):")
        for t, key, n in prof["top"]:
            log(f"    {t:10.1f}  x{n:<6d} {key[:80]}")
    check_decode_consistency(get_config("mamba2-780m", smoke=True), device)
    log(f"  {time.perf_counter() - t0:.1f} s for the mamba2 decode phase")

    del cm
    recurrentgemma_phases(device, results, launches)
    moe_frontend_phase(device, results, launches)
    slice_fleet_phase(device, search.sens, results, launches)

    for r in k6_4096.values():
        log(f"  flash_attention at S 4096 {r['shape']}: {r['ms']:.4f} ms "
            f"kernel, {r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} "
            f"ms SDPA, bound {r['bound_ms']:.4f} ms; max err "
            f"{r['max_abs_err']:.3g}, max row rel {r['row_rel_err']:.3g}")
    r = k8_4096
    log(f"  ssd_scan at S 4096 {r['shape']}, route {r['route']}: "
        f"{r['ms']:.4f} ms kernel, {r['plain_ms']:.4f} ms chunked plain, "
        f"bound {r['bound_ms']:.4f} ms f32 ({r['bound_by']}), "
        f"{r['tc_bound_ms']:.4f} ms split TF32; max err "
        f"{r['max_abs_err']:.3g}, max row rel {r['row_rel_err']:.3g} "
        f"({CARD})")
    r = k7_4096
    log(f"  rglru_scan at S 4096 {r['shape']}: {r['ms']:.4f} ms kernel, "
        f"{r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}); max err {r['max_abs_err']:.3g}, max row rel "
        f"{r['row_rel_err']:.3g} ({CARD})")
    # the trainer path's training launches (not its autograd checks)
    launches["flash_attention"] += trainer["launcher"]["k6"]
    launches["ssd_scan"] += trainer["mamba2"]["k8"]
    launches["rglru_scan"] += trainer["recurrentgemma"]["rglru_scan"]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all, the "
        f"kernels' build included")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "launches": launches[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in results.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
