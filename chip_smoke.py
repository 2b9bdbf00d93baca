#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Thirty-three phases, each printing a line or a few; any failed check ends the
run with a nonzero exit and no result line:

1. device: the card, its power limit, torch and the kernels' build time
   (every kernel is built from ``src/repro_torch/kernels/csrc/`` here);
2. kernel: the segmented matmul kernel against its plain PyTorch version
   at the full-width qwen3-4b and mamba2-130m projection shapes, passes
   1/2/3, fp32 and bf16 activations, within 64 ulps of the largest output;
   every row of a call equal to the same row at M = 1, bit for bit, for
   every M the serve phases give it and 300; whisper-tiny's projections
   (M = 4, 32 and 6000, rows M-invariant at all three) and the wide
   projections of gemma2-9b, gemma3-12b and minitron-8b (M = 4 and 32,
   rows M-invariant) within the same bound, whisper's cross-attention K/V
   (M 6000) and a decode layer of each dense decoder timed beside their
   bounds; the projections of qwen2-vl-72b, llama4-maverick (experts,
   attention, dense MLP) and deepseek-v3 (MLA, experts, dense MLP) at M =
   4, 16 and 32 within the bound and M-invariant, a qwen2-vl decode layer
   (M 4) and a llama4 and a deepseek expert projection (M 16) timed beside
   their bounds; the zamba2-7b projections
   (in_proj N 14576, out_proj, the shared block's seven) checked at M = 4
   and 32 and timed at 4 and 150, with the kernel time of a zamba2 decode
   step's 227 projections beside its bound; timed at M = 1, 4, 32 and 150
   (and 2048 once) with CUDA events behind a device spin (L2 flushed
   before every call by writing 64 MB) beside the plain version, a bf16
   ``torch.matmul`` yardstick, a ``torch.sum`` of the weight (its bytes
   read once, at the decode layer's shapes), the launch floor and the
   card's bound, with the call's host time and the wrapper's host
   microseconds a call (timings to ``chiprun_out/chip_smoke_kernels.json``);
3. serve: full-width qwen3-4b (36 layers, seeded random weights) served by
   the continuous-batching engine under the premium/standard/bulk tiers;
   every request completes, the kernel ran 7 x 36 + 1 times a forward
   under every tier (the exact tier's products and every tier's LM head
   are K1 at one pass), and every request's tokens equal a solo
   ``Session.generate`` under its tier's policy bit for bit.  Then the
   batch-invariance probe on its weights, bit for bit under each tier: a
   decode step's row among 4 slots against the row decoded alone at the
   same cache; a 150-token prompt prefilled whole against the engine's
   chunks of 32 (the last logits and every K/V row); the rows of each
   site (each tier's projections, the LM head, ``rmsnorm``, the blockwise
   attention) at M = 1 / 4 / 32 against M = 150; and the exact tier
   within 64 ulps of its former fp32 SGEMM form and equal to segmented1
   (``chiprun_out/chip_smoke_invariance.json``);
4. bitwise: the bit-level AFPM kernel against its plain PyTorch version on
   the card, bit for bit (NaNs by NaN-ness): the four golden cases of
   ``tests/golden/afpm_golden.json``, every AFPM registry entry and two
   ablation configs on seeded inputs full of specials at (512, 512), a
   ragged (3, 1001, 7) and a broadcast 0-d scalar; timed at (512, 512) and
   (8192, 8192) beside the plain version, ``torch.mul`` of the same shapes
   (the same bytes, not the same function) and the card's bound, with the
   instructions per element counted from the kernel's SASS (its 16-byte
   loop, four elements an iteration; timings to
   ``chiprun_out/chip_smoke_bitwise.json``);
5. emulated: the bit-level kernel's emulated-matmul entry.  At K = 1 (one
   chunk) it equals +0 plus the elementwise kernel's product bit for bit
   for every AFPM registry entry and the two ablations, on inputs full of
   specials; ResNet-18's matmul shapes at 8 and 48 images under
   AC4-4/5-5/6-6 and ACL5, ragged shapes, leading dims, k_chunk 16/64 and
   AC-fp16/bf16 through ``nmatmul`` within 64 ulps of the plain version;
   rows independent of M (1-300) bit for bit, split-mode rows against
   whole-mode rows among them; two calls equal; stage 0's conv and stage
   3's conv2 at 48 images timed (and held to 64 ulps) beside the plain
   version and the bound (products x the operations a product needs over
   the instruction rate, or the bytes), with the built inner loop's SASS
   instructions a product by pipe; the straight-through gradient against
   the plain route's within 1e-5 (``chiprun_out/chip_smoke_emulated.json``);
6. table3: the paper's Table III image pipeline through the kernel: at
   size 96 with 2 pairs its 24 PSNRs equal the JAX package's own CPU run
   (``benchmarks/BENCH_cpu_ci.json``) to 1e-9 dB; at 512 x 512 with 3
   pairs (the size of the paper's test images) the kernel route and the
   plain route give bit-identical images for all 12 designs, and the
   kernel route launches the kernel exactly 192 times;
7. ssd: the SSD chunked-scan kernel against its plain PyTorch version on
   the card, within 64 ulps of the largest output: the full-width
   mamba2-130m shapes (batch 1 and 4; L = 40, 77 and 150, padded to 256,
   as the serve phase's prompts give them, and 2048;
   H 24, P 64, N 128, chunk 128) and the reduced config's ragged shape
   (N 16, P 8, Q 16, L 50), and zamba2-7b's (H 112, P 64, N 64; batch 1
   and 4 at L = 40, 77 and 150), batch 4 equal to batch 1 row by row bit
   for bit and two calls equal bit for bit; timed at the serve path's
   prefill shapes (zamba2's at L = 150) and at L = 2048 beside the plain
   version, the card's bound (the
   FMAs ``y`` needs, ``ssd_scan.fmas``, or the bytes) and phase 2's launch
   floor, with the kernels a call launches (no PyTorch call computes the
   scan, so there is no library time);
8. mamba2: full-width mamba2-130m (24 SSD layers, seeded random weights)
   served by the engine under the premium/standard/bulk tiers with
   whole-prompt prefill; every request completes, the scan kernel ran 24
   times per prefill and the segmented matmul 49 times a forward under
   every tier, every request's tokens equal a solo ``Session.generate``
   under its tier, and the prefill logits of a full-width prompt of
   each served length through the kernels agree with the plain route's on
   the card;
9. zamba2: full-width zamba2-7b (68 SSD blocks and one shared attention +
   MLP block applied 13 times, 5.74 B fp32 params seeded on the card)
   served as phase 8 serves mamba2 (the shared block's 13 KV caches paged,
   the SSD states per slot, whole-prompt prefill); every request
   completes, the scan kernel ran 68 times per prefill and the segmented
   matmul 228 times a forward under every tier, every request's tokens
   equal a solo ``Session.generate`` under its tier, a decode step's row
   among 4 equals it alone under each tier, and the prefill logits
   through the kernels agree with the plain route's (2**-6 of the
   largest); per tier decode ms a step, prefill ms, tok/s and a solo
   generate's peak memory
   (``chiprun_out/chip_smoke_zamba2.json``);
10. cli: the session CLI on the card, ``main(argv)`` as ``python -m
   repro_torch.session`` runs it: ``generate --arch zamba2-7b``,
   ``serve-loop --weights tests/golden/compat/qwen3-4b`` under premium and
   standard, ``ppa`` and ``auto-configure --arch zamba2-7b`` (the reduced
   configs), each exit 0 (lines to ``chiprun_out/chip_smoke_cli.txt``);
   the fixture's params through ``Session.from_pretrained`` on the card
   equal ``qwen3-4b_reference.npz`` bit for bit;
11. whisper: full-width whisper-tiny (61.07 M seeded params) through
   ``transformer.prefill`` / ``decode_step`` (the reference has no whisper
   ``generate`` and no whisper serving): 4 x 1500 seeded frames, an
   8-token prompt and 32 greedy tokens under exact, segmented3 and
   segmented1; the segmented matmul 73 times a prefill (28 in the
   encoder, 44 in the decoder, the LM head) and 45 a decode step, under
   every tier;
   the kernel route's prefill and decode logits within 2**-6 of the plain
   route's fed the same tokens; the committed whisper-tiny checkpoint
   through ``Session.from_pretrained`` on the card bit for bit equal to
   ``whisper-tiny_reference.npz``; encoder ms, prefill ms and ms a decode
   step per tier;
12. gemma2: full-width gemma2-9b (42 layers, sliding window and softcaps,
   9.24 B seeded params) served as phase 3 serves qwen3-4b; every request
   completes, the segmented matmul ran 295 times a forward under every
   tier, every request's tokens equal a solo ``Session.generate`` under
   its tier, and every logit
   the engine computes lies within the softcap of 30; per tier decode ms
   a step, prefill ms a chunk, tok/s and a solo generate's peak memory
   (``chiprun_out/chip_smoke_gemma2.json``);
13. dense-zoo: full-width gemma3-12b (one 1200-token prompt, past the
   1024 window of 40 of its 48 layers) and then minitron-8b (batch 4,
   40-token prompts), each a solo ``Session.generate`` of 16 tokens under
   standard: 337 and 225 segmented-matmul launches a forward, and the
   kernel route's prefill logits within 2**-6 of the plain route's;
   gemma3's prompt also through the engine under the three tiers (4
   slots, chunks of 256, ``max_len`` 1216: the window masks over the
   paged cache), each tier's tokens equal to its solo generate's;
14. qwen2-vl: full-width qwen2-vl-72b (M-RoPE) cut to 8 of its 80 layers
   (38 GB seeded) served as phase 3 serves qwen3-4b: every request
   completes, 57 segmented-matmul launches a forward under every tier,
   every tier's tokens equal its solo generate; then the vision stub
   through the model API: a
   prefill of seeded patch embeddings (1, 256, d) at a 16 x 16 image's
   3-D positions and 8 greedy decode steps, the kernel route's logits
   within 2**-6 of the plain route's;
15. llama4: full-width llama4-maverick (experts at d_ff 8192, top-1 plus
   a shared expert) cut to one (moe, dense) repeat and 64 of 128 experts
   (42.5 GB) served alike with prefill chunks of 160 (a routing group's
   capacity depends on its length, so a prompt is routed whole as a solo
   prefill routes it): 207 launches a forward under every tier (192
   expert projections; the exact tier's one launch an expert projection
   on the card), every tier == solo, a 150-token prefill's kernel-route
   logits within
   2**-6 of the plain route's;
16. deepseek: full-width deepseek-v3 (MLA, 256 experts, top-8, a shared
   expert) cut to one dense-MLA and one MoE-MLA layer (55.8 GB) served as
   phase 15 with its latent caches paged: 783 launches a forward (768
   expert projections), every tier == solo, a decode step's row among 4
   equal to it alone under each tier, the router's rows at M = 1 / 4 / 32
   equal to M = 150, kernel-route logits within 2**-6; a decode step's ms
   per tier beside the byte bound of its 768 expert projections
   (``chiprun_out/chip_smoke_giants.json`` for the three);
17. train-grad: one full-width mamba2-130m training step (8 x 128 tokens,
   remat full) through the kernels and through the plain route on the
   same params and batch: with fp32 activations under segmented3 (K1
   and K3) every leaf's gradient within 2**-6 of the plain route's
   largest (the plain K1 takes K1's own backward), and of PyTorch's
   autograd of the plain version, a reference independent of that
   backward; under exact, K3 alone (K1 on both routes) within 2**-6, and
   K1 at one pass with K3 within 2**-6 on the model cut to its first 2
   layers; under exact at 24 layers and with the config's bf16
   activations under segmented3 finite gradients, the difference printed
   beside the plain route's own spread when its K1 outputs move by one
   ulp (the early layers' gradients are chaotic there at init: every
   product rounds its operands to bf16); K1 and K3 launches a step (the
   remat recompute runs each forward twice; the exact tier and the LM
   head of each loss chunk run K1 too);
18. train-qwen3: four full-width qwen3-4b steps (8 x 128 tokens) through
   ``repro_torch.launch.train.train`` (AdamW, fp32 moments, remat full, 8
   loss chunks): finite losses, the first near sqrt(d_model) (the
   untrained tied model predicts its input token), parameters changed;
   ms a step, tokens/s, peak memory, and the last step under
   ``torch.profiler``;
19. train-mamba2: full-width mamba2-130m trained 30 steps (lr 3e-3), the
    loss falling, K1 (exact, at one pass) and K3 launches counted, the
    last step profiled; then the
    reduced qwen3-4b trained 20 steps with a checkpoint every 10, and a
    second run restored from the step-10 checkpoint alone ends on the
    same bits;
20. train-resnet: Table IV's ResNet-18 at full width trained as the
    reference trains it (120 steps of 64 ``cifar_like`` images, AdamW;
    two short trainings first, equal bit for bit), then top-1 on the
    reference's 48 evaluation images under exact (at least 0.9), segmented 1/2/3 (K1, 21 launches a forward) and the eight
    designs emulated, beside the paper's values; the AFPM designs' emulated
    matmuls run the bit-level kernel (21 launches a forward each, 84 in
    all), and AC5-5's 48-image forward is timed on the plain route too, at
    least 10x slower, its logits within 1e-4 of the kernel route's
    (``chiprun_out/chip_smoke_train.json``);
21. resnet: the paper's Table IV network.  The committed resnet18
   checkpoint loads through ``Session.from_pretrained`` onto the card bit
   for bit equal to ``resnet18_reference.npz``; then the full-width
   ResNet-18 trained in phase 20 on 256 ``cifar_like`` images: top-1 and
   argmax agreement per mode; exact (the native conv with TF32 off) beside
   the same forward with TF32 on and the fp32 im2col route; segmented
   1/2/3 through the segmented matmul kernel, 21 launches a forward,
   every conv within 64 ulps of the plain version on the same operands and
   the logits within 2**-6 of the plain route's; the kernel timed at
   stage 0's conv shape (M 262144, K 576, N 64); the eight designs' rows
   from phase 20, their emulated-matmul launches a forward (21 for an AFPM
   design, 0 for a baseline), and AC5-5 at batch 8 through the kernel
   against the plain route conv by conv (64 ulps) and by its logits
   (1e-4); the
   proxy auto-configurer on 32 calibration images,
   whose emitted policy then runs.  ms a forward per mode on the host
   clock around a synced call, and one forward per mode (exact,
   segmented3, emulated AC5-5 at batch 8, at most 1000 device kernels)
   under ``torch.profiler``: device time by kernel group and the card's
   busy share (``chiprun_out/chip_smoke_resnet.json``).

22. tune (run right after phase 3, on its weights): the kernel autotuner
   (``repro_torch.kernels.autotune.sweep``) times every candidate launch
   shape with ``timed_ms`` (behind a spin, after the 64 MB flush): K1's
   tiles at qwen3-4b's projections at M = 4 and 150, K2's elementwise CTA
   shape at 512^2 and 8192^2 (AC5-5), K3's chunk at mamba2's and zamba2's
   150-token layers on both routes; every K1 and K2 candidate equal to the
   static launch's output bit for bit, every K3 candidate within 64 ulps
   of ``ssd_scan_chunked_ref``; the artifact written to
   ``chiprun_out/TUNE_<device_kind>.json``, loaded back and activated; a
   table of another device kind changes no call; a full-width
   ``Session(tune=).generate`` under standard equals the untuned tokens;
   each key's winner printed beside the static choice's time; the table
   is dropped after the phase (``chiprun_out/chip_smoke_launch.json``
   for phases 22-24);
23. launch (after phase 22, on phase 3's weights): ``ContinuousBatcher``
   with 2 slots serves 5 requests through full-width qwen3-4b under
   segmented3: every request completes, 7 x 36 + 1 K1 launches a forward,
   and one request's tokens equal a manual greedy loop's;
24. dryrun (after phase 18): ``python -m repro_torch.launch.dryrun --arch
   qwen3-4b --shape <s> --both-meshes`` for the four shapes, and for
   llama4-maverick-400b-a17b train_4k and deepseek-v3-671b prefill_32k on
   16 x 16 (expert parallelism on the fake group), one subprocess each,
   every record ok or skipped (``chiprun_out/dryrun/``), each counted on
   the placed step over a fake process group of 256 or 512 CUDA ranks:
   one chip's peak and collective bytes by kind, printed per cell and
   mesh; at a 1 x 1 mesh the dry-run
   of phase 18's
   step (8 x 128 tokens, AdamW) has argument bytes equal to the bytes of
   the tensors that step took, and its peak estimate is printed beside
   phase 18's measured peak;
25. dist (right after phase 16, on its weights): the code over ranks on
   a one-rank NCCL group (``make_test_mesh((1, 1))``, destroyed at the
   end of the phase): deepseek-v3's MoE layer at full width through the
   expert-parallel path (``all_to_all`` dispatch, K1 on each of the 256
   local experts) in a 4-slot decode step, equal to the group-local path
   bit for bit, within 64 ulps of the plain route, 771 K1 launches a
   call and 2 x E x C x D x 4 all-to-all bytes counted; the group-local
   decode timed again after it, and once with every K1 call through its
   custom op (bit for bit); a 256-token
   prefill through it against the plain route; ``pipeline_apply`` over a
   ``("pipe",)`` mesh of 1 with 4 full-width qwen3-4b blocks as its stage
   (4 microbatches) equal to the blocks in sequence bit for bit;
   ``hierarchical_grad_reduce(compress=True)`` over one block's
   gradient-shaped tree within max|g|/100, its error feedback the
   residual; each time beside the card's name and power limit;
26. placed (right after phase 25): whole-model placement on a one-rank
   NCCL group (``make_test_mesh((1, 1))``): a freshly seeded full-width
   qwen3-4b placed by the serve rules (``sharding.place``: DTensor params
   and batch), a 40-token prefill of 2 prompts and 8 greedy decode steps
   through ``launch.steps`` under premium, standard and bulk, equal to the
   same weights unplaced bit for bit (every step's logits and the
   tokens), with equal K1 launches ((7 x 36 + 1) x 9 under every tier,
   the exact tier's through K1 at one pass), and every K1 call of a
   placed standard prefill, the LM head's included, dispatched by
   DTensor through ``repro_torch::afpm_matmul``; a full-width
   mamba2-130m prefill (4 x 150 tokens) placed, through K3
   (``repro_torch::ssd_scan``), bit for bit;
   the host ms of each placed step beside the unplaced one, DTensor's
   host microseconds an ATen op of a decode step, and K1's host
   microseconds a call on plain tensors through its wrapper (the route of
   an unplaced step) and through its op;
27. train-zamba2 (right after phase 19): full-width zamba2-7b cut to 7 of
   its 13 (5 SSD + shared attention) repeats and its 3-block SSD tail (45
   layers, 3.40 B params) seeded on the card and trained 4 steps of 8 x
   128 tokens as ``launch.train.train`` trains an arch (its optimizer,
   AdamW with fp32 moments here, ``steps.make_train_step``, remat full,
   the config's loss pieces): finite losses, every leaf moved, K1 and K3
   launches a step equal to the count reckoned from the parameter shapes
   (K3 at H 112, N 64); ms a step, tokens/s, peak memory beside the bytes
   of params, gradients and optimizer state; then the gradient gate on one
   SSD block and the shared block with fp32 activations: the kernel
   route's gradients against the plain route's on the same params and
   batch, every leaf within 2**-6 of the plain route's largest, under
   segmented3 and under exact;
28. train-llama4: full-width llama4-maverick cut to one (moe, dense)
   repeat and 8 of its 128 experts (3.58 B params; Adafactor, 8
   micro-batches, one K1 launch an expert projection) trained and gated
   as phase 27 (the gate on the same two layers; both routes route every
   token to the same expert, else the gate names the token and its router
   margin; top-1's router gradient, rounding noise on both routes, held
   to 1e-6 of the largest leaf's);
29. train-deepseek: full-width deepseek-v3 cut to one dense-MLA and one
   MoE-MLA layer with 16 of its 256 experts (3.37 B params, capacity 80
   an expert a row) trained and gated as phase 28; then the reduced
   config trained 20 steps with a checkpoint every 10, and a second run
   restored from the step-10 checkpoint alone ends on the same bits;
30. train-gemma2 (right after phase 29): full-width gemma2-9b cut to 7 of
   its 21 (local 4096, global) repeats (14 layers, 3.69 B params; AdamW;
   the attention softcap 50 and the logit softcap 30 under autograd, the
   tied 256000 x 3584 table K1's x in the head and its gradient summed
   over the head and the embedding gather) trained and gated as phase 27,
   the gate on one repeat;
31. train-gemma3: full-width gemma3-12b cut to 2 of its 8 (5 local 1024 +
   1 global) repeats (12 layers, 3.70 B params) trained on 2 x 1280
   tokens, rows longer than the window, so that 10 layers mask in the
   forward and in the remat recompute (the loss one piece), and gated as
   phase 27 at the same size on (local, global);
32. train-minitron: full-width minitron-8b cut to 6 of its 32 layers (3.56
   B params, the untied 256000 x 4096 head), trained and gated as phase
   27 on 2 layers;
33. train-qwen2-vl: full-width qwen2-vl-72b cut to 4 of its 80 layers
   (6.00 B fp32 params, as the trainer seeds every config; Adafactor, 4
   micro-batches, M-RoPE) trained on the token stream and gated as phase
   27 on 2 layers, on the token path and on the image path (seeded patch
   embeddings at 3-D positions, the token stream's targets; the token
   table's gradient exactly 0 on both routes).

Then one JSON line on the kernels, the card's name and power limit, and
the result line.  Per-shape kernel timings go to
``chiprun_out/chip_smoke_kernels.json``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import pathlib
import re
import subprocess
import sys
import time
import unittest.mock

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ULP_BOUND = 64
D, FF, KVD = 2560, 9728, 1024
# (K, N) of the seven projections of one qwen3-4b layer: wq, wk, wv, wo,
# mlp.wi, mlp.wg, mlp.wo
LAYER_PROJ = [(D, 4096), (D, KVD), (D, KVD), (4096, D), (D, FF), (D, FF),
              (FF, D)]
SHAPES = sorted(set(LAYER_PROJ))
# (K, N) of mamba2-130m's segmented projections: in_proj, out_proj
MAMBA2_PROJ = [(768, 3352), (1536, 768)]
# (K, N) of zamba2-7b's: an SSD block's in_proj (N 14576 = 16 x 911) and
# out_proj, the shared block's wq / wk / wv / wo (3584 x 3584), mlp.wi /
# mlp.wg and mlp.wo
ZD, ZFF, ZIN = 3584, 14336, 14576
ZAMBA2_PROJ = [(ZD, ZIN), (2 * ZD, ZD), (ZD, ZD), (ZD, ZFF), (ZFF, ZD)]
# one zamba2-7b forward's K1 calls: 68 SSD blocks x (in_proj, out_proj) and
# 13 applications of the shared block x 7 projections: 227
ZAMBA2_STEP = ([(ZD, ZIN), (2 * ZD, ZD)] * 68
               + [(ZD, ZD)] * 4 * 13 + [(ZD, ZFF)] * 2 * 13 + [(ZFF, ZD)] * 13)
# whisper-tiny (d 384, d_ff 1536): its encoder's 1500 frames at batch 4
# give the encoder's projections and the cross-attention's K/V projections
# (both recomputed in every decode step, as the reference does) M = 6000
WD, WFF, WHISPER_M = 384, 1536, 4 * 1500
WHISPER_PROJ = [(WD, WD), (WD, WFF), (WFF, WD)]
# (K, N) of one decode layer's seven projections (wq, wk, wv, wo, mlp.wi,
# mlp.wg, mlp.wo) of the three dense decoders of phases [gemma2] and
# [dense-zoo]
GEMMA2_LAYER = [(3584, 4096), (3584, 2048), (3584, 2048), (4096, 3584),
                (3584, 14336), (3584, 14336), (14336, 3584)]
GEMMA3_LAYER = [(3840, 4096), (3840, 2048), (3840, 2048), (4096, 3840),
                (3840, 15360), (3840, 15360), (15360, 3840)]
MINITRON_LAYER = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096),
                  (4096, 16384), (4096, 16384), (16384, 4096)]
ZOO_LAYERS = {"gemma2-9b": GEMMA2_LAYER, "gemma3-12b": GEMMA3_LAYER,
              "minitron-8b": MINITRON_LAYER}
# those not among zamba2-7b's (gemma2's MLP shapes are)
ZOO_PROJ = sorted(set(GEMMA2_LAYER + GEMMA3_LAYER + MINITRON_LAYER)
                  - set(ZAMBA2_PROJ))
# (K, N) of the last three families' projections.  qwen2-vl-72b: one
# layer's seven (d 8192, 64 heads of 128 over 8 KV heads, d_ff 29568)
QWEN2VL_LAYER = [(8192, 8192), (8192, 1024), (8192, 1024), (8192, 8192),
                 (8192, 29568), (8192, 29568), (29568, 8192)]
# llama4-maverick (d 5120, 40 heads of 128 over 8): attention, an expert's
# (and the shared expert's) wi / wg / wo, the dense layers' MLP
LLAMA4_ATTN = [(5120, 5120), (5120, 1024), (5120, 1024), (5120, 5120)]
LLAMA4_EXPERT = [(5120, 8192), (5120, 8192), (8192, 5120)]
LLAMA4_DENSE = [(5120, 16384), (5120, 16384), (16384, 5120)]
# deepseek-v3 (d 7168, 128 heads): MLA's wq_a, wq_b (q rank 1536 -> 128 x
# 192), wkv_a (kv rank 512 + rope 64) and wo; an expert's; the dense MLP
DSV3_MLA = [(7168, 1536), (1536, 24576), (7168, 576), (16384, 7168)]
DSV3_EXPERT = [(7168, 2048), (7168, 2048), (2048, 7168)]
DSV3_DENSE = [(7168, 18432), (7168, 18432), (18432, 7168)]
GIANT_PROJ = sorted(set(QWEN2VL_LAYER + LLAMA4_ATTN + LLAMA4_EXPERT
                        + LLAMA4_DENSE + DSV3_MLA + DSV3_EXPERT + DSV3_DENSE))
# the depths and expert counts the card runs: qwen2-vl 8 of 80 layers;
# llama4 one (moe, dense) repeat of 24 with 64 of 128 experts; deepseek one
# dense and one MoE layer of 3 + 58, every one of the 256 experts
QWEN2VL_LAYERS, LLAMA4_EXPERTS = 8, 64
# K1 calls of a forward's projections (the LM head adds one): 7 a
# qwen2-vl layer; llama4's MoE layer 4 + 3 x 64 + 3 (shared), its dense
# layer 7; deepseek's dense-MLA layer 4 + 3, its MoE-MLA layer 4 + 3 x
# 256 + 3
QWEN2VL_STEP = QWEN2VL_LAYER * QWEN2VL_LAYERS
LLAMA4_STEP = (LLAMA4_ATTN + LLAMA4_EXPERT * LLAMA4_EXPERTS + LLAMA4_EXPERT
               + LLAMA4_ATTN + LLAMA4_DENSE)
DSV3_STEP = DSV3_MLA + DSV3_DENSE + DSV3_MLA + DSV3_EXPERT * 256 + DSV3_EXPERT
# M of an expert's K1 call in a 4-slot decode step: 4 rows x capacity 4
EXPERT_M = 16
# phase [dist]: the expert-parallel decode step's slots (capacity 4 from 4
# tokens: no drops, an expert's K1 call at 4 rows) and its prefill's
# tokens; the pipeline's stage (qwen3-4b blocks at full width), its
# microbatches and their (batch, tokens)
DIST_SLOTS, DIST_PREFILL = 4, 256
# phase [placed]: qwen3-4b's prompts (batch, tokens) and greedy steps, and
# mamba2-130m's prefill (batch, tokens)
PLACED_BATCH, PLACED_PROMPT, PLACED_STEPS = 2, 40, 8
PLACED_MAMBA2 = (4, 150)
PIPE_LAYERS, PIPE_MICRO, PIPE_MB, PIPE_SEQ = 4, 4, 2, 64
# every M the serve phases give the segmented matmul (decode 1 and 4,
# prefill tails 8 / 13 / 22, chunks of 32, whole prompts 40 / 77 / 150) and
# 300, which takes the kernel's whole mode at (2560, 4096)
INVARIANCE_M = (1, 4, 8, 13, 22, 32, 40, 77, 150, 300)
# logits of the kernel route against the plain route, in units of the
# largest |logit| (phases 8 and 9): the scan kernel agrees with its plain version
# within a few fp32 ulps, but the model's activations are bf16, so such a
# difference can flip a bf16 rounding (2**-8 of an element) in any of 24
# layers, and the flips add up through the residual stream
LOGIT_BOUND = 2.0 ** -6
# the same with fp32 activations (phase [zamba2]): no bf16 residual stream;
# under standard K1's hi + lo carry a projection's operand to about 2**-16,
# but the attention's score and PV operands are still rounded to bf16, so
# the routes' few-ulp differences can move those roundings; under exact
# every matmul operand is rounded to bf16
FP32_LOGIT_BOUND = {"segmented3": 2.0 ** -10, "exact": 2.0 ** -6}
SERVE_LENGTHS = (40, 77, 150)
# the batch-invariance probe: rows of a site at these M against the same
# rows at the largest, and a 150-token prompt prefilled whole against the
# serving engine's chunks of 32
PROBE_M = (1, 4, 32, 150)
PROBE_CHUNK = 32
# phase 21: the ResNet forwards' batch, and the emulated designs' (the
# bit-level datapath is O(M * N * K) elementwise work)
RESNET_BATCH = 256
EMULATED_BATCH = 8
# the training phases' batch: sequences of TRAIN_SEQ tokens
TRAIN_SEQ, TRAIN_BATCH = 128, 8
# [train-grad]: the depth at which the exact tier's step (K1 at one pass)
# is held against its plain route: not chaotic there, as 24 layers are
GRAD_CUT_LAYERS = 2
# the family training phases: the cut depths and expert counts that fit
# params, gradients and the optimizer's state in 80 GB at full width
# (zamba2-7b 7 of 13 (5 SSD + shared) repeats and its 3-block SSD tail;
# llama4 one (moe, dense) repeat, 8 of 128 experts; deepseek-v3 one
# dense-MLA and one MoE-MLA layer, 16 of 256 experts), and their steps
ZAMBA2_TRAIN_REPEATS, LLAMA4_TRAIN_EXPERTS, DSV3_TRAIN_EXPERTS = 7, 8, 16
# and the dense ones: gemma2-9b 7 of 21 (local, global) repeats, gemma3-12b
# 2 of 8 (5 local + 1 global) repeats on rows longer than its 1024-token
# window (so that its local layers mask), minitron-8b 6 of 32 layers,
# qwen2-vl-72b 4 of 80 layers (fp32 params, as the trainer seeds every
# config: at 8 layers its params and gradients alone take 76 GB)
GEMMA2_TRAIN_REPEATS, GEMMA3_TRAIN_REPEATS = 7, 2
MINITRON_TRAIN_LAYERS, QWEN2VL_TRAIN_LAYERS = 6, 4
GEMMA3_TRAIN_SEQ, GEMMA3_TRAIN_BATCH = 1280, 2
FAMILY_STEPS = 4
# a leaf's gradient that is at most this much of the largest leaf's on
# the plain route is rounding noise (top-1's router: its one gate is
# renormalised to 1, so the router gets no gradient but for rounding):
# held to the same floor on the kernel route, not to LOGIT_BOUND of
# itself (tests/test_torch_moe.py holds it so against the JAX package)
NOISE_FLOOR = 1e-6
GOLDEN = ROOT / "tests" / "golden" / "afpm_golden.json"
BENCH_CPU = ROOT / "benchmarks" / "BENCH_cpu_ci.json"
# the timed AFPM designs and the template arguments (ACL, FULL, COND, COMP,
# SKIP_BD) of the kernel instantiation each runs, as they appear in the
# mangled name after the kernel's (afpm_bitwise_kernel, afpm_emulated_kernel)
K2_TIMED = {"AC5-5": "ILb0ELb1ELb1ELb1ELb1E", "ACL5": "ILb1ELb1ELb0ELb0ELb1E"}
K2_SHAPES = [(512, 512), (8192, 8192)]
# elements an iteration of K2's elementwise loop (16-byte loads), products
# an iteration of its emulated matmul's inner loop (4 x 4 a thread)
K2_PER_LOOP, EMU_PER_LOOP = 4, 16
# ResNet-18's 21 matmuls (CIFAR 32 x 32, im2col): (rows an image, K, N)
RESNET_MATMULS = ([(1024, 27, 64)] + [(1024, 576, 64)] * 4
                  + [(256, 576, 128), (256, 1152, 128), (256, 64, 128)]
                  + [(256, 1152, 128)] * 2
                  + [(64, 1152, 256), (64, 2304, 256), (64, 128, 256)]
                  + [(64, 2304, 256)] * 2
                  + [(16, 2304, 512), (16, 4608, 512), (16, 256, 512)]
                  + [(16, 4608, 512)] * 2 + [(1, 512, 10)])
# the AFPM designs of Table IV, whose emulated matmuls run K2's matmul entry
EMU_DESIGNS = ("AC4-4", "AC5-5", "AC6-6", "ACL5")
# the timed emulated matmuls, at Table IV's 48 images: (M, K, N)
EMU_TIMED = {"stage 0 conv": (48 * 1024, 576, 64),
             "stage 3 conv2": (48 * 16, 4608, 512)}
# the images of a forward at which [emulated] holds ResNet-18's matmuls
# against the plain version: [resnet]'s batch and Table IV's evaluation
EMU_BATCHES = (EMULATED_BATCH, 48)
# (K, N, k_chunk) of [emulated]'s M-invariance check: the plan splits the
# first two at M < 300 and not at M = 300, so split-mode rows are held
# against whole-mode rows; the third (stage 3's conv2) splits at every M
INVARIANCE_KN = [(576, 1600, 64), (1001, 1600, 16), (4608, 512, 64)]
# operations a product of the emulated matmul needs once its operands are
# decoded (each operand is decoded once a tile, shared by 64 products), one
# Hopper instruction each, and so its operation bound, whatever a build
# issues.  AC-n-n with BD skipped (every Table IV design): A*D' and the
# multiply-add of B'*C (2), the cross term's shift (1), the accumulator's
# three-input add (1), the normalisation bit's shift (1), the exponent
# words' three-input add (1), the fraction's two shifts (2), exponent and
# fraction joined by a shift-add (1), twice the exponent word (1), overflow
# and underflow, a compare and a select each (4), the sign joined (1), the
# NaN rules' two compares and select (3), and the fp32 add into the chunk's
# sum (1): 19.  ACL-n's low term is A & C (1) for the first three: 17.
EMU_FUNCTION_OPS = {"AC5-5": 19, "ACL5": 17}
# the emulated AC5-5 forward's logits, kernel route against plain route, in
# units of the largest |logit|: every conv is within ULP_BOUND fp32 ulps of
# the plain version (a few, measured), and a trained network's logits move
# by about as much
EMU_LOGIT_BOUND = 1e-4


def logit_bound(policy: str, dtype: str) -> float:
    return LOGIT_BOUND if dtype == "bfloat16" else FP32_LOGIT_BOUND[policy]


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def card_peaks(name: str):
    """(bytes/s, dense bf16 FLOP/s, fp32 FLOP/s outside the tensor cores)
    from NVIDIA's data sheets: the package's one table, which the dry-run
    prices its roofline with (``repro_torch.launch.hlo_analysis``)."""
    from repro_torch.launch.hlo_analysis import card_peaks as peaks

    return peaks(name)


def timed_ms(fn, iters: int, flush, device_only: bool = False,
             spin_cycles: int = 1_000_000) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each one timed by
    CUDA events after an L2 flush (the serving path reads every weight
    once a forward, cold); one warmup call first.  With ``device_only``
    the card first spins for ``spin_cycles`` clocks (half a millisecond by
    default; more for a function of many launches), so the host has
    enqueued ``fn``'s launches before the start event runs: the time then
    leaves out the host's call overhead (most of a small kernel's call)."""
    import torch

    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def sass_loop_ops(lib: pathlib.Path, key: str) -> collections.Counter:
    """Instructions by opcode (``IMAD``, ``LOP3``, ...) in the longest
    innermost loop of the kernel whose mangled name holds ``key``: the span
    closed by a backward branch in ``cuobjdump -sass`` of the built library
    that holds no other loop, NOPs excluded (K2's elementwise loop takes 4
    elements an iteration, its emulated matmul's inner loop 16 products).
    A forward branch inside it may skip a few."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           str(lib)], check=True, capture_output=True,
                          text=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if key in f.split("\n", 1)[0])
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    spans = [(int(m.group(1), 16), a) for a, t in ins
             for m in [re.search(r"\bBRA\s+0x([0-9a-f]+)", t)]
             if m and int(m.group(1), 16) < a]
    inner = [sp for sp in spans if not any(
        o != sp and sp[0] <= o[0] and o[1] <= sp[1] for o in spans)]
    if not inner:
        raise AssertionError(f"no loop found in the SASS of {key}")
    lo, hi = max(inner, key=lambda sp: sp[1] - sp[0])
    # the opcode: the first word that is not a predicate guard (@P0, @!P1)
    ops = (next(w for w in t.split() if not w.startswith("@")).split(".")[0]
           for a, t in ins if lo <= a <= hi)
    return collections.Counter(op for op in ops if op != "NOP")


def pipe_split(ops: collections.Counter) -> dict:
    """Hopper's pipes for a loop's instructions: a scheduler issues one warp
    instruction a clock; the integer ALU pipe (adds, logic, shifts,
    compares, selects) and the FMA-heavy pipe (IMAD, IMUL) take one every
    second clock; fp32 adds and FMAs take either FMA pipe; loads, branches
    and barriers only issue.  Returns the counts and the issue slots the
    loop needs, the largest of: all its instructions, twice its ALU ones,
    twice its IMADs, and IMADs plus fp32 ops."""
    fma = sum(n for op, n in ops.items() if op in ("IMAD", "IMUL"))
    fp = sum(n for op, n in ops.items() if op in ("FADD", "FFMA", "FMUL"))
    other = sum(n for op, n in ops.items() if op in (
        "LDS", "LDG", "LDGSTS", "STS", "STG", "BRA", "BAR", "DEPBAR", "S2R",
        "EXIT"))
    total = sum(ops.values())
    alu = total - fma - fp - other
    return dict(total=total, alu=alu, imad=fma, fp=fp, other=other,
                slots=max(total, 2 * alu, 2 * fma, fma + fp))


def instruction_rates():
    """(thread instructions a second: 4 schedulers an SM, one warp
    instruction each a clock at the card's top SM clock; the INT32 rate,
    64 lanes an SM; the SM count)."""
    import torch

    props = torch.cuda.get_device_properties(0)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    return (props.multi_processor_count * 128 * clock_hz,
            props.multi_processor_count * 64 * clock_hz,
            props.multi_processor_count)


def phase_device():
    import torch

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    print(f"[device] {torch.cuda.get_device_name(0)} | power limit "
          f"{smi('power.limit')} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | built {len(logs)} of "
          f"{len(_build.sources())} kernel libraries in {build_s:.1f} s")


def host_us_per_call(fn, calls: int = 200) -> float:
    """Mean host microseconds a call of ``fn`` takes with the card busy:
    the calls are enqueued behind a device spin, so none waits for the
    card and the mean is the host's own cost (validation, allocation, the
    ctypes call, the launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)   # about 0.1 s of spin
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def phase_kernel(peaks):
    import numpy as np
    import torch

    from repro_torch.kernels import afpm_matmul as k1

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_ulp, worst_abs, n_cases = 0.0, 0.0, 0

    def check(xx, w, passes):
        """The kernel's output on ``xx`` against its plain version's,
        within ULP_BOUND ulps of the largest output."""
        nonlocal worst_ulp, worst_abs, n_cases
        got = k1.afpm_matmul(xx, w, passes)
        want = k1.afpm_matmul_plain(xx, w, passes)
        torch.cuda.synchronize()
        where = f"afpm_matmul {tuple(xx.shape)}@{tuple(w.shape)}"
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{where}: bad output")
        err = (got - want).abs().max().item()
        ulp = err / float(np.spacing(np.float32(want.abs().max().item())))
        if ulp > ULP_BOUND:
            raise AssertionError(
                f"{where} passes={passes} {xx.dtype}: {ulp:.1f} ulps of the "
                f"largest output > {ULP_BOUND}")
        worst_ulp, worst_abs = max(worst_ulp, ulp), max(worst_abs, err)
        n_cases += 1

    cases = [((M, K), (K, N)) for K, N in SHAPES + MAMBA2_PROJ
             for M in (4, 32)]
    # zamba2-7b's at decode (4 slots), 32 rows and its whole prompts
    cases += [((M, K), (K, N)) for K, N in ZAMBA2_PROJ
              for M in (4, 32) + SERVE_LENGTHS]
    # the three dense decoders' at decode (4 slots) and 32 rows, whisper's
    # at M = 6000 too
    cases += [((M, K), (K, N)) for K, N in ZOO_PROJ for M in (4, 32)]
    cases += [((M, K), (K, N)) for K, N in WHISPER_PROJ
              for M in (4, 32, WHISPER_M)]
    # the last three families' at a decode step, an expert's rows in a
    # 4-slot decode step and 32 rows
    cases += [((M, K), (K, N)) for K, N in GIANT_PROJ
              for M in (4, EXPERT_M, 32)]
    cases.append(((3, 5, 2500), (2500, 1000)))   # ragged, batched
    for xs, ws in cases:
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda") * ws[0] ** -0.5
        for xx in (x, x.to(torch.bfloat16)):
            for passes in (1, 2, 3):
                check(xx, w, passes)

    # batch invariance: every row of a call equals the same row alone
    # (M = 1) bit for bit, at every M the serve path gives the kernel and
    # 300, in split and whole mode, with 64- and 128-column tiles, at
    # qwen3-4b's shapes and zamba2-7b's in_proj (N 14576, ragged) and mlp.wo
    n_rows = 0
    for K, N in [(D, 4096), (D, 1024), (FF, D), (ZD, ZIN), (ZFF, ZD)]:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        x32 = torch.randn((max(INVARIANCE_M), K), generator=gen, device="cuda")
        for x in (x32, x32.to(torch.bfloat16)):
            for passes in (1, 2, 3):
                alone = torch.cat([k1.afpm_matmul(x[i:i + 1], w, passes)
                                   for i in range(x.shape[0])])
                for M in INVARIANCE_M:
                    got = k1.afpm_matmul(x[:M], w, passes)
                    same = (got.view(torch.int32)
                            == alone[:M].view(torch.int32)).all(1)
                    if not bool(same.all()):
                        raise AssertionError(
                            f"afpm_matmul ({M}, {K}) @ ({K}, {N}) passes="
                            f"{passes} {x.dtype}: rows "
                            f"{torch.nonzero(~same).flatten()[:8].tolist()} "
                            f"differ from the same rows at M = 1")
                    n_rows += M
    # the dense decoders', whisper's and the last three families' shapes:
    # rows at M = 4, 16 and 32 (and whisper's 6000, its first 32 rows)
    # equal the same rows at M = 1
    for K, N in ZOO_PROJ + WHISPER_PROJ + GIANT_PROJ:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        big = WHISPER_M if (K, N) in WHISPER_PROJ else 32
        x32 = torch.randn((big, K), generator=gen, device="cuda")
        for x in (x32, x32.to(torch.bfloat16)):
            for passes in (1, 2, 3):
                alone = torch.cat([k1.afpm_matmul(x[i:i + 1], w, passes)
                                   for i in range(32)])
                for M in sorted({4, EXPERT_M, 32, big}):
                    got = k1.afpm_matmul(x[:M], w, passes)[:32]
                    same = (got.view(torch.int32)
                            == alone[:min(M, 32)].view(torch.int32)).all(1)
                    if not bool(same.all()):
                        raise AssertionError(
                            f"afpm_matmul ({M}, {K}) @ ({K}, {N}) passes="
                            f"{passes} {x.dtype}: rows "
                            f"{torch.nonzero(~same).flatten()[:8].tolist()} "
                            f"differ from the same rows at M = 1")
                    n_rows += min(M, 32)
        del w, x32
    # timing: bf16 activations (the full-width models' dtype) at decode
    # M = 1 (solo) and 4 (engine), a 32-row prefill chunk and a 150-token
    # prompt, for the qwen3-4b and mamba2-130m projections; M = 2048 once.
    # kernel_ms, library_ms and plain_ms are device time (behind a device
    # spin) after the L2 is flushed by writing 64 MB, as phases [bitwise]
    # and [ssd] time K2 and K3; kernel_call_ms holds the host's call too
    # (no device spin), PR 11's method.  read_ms, at the decode layer's
    # shapes, is one torch.sum of the weight timed alike: the same bytes
    # read once by a plain PyTorch reduction, the rate a read of them gets
    # after this flush
    bw, flops, _ = peaks
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    rows = []
    timed = [(K, N, M, passes) for K, N in SHAPES + MAMBA2_PROJ
             for M in (1, 4, 32, 150) for passes in (1, 3)]
    timed.append((D, FF, 2048, 3))
    # zamba2-7b's projections at a 4-slot decode step and a 150-token prompt
    timed += [(K, N, M, 3) for K, N in ZAMBA2_PROJ for M in (4, 150)]
    # whisper's cross-attention K/V projection over 4 x 1500 frames, and
    # the three dense decoders' projections at a 4-slot decode step
    timed += [(WD, WD, WHISPER_M, passes) for passes in (1, 3)]
    timed += [(K, N, 4, 3) for K, N in ZOO_PROJ]
    # a qwen2-vl-72b decode layer (4 slots), and one llama4 and one
    # deepseek-v3 expert projection at a 4-slot decode step's M
    timed += [(K, N, 4, 3) for K, N in sorted(set(QWEN2VL_LAYER))]
    timed += [(K, N, EXPERT_M, 3) for K, N in (LLAMA4_EXPERT[0],
                                               DSV3_EXPERT[0])]
    weights = {}
    for K, N, M, passes in timed:
        if (K, N) not in weights:
            weights = {(K, N): torch.randn((K, N), generator=gen,
                                           device="cuda") * K ** -0.5}
        w = weights[(K, N)]
        wb = w.to(torch.bfloat16)
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        lib = lambda: [torch.matmul(x, wb) for _ in range(passes)]
        kern = lambda: k1.afpm_matmul(x, w, passes)
        bytes_ms = (K * N * 4 + M * K * 2 + M * N * 4) / bw * 1e3
        ops_ms = 2 * passes * M * N * K / flops * 1e3
        check(x, w, passes)   # each timed call's output against plain
        p = k1.plan(M, K, N)
        rows.append(dict(
            M=M, K=K, N=N, passes=passes, plan=p._asdict(),
            kernel_ms=timed_ms(kern, 20, flush, True),
            kernel_call_ms=timed_ms(kern, 20, flush),
            plain_ms=timed_ms(lambda: k1.afpm_matmul_plain(x, w, passes), 10,
                              flush, True),
            library_ms=timed_ms(lib, 20, flush, True),
            host_us=host_us_per_call(kern) if M == 4 and passes == 3 else None,
            read_ms=(timed_ms(w.sum, 20, flush, True)
                     if M == 4 and passes == 3 else None),
            bytes_ms=bytes_ms, ops_ms=ops_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations"))
    del weights, w, wb, x
    one = torch.zeros(1, device="cuda")
    floor_ms = timed_ms(lambda: one.add_(1), 50, flush, True)

    # the kernels line: one decode layer of the standard tier (7 projections,
    # M = 4 slots, passes = 3)
    def layer_sum(key):
        return sum(next(r[key] for r in rows if (r["K"], r["N"]) == kn
                        and r["M"] == 4 and r["passes"] == 3)
                   for kn in LAYER_PROJ)

    layer = {k: layer_sum(k) for k in ("kernel_ms", "kernel_call_ms",
                                       "plain_ms", "library_ms", "read_ms")}
    layer["host_us"] = layer_sum("host_us") / len(LAYER_PROJ)
    layer["launch_floor_ms"] = floor_ms
    b_ms, o_ms = layer_sum("bytes_ms"), layer_sum("ops_ms")
    layer["bound_ms"] = max(b_ms, o_ms)
    layer["bound_by"] = "bytes" if b_ms >= o_ms else "operations"
    # one zamba2-7b decode step of the standard tier: its 227 projections
    # at M = 4, passes = 3
    def row_of(kn, M=4, passes=3):
        return next(r for r in rows if (r["K"], r["N"]) == kn
                    and r["M"] == M and r["passes"] == passes)

    zamba2 = {k: sum(row_of(kn)[k] for kn in ZAMBA2_STEP)
              for k in ("kernel_ms", "plain_ms", "library_ms", "bytes_ms",
                        "ops_ms")}
    zamba2["bound_ms"] = max(zamba2["bytes_ms"], zamba2["ops_ms"])
    zamba2["bound_by"] = ("bytes" if zamba2["bytes_ms"] >= zamba2["ops_ms"]
                          else "operations")
    zamba2["in_proj"] = {k: row_of((ZD, ZIN))[k] for k in (
        "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    layer["zamba2_step"] = zamba2
    # one decode layer of each dense decoder (standard tier, M = 4) and
    # whisper's cross-attention K/V projection, with their bounds
    for arch, shapes in ZOO_LAYERS.items():
        zoo = {k: sum(row_of(kn)[k] for kn in shapes)
               for k in ("kernel_ms", "plain_ms", "library_ms", "bytes_ms",
                         "ops_ms")}
        zoo["bound_ms"] = max(zoo["bytes_ms"], zoo["ops_ms"])
        zoo["bound_by"] = ("bytes" if zoo["bytes_ms"] >= zoo["ops_ms"]
                           else "operations")
        layer[f"{arch}_layer"] = zoo
    qv = {k: sum(row_of(kn)[k] for kn in QWEN2VL_LAYER)
          for k in ("kernel_ms", "plain_ms", "library_ms", "bytes_ms",
                    "ops_ms")}
    qv["bound_ms"] = max(qv["bytes_ms"], qv["ops_ms"])
    qv["bound_by"] = "bytes" if qv["bytes_ms"] >= qv["ops_ms"] else "operations"
    layer["qwen2-vl-72b_layer"] = qv
    for name, kn in (("llama4_expert", LLAMA4_EXPERT[0]),
                     ("deepseek_expert", DSV3_EXPERT[0])):
        layer[name] = {k: row_of(kn, EXPERT_M)[k] for k in (
            "M", "K", "N", "kernel_ms", "plain_ms", "library_ms", "bytes_ms",
            "ops_ms", "bound_ms", "bound_by")}
    layer["whisper_cross_kv"] = {
        f"passes{passes}": {k: row_of((WD, WD), WHISPER_M, passes)[k]
                            for k in ("kernel_ms", "plain_ms", "library_ms",
                                      "bytes_ms", "ops_ms", "bound_ms",
                                      "bound_by")}
        for passes in (1, 3)}
    big = next(r for r in rows if r["M"] == 2048)
    (ROOT / "chiprun_out" / "chip_smoke_kernels.json").write_text(
        json.dumps({"card": smi("name,power.limit"), "layer": layer,
                    "rows": rows}, indent=1))
    print(f"[kernel] afpm_matmul: {n_cases} cases (the timed calls among "
          f"them) within {ULP_BOUND} ulps (worst {worst_ulp:.2f} ulps, "
          f"{worst_abs:.3g} abs); {n_rows} rows "
          f"at M in {INVARIANCE_M} equal to M = 1 bit for bit; one decode "
          f"layer (M=4, passes=3): kernel {layer['kernel_ms']:.4f} ms on the "
          f"device, {layer['kernel_call_ms']:.4f} ms with the host's call, "
          f"host {layer['host_us']:.1f} us a call; plain "
          f"{layer['plain_ms']:.4f} ms, bf16 torch.matmul x3 "
          f"{layer['library_ms']:.4f} ms, torch.sum of the weights "
          f"{layer['read_ms']:.4f} ms, bound {layer['bound_ms']:.4f} ms "
          f"({layer['bound_by']}), launch floor {floor_ms:.4f} ms a call (a "
          f"one-element torch.add, timed alike); M=2048 at ({D}, {FF}): kernel "
          f"{big['kernel_ms']:.4f} ms, torch.matmul x3 {big['library_ms']:.4f}"
          f" ms, bound {big['bound_ms']:.4f} ms ({big['bound_by']}); "
          f"zamba2-7b in_proj (M=4, K {ZD}, N {ZIN}, passes=3): kernel "
          f"{zamba2['in_proj']['kernel_ms']:.4f} ms, plain "
          f"{zamba2['in_proj']['plain_ms']:.4f} ms, torch.matmul x3 "
          f"{zamba2['in_proj']['library_ms']:.4f} ms, bound "
          f"{zamba2['in_proj']['bound_ms']:.4f} ms; its {len(ZAMBA2_STEP)} "
          f"projections of a decode step: kernel {zamba2['kernel_ms']:.4f} ms,"
          f" torch.matmul x3 {zamba2['library_ms']:.4f} ms, bound "
          f"{zamba2['bound_ms']:.4f} ms ({zamba2['bound_by']})")
    kv = layer["whisper_cross_kv"]
    print(f"[kernel] whisper-tiny cross-attention K/V (M {WHISPER_M}, K {WD}, "
          f"N {WD}): " + "; ".join(
              f"passes={p[-1]} kernel {v['kernel_ms']:.4f} ms, plain "
              f"{v['plain_ms']:.4f} ms, torch.matmul x{p[-1]} "
              f"{v['library_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']})" for p, v in kv.items())
          + "; one decode layer (M=4, passes=3): " + "; ".join(
              f"{arch} kernel {layer[arch + '_layer']['kernel_ms']:.4f} ms, "
              f"plain {layer[arch + '_layer']['plain_ms']:.4f} ms, "
              f"torch.matmul x3 {layer[arch + '_layer']['library_ms']:.4f} ms,"
              f" bound {layer[arch + '_layer']['bound_ms']:.4f} ms "
              f"({layer[arch + '_layer']['bound_by']})" for arch in ZOO_LAYERS))
    print("[kernel] the last three families (passes=3): qwen2-vl-72b decode "
          "layer (M=4): " + (
              f"kernel {qv['kernel_ms']:.4f} ms, plain {qv['plain_ms']:.4f} ms, "
              f"torch.matmul x3 {qv['library_ms']:.4f} ms, bound "
              f"{qv['bound_ms']:.4f} ms ({qv['bound_by']})") + "; " + "; ".join(
              f"{n} (M={v['M']}, K {v['K']}, N {v['N']}): kernel "
              f"{v['kernel_ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
              f"torch.matmul x3 {v['library_ms']:.4f} ms, bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']})"
              for n, v in ((n, layer[n]) for n in ("llama4_expert",
                                                   "deepseek_expert"))))
    for r in rows:
        print(f"[kernel]   M {r['M']:4d} K {r['K']:4d} N {r['N']:4d} passes "
              f"{r['passes']}: kernel {r['kernel_ms']:.4f} (call "
              f"{r['kernel_call_ms']:.4f}) library {r['library_ms']:.4f} "
              f"plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return dict(max_abs_err=worst_abs, max_ulp_err=worst_ulp, **layer)


def ulp_gap(got, want) -> int:
    """The largest distance between two fp64, fp32 or bf16 tensors of one
    shape in units in the last place, element by element (0: equal bit
    for bit; +0 and -0 count as equal)."""
    import torch

    width = {torch.float64: 64, torch.float32: 32,
             torch.bfloat16: 16}[want.dtype]
    it = {64: torch.int64, 32: torch.int32, 16: torch.int16}[width]

    def ordered(t):
        b = t.contiguous().view(it).to(torch.int64)
        mag = b & ((1 << (width - 1)) - 1)
        return torch.where(b < 0, -mag, mag)

    return int((ordered(got.to(want.dtype)) - ordered(want)).abs().max())


def solo_mismatches(tag: str, sess, reqs, gen_len: int = 16) -> list:
    """Every served request's tokens against a solo ``Session.generate`` of
    its prompt under its tier's policy (premium, standard and bulk alike):
    a line for each request that differs, with its tier and the first
    token that differs."""
    import numpy as np

    from repro_torch.serving import DEFAULT_TIERS

    policy = {t.name: t.policy for t in DEFAULT_TIERS}
    solo, bad = {}, []
    for r in reqs:
        s = solo.setdefault(r.tier, sess.replace(policy=policy[r.tier]))
        want = s.generate(prompts=r.prompt[None], gen_len=gen_len).tokens[0]
        got = np.asarray(r.result())
        if not np.array_equal(got, want):
            i = int(np.flatnonzero(got != want)[0])
            bad.append(f"{tag} {r.tier} ({policy[r.tier]}) request {r.id}, "
                       f"{len(r.prompt)}-token prompt: token {i} is "
                       f"{got[i]} in the engine, {want[i]} solo")
    return bad


def _row_of_state(state, row: int):
    """A copy of one batch row of a serving state (every leaf's axis 1)."""
    return {"layers": [{pi: {k: v[:, row:row + 1].clone()
                             for k, v in cache.items()}
                        for pi, cache in seg.items()}
                       for seg in state["layers"]]}


def decode_row_probe(tag: str, sess, plen: int = 40, rows: int = 4):
    """Per tier: a decode step's logits of row 0 among ``rows`` slots (each
    at its own position, as the engine decodes) against the same row
    decoded alone at the same cache (its rows of the prefilled state
    copied), bit for bit.  Returns ({tier: ulp gap}, failure lines)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS

    cfg = sess.config
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (rows, plen)), device="cuda")
    pos = torch.full((rows,), plen, device="cuda")
    gaps, bad = {}, []
    with torch.inference_mode():
        for t in DEFAULT_TIERS:
            s = sess.replace(policy=t.policy)
            _, state = transformer.prefill(s.params, s.config,
                                           {"tokens": prompts},
                                           max_len=plen + 8)
            alone = _row_of_state(state, 0)
            tok = prompts[:, -1:]
            lg_all, _ = transformer.decode_step(s.params, s.config,
                                                {"token": tok}, state, pos)
            lg_one, _ = transformer.decode_step(s.params, s.config,
                                                {"token": tok[:1]}, alone,
                                                pos[:1])
            gaps[t.name] = ulp_gap(lg_all[:1], lg_one)
            if gaps[t.name]:
                n = int((lg_all[:1] != lg_one).sum())
                bad.append(f"{tag} {t.name} ({t.policy}) decode step: row 0"
                           f" among {rows} != alone, {n} logits differ, "
                           f"largest gap {gaps[t.name]} ulps")
            del state, alone
    return gaps, bad


def chunk_probe(tag: str, sess, prompt):
    """Per tier: the prompt prefilled whole (``transformer.prefill``)
    against the serving engine's chunked prefill
    (``TransformerRunner.prefill_chunk_step``, chunks of
    :data:`PROBE_CHUNK`, one slot): the last position's logits and every
    layer's K/V cache rows, bit for bit.  Returns ({tier: {"logits",
    "kv"}: ulp gap}, failure lines)."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS, kvcache
    from repro_torch.serving.engine import TransformerRunner

    L = len(prompt)
    gaps, bad = {}, []
    real = transformer.decode_step
    for t in DEFAULT_TIERS:
        s = sess.replace(policy=t.policy)
        with torch.inference_mode():
            whole, state = transformer.prefill(
                s.params, s.config,
                {"tokens": torch.as_tensor(prompt[None], device="cuda")})
        runner = TransformerRunner(s.config, s.params, 1, 256, device="cuda")
        table = list(range(runner.max_pages))
        seen = []

        def captured(*a, **k):
            out = real(*a, **k)
            seen.append(out[0])
            return out

        transformer.decode_step = captured
        try:
            for a in range(0, L, PROBE_CHUNK):
                runner.prefill_chunk_step(prompt, a, min(L, a + PROBE_CHUNK),
                                          table)
        finally:
            transformer.decode_step = real
        dense = kvcache.gather_state(runner.pool, runner._layout,
                                     torch.as_tensor([table], device="cuda"))
        kv = max(ulp_gap(dense["layers"][si][pi][k][:, :, :L], leaf)
                 for si, seg in enumerate(state["layers"])
                 for pi, cache in seg.items() for k, leaf in cache.items())
        g = gaps[t.name] = dict(logits=ulp_gap(seen[-1][:, -1:], whole),
                                kv=kv)
        if g["logits"] or g["kv"]:
            n = int((seen[-1][:, -1:] != whole).sum())
            bad.append(f"{tag} {t.name} ({t.policy}) {L}-token prefill in "
                       f"chunks of {PROBE_CHUNK} != whole: {n} last-position"
                       f" logits differ, largest gap {g['logits']} ulps; K/V "
                       f"rows largest gap {g['kv']} bf16 ulps")
        del runner, dense, state, seen
    return gaps, bad


def site_probe(tag: str, sites: dict):
    """Each site's rows at every M of :data:`PROBE_M` against the same rows
    at the largest, bit for bit, under the serving path's sums
    (``layers.fp64_sums``).  ``sites`` maps a name to ``fn(m)`` giving the
    site's first ``m`` rows (on the first axis).  Returns ({site: largest
    ulp gap}, failure lines)."""
    import torch

    from repro_torch.models import layers

    gaps, bad = {}, []
    with torch.inference_mode(), layers.fp64_sums():
        for name, fn in sites.items():
            full = fn(PROBE_M[-1])
            worst = {m: ulp_gap(fn(m), full[:m]) for m in PROBE_M[:-1]}
            gaps[name] = max(worst.values())
            if gaps[name]:
                bad.append(f"{tag} {name}: rows at M = "
                           f"{[m for m, g in worst.items() if g]} != the "
                           f"same rows at M = {PROBE_M[-1]}, largest gap "
                           f"{gaps[name]} ulps")
    return gaps, bad


def serve_probe(sess):
    """The batch-invariance probe on full-width qwen3-4b's weights: the
    decode row (:func:`decode_row_probe`), the chunked prefill
    (:func:`chunk_probe`) and the sites at M = 1 / 4 / 32 / 150: each
    tier's product at every projection of layer 0 (its config through
    ``nmatmul``; ``attn.wo`` and ``mlp.wo`` on inputs of their own K),
    the LM head, ``rmsnorm`` and the blockwise attention
    (queries at positions 0 .. M-1 over the 150 keys, the later ones
    masked); and the exact tier against the parent's form (an fp32 SGEMM
    of bf16-rounded operands) within :data:`ULP_BOUND` ulps of the largest
    output, and against segmented1 bit for bit, at M = 4 and 150.
    Returns (readings, failure lines)."""
    import numpy as np
    import torch

    from repro_torch.core.numerics import NumericsConfig
    from repro_torch.models import attention, layers, transformer
    from repro_torch.numerics import nmatmul, numerics_scope
    from repro_torch.serving import DEFAULT_TIERS

    cfg = sess.config
    M = PROBE_M[-1]
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((M, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = (torch.randn((1, M, H, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    p0 = sess.params["seg0_p0"]
    layer0 = {f"{a}.{n}": w[0] for a in ("attn", "mlp")
              for n, w in p0[a].items() if n.startswith("w")}
    sites = {"head": lambda m: transformer.logits_fn(
                 sess.params, cfg, x[None, :m])[0],
             "rmsnorm": lambda m: layers.rmsnorm(
                 {"scale": p0["ln1"]["scale"][0]}, x[:m], cfg.norm_eps),
             "blockwise": lambda m: attention._blockwise(
                 q[:, :m], k, v)[0]}
    xin = {cfg.d_model: x}
    for w in layer0.values():
        if w.shape[0] not in xin:
            xin[w.shape[0]] = torch.randn((M, w.shape[0]), generator=gen,
                                          device="cuda").to(torch.bfloat16)
    for t in DEFAULT_TIERS:
        ncfg = sess.replace(policy=t.policy).config.numerics
        for name, w in layer0.items():
            def product(m, ncfg=ncfg, w=w):
                with numerics_scope(ncfg):
                    return nmatmul(xin[w.shape[0]][:m], w)
            sites[f"{t.policy} {name}"] = product
    gaps, bad = site_probe("qwen3-4b", sites)

    # the exact tier beside the parent's SGEMM form and segmented1
    exact = NumericsConfig(mode="exact")
    seg1 = NumericsConfig(mode="segmented", seg_passes=1)
    f32 = torch.float32
    worst = dict(sgemm_ulps=0.0, seg1_gap=0)
    for name in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi",
                 "mlp.wg", "mlp.wo"):
        w = layer0[name]
        xs = torch.randn((M, w.shape[0]), generator=gen, device="cuda")
        for m in (4, M):
            with torch.inference_mode():
                with numerics_scope(exact):
                    got = nmatmul(xs[:m], w)
                with numerics_scope(seg1):
                    s1 = nmatmul(xs[:m], w)
                want = torch.matmul(xs[:m].to(torch.bfloat16).to(f32),
                                    w.to(torch.bfloat16).to(f32))
            worst["sgemm_ulps"] = max(worst["sgemm_ulps"],
                                      max_ulps(got, want))
            worst["seg1_gap"] = max(worst["seg1_gap"], ulp_gap(got, s1))
    if worst["sgemm_ulps"] > ULP_BOUND:
        bad.append(f"qwen3-4b exact tier: {worst['sgemm_ulps']:.2f} ulps of "
                   f"the largest from the SGEMM form > {ULP_BOUND}")
    if worst["seg1_gap"]:
        bad.append(f"qwen3-4b exact tier != segmented1: largest gap "
                   f"{worst['seg1_gap']} ulps")

    rows, bad_rows = decode_row_probe("qwen3-4b", sess)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, M)
    chunks, bad_chunks = chunk_probe("qwen3-4b", sess, prompt)
    return (dict(sites=gaps, decode_row=rows, chunked_prefill=chunks,
                 **worst), bad + bad_rows + bad_chunks)


def phase_serve():
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import decode_attention as fused
    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS, trace
    from repro_torch.session import Session

    cfg = get_arch("qwen3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (36, 2560, 151936)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = Session(cfg, seed=0)
    sess.params  # seeded random init on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = sess.serving_engine(slots=4, max_len=256)
    rng = np.random.default_rng(0)
    lengths = (40, 77, 150)
    reqs = []
    for i in range(6):
        tier = DEFAULT_TIERS[i % 3].name
        plen = lengths[(i + i // 3) % 3]
        reqs.append(eng.submit(rng.integers(0, cfg.vocab, plen), tier=tier,
                               max_new_tokens=16))

    k1.afpm_matmul.launches = 0
    fused_before = fused.decode_core.launches
    trace.clear()
    t0 = time.perf_counter()
    stats = eng.run()
    serve_s = time.perf_counter() - t0
    launches = k1.afpm_matmul.launches
    fused_launches = fused.decode_core.launches - fused_before
    span_layers = sorted({s.attrs["attn_kernel_layers"]
                          for s in trace.spans() if s.name == "serve.decode"})

    bad = [r.id for r in reqs if not r.done or len(r.result()) != 16]
    if bad:
        raise AssertionError(f"requests did not finish with 16 tokens: {bad}")
    # every tier runs K1: seven projections a layer and the LM head
    forwards = sum(st.n_prefill_chunks + st.n_decode_steps
                   for st in stats.values())
    per_forward = 7 * cfg.n_layers + 1
    fails = []
    if launches != per_forward * forwards:
        fails.append(f"afpm_matmul launched {launches} times, expected "
                     f"{per_forward} x {forwards} forwards")
    # every decode call's attention layers take the fused kernel, once each
    decodes = sum(st.n_decode_steps for st in stats.values())
    if fused_launches != cfg.n_layers * decodes or span_layers != [
            cfg.n_layers]:
        fails.append(f"decode attention kernel launched {fused_launches} "
                     f"times, expected {cfg.n_layers} x {decodes} decode "
                     f"calls; serve.decode spans counted {span_layers}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    fails += solo_mismatches("qwen3-4b", sess, reqs)
    with torch.inference_mode():
        logits, _ = transformer.prefill(
            sess.params, sess.config,
            {"tokens": torch.as_tensor(reqs[0].prompt[None], device="cuda")})
    if logits.shape != (1, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits bad: {tuple(logits.shape)}")
    probe, bad = serve_probe(sess)
    fails += bad

    parts = []
    for t in DEFAULT_TIERS:
        s = stats[t.name]
        dec_tokens = s.n_tokens - s.n_finished   # first tokens come from prefill
        parts.append(f"{t.name}({t.policy}) decode {dec_tokens / s.decode_s:.1f} "
                     f"tok/s {1e3 * s.decode_s / s.n_decode_steps:.1f} ms/step "
                     f"prefill {1e3 * s.prefill_s / s.n_prefill_chunks:.1f} "
                     f"ms/chunk")
    print(f"[serve] qwen3-4b full width ({cfg.param_count() / 1e9:.2f} B params, "
          f"init {init_s:.1f} s): 6 requests x 16 tokens in {serve_s:.2f} s; "
          f"{'; '.join(parts)}; afpm_matmul launches {launches} = "
          f"{per_forward} x {forwards} forwards; decode attention kernel "
          f"{fused_launches} = {cfg.n_layers} x {decodes} decode calls "
          f"(serve.decode spans: {span_layers}); every tier's tokens == its "
          f"solo generate; peak memory {peak_gb:.2f} GB")
    print(f"[serve] batch-invariance probe, largest ulp gaps (0: bit for "
          f"bit): decode row 0 among 4 vs alone {probe['decode_row']}; "
          f"{PROBE_M[-1]}-token prefill in chunks of {PROBE_CHUNK} vs whole "
          f"{probe['chunked_prefill']}; rows at M = "
          f"{'/'.join(map(str, PROBE_M[:-1]))} vs {PROBE_M[-1]}: "
          f"{probe['sites']}; exact tier vs the SGEMM form "
          f"{probe['sgemm_ulps']:.2f} ulps of the largest, vs segmented1 "
          f"{probe['seg1_gap']}")
    if fails:
        raise AssertionError("[serve]: " + "; ".join(fails))
    return launches, fused_launches, sess, probe


def decode_ties(got, want) -> tuple:
    """(elements that differ, their largest gap in ulps): the fused decode
    kernel and its plain chain sum in fp64 in other orders, so a rounding
    to fp32 or bf16 may flip by one ulp where the exact value sits within
    a few fp64 ulps of a boundary (a tie), and nowhere else."""
    import torch

    width = {torch.float32: 32, torch.bfloat16: 16}[want.dtype]
    it = {32: torch.int32, 16: torch.int16}[width]

    def ordered(t):
        b = t.contiguous().view(it).to(torch.int64)
        mag = b & ((1 << (width - 1)) - 1)
        return torch.where(b < 0, -mag, mag)

    gap = (ordered(got) - ordered(want)).abs()
    return int((gap > 0).sum()), int(gap.max())


def phase_decode_attention(peaks):
    """The fused decode attention core (``kernels/decode_attention.py``:
    qk-norm, RoPE, the cache write and fp64-summed GQA attention in one
    launch) at qwen3-4b's shapes, against its plain chain
    (``attention.decode_core_plain``): 96 rows of a 640-position view at
    batch-short's fill (rows at positions 64-422, about 38% of the view in
    use), and 4 slots at the end of caches of 256, 4096 and 32768.  Device
    time behind a spin after a 64 MB write flush, a layer; the host's
    microseconds a call with the card busy; the byte bound (each attended
    K and V row read once, q / k / v and the output once, the new cache
    rows written) at the card's bandwidth.  The kernel's outputs and cache
    rows must equal the plain chain's but for counted one-ulp ties."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as fused
    from repro_torch.models import attention
    from repro_torch.models.layers import fp64_sums

    cfg = get_arch("qwen3-4b")
    H, KH, D, layers = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 36
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    scales = tuple(torch.from_numpy((rng.standard_normal(D) * 0.1).astype(
        np.float32)).cuda() for _ in range(2))
    params = {"q_norm": {"scale": scales[0]}, "k_norm": {"scale": scales[1]}}
    rows, parts, fails = [], [], []
    shapes = [("batch-short", 96, 640, rng.integers(64, 423, 96))] + [
        (f"cache {S}", 4, S, np.full(4, S - 1)) for S in (256, 4096, 32768)]
    for tag, B, S, at in shapes:
        q, k, v = (torch.from_numpy(rng.standard_normal((B, 1, h, D)).astype(
            np.float32)).cuda() for h in (H, KH, KH))
        cache = {n: torch.from_numpy(rng.standard_normal((B, S, KH, D)).astype(
            np.float32)).cuda().to(torch.bfloat16) for n in ("k", "v")}
        pos = torch.as_tensor(at, dtype=torch.int64, device="cuda")
        positions = pos[:, None]
        kc = {n: t.clone() for n, t in cache.items()}

        def kernel():
            return fused.decode_core(q, k, v, kc["k"], kc["v"], pos,
                                     positions, scales=scales,
                                     eps=cfg.norm_eps, theta=cfg.rope_theta)

        def plain():
            with fp64_sums():
                return attention.decode_core_plain(
                    params, q, k, v, cache, cfg, None, positions, pos)[0]

        got, want = kernel(), plain().to(torch.bfloat16)
        torch.cuda.synchronize()
        ties = {"out": decode_ties(got, want)}
        r = torch.arange(B, device="cuda")
        for n in ("k", "v"):
            ties[n] = decode_ties(kc[n][r, pos], cache[n][r, pos])
        for what, (n, worst) in ties.items():
            if worst > 1 or n > max(2, (got if what == "out" else q).numel()
                                    // 10 ** 4):
                fails.append(f"{tag} {what}: {n} elements differ, by up to "
                             f"{worst} ulps")
        if not torch.isfinite(got.float()).all():
            fails.append(f"{tag}: non-finite outputs")
        keys = int((pos + 1).sum()) * KH
        nbytes = (2 * keys * D * 2 + (q.numel() + 2 * k.numel()) * 4
                  + got.numel() * 2 + 2 * k.numel() * 2)
        bound_ms = nbytes / peaks[0] * 1e3
        kernel_ms = timed_ms(kernel, 20, flush, True)
        plain_ms = timed_ms(plain, 5, flush, True, spin_cycles=20_000_000)
        host = (host_us_per_call(kernel), host_us_per_call(plain, 20))
        rows.append(dict(shape=tag, rows=B, view=S, attended=keys // KH,
                         kernel_ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes",
                         kernel_host_us=host[0], plain_host_us=host[1],
                         ties={w: list(t) for w, t in ties.items()}))
        parts.append(f"{tag} ({B} rows, {keys // KH} keys attended): kernel "
                     f"{kernel_ms:.4f} ms (bound {bound_ms:.4f}, "
                     f"{100 * bound_ms / kernel_ms:.1f}%), plain "
                     f"{plain_ms:.4f} ms a layer (a step's {layers} layers "
                     f"{layers * kernel_ms:.2f} / {layers * plain_ms:.2f} ms); "
                     f"host {host[0]:.1f} / {host[1]:.1f} us a call; ties "
                     f"{ties}")
        del q, k, v, cache, kc, got, want
    print(f"[decode-attn] qwen3-4b decode attention core: {'; '.join(parts)}")
    if fails:
        raise AssertionError("[decode-attn]: " + "; ".join(fails))
    return rows


def bit_mismatches(got, want):
    """(elements whose fp32 bits differ, NaNs compared by NaN-ness only;
    the largest absolute difference where both are finite)."""
    import numpy as np

    def bits(t):
        return t.detach().contiguous().cpu().numpy().view(np.uint32) \
            if hasattr(t, "detach") else np.asarray(t, np.uint32)

    g, w = bits(got), bits(want)
    if g.shape != w.shape:
        return max(g.size, w.size), float("inf")
    nan = lambda b: (((b >> 23) & 0xFF) == 255) & ((b & 0x7FFFFF) != 0)
    gv, wv = g.view(np.float32), w.view(np.float32)
    fin = np.isfinite(gv) & np.isfinite(wv)
    err = float(np.max(np.abs(gv[fin].astype(np.float64) - wv[fin]), initial=0.0))
    return int((~((g == w) | (nan(g) & nan(w)))).sum()), err


def special_inputs(rng, shape):
    """Seeded fp32 over the whole exponent range with zeros, +-subnormals,
    +-inf, NaN and the min/max normals mixed in, on the card."""
    import numpy as np
    import torch

    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        v = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 39, n)).astype(np.float32)
    f = np.finfo(np.float32)
    specials = np.array([0.0, -0.0, 1e-40, -1e-40, 1e-45, np.inf, -np.inf, np.nan,
                         f.tiny, -f.tiny, f.max, -f.max], np.float32)
    idx = rng.integers(0, n, max(n // 8, 1))
    v[idx] = rng.choice(specials, idx.size)
    return torch.from_numpy(v.reshape(shape)).cuda()


def phase_bitwise(peaks):
    import numpy as np
    import torch

    from repro_torch.core.afpm import (AFPMConfig, afpm_matmul_emulated,
                                       chunked_emulated_matmul)
    from repro_torch.core.registry import afpm_config, available, get_multiplier
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import afpm_bitwise as k2
    from repro_torch.numerics import NumericsConfig, nmatmul, numerics_scope

    bad, n_cases, worst = [], 0, 0.0

    def check(got, want, *what):
        nonlocal n_cases, worst
        m, err = bit_mismatches(got, want)
        worst = max(worst, err)
        n_cases += 1
        if m:
            bad.append((*what, m))

    for case in json.loads(GOLDEN.read_text())["cases"]:
        cfg = AFPMConfig(n=case["n"], mode=case["mode"], fmt=case["fmt"])
        x = torch.from_numpy(np.asarray(case["x_bits"], np.uint32).view(np.float32)).cuda()
        y = torch.from_numpy(np.asarray(case["y_bits"], np.uint32).view(np.float32)).cuda()
        got = k2.afpm_bitwise(x, y, cfg)
        check(got, case["out_bits"], case["label"], "golden")
        check(got, k2.afpm_bitwise_plain(x, y, cfg), case["label"], "plain")
    rng = np.random.default_rng(0)
    cfgs = [(name, afpm_config(name)) for name in available() if afpm_config(name)]
    cfgs += [("AC5-5/conditional=False", AFPMConfig(n=5, conditional=False)),
             ("AC5-5/skip_bd=False", AFPMConfig(n=5, skip_bd=False))]
    for label, cfg in cfgs:
        for shape in [(512, 512), (3, 1001, 7)]:
            x, y = special_inputs(rng, shape), special_inputs(rng, shape)
            check(k2.afpm_bitwise(x, y, cfg), k2.afpm_bitwise_plain(x, y, cfg),
                  label, shape)
        x = special_inputs(rng, (257, 129))
        for s in (0.6, -1e-40, float("inf")):
            scalar = torch.tensor(s, dtype=torch.float32, device="cuda")
            check(dispatch.multiply(x, scalar, cfg, backend="hopper"),
                  dispatch.multiply(x, scalar, cfg, backend="torch"),
                  label, "0-d", s)
    torch.cuda.synchronize()
    if bad:
        raise AssertionError(f"afpm_bitwise differs from its plain version: {bad}")

    # timing: one Table III operand (512 x 512) and a size that reaches the
    # memory rate.  Bound = max(12 bytes an element over the data-sheet
    # rate, loop-body SASS instructions an element over the card's instruction
    # rate: 4 schedulers an SM, one warp instruction each a clock).  The
    # INT32 rate (64 lanes an SM) is reported beside it: it is no bound,
    # since IMAD and its moves and shifts run on the FMA pipe.
    bw = peaks[0]
    instr_rate, int32_rate, sm_count = instruction_rates()
    lib = _build.library_path("afpm_bitwise")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, key in K2_TIMED.items():
        cfg = afpm_config(name)
        ops = sum(sass_loop_ops(lib, "afpm_bitwise_kernel" + key).values()) \
            / K2_PER_LOOP
        for shape in K2_SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda")
            y = torch.randn(shape, generator=gen, device="cuda")
            n = x.numel()
            bytes_ms = 12 * n / bw * 1e3
            ops_ms = ops * n / instr_rate * 1e3
            big = n > 1 << 20
            rows.append(dict(
                design=name, shape=list(shape), ops_per_element=ops,
                kernel_ms=timed_ms(lambda: k2.afpm_bitwise(x, y, cfg), 20, flush, True),
                kernel_call_ms=timed_ms(lambda: k2.afpm_bitwise(x, y, cfg), 20, flush),
                plain_ms=timed_ms(lambda: k2.afpm_bitwise_plain(x, y, cfg),
                                  3 if big else 10, flush, True),
                torch_mul_ms=timed_ms(lambda: torch.mul(x, y), 20, flush, True),
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                int32_ms=ops * n / int32_rate * 1e3,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations"))
            del x, y
    torch.cuda.empty_cache()
    (ROOT / "chiprun_out" / "chip_smoke_bitwise.json").write_text(json.dumps(
        {"card": smi("name,power.limit"), "instr_rate": instr_rate,
         "int32_rate": int32_rate, "sm_count": sm_count, "rows": rows},
        indent=1))
    print(f"[bitwise] afpm_bitwise: {n_cases} cases bit-exact (NaN-ness for "
          f"NaNs; 4 golden cases against their bits and the plain version, the "
          f"rest against the plain version on the card); instruction rate "
          f"{instr_rate / 1e12:.2f} T/s; " + "; ".join(
              f"{r['design']} {r['shape'][0]}x{r['shape'][1]} kernel "
              f"{r['kernel_ms']:.4f} ms (call {r['kernel_call_ms']:.4f}) plain "
              f"{r['plain_ms']:.4f} ms torch.mul (same bytes, not the same "
              f"function) {r['torch_mul_ms']:.4f} ms bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}; {r['ops_per_element']:g} SASS instr/elem, "
              f"{r['int32_ms']:.4f} ms at the INT32 rate)" for r in rows))
    # the kernels line: one Table III operand, AC5-5
    row = next(r for r in rows if r["design"] == "AC5-5"
               and r["shape"] == [512, 512])
    return dict(row, mismatched_bits=sum(b[-1] for b in bad), max_abs_err=worst)


def max_ulps(got, want) -> float:
    """Largest |got - want| in fp32 ulps of want's largest magnitude."""
    import numpy as np

    err = (got - want).abs().max().item()
    return err / float(np.spacing(np.float32(want.abs().max().item())))


def phase_emulated(peaks):
    """K2's emulated-matmul entry against the elementwise entry (K = 1, bit
    for bit) and against its plain version (64 ulps); rows M-invariant,
    split-mode rows equal to whole-mode rows, repeats equal; timed; its
    gradient."""
    import numpy as np
    import torch

    from repro_torch.core.afpm import (AFPMConfig, afpm_matmul_emulated,
                                       chunked_emulated_matmul)
    from repro_torch.core.registry import afpm_config, available, get_multiplier
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import afpm_bitwise as k2
    from repro_torch.numerics import NumericsConfig, nmatmul, numerics_scope

    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(M, K, N):
        """ReLU'd activations (half zeros, as im2col of a ReLU output) and
        weights of scale 1/sqrt(K)."""
        x = torch.randn((M, K), generator=gen, device="cuda").relu()
        return x, torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5

    # 1. K = 1 (one chunk): +0 plus the elementwise product, bit for bit,
    # for every AFPM config and the two ablations [bitwise] holds
    cfgs = [(n, afpm_config(n)) for n in available() if afpm_config(n)]
    cfgs += [("AC5-5/conditional=False", AFPMConfig(n=5, conditional=False)),
             ("AC5-5/skip_bd=False", AFPMConfig(n=5, skip_bd=False))]
    bad = []
    for label, cfg in cfgs:
        x, w = special_inputs(rng, (300, 1)), special_inputs(rng, (1, 257))
        got = dispatch.emulated_matmul(x, w, cfg, backend="hopper")
        prod = k2.afpm_bitwise(x.expand(300, 257).contiguous(),
                               w.expand(300, 257).contiguous(), cfg)
        m, _ = bit_mismatches(got, torch.zeros_like(prod) + prod)
        if m:
            bad.append((label, m))
    if bad:
        raise AssertionError(f"emulated matmul at K = 1 != afpm_bitwise: {bad}")

    # 2. against the plain version: ResNet-18's matmul shapes at batch 8
    # and at Table IV's 48 images for the four designs (k_chunk 64, the
    # path's), ragged shapes and leading dims at k_chunk 16 and 64
    worst_ulp, worst_abs, n_cases = 0.0, 0.0, 0
    cases = [(name, (b * r, K), N, 64) for name in EMU_DESIGNS
             for b in EMU_BATCHES for r, K, N in sorted(set(RESNET_MATMULS))]
    for name in ("AC5-5", "ACL5"):
        cases += [(name, (77, 1001), 93, 16), (name, (1, 27), 10, 64),
                  (name, (130, 200), 65, 16), (name, (2, 3, 50, 130), 70, 64),
                  (name, (5, 4608), 3, 16), (name, (128, 4608), 512, 16)]

    def hold(got, want, what):
        nonlocal worst_ulp, worst_abs, n_cases
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"emulated {what}: bad output")
        ulp = max_ulps(got, want)
        if ulp > ULP_BOUND:
            raise AssertionError(f"emulated {what}: {ulp:.1f} ulps > "
                                 f"{ULP_BOUND}")
        worst_ulp = max(worst_ulp, ulp)
        worst_abs = max(worst_abs, (got - want).abs().max().item())
        n_cases += 1
        return ulp

    for name, xs, N, kc in cases:
        cfg = afpm_config(name)
        x, w = operands(int(np.prod(xs[:-1])), xs[-1], N)
        x = x.reshape(xs)
        hold(k2.emulated_matmul(x, w, cfg, kc),
             afpm_matmul_emulated(x, w, cfg, kc),
             f"{name} {xs} @ ({xs[-1]}, {N}) k_chunk {kc}")
    del x, w
    # an AC-<fmt> registry entry through nmatmul: the kernel, at its
    # storage format, against the registry's plain route
    for name in ("AC-fp16", "AC-bf16"):
        x, w = operands(512, 576, 64)
        k2.emulated_matmul.launches = 0
        with numerics_scope(NumericsConfig(mode="emulated", multiplier=name)):
            got = nmatmul(x, w)
        if k2.emulated_matmul.launches != 1:
            raise AssertionError(f"emulated {name}: nmatmul launched the "
                                 f"kernel {k2.emulated_matmul.launches} times")
        hold(got, chunked_emulated_matmul(x, w, get_multiplier(name)),
             f"{name} through nmatmul")

    # 3. rows independent of M, bit for bit (M 1-300): split-mode rows
    # against whole-mode rows among them
    n_rows = 0
    for name in EMU_DESIGNS:
        cfg, modes = afpm_config(name), set()
        for K, N, kc in INVARIANCE_KN:
            x, w = operands(300, K, N)
            full = k2.emulated_matmul(x, w, cfg, kc)
            modes.add(k2.plan(300, K, N, kc).split)
            for M in (1, 2, 7, 13, 64, 65, 128, 150, 200, 299):
                modes.add(k2.plan(M, K, N, kc).split)
                m, _ = bit_mismatches(k2.emulated_matmul(x[:M], w, cfg, kc),
                                      full[:M])
                if m:
                    raise AssertionError(f"emulated {name} ({M}, {K}) @ ({K}, "
                                         f"{N}) k_chunk {kc}: {m} elements "
                                         f"differ from M = 300's")
                n_rows += M
        if modes != {True, False}:
            raise AssertionError("the M-invariance check missed a plan mode")

    # 4. two calls equal, in either mode
    for name in EMU_DESIGNS:
        cfg = afpm_config(name)
        for M, K, N, kc in [(128, 4608, 512, 64), (8, 512, 10, 64),
                            (300, 1000, 70, 16), (300, 576, 1600, 64)]:
            x, w = operands(M, K, N)
            if bit_mismatches(k2.emulated_matmul(x, w, cfg, kc),
                              k2.emulated_matmul(x, w, cfg, kc))[0]:
                raise AssertionError(f"emulated {name} ({M}, {K}, {N}): two "
                                     f"calls differ")

    # 5. timing at Table IV's 48 images: device time behind the spin after
    # the 64 MB write flush, as K1-K3; the timed calls' outputs are held to
    # 64 ulps too.  Bound = max(bytes, products x the operations a product
    # needs (EMU_FUNCTION_OPS) over the instruction rate).  Beside it, the
    # built inner loop's SASS instructions a product, at the issue rate and
    # by Hopper's pipes (pipe_split)
    bw = peaks[0]
    instr_rate, int32_rate, _ = instruction_rates()
    lib = _build.library_path("afpm_bitwise")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    rows = []
    for name in ("AC5-5", "ACL5"):
        cfg = afpm_config(name)
        loop = pipe_split(sass_loop_ops(lib, "afpm_emulated_kernel"
                                        + K2_TIMED[name]))
        per = {k: v / EMU_PER_LOOP for k, v in loop.items()}
        for label, (M, K, N) in EMU_TIMED.items():
            x, w = operands(M, K, N)
            products = M * K * N
            bytes_ms = (M * K + K * N + M * N) * 4 / bw * 1e3
            ops_ms = products * EMU_FUNCTION_OPS[name] / instr_rate * 1e3
            out = {}

            def kernel():
                out["kernel"] = k2.emulated_matmul(x, w, cfg)

            def plain():
                out["plain"] = afpm_matmul_emulated(x, w, cfg)

            row = dict(
                design=name, shape=label, M=M, K=K, N=N,
                plan=k2.plan(M, K, N)._asdict(),
                function_ops_per_product=EMU_FUNCTION_OPS[name],
                sass_per_product=per,
                kernel_ms=timed_ms(kernel, 10, flush, True),
                plain_ms=timed_ms(plain, 1, flush, True),
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                sass_issue_ms=products * per["total"] / instr_rate * 1e3,
                sass_pipe_ms=products * per["slots"] / instr_rate * 1e3,
                int32_ms=products * per["total"] / int32_rate * 1e3,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            row["max_ulp_err"] = hold(out["kernel"], out["plain"],
                                      f"{name} {label} timed")
            rows.append(row)
            del x, w, out
    torch.cuda.empty_cache()

    # 6. gradient: the kernel route's straight-through gradients against
    # the plain route's, 1e-5 of each input's largest
    cfg = afpm_config("AC5-5")
    x, w = operands(128, 1152, 256)
    x = x.reshape(2, 64, 1152)
    g = torch.randn((2, 64, 256), generator=gen, device="cuda")
    grads = {}
    for backend in ("hopper", "torch"):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (dispatch.emulated_matmul(xx, ww, cfg, backend=backend)
         * g).sum().backward()
        grads[backend] = (xx.grad, ww.grad)
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(grads["hopper"], grads["torch"]))
    if not grad_err <= 1e-5:
        raise AssertionError(f"emulated matmul gradient {grad_err:.3g} of the "
                             f"largest from the plain route's (bound 1e-5)")

    (ROOT / "chiprun_out" / "chip_smoke_emulated.json").write_text(json.dumps(
        {"card": smi("name,power.limit"), "instr_rate": instr_rate,
         "int32_rate": int32_rate, "rows": rows}, indent=1))
    print(f"[emulated] K = 1 == afpm_bitwise bit for bit for {len(cfgs)} "
          f"configs (specials included); {n_cases} matmuls (ResNet-18's "
          f"shapes at {' and '.join(map(str, EMU_BATCHES))} images x "
          f"{len(EMU_DESIGNS)} designs, ragged, leading dims, k_chunk 16/64, "
          f"AC-fp16/bf16 through nmatmul, the timed calls) within "
          f"{worst_ulp:.2f} ulps of the plain version (bound {ULP_BOUND}, "
          f"{worst_abs:.3g} abs); {n_rows} rows at M 1-299 equal to M = 300's "
          f"bit for bit, split-mode rows against whole-mode rows among them; "
          f"repeats equal; gradient {grad_err:.3g} of the largest from the "
          f"plain route's (bound 1e-5)")
    for r in rows:
        sp = r["sass_per_product"]
        print(f"[emulated]   {r['design']} {r['shape']} ({r['M']}, {r['K']}) @ "
              f"({r['K']}, {r['N']}): kernel {r['kernel_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.1f} ms, {r['max_ulp_err']:.2f} ulps apart; "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['function_ops_per_product']} operations a product; bytes "
              f"{r['bytes_ms']:.4f} ms); the built loop {sp['total']:g} SASS "
              f"instr a product ({sp['alu']:g} ALU, {sp['imad']:g} IMAD, "
              f"{sp['fp']:g} fp32, {sp['other']:g} other): "
              f"{r['sass_issue_ms']:.4f} ms at the issue rate, "
              f"{r['sass_pipe_ms']:.4f} ms by its pipes, "
              f"{r['int32_ms']:.4f} ms all at the INT32 rate; plan "
              f"{'split' if r['plan']['split'] else 'whole'} "
              f"{tuple(r['plan']['grid'])}")
    row = rows[0]   # the kernels line: AC5-5 at stage 0's conv
    return dict(row, max_ulp_err=worst_ulp, max_abs_err=worst_abs,
                grad_err=grad_err)


def phase_table3():
    import numpy as np

    from repro_torch.bench import table3_image as t3
    from repro_torch.core.registry import afpm_config
    from repro_torch.kernels import afpm_bitwise as k2
    from repro_torch.kernels import afpm_matmul as k1

    bench = json.loads(BENCH_CPU.read_text())["metrics"]
    small = t3.run(n_images=2, size=96)
    worst = 0.0
    for name, row in small.psnr.items():
        for kind, got in (("blend", row[0]), ("edge", row[2])):
            want = bench[f"table3_{name}_psnr_{kind}"]["value"]
            if not abs(got - want) <= 1e-9:
                raise AssertionError(f"Table III {name} {kind} at 96: {got!r} dB "
                                     f"on the card, {want!r} in {BENCH_CPU.name}")
            worst = max(worst, abs(got - want))

    n_img, size = 3, 512
    k1.afpm_matmul.launches = 0
    k2.afpm_bitwise.launches = 0
    t0 = time.perf_counter()
    full = t3.run(n_images=n_img, size=size, backend="auto")
    full_s = time.perf_counter() - t0
    launches = k2.afpm_bitwise.launches
    # products of one design: 2 per blend pair; per edge image one per
    # nonzero Sobel tap of each direction plus the two squares
    afpm = [n for n in t3.MULTS if afpm_config(n) is not None]
    per_edge = int(np.count_nonzero(t3.SOBEL_X) + np.count_nonzero(t3.SOBEL_Y)) + 2
    expected = len(afpm) * (2 * n_img + per_edge * n_img)
    if launches != expected or expected != 192:
        raise AssertionError(f"afpm_bitwise launched {launches} times in the "
                             f"Table III run, expected {expected} (192)")
    plain = t3.run(n_images=n_img, size=size, backend="torch")
    diff = {name: sum(int((a.view(np.uint32) != b.view(np.uint32)).sum())
                      for a, b in zip(full.outputs[name], plain.outputs[name]))
            for name in t3.MULTS}
    if any(diff.values()) or full.psnr != plain.psnr:
        raise AssertionError(f"Table III kernel route != plain route: {diff}")
    for r in full.psnr.values():
        if not all(np.isfinite(v) and v > 0 for v in r):
            raise AssertionError(f"Table III PSNRs not finite: {full.psnr}")
    print(f"[table3] size 96 x 2 pairs: 24 PSNRs == {BENCH_CPU.name} (worst "
          f"{worst:.3g} dB); size {size} x {n_img} pairs: kernel route == plain "
          f"route bit for bit for {len(t3.MULTS)} designs; afpm_bitwise "
          f"launches {launches} = {len(afpm)} designs x ({2 * n_img} blend + "
          f"{per_edge * n_img} edge products); run {full_s:.2f} s")
    for line in t3.report(full):
        print("[table3] " + line)
    plain_s = ", ".join(f"{n} {plain.seconds[n]:.4f}" for n in afpm)
    print(f"[table3] plain route seconds (AFPM designs): {plain_s}")
    return launches


def ssd_inputs(gen, b, L, H, P, N):
    """Seeded fp32 SSD operands on the card, dt in [0.01, 0.21)."""
    import torch

    r = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    dt = torch.rand((b, L, H), generator=gen, device="cuda") * 0.2 + 0.01
    A = -(torch.rand((H,), generator=gen, device="cuda") * 1.5 + 0.5)
    return r(b, L, H, P), dt, A, r(b, L, N), r(b, L, N)


def phase_ssd(peaks, floor_ms):
    import numpy as np
    import torch

    from repro_torch.kernels import dispatch, ref
    from repro_torch.kernels import ssd_scan as k3

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, P, N, chunk = 24, 64, 128, 128
    # every prefill length the serve phase gives the kernel, and 2048
    cases = [(b, L, H, P, N, chunk) for b in (1, 4)
             for L in (*SERVE_LENGTHS, 2048)]
    cases.append((1, 50, 16, 8, 16, 16))   # reduced config, ragged
    # zamba2-7b's SSD blocks: H 112, P 64, N 64 at the served lengths
    cases += [(b, L, 112, 64, 64, chunk) for b in (1, 4) for L in SERVE_LENGTHS]
    worst_ulp, worst_abs = 0.0, 0.0
    for b, L, h, p, n, q in cases:
        x, dt, A, B, C = ssd_inputs(gen, b, L, h, p, n)
        got = dispatch.ssd(x, dt, A, B, C, chunk=q, backend="hopper")
        want = dispatch.ssd(x, dt, A, B, C, chunk=q, backend="torch")
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"ssd_scan {(b, L, h, p, n, q)}: bad output")
        err = (got - want).abs().max().item()
        ulp = err / float(np.spacing(np.float32(want.abs().max().item())))
        if ulp > ULP_BOUND:
            raise AssertionError(f"ssd_scan {(b, L, h, p, n, q)}: {ulp:.1f} "
                                 f"ulps of the largest output > {ULP_BOUND}")
        worst_ulp, worst_abs = max(worst_ulp, ulp), max(worst_abs, err)
        again = dispatch.ssd(x, dt, A, B, C, chunk=q, backend="hopper")
        if not torch.equal(again, got):   # no float is summed by atomics
            raise AssertionError(f"ssd_scan {(b, L, h, p, n, q)}: two calls "
                                 f"differ")
        if b > 1:   # an element depends only on its (batch row, head)
            for i in range(b):
                one = dispatch.ssd(x[i], dt[i], A, B[i], C[i], chunk=q,
                                   backend="hopper")
                if not torch.equal(one, got[i]):
                    raise AssertionError(f"ssd_scan {(b, L)}: row {i} at "
                                         f"batch 1 != at batch {b}")

    # timing: the kernel as the serve path calls it (one layer's scan of a
    # batch-1 prefill, L padded to a multiple of Q = min(128, L)) and at
    # L = 2048.  kernel_ms times the wrapper behind a device spin, so it
    # holds the kernel and its chunk_decay prologue on the card, not the
    # host's call; the plain version (some 20 launches a chunk) behind a
    # spin of about 20 ms, long enough for the host to enqueue all of its
    # launches.  The bound is for the kernel's own input (padded L): the
    # FMAs y needs (k3.fmas: C B^T once a chunk, no carry on the first
    # chunk, no state update on the last) at the fp32 rate, or x, y, dt, B
    # and C moved once.  decay_ms is the wrapper's plain prologue alone
    # (ref.chunk_decay: a cumsum and a product), timed alike.
    bw, _, fp32 = peaks
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    rows = []
    for b, L, H in ([(1, n, 24) for n in SERVE_LENGTHS]
                    + [(1, 2048, 24), (4, 2048, 24), (1, SERVE_LENGTHS[2], 112)]):
        N = 128 if H == 24 else 64    # mamba2-130m, or zamba2-7b
        Q = min(chunk, L)
        Lp = -(-L // Q) * Q
        x, dt, A, B, C = ssd_inputs(gen, b, Lp, H, P, N)
        ops_ms = 2 * k3.fmas(b, Lp, H, P, N, Q) / fp32 * 1e3
        bytes_ms = 4 * (2 * b * Lp * H * P + b * Lp * H + H
                        + 2 * b * Lp * N) / bw * 1e3
        pl = k3.plan(Lp, Q, H, P, N)
        rows.append(dict(
            batch=b, L=L, L_padded=Lp, Q=Q, H=H, N=N, plan=pl._asdict(),
            kernels_a_call=pl.kernels, launch_floor_ms=floor_ms,
            kernel_ms=timed_ms(lambda: k3.ssd_scan(x, dt, A, B, C, Q), 20,
                               flush, True),
            decay_ms=timed_ms(lambda: ref.chunk_decay(dt, A, Q), 20, flush,
                              True),
            plain_ms=timed_ms(lambda: k3.ssd_scan_plain(x, dt, A, B, C, Q),
                              5, flush, True, spin_cycles=40_000_000),
            ops_ms=ops_ms, bytes_ms=bytes_ms, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes"))
    (ROOT / "chiprun_out" / "chip_smoke_ssd.json").write_text(json.dumps(
        {"card": smi("name,power.limit"), "rows": rows}, indent=1))
    print(f"[ssd] ssd_scan: {len(cases)} cases within {ULP_BOUND} ulps of the "
          f"largest output (worst {worst_ulp:.2f} ulps, {worst_abs:.3g} abs), "
          f"batch 4 == batch 1 row by row, two calls equal bit for bit; a "
          f"call launches {rows[0]['kernels_a_call']} kernels after "
          f"chunk_decay's 2 ops; launch floor {floor_ms:.4f} ms a launch "
          f"(phase 2); " + "; ".join(
              f"b{r['batch']} L {r['L']} H {r['H']} N {r['N']} (padded "
              f"{r['L_padded']}, Q {r['Q']}, "
              f"{r['plan']['grid_a']} + {r['plan']['grid_b']} CTAs a row) kernel "
              f"{r['kernel_ms']:.4f} ms (chunk_decay {r['decay_ms']:.4f}) plain "
              f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; operations {r['ops_ms']:.4f}, bytes "
              f"{r['bytes_ms']:.4f})" for r in rows))
    row = next(r for r in rows if r["L"] == SERVE_LENGTHS[2]
               and r["batch"] == 1 and r["H"] == 24)
    zamba2 = next(r for r in rows if r["H"] == 112)
    return dict(row, max_abs_err=worst_abs, max_ulp_err=worst_ulp,
                zamba2={k: zamba2[k] for k in (
                    "L", "L_padded", "H", "N", "kernel_ms", "decay_ms",
                    "plain_ms", "bound_ms", "bound_by")})


def phase_mamba2():
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS
    from repro_torch.session import Session

    cfg = get_arch("mamba2-130m")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (24, 768, 50280)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = Session(cfg, seed=0)
    sess.params  # seeded random init on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = sess.serving_engine(slots=4, max_len=256)
    if any(lane.runner.chunked for lane in eng._lanes.values()):
        raise AssertionError("mamba2 lanes should prefill whole prompts")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(6):
        tier = DEFAULT_TIERS[i % 3].name
        plen = SERVE_LENGTHS[(i + i // 3) % 3]
        reqs.append(eng.submit(rng.integers(0, cfg.vocab, plen), tier=tier,
                               max_new_tokens=16))

    k1.afpm_matmul.launches = 0
    k3.ssd_scan.launches = 0
    t0 = time.perf_counter()
    stats = eng.run()
    serve_s = time.perf_counter() - t0
    launches, k1_launches = k3.ssd_scan.launches, k1.afpm_matmul.launches

    bad = [r.id for r in reqs if not r.done or len(r.result()) != 16]
    if bad:
        raise AssertionError(f"requests did not finish with 16 tokens: {bad}")
    prefills = sum(st.n_prefill_chunks for st in stats.values())
    if prefills != len(reqs) or launches != cfg.n_layers * prefills:
        raise AssertionError(f"ssd_scan launched {launches} times, expected "
                             f"{cfg.n_layers} x {prefills} prefills")
    # every tier: in_proj and out_proj a layer and the LM head
    per_forward = 2 * cfg.n_layers + 1
    forwards = sum(st.n_prefill_chunks + st.n_decode_steps
                   for st in stats.values())
    fails = []
    if k1_launches != per_forward * forwards:
        fails.append(f"afpm_matmul launched {k1_launches} times, expected "
                     f"{per_forward} x {forwards} forwards")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fails += solo_mismatches("mamba2-130m", sess, reqs)

    # the kernel route against the plain route on the card, one full-width
    # prompt of each served length, under exact (only the scan differs) and
    # standard
    prompts = {len(r.prompt): r.prompt for r in reqs}
    logit_err = {"exact": 0.0, "segmented3": 0.0}
    with torch.inference_mode():
        for plen in SERVE_LENGTHS:
            prompt = torch.as_tensor(prompts[plen][None], device="cuda")
            for policy in logit_err:
                out = {}
                for backend in ("auto", "torch"):
                    s = sess.replace(policy=policy, backend=backend)
                    before = k3.ssd_scan.launches
                    out[backend], _ = transformer.prefill(
                        s.params, s.config, {"tokens": prompt})
                    ran = k3.ssd_scan.launches - before
                    if ran != (cfg.n_layers if backend == "auto" else 0):
                        raise AssertionError(
                            f"{policy}/{backend}: ssd_scan ran {ran} times "
                            f"in one prefill")
                want = out["torch"]
                if out["auto"].shape != (1, 1, cfg.vocab) \
                        or not torch.isfinite(out["auto"]).all():
                    raise AssertionError(f"prefill logits bad: "
                                         f"{tuple(out['auto'].shape)}")
                rel = ((out["auto"] - want).abs().max()
                       / want.abs().max()).item()
                if rel > LOGIT_BOUND:
                    raise AssertionError(
                        f"{policy}, {plen} tokens: kernel-route logits "
                        f"differ from the plain route by {rel:.3g} of the "
                        f"largest > {LOGIT_BOUND}")
                logit_err[policy] = max(logit_err[policy], rel)

    parts = []
    for t in DEFAULT_TIERS:
        st = stats[t.name]
        dec_tokens = st.n_tokens - st.n_finished
        parts.append(f"{t.name}({t.policy}) decode "
                     f"{dec_tokens / st.decode_s:.1f} tok/s "
                     f"{1e3 * st.decode_s / st.n_decode_steps:.2f} ms/step "
                     f"prefill {1e3 * st.prefill_s / st.n_prefill_chunks:.2f} "
                     f"ms/request")
    print(f"[mamba2] mamba2-130m full width ({cfg.param_count() / 1e6:.1f} M "
          f"params, init {init_s:.1f} s): 6 requests x 16 tokens in "
          f"{serve_s:.2f} s; {'; '.join(parts)}; ssd_scan launches {launches}"
          f" = {cfg.n_layers} x {prefills} prefills; afpm_matmul launches "
          f"{k1_launches} = {per_forward} x {forwards} forwards; every "
          f"tier's tokens == its solo generate; kernel vs plain route "
          f"prefill logits "
          f"(prompts of {'/'.join(map(str, SERVE_LENGTHS))} tokens) at most "
          f"{logit_err['exact']:.3g} (exact) and {logit_err['segmented3']:.3g}"
          f" (standard) of the largest (bound {LOGIT_BOUND:.3g}); peak memory "
          f"{peak_gb:.2f} GB")
    if fails:
        raise AssertionError("[mamba2]: " + "; ".join(fails))
    return launches


def phase_zamba2():
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS, kvcache
    from repro_torch.session import Session

    cfg = get_arch("zamba2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab) == (81, 3584, 32000)
    n_ssd = sum(r * sum(s.kind == "ssm" for s in p) for r, p in cfg.segments)
    n_shared = sum(r for r, p in cfg.segments if any(s.shared for s in p))
    # every tier: in_proj and out_proj an SSD block, the shared block's
    # seven projections an application, and the LM head
    per_forward = 2 * n_ssd + 7 * n_shared + 1
    assert (n_ssd, n_shared, per_forward) == (68, 13, 228)
    n_params = sum(int(np.prod(shape)) for shape, _ in
                   transformer.param_shapes(cfg).values())
    assert n_params == 5_737_364_864, n_params
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = Session(cfg, seed=0)
    sess.params  # seeded random init on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gb = torch.cuda.memory_allocated() / 1e9 - held_gb
    eng = sess.serving_engine(slots=4, max_len=256)
    pools_gb = torch.cuda.memory_allocated() / 1e9 - held_gb - params_gb
    if any(lane.runner.chunked for lane in eng._lanes.values()) \
            or kvcache.paged_layout(cfg) != (frozenset({5}), frozenset()):
        raise AssertionError("zamba2 lanes should page the shared block's "
                             "KV caches, keep the SSD states per slot and "
                             "prefill whole prompts")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(6):
        tier = DEFAULT_TIERS[i % 3].name
        plen = SERVE_LENGTHS[(i + i // 3) % 3]
        reqs.append(eng.submit(rng.integers(0, cfg.vocab, plen), tier=tier,
                               max_new_tokens=16))

    k1.afpm_matmul.launches = 0
    k3.ssd_scan.launches = 0
    t0 = time.perf_counter()
    stats = eng.run()
    serve_s = time.perf_counter() - t0
    launches, k1_launches = k3.ssd_scan.launches, k1.afpm_matmul.launches
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    bad = [r.id for r in reqs if not r.done or len(r.result()) != 16]
    if bad:
        raise AssertionError(f"requests did not finish with 16 tokens: {bad}")
    prefills = sum(st.n_prefill_chunks for st in stats.values())
    if prefills != len(reqs) or launches != n_ssd * prefills:
        raise AssertionError(f"ssd_scan launched {launches} times, expected "
                             f"{n_ssd} x {prefills} prefills")
    forwards = sum(st.n_prefill_chunks + st.n_decode_steps
                   for st in stats.values())
    fails = []
    if k1_launches != per_forward * forwards:
        fails.append(f"afpm_matmul launched {k1_launches} times, expected "
                     f"{per_forward} x {forwards} forwards")

    # per tier, with the engine's pools freed: a solo generate of the
    # longest prompt and its peak memory; every request equals its tier's
    # solo generate bit for bit, and a decode row among 4 equals it alone
    del eng
    torch.cuda.empty_cache()
    longest = next(r for r in reqs if len(r.prompt) == SERVE_LENGTHS[2])
    peak = {}
    for t in DEFAULT_TIERS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sess.replace(policy=t.policy).generate(prompts=longest.prompt[None],
                                               gen_len=16)
        peak[t.name] = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    fails += solo_mismatches("zamba2-7b", sess, reqs)
    decode_row, bad = decode_row_probe("zamba2-7b", sess)
    fails += bad

    # the kernel route against the plain route, one full-width prompt of
    # each served length, under exact (only the scan differs) and standard,
    # with the config's bf16 activations and with fp32 ones
    prompts = {len(r.prompt): r.prompt for r in reqs}
    logit_err = {(policy, dtype): [] for dtype in ("bfloat16", "float32")
                 for policy in ("exact", "segmented3")}
    plain = {}
    with torch.inference_mode():
        for plen in SERVE_LENGTHS:
            prompt = torch.as_tensor(prompts[plen][None], device="cuda")
            for policy, dtype in logit_err:
                out = {}
                for backend in ("auto", "torch"):
                    s = sess.replace(policy=policy, backend=backend)
                    c = dataclasses.replace(s.config, dtype=dtype)
                    b3, b1 = k3.ssd_scan.launches, k1.afpm_matmul.launches
                    out[backend], _ = transformer.prefill(
                        s.params, c, {"tokens": prompt})
                    ran3 = k3.ssd_scan.launches - b3
                    ran1 = k1.afpm_matmul.launches - b1
                    want3 = n_ssd if backend == "auto" else 0
                    want1 = per_forward if backend == "auto" else 0
                    if (ran3, ran1) != (want3, want1):
                        fails.append(
                            f"{policy}/{backend}: ssd_scan ran {ran3} and "
                            f"afpm_matmul {ran1} times in one prefill, "
                            f"expected {want3} and {want1}")
                want = plain[policy, dtype, plen] = out["torch"]
                if out["auto"].shape != (1, 1, cfg.vocab) \
                        or not torch.isfinite(out["auto"]).all():
                    raise AssertionError(f"prefill logits bad: "
                                         f"{tuple(out['auto'].shape)}")
                logit_err[policy, dtype].append(
                    ((out["auto"] - want).abs().max()
                     / want.abs().max()).item())
    # the bf16 readings' floor: the plain route against itself with its
    # scan's outputs one fp32 ulp up, under exact (where only the scan
    # differs between the routes); not gated
    real = ref.ssd_scan_chunked_ref

    def nudged(*args):
        out = real(*args)
        return torch.nextafter(out, torch.full_like(out, 1e38))

    spread = []
    ref.ssd_scan_chunked_ref = nudged
    try:
        s = sess.replace(policy="exact", backend="torch")
        with torch.inference_mode():
            for plen in SERVE_LENGTHS:
                want = plain["exact", "bfloat16", plen]
                got, _ = transformer.prefill(s.params, s.config, {
                    "tokens": torch.as_tensor(prompts[plen][None],
                                              device="cuda")})
                spread.append(((got - want).abs().max()
                               / want.abs().max()).item())
    finally:
        ref.ssd_scan_chunked_ref = real
    # gated once every reading is in, so a failure shows them all
    readings, over = [], []
    for (policy, dtype), errs in logit_err.items():
        bound = logit_bound(policy, dtype)
        readings.append(f"{policy}/{dtype} "
                        f"{', '.join(f'{e:.3g}' for e in errs)} "
                        f"(bound {bound:.3g})")
        if max(errs) > bound:
            over.append(readings[-1])
    if over:
        raise AssertionError(f"kernel-route prefill logits differ from the "
                             f"plain route's by more than the bound, of the "
                             f"largest, prompts of {SERVE_LENGTHS} tokens: "
                             f"{'; '.join(over)}")

    tiers = {}
    parts = []
    for t in DEFAULT_TIERS:
        st = stats[t.name]
        dec_tokens = st.n_tokens - st.n_finished
        tiers[t.name] = dict(
            policy=t.policy, decode_tok_s=dec_tokens / st.decode_s,
            decode_ms_step=1e3 * st.decode_s / st.n_decode_steps,
            decode_steps=st.n_decode_steps,
            prefill_ms=1e3 * st.prefill_s / st.n_prefill_chunks,
            solo_peak_gb=peak[t.name])
        parts.append(f"{t.name}({t.policy}) decode "
                     f"{tiers[t.name]['decode_tok_s']:.1f} tok/s "
                     f"{tiers[t.name]['decode_ms_step']:.2f} ms/step prefill "
                     f"{tiers[t.name]['prefill_ms']:.2f} ms/request, a "
                     f"solo generate of {SERVE_LENGTHS[2]} + 16 tokens peaks "
                     f"at {peak[t.name]:.2f} GB")
    print(f"[zamba2] zamba2-7b full width ({n_params / 1e9:.3f} B params, "
          f"{params_gb:.2f} GB on the card, init {init_s:.1f} s; the three "
          f"lanes' pools {pools_gb:.2f} GB): 6 requests x 16 tokens in "
          f"{serve_s:.2f} s; {'; '.join(parts)}; engine peak "
          f"{serve_peak_gb - held_gb:.2f} GB; ssd_scan launches {launches} = "
          f"{n_ssd} x "
          f"{prefills} prefills; afpm_matmul launches {k1_launches} = "
          f"{per_forward} x {forwards} forwards; every tier's tokens == its "
          f"solo generate; a decode row among 4 vs alone, ulp gap "
          f"{decode_row}; kernel vs plain route prefill logits (prompts of "
          f"{'/'.join(map(str, SERVE_LENGTHS))} tokens), of the largest: "
          f"{'; '.join(readings)}; the plain route against itself with its "
          f"scan one ulp up, exact/bfloat16: "
          f"{', '.join(f'{e:.3g}' for e in spread)}")
    out = dict(k3=launches, k1=k1_launches, prefills=prefills,
               forwards=forwards, params=n_params, params_gb=params_gb,
               pools_gb=pools_gb, init_s=init_s, serve_s=serve_s,
               serve_peak_gb=serve_peak_gb - held_gb,
               tiers=tiers, logit_err={f"{p}/{d}": errs for (p, d), errs
                                       in logit_err.items()},
               plain_one_ulp_spread=spread, decode_row=decode_row)
    (ROOT / "chiprun_out" / "chip_smoke_zamba2.json").write_text(json.dumps(
        dict(out, card=smi("name,power.limit")), indent=1))
    if fails:
        raise AssertionError("[zamba2]: " + "; ".join(fails))
    return out


def phase_cli():
    """The session CLI on the card: each subcommand as a user runs it
    (``python -m repro_torch.session ...`` is ``main(argv)``), exit 0; the
    qwen3-4b fixture loaded through ``from_pretrained`` equal to the file's
    reference arrays bit for bit."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.compat import flatten_tree
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.session import Session, main

    fixture = ROOT / "tests" / "golden" / "compat" / "qwen3-4b"
    runs = [
        ["generate", "--arch", "zamba2-7b"],
        ["serve-loop", "--weights", str(fixture), "--tiers",
         "premium:exact,standard:segmented3"],
        ["ppa"],
        ["auto-configure", "--arch", "zamba2-7b", "--budget", "1e-2"],
    ]
    lines = {}
    for argv in runs:
        buf = io.StringIO()
        before = k1.afpm_matmul.launches
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        secs = time.perf_counter() - t0
        out = buf.getvalue().splitlines()
        if rc != 0:
            raise AssertionError(f"session CLI {' '.join(argv)}: exit {rc}")
        lines[argv[0]] = dict(seconds=secs, lines=out,
                              k1=k1.afpm_matmul.launches - before)
    if lines["serve-loop"]["k1"] <= 0:
        raise AssertionError("serve-loop's standard tier ran no afpm_matmul")
    sess = Session.from_pretrained("qwen3-4b", fixture)
    ref = dict(np.load(fixture.parent / "qwen3-4b_reference.npz"))
    got = {k: v for k, v in flatten_tree(sess.params).items()}
    if sess.params["embed"].device.type != "cuda" or sorted(got) != sorted(ref):
        raise AssertionError("from_pretrained: params not on the card, or "
                             "names differ from the reference")
    for k, v in ref.items():
        if got[k].dtype != v.dtype or not np.array_equal(
                got[k].view(np.uint32), v.view(np.uint32)):
            raise AssertionError(f"from_pretrained: {k} differs from the "
                                 f"reference bit for bit")
    del sess
    torch.cuda.empty_cache()
    (ROOT / "chiprun_out" / "chip_smoke_cli.txt").write_text("\n".join(
        f"$ python -m repro_torch.session {' '.join(a)}\n"
        + "\n".join(lines[a[0]]["lines"]) for a in runs))
    summary = "; ".join(
        f"{cmd} exit 0 in {v['seconds']:.1f} s ({v['lines'][-1].strip()})"
        for cmd, v in lines.items())
    print(f"[cli] {summary}; from_pretrained('qwen3-4b') on the card == "
          f"qwen3-4b_reference.npz bit for bit ({len(ref)} tensors); "
          f"serve-loop's standard tier {lines['serve-loop']['k1']} "
          f"afpm_matmul launches")
    return lines


def zoo_shapes_of(cfg):
    """(K, N) of one decode layer's seven projections, from the model's
    own parameter shapes."""
    from repro_torch.models import transformer

    shapes = transformer.param_shapes(cfg)
    return [tuple(shapes[f"seg0_p0.{site}"][0][-2:]) for site in (
        "attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi", "mlp.wg",
        "mlp.wo")]


def phase_whisper():
    """Full-width whisper-tiny through the model API (the reference has no
    whisper ``generate`` and no whisper serving): 4 x 1500 seeded frames,
    an 8-token prompt, 32 greedy tokens, under exact, segmented3 and
    segmented1; K1 launches counted per prefill and per decode step; the
    kernel route's prefill and decode logits against the plain route's
    (fed the same tokens); the committed fixture bit for bit on the card."""
    import numpy as np
    import torch

    from repro_torch.compat import flatten_tree
    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.models import transformer
    from repro_torch.numerics import numerics_scope
    from repro_torch.session import Session

    cfg = get_arch("whisper-tiny")
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.vocab,
            cfg.enc_len) == (4, 4, WD, 51865, 1500)
    n_params = sum(int(np.prod(shape)) for shape, _ in
                   transformer.param_shapes(cfg).values())
    assert n_params == 61_074_432, n_params
    # K1 under every tier: seven projections an encoder layer, eleven a
    # decoder layer (self- and cross-attention, MLP) and the LM head
    per_enc, per_dec = 7 * cfg.encoder_layers, 11 * cfg.n_layers + 1
    assert (per_enc, per_dec) == (28, 45)
    B, plen, gen_len = 4, 8, 32
    assert plen + gen_len <= cfg.decoder_len
    sess = Session(cfg, seed=0)
    sess.params  # seeded random init on the card
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, plen), generator=gen,
                                     device="cuda"),
             "enc_embeds": torch.randn((B, cfg.enc_len, cfg.d_model),
                                       generator=gen, device="cuda")}

    def run(s, forced=None):
        """Prefill, then gen_len - 1 decode steps (greedy, or fed
        ``forced``); returns the logits of every step, the tokens, the
        launches of the prefill and of each step, and the host ms."""
        c = s.config
        with torch.inference_mode():
            b1 = k1.afpm_matmul.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = transformer.prefill(s.params, c, batch,
                                                max_len=plen + gen_len)
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            pre = k1.afpm_matmul.launches - b1
            out, toks = [logits], [logits[:, -1:].argmax(-1)]
            t0 = time.perf_counter()
            for i in range(gen_len - 1):
                tok = toks[-1] if forced is None else forced[:, i:i + 1]
                logits, state = transformer.decode_step(
                    s.params, c, {"token": tok}, state, plen + i)
                out.append(logits)
                toks.append(logits[:, -1:].argmax(-1))
            torch.cuda.synchronize()
            decode_ms = 1e3 * (time.perf_counter() - t0) / (gen_len - 1)
            steps = k1.afpm_matmul.launches - b1 - pre
        return dict(logits=out, tokens=torch.cat(toks, 1), pre=pre,
                    steps=steps, prefill_ms=prefill_ms, decode_ms=decode_ms)

    run(sess.replace(policy="segmented3"))    # warm
    tiers = {}
    k1.afpm_matmul.launches = 0
    for policy in ("exact", "segmented3", "segmented1"):
        tiers[policy] = run(sess.replace(policy=policy))
    launches = k1.afpm_matmul.launches
    for policy, r in tiers.items():
        want = (per_enc + per_dec, per_dec * (gen_len - 1))
        if (r["pre"], r["steps"]) != want:
            raise AssertionError(
                f"whisper {policy}: afpm_matmul ran {r['pre']} times in the "
                f"prefill and {r['steps']} in {gen_len - 1} decode steps, "
                f"expected {want[0]} and {want[1]}")
        bad = [i for i, lg in enumerate(r["logits"])
               if lg.shape != (B, 1, cfg.vocab) or not torch.isfinite(lg).all()]
        if bad or r["tokens"].shape != (B, gen_len):
            raise AssertionError(f"whisper {policy}: bad logits at steps "
                                 f"{bad[:4]}")
    # the kernel route against the plain route, fed the kernel route's
    # tokens; and the encoder alone, timed
    errs, enc_ms = {}, {}
    for policy, r in tiers.items():
        s = sess.replace(policy=policy)
        plain = run(s.replace(backend="torch"), forced=r["tokens"][:, :-1])
        if plain["pre"] or plain["steps"]:
            raise AssertionError(f"whisper {policy}: the plain route ran "
                                 f"afpm_matmul")
        errs[policy] = [rel_err(a, b) for a, b in zip(r["logits"],
                                                     plain["logits"])]
        with torch.inference_mode(), numerics_scope(s.config.numerics):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                transformer.encoder_apply(s.params["encoder"], s.config, batch)
            torch.cuda.synchronize()
            enc_ms[policy] = 1e3 * (time.perf_counter() - t0) / 5
    over = [f"{p}: prefill {e[0]:.3g}, decode up to {max(e[1:]):.3g}"
            for p, e in errs.items() if max(e) > LOGIT_BOUND]
    if over:
        raise AssertionError(f"whisper kernel-route logits differ from the "
                             f"plain route's by more than {LOGIT_BOUND:.3g} "
                             f"of the largest: {'; '.join(over)}")

    fixture = ROOT / "tests" / "golden" / "compat" / "whisper-tiny"
    loaded = Session.from_pretrained("whisper-tiny", fixture)
    ref = dict(np.load(fixture.parent / "whisper-tiny_reference.npz"))
    got = flatten_tree(loaded.params)
    if loaded.params["embed"].device.type != "cuda" \
            or sorted(got) != sorted(ref):
        raise AssertionError("whisper from_pretrained: params not on the "
                             "card, or names differ from the reference")
    for k, v in ref.items():
        if got[k].dtype != v.dtype or not np.array_equal(
                got[k].view(np.uint32), v.view(np.uint32)):
            raise AssertionError(f"whisper from_pretrained: {k} differs from "
                                 f"the reference bit for bit")
    del loaded, sess
    torch.cuda.empty_cache()

    rows = {p: dict(encoder_ms=enc_ms[p], prefill_ms=r["prefill_ms"],
                    decode_ms_step=r["decode_ms"],
                    prefill_launches=r["pre"], step_launches=r["steps"]
                    // (gen_len - 1),
                    logits_rel_err=max(errs[p]))
            for p, r in tiers.items()}
    print(f"[whisper] whisper-tiny full width ({n_params / 1e6:.2f} M params"
          f" on the card), {B} x {cfg.enc_len} frames, {plen}-token prompt, "
          f"{gen_len} greedy tokens: " + "; ".join(
              f"{p} encoder {v['encoder_ms']:.2f} ms, prefill "
              f"{v['prefill_ms']:.2f} ms, decode {v['decode_ms_step']:.2f} "
              f"ms/step, afpm_matmul {v['prefill_launches']} a prefill and "
              f"{v['step_launches']} a step, kernel vs plain logits "
              f"{v['logits_rel_err']:.3g} of the largest"
              for p, v in rows.items())
          + f" (bound {LOGIT_BOUND:.3g}); afpm_matmul launches {launches}; "
          f"from_pretrained('whisper-tiny') on the card == "
          f"whisper-tiny_reference.npz bit for bit ({len(ref)} tensors)")
    return dict(k1=launches, tiers=rows, params=n_params)


def phase_gemma2():
    """Full-width gemma2-9b served by the engine as [serve] serves
    qwen3-4b; every logit the engine computes within the logit softcap."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS
    from repro_torch.session import Session

    cfg = get_arch("gemma2-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.logit_softcap,
            cfg.attn_softcap) == (42, 3584, 256000, 30.0, 50.0)
    assert zoo_shapes_of(cfg) == GEMMA2_LAYER
    per_forward = 7 * cfg.n_layers + 1   # every tier: and the LM head
    assert per_forward == 295
    n_params = sum(int(np.prod(shape)) for shape, _ in
                   transformer.param_shapes(cfg).values())
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = Session(cfg, seed=0)
    sess.params  # seeded random init on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gb = torch.cuda.memory_allocated() / 1e9 - held_gb
    eng = sess.serving_engine(slots=4, max_len=256)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(6):
        tier = DEFAULT_TIERS[i % 3].name
        plen = SERVE_LENGTHS[(i + i // 3) % 3]
        reqs.append(eng.submit(rng.integers(0, cfg.vocab, plen), tier=tier,
                               max_new_tokens=16))

    # the largest |logit| of every engine step, on the card (no sync)
    real = transformer.logits_fn
    top = torch.zeros((), device="cuda")

    def watched(params, c, hidden):
        nonlocal top
        out = real(params, c, hidden)
        top = torch.maximum(top, out.abs().amax())
        return out

    transformer.logits_fn = watched
    try:
        k1.afpm_matmul.launches = 0
        t0 = time.perf_counter()
        stats = eng.run()
        serve_s = time.perf_counter() - t0
        launches = k1.afpm_matmul.launches
    finally:
        transformer.logits_fn = real
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    top = top.item()

    bad = [r.id for r in reqs if not r.done or len(r.result()) != 16]
    if bad:
        raise AssertionError(f"requests did not finish with 16 tokens: {bad}")
    forwards = sum(st.n_prefill_chunks + st.n_decode_steps
                   for st in stats.values())
    fails = []
    if launches != per_forward * forwards:
        fails.append(f"afpm_matmul launched {launches} times, expected "
                     f"{per_forward} x {forwards} forwards")
    if not 0.0 < top <= cfg.logit_softcap:
        raise AssertionError(f"gemma2 engine logits reach {top}, outside "
                             f"the softcap {cfg.logit_softcap}")

    del eng
    torch.cuda.empty_cache()
    longest = next(r for r in reqs if len(r.prompt) == SERVE_LENGTHS[2])
    peak = {}
    for t in DEFAULT_TIERS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sess.replace(policy=t.policy).generate(prompts=longest.prompt[None],
                                               gen_len=16)
        peak[t.name] = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    fails += solo_mismatches("gemma2-9b", sess, reqs)
    del sess
    torch.cuda.empty_cache()

    tiers, parts = {}, []
    for t in DEFAULT_TIERS:
        st = stats[t.name]
        dec_tokens = st.n_tokens - st.n_finished
        tiers[t.name] = dict(
            policy=t.policy, decode_tok_s=dec_tokens / st.decode_s,
            decode_ms_step=1e3 * st.decode_s / st.n_decode_steps,
            decode_steps=st.n_decode_steps,
            prefill_ms_chunk=1e3 * st.prefill_s / st.n_prefill_chunks,
            prefill_chunks=st.n_prefill_chunks, solo_peak_gb=peak[t.name])
        v = tiers[t.name]
        parts.append(f"{t.name}({t.policy}) decode {v['decode_tok_s']:.1f} "
                     f"tok/s {v['decode_ms_step']:.2f} ms/step prefill "
                     f"{v['prefill_ms_chunk']:.2f} ms/chunk, a solo generate"
                     f" of {SERVE_LENGTHS[2]} + 16 tokens peaks at "
                     f"{v['solo_peak_gb']:.2f} GB")
    print(f"[gemma2] gemma2-9b full width ({n_params / 1e9:.3f} B params, "
          f"{params_gb:.2f} GB on the card, init {init_s:.1f} s): 6 requests "
          f"x 16 tokens in {serve_s:.2f} s; {'; '.join(parts)}; engine peak "
          f"{serve_peak_gb:.2f} GB; afpm_matmul launches {launches} = "
          f"{per_forward} x {forwards} forwards; every tier's tokens == its "
          f"solo generate; largest |logit| {top:.4f} (softcap "
          f"{cfg.logit_softcap})")
    out = dict(k1=launches, forwards=forwards, params=n_params,
               params_gb=params_gb, init_s=init_s, serve_s=serve_s,
               serve_peak_gb=serve_peak_gb, top_logit=top, tiers=tiers)
    (ROOT / "chiprun_out" / "chip_smoke_gemma2.json").write_text(json.dumps(
        dict(out, card=smi("name,power.limit")), indent=1))
    if fails:
        raise AssertionError("[gemma2]: " + "; ".join(fails))
    return out


def phase_dense_zoo():
    """Full-width gemma3-12b (a 1200-token prompt past its 1024 window,
    batch 1) and minitron-8b (batch 4, 40-token prompts) through a solo
    ``Session.generate`` of 16 tokens under standard, one after the
    other; K1 launches a forward, the kernel route's prefill logits
    against the plain route's."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS
    from repro_torch.session import Session

    out, parts, fails = {}, [], []
    for arch, batch, plen in (("gemma3-12b", 1, 1200), ("minitron-8b", 4, 40)):
        cfg = get_arch(arch)
        assert zoo_shapes_of(cfg) == ZOO_LAYERS[arch]
        per_forward = 7 * cfg.n_layers + 1   # and the LM head
        local = sum(r * sum(s.attn == "local" and s.window < plen
                            for s in p) for r, p in cfg.segments)
        assert (per_forward, local) == {"gemma3-12b": (337, 40),
                                        "minitron-8b": (225, 0)}[arch]
        n_params = sum(int(np.prod(shape)) for shape, _ in
                       transformer.param_shapes(cfg).values())
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        sess = Session(cfg, policy="segmented3", seed=0)
        sess.params  # seeded random init on the card
        torch.cuda.synchronize()
        params_gb = torch.cuda.memory_allocated() / 1e9 - held_gb
        prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                    (batch, plen))
        k1.afpm_matmul.launches = 0
        res = sess.generate(prompts=prompts, gen_len=16)
        launches = k1.afpm_matmul.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
        if res.tokens.shape != (batch, 16):
            raise AssertionError(f"{arch}: generate gave tokens of shape "
                                 f"{res.tokens.shape}")
        if launches != per_forward * 16:
            fails.append(f"{arch}: afpm_matmul launched {launches} times in "
                         f"a generate of 16 tokens, expected {per_forward} "
                         f"x 16")
        engine = {}
        if arch == "gemma3-12b":
            # the engine under a window that masks: the 1200-token prompt
            # under each tier, prefilled in chunks of 256 over the paged
            # cache (40 of 48 layers attend only their last 1024
            # positions), then 15 decode steps over the 4-slot pools; the
            # tokens equal the tier's solo generate
            eng = sess.serving_engine(slots=4, max_len=plen + 16,
                                      prefill_chunk=256)
            reqs = [eng.submit(prompts[0], tier=t.name, max_new_tokens=16)
                    for t in DEFAULT_TIERS]
            b1 = k1.afpm_matmul.launches
            t0 = time.perf_counter()
            stats = eng.run()
            serve_s = time.perf_counter() - t0
            del eng
            torch.cuda.empty_cache()
            st = stats["standard"]
            forwards = sum(v.n_prefill_chunks + v.n_decode_steps
                           for v in stats.values())
            engine = dict(serve_s=serve_s, k1=k1.afpm_matmul.launches - b1,
                          prefill_chunks=st.n_prefill_chunks,
                          decode_steps=st.n_decode_steps,
                          decode_ms_step={n: 1e3 * v.decode_s
                                          / v.n_decode_steps
                                          for n, v in stats.items()})
            if not all(r.done for r in reqs):
                raise AssertionError(f"{arch} engine: a request did not "
                                     f"finish")
            fails += solo_mismatches(f"{arch} under the masking window",
                                     sess, reqs)
            if engine["k1"] != per_forward * forwards:
                fails.append(f"{arch} engine: afpm_matmul launched "
                             f"{engine['k1']} times, expected {per_forward} "
                             f"x {forwards} forwards")
        err, k_ms, p_ms = prompt_logits(
            sess, arch, torch.as_tensor(prompts, device="cuda"), per_forward,
            fails)
        del sess
        torch.cuda.empty_cache()
        out[arch] = dict(params=n_params, params_gb=params_gb,
                         generate_s=res.seconds, tok_s=res.tokens_per_s,
                         peak_gb=peak_gb, k1=launches,
                         prefill_ms=k_ms, plain_prefill_ms=p_ms,
                         logits_rel_err=err, local_layers_masking=local,
                         engine=engine)
        if engine:
            parts.append(
                f"{arch} through the engine under the three tiers (4 slots, "
                f"chunks of 256, max_len {plen + 16}): "
                f"{engine['prefill_chunks']} chunks + "
                f"{engine['decode_steps']} decode steps a tier in "
                f"{engine['serve_s']:.2f} s (ms/step " + ", ".join(
                    f"{n} {v:.1f}" for n, v in
                    engine["decode_ms_step"].items())
                + f"), afpm_matmul {engine['k1']}, every tier's tokens == "
                f"its solo generate under the masking window")
        parts.append(
            f"{arch} ({n_params / 1e9:.3f} B params, {params_gb:.2f} GB) "
            f"batch {batch} x {plen}-token prompts: generate of 16 tokens "
            f"{res.seconds:.2f} s ({res.tokens_per_s:.1f} tok/s), peak "
            f"{peak_gb:.2f} GB, afpm_matmul {launches} = {per_forward} x 16 "
            f"forwards; prefill {k_ms:.1f} ms (plain route "
            f"{p_ms:.1f} ms), kernel vs plain logits {err:.3g} of the "
            f"largest (bound {LOGIT_BOUND:.3g}); {local} local layers mask")
    print(f"[dense-zoo] full width: {'; '.join(parts)}")
    if fails:
        raise AssertionError("[dense-zoo]: " + "; ".join(fails))
    out["k1"] = sum(v["k1"] for v in out.values())
    out["engine_k1"] = out["gemma3-12b"]["engine"]["k1"]
    return out


def giant_shapes_of(cfg):
    """(K, N) of every projection's K1 call of one forward, in call order,
    from the model's own parameter shapes (an MoE layer's experts each
    once a projection, an SSD block's in_proj and out_proj)."""
    from repro_torch.models import transformer

    shapes = transformer.param_shapes(cfg)
    out = []
    for si, (repeats, pattern) in enumerate(cfg.segments):
        for _ in range(repeats):
            for pi, spec in enumerate(pattern):
                pre = f"seg{si}_p{pi}"
                if spec.kind == "ssm":
                    out += [tuple(shapes[f"{pre}.ssm.{n}"][0][-2:])
                            for n in ("in_proj", "out_proj")]
                    continue
                sites = (("wq_a", "wq_b", "wkv_a", "wo") if spec.attn == "mla"
                         else ("wq", "wk", "wv", "wo"))
                out += [tuple(shapes[f"{pre}.attn.{n}"][0][-2:]) for n in sites]
                if spec.kind == "moe":
                    for _ in range(cfg.moe.n_experts):
                        out += [tuple(shapes[f"{pre}.mlp.{n}"][0][-2:])
                                for n in ("wi", "wg", "wo")]
                    pre += ".mlp.shared"
                else:
                    pre += ".mlp"
                out += [tuple(shapes[f"{pre}.{n}"][0][-2:])
                        for n in ("wi", "wg", "wo")]
    return out


def serve_cut(tag: str, cfg, projections: int, prefill_chunk=None):
    """``cfg`` (full width, cut depth) seeded on the card and served by the
    engine as [serve] serves qwen3-4b: 4 slots, ``max_len`` 256, six
    requests of 40 / 77 / 150 tokens and 16 new tokens under the three
    tiers.  Every request completes; K1 runs a forward ``projections``
    times and once for the LM head, under every tier; and every tier's
    tokens equal its solo ``Session.generate``'s bit for bit.  Returns
    (session, numbers); the failed gates are the numbers' ``fails``, for
    the caller to raise once it has printed its readings."""
    import numpy as np
    import torch

    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.models import transformer
    from repro_torch.serving import DEFAULT_TIERS
    from repro_torch.session import Session

    if len(giant_shapes_of(cfg)) != projections:
        raise AssertionError(f"{tag}: {len(giant_shapes_of(cfg))} K1 calls a "
                             f"forward by the parameter shapes, expected "
                             f"{projections}")
    per_forward = projections + 1
    n_params = sum(int(np.prod(shape)) for shape, _ in
                   transformer.param_shapes(cfg).values())
    held_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = Session(cfg, seed=0)
    sess.params  # seeded random init on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gb = torch.cuda.memory_allocated() / 1e9 - held_gb
    eng = sess.serving_engine(slots=4, max_len=256,
                              prefill_chunk=prefill_chunk)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(6):
        tier = DEFAULT_TIERS[i % 3].name
        plen = SERVE_LENGTHS[(i + i // 3) % 3]
        reqs.append(eng.submit(rng.integers(0, cfg.vocab, plen), tier=tier,
                               max_new_tokens=16))
    k1.afpm_matmul.launches = 0
    t0 = time.perf_counter()
    stats = eng.run()
    serve_s = time.perf_counter() - t0
    launches = k1.afpm_matmul.launches
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    bad = [r.id for r in reqs if not r.done or len(r.result()) != 16]
    if bad:
        raise AssertionError(f"{tag}: requests did not finish with 16 "
                             f"tokens: {bad}")
    forwards = sum(st.n_prefill_chunks + st.n_decode_steps
                   for st in stats.values())
    fails = []
    if launches != per_forward * forwards:
        fails.append(f"{tag}: afpm_matmul launched {launches} times, "
                     f"expected {per_forward} x {forwards} forwards")
    del eng
    torch.cuda.empty_cache()
    fails += solo_mismatches(tag, sess, reqs)
    tiers = {}
    for t in DEFAULT_TIERS:
        st = stats[t.name]
        tiers[t.name] = dict(
            policy=t.policy,
            decode_tok_s=(st.n_tokens - st.n_finished) / st.decode_s,
            decode_ms_step=1e3 * st.decode_s / st.n_decode_steps,
            decode_steps=st.n_decode_steps,
            prefill_ms_chunk=1e3 * st.prefill_s / st.n_prefill_chunks,
            prefill_chunks=st.n_prefill_chunks)
    return sess, dict(k1=launches, forwards=forwards, params=n_params,
                      params_gb=params_gb, init_s=init_s, serve_s=serve_s,
                      serve_peak_gb=serve_peak_gb, tiers=tiers,
                      per_forward=per_forward, fails=fails)


def tier_text(tiers: dict) -> str:
    return "; ".join(
        f"{name}({v['policy']}) decode {v['decode_ms_step']:.2f} ms/step "
        f"({v['decode_tok_s']:.1f} tok/s), prefill {v['prefill_ms_chunk']:.2f}"
        f" ms/chunk" for name, v in tiers.items())


def prompt_logits(sess, tag: str, tokens, per_forward: int, fails: list):
    """One full-prompt prefill through the kernels and through the plain
    route (the standard tier): K1 launches per_forward times (the LM head
    included) and never, and the kernel route's logits within LOGIT_BOUND
    of the plain route's largest; a gate that fails adds a line to
    ``fails``.  Returns (relative error, kernel ms, plain ms)."""
    import torch

    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.models import transformer

    logits, ms = {}, {}
    with torch.inference_mode():
        for backend in ("auto", "torch"):
            s = sess.replace(policy="segmented3", backend=backend)
            b1 = k1.afpm_matmul.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[backend], _ = transformer.prefill(s.params, s.config,
                                                     {"tokens": tokens})
            torch.cuda.synchronize()
            ms[backend] = 1e3 * (time.perf_counter() - t0)
            ran = k1.afpm_matmul.launches - b1
            if ran != (per_forward if backend == "auto" else 0):
                fails.append(f"{tag} {backend}: afpm_matmul ran {ran} times "
                             f"in a prefill")
    lg = logits["auto"]
    if lg.shape != (tokens.shape[0], 1, sess.config.vocab) \
            or not torch.isfinite(lg).all():
        raise AssertionError(f"{tag}: bad prefill logits {tuple(lg.shape)}")
    err = rel_err(lg, logits["torch"])
    if err > LOGIT_BOUND:
        fails.append(f"{tag}: kernel-route prefill logits {err:.3g} of the "
                     f"largest from the plain route's > {LOGIT_BOUND:.3g}")
    return err, ms["auto"], ms["torch"]


def phase_qwen2_vl():
    """Full-width qwen2-vl-72b cut to 8 layers, served as [serve] serves
    qwen3-4b; then the model API on its vision-stub input: a prefill of
    seeded patch embeddings (1, 256, d) at an image's 3-D positions and 8
    greedy decode steps, the kernel route against the plain route."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.models import transformer

    full = get_arch("qwen2-vl-72b")
    assert (full.n_layers, full.d_model, full.vocab, full.mrope_sections) \
        == (80, 8192, 152064, (16, 24, 24))
    cfg = dataclasses.replace(full, segments=((QWEN2VL_LAYERS,
                                               full.segments[0][1]),))
    assert giant_shapes_of(cfg) == QWEN2VL_STEP
    sess, out = serve_cut("qwen2-vl", cfg, len(QWEN2VL_STEP))

    # the model API on the vision stub: patch embeddings of a 16 x 16
    # image at t = 0, h = i // 16, w = i % 16; decode steps then take the
    # absolute position in all three streams
    gen = torch.Generator(device="cuda").manual_seed(1)
    S, n = 256, 8
    embeds = torch.randn((1, S, cfg.d_model), generator=gen, device="cuda")
    i = torch.arange(S, device="cuda")
    positions = torch.stack([torch.zeros_like(i), i // 16, i % 16], -1)[None]
    steps, toks, ms, errs = {}, None, {}, []
    with torch.inference_mode():
        for backend in ("auto", "torch"):
            s = sess.replace(policy="segmented3", backend=backend)
            b1 = k1.afpm_matmul.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, state = transformer.prefill(
                s.params, s.config, {"embeds": embeds, "positions": positions},
                max_len=S + n)
            torch.cuda.synchronize()
            ms[backend] = 1e3 * (time.perf_counter() - t0)
            # both routes take the kernel route's greedy tokens
            seq, fed = [lg], []
            for j in range(n):
                tok = lg[:, -1:].argmax(-1) if toks is None else toks[j]
                fed.append(tok)
                lg, state = transformer.decode_step(s.params, s.config,
                                                    {"token": tok}, state,
                                                    S + j)
                seq.append(lg)
            toks, steps[backend] = fed, seq
            ran = k1.afpm_matmul.launches - b1
            want = (n + 1) * out["per_forward"] if backend == "auto" else 0
            if ran != want:
                out["fails"].append(f"qwen2-vl {backend}: afpm_matmul ran "
                                    f"{ran} times in a prefill and {n} "
                                    f"steps, expected {want}")
            del state
    for j, (a, b) in enumerate(zip(steps["auto"], steps["torch"])):
        if a.shape != (1, 1, cfg.vocab) or not torch.isfinite(a).all():
            raise AssertionError(f"qwen2-vl step {j}: bad logits "
                                 f"{tuple(a.shape)}")
        errs.append(rel_err(a, b))
    if max(errs) > LOGIT_BOUND:
        raise AssertionError(f"qwen2-vl: kernel-route logits {max(errs):.3g} "
                             f"of the largest from the plain route's > "
                             f"{LOGIT_BOUND:.3g} (prefill, then per step: "
                             f"{[f'{e:.2g}' for e in errs]})")
    del sess, s, steps, embeds
    torch.cuda.empty_cache()
    out.update(vision_prefill_ms=ms["auto"], vision_plain_prefill_ms=ms["torch"],
               vision_logits_rel_err=max(errs))
    print(f"[qwen2-vl] qwen2-vl-72b full width, {QWEN2VL_LAYERS} of "
          f"{full.n_layers} layers ({out['params'] / 1e9:.3f} B params, "
          f"{out['params_gb']:.2f} GB on the card, init {out['init_s']:.1f} s):"
          f" 6 requests x 16 tokens in {out['serve_s']:.2f} s; "
          f"{tier_text(out['tiers'])}; engine peak {out['serve_peak_gb']:.2f} "
          f"GB; afpm_matmul launches {out['k1']} = {out['per_forward']} x "
          f"{out['forwards']} forwards; every tier's tokens == its solo "
          f"generate; vision stub (1 x {S} patch embeddings at 3-D positions)"
          f" prefill {ms['auto']:.1f} ms (plain route {ms['torch']:.1f} ms) "
          f"and {n} decode steps: kernel vs plain logits {max(errs):.3g} of "
          f"the largest (bound {LOGIT_BOUND:.3g})")
    if out["fails"]:
        raise AssertionError("[qwen2-vl]: " + "; ".join(out["fails"]))
    return out


def phase_llama4():
    """Full-width llama4-maverick (an expert at full width) cut to one
    (moe, dense) repeat and 64 of its 128 experts, served as [serve]
    serves qwen3-4b with whole-prompt chunks (capacity depends on a
    routing group's length); a full-prompt prefill's kernel route against
    its plain route."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch

    full = get_arch("llama4-maverick-400b-a17b")
    assert (full.n_layers, full.d_model, full.d_ff, full.dense_ff,
            full.vocab, full.moe.n_experts, full.moe.top_k,
            full.moe.n_shared) == (48, 5120, 8192, 16384, 202048, 128, 1, 1)
    cfg = dataclasses.replace(
        full, segments=((1, full.segments[0][1]),),
        moe=dataclasses.replace(full.moe, n_experts=LLAMA4_EXPERTS))
    assert giant_shapes_of(cfg) == LLAMA4_STEP
    sess, out = serve_cut("llama4", cfg, len(LLAMA4_STEP),
                          prefill_chunk=max(SERVE_LENGTHS) + 10)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab,
                                               (1, max(SERVE_LENGTHS)))
    err, k_ms, p_ms = prompt_logits(sess, "llama4", torch.as_tensor(
        prompt, device="cuda"), out["per_forward"], out["fails"])
    del sess
    torch.cuda.empty_cache()
    out.update(logits_rel_err=err, prefill_ms=k_ms, plain_prefill_ms=p_ms)
    print(f"[llama4] llama4-maverick-400b-a17b full width, 1 of 24 (moe, "
          f"dense) repeats, {LLAMA4_EXPERTS} of 128 experts "
          f"({out['params'] / 1e9:.3f} B params, {out['params_gb']:.2f} GB on "
          f"the card, init {out['init_s']:.1f} s): 6 requests x 16 tokens in "
          f"{out['serve_s']:.2f} s, prefill chunks of "
          f"{max(SERVE_LENGTHS) + 10}; {tier_text(out['tiers'])}; engine peak "
          f"{out['serve_peak_gb']:.2f} GB; afpm_matmul launches {out['k1']} = "
          f"{out['per_forward']} x {out['forwards']} forwards; every "
          f"tier's tokens == its solo generate; a {max(SERVE_LENGTHS)}-token "
          f"prefill {k_ms:.1f} ms (plain route {p_ms:.1f} ms), kernel vs "
          f"plain logits {err:.3g} of the largest (bound {LOGIT_BOUND:.3g})")
    if out["fails"]:
        raise AssertionError("[llama4]: " + "; ".join(out["fails"]))
    return out


def phase_deepseek(peaks):
    """Full-width deepseek-v3 (MLA, all 256 experts) cut to one dense-MLA
    and one MoE-MLA layer, served as [llama4] is, its latent caches
    paged; a decode step's ms per tier beside the byte bound of its 768
    expert projections; a full-prompt prefill's kernel route against its
    plain route."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    full = get_arch("deepseek-v3-671b")
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff,
            full.dense_ff, full.vocab, full.moe.n_experts, full.moe.top_k,
            full.mla.kv_lora_rank, full.mla.q_lora_rank) \
        == (61, 7168, 128, 2048, 18432, 129280, 256, 8, 512, 1536)
    cfg = dataclasses.replace(full, segments=tuple(
        (1, pattern) for _, pattern in full.segments))
    assert giant_shapes_of(cfg) == DSV3_STEP
    sess, out = serve_cut("deepseek", cfg, len(DSV3_STEP),
                          prefill_chunk=max(SERVE_LENGTHS) + 10)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab,
                                               (1, max(SERVE_LENGTHS)))
    err, k_ms, p_ms = prompt_logits(sess, "deepseek", torch.as_tensor(
        prompt, device="cuda"), out["per_forward"], out["fails"])
    K, N = DSV3_EXPERT[0]
    experts_gb = 3 * 256 * K * N * 4 / 1e9
    bound_ms = sum(K_ * N_ * 4 + EXPERT_M * K_ * 2 + EXPERT_M * N_ * 4
                   for K_, N_ in DSV3_EXPERT * 256) / peaks[0] * 1e3
    # a decode row among 4 against it alone under each tier (MLA's
    # absorbed form, the MoE layer), and the router's rows at M = 1 / 4 /
    # 32 against M = 150 under the serving sums
    decode_row, bad = decode_row_probe("deepseek-v3", sess)
    out["fails"] += bad
    moe_layer = next(p["mlp"] for n, p in sess.params.items()
                     if n.startswith("seg") and "router" in p["mlp"])
    router = moe_layer["router"][0]
    xr = torch.randn((1, PROBE_M[-1], cfg.d_model), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(6)
                     ).to(torch.bfloat16)
    router_gap, bad = site_probe("deepseek-v3", {
        "router": lambda m: moe._route(xr[:, :m], router, cfg,
                                       moe.capacity(cfg, m))[0][0]})
    out["fails"] += bad
    out.update(logits_rel_err=err, prefill_ms=k_ms, plain_prefill_ms=p_ms,
               experts_bound_ms=bound_ms, experts_gb=experts_gb,
               decode_row=decode_row, router=router_gap["router"])
    print(f"[deepseek] deepseek-v3-671b full width, 1 dense-MLA + 1 MoE-MLA "
          f"of 3 + 58 layers, all 256 experts ({out['params'] / 1e9:.3f} B "
          f"params, {out['params_gb']:.2f} GB on the card, init "
          f"{out['init_s']:.1f} s): 6 requests x 16 tokens in "
          f"{out['serve_s']:.2f} s, prefill chunks of "
          f"{max(SERVE_LENGTHS) + 10}, the latent ckv / kpe caches paged; "
          f"{tier_text(out['tiers'])}; a decode step's 768 expert projections "
          f"read {experts_gb:.2f} GB: byte bound {bound_ms:.2f} ms; engine "
          f"peak {out['serve_peak_gb']:.2f} GB; afpm_matmul launches "
          f"{out['k1']} = {out['per_forward']} x {out['forwards']} "
          f"forwards; every tier's tokens == its solo generate; a decode row "
          f"among 4 vs alone, ulp gap {decode_row}; the router's rows at M = "
          f"{'/'.join(map(str, PROBE_M[:-1]))} vs {PROBE_M[-1]}, ulp gap "
          f"{out['router']}; a {max(SERVE_LENGTHS)}-token prefill "
          f"{k_ms:.1f} ms (plain route {p_ms:.1f} ms), kernel vs plain "
          f"logits {err:.3g} of the largest (bound {LOGIT_BOUND:.3g})")
    if out["fails"]:
        raise AssertionError("[deepseek]: " + "; ".join(out["fails"]))
    return out, sess


def moe_layer_ms(layer, x, cfg, ncfg, f64: bool, repeats: int = 5):
    """(median host ms of a synced ``moe_apply``, its output, K1 launches
    of one call); ``f64``: under the serving path's sums (the router in
    fp64, ``layers.fp64_sums``)."""
    import torch

    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.models import layers, moe

    with torch.inference_mode(), layers.fp64_sums(f64):
        ms, out = host_ms(lambda: moe.moe_apply(layer, x, cfg, ncfg), repeats)
        before = k1.afpm_matmul.launches
        moe.moe_apply(layer, x, cfg, ncfg)
        torch.cuda.synchronize()
    return ms, out, k1.afpm_matmul.launches - before


def phase_dist(sess, peaks):
    """The code over ranks on a one-rank NCCL group: deepseek-v3's
    MoE-MLA layer (phase 16's weights, all 256 experts) through the
    expert-parallel path (``all_to_all`` dispatch, K1 on every local
    expert) in a 4-slot decode step (== group-local bit for bit, K1 within
    64 ulps of plain, the all-to-all bytes counted) and a 256-token
    prefill (against plain); ``pipeline_apply`` over a ``("pipe",)`` mesh
    of 1 with qwen3-4b blocks as its stage (== the blocks in sequence,
    bit for bit); ``hierarchical_grad_reduce(compress=True)`` over one
    qwen3-4b block's gradient-shaped tree."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.distributed.sharding import rules_for, use_mesh_rules
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import custom_ops
    from repro_torch.launch.mesh import init_ranks, make_test_mesh
    from repro_torch.launch.multipod import hierarchical_grad_reduce
    from repro_torch.models import layers, moe, transformer
    from repro_torch.numerics import (NumericsConfig, layer_scope,
                                      numerics_scope)
    from repro_torch import tree as tree_util

    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    cfg = sess.config
    E, D = cfg.moe.n_experts, cfg.d_model
    layer = transformer._take(sess.params["seg1_p0"], 0)["mlp"]
    seg3 = NumericsConfig(mode="segmented", seg_passes=3)
    plain = NumericsConfig(mode="segmented", seg_passes=3, backend="torch")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x_dec = torch.randn((DIST_SLOTS, 1, D), generator=gen, device="cuda")
    x_pre = torch.randn((1, DIST_PREFILL, D), generator=gen, device="cuda")
    per_call = 3 * E + 3           # every expert's projections, the shared
    out = {"card": card}
    init_ranks("cuda")
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
        local_ms, local, n = moe_layer_ms(layer, x_dec, cfg, seg3, True)
        if n != per_call:
            raise AssertionError(f"dist: group-local decode ran K1 {n} times,"
                                 f" expected {per_call}")
        with use_mesh_rules(mesh, rules_for(cfg, "serve")):
            with torch.inference_mode(), layers.fp64_sums(), \
                    collectives.count_collectives() as stats:
                b0 = k1.afpm_matmul.launches
                ep = moe.moe_apply(layer, x_dec, cfg, seg3)
                torch.cuda.synchronize()
                ep_launches = k1.afpm_matmul.launches - b0
            ep_ms, ep_again, _ = moe_layer_ms(layer, x_dec, cfg, seg3, True)
            _, ep_plain, _ = moe_layer_ms(layer, x_dec, cfg, plain, True, 1)
            pre_ms, pre, pre_launches = moe_layer_ms(layer, x_pre, cfg, seg3,
                                                     False, 3)
            pre_plain_ms, pre_plain, _ = moe_layer_ms(layer, x_pre, cfg,
                                                      plain, False, 1)
        # group-local once more, after EP (the first sample is the phase's
        # first call), and with every K1 call through its op, which an
        # unplaced call skips (the op's dispatch on the host, a layer's
        # 768 calls)
        local_again_ms, _, _ = moe_layer_ms(layer, x_dec, cfg, seg3, True)
        through = custom_ops._through_op
        custom_ops._through_op = lambda *ts: True
        try:
            local_op_ms, local_op, _ = moe_layer_ms(layer, x_dec, cfg, seg3,
                                                    True)
        finally:
            custom_ops._through_op = through
        if not torch.equal(local_op, local):
            raise AssertionError("dist: group-local through the op != "
                                 "through the wrapper")
        C = moe.capacity(cfg, DIST_SLOTS)
        a2a = 2 * E * C * D * x_dec.element_size()
        if ep_launches != per_call or pre_launches != per_call:
            raise AssertionError(f"dist: EP ran K1 {ep_launches} times a "
                                 f"decode step, {pre_launches} a prefill, "
                                 f"expected {per_call}")
        if stats.by_kind.get("all-to-all") != a2a:
            raise AssertionError(f"dist: all-to-all bytes {stats.by_kind} != "
                                 f"2 x E x C x D x 4 = {a2a}")
        if not (torch.equal(ep, local) and torch.equal(ep_again, local)):
            raise AssertionError(
                f"dist: EP decode != group-local: "
                f"{(ep - local).abs().max().item():.3g}")
        dec_ulps = max_ulps(ep, ep_plain)
        pre_ulps = max_ulps(pre, pre_plain)
        if max(dec_ulps, pre_ulps) > ULP_BOUND or not torch.isfinite(
                pre).all():
            raise AssertionError(f"dist: K1 vs plain {dec_ulps:.2f} ulps "
                                 f"(decode), {pre_ulps:.2f} (prefill) > "
                                 f"{ULP_BOUND}")
        bound_ms = sum(K_ * N_ * 4 + C * K_ * 4 + C * N_ * 4
                       for K_, N_ in DSV3_EXPERT * E) / peaks[0] * 1e3
        out.update(ep_decode_ms=ep_ms, local_decode_ms=local_ms,
                   local_again_decode_ms=local_again_ms,
                   local_op_decode_ms=local_op_ms,
                   ep_launches=ep_launches, a2a_bytes=a2a,
                   collective_by_kind=dict(stats.by_kind),
                   decode_ulps=dec_ulps, prefill_ms=pre_ms,
                   plain_prefill_ms=pre_plain_ms, prefill_ulps=pre_ulps,
                   experts_bound_ms=bound_ms)
        del local, local_op, ep, ep_again, ep_plain, pre, pre_plain

        # the pipeline: qwen3-4b blocks at full width as one stage
        qcfg = get_arch("qwen3-4b")
        (_, pattern), = qcfg.segments
        qcfg = dataclasses.replace(qcfg, segments=((PIPE_LAYERS, pattern),))
        blocks = transformer.init(qcfg, seed=0, device="cuda")["seg0_p0"]
        stacked = tree_util.map(lambda t: t[None], blocks)
        positions = transformer._positions_for(qcfg, {}, PIPE_MB, PIPE_SEQ, 0,
                                               "cuda")

        def stage(p, h):
            for r in range(PIPE_LAYERS):
                with layer_scope(f"blocks.{r}"):
                    h = transformer._train_block(transformer._take(p, r), h,
                                                 qcfg, pattern[0], positions)
            return h

        xs = torch.randn((PIPE_MICRO, PIPE_MB, PIPE_SEQ, qcfg.d_model),
                         generator=gen, device="cuda")
        pipe = make_test_mesh((1,), ("pipe",), device="cuda")
        with torch.inference_mode(), numerics_scope(seg3):
            b0 = k1.afpm_matmul.launches
            pipe_ms, got = host_ms(lambda: pipeline_apply(
                pipe, stage, stacked, xs), 3)
            pipe_launches = (k1.afpm_matmul.launches - b0) // 4
            seq_ms, want = host_ms(lambda: torch.stack(
                [stage(blocks, xs[m]) for m in range(PIPE_MICRO)]), 3)
        if not torch.equal(got, want):
            raise AssertionError(f"dist: pipeline != the blocks in sequence: "
                                 f"{(got - want).abs().max().item():.3g}")
        if pipe_launches != 7 * PIPE_LAYERS * PIPE_MICRO:
            raise AssertionError(f"dist: the pipeline ran K1 {pipe_launches} "
                                 f"times")
        del got, want, xs, stacked

        # the compressed hierarchical reduce of a block's gradients
        pod = make_test_mesh((1, 1), ("pod", "data"), device="cuda")
        grads = tree_util.map(lambda t: torch.randn(
            t.shape[1:], generator=gen, device="cuda") * 0.01, blocks)
        errs = tree_util.map(torch.zeros_like, grads)
        red_ms, (red, new_errs) = host_ms(lambda: hierarchical_grad_reduce(
            pod, grads, errs, compress=True), 3)
        for g, r, e in zip(tree_util.leaves(grads), tree_util.leaves(red),
                           tree_util.leaves(new_errs)):
            if (r - g).abs().max() > g.abs().max() / 100 or \
                    not torch.equal(e, g - r):
                raise AssertionError("dist: the compressed reduce is off its "
                                     "bound, or its error feedback is not "
                                     "the residual")
        n_grad = sum(g.numel() for g in tree_util.leaves(grads))
        del blocks, grads, errs, red, new_errs
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out.update(pipeline_ms=pipe_ms, sequential_ms=seq_ms,
               pipeline_launches=pipe_launches, reduce_ms=red_ms,
               reduce_elements=n_grad, phase_s=time.perf_counter() - t_phase)
    print(f"[dist] one-rank NCCL group, (1, 1) mesh, serve rules; deepseek-v3 "
          f"MoE layer at full width ({E} experts of {D} x "
          f"{cfg.d_ff}) expert-parallel: a {DIST_SLOTS}-slot decode step "
          f"(segmented3, C {C}) == group-local bit for bit, K1 {ep_launches} "
          f"launches a call, vs plain {dec_ulps:.2f} ulps; all-to-all "
          f"{a2a} bytes = 2 x E x C x D x 4 (counted {stats.by_kind}); EP "
          f"{ep_ms:.2f} ms beside group-local {local_ms:.2f} ms ("
          f"{local_again_ms:.2f} ms after EP, {local_op_ms:.2f} ms with "
          f"every K1 call through repro_torch::afpm_matmul; its "
          f"{3 * E} expert projections' byte bound {bound_ms:.2f} ms); a "
          f"{DIST_PREFILL}-token prefill {pre_ms:.2f} ms (plain route "
          f"{pre_plain_ms:.2f} ms), vs plain {pre_ulps:.2f} ulps (bound "
          f"{ULP_BOUND}); pipeline_apply over ('pipe',) of 1, qwen3-4b "
          f"{PIPE_LAYERS} blocks at full width, {PIPE_MICRO} microbatches of "
          f"{PIPE_MB} x {PIPE_SEQ}: {pipe_ms:.2f} ms (the blocks in sequence "
          f"{seq_ms:.2f} ms), == sequential bit for bit, K1 {pipe_launches} "
          f"launches; hierarchical_grad_reduce(compress=True) over a block's "
          f"{n_grad} gradient elements {red_ms:.2f} ms, within max|g|/100, "
          f"error feedback == residual; phase {out['phase_s']:.1f} s; {card}")
    return out


class OpCalls:
    """A dispatch mode counting the port's custom ops (``repro_torch::``):
    ``placed`` the calls DTensor dispatched (DTensor arguments), ``local``
    the calls that ran on a rank's blocks; DTensor-level ops pass on."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        self.placed = collections.Counter()
        self.local = collections.Counter()
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                placed = any(issubclass(t, DTensor) for t in types)
                if func.namespace == "repro_torch":
                    (outer.placed if placed else outer.local)[
                        func._opname] += 1
                if placed:
                    return NotImplemented
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


def placed_steps(params, cfg, tokens, steps_n, mesh=None, counter=None):
    """A prefill of ``tokens`` and ``steps_n`` greedy lockstep decode steps
    through ``launch.steps``: unplaced, or (``mesh``) placed by the serve
    rules.  Returns every step's logits (whole, on the card), the tokens
    and the host ms of the prefill and of each decode step."""
    import torch

    from repro_torch.distributed.sharding import (place, rules_for,
                                                  use_mesh_rules)
    from repro_torch.launch import specs, steps
    from repro_torch.models import transformer

    B, S = tokens.shape
    pre = steps.make_prefill_step(cfg, max_len=S + steps_n)
    dec = steps.make_decode_step(cfg)
    rules = rules_for(cfg, "serve")
    whole = (lambda t: t.full_tensor()) if mesh is not None else (
        lambda t: t)
    logits, toks, ms = [], [], []
    ctx = (use_mesh_rules(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx, torch.inference_mode():
        batch = {"tokens": tokens}
        if mesh is not None:
            params = place(params, transformer.unflatten(
                transformer.param_specs(cfg)), mesh, rules)
            batch = place(batch, specs.batch_axes_tree(batch), mesh, rules)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (counter.mode if counter else contextlib.nullcontext()):
            lg, state = pre(params, batch)
        full = whole(lg)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        for i in range(steps_n):
            logits.append(full)
            tok = full[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks.append(tok)
            if mesh is not None:
                tok = place(tok, specs.BATCH_AXES["token"], mesh, rules)
            t0 = time.perf_counter()
            lg, state = dec(params, state, tok, S + i)
            full = whole(lg)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(full)
    return logits, torch.cat(toks, dim=1) if toks else None, ms


def aten_ops(fn) -> int:
    """The ATen ops ``fn()`` runs (a dispatch mode's count)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return n[0]


def phase_placed():
    """Whole-model placement on a one-rank NCCL group: full-width qwen3-4b
    placed by the serve rules on a (1, 1) mesh (``sharding.place``, DTensor
    params and batch), a 40-token prefill and 8 greedy decode steps under
    each tier, equal to the same weights unplaced bit for bit (logits and
    tokens) with equal K1 launches, every K1 call dispatched by DTensor
    through ``repro_torch::afpm_matmul``; a full-width mamba2-130m prefill
    placed, through K3 (``repro_torch::ssd_scan``), bit for bit; the host
    ms of each beside the unplaced step."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_ranks, make_test_mesh
    from repro_torch.serving import DEFAULT_TIERS
    from repro_torch.session import Session

    t_phase = time.perf_counter()
    card = smi("name,power.limit")
    base = get_arch("qwen3-4b")
    assert (base.n_layers, base.d_model, base.vocab) == (36, 2560, 151936)
    sess = Session(base, seed=0)
    params = sess.params
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, base.vocab, (PLACED_BATCH,
                                                          PLACED_PROMPT)),
                             dtype=torch.int32, device="cuda")
    out = {"card": card, "tiers": {}}
    init_ranks("cuda")
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
        for tier in DEFAULT_TIERS:
            cfg = sess.replace(policy=tier.policy).config
            runs = {}
            for name, m in (("unplaced", None), ("placed", mesh),
                            ("unplaced", None), ("placed", mesh)):
                b0 = k1.afpm_matmul.launches
                got = placed_steps(params, cfg, tokens, PLACED_STEPS, m)
                runs.setdefault(name, []).append(
                    (got, k1.afpm_matmul.launches - b0))
            (ul, ut, _), un = runs["unplaced"][0]
            for (pl, pt, _), pn in runs["placed"]:
                if pn != un:
                    raise AssertionError(f"[placed] {tier.name}: K1 {pn} "
                                         f"launches placed, {un} unplaced")
                if not torch.equal(pt, ut):
                    raise AssertionError(f"[placed] {tier.name}: tokens "
                                         f"{pt.tolist()} != {ut.tolist()}")
                for i, (a, b) in enumerate(zip(pl, ul)):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"[placed] {tier.name}: step {i} logits differ "
                            f"by {(a - b).abs().max().item()}")
            # every tier: seven projections a layer and the LM head
            if un != (7 * base.n_layers + 1) * (PLACED_STEPS + 1):
                raise AssertionError(f"[placed] {tier.name}: K1 {un} "
                                     f"launches, expected (7 x 36 + 1) x 9")
            # the second run of each is the timed one (DTensor's sharding
            # cache and the allocator warm)
            ums, pms = runs["unplaced"][1][0][2], runs["placed"][1][0][2]
            out["tiers"][tier.name] = {
                "policy": tier.policy, "k1": un,
                "prefill_ms": [ums[0], pms[0]],
                "decode_ms": [float(np.median(ums[1:])),
                              float(np.median(pms[1:]))]}
        # every K1 call of a placed standard prefill went through its op
        counter = OpCalls()
        cfg = sess.replace(policy="segmented3").config
        b0 = k1.afpm_matmul.launches
        placed_steps(params, cfg, tokens, 0, mesh, counter)
        n = k1.afpm_matmul.launches - b0
        if not (counter.placed["afpm_matmul"] == counter.local["afpm_matmul"]
                == n == 7 * base.n_layers + 1):
            raise AssertionError(f"[placed] K1 {n} launches, op calls "
                                 f"{dict(counter.placed)} placed, "
                                 f"{dict(counter.local)} local")
        out["k1_op_calls"] = n
        # the op's dispatch on the host: K1 on plain tensors at a decode
        # projection's shape, through its wrapper (what an unplaced step
        # calls) and through repro_torch::afpm_matmul (what DTensor calls
        # on each block)
        from repro_torch.kernels import custom_ops

        gen = torch.Generator(device="cuda").manual_seed(13)
        xa = torch.randn((PLACED_BATCH, 1, base.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
        wa = 0.02 * torch.randn((base.d_model, base.d_model), generator=gen,
                                device="cuda")
        with torch.inference_mode():
            if not torch.equal(custom_ops.segmented_matmul(xa, wa, 3),
                               custom_ops.afpm_matmul_op(xa, wa, 3, None)):
                raise AssertionError("[placed] K1 through its op != K1 "
                                     "through its wrapper")
            out["k1_host_us"] = {
                "wrapper": host_us_per_call(
                    lambda: custom_ops.segmented_matmul(xa, wa, 3)),
                "op": host_us_per_call(
                    lambda: custom_ops.afpm_matmul_op(xa, wa, 3, None))}
        del xa, wa
        # DTensor's host cost an op: the ATen ops of a decode step
        with torch.inference_mode():
            pre = steps.make_prefill_step(cfg, max_len=PLACED_PROMPT + 1)
            _, st = pre(params, {"tokens": tokens})
            ops = aten_ops(lambda: steps.make_decode_step(cfg)(
                params, st, tokens[:, :1], PLACED_PROMPT))
        del st
        std = out["tiers"]["standard"]["decode_ms"]
        out["decode_ops"] = ops
        out["host_us_an_op"] = 1e3 * (std[1] - std[0]) / ops
        del params, sess
        torch.cuda.empty_cache()
        # mamba2-130m: a placed prefill through K3
        mcfg = Session("mamba2-130m", reduced=False,
                       policy="segmented3").config
        mparams = Session(mcfg, seed=0).params
        mtok = torch.as_tensor(rng.integers(0, mcfg.vocab, PLACED_MAMBA2),
                               dtype=torch.int32, device="cuda")
        got = {}
        for name, m in (("unplaced", None), ("placed", mesh),
                        ("unplaced", None), ("placed", mesh)):
            b0 = k3.ssd_scan.launches
            c = OpCalls() if m is not None else None
            lg, _, ms = placed_steps(mparams, mcfg, mtok, 0, m, c)
            got[name] = (lg[0], k3.ssd_scan.launches - b0, ms[0], c)
        (ul, un, ums, _), (pl, pn, pms, c) = got["unplaced"], got["placed"]
        if not (pn == un == mcfg.n_layers and c.placed["ssd_scan"]
                == c.local["ssd_scan"] == pn) or not torch.equal(pl, ul):
            raise AssertionError(f"[placed] mamba2: K3 {pn} / {un} launches, "
                                 f"op calls {dict(c.placed)}, logits equal "
                                 f"{torch.equal(pl, ul)}")
        out["mamba2"] = {"k3": pn, "prefill_ms": [ums, pms]}
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    tiers = "; ".join(
        f"{n}({t['policy']}) prefill {t['prefill_ms'][0]:.2f} / "
        f"{t['prefill_ms'][1]:.2f} ms, a decode step {t['decode_ms'][0]:.2f}"
        f" / {t['decode_ms'][1]:.2f} ms, K1 {t['k1']}"
        for n, t in out["tiers"].items())
    print(f"[placed] one-rank NCCL group, (1, 1) mesh, serve rules; qwen3-4b "
          f"full width, {PLACED_BATCH} x {PLACED_PROMPT} tokens + "
          f"{PLACED_STEPS} greedy steps, unplaced / placed: {tiers}; placed "
          f"== unplaced bit for bit (logits and tokens) under every tier, "
          f"equal K1 launches, a standard prefill's {out['k1_op_calls']} K1 "
          f"calls all dispatched by DTensor through repro_torch::afpm_matmul;"
          f" a decode step's {out['decode_ops']} ATen ops, DTensor "
          f"{out['host_us_an_op']:.1f} us an op; K1's host cost a call at "
          f"({PLACED_BATCH}, 1, {base.d_model}) @ ({base.d_model}, "
          f"{base.d_model}), plain tensors: "
          f"{out['k1_host_us']['wrapper']:.1f} us through its wrapper (an "
          f"unplaced step), {out['k1_host_us']['op']:.1f} us through "
          f"repro_torch::afpm_matmul; mamba2-130m full width "
          f"prefill of {PLACED_MAMBA2[0]} x {PLACED_MAMBA2[1]}: "
          f"{out['mamba2']['prefill_ms'][0]:.2f} / "
          f"{out['mamba2']['prefill_ms'][1]:.2f} ms, K3 "
          f"{out['mamba2']['k3']} launches through repro_torch::ssd_scan, "
          f"bit for bit; phase {out['phase_s']:.1f} s; {card}")
    return out


def train_batch(cfg, step: int, seq_len: int, batch: int):
    """A seeded batch of the training token stream on the card."""
    import torch

    from repro_torch.data.synthetic import DataConfig, lm_batch

    return {k: torch.from_numpy(v).to("cuda") for k, v in lm_batch(
        DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
                   seed=0), step).items()}


def _step_grads(params, cfg, batch):
    """(loss, gradients in leaf order, (K1, K3) launches) of one step."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    k1.afpm_matmul.launches = k3.ssd_scan.launches = 0
    loss, g = steps.grads_of(transformer.loss_fn, params, cfg, batch)
    torch.cuda.synchronize()
    out = (float(loss), [t.clone() for t in tree_util.leaves(g)],
           (k1.afpm_matmul.launches, k3.ssd_scan.launches))
    steps.clear_grads(params)
    return out


def _leaf_errs(names, got, want, tag: str = "train-grad"):
    """Each leaf's largest difference in units of ``want``'s largest;
    raises on a missing or non-finite gradient."""
    import torch

    errs = {}
    for name, a, b in zip(names, got, want):
        if a is None or not (torch.isfinite(a).all()
                             and torch.isfinite(b).all()):
            raise AssertionError(f"{tag}: {name} has no finite gradient")
        errs[name] = rel_err(a, b) if b.abs().max() > 0 \
            else a.abs().max().item()
    return errs


def phase_train_grad():
    """One full-width mamba2-130m training step's gradients through the
    kernels (K3 in every forward, K1 under both tiers: at one pass under
    exact) against the plain route's, on the same params and batch.

    Held leaf by leaf within 2**-6 under segmented3 with fp32
    activations.  With the config's bf16 activations the gradients of the
    early layers are chaotic at init: the residual stream carries the
    sqrt(d)-scaled embedding (about 28 an element, a bf16 ulp of 0.125),
    so an fp32 ulp anywhere upstream can move a rounding of it, and the
    gradients move with it.  So do they under exact, where every product
    rounds its operands to bf16, and K1 at one pass and the plain fp32
    SGEMM sum in other orders.  There the step is held to finite
    gradients, and the difference is printed beside the plain route's own
    spread when its K1 outputs are nudged by one ulp.  Under exact with
    fp32 activations two gates hold within 2**-6 instead: K3's gradient,
    with K1 on both routes and the scan alone kernel or plain; and K1 at
    one pass, forward and gradient, on the model cut to its first
    ``GRAD_CUT_LAYERS`` layers, where the step is not chaotic."""
    import dataclasses

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs import get_arch
    from repro_torch.kernels import autograd, ref
    from repro_torch.models import transformer
    from repro_torch.numerics import (NumericsConfig, NumericsPolicy,
                                      PolicyRule)

    cfg = get_arch("mamba2-130m")
    assert cfg.remat == "full" and cfg.n_layers == 24
    params = transformer.init(cfg, seed=0, device="cuda")
    batch = train_batch(cfg, 0, TRAIN_SEQ, TRAIN_BATCH)
    names = [n for n, _ in tree_util.named(params)]
    seg3 = dict(mode="segmented", seg_passes=3)
    # remat "full": every block's forward runs again in the backward, and
    # every loss chunk's head; the exact tier runs K1 at one pass
    chunks = (cfg.loss_batch_chunks
              if TRAIN_BATCH % cfg.loss_batch_chunks == 0 else 1)
    want = dict.fromkeys(("exact", "segmented3"),
                         (4 * cfg.n_layers + 2 * chunks, 2 * cfg.n_layers))
    worst, counts, losses = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        for mode, kw in (("exact", {}), ("segmented3", seg3)):
            if dtype == "bfloat16" and mode == "exact":
                continue
            run = {}
            for backend in ("hopper", "torch"):
                c = dataclasses.replace(cfg, dtype=dtype, numerics=(
                    NumericsConfig(backend=backend, **kw)))
                run[backend] = _step_grads(params, c, batch)
            key = f"{mode}/{dtype}"
            losses[key] = (run["hopper"][0], run["torch"][0])
            counts[key] = run["hopper"][2]
            if counts[key] != want[mode] or run["torch"][2] != (0, 0):
                raise AssertionError(
                    f"train-grad {key}: (K1, K3) launched {counts[key]} "
                    f"times a step (plain route {run['torch'][2]}), "
                    f"expected {want[mode]}")
            errs = _leaf_errs(names, run["hopper"][1], run["torch"][1])
            worst[key] = max(errs.items(), key=lambda kv: kv[1])
            chaotic = dtype == "bfloat16" or mode == "exact"
            if not chaotic and worst[key][1] > LOGIT_BOUND:
                raise AssertionError(
                    f"train-grad {key}: {worst[key][0]} kernel-route "
                    f"gradient {worst[key][1]:.3g} of the plain route's "
                    f"largest > {LOGIT_BOUND}")
            if (mode, dtype) == ("exact", "float32"):
                # K3's gradient held as before this tier ran K1: the same
                # products on both sides (K1 at one pass), the scan alone
                # through its kernel or its plain version
                alone = {}
                for b in ("hopper", "torch"):
                    pol = NumericsPolicy(
                        (PolicyRule("*.scan", NumericsConfig(backend=b)),),
                        default=NumericsConfig(backend="hopper"))
                    alone[b] = _step_grads(params, dataclasses.replace(
                        cfg, dtype=dtype, numerics=pol), batch)[1]
                errs = _leaf_errs(names, alone["hopper"], alone["torch"])
                worst["K3 alone/exact/float32"] = max(errs.items(),
                                                      key=lambda kv: kv[1])
                if worst["K3 alone/exact/float32"][1] > LOGIT_BOUND:
                    raise AssertionError(
                        f"train-grad exact/float32, K3 alone: "
                        f"{worst['K3 alone/exact/float32'][0]} kernel-route "
                        f"gradient {worst['K3 alone/exact/float32'][1]:.3g} "
                        f"of the plain route's largest > {LOGIT_BOUND}")
            if (mode, dtype) == ("segmented3", "float32"):
                # the plain route's K1 takes K1's own backward: hold the
                # kernel route against PyTorch's autograd of the plain
                # version as well, a reference independent of that code
                with unittest.mock.patch.object(
                        autograd.PlainSegmentedMatmul, "apply",
                        staticmethod(ref.afpm_matmul_ref)):
                    c = dataclasses.replace(cfg, dtype=dtype, numerics=(
                        NumericsConfig(backend="torch", **kw)))
                    auto = _step_grads(params, c, batch)[1]
                errs = _leaf_errs(names, run["hopper"][1], auto)
                worst["autograd/float32"] = max(errs.items(),
                                                key=lambda kv: kv[1])
                if worst["autograd/float32"][1] > LOGIT_BOUND:
                    raise AssertionError(
                        f"train-grad {key}: {worst['autograd/float32'][0]} "
                        f"kernel-route gradient "
                        f"{worst['autograd/float32'][1]:.3g} of autograd's "
                        f"of the plain version > {LOGIT_BOUND}")
            if chaotic:
                # the plain route against itself, its K1 outputs one ulp up
                real = ref.afpm_matmul_ref

                def nudged(x, w, passes=3, sums=torch.float32):
                    out = real(x, w, passes, sums)
                    up = torch.nextafter(out, torch.full_like(out, 1e38))
                    return out + (up - out).detach()    # the same gradient

                ref.afpm_matmul_ref = nudged
                try:
                    c = dataclasses.replace(cfg, dtype=dtype, numerics=(
                        NumericsConfig(backend="torch", **kw)))
                    spread = _leaf_errs(names, _step_grads(params, c,
                                                           batch)[1],
                                        run["torch"][1])
                finally:
                    ref.afpm_matmul_ref = real
                worst[f"plain one-ulp spread/{key}"] = max(
                    spread.items(), key=lambda kv: kv[1])
    # K1 at one pass (the exact tier), forward and gradient, where the
    # step is not chaotic: the first GRAD_CUT_LAYERS layers, K1 and K3 on
    # the kernel route, neither on the plain route
    cut = dataclasses.replace(cfg, dtype="float32", segments=(
        (GRAD_CUT_LAYERS, cfg.segments[0][1]),))
    cut_params = transformer.init(cut, seed=0, device="cuda")
    cut_names = [n for n, _ in tree_util.named(cut_params)]
    run = {b: _step_grads(cut_params, dataclasses.replace(
        cut, numerics=NumericsConfig(backend=b)), batch)
        for b in ("hopper", "torch")}
    key = f"exact/float32, {GRAD_CUT_LAYERS} layers"
    losses[key] = (run["hopper"][0], run["torch"][0])
    counts[key] = run["hopper"][2]
    want_cut = (4 * GRAD_CUT_LAYERS + 2 * chunks, 2 * GRAD_CUT_LAYERS)
    if counts[key] != want_cut or run["torch"][2] != (0, 0):
        raise AssertionError(
            f"train-grad {key}: (K1, K3) launched {counts[key]} times a "
            f"step (plain route {run['torch'][2]}), expected {want_cut}")
    worst[key] = max(_leaf_errs(cut_names, run["hopper"][1],
                                run["torch"][1]).items(),
                     key=lambda kv: kv[1])
    if worst[key][1] > LOGIT_BOUND:
        raise AssertionError(
            f"train-grad {key}: {worst[key][0]} kernel-route gradient "
            f"{worst[key][1]:.3g} of the plain route's largest > "
            f"{LOGIT_BOUND}")
    del cut_params, run
    print(f"[train-grad] mamba2-130m full width, one training step of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens (remat full), kernel route "
          f"against plain route on the same params and batch: every one of "
          f"{len(names)} leaves has a finite gradient; "
          + "; ".join(f"{k}: loss {losses[k][0]:.6f} (plain {losses[k][1]:.6f}"
                      f"), K1 {counts[k][0]} and K3 {counts[k][1]} launches "
                      f"a step, worst leaf {worst[k][0]} {worst[k][1]:.3g} of "
                      f"the plain route's largest" for k in losses)
          + f"; segmented3/float32 against PyTorch's autograd of the "
          f"plain version: worst leaf {worst['autograd/float32'][0]} "
          f"{worst['autograd/float32'][1]:.3g}; exact/float32 with K1 on "
          f"both routes, the scan alone kernel or plain: worst leaf "
          f"{worst['K3 alone/exact/float32'][0]} "
          f"{worst['K3 alone/exact/float32'][1]:.3g}"
          + f" (bound {LOGIT_BOUND:.3g}, held at segmented3/float32, for "
          f"K3 alone and at {GRAD_CUT_LAYERS} layers under exact; not held "
          f"at 24 layers where every product operand is rounded to bf16, "
          f"exact and bf16 activations, where the plain route's own "
          f"gradients move by "
          + ", ".join(f"{v[1]:.3g} ({k.split('/', 1)[1]}, worst leaf "
                      f"{v[0]})" for k, v in worst.items()
                      if k.startswith("plain one-ulp"))
          + " when its K1 outputs move by one fp32 ulp)")
    del params
    return dict(k1=counts["segmented3/bfloat16"][0],
                k3=counts["segmented3/bfloat16"][1],
                worst={k: list(v) for k, v in worst.items()},
                losses=losses)


class _Watched:
    """The trainer's straggler watchdog, kept so that the phase can read
    the per-step times the trainer records (host clock around a step that
    ends with its loss copied to the host), and call ``on_step`` after
    each step."""
    last = None
    on_step = None

    @classmethod
    def install(cls, module):
        base = module.StepWatchdog

        class Watchdog(base):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                cls.last = self

            def record(self, worker, duration_s):
                super().record(worker, duration_s)
                if cls.on_step is not None:
                    cls.on_step()

        module.StepWatchdog = Watchdog
        return base


def _profile_last_step(n_steps: int):
    """A profiler that records the last of ``n_steps`` trainer steps, and
    the ``on_step`` hook that starts and stops it (called after each
    step's record)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    done = [0]

    def on_step():
        done[0] += 1
        if done[0] == n_steps - 1:
            prof.start()
        elif done[0] == n_steps:
            prof.stop()

    return prof, on_step


def _device_groups(prof, wall_ms: float) -> dict:
    """Device ms by kernel group of a finished profile of a language
    model's step (no convs), and the busy share of ``wall_ms``."""
    import torch

    groups, n = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = kernel_group(e.name, convs=False)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
            n += 1
    busy = sum(groups.values())
    return dict(step_ms=wall_ms, device_ms=busy, busy_share=busy / wall_ms,
                kernels=n, groups=dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])))


def _profile_text(pr: dict) -> str:
    return (f"{pr['step_ms']:.1f} ms, device {pr['device_ms']:.1f} ms "
            f"({100 * pr['busy_share']:.0f}% busy, {pr['kernels']} kernels: "
            + ", ".join(f"{g} {v:.1f}" for g, v in pr["groups"].items())
            + ")")


def phase_train_qwen3():
    """Four full-width qwen3-4b training steps through the trainer's own
    function: AdamW with fp32 moments, remat full, 8 loss chunks; the last
    step under torch.profiler."""
    import math
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_mod

    cfg = get_arch("qwen3-4b")
    assert (cfg.remat, cfg.loss_batch_chunks, cfg.moment_dtype) == \
        ("full", 8, "float32")
    n_steps = 4
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = _Watched.install(train_mod)
    prof, _Watched.on_step = _profile_last_step(n_steps)
    try:
        t0 = time.perf_counter()
        params, opt, losses = train_mod.train(
            "qwen3-4b", reduced=False, steps=n_steps, seq_len=TRAIN_SEQ,
            batch=TRAIN_BATCH, device="cuda", log_every=1)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    finally:
        train_mod.StepWatchdog, _Watched.on_step = base, None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = list(_Watched.last.durations[0])
    ms = 1e3 * statistics.median(step_s[1:n_steps - 1])
    # the untrained model's loss: the tied, unit-variance embedding enters
    # at sqrt(d) scale and dominates the final norm, so the logit of the
    # input token itself is about |e|^2 / sqrt(d) = sqrt(d) and the others
    # are of unit scale; the Markov stream's next token is another, so the
    # first loss is about sqrt(d) (50.6 here), not ln(vocab)
    ln_v, want0 = math.log(cfg.vocab), cfg.d_model ** 0.5
    if not all(math.isfinite(l) for l in losses) or \
            abs(losses[0] - want0) > 1.0:
        raise AssertionError(f"train-qwen3 losses {losses}: not finite or "
                             f"step 0 not within 1.0 of sqrt(d_model) "
                             f"{want0:.2f}")
    # params changed: the norms' scales start at zero, and the embedding
    # is the seeded generator's first draw
    gen = torch.Generator(device="cuda").manual_seed(0)
    embed0 = torch.randn(params["embed"].shape, generator=gen, device="cuda")
    moved = (params["embed"] - embed0).abs().max().item()
    del embed0
    if moved == 0 or not params["final_norm"]["scale"].abs().max() > 0:
        raise AssertionError("train-qwen3: parameters did not change")
    profile_out = _device_groups(prof, 1e3 * step_s[-1])
    # the tensors a step takes: params, the optimizer state (moments and
    # its step counter) and the batch the trainer makes (int32 ids)
    from repro_torch import tree as tree_util
    from repro_torch.data.synthetic import DataConfig, lm_batch

    batch = lm_batch(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH, seed=0), 0)
    step_bytes = (sum(t.numel() * t.element_size()
                      for t in tree_util.leaves((params, opt)))
                  + sum(a.nbytes for a in batch.values()))
    print(f"[train-qwen3] qwen3-4b full width ({cfg.param_count() / 1e9:.2f} "
          f"B params), {n_steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"through launch.train.train (AdamW fp32 moments, remat full, "
          f"{cfg.loss_batch_chunks} loss chunks) in {total_s:.1f} s: losses "
          + ", ".join(f"{l:.4f}" for l in losses)
          + f" (step 0 expected near sqrt(d_model) {want0:.2f}; ln vocab "
          f"{ln_v:.2f}); {ms:.1f} ms a step (median of steps "
          f"1-{n_steps - 2}, host clock around a synced step), "
          f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GB; step {n_steps - 1} under torch.profiler "
          + _profile_text(profile_out))
    del params, opt
    torch.cuda.empty_cache()
    return dict(ms=ms, peak_gb=peak_gb, losses=losses, profile=profile_out,
                step_bytes=step_bytes)


def phase_train_mamba2():
    """Full-width mamba2-130m trained for 30 steps, the last under
    torch.profiler; then a checkpoint restart of the reduced qwen3-4b
    config, bit for bit."""
    import math
    import shutil
    import statistics

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import get_arch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.launch import train as train_mod

    cfg = get_arch("mamba2-130m")
    n_steps = 30
    base = _Watched.install(train_mod)
    prof, _Watched.on_step = _profile_last_step(n_steps)
    try:
        k1.afpm_matmul.launches = k3.ssd_scan.launches = 0
        _, _, losses = train_mod.train(
            "mamba2-130m", reduced=False, steps=n_steps, seq_len=TRAIN_SEQ,
            batch=TRAIN_BATCH, lr=3e-3, device="cuda", log_every=10)
        torch.cuda.synchronize()
        launches = (k1.afpm_matmul.launches, k3.ssd_scan.launches)
    finally:
        train_mod.StepWatchdog, _Watched.on_step = base, None
    # the watchdog keeps the last 16 steps; the profiled one is left out
    step_s = list(_Watched.last.durations[0])
    ms = 1e3 * statistics.median(step_s[:-1])
    profile_out = _device_groups(prof, 1e3 * step_s[-1])
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not all(math.isfinite(l) for l in losses) or not last < first:
        raise AssertionError(f"train-mamba2: losses {losses} not finite or "
                             f"not falling ({first:.4f} -> {last:.4f})")
    # exact: K1 at one pass, each block's forward and its recompute (remat
    # full), and each loss chunk's head twice
    chunks = (cfg.loss_batch_chunks
              if TRAIN_BATCH % cfg.loss_batch_chunks == 0 else 1)
    per_step = (4 * cfg.n_layers + 2 * chunks, 2 * cfg.n_layers)
    if launches != (per_step[0] * n_steps, per_step[1] * n_steps):
        raise AssertionError(f"train-mamba2: (K1, K3) launched {launches} "
                             f"times, expected {per_step} a step")

    # restart: 20 steps with a checkpoint every 10; a second run resumes
    # from the first's step-10 checkpoint alone and must end on the same
    # bits
    ck = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(steps=20, seq_len=32, batch=4, ckpt_every=10, device="cuda",
              log_every=100)
    p1, o1, l1 = train_mod.train("qwen3-4b", ckpt_dir=str(ck / "a"), **kw)
    (ck / "b").mkdir(parents=True)
    shutil.copytree(ck / "a" / "step_000000010", ck / "b" / "step_000000010")
    p2, o2, l2 = train_mod.train("qwen3-4b", ckpt_dir=str(ck / "b"), **kw)
    leaves1, leaves2 = tree_util.leaves((p1, o1)), tree_util.leaves((p2, o2))
    same = sum(bool(torch.equal(a, b)) for a, b in zip(leaves1, leaves2))
    if same != len(leaves1) or l2 != l1[10:] or \
            ckpt_io.all_steps(str(ck / "b")) != [10, 20]:
        raise AssertionError(f"restart: {same} of {len(leaves1)} leaves "
                             f"equal bit for bit; losses {l1[10:]} vs {l2}")
    shutil.rmtree(ck, ignore_errors=True)
    print(f"[train-mamba2] mamba2-130m full width, {n_steps} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, lr 3e-3: loss "
          + " ".join(f"{l:.3f}" for l in losses)
          + f"; first-5 mean {first:.4f} -> last-5 mean {last:.4f}; "
          f"{ms:.1f} ms a step (median of steps {n_steps - 16}-"
          f"{n_steps - 2}), {launches[1]} K3 launches "
          f"({2 * cfg.n_layers} a step: forward and remat recompute); "
          f"restart of reduced "
          f"qwen3-4b from its step-10 checkpoint: all {len(leaves1)} "
          f"leaves of params and optimizer state equal the uninterrupted "
          f"run's bit for bit after step 20, losses equal; step "
          f"{n_steps - 1} under torch.profiler " + _profile_text(profile_out))
    return dict(k3=launches[1], ms=ms, losses=losses, profile=profile_out)


def train_launches(cfg, rows: int):
    """(K1, K3) launches of one training step of ``cfg`` on ``rows`` rows
    through the kernels, reckoned from the parameter shapes: each of
    ``cfg.grad_accum`` micro-batches runs every projection of
    :func:`giant_shapes_of` and the LM head once for each of its loss
    pieces, twice under remat full (the forward and the backward's
    recompute; the backwards are plain), and every SSD block's scan
    twice."""
    assert cfg.remat == "full"
    accum = max(1, cfg.grad_accum)
    micro = rows // accum
    pieces = (cfg.loss_batch_chunks
              if micro % cfg.loss_batch_chunks == 0 else 1)
    scans = sum(r * sum(s.kind == "ssm" for s in p) for r, p in cfg.segments)
    return (accum * 2 * (len(giant_shapes_of(cfg)) + pieces),
            accum * 2 * scans)


def _leaf_sums(params) -> list:
    """Each leaf's fp64 sum: whether a step moved it."""
    import torch

    from repro_torch import tree as tree_util

    with torch.no_grad():
        return [float(t.sum(dtype=torch.float64))
                for t in tree_util.leaves(params)]


def train_cut(tag: str, cfg, n_steps: int = FAMILY_STEPS,
              seq_len: int = TRAIN_SEQ, batch: int = TRAIN_BATCH):
    """``cfg`` (full width, cut depth) seeded on the card and trained
    ``n_steps`` steps of ``batch`` x ``seq_len`` tokens as
    ``launch.train.train`` trains an arch: the config's optimizer
    (``steps.make_optimizer``: AdamW with fp32 moments, or Adafactor),
    the reference's schedule, ``steps.make_train_step`` (the config's
    micro-batches, remat and loss pieces), the synthetic token stream.
    Gates: finite losses, every leaf moved, and the K1 and K3 launches of
    every step equal to :func:`train_launches`.  Returns the readings."""
    import math
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as tree_util
    from repro_torch.data.synthetic import DataConfig, lm_batch
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    params = transformer.init(cfg, 0, "cuda")
    opt_cfg, opt_init, opt_apply = steps_mod.make_optimizer(
        cfg, lr=3e-4, total_steps=n_steps, warmup_steps=max(2, n_steps // 10))
    opt = opt_init(params, opt_cfg)
    train_step = steps_mod.make_train_step(cfg, opt_cfg, opt_apply)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
                      seed=0)
    before = _leaf_sums(params)
    want = train_launches(cfg, batch)
    losses, step_s, launches = [], [], []
    # the last step under torch.profiler: device time by kernel group
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for step in range(n_steps):
        b = {k: torch.from_numpy(v).to("cuda")
             for k, v in lm_batch(dcfg, step).items()}
        torch.cuda.synchronize()
        k1.afpm_matmul.launches = k3.ssd_scan.launches = 0
        with (prof if step == n_steps - 1 else contextlib.nullcontext()):
            t0 = time.perf_counter()
            params, opt, metrics = train_step(params, opt, b)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches.append((k1.afpm_matmul.launches, k3.ssd_scan.launches))
    profile_out = _device_groups(prof, 1e3 * step_s[-1])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = sum(a != b for a, b in zip(before, _leaf_sums(params)))
    leaf_bytes = sum(t.numel() * t.element_size()
                     for t in tree_util.leaves(params))
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in tree_util.leaves(opt)
                    if isinstance(t, torch.Tensor))
    n_params = sum(t.numel() for t in tree_util.leaves(params))
    del params, opt, b, metrics
    torch.cuda.empty_cache()
    fails = []
    if not all(math.isfinite(l) for l in losses):
        fails.append(f"{tag}: losses {losses} not finite")
    if moved != len(before):
        fails.append(f"{tag}: {moved} of {len(before)} leaves moved")
    if any(n != want for n in launches):
        fails.append(f"{tag}: (K1, K3) launched {launches} a step, "
                     f"expected {want}")
    ms = 1e3 * statistics.median(step_s[1:n_steps - 1])
    return dict(losses=losses, step_ms=[1e3 * s for s in step_s], ms=ms,
                rows=batch, seq_len=seq_len,
                tokens_s=batch * seq_len / ms * 1e3,
                peak_gb=peak_gb, held_gb=held_gb, params=n_params,
                params_gb=leaf_bytes / 1e9, grads_gb=leaf_bytes / 1e9,
                opt_gb=opt_bytes / 1e9,
                optimizer=type(opt_cfg).__name__.removesuffix("Config"),
                k1=launches[0][0], k3=launches[0][1], want=want,
                moved=moved, leaves=len(before), fails=fails,
                profile=profile_out)


@contextlib.contextmanager
def recorded_routes():
    """Every MoE routing decision made while open: ``(probs, eidx)`` of
    each ``moe.route`` call, in call order."""
    from repro_torch.models import moe

    real, calls = moe.route, []

    def record(probs, top_k):
        gate, eidx = real(probs, top_k)
        calls.append((probs.detach(), eidx))
        return gate, eidx

    moe.route = record
    try:
        yield calls
    finally:
        moe.route = real


def route_mismatch(tag: str, got: list, want: list, top_k: int):
    """None when both routes chose the same experts, in the same order,
    for every token of every routing call; else a line naming the first
    token that differs and its router margin (the gap between the kernel
    route's probabilities ranked k and k + 1 there, the smallest of the
    first ``top_k``).  Also returns the smallest such margin over all
    tokens: how near a tie the routing came."""
    import torch

    if len(got) != len(want):
        return (f"{tag}: {len(got)} routing calls on the kernel route, "
                f"{len(want)} on the plain route"), None
    margin = None
    for i, ((pa, ea), (_, eb)) in enumerate(zip(got, want)):
        top = torch.sort(pa, dim=-1, descending=True).values[..., :top_k + 1]
        gaps = (top[..., :-1] - top[..., 1:]).amin(-1)
        m = float(gaps.min())
        margin = m if margin is None else min(margin, m)
        bad = (ea != eb).any(-1).nonzero()
        if len(bad):
            row, pos = (int(v) for v in bad[0])
            return (f"{tag}: routing call {i} (the forward's and the "
                    f"recompute's, layer by layer) sends token (row {row}, "
                    f"position {pos}) to experts {ea[row, pos].tolist()} "
                    f"on the kernel route and {eb[row, pos].tolist()} on "
                    f"the plain route; its router margin "
                    f"{float(gaps[row, pos]):.3g}"), margin
    return None, margin


def family_grad_gate(tag: str, cut, batch):
    """The kernel route's gradients against the plain route's on ``cut``
    (``GRAD_CUT_LAYERS`` layers at full width, fp32 activations), on the
    same params and ``batch`` (on the card), under segmented3 and under
    exact: the same routing on both routes (else the gate names the token
    that moved), then every leaf within LOGIT_BOUND of the plain route's
    largest.
    K1 and K3 launch as :func:`train_launches` reckons on the kernel
    route and never on the plain route.  Returns (readings, fails)."""
    import dataclasses

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import ssd_scan as k3
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.numerics import NumericsConfig

    assert cut.n_layers == GRAD_CUT_LAYERS and cut.dtype == "float32"
    params = transformer.init(cut, seed=0, device="cuda")
    names = [n for n, _ in tree_util.named(params)]
    want_k = train_launches(dataclasses.replace(cut, grad_accum=1),
                            batch["targets"].shape[0])
    out, fails = {}, []
    for mode, kw in (("segmented3", dict(mode="segmented", seg_passes=3)),
                     ("exact", {})):
        run = {}
        for backend in ("hopper", "torch"):
            c = dataclasses.replace(cut, numerics=NumericsConfig(
                backend=backend, **kw))
            k1.afpm_matmul.launches = k3.ssd_scan.launches = 0
            with recorded_routes() as routes:
                loss, g = steps.grads_of(transformer.loss_fn, params, c, batch)
                torch.cuda.synchronize()
            run[backend] = dict(loss=float(loss), routes=routes,
                                k=(k1.afpm_matmul.launches,
                                   k3.ssd_scan.launches))
            if backend == "hopper":
                # the gradients themselves: clear_grads below detaches them
                # from the params, so the plain route makes its own
                run[backend]["g"] = tree_util.leaves(g)
            else:
                got, want = run["hopper"].pop("g"), tree_util.leaves(g)
                errs = _leaf_errs(names, got, want, tag)
                # a leaf whose gradient is rounding noise on the plain
                # route (top-1's router: its one gate renormalised to 1)
                # is held to that noise on both, as tests/test_torch_moe.py
                # holds it
                largest = max(float(t.abs().max()) for t in want)
                floor = NOISE_FLOOR * largest
                noise = {n: max(float(a.abs().max()), float(b.abs().max()))
                         for n, a, b in zip(names, got, want)
                         if float(b.abs().max()) <= floor}
                del got, want
            # one route's gradients held at a time beside the kernel
            # route's (qwen2-vl's 2-layer cut: 17 GB a set)
            del g
            steps.clear_grads(params)
        r = dict(loss=run["hopper"]["loss"], plain_loss=run["torch"]["loss"],
                 k1=run["hopper"]["k"][0], k3=run["hopper"]["k"][1])
        if run["hopper"]["k"] != want_k or run["torch"]["k"] != (0, 0):
            fails.append(f"{tag} gradient gate {mode}: (K1, K3) launched "
                         f"{run['hopper']['k']} (plain route "
                         f"{run['torch']['k']}), expected {want_k}")
        if cut.moe is not None:
            bad, r["router_margin"] = route_mismatch(
                f"{tag} {mode}", run["hopper"]["routes"],
                run["torch"]["routes"], cut.moe.top_k)
            r["routing_calls"] = len(run["hopper"]["routes"])
            if bad:
                # gradients of two routings are not compared
                fails.append(bad)
                out[mode] = r
                continue
        r["noise"] = {n: v / largest for n, v in noise.items()}
        for n, v in noise.items():
            if v > floor:
                fails.append(f"{tag} gradient gate {mode}: {n}'s gradient "
                             f"{v:.3g} is noise on the plain route (at most "
                             f"{NOISE_FLOOR:g} of the largest leaf's) but "
                             f"not on the kernel route")
        r["worst"] = list(max(((n, e) for n, e in errs.items()
                               if n not in noise), key=lambda kv: kv[1]))
        if r["worst"][1] > LOGIT_BOUND:
            fails.append(f"{tag} gradient gate {mode}: {r['worst'][0]} "
                         f"kernel-route gradient {r['worst'][1]:.3g} of the "
                         f"plain route's largest > {LOGIT_BOUND}")
        out[mode] = r
    del params
    torch.cuda.empty_cache()
    return out, fails


def gate_text(gate: dict) -> str:
    """One line's text of a :func:`family_grad_gate` reading."""
    return "; ".join(
        f"{mode}: loss {v['loss']:.6f} (plain {v['plain_loss']:.6f}), K1 "
        f"{v['k1']} / K3 {v['k3']} a step"
        + (f", {v['routing_calls']} routing calls equal on both routes "
           f"(smallest router margin {v['router_margin']:.3g})"
           if 'routing_calls' in v else "")
        + (f", worst leaf {v['worst'][0]} {v['worst'][1]:.3g}"
           if 'worst' in v else "")
        + "".join(f", {n} noise on both routes ({e:.3g} of the largest "
                  f"leaf's, held to {NOISE_FLOOR:g})"
                  for n, e in v.get("noise", {}).items())
        for mode, v in gate.items())


def family_text(tag: str, cfg, tr: dict, gate: dict, extra: str = "") -> str:
    return (f"[{tag}] {cfg.n_layers} layers at full width "
            f"({tr['params'] / 1e9:.3f} B params), {len(tr['losses'])} steps "
            f"of {tr['rows']} x {tr['seq_len']} tokens ({cfg.grad_accum} "
            f"micro-batches, remat {cfg.remat}, {tr['optimizer']}): losses "
            + ", ".join(f"{l:.4f}" for l in tr["losses"])
            + f"; {tr['moved']} of {tr['leaves']} leaves moved; "
            f"{tr['ms']:.1f} ms a step (median of steps 1-"
            f"{len(tr['losses']) - 2}, host clock around a synced step; "
            + ", ".join(f"{s:.1f}" for s in tr["step_ms"])
            + f"), {tr['tokens_s']:.0f} tokens/s; peak {tr['peak_gb']:.2f} "
            f"GB beside params {tr['params_gb']:.2f} + gradients "
            f"{tr['grads_gb']:.2f} + optimizer state {tr['opt_gb']:.2f} GB "
            f"(held before {tr['held_gb']:.2f}); K1 {tr['k1']} and K3 "
            f"{tr['k3']} launches a step (reckoned {tr['want'][0]} / "
            f"{tr['want'][1]}: micro-batches x 2 forwards x (projections + "
            f"head calls), scans likewise); step {len(tr['losses']) - 1} "
            f"under torch.profiler " + _profile_text(tr["profile"])
            + f"; gradient gate on "
            f"{GRAD_CUT_LAYERS} layers, fp32 activations, kernel route "
            f"against plain route (bound {LOGIT_BOUND:.3g}): "
            + gate_text(gate) + extra
            + f"; phase {tr['phase_s']:.1f} s; {smi('name,power.limit')}")


def train_family(tag: str, cfg, cut, after=None, seq_len: int = TRAIN_SEQ,
                 batch: int = TRAIN_BATCH):
    """A family training phase: :func:`train_cut` of ``cfg`` on ``batch``
    x ``seq_len`` tokens, then :func:`family_grad_gate` on ``cut`` at the
    same size and ``after()``, which returns more text for the phase's
    line and more failed gates; prints the line, then raises with every
    failed gate."""
    t0 = time.perf_counter()
    tr = train_cut(tag, cfg, seq_len=seq_len, batch=batch)
    gate, fails = family_grad_gate(tag, cut,
                                   train_batch(cut, 0, seq_len, batch))
    text, more = after() if after is not None else ("", [])
    tr["phase_s"] = time.perf_counter() - t0
    print(family_text(tag, cfg, tr, gate, text))
    fails = tr.pop("fails") + fails + more
    if fails:
        raise AssertionError(f"[{tag}]: " + "; ".join(fails))
    return dict(tr, gate=gate)


def phase_train_zamba2():
    """Full-width zamba2-7b cut to ZAMBA2_TRAIN_REPEATS of its 13 (5 SSD +
    shared attention) repeats and its 3-block SSD tail, trained
    FAMILY_STEPS steps (AdamW, fp32 moments; K1 in every projection, K3
    at H 112, N 64 in every SSD block, the shared block's gradient summed
    over its applications under remat); the gradient gate on one SSD
    block and the shared block."""
    import dataclasses

    from repro_torch.configs import get_arch

    full = get_arch("zamba2-7b")
    assert (full.n_layers, full.d_model, full.ssm.state_size,
            full.segments[0][0], full.optimizer) == (81, 3584, 64, 13,
                                                     "adamw")
    (_, pattern), tail = full.segments
    cfg = dataclasses.replace(full, segments=((ZAMBA2_TRAIN_REPEATS,
                                               pattern), tail))
    cut = dataclasses.replace(full, dtype="float32",
                              segments=((1, (pattern[0], pattern[-1])),))
    return train_family("train-zamba2", cfg, cut, lambda: (
        f"; the shared block applied {ZAMBA2_TRAIN_REPEATS} times a "
        f"forward", []))


def phase_train_llama4():
    """Full-width llama4-maverick cut to one (moe, dense) repeat and
    LLAMA4_TRAIN_EXPERTS of its 128 experts, trained FAMILY_STEPS steps
    (Adafactor, 8 micro-batches; one K1 launch an expert projection,
    forward and recompute); the gradient gate on the same two layers."""
    import dataclasses

    from repro_torch.configs import get_arch

    full = get_arch("llama4-maverick-400b-a17b")
    assert (full.d_model, full.d_ff, full.moe.n_experts, full.moe.top_k,
            full.grad_accum) == (5120, 8192, 128, 1, 8)
    cfg = dataclasses.replace(
        full, segments=((1, full.segments[0][1]),),
        moe=dataclasses.replace(full.moe, n_experts=LLAMA4_TRAIN_EXPERTS))
    return train_family("train-llama4", cfg,
                        dataclasses.replace(cfg, dtype="float32"))


def _restart_deepseek():
    """The reduced deepseek-v3 (MLA, MoE) trained 20 steps with a
    checkpoint every 10; a second run restored from the step-10
    checkpoint alone must end on the same bits, as [train-mamba2]
    restarts the reduced qwen3-4b.  Returns (text, failed gates)."""
    import shutil

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.launch import train as train_mod

    ck = ROOT / "build" / "chip_smoke_ckpt_deepseek"
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(steps=20, seq_len=32, batch=4, ckpt_every=10, device="cuda",
              log_every=100)
    p1, o1, l1 = train_mod.train("deepseek-v3-671b", ckpt_dir=str(ck / "a"),
                                 **kw)
    (ck / "b").mkdir(parents=True)
    shutil.copytree(ck / "a" / "step_000000010", ck / "b" / "step_000000010")
    p2, o2, l2 = train_mod.train("deepseek-v3-671b", ckpt_dir=str(ck / "b"),
                                 **kw)
    leaves1, leaves2 = tree_util.leaves((p1, o1)), tree_util.leaves((p2, o2))
    same = sum(bool(torch.equal(a, b)) for a, b in zip(leaves1, leaves2))
    fails = []
    if same != len(leaves1) or l2 != l1[10:] or \
            ckpt_io.all_steps(str(ck / "b")) != [10, 20]:
        fails.append(f"restart: {same} of {len(leaves1)} leaves equal bit "
                     f"for bit; losses {l1[10:]} vs {l2}")
    shutil.rmtree(ck, ignore_errors=True)
    return (f"; restart of the reduced config from its step-10 checkpoint: "
            f"{same} of {len(leaves1)} leaves of params and optimizer state "
            f"equal the uninterrupted run's bit for bit after step 20, "
            f"losses {'equal' if l2 == l1[10:] else 'differ'}", fails)


def phase_train_deepseek():
    """Full-width deepseek-v3 cut to one dense-MLA and one MoE-MLA layer
    with DSV3_TRAIN_EXPERTS of its 256 experts, trained FAMILY_STEPS
    steps (Adafactor, 8 micro-batches, capacity 80 an expert a row); the
    gradient gate on the same two layers; then the reduced config's
    restart (:func:`_restart_deepseek`)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    full = get_arch("deepseek-v3-671b")
    assert (full.d_model, full.d_ff, full.moe.n_experts, full.moe.top_k,
            full.mla.kv_lora_rank, full.grad_accum) == (7168, 2048, 256, 8,
                                                        512, 8)
    cfg = dataclasses.replace(
        full, segments=tuple((1, pattern) for _, pattern in full.segments),
        moe=dataclasses.replace(full.moe, n_experts=DSV3_TRAIN_EXPERTS))

    def after():
        text, fails = _restart_deepseek()
        return (f"; capacity {moe.capacity(cfg, TRAIN_SEQ)} slots an expert "
                f"a row" + text, fails)

    return train_family("train-deepseek", cfg,
                        dataclasses.replace(cfg, dtype="float32"), after)


def phase_train_gemma2():
    """Full-width gemma2-9b cut to GEMMA2_TRAIN_REPEATS of its 21 (local
    4096, global) repeats, trained FAMILY_STEPS steps (AdamW): the
    attention softcap of 50 in every block and the logit softcap of 30
    after the tied head under autograd, the head K1 at one pass over the
    256000 x 3584 table, whose gradient sums the head's and the embedding
    gather's; the gradient gate on one repeat."""
    import dataclasses

    from repro_torch.configs import get_arch

    full = get_arch("gemma2-9b")
    assert (full.d_model, full.vocab, full.segments[0][0], full.attn_softcap,
            full.logit_softcap, full.tie_embeddings, full.optimizer) == (
        3584, 256000, 21, 50.0, 30.0, True, "adamw")
    (_, pattern), = full.segments
    cfg = dataclasses.replace(full, segments=((GEMMA2_TRAIN_REPEATS,
                                               pattern),))
    return train_family("train-gemma2", cfg, dataclasses.replace(
        full, dtype="float32", segments=((1, pattern),)))


def phase_train_gemma3():
    """Full-width gemma3-12b cut to GEMMA3_TRAIN_REPEATS of its 8 (5 local
    1024 + 1 global) repeats, trained FAMILY_STEPS steps (AdamW) on
    GEMMA3_TRAIN_BATCH rows of GEMMA3_TRAIN_SEQ tokens: longer than the
    window, so the local layers mask, in the forward and in the remat
    recompute, and the loss is one piece (2 rows do not cut into 8); the
    gradient gate on (local, global) at the same size."""
    import dataclasses

    from repro_torch.configs import get_arch

    full = get_arch("gemma3-12b")
    (_, pattern), = full.segments
    assert (full.d_model, full.vocab, full.segments[0][0], len(pattern),
            pattern[0].window, full.tie_embeddings, full.optimizer) == (
        3840, 262144, 8, 6, 1024, True, "adamw")
    assert GEMMA3_TRAIN_SEQ > pattern[0].window
    cfg = dataclasses.replace(full, segments=((GEMMA3_TRAIN_REPEATS,
                                               pattern),))
    cut = dataclasses.replace(full, dtype="float32",
                              segments=((1, (pattern[0], pattern[-1])),))
    local = sum(s.attn == "local" for s in cfg.layer_specs())
    return train_family("train-gemma3", cfg, cut, lambda: (
        f"; {local} of {cfg.n_layers} layers (and the gate's first) attend "
        f"their last {pattern[0].window} of {GEMMA3_TRAIN_SEQ} positions",
        []), seq_len=GEMMA3_TRAIN_SEQ, batch=GEMMA3_TRAIN_BATCH)


def phase_train_minitron():
    """Full-width minitron-8b cut to MINITRON_TRAIN_LAYERS of its 32
    layers, trained FAMILY_STEPS steps (AdamW; the untied 256000 x 4096
    head, d_ff 16384); the gradient gate on 2 layers."""
    import dataclasses

    from repro_torch.configs import get_arch

    full = get_arch("minitron-8b")
    (_, pattern), = full.segments
    assert (full.d_model, full.d_ff, full.vocab, full.n_layers,
            full.tie_embeddings, full.optimizer) == (4096, 16384, 256000, 32,
                                                     False, "adamw")
    cfg = dataclasses.replace(full, segments=((MINITRON_TRAIN_LAYERS,
                                               pattern),))
    return train_family("train-minitron", cfg, dataclasses.replace(
        full, dtype="float32", segments=((GRAD_CUT_LAYERS, pattern),)))


def phase_train_qwen2_vl():
    """Full-width qwen2-vl-72b cut to QWEN2VL_TRAIN_LAYERS of its 80
    layers, trained FAMILY_STEPS steps on the token stream (Adafactor, 4
    micro-batches, M-RoPE with the three streams at the absolute
    position); the params fp32 as the trainer seeds every config (its
    ``param_dtype``, bf16, is the dry-run's).  The gradient gate on 2
    layers, on the token path and on the image path: seeded patch
    embeddings at the 3-D positions of an image of 8 rows of 16 patches
    with the token stream's targets, where the token table's gradient is
    exactly 0 on both routes."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    full = get_arch("qwen2-vl-72b")
    (_, pattern), = full.segments
    assert (full.d_model, full.d_ff, full.vocab, full.mrope_sections,
            full.optimizer, full.grad_accum) == (8192, 29568, 152064,
                                                 (16, 24, 24), "adafactor", 4)
    cfg = dataclasses.replace(full, segments=((QWEN2VL_TRAIN_LAYERS,
                                               pattern),))
    cut = dataclasses.replace(full, dtype="float32",
                              segments=((GRAD_CUT_LAYERS, pattern),))

    def after():
        # the model API's vision stub as [qwen2-vl] feeds it: t = 0,
        # h = i // 16, w = i % 16
        gen = torch.Generator(device="cuda").manual_seed(1)
        i = torch.arange(TRAIN_SEQ, device="cuda")
        pos = torch.stack([torch.zeros_like(i), i // 16, i % 16], -1)
        batch = {"embeds": torch.randn((TRAIN_BATCH, TRAIN_SEQ, cut.d_model),
                                       generator=gen, device="cuda"),
                 "positions": pos.expand(TRAIN_BATCH, -1, -1).contiguous(),
                 "targets": train_batch(cut, 0, TRAIN_SEQ,
                                        TRAIN_BATCH)["targets"]}
        gate, fails = family_grad_gate("train-qwen2-vl image path", cut,
                                       batch)
        for mode, v in gate.items():
            if v.get("noise", {}).get("embed") != 0.0:
                fails.append(f"train-qwen2-vl image path {mode}: the token "
                             f"table's gradient is not 0 on both routes")
        return (f"; image path ({TRAIN_BATCH} x {TRAIN_SEQ} patch "
                f"embeddings at 3-D positions, the token table's gradient 0 "
                f"on both routes): " + gate_text(gate), fails)

    return train_family("train-qwen2-vl", cfg, cut, after)


def phase_train_resnet():
    """Table IV's ResNet-18, full width, trained as the reference trains
    it; then top-1 on the reference's 48 evaluation images under exact,
    segmented 1/2/3 (K1 at im2col shapes) and the eight designs."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.bench import table4_resnet
    from repro_torch.core.metrics import top_k_accuracy
    from repro_torch.kernels import afpm_bitwise as k2
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.session import Session

    # two short trainings end on the same bits (deterministic cuDNN)
    runs = [table4_resnet.train_resnet(steps=6, batch=64, width_mult=1.0,
                                       device="cuda", log_every=100)
            for _ in range(2)]
    a, b = (tree_util.leaves((r[1], r[2])) for r in runs)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("train-resnet: two trainings from one seed "
                             "differ")
    del runs, a, b
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params, state, losses = table4_resnet.train_resnet(
        steps=120, batch=64, width_mult=1.0, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    assert cfg.widths == (64, 128, 256, 512)
    sess = Session.from_resnet(cfg, params, state, device="cuda")
    k2.emulated_matmul.launches = 0
    rows = table4_resnet.run(sess=sess, eval_n=48)
    torch.cuda.synchronize()
    emu_launches = k2.emulated_matmul.launches
    if emu_launches != 21 * len(EMU_DESIGNS):
        raise AssertionError(f"train-resnet: {emu_launches} emulated-matmul "
                             f"launches in Table IV's evaluation, expected "
                             f"21 x {len(EMU_DESIGNS)} AFPM designs")
    ev = table4_resnet.eval_batch(48)
    labels = torch.as_tensor(ev["labels"])
    # AC5-5's 48-image forward on the plain route, beside the kernel
    # route's in `rows` (both timed without a warmup, as run() times)
    plain_ac55 = sess.replace(policy=table4_resnet.emulated_config("AC5-5"),
                              backend="torch")
    plain_s, plain_logits = table4_resnet.timed_forward(
        plain_ac55, ev["images"], 1, warmup=False)
    kernel_s = rows["AC5-5"]["ms"] / 1e3
    if plain_s < 10 * kernel_s:
        raise AssertionError(f"train-resnet: AC5-5's 48-image forward takes "
                             f"{kernel_s:.3f} s through the kernel, "
                             f"{plain_s:.3f} s plain: under 10x")
    # the kernel route's 48-image logits against the plain route's; beside
    # them, how far another design's logits (ACL5's, kernel route) lie from
    # AC5-5's plain ones: what the gate tells apart
    kernel_logits = sess.replace(
        policy=table4_resnet.emulated_config("AC5-5")).apply(ev["images"])
    logits_err = rel_err(kernel_logits, plain_logits)
    other_err = rel_err(sess.replace(
        policy=table4_resnet.emulated_config("ACL5")).apply(ev["images"]),
        plain_logits)
    if not logits_err <= EMU_LOGIT_BOUND:
        raise AssertionError(f"train-resnet: AC5-5's 48-image logits through "
                             f"the kernel are {logits_err:.3g} of the largest "
                             f"from the plain route's (bound "
                             f"{EMU_LOGIT_BOUND:g})")
    exact = sess.apply(ev["images"])
    seg = {}
    for passes in (1, 2, 3):
        k1.afpm_matmul.launches = 0
        logits = sess.replace(policy=f"segmented{passes}").apply(ev["images"])
        torch.cuda.synchronize()
        if k1.afpm_matmul.launches != 21 or not torch.isfinite(logits).all():
            raise AssertionError(f"train-resnet segmented{passes}: "
                                 f"{k1.afpm_matmul.launches} K1 launches")
        seg[passes] = (top_k_accuracy(logits, labels, 1),
                       (logits.argmax(-1) == exact.argmax(-1)).float()
                       .mean().item())
    top1 = rows["Exact"]["top1"]
    if top1 < 0.9:
        raise AssertionError(f"train-resnet: exact top-1 {top1:.3f} < 0.9")
    print(f"[train-resnet] ResNet-18 full width: two 6-step trainings "
          f"equal bit for bit; trained 120 steps x 64 images (AdamW lr 3e-3 "
          f"cosine, TF32 off) in {train_s:.1f} s: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; Table IV top-1 on 48 images "
          f"(paper beside it): exact {top1:.4f} ({table4_resnet.PAPER['Exact'][2]})"
          + "".join(f"; segmented{p} {seg[p][0]:.4f} (agreement "
                    f"{100 * seg[p][1]:.1f}%)" for p in (1, 2, 3))
          + "".join(f"; {n} {r['top1']:.4f} ({table4_resnet.PAPER[n][2]}, "
                    f"d {r['d_top1']:+.4f}, agreement {100 * r['agree']:.1f}%,"
                    f" MRED {r['mred']:.3g}, {r['ms'] / 1e3:.2f} s)"
                    for n, r in rows.items() if n != "Exact"))
    print(f"[train-resnet] emulated matmuls through K2: {emu_launches} "
          f"launches in the evaluation (21 a forward of each of "
          f"{', '.join(EMU_DESIGNS)}; 0 for the baselines, plain); AC5-5's "
          f"48-image forward {kernel_s:.3f} s through the kernel, "
          f"{plain_s:.3f} s on the plain route ({plain_s / kernel_s:.0f}x), "
          f"top-1 {rows['AC5-5']['top1']:.4f} vs "
          f"{top_k_accuracy(plain_logits, labels, 1):.4f}, logits "
          f"{logits_err:.3g} of the largest apart (bound "
          f"{EMU_LOGIT_BOUND:g}; ACL5's kernel-route logits lie "
          f"{other_err:.3g} from AC5-5's plain ones)")
    return dict(cfg=cfg, params=params, state=state, rows=rows, seg=seg,
                train_s=train_s, emu_launches=emu_launches,
                ac55_kernel_s=kernel_s, ac55_plain_s=plain_s,
                ac55_logits_rel_err=logits_err, acl5_vs_ac55_rel_err=other_err)


def host_ms(fn, repeats: int):
    """Median host milliseconds of a synced call of ``fn`` (one warmup call
    first, excluded), and the last call's result."""
    import statistics

    import torch

    out = fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), out


def kernel_group(name: str, convs: bool = True) -> str:
    """The group a device kernel's time is reported under (the profiles of
    the training phases and [resnet]);
    ``convs=False`` for a model without cuDNN convs, whose cuBLAS kernels
    may carry conv-like names (``xmma``)."""
    n = name.lower()
    if "afpm_emulated" in n:
        return "K2 emulated matmul"
    if "afpm_bitwise" in n:
        return "K2"
    if "afpm" in n:
        return "K1"
    if "ssd_scan" in n or "chunk_kernel" in n or "output_kernel" in n:
        return "K3"
    if convs and any(k in n for k in ("conv", "fprop", "xmma", "implicit",
                                      "cudnn", "winograd")):
        return "cudnn conv"
    if not convs and any(k in n for k in ("xmma", "sgemm", "gemv")):
        return "matmul"
    if any(k in n for k in ("gemm", "cutlass", "matmul")):
        return "matmul"
    if any(k in n for k in ("cat", "pad", "copy", "transpose", "nchw",
                            "nhwc")):
        return "im2col/layout copies"
    if "reduce" in n:
        return "reductions"
    return "elementwise"


def profile_call(fn) -> dict:
    """One call of ``fn`` (after a warmup) under ``torch.profiler``: the
    host ms of the synced call (profiler on), the device ms of its kernels
    by :func:`kernel_group`, and their sum over the host ms (the card's
    busy share; kernels of one stream do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    groups, n = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            g = kernel_group(evt.name)
            groups[g] = groups.get(g, 0.0) + evt.time_range.elapsed_us() / 1e3
            n += 1
    busy = sum(groups.values())
    return dict(wall_ms=wall, device_ms=busy, busy_share=busy / wall,
                kernels=n, groups=dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])))


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def phase_resnet(peaks, trained):
    import numpy as np
    import torch

    from repro_torch.bench.table4_resnet import emulated_config
    from repro_torch.compat import flatten_tree
    from repro_torch.core.metrics import mred, top_k_accuracy
    from repro_torch.data.synthetic import DataConfig, cifar_like
    from repro_torch.kernels import afpm_bitwise as k2
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import dispatch
    from repro_torch.models import resnet
    from repro_torch.numerics import set_operand_tap
    from repro_torch.session import Session

    # 1. the committed checkpoint, through from_pretrained, onto the card
    fixture = ROOT / "tests" / "golden" / "compat"
    fx = Session.from_pretrained("resnet18", fixture / "resnet18",
                                 device="cuda")
    got = flatten_tree(fx.params)
    got.update(flatten_tree(fx._state))
    ref = np.load(fixture / "resnet18_reference.npz")
    if sorted(got) != sorted(ref.files) or not all(
            got[k].dtype == ref[k].dtype
            and got[k].tobytes() == ref[k].tobytes() for k in ref.files):
        raise AssertionError("resnet18 fixture on the card differs from "
                             "resnet18_reference.npz")

    cfg, params, state = trained["cfg"], trained["params"], trained["state"]
    assert (cfg.widths, cfg.blocks) == ((64, 128, 256, 512), (2, 2, 2, 2))
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(t.size for t in flatten_tree(params).values())
    sess = Session.from_resnet(cfg, params, state, device="cuda")
    data = cifar_like(DataConfig(global_batch=RESNET_BATCH, seed=999), 10_000)
    x = torch.as_tensor(data["images"], device="cuda")
    labels = torch.as_tensor(data["labels"])
    timing = {}   # mode -> (ms a forward, batch)

    # 2. exact: the native conv with TF32 off.  Stage 0's first conv at
    # this batch, against an fp64 conv: the model's conv sits at fp32's
    # error, a direct cuDNN call with TF32 on at TF32's.  The whole forward
    # against the fp32 im2col route (a calibration tap routes exact convs
    # through im2col + an fp32 matmul)
    timing["exact"] = host_ms(lambda: sess.apply(x), 5)[0], RESNET_BATCH
    exact = sess.apply(x)
    gen = torch.Generator(device="cuda").manual_seed(1)
    act = torch.randn((RESNET_BATCH, 32, 32, 64), generator=gen,
                      device="cuda").relu()
    w = params["s0b0"]["conv1"]
    xn, wn = act.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    conv64 = torch.nn.functional.conv2d(xn.double(), wn.double(),
                                        padding=1).permute(0, 2, 3, 1)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=True):
        conv_tf32 = torch.nn.functional.conv2d(xn, wn, padding=1)
    d_tf32 = rel_err(conv_tf32.permute(0, 2, 3, 1).double(), conv64)
    d_conv = rel_err(resnet.conv2d(act, w).double(), conv64)
    prev = set_operand_tap(lambda *a: None)
    try:
        im2col_fp32 = sess.apply(x)
    finally:
        set_operand_tap(prev)
    d_fp32 = rel_err(im2col_fp32, exact)
    top1 = {"exact": (top_k_accuracy(exact, labels, 1), 1.0)}
    if exact.shape != (RESNET_BATCH, 10) or not torch.isfinite(exact).all() \
            or d_fp32 > 1e-4 or d_conv > 1e-5:
        raise AssertionError(f"exact logits bad: {tuple(exact.shape)}, "
                             f"{d_fp32:.3g} of the largest from the fp32 "
                             f"im2col route (bound 1e-4), stage 0's conv "
                             f"{d_conv:.3g} from fp64 (bound 1e-5)")

    # 3. segmented 1/2/3 through K1: 21 launches a forward; every conv
    # within 64 ulps of the plain version on the same operands, logits
    # within 2**-6 of the plain route's
    worst_ulp, seg_err, launches = 0.0, {}, 0
    for passes in (1, 2, 3):
        s = sess.replace(policy=f"segmented{passes}")
        k1.afpm_matmul.launches = 0
        logits = s.apply(x)
        torch.cuda.synchronize()
        ran = k1.afpm_matmul.launches
        if ran != 21:
            raise AssertionError(f"segmented{passes}: afpm_matmul launched "
                                 f"{ran} times in one forward, expected 21 "
                                 f"(20 convs + fc)")
        launches += ran
        plain = sess.replace(policy=f"segmented{passes}",
                             backend="torch").apply(x)
        seg_err[passes] = rel_err(logits, plain)
        top1[f"segmented{passes}"] = (
            top_k_accuracy(logits, labels, 1),
            (logits.argmax(-1) == exact.argmax(-1)).float().mean().item())
        if not torch.isfinite(logits).all() or seg_err[passes] > LOGIT_BOUND:
            raise AssertionError(f"segmented{passes}: kernel-route logits "
                                 f"{seg_err[passes]:.3g} of the largest from "
                                 f"the plain route > {LOGIT_BOUND}")
        sites = []
        prev = set_operand_tap(lambda path, a, b: sites.append((path, a, b)))
        try:
            with torch.inference_mode():
                resnet.apply(params, state, x, s.config)
        finally:
            set_operand_tap(prev)
        for path, a, b in sites:
            kern = dispatch.matmul(a, b, passes, backend="hopper")
            want = dispatch.matmul(a, b, passes, backend="torch")
            ulp = float(np.spacing(np.float32(want.abs().max().item())))
            err = (kern - want).abs().max().item() / ulp
            if err > ULP_BOUND:
                raise AssertionError(f"segmented{passes} {path} "
                                     f"{tuple(a.shape)}@{tuple(b.shape)}: "
                                     f"{err:.1f} ulps > {ULP_BOUND}")
            worst_ulp = max(worst_ulp, err)
        del sites
        timing[f"segmented{passes}"] = host_ms(lambda: s.apply(x), 5)[0], \
            RESNET_BATCH

    # K1 at stage 0's conv shape (M = B * 1024, K = 576, N = 64), timed as
    # phase [kernel] times it
    bw, flops, _ = peaks
    M, K, N = RESNET_BATCH * 1024, 576, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randn((M, K), generator=gen, device="cuda")
    b = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    bytes_ms = (M * K * 4 + K * N * 4 + M * N * 4) / bw * 1e3
    ops_ms = 2 * 3 * M * N * K / flops * 1e3
    conv = dict(
        M=M, K=K, N=N, passes=3, plan=k1.plan(M, K, N)._asdict(),
        kernel_ms=timed_ms(lambda: k1.afpm_matmul(a, b, 3), 20, flush, True),
        plain_ms=timed_ms(lambda: k1.afpm_matmul_plain(a, b, 3), 5, flush,
                          True),
        library_ms=timed_ms(lambda: [torch.matmul(ab, bb) for _ in range(3)],
                            20, flush, True),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    del a, b, ab, bb, flush

    # 4. the eight Table IV designs ran emulated on these weights in
    # [train-resnet].  Here: K2's emulated matmul runs 21 times a forward of
    # an AFPM design and never for a baseline (one image a forward); AC5-5
    # at batch 8 conv by conv (every conv fed the same operands) within 64
    # ulps of the plain route, and its logits beside the plain route's
    xe = x[:EMULATED_BATCH]
    emulated = {n: (r["top1"], r["agree"], r["logits_mred"])
                for n, r in trained["rows"].items() if n != "Exact"}
    for n, r in trained["rows"].items():
        if n != "Exact":
            timing[f"emulated {n}"] = r["ms"], 48
    emu_launches = {}
    for n in emulated:
        k2.emulated_matmul.launches = 0
        sess.replace(policy=emulated_config(n)).apply(x[:1])
        torch.cuda.synchronize()
        emu_launches[n] = k2.emulated_matmul.launches
        if emu_launches[n] != (21 if n in EMU_DESIGNS else 0):
            raise AssertionError(f"emulated {n}: {emu_launches[n]} K2 "
                                 f"emulated-matmul launches a forward")
    ac55 = emulated_config("AC5-5")
    emu_kernel = sess.replace(policy=ac55).apply(xe)
    emu_plain = sess.replace(policy=ac55, backend="torch").apply(xe)
    emu_logits_err = rel_err(emu_kernel, emu_plain)
    emu_agree = (emu_kernel.argmax(-1) == emu_plain.argmax(-1)).float() \
        .mean().item()
    sites = []
    prev = set_operand_tap(lambda path, a, b: sites.append((path, a, b)))
    try:
        with torch.inference_mode():
            resnet.apply(params, state, xe, sess.replace(policy=ac55).config)
    finally:
        set_operand_tap(prev)
    emu_worst_ulp = 0.0
    for path, a, b in sites:
        err = max_ulps(dispatch.emulated_matmul(a, b, ac55.afpm(),
                                                backend="hopper"),
                       dispatch.emulated_matmul(a, b, ac55.afpm(),
                                                backend="torch"))
        if err > ULP_BOUND:
            raise AssertionError(f"emulated AC5-5 {path} {tuple(a.shape)}@"
                                 f"{tuple(b.shape)}: {err:.1f} ulps > "
                                 f"{ULP_BOUND}")
        emu_worst_ulp = max(emu_worst_ulp, err)
    if len(sites) != 21 or not torch.isfinite(emu_kernel).all() \
            or not emu_logits_err <= EMU_LOGIT_BOUND:
        raise AssertionError(f"emulated AC5-5 at batch {EMULATED_BATCH}: "
                             f"{len(sites)} sites, finite logits "
                             f"{bool(torch.isfinite(emu_kernel).all())}, "
                             f"logits {emu_logits_err:.3g} of the largest "
                             f"from the plain route's (bound "
                             f"{EMU_LOGIT_BOUND:g})")
    del sites

    # where a forward's time goes: one profiled forward per mode
    profiles = {
        "exact": profile_call(lambda: sess.apply(x)),
        "segmented3": profile_call(
            lambda: sess.replace(policy="segmented3").apply(x)),
        "emulated AC5-5": profile_call(
            lambda: sess.replace(policy=emulated_config("AC5-5")).apply(xe)),
    }
    if profiles["emulated AC5-5"]["kernels"] > 1000:
        raise AssertionError(f"emulated AC5-5: "
                             f"{profiles['emulated AC5-5']['kernels']} device "
                             f"kernels in one forward")
    (ROOT / "chiprun_out" / "chip_smoke_resnet.json").write_text(json.dumps(
        {"card": smi("name,power.limit"), "profiles": profiles,
         "timing_ms": timing, "conv": conv, "emulated": emulated,
         "emulated_launches": emu_launches,
         "emulated_ac55": {"max_ulp_err": emu_worst_ulp,
                           "logits_rel_err": emu_logits_err,
                           "argmax_agreement": emu_agree},
         "top1": top1},
        indent=1))

    # 5. the proxy auto-configurer on 32 calibration images, then the
    # emitted policy
    calib = torch.as_tensor(cifar_like(DataConfig(global_batch=32, seed=123),
                                       20_000)["images"], device="cuda")
    auto = sess.replace(policy=None)
    ref_calib = auto.apply(calib)
    t0 = time.perf_counter()
    res = auto.auto_configure(1e-2, calib=calib, method="proxy",
                              candidates="segmented")
    auto_s = time.perf_counter() - t0
    k1.afpm_matmul.launches = 0
    out = auto.apply(calib)
    torch.cuda.synchronize()
    auto_launches = k1.afpm_matmul.launches
    measured = mred(out, ref_calib)
    n_seg = sum(1 for _, name in res.assignments if name.startswith("seg"))
    if res.n_evals != 1 or res.error > 1e-2 or auto_launches != n_seg \
            or not torch.isfinite(out).all():
        raise AssertionError(f"auto_configure: {res.n_evals} evals, composed "
                             f"{res.error:.3g}, {auto_launches} K1 launches "
                             f"for {n_seg} segmented sites")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"[resnet] fixture from_pretrained on the card == "
          f"resnet18_reference.npz bit for bit; ResNet-18 full width "
          f"({n_params / 1e6:.2f} M params, trained in [train-resnet]), batch "
          f"{RESNET_BATCH}: top-1 (argmax agreement with exact) "
          + "; ".join(f"{m} {t:.4f} ({100 * a:.1f}%)"
                      for m, (t, a) in top1.items())
          + f"; stage 0's "
          f"conv against fp64, exact (TF32 off) {d_conv:.3g}, cuDNN with "
          f"TF32 on {d_tf32:.3g} of the largest output; exact logits vs the "
          f"fp32 im2col route {d_fp32:.3g} of the largest; segmented 1/2/3: 21 K1 "
          f"launches a forward, every conv within {worst_ulp:.2f} ulps of "
          f"the plain version (bound {ULP_BOUND}), logits "
          + "/".join(f"{seg_err[p]:.3g}" for p in (1, 2, 3))
          + f" of the plain route's largest (bound {LOGIT_BOUND:.3g}); K1 at "
          f"({M}, {K}) @ ({K}, {N}) passes 3: kernel {conv['kernel_ms']:.4f} "
          f"ms, plain {conv['plain_ms']:.4f}, bf16 torch.matmul x3 "
          f"{conv['library_ms']:.4f}, bound {conv['bound_ms']:.4f} "
          f"({conv['bound_by']}); auto_configure(1e-2, proxy, segmented) on "
          f"32 images in {auto_s:.2f} s: {len(res.assignments)} of "
          f"{len(auto.layer_paths())} sites approximate, composed "
          f"{res.error:.3g}, measured {measured:.3g}, modeled area -"
          f"{res.area_reduction:.1%}, {auto_launches} K1 launches; peak "
          f"memory {peak_gb:.2f} GB")
    print(f"[resnet]   emulated in [train-resnet], 48 images (top-1, argmax "
          f"agreement with exact, logits MRED): " + "; ".join(
              f"{n} {t:.4f} {100 * a:.1f}% {m:.3g}"
              for n, (t, a, m) in emulated.items()))
    print(f"[resnet]   K2 emulated-matmul launches a forward: " + ", ".join(
              f"{n} {c}" for n, c in emu_launches.items())
          + f"; AC5-5 at batch {EMULATED_BATCH}, kernel route vs plain route: "
          f"every conv within {emu_worst_ulp:.2f} ulps (bound {ULP_BOUND}), "
          f"logits {emu_logits_err:.3g} of the largest apart (bound "
          f"{EMU_LOGIT_BOUND:g}), argmax "
          f"agreement {100 * emu_agree:.1f}%")
    print("[resnet]   ms a forward (images/s), host clock around a synced "
          "call, median: " + "; ".join(
              f"{mode} {ms:.2f} ({1e3 * bsz / ms:.0f})"
              for mode, (ms, bsz) in timing.items()))
    print("[resnet]   one profiled forward (torch.profiler; host ms with "
          "the profiler on, device ms by kernel group, busy share): "
          + "; ".join(
              f"{mode} {pr['wall_ms']:.2f} ms, device {pr['device_ms']:.2f} "
              f"({100 * pr['busy_share']:.0f}%, {pr['kernels']} kernels: "
              + ", ".join(f"{g} {ms:.2f}" for g, ms in pr["groups"].items())
              + ")" for mode, pr in profiles.items()))
    return dict(launches=launches, conv=conv, max_ulp_err=worst_ulp,
                auto_launches=auto_launches, emu_max_ulp_err=emu_worst_ulp,
                emu_logits_rel_err=emu_logits_err, emu_agreement=emu_agree)


# [tune]: qwen3-4b's projections (K, N) at decode (M 4) and prefill (M 150),
# K2 at 512^2 and 8192^2, K3 at mamba2's and zamba2's 150-token layers
TUNE_M = (4, 150)
TUNE_BITWISE = {"medium": 512, "large": 8192}
TUNE_SSD = (("mamba2", 24, 64, 128), ("zamba2", 112, 64, 64))
TUNE_SSD_L = 150
# the [launch] phase's requests
LAUNCH_PROMPTS = (40, 77, 150, 23, 61)
LAUNCH_NEW = 8


def phase_tune(sess):
    """The autotuner on the card: every candidate of K1 (qwen3-4b's
    projections), K2 (elementwise) and K3 (both routes) timed by
    ``timed_ms``, each held against the static launch's output, the
    artifact written, loaded and activated; then a table of another device
    kind changes no call, and a tuned full-width standard generate gives
    the untuned tokens.  The table is dropped at the end, so every later
    phase runs the static launch shapes."""
    import numpy as np
    import torch

    from repro_torch.core.registry import afpm_config
    from repro_torch.kernels import afpm_bitwise as k2
    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.kernels import autotune, dispatch, ref

    kind = autotune.device_kind("cuda")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(22)
    ac55 = afpm_config("AC5-5")
    k1_calls = [(torch.randn((M, K), generator=gen, device="cuda").to(
                     torch.bfloat16),
                 torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5)
                for M in TUNE_M for K, N in SHAPES]
    k1_static = [k1.afpm_matmul(x, w, 3) for x, w in k1_calls]
    k2_ops = {b: [torch.randn((n, n), generator=gen, device="cuda")
                  for _ in range(2)] for b, n in TUNE_BITWISE.items()}
    k2_static = {b: k2.afpm_bitwise(x, y, ac55) for b, (x, y) in k2_ops.items()}
    k3_ops = [ssd_inputs(gen, 1, TUNE_SSD_L, h, p, n) for _, h, p, n in TUNE_SSD]
    k3_ref = [dispatch.ssd(*ops, chunk=dispatch.SCAN_CHUNKS[("torch", "small")],
                           backend="torch") for ops in k3_ops]
    worst = {"matmul": 0, "bitwise": 0, "ssd": 0.0}

    def measure(kernel, backend, bucket, block, size):
        """Device ms of every call of the key's shapes under ``block``
        (behind a spin, after the 64 MB flush), returned in us; each
        call's output held against the static launch's first."""
        if kernel == "matmul":
            fns = [lambda x=x, w=w: k1.afpm_matmul(x, w, 3, tile=block)
                   for x, w in k1_calls]
            for fn, want in zip(fns, k1_static):
                worst["matmul"] = max(worst["matmul"],
                                      bit_mismatches(fn(), want)[0])
        elif kernel == "bitwise":
            x, y = k2_ops[bucket]
            fns = [lambda: k2.afpm_bitwise(x, y, ac55, block)]
            worst["bitwise"] = max(worst["bitwise"],
                                   bit_mismatches(fns[0](), k2_static[bucket])[0])
        else:
            fns = [lambda ops=ops: dispatch.ssd(*ops, chunk=block,
                                                backend=backend)
                   for ops in k3_ops]
            for fn, want in zip(fns, k3_ref):
                worst["ssd"] = max(worst["ssd"], max_ulps(fn(), want))
        return 1e3 * sum(timed_ms(fn, 10, flush, device_only=True)
                         for fn in fns)

    t0 = time.perf_counter()
    table = autotune.TuningTable(device=kind, meta={
        "card": smi("name,power.limit"), "source": "chip_smoke.py [tune]"})
    for kernels, backends, buckets in (
            (("matmul",), ("hopper",), ("large",)),
            (("bitwise",), ("hopper",), tuple(TUNE_BITWISE)),
            (("ssd",), ("hopper", "torch"), ("small",))):
        part = autotune.sweep(measure, kernels=kernels, backends=backends,
                              buckets=buckets, device=kind)
        table.entries.update(part.entries)
    sweep_s = time.perf_counter() - t0
    if worst["matmul"] or worst["bitwise"]:
        raise AssertionError(f"[tune] a K1 / K2 candidate changed bits: "
                             f"{worst}")
    if worst["ssd"] > ULP_BOUND:
        raise AssertionError(f"[tune] a K3 candidate is {worst['ssd']:.1f} "
                             f"ulps from ssd_scan_chunked_ref")
    out = ROOT / "chiprun_out" / autotune.artifact_name(kind)
    table.save(str(out))
    loaded = autotune.activate(str(out))
    if loaded.to_dict() != json.loads(json.dumps(table.to_dict())) or \
            loaded.device != kind:
        raise AssertionError("[tune] the artifact did not load back")
    statics = {"matmul": autotune.MATMUL_STATIC, "bitwise": k2.STATIC_BLOCK}
    rows = {}
    for key, e in sorted(loaded.entries.items()):
        kernel, backend, bucket = key.split("/")
        static = statics.get(kernel, dispatch.SCAN_CHUNKS.get((backend, bucket)))
        label = autotune._block_label(static)
        rows[key] = dict(winner=e["block"], winner_us=e["median_us"],
                         static=label, static_us=e["candidates"][label],
                         candidates=e["candidates"])
    # the active table is the one every lookup now reads
    x, w = k1_calls[0]
    dev = x.device
    bucket = autotune.shape_bucket(*x.shape, w.shape[1])
    if k1.tuned_tile(*x.shape, w.shape[1], dev) != loaded.lookup(
            "matmul", "hopper", bucket) or bucket != "large":
        raise AssertionError("[tune] K1 does not read the active table")
    # a table of another device kind changes no call
    other = autotune.TuningTable(device="another_card")
    other.put("matmul", "hopper", "large", (16, 64, 1), 1.0)
    other.put("bitwise", "hopper", "large", (64, 1056), 1.0)
    other.put("ssd", "hopper", "small", 64, 1.0)
    autotune.activate(other)
    if (k1.tuned_tile(*x.shape, w.shape[1], dev) is not None
            or k2.launch_block(8192 * 8192, dev) != k2.STATIC_BLOCK
            or dispatch.scan_chunk("hopper", TUNE_SSD_L, dev)
            != dispatch.SCAN_CHUNKS[("hopper", "small")]
            or bit_mismatches(k1.afpm_matmul(x, w, 3), k1_static[0])[0]):
        raise AssertionError("[tune] a table of another device kind applied")
    # a full-width standard generate under the table == untuned
    autotune.deactivate()
    rng = np.random.default_rng(22)
    prompts = rng.integers(0, sess.config.vocab, (2, 40))
    std = sess.replace(policy="segmented3")
    k1.afpm_matmul.launches = 0
    plain = std.generate(prompts=prompts, gen_len=16).tokens
    n_plain = k1.afpm_matmul.launches
    tuned_sess = std.replace(tune=str(out))
    if autotune.active_source() != str(out):
        raise AssertionError("[tune] Session(tune=) did not activate")
    k1.afpm_matmul.launches = 0
    tuned = tuned_sess.generate(prompts=prompts, gen_len=16).tokens
    n_tuned = k1.afpm_matmul.launches
    autotune.deactivate()
    if not np.array_equal(tuned, plain) or n_tuned != n_plain or not n_plain:
        raise AssertionError(f"[tune] tuned generate {tuned.tolist()} "
                             f"({n_tuned} launches) != untuned "
                             f"{plain.tolist()} ({n_plain})")
    del k1_calls, k2_ops, k3_ops, flush
    torch.cuda.empty_cache()
    print(f"[tune] {kind}: {len(rows)} keys swept in {sweep_s:.1f} s -> "
          f"{out.relative_to(ROOT)} (loaded back, activated); every K1 and "
          f"K2 candidate == the static launch bit for bit, K3 candidates "
          f"within {worst['ssd']:.2f} ulps of ssd_scan_chunked_ref; a table "
          f"of another device kind changed no call; Session(tune=).generate "
          f"under standard == untuned ({n_tuned} K1 launches each)")
    for key, r in rows.items():
        print(f"[tune]   {key}: winner {autotune._block_label(r['winner'])} "
              f"{r['winner_us']:.2f} us, static {r['static']} "
              f"{r['static_us']:.2f} us (sum over the key's calls)")
    return dict(keys=rows, artifact=str(out.relative_to(ROOT)),
                sweep_s=sweep_s, k3_max_ulps=worst["ssd"])


def phase_launch(sess):
    """``ContinuousBatcher`` (2 slots) serves 5 requests through
    full-width qwen3-4b under segmented3 on [serve]'s weights: every
    request completes, K1 runs, and one request's tokens equal a manual
    greedy loop's."""
    import numpy as np
    import torch

    from repro_torch.kernels import afpm_matmul as k1
    from repro_torch.launch import steps
    from repro_torch.launch.scheduler import ContinuousBatcher, Request

    std = sess.replace(policy="segmented3")
    cfg, params = std.config, std.params
    max_len = 256
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    prefill_fn = lambda toks: prefill(params, {"tokens": toks})
    decode_fn = lambda tok, st, pos: decode(params, st, tok, pos)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in LAUNCH_PROMPTS]
    b = ContinuousBatcher(2, prefill_fn, decode_fn, max_len)
    for uid, pr in enumerate(prompts):
        b.submit(Request(uid=uid, prompt=pr, max_new_tokens=LAUNCH_NEW))
    k1.afpm_matmul.launches = 0
    t0 = time.perf_counter()
    done, ticks = b.run_to_completion()
    run_s = time.perf_counter() - t0
    launches = k1.afpm_matmul.launches
    if sorted(r.uid for r in done) != list(range(len(prompts))) or any(
            len(r.generated) != LAUNCH_NEW for r in done):
        raise AssertionError(f"[launch] requests did not complete: "
                             f"{[(r.uid, len(r.generated)) for r in done]}")
    forwards = len(prompts) * LAUNCH_NEW   # a prefill + 7 decode steps each
    if launches != (7 * cfg.n_layers + 1) * forwards:
        raise AssertionError(f"[launch] {launches} K1 launches, expected "
                             f"{7 * cfg.n_layers + 1} x {forwards} forwards")
    # request 2 by hand: the manual greedy loop
    with torch.inference_mode():
        logits, state = prefill_fn(torch.as_tensor(prompts[2], device="cuda")[None])
        want = [int(logits[0, -1].argmax())]
        for i in range(LAUNCH_NEW - 1):
            tok = torch.tensor([[want[-1]]], device="cuda")
            logits, state = decode_fn(tok, state, len(prompts[2]) + i)
            want.append(int(logits[0, -1].argmax()))
    got = next(r for r in done if r.uid == 2).generated
    if got != want:
        raise AssertionError(f"[launch] request 2: batcher {got} != manual "
                             f"greedy loop {want}")
    print(f"[launch] ContinuousBatcher, 2 slots: {len(prompts)} requests "
          f"(prompts {LAUNCH_PROMPTS}) x {LAUNCH_NEW} tokens through "
          f"full-width qwen3-4b under segmented3 in {ticks} ticks, "
          f"{run_s:.2f} s; afpm_matmul launches {launches} = "
          f"{7 * cfg.n_layers} x {forwards} forwards; request 2 == the "
          f"manual greedy loop")
    return dict(ticks=ticks, run_s=run_s, k1=launches)


#: the sharded counts of [dryrun] beside qwen3-4b's: expert parallelism on
#: the fake group (its all-to-alls) on the 16 x 16 mesh
DRYRUN_GIANTS = (("llama4-maverick-400b-a17b", "train_4k"),
                 ("deepseek-v3-671b", "prefill_32k"))
#: the JAX package's dry-run of the same cells (``repro.launch.dryrun.
#: lower_cell`` on a CPU, jax 0.9.0): per-chip FLOPs, peak estimate bytes
#: and collective bytes by kind, kept as constants (this script imports no
#: JAX) to print beside the card's count
DRYRUN_JAX = {
    "qwen3-4b train_4k 16x16": (191291937783808.0, 14714858496, {
        "all-gather": 284059500544, "all-reduce": 152925499552,
        "all-to-all": 17003708416, "collective-permute": 7493615616}),
    "qwen3-4b train_4k 2x16x16": (97239133323264.0, 13610200064, {
        "all-gather": 198839238656, "all-reduce": 79239966880,
        "all-to-all": 7257194496, "collective-permute": 4135763968}),
    "qwen3-4b prefill_32k 16x16": (108929057800192.0, 5039790264, {
        "all-gather": 47307292672, "all-reduce": 48318402560,
        "all-to-all": 2415919104, "collective-permute": 20480}),
    "qwen3-4b prefill_32k 2x16x16": (54464528900096.0, 3791414360, {
        "all-gather": 25564020736, "all-reduce": 24159201280,
        "all-to-all": 1207959552, "collective-permute": 10240}),
    "qwen3-4b decode_32k 16x16": (13685948416.0, 9789140436, {
        "all-gather": 7815168, "all-reduce": 15492224,
        "collective-permute": 73728}),
    "qwen3-4b decode_32k 2x16x16": (6842974208.0, 5493964868, {
        "all-gather": 3907584, "all-reduce": 7746112,
        "collective-permute": 36864}),
    "llama4-maverick-400b-a17b train_4k 16x16": (
        2112686359838720.0, 39152961480, {
            "all-gather": 2948621180928, "all-reduce": 1230490791668,
            "all-to-all": 24159191040, "collective-permute": 50081845248}),
    "deepseek-v3-671b prefill_32k 16x16": (1139130248396800.0, 37185061368, {
        "all-gather": 300227231744, "all-reduce": 229243936768,
        "all-to-all": 168980119552, "collective-permute": 57344}),
}
#: the port's count of the same cells over CUDA-type fake ranks on a CPU
#: (``launch.dryrun.lower_session_cell``, torch 2.13): per-chip FLOPs.
#: Every product's operand layout is chosen before the call, so the
#: card's torch must count the same
DRYRUN_CPU_FLOPS = {
    "qwen3-4b train_4k 16x16": 164039833419776.0,
    "qwen3-4b train_4k 2x16x16": 82019916709888.0,
    "qwen3-4b prefill_32k 16x16": 108929057800192.0,
    "qwen3-4b prefill_32k 2x16x16": 54464528900096.0,
    "qwen3-4b decode_32k 16x16": 13685948416.0,
    "qwen3-4b decode_32k 2x16x16": 6842974208.0,
    "llama4-maverick-400b-a17b train_4k 16x16": 1658941855498240.0,
    "deepseek-v3-671b prefill_32k 16x16": 1139130248396800.0,
}


def phase_dryrun(train):
    """The dry-run CLI for qwen3-4b at every shape on both production
    meshes, and for llama4's train_4k and deepseek-v3's prefill_32k on
    16 x 16 (one subprocess a cell, all at once; each counts the placed
    step over a fake group of 256 or 512 CUDA ranks: one chip's peak and
    collective bytes), each sharded cell printed beside the JAX package's
    figures (:data:`DRYRUN_JAX`), its FLOPs equal to a CPU's count of the
    same tree (:data:`DRYRUN_CPU_FLOPS`), qwen3-4b train_4k's peak under
    the card's memory on both meshes; then at a 1 x 1 mesh the dry-run of
    [train-qwen3]'s step (8 x 128 tokens, AdamW): its argument bytes ==
    the bytes of the tensors that phase's step took, and its peak
    estimate beside that phase's measured peak."""
    import torch

    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.session import Session

    out_dir = ROOT / "chiprun_out" / "dryrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells = {("qwen3-4b", s): ("16x16", "2x16x16") for s in specs.SHAPES}
    cells.update({c: ("16x16",) for c in DRYRUN_GIANTS})
    t0 = time.perf_counter()
    procs = {(a, s): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", s, *(["--both-meshes"] if len(tags) > 1 else []),
         "--out-dir", str(out_dir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for (a, s), tags in cells.items()}
    try:
        logs = {c: p.communicate(timeout=600)[0] for c, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    recs = {}
    for (a, s), p in procs.items():
        for tag in cells[(a, s)]:
            path = out_dir / f"{a}__{s}__{tag}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            recs[(a, s, tag)] = rec
            st = rec.get("status", "missing")
            if st != "ok" and not st.startswith("skipped"):
                raise AssertionError(f"[dryrun] {a} {s} {tag}: {st}: "
                                     f"{rec.get('error')}\n"
                                     f"{logs[(a, s)][-2000:]}")
        if p.returncode != 0:
            raise AssertionError(f"[dryrun] {a} {s} exited {p.returncode}: "
                                 f"{logs[(a, s)][-2000:]}")
    one = dryrun.lower_session_cell(
        Session("qwen3-4b", reduced=False),
        dict(kind="train", seq=TRAIN_SEQ, batch=TRAIN_BATCH),
        mesh=Mesh((1, 1), ("data", "model")))
    mem = one["memory"]
    if mem["argument_bytes"] != train["step_bytes"]:
        raise AssertionError(f"[dryrun] 1 x 1 argument_bytes "
                             f"{mem['argument_bytes']} != [train-qwen3]'s "
                             f"step tensors {train['step_bytes']}")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    for (a, s, tag), rec in recs.items():
        if rec["status"] == "ok":
            r, m = rec["roofline"], rec["memory"]
            # a sharded mesh counts the placed step over CUDA ranks: one
            # chip's peak and its collectives
            if not rec.get("sharded") or rec.get("ranks") != "cuda" \
                    or r["collective_by_kind"] is None \
                    or r["t_collective_s"] is None:
                raise AssertionError(f"[dryrun] {a} {s} {tag}: no sharded "
                                     f"peak or collective term: {m} {r}")
            cell = f"{a} {s} {tag}"
            flops, peak = r["hlo_flops_per_chip"], m["peak_estimate_bytes"]
            # the placed training step fits the card (the reference's plan
            # needs 14.7 GB a chip)
            if s == "train_4k" and a == "qwen3-4b" and peak >= card_bytes:
                raise AssertionError(f"[dryrun] {cell}: peak/chip {peak} "
                                     f">= the card's {card_bytes} bytes")
            if flops != DRYRUN_CPU_FLOPS[cell]:
                raise AssertionError(f"[dryrun] {cell}: {flops!r} FLOP/chip "
                                     f"on the card, {DRYRUN_CPU_FLOPS[cell]!r}"
                                     f" counted on a CPU")
            jf, jpeak, jcoll = DRYRUN_JAX[cell]

            def kinds(by_kind):
                return ", ".join(f"{k} {v / 1e9:.4g}"
                                 for k, v in sorted(by_kind.items()))
            print(f"[dryrun]   {cell}: args/chip "
                  f"{m['argument_bytes'] / 1e9:.3f} GB, peak/chip "
                  f"{peak / 1e9:.3f} GB (temp {m['temp_bytes'] / 1e9:.3f}; "
                  f"JAX {jpeak / 1e9:.3f}), {flops:.4g} FLOP/chip (JAX "
                  f"{jf:.4g}, x{flops / jf:.3f}; == the CPU count), "
                  f"collectives/chip {r['collective_bytes_per_chip'] / 1e9:.4g}"
                  f" GB ({kinds(r['collective_by_kind'])}; JAX "
                  f"{sum(jcoll.values()) / 1e9:.4g}: {kinds(jcoll)}), "
                  f"t_compute {r['t_compute_s'] * 1e3:.4g} ms, t_memory "
                  f"{r['t_memory_s'] * 1e3:.4g} ms, t_collective "
                  f"{r['t_collective_s'] * 1e3:.4g} ms ({r['dominant']}), "
                  f"counted in {rec['count_s']} s ({rec['counted_ops']} ops)")
        else:
            print(f"[dryrun]   {a} {s} {tag}: {rec['status']}")
    print(f"[dryrun] qwen3-4b x {len(specs.SHAPES)} shapes x 2 meshes and "
          f"{', '.join(f'{a} {s}' for a, s in DRYRUN_GIANTS)} on 16x16 in "
          f"{wall_s:.1f} s (every record ok or skipped, records -> "
          f"{out_dir.relative_to(ROOT)}); 1 x 1 mesh, [train-qwen3]'s step "
          f"({TRAIN_BATCH} x {TRAIN_SEQ}, AdamW): argument_bytes "
          f"{mem['argument_bytes']} == the step's tensors' bytes; peak "
          f"estimate {mem['peak_estimate_bytes'] / 1e9:.2f} GB (temp "
          f"{mem['temp_bytes'] / 1e9:.2f} GB) beside the measured "
          f"{train['peak_gb']:.2f} GB (max_memory_allocated); counted in "
          f"{one['count_s']} s")
    return dict(wall_s=wall_s, one_by_one=mem, records={
        f"{a} {s} {tag}": rec for (a, s, tag), rec in recs.items()})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    phase_device()
    k = phase_kernel(peaks)
    launches, serve_fused, qwen3, probe = phase_serve()
    tu = phase_tune(qwen3)
    la = phase_launch(qwen3)
    del qwen3
    torch.cuda.empty_cache()
    da = phase_decode_attention(peaks)
    b = phase_bitwise(peaks)
    e = phase_emulated(peaks)
    torch.cuda.empty_cache()
    b_launches = phase_table3()
    torch.cuda.empty_cache()
    c = phase_ssd(peaks, k["launch_floor_ms"])
    c_launches = phase_mamba2()
    torch.cuda.empty_cache()
    z = phase_zamba2()
    torch.cuda.empty_cache()
    phase_cli()
    w = phase_whisper()
    torch.cuda.empty_cache()
    g2 = phase_gemma2()
    torch.cuda.empty_cache()
    dz = phase_dense_zoo()
    torch.cuda.empty_cache()
    qv = phase_qwen2_vl()
    torch.cuda.empty_cache()
    l4 = phase_llama4()
    torch.cuda.empty_cache()
    ds, ds_sess = phase_deepseek(peaks)
    torch.cuda.empty_cache()
    dd = phase_dist(ds_sess, peaks)
    del ds_sess
    torch.cuda.empty_cache()
    pl = phase_placed()
    (ROOT / "chiprun_out" / "chip_smoke_invariance.json").write_text(
        json.dumps({"card": smi("name,power.limit"), "qwen3-4b": probe,
                    "zamba2-7b": {"decode_row": z["decode_row"]},
                    "deepseek-v3-671b": {"decode_row": ds["decode_row"],
                                         "router": ds["router"]}}, indent=1))
    (ROOT / "chiprun_out" / "chip_smoke_giants.json").write_text(json.dumps(
        {"card": smi("name,power.limit"), "qwen2-vl-72b": qv,
         "llama4-maverick-400b-a17b": l4, "deepseek-v3-671b": ds,
         "gemma3_engine": dz["gemma3-12b"]["engine"], "dist": dd,
         "placed": pl}, indent=1))
    tg = phase_train_grad()
    tq = phase_train_qwen3()
    dr = phase_dryrun(tq)
    (ROOT / "chiprun_out" / "chip_smoke_launch.json").write_text(json.dumps(
        {"card": smi("name,power.limit"), "tune": tu, "launch": la,
         "dryrun": dr}, indent=1))
    tm = phase_train_mamba2()
    tz = phase_train_zamba2()
    tl = phase_train_llama4()
    tds = phase_train_deepseek()
    dense = {"gemma2-9b": phase_train_gemma2(),
             "gemma3-12b": phase_train_gemma3(),
             "minitron-8b": phase_train_minitron(),
             "qwen2-vl-72b": phase_train_qwen2_vl()}
    tr = phase_train_resnet()
    (ROOT / "chiprun_out" / "chip_smoke_train.json").write_text(json.dumps(
        {"card": smi("name,power.limit"), "train_grad": tg, "qwen3": tq,
         "mamba2": tm, "zamba2-7b": tz, "llama4-maverick-400b-a17b": tl,
         "deepseek-v3-671b": tds, **dense, "resnet": {k: tr[k] for k in (
             "rows", "seg", "train_s", "emu_launches", "ac55_kernel_s",
             "ac55_plain_s", "ac55_logits_rel_err", "acl5_vs_ac55_rel_err")}},
        indent=1))
    torch.cuda.empty_cache()
    r = phase_resnet(peaks, tr)
    print(json.dumps({"kernels": [{
        "name": "afpm_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/afpm_matmul.cu",
        "replaces": "src/repro/kernels/afpm_matmul.py:94",
        "launches": launches,
        "max_abs_err": k["max_abs_err"], "max_ulp_err": k["max_ulp_err"],
        "ms": k["kernel_ms"], "kernel_ms": k["kernel_ms"],
        "kernel_call_ms": k["kernel_call_ms"], "host_us": k["host_us"],
        "plain_ms": k["plain_ms"], "library_ms": k["library_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "resnet_launches": r["launches"], "resnet_max_ulp_err": r["max_ulp_err"],
        "resnet_conv": r["conv"], "train_grad_launches": tg["k1"],
        "train_step_launches": {"zamba2-7b": tz["k1"],
                                "llama4-maverick-400b-a17b": tl["k1"],
                                "deepseek-v3-671b": tds["k1"],
                                **{a: v["k1"] for a, v in dense.items()}},
        "zamba2_launches": z["k1"], "zamba2_step": k["zamba2_step"],
        "whisper_launches": w["k1"], "gemma2_launches": g2["k1"],
        "dense_zoo_launches": dz["k1"],
        "gemma3_engine_launches": dz["engine_k1"],
        "qwen2_vl_launches": qv["k1"], "llama4_launches": l4["k1"],
        "deepseek_launches": ds["k1"], "ep_launches": dd["ep_launches"],
        "placed_launches": {t: v["k1"] for t, v in pl["tiers"].items()},
        "qwen2_vl_layer": k["qwen2-vl-72b_layer"],
        "llama4_expert": k["llama4_expert"],
        "deepseek_expert": k["deepseek_expert"],
        "whisper_cross_kv": k["whisper_cross_kv"],
        "gemma2_layer": k["gemma2-9b_layer"],
        "gemma3_layer": k["gemma3-12b_layer"],
        "minitron_layer": k["minitron-8b_layer"],
        "backward": "plain (repro_torch/kernels/autograd.py)"}, {
        "name": "afpm_bitwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/afpm_bitwise.cu",
        "replaces": "src/repro/kernels/afpm_bitwise.py:29",
        "launches": b_launches,
        "max_abs_err": b["max_abs_err"], "mismatched_bits": b["mismatched_bits"],
        "shape": b["shape"], "design": b["design"],
        "ms": b["kernel_ms"], "kernel_ms": b["kernel_ms"],
        "plain_ms": b["plain_ms"], "library_ms": None,
        "torch_mul_ms": b["torch_mul_ms"],
        "ops_per_element": b["ops_per_element"],
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}, {
        "name": "afpm_emulated_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/afpm_bitwise.cu",
        "replaces": "src/repro/kernels/afpm_bitwise.py:29",
        "entry_of": "afpm_bitwise", "launches": tr["emu_launches"],
        "max_abs_err": e["max_abs_err"], "max_ulp_err": e["max_ulp_err"],
        "shape": [e["M"], e["K"], e["N"]], "design": e["design"],
        "ms": e["kernel_ms"], "kernel_ms": e["kernel_ms"],
        "plain_ms": e["plain_ms"], "library_ms": None,
        "function_ops_per_product": e["function_ops_per_product"],
        "sass_per_product": e["sass_per_product"],
        "sass_issue_ms": e["sass_issue_ms"], "sass_pipe_ms": e["sass_pipe_ms"],
        "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
        "resnet_max_ulp_err": r["emu_max_ulp_err"],
        "resnet_logits_rel_err": r["emu_logits_rel_err"],
        "table4_logits_rel_err": tr["ac55_logits_rel_err"],
        "table4_ac55_s": tr["ac55_kernel_s"],
        "table4_ac55_plain_s": tr["ac55_plain_s"],
        "backward": "plain straight-through (repro_torch/kernels/autograd.py)"}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:77",
        "launches": c_launches,
        "max_abs_err": c["max_abs_err"], "max_ulp_err": c["max_ulp_err"],
        "batch": c["batch"], "L": c["L"], "L_padded": c["L_padded"],
        "ms": c["kernel_ms"], "kernel_ms": c["kernel_ms"],
        "plain_ms": c["plain_ms"], "library_ms": None,
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "train_grad_launches": tg["k3"], "train_mamba2_launches": tm["k3"],
        "train_zamba2_step_launches": tz["k3"],
        "zamba2_launches": z["k3"], "zamba2": c["zamba2"],
        "placed_launches": pl["mamba2"]["k3"],
        "backward": "plain (repro_torch/kernels/autograd.py)"}, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": None, "launches": serve_fused,
        "ms": da[0]["kernel_ms"], "kernel_ms": da[0]["kernel_ms"],
        "plain_ms": da[0]["plain_ms"], "library_ms": None,
        "bound_ms": da[0]["bound_ms"], "bound_by": "bytes", "shapes": da,
        "backward": None}]}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
