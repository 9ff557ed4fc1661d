#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (k_diffusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (the kernel phases one per kernel and shape):
1. device: needs a CUDA device; prints nvidia-smi's name and power limit;
2. build: compiles every kernel from csrc/ with nvcc, and prints the
   registers and spills of the attention kernels, the forward (K3, K13)
   and the backward's two (K9, K14) at each head dim, of the neighborhood
   forward of K2 and K11 and the backward's two of K7 and K12 (the
   neighborhood geometry on the same forward and backward; K11's and K12's
   with v through its own strides), of the forwards K1 and K4, of K6's and
   K10's (csrc/gemm.cuh's dxn and dW kernels and each one's first kernel),
   of K5's cluster kernel and of K15's (csrc/na_proj.cuh, head dims 32 and
   64), of K8's (bf16 and float32 outputs), and of the float32 forms
   (csrc/attn_tf32.cuh's dense kernels, csrc/na_tf32.cuh's, also at head
   dim 128, csrc/na_proj_tf32.cuh's, the TF32 GEMM core's); none may spill
   or be missing;
3. kernels: each forward kernel K1-K5 against its plain PyTorch version at
   the flagship shapes (batch 8, bfloat16), with the bound stated, and the
   kernel's, the plain version's and, where one PyTorch call computes the
   same function, that call's times from CUDA events (K5 with the model's
   float32 weights; uncounted, with bfloat16 weights and at batch 32);
   a profile showing that each K5 call runs one device kernel and nothing
   else, at the flagship's width and at the ViT's (d 768, d_ff 2048, batch
   64, streamed); then K3's training forward, out and logsumexp, against
   the plain versions;
4. forward: the flagship HDiT (configs/config_oxford_flowers.json, seeded
   weights, zero-init tensors filled with noise) at batch 2 in bfloat16 on
   the card against the same weights in float32 on the CPU (plain versions);
5. sampling: 50-step DPM++(2M) at batch 8 on the card; the output must be
   finite and every kernel's launch count must match the model's layout;
6. backward kernels: K6-K10 against their plain versions (autograd through
   the forward's plain version; for K8 the plain overlap-add of plain
   per-tile halo partials) at the flagship training shapes, batch 8, as in
   phase 3, and K1 and K6 at config_512_hdit's 16 x 16 x 768 level, K4 and
   K10 at its 32 x 32 x 512 level, K4 at its 16 x 16 x 768 level and K2 at
   its 128 x 128 x 128 NA level (the largest NA grid a shipped config
   runs), outside the sums; then K8's op path (one call at each NA level,
   with launch counts: no model path runs K8); then, on one packed input,
   K3 against K13 (out and logsumexp) and K9 against K14 (dq, dk, dv) bit
   for bit: each pair runs one wgmma design; at both NA levels K2 against
   K11 (out and logsumexp) bit for bit, the same wgmma forward, K7
   against K12 (dq, dk, dv) bit for bit, the same wgmma backward, and each
   against a rerun of itself; K10 at d = 640 raises ValueError naming its
   limit of 576 before any launch;
7. gradient parity: one training step's loss and full parameter gradient,
   the flagship at batch 2 in bfloat16 on the card against the same
   weights, reals, noise and sigmas in float32 on the CPU, dropout off;
8. training: the flagship config as it is (dropout on) at batch 32 on
   synthetic seeded reals, a few warm-up steps then 20 timed steps through
   training.make_train_step; losses finite, params and EMA moved, and
   every kernel's launch count per step equal to the model's layout. Then
   3 more steps under torch.profiler: the device time by kernel;
9. flash kernels: K13 and K14 against their plain versions at the U-Net's
   shapes (configs/config_cifar10.json, batch 64: 16 x 16 and 8 x 8 levels,
   q, k, v strided views of one projection) and K13 at the mnist HDiT's
   (7 x 7 tokens, batch 8), as in phase 3; then K13's training forward, out
   and logsumexp, against the plain versions at the U-Net's shapes, at
   s in {1, 49, 65, 200} and at head dim 32;
10. U-Net forward: config_cifar10.json at full width, seeded weights with
   the zero-init tensors filled with noise, bfloat16 on the card at batch 2
   against float32 on the CPU, through the augment wrapper;
11. U-Net sampling: 50-step DPM++(2M) at batch 64, aug_cond zeros; launch
   counts exactly 16 flash per step and no other kernel;
12. U-Net training: the gradient of one step at batch 2 on the card against
   the CPU (dropout off), then the config as it is (dropout 0.05) at batch
   64 on seeded reals and aug_cond, 3 warm-up + 20 timed steps and a
   3-step profile, as in phases 7 and 8;
13. HDiT routed config: config_mnist_transformer.json (7 x 7 tokens, class
   conditioning) at batch 8 in bfloat16 on the card against float32 on the
   CPU; its global level goes to K13, not K3;
14. per-head NA kernels: K11 and K12 against their plain versions at the
   flagship's NA levels (batch 8, q and k contiguous, v a strided third of
   the projection, as the unfused prologue leaves them), then at head dims
   32 and 128 and at a level wider than K2 takes (12 heads of 64);
15. the fused epilogue K15 (na2d_packed_proj, csrc/na_proj.cuh) against
   its plain version at the flagship's NA levels, batch 8, and, counting no
   calls, at head dim 32 (8 x 64 x 64, 4 heads of 32) and at
   config_512_hdit's 128 x 128 x 128 NA level; K15 with w_out = I and skip
   = 0 against K2 bit for bit at both flagship levels; then its op path,
   forward and backward (K2 recompute, K7), with launch counts and the
   gradients against the plain version's, and K15 timed against the
   composition the model runs (K2, a matmul with w_out, the residual
   add);
16. the unfused training step: the flagship config as it is with
   KDT_TRAIN_FUSION=0 (for this phase only): gradient parity at batch 2 as
   in phase 7, then 3 + 20 steps at batch 32 and a profile as in phase 8,
   every NA level through K11/K12 and no K1/K2/K4/K6/K7/K8/K10;
17. head dim 32: K1/K6 and K13/K14 at configs/config_test_tiny.json's
   shapes against their plain versions, its forward at batch 8 and one
   step's gradient at batch 2 against float32 on the CPU;
18. default build: the flagship and the U-Net from make_model(config) with
   no dtype and no device compute in bfloat16 on the card and give a
   finite forward at batch 2; an explicit float32 there builds a float32
   model (both take float32 on the card);
19. condcache and the sampler suite, the flagship at batch 8: K1 and K4
   with their scale a (8, d) block of a (8, 7168) condcache row, read
   through its row stride, against their plain versions and bit for bit
   against the same kernel on the block's contiguous copy, both timed;
   the table's precompute (one K5 launch per schedule sigma); one denoiser
   call at three schedule sigmas, cached against uncached, bit for bit,
   with 12 K1, 8 K2, 4 K3, 12 K4 and no K5 a cached call; the card time a
   call with and without condcache (profiles); 50-step DPM++(2M), cached
   against uncached, bit for bit, with its launch counts; then each of the
   13 samplers as the sample entry point runs it (condcache under the
   schedule-point samplers): finite output, launch counts equal to its
   model calls x the layout (plus the table's K5 launches), samples/s;
20. the sample entry point: a flagship inference checkpoint saved in
   bfloat16, then the sample entry point (``k_diffusion_tpu_torch.sample``'s
   main with ``--sampler lms -n 8``) on it in-process on the card, which
   must write 8 PNGs; then the cifar10 U-Net the same way under dpmpp_2m
   (phase 21 runs the entry point as a process of its own);
21. the training entry point: the loader alone at batch 32 (images/s at
   1, 4 and 8 threads, the median and range of timed epochs after an
   untimed one, on 256 x 256 PNGs written by to_png, and at 1 thread on
   one batch of Paeth-filtered ones); ``python -m
   k_diffusion_tpu_torch.train`` as a subprocess on the
   flagship config with an imagefolder of 128 PNGs at 256 x 256, 6 steps
   at batch 32, checkpoints at 3 and 6, the state JSON and a demo grid at
   6; a second run in-process resumed mid-epoch from step 3 to 6, its params
   and EMA within relative L2 1e-3 of the first run's (bit-equal or not,
   printed); the flagship in-process for 26 steps with phase 8's launch
   counts, its images/s over steps 1-25 with and without the loader's
   waits beside phase 8's; config_test_tiny in-process with two
   microbatches and --gns (class dropout and the augmentation warp on the
   card) for 17 steps, whose profiler trace of steps 10-15 must hold no
   host-blocking call but the trainer's one synchronisation, and the
   cifar10 U-Net on raw CIFAR-10 batch files for 3 steps at batch 64, each
   with its launch counts per step; then convert_for_inference (in-process)
   on the flagship's checkpoint and ``python -m k_diffusion_tpu_torch.sample``
   on the result as a subprocess;
22. the rest of the model surface: (a) config_oxford_flowers_shifted_
   window.json at full width and depth: forward and gradient parity as in
   phases 4 and 7, 50-step DPM++(2M) at batch 8 (per call 12 K1, 4 K3, 12
   K4, 1 K5, no K2; the window attention's PyTorch ops by name in the
   profile), condcache cached against uncached bit for bit, 3 + 20
   training steps at batch 32 (also 12 K6, 4 K9, 8 K10 a step), then one
   step at batch 32 with dropout on without checkpointing and with it over
   every level and over level 0, on the flagship (bit-equal required) and
   on this config (relative L2 1e-3; bit-equality printed), peak memory
   of each, and the sample entry point on its bf16 checkpoint (8 PNGs);
   (b) the ViT at DiT-B/2's width and depth (12 layers, width 768, 256
   tokens): K5 at d 768 / d_ff 2048, batch 64, whose layer shares stream,
   and at the HDiT's 256 / 768 (resident), one launch and one device
   kernel a call; K13 and K14 at (64, 256, 12, 64) against their plain
   versions and SDPA; forward and gradient parity, 50-step DPM++(2M) at
   batch 64 (12 K13, 1 K5 a call), 3 + 20 training steps at batch 64 (12
   K13, 12 K14 a step) and a checkpointed step (24 K13); (c)
   config_cifar10.json with cross-attention on its attention levels
   (cross_cond_dim 768, 77-token sequences with seeded padding lengths)
   and the variance head: forward and DenoiserWithVariance gradient parity
   at batch 2, 50-step DPM++(2M) at batch 64 (16 K13 a call); (d) the
   flagship with loss_scales 3: one step's loss and gradient against the
   CPU.
23. the engine (``engine_phase``): each remat policy's flagship step
   against the plain step, 8-bit AdamW and SGD, CFG sampling, the
   likelihood, InceptionV3 on the card and FID/KID in the trainer;
24. data parallelism: (a) two ranks on the one card over gloo (two
   processes running this script with ``--dp-rank``; NCCL refuses two ranks
   on one device), the flagship at full width and depth on the fused
   training path, dropout 0, 16 images a rank, 3 steps, against one
   process at batch 32 with the same weights and global draws: the losses
   within 1e-3 relative; step 1's all-reduced gradient within 1e-2
   relative L2, tensor by tensor, of one process's gradient over the
   ranks' two blocks of rows (bit-equal tensors counted), and within 1e-2
   over all tensors of the batch-32 gradient (the worst tensor printed:
   the bf16 kernels split their sums by the batch); the ranks' params, EMA
   and gradients bit for bit equal, each rank's launch counts 3 steps of
   the layout (K1-K7, K9, K10) and no plain version called on a CUDA
   tensor but K5's backward (the VJP of its plain version, once a step);
   the step times of both, which measure no scaling (the two ranks share
   one card); (b) the trainer
   under ``python -m torch.distributed.run --standalone --nproc_per_node 1``
   (NCCL) on the flagship with a synthetic dataset and
   ``--checkpoint-format orbax``: 2 steps and a sharded save, then a second
   run (the entry point in-process) that resumes from the state pointer to
   step 4; each prints ``World: 1 process(es)``; that checkpoint loaded on
   the card, saved again
   sharded (async, the pointer moved after the commit) and loaded back
   through the pointer gives bit-equal model, EMA and optimizer state.
25. float32 compute on the card (``float32_phase``, ``--mixed-precision
   no``, the U-Net family): (a) the float32 forms of K13 and K14
   (csrc/attn_tf32.cuh's mma.sync forward, csrc/attn_tf32_bwd.cuh's TF32
   wgmma backward) against their plain versions in float32 with TF32 off,
   within 5e-3 x max|plain|, at the cifar10 U-Net's shapes at batch 64
   (its main path), config_mnist.json's 7 x 7 level and head dim 32; (c)
   their times beside the plain version's and SDPA's on the float32 inputs
   (TF32 on), the bound from TF32's 494.7 TFLOP/s, the backward's at each
   shape and on its path beside its earlier row (``f32_bwd_compare``, as
   phases 26 (a), 27 (a) and 28 (a) do for K9, K7 and K12 in float32), and
   K9-f32 = K14-f32 (dq, dk, dv) bit for bit on one packed input, a K14-f32
   rerun bit-equal; (b) on the same inputs each float32 kernel's error
   against float64 at most 1/4 of the bf16 kernel's; (d) the cifar10
   U-Net at batch 8 in float32 (TF32) and in bf16 on the card against
   float32 on the CPU, forward and gradient: the float32 errors at most
   1/4 of bf16's, launch counts in each dtype's kernels only; (e) 50-step
   DPM++(2M) and 3 + 20 training steps at batch 64 in float32 (16 float32
   K13 a call; 16 K13 and 16 K14 a step; no bf16 flash launch) beside
   phases 11 and 12, each profile also giving the float32 attention
   backward's share of a step's card time (as phases 26-28 do); (f) the
   trainer with --mixed-precision no on config_cifar10.json from seeded
   in-memory images: 4 steps with saves and a demo grid, then a resume
   from step 2 within 1e-3, with launch counts, both through the entry
   point in-process.
26. float32 compute on the card for the ViT and the HDiT without
   neighborhood-attention levels (``transformers_float32_phase``): (a) the
   float32 forms of K1, K4, K6, K10 (csrc/fused_qkv_f32.cu, geglu_f32.cu;
   the forwards on the TF32 mma.sync core csrc/gemm_tf32.cuh, the
   backwards on the TF32 wgmma core csrc/gemm_tf32_wg.cuh), K5 and K3/K9
   (csrc/attn_tf32.cuh)
   against their plain versions in float32 with TF32 off, within 5e-3 x
   max|plain|, at the shifted-window config's shapes (K1, K4 at batch 8 a
   call, K6, K10 at batch-8 step shapes, K3, K9 at 8 x 256 x 512), K5 at
   the HDiT's 8 x 256 and the ViT's 64 x 768, f 2048, and K1, K4, K6, K10
   at config_test_tiny's d 64 (head dim 32); (c) their times beside the
   plain version's, the TF32 bound's and, for K3/K9, SDPA's on the float32
   inputs, for K6/K10 their products alone as torch.matmul with TF32 on
   (``products_ms``), their reruns bit-equal and their time split by
   kernel; (b) on the same inputs each float32 kernel's error against
   float64 at most 1/4 of its bf16 form's, output by output; (d) the
   shifted-window config and the ViT at DiT-B/2 (a call and a step at
   batch 8 each) in float32 and in bf16 on the card against float32 on
   the CPU, forward and gradient: the float32 errors at most 1/4 of
   bf16's, launches in each dtype's kernels only; (e) 50-step DPM++(2M)
   and 3 + 20 training steps of each in float32 with launch counts; (f)
   the trainer with --mixed-precision no on config_cifar10_transformer.json
   as in phase 25 (f), its resume bit-equal; (g) the refusals that remain,
   each by name before any launch: float16 for the flagship with head dim
   128 at its neighborhood levels, K11 at head dim 128, K15
   (na2d_packed_proj) and K8's output.
27. float32 compute on the card for the neighborhood-attention configs
   (``na_float32_phase``; the flagship, config_512_hdit and
   config_256_p8_wide): (a) the float32 forms of K2 and K7 (channel-packed)
   and of K11 and K12 (per head, v strided), csrc/na_tf32.cuh (the
   backwards on csrc/attn_tf32_bwd.cuh's TF32 wgmma bodies), against
   their plain versions in float32 with TF32 off, within 5e-3 x
   max|plain|, at the flagship's NA levels (batch 8), K11 and K12 also at
   head dim 32 and K2 and K7 at config_512_hdit's 128 x 128 x 128 level,
   timed beside the plain versions, the TF32 bound and masked SDPA on
   float32 (TF32 on), and each against float64 at most 1/4 of its bf16
   form's error, output by output; (b) on one input at each flagship NA
   level K2-f32 = K11-f32 (out, lse) and K7-f32 = K12-f32 (dq, dk, dv)
   bit for bit, and a rerun of each bit-equal; (c) the flagship at batch 2
   in float32 and in bf16 on the card against the float32 CPU side of
   phases 4 and 7 (reused), forward and gradient: the float32 errors at
   most 1/4 of bf16's; (d) 50-step DPM++(2M) at batch 8 in float32 (12
   K1-f32, 8 K2-f32, 4 K3-f32, 12 K4-f32, 1 K5-f32 a call, no bf16 launch;
   also through condcache); (e) 3 + 20 training steps at batch 32, fused
   (also 12 K6-f32, 8 K7-f32, 4 K9-f32, 8 K10-f32 a step) and unfused
   (KDT_TRAIN_FUSION=0: 8 K11-f32 and 8 K12-f32), card time, peak memory
   and host-clock rates beside phases 5, 8 and 16's bf16; (f) the trainer
   with --mixed-precision no on config_oxford_flowers.json as in phase 26
   (f), its resume bit-equal; (g) config_512_hdit at 512 x 512, batch 2,
   in float32 and bf16 on the card from the same weights: a call, an
   unfused loss gradient and, in float32, a fused one, each dtype's
   launches only, float32 within 5e-2 of bf16 and its fused gradient
   within 1/4 of that distance of its unfused one; config_512_hdit cut to
   256 x 256 (batch 2, unfused) and config_256_p8_wide (batch 8, fused and
   unfused) as in (c) against float32 on the CPU, the float32 errors at
   most 1/4 of bf16's; each of the two as shipped (dropout on) 3 + 20
   float32 training steps (config_512_hdit at 8, config_256_p8_wide at
   32) with their launch counts.
28. the flagship with head dim 128 at its neighborhood levels
   (``na128_phase``; config_oxford_flowers.json with d_head 128 there, no
   config ships it: one head of 128 at 64 x 64, two at 32 x 32), whose NA
   levels take the plain prologue (``fused_qkv.takes``) and K11/K12 at
   head dim 128: (a) K11 and K12 at its NA levels (batch 8) in float32
   (csrc/na_tf32.cuh; the backward two warpgroups a block that split its
   products, csrc/attn_tf32_bwd.cuh) and bf16 (csrc/na_fwd.cuh,
   csrc/na_bwd.cuh on csrc/wgmma.cuh's tiles of two column halves)
   against their plain versions (float32: TF32 off, 5e-3), timed beside
   them, the bound and masked SDPA, the bf16 forms' times at each shape
   printed against masked SDPA's and their sums against the float32
   forms', the float32 forms against float64 within 1/4 of the bf16 forms'
   errors, output by output, and both dtypes rerun bit-equal; (b) K15-f32
   (csrc/na_proj_tf32.cuh) at one op call at each flagship NA level and
   at head dim 32 against its plain version and float64, with w_out = I
   and skip = 0 within 2^-10 of K2-f32 (head dim 64) or K11-f32 (32)
   element by element, and its op path forward and backward (K2-f32 and
   K7-f32 recompute) with launch counts; (c) K8-f32 at each flagship NA
   level and its op path; (d) the model at batch 2 in bf16 and float32
   from the same weights against float32 on the CPU, forward and gradient,
   float32's errors at most 1/4 of bf16's, launches in each dtype's
   kernels only (a call 4 K1, 8 K11, 4 K3, 12 K4, 1 K5: K1 at the global
   level only, no K2); (e) 50-step DPM++(2M) at batch 8, also through
   condcache, and 3 + 20 training steps at batch 32 in each dtype (also 4
   K6, 8 K12, 4 K9, 8 K10 a step; no K7), beside the flagship's; (f) the
   trainer with --mixed-precision no on it as in phase 27 (f), its resume
   bit-equal.

Each phase ends with a ``time:`` line (its seconds, and in all), the long
ones also each part of them, and the script with its total.

Each kernel line also gives the kernel's achieved TFLOP/s (the operations
its function needs over its time) and its time's share of the bound.

Then one JSON line of per-kernel results and last ``{"ok": true, "device":
{...}}``. A kernel's ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms``
are summed over its calls in one denoiser call (forward kernels) or one
training step (backward kernels) on its main path: the flagship at batch 8
for K1-K10 and, in the unfused step, K11 and K12; the U-Net at batch 64 for
K13 and K14, in bf16 and (``flash_f32``, ``flash_bwd_f32``) in float32;
the shifted-window config at batch 8 for the float32 forms of K1, K3-K6,
K9 and K10 (``*_f32``; K3 and K9 on K13's and K14's float32 bodies); the
flagship at batch 8 for the float32 forms of K2 and K7 and, in the unfused
step, of K11 and K12 (phase 27); the NA-128 flagship at batch 8 for K11
and K12 at head dim 128 in each dtype (``*_e128``, phase 28); one op call
at each flagship NA level for K15 and K8 and their float32 forms.
``launches`` is its count in that path's sampling (forward) or timed
training (backward) run, for K11 and K12 the unfused training run, for K15
and K8 and their float32 forms their op paths, for the ``*_f32`` forms of
phase 26 the shifted-window config's float32 runs, for those of phase 27
the flagship's float32 runs, for the ``*_e128`` ones the NA-128
flagship's runs in their dtype. Any
failure raises: exit code non-zero, no result line. Imports nothing of JAX.
"""

import collections
import contextlib
import copy
import json
import math
import os
import pickle
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config_oxford_flowers.json"
UNET_CONFIG = ROOT / "configs" / "config_cifar10.json"
MNIST_TRANSFORMER = ROOT / "configs" / "config_mnist_transformer.json"
TEST_TINY = ROOT / "configs" / "config_test_tiny.json"
SEED = 0
SAMPLE_BATCH, STEPS = 8, 50
TRAIN_BATCH, WARMUP_STEPS, TRAIN_STEPS = 32, 3, 20
# the U-Net's sampling and training batch: the defaults of sample.py and
# train.py
UNET_BATCH = 64
# a kernel may differ from its plain version by a few bf16 roundings of its
# output: the plain version rounds intermediates (the raw projection, the
# GEGLU halves, the residual stream, the attention logits) to bf16 where the
# kernel keeps f32
KERNEL_REL_BOUND = 3e-2
# the bf16 model on the card against the f32 model on the CPU, relative L2
# error of the denoiser output: ~100 bf16 roundings in sequence
FORWARD_REL_BOUND = 5e-2
# the same for the full parameter gradient of one training step, relative
# L2 of the flattened gradient: the forward's bound
GRAD_REL_BOUND = 5e-2
# published dense peaks of one H100 SXM at its full 700 W limit: bf16 tensor
# cores, and device memory
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# one kernel at one shape: ``calls`` per denoiser call or training step on
# its main path; ``fn`` the kernel's wrapper, ``plain`` its plain version,
# each returning a tensor or a tuple of tensors; ``flops`` the operations
# the function needs at this shape and ``inputs`` the tensors it reads, for
# the bound; ``timed`` what is timed and counted as the kernel where that
# is not ``fn``; ``library`` one PyTorch call that computes the same
# function, timed as a yardstick and used nowhere in the port; ``rel_bound``
# the kernel's error bound against the plain version (x its max|plain|) and
# ``peak`` the card's peak rate for the operations' type; ``products``,
# where given, the kernel's matrix products alone as torch.matmul calls, a
# second yardstick the port never calls
Case = collections.namedtuple(
    "Case", "name label calls fn plain flops inputs timed library rel_bound "
    "peak products",
    defaults=(None, None, KERNEL_REL_BOUND, PEAK_BF16_FLOPS, None))


class Clock:
    """The run's ``time:`` lines: ``part`` prints the seconds since the
    last mark, ``lap`` a phase's seconds and the total so far."""

    def __init__(self):
        self.start = self.phase = self.last = time.perf_counter()

    def part(self, what):
        now = time.perf_counter()
        print(f"time: {what} {now - self.last:.1f} s", flush=True)
        self.last = now

    def lap(self, what):
        now = time.perf_counter()
        print(f"time: {what} {now - self.phase:.1f} s, total "
              f"{now - self.start:.1f} s", flush=True)
        self.phase = self.last = now


CLOCK = Clock()


def device_ms(fn, reps):
    """Median over 5 trials of the mean device time of ``fn`` in ms, from
    CUDA events. Each trial first queues a sleep on the card so that the
    host enqueues all ``reps`` calls before the card reaches them: the
    events then time the card, not the host's launch rate. The sleep is
    4x the host time of ``reps`` untimed calls (as the first took), at
    2 GHz, within 5e6 and 5e7 cycles."""
    host = time.perf_counter()
    fn()
    host = time.perf_counter() - host
    torch.cuda.synchronize()
    cycles = int(min(5e7, max(5e6, 4 * reps * host * 2e9)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    trials = []
    for _ in range(5):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        trials.append(start.elapsed_time(end) / reps)
    return statistics.median(trials)


def check_close(name, got, want, bound):
    """Max abs error of got against want; raises if it exceeds bound times
    want's max magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    limit = bound * want.float().abs().max().item()
    if not err <= limit:
        raise AssertionError(f"{name}: max abs err {err:.3e} > {limit:.3e}")
    return err, limit


def tensors(*items):
    """The tensors among ``items``, lists and tuples opened."""
    out = []
    for item in items:
        if isinstance(item, torch.Tensor):
            out.append(item)
        elif isinstance(item, (list, tuple)):
            out.extend(tensors(*item))
    return out


def bound_ms(flops, inputs, outputs, peak=PEAK_BF16_FLOPS):
    """(ms from the operations at the ``peak`` rate, by default bf16's, ms
    from the bytes at the memory rate): each input read once, each output
    written once."""
    moved = sum(t.numel() * t.element_size()
                for t in tensors(inputs, outputs))
    return flops / peak * 1e3, moved / PEAK_BYTES_PER_S * 1e3


def lecun(shape, g, dev):
    return (torch.randn(shape, generator=g) / shape[0] ** 0.5).to(
        dev, torch.bfloat16)


def heads_view(t, heads):
    """(b, s, heads * 64) -> the (b, heads, s, 64) view SDPA takes."""
    b, s, c = t.shape
    return t.reshape(b, s, heads, c // heads).transpose(1, 2)


def sdpa(q, k, v, scale, mask=None):
    """The library yardstick: q, k, v (b, s, heads, e) as (b, heads, s, e)
    views; ``mask`` an (s, s) additive bias."""
    return F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), attn_mask=mask, scale=scale)


def sdpa_backward(q, k, v, dout, scale, mask=None):
    """The library yardstick of a backward: SDPA's backward alone, from a
    forward graph built once. Its gradients are (b, heads, s, e)."""
    with torch.enable_grad():
        leaves = [t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             scale=scale)
    cot = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, cot, retain_graph=True)


def na_library(qkv, dout=None, plain=None):
    """The yardstick of K2 and K11, or with ``dout`` of K7 and K12:
    SDPA, or its backward alone, on the (b, hw, heads, e) views of (b, h, w,
    heads, e) q, k, v, each query's clamped 7 x 7 window a dense (hw, hw)
    additive bf16 mask (the plain version's): hw / 49 times the kernels'
    work. Held once against the plain version here (``plain``, the forward's
    on (b, h, w, heads, e) maps, where not ``na2d_reference``); returns the
    timed callable."""
    from k_diffusion_tpu_torch.ops.attention import neighborhood_mask_2d
    from k_diffusion_tpu_torch.ops.kernels import na2d

    b, h, w, heads, e = qkv[0].shape
    dev = qkv[0].device
    mask = torch.zeros((h * w, h * w), device=dev, dtype=qkv[0].dtype)
    mask.masked_fill_(~neighborhood_mask_2d(h, w, 7, dev), float("-inf"))
    flat = [t.reshape(b, h * w, heads, e) for t in qkv]
    unflat = lambda t: t.transpose(1, 2).reshape(b, h, w, heads, e)
    label = f"{b}x{h}x{w}x{heads}x{e}"
    if dout is None:
        call = lambda: sdpa(*flat, 1.0, mask)
        check_close(f"masked SDPA {label}", unflat(call()),
                    (plain or na2d.na2d_reference)(*qkv, 7), KERNEL_REL_BOUND)
        return call
    call = sdpa_backward(*flat, dout.reshape(flat[0].shape), 1.0, mask)
    wants = na2d.heads_reference_backward(*qkv, dout, 7)
    for name, got, want in zip("qkv", call(), wants):
        check_close(f"masked SDPA backward d{name} {label}", unflat(got), want,
                    KERNEL_REL_BOUND)
    return call


def kernel_cases(dev):
    """The forward kernels at the flagship eval shapes, batch 8. Inputs are
    seeded."""
    from k_diffusion_tpu_torch.ops import rope
    from k_diffusion_tpu_torch.ops.kernels import (fused_ffn, fused_mapping,
                                                   fused_qkv, global_packed,
                                                   na2d)

    g = torch.Generator().manual_seed(SEED)
    b, bf16 = SAMPLE_BATCH, torch.bfloat16

    def normal(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(dev, bf16)

    def unit_heads(*shape):
        # cosine-sim q/k as the prologue makes them: norm sqrt(10) per head
        t = torch.randn(shape, generator=g)
        t = t.reshape(*shape[:-1], -1, 64)
        t = t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5
        return t.reshape(shape).to(dev, bf16)

    cases = []
    # (h, w, width, d_ff, attention, layers per forward): down + up stacks
    for h, d, d_ff, attn, n in ((64, 128, 384, "na", 4),
                                (32, 256, 768, "na", 4),
                                (16, 512, 1536, "global", 4)):
        heads, t = d // 64, b * h * h
        x = normal(b, h, h, d)
        ns = (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, bf16)
        w_qkv = lecun((d, 3 * d), g, dev)
        a_scale = torch.full((heads,), 10.0, device=dev)
        pos = rope.make_axial_pos(h, h, device=dev)
        label = f"{b}x{h}x{h}x{d}"
        args = (x, pos, ns, w_qkv, a_scale, heads)
        cases.append(Case("fused_qkv", label, n,
                          lambda a=args: fused_qkv.fused_qkv_prologue(*a),
                          lambda a=args: fused_qkv.reference(*a),
                          2 * t * d * 3 * d, args))
        qkv = (unit_heads(b, h, h, d), unit_heads(b, h, h, d),
               normal(b, h, h, d))
        if attn == "na":
            cases.append(Case(
                "na2d", label, n,
                lambda t=qkv, nh=heads: na2d.na2d_packed(*t, nh, 7),
                lambda t=qkv, nh=heads: _na_plain(na2d, *t, nh),
                4 * t * d * 7 ** 2, qkv,
                library=na_library(split_heads(qkv, heads))))
        else:
            s = h * h
            flat = tuple(t.reshape(b, s, d) for t in qkv)
            cases.append(Case(
                "global_packed", f"{b}x{s}x{d}", n,
                lambda t=flat, nh=heads:
                global_packed.packed_global_attention(*t, nh),
                lambda t=flat, nh=heads: global_packed.reference(*t, nh),
                4 * b * s * s * d, flat,
                library=lambda t=flat, nh=heads: F.scaled_dot_product_attention(
                    *(heads_view(x, nh) for x in t), scale=1.0)))
        xt = x.reshape(b, h * h, d)
        ffn_args = (xt, ns, lecun((d, 2 * d_ff), g, dev),
                    lecun((d_ff, d), g, dev))
        cases.append(Case("fused_ffn", f"{b}x{h * h}x{d} f={d_ff}", n,
                          lambda a=ffn_args: fused_ffn.fused_geglu_ffn(*a),
                          lambda a=ffn_args: fused_ffn.reference(*a),
                          6 * t * d * d_ff, ffn_args))
    mw = 256
    blocks = [((1 + 0.1 * torch.randn(mw, generator=g)).to(dev),
               lecun((mw, 2 * 3 * mw), g, dev), lecun((3 * mw, mw), g, dev))
              for _ in range(2)]
    # the model holds its weights as float32 params: the counted case;
    # uncounted, the same weights in bfloat16 and the training batch
    blocks32 = [(ns, wu.float(), wd.float()) for ns, wu, wd in blocks]
    for batch, weights, calls, what in ((b, blocks32, 1, "f32 weights"),
                                        (b, blocks, 0, "bf16 weights"),
                                        (TRAIN_BATCH, blocks32, 0,
                                         "f32 weights")):
        map_args = (normal(batch, mw), torch.ones(mw, device=dev),
                    torch.ones(mw, device=dev), weights)
        cases.append(Case(
            "fused_mapping", f"{batch}x{mw} f={3 * mw}, {what}", calls,
            lambda a=map_args: fused_mapping.fused_mapping(*a),
            lambda a=map_args: fused_mapping.reference(*a),
            len(blocks) * 6 * batch * mw * 3 * mw, map_args))
    return cases


def mapping_one_launch(dev, mw=256, d_ff=768, batch=SAMPLE_BATCH):
    """Each fused_mapping call with the model's float32 params (width mw,
    d_ff, depth 2) runs one device kernel, K5's, and nothing else (no
    stack, no cast): three calls, counted by torch.profiler and by the
    wrapper's count."""
    from torch.profiler import ProfilerActivity
    from k_diffusion_tpu_torch.ops.kernels import fused_mapping

    g = torch.Generator().manual_seed(SEED + 20)
    blocks = [((1 + 0.1 * torch.randn(mw, generator=g)).to(dev),
               (torch.randn((mw, 2 * d_ff), generator=g) / mw ** 0.5).to(dev),
               (torch.randn((d_ff, mw), generator=g)
                / d_ff ** 0.5).to(dev)) for _ in range(2)]
    emb = torch.randn((batch, mw), generator=g).to(dev, torch.bfloat16)
    ones = torch.ones(mw, device=dev)
    fused_mapping.fused_mapping(emb, ones, ones, blocks)
    torch.cuda.synchronize()
    before = fused_mapping.launches
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fused_mapping.fused_mapping(emb, ones, ones, blocks)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if (len(names) != 3 or any("mapping_kernel" not in n for n in names)
            or fused_mapping.launches != before + 3):
        raise AssertionError(f"fused_mapping: three calls ran {names}")
    ranks = fused_mapping.cluster_size(dev.index or 0, mw, d_ff, 2, True)
    print(f"fused_mapping {batch}x{mw} f={d_ff}: three calls with float32 "
          f"weights run three device kernels ({names[0][:60]}), three "
          f"launches counted; clusters of {ranks} ranks, "
          f"{fused_mapping.layout(mw, d_ff, 2, ranks, True)}", flush=True)


def backward_cases(dev):
    """The backward kernels at the flagship training shapes, batch 8: K6 at
    every level, K7, K8 and K10 at the two NA levels (the mid level's
    feed-forward blocks have dropout and run unfused), K9 at the global
    level. Each fn returns a tuple of gradients. K7 is the whole backward,
    (dq, dk, dv) from q, k, v, out, lse and dout; K8 sums the plain per-tile
    halo partials of the same inputs (``packed_backward_partials_
    reference``), held against the plain overlap-add of them. Inputs are
    seeded; the weights are float32, as the model's parameters. A
    backward's operations count the products it cannot do without: the
    recomputed forward product where the forward's result is not an input
    (the raw qkv, the logits, the GEGLU hidden), and each gradient product.
    Returns the cases and K8's partials at each NA level, for its op path."""
    from k_diffusion_tpu_torch.ops import rope
    from k_diffusion_tpu_torch.ops.kernels import (fused_ffn, fused_qkv,
                                                   global_packed, na2d)

    g = torch.Generator().manual_seed(SEED + 2)
    b, bf16 = SAMPLE_BATCH, torch.bfloat16

    def normal(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g) * std).to(dev, dtype)

    def unit_heads(*shape):
        t = torch.randn(shape, generator=g).reshape(*shape[:-1], -1, 64)
        return (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
            shape).to(dev, bf16)

    cases, overlap = [], []
    for h, d, d_ff, attn, n in ((64, 128, 384, "na", 4),
                                (32, 256, 768, "na", 4),
                                (16, 512, 1536, "global", 4)):
        heads, t = d // 64, b * h * h
        label = f"{b}x{h}x{h}x{d}"
        args = (normal(b, h, h, d), rope.make_axial_pos(h, h, device=dev),
                (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, bf16),
                normal(d, 3 * d, std=d ** -0.5, dtype=torch.float32),
                10 * (1 + 0.1 * torch.randn(heads, generator=g)).to(dev),
                heads, *(normal(b, h, h, d) for _ in range(3)))
        # the raw qkv recomputed, then dW_qkv and dx
        cases.append(Case("fused_qkv_bwd", label, n,
                          lambda a=args: fused_qkv.prologue_backward(*a),
                          lambda a=args: fused_qkv.reference_backward(*a),
                          3 * 2 * t * d * 3 * d, args))
        q, k, v, dout = (unit_heads(b, h, h, d), unit_heads(b, h, h, d),
                         normal(b, h, h, d), normal(b, h, h, d))
        if attn == "na":
            out, lse = na2d.packed_forward(q, k, v, heads, 7, save_lse=True)
            fwd = (q, k, v, out, lse, dout, heads, 7)
            # the logits recomputed, then dp, dv, dk, dq; the bytes q, k,
            # v, out, dout and lse read, dq, dk and dv written
            cases.append(Case(
                "na2d_bwd", label, n,
                lambda a=fwd: na2d.packed_backward(*a),
                lambda a=(q, k, v, dout, heads, 7): na2d.reference_backward(*a),
                5 * 2 * t * d * 7 ** 2, fwd[:6],
                library=na_library(split_heads((q, k, v), heads),
                                   split_heads((dout,), heads)[0])))
            parts = na2d.packed_backward_partials_reference(q, k, v, dout,
                                                            heads, 7)
            overlap.append((*parts, h, h, 7))
            # the library call: one index_add_ of the dk and dv halo rows
            # (side by side) into the plain version's position map
            halo = na2d.TILE + na2d.MAX_KERNEL - 1
            rows = torch.cat([p[:, :, :, :halo * halo].reshape(
                b, heads, -1, 64) for p in parts], -1)
            sums = torch.zeros((b, heads, h * h + 1, 128), device=dev)
            # one call a level: K8's path is its op path (``overlap_path``)
            cases.append(Case(
                "na2d_overlap_add", label, 1,
                lambda p=parts, h=h: na2d.overlap_add(*p, h, h, 7),
                lambda p=parts, h=h: na2d.overlap_add_reference(*p, h, h, 7),
                0, parts,
                library=lambda s=sums, t=na2d.overlap_add_targets(h, h, 7, dev),
                r=rows: s.index_add_(2, t, r)))
            ffn_args = (normal(b, h * h, d), (1 + 0.1 * torch.randn(
                (b, d), generator=g)).to(dev, bf16),
                normal(d, 2 * d_ff, std=d ** -0.5, dtype=torch.float32),
                normal(d_ff, d, std=d_ff ** -0.5, dtype=torch.float32),
                normal(b, h * h, d))
            # the GEGLU up product recomputed, then dh, dW_down, dx, dW_up
            cases.append(Case("fused_ffn_bwd", f"{b}x{h * h}x{d} f={d_ff}", n,
                              lambda a=ffn_args: fused_ffn.ffn_backward(*a),
                              lambda a=ffn_args: fused_ffn.reference_backward(*a),
                              16 * t * d * d_ff, ffn_args))
        else:
            s = h * h
            q, k, v, dout = (t.reshape(b, s, d) for t in (q, k, v, dout))
            out, lse = global_packed.packed_forward(q, k, v, heads,
                                                    save_lse=True)
            split = [t.reshape(b, s, heads, 64) for t in (q, k, v, dout)]
            cases.append(Case(
                "global_packed_bwd", f"{b}x{s}x{d}", n,
                lambda a=(q, k, v, out, lse, dout, heads):
                global_packed.packed_backward(*a),
                lambda a=(q, k, v, dout, heads):
                global_packed.reference_backward(*a),
                5 * 2 * b * s * s * d, (q, k, v, out, lse, dout),
                library=sdpa_backward(*split, 1.0)))
    return cases, overlap


def overlap_path(overlap, dtype=torch.bfloat16):
    """K8's op path: ``na2d.overlap_add`` once on each NA level's partials
    (``backward_cases``' plain ones; phase 28's seeded ones with ``dtype``
    float32, K8-f32), writing ``dtype``, with the launch counts read around
    it: since K7 writes dk and dv itself, no model path runs K8. Each
    result is held against the plain overlap-add again. Returns the
    counts."""
    from k_diffusion_tpu_torch.ops import kernels
    from k_diffusion_tpu_torch.ops.kernels import na2d

    f32 = dtype == torch.float32
    bound = F32_KERNEL_REL_BOUND if f32 else KERNEL_REL_BOUND
    kernels.reset_launch_counts()
    got = [na2d.overlap_add(*args, dtype=dtype) for args in overlap]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    expected = dict.fromkeys(kernels.COUNTERS, 0) | {
        "na2d_overlap_add_f32" if f32 else "na2d_overlap_add": len(overlap)}
    if counts != expected:
        raise AssertionError(f"overlap-add path: launch counts {counts} != "
                             f"expected {expected}")
    for sums, args in zip(got, overlap):
        for name, a, b_ in zip(("dk", "dv"), sums, na2d.overlap_add_reference(
                *args, dtype=dtype)):
            if a.dtype != dtype:
                raise AssertionError(f"overlap-add path {name}: {a.dtype}")
            check_close(f"overlap-add path {name}", a, b_, bound)
    print(f"overlap-add path ({dtype}): launches {counts}; dk, dv within "
          f"{bound} x max|plain|", flush=True)
    return counts


def na_bit_check(dev):
    """At both flagship NA levels (batch 8, cosine-sim q and k): K2 and K11
    run one forward (csrc/na_fwd.cuh), so on one packed input, read by K11
    as its (b, h, w, heads, 64) view, they give the same out and lse bit
    for bit; K7 and K12 run one backward (csrc/na_bwd.cuh), so they give
    the same dq, dk, dv bit for bit; neither has partials or atomics, so
    two runs of each give bit-identical dq, dk, dv."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 19)
    labels = []
    for h, c in ((64, 128), (32, 256)):
        b, heads = SAMPLE_BATCH, c // 64
        t = torch.randn((2, b, h, h, heads, 64), generator=g)
        q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
            2, b, h, h, c).to(dev, torch.bfloat16)
        v, dout = torch.randn((2, b, h, h, c), generator=g).to(
            dev, torch.bfloat16)
        out, lse = na2d.packed_forward(q, k, v, heads, 7, save_lse=True)
        out11, lse11 = na2d.heads_forward(*split_heads((q, k, v), heads), 7,
                                          save_lse=True)
        for name, a, b_ in (("out", out, out11.reshape(out.shape)),
                            ("lse", lse, lse11)):
            if not torch.equal(a, b_):
                diff = (a.float() - b_.float()).abs().max().item()
                raise AssertionError(f"K2 and K11 {name} differ by {diff:.3e}")
        first = na2d.packed_backward(q, k, v, out, lse, dout, heads, 7)
        again = na2d.packed_backward(q, k, v, out, lse, dout, heads, 7)
        split = split_heads((q, k, v, out11, dout), heads)
        k12 = na2d.heads_backward(*split[:4], lse11, split[4], 7)
        k12_again = na2d.heads_backward(*split[:4], lse11, split[4], 7)
        for pair, got, want in (("K7 rerun", again, first),
                                ("K12 and K7", k12, first),
                                ("K12 rerun", k12_again, k12)):
            for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
                if not torch.equal(a.reshape(b_.shape), b_):
                    diff = (a.reshape(b_.shape).float()
                            - b_.float()).abs().max().item()
                    raise AssertionError(f"{pair} {name} differ by {diff:.3e}")
        labels.append(f"{b}x{h}x{h}x{c}")
    print(f"NA forward bit check [{', '.join(labels)}]: K2 and K11 give "
          f"bit-identical out and lse on one packed input", flush=True)
    print(f"K7 bit check [{', '.join(labels)}]: two runs give bit-identical "
          f"dq, dk, dv", flush=True)
    print(f"K12 bit check [{', '.join(labels)}]: K12 on the packed input's "
          f"(b, h, w, heads, 64) views gives K7's dq, dk, dv bit for bit, "
          f"and two runs of K12 bit-identical ones", flush=True)


def ffn_width_check(dev):
    """K10 refuses d = 640, past its first kernel's shared memory, with a
    ValueError naming its limit of 576, before any launch."""
    from k_diffusion_tpu_torch.ops import kernels
    from k_diffusion_tpu_torch.ops.kernels import fused_ffn

    kernels.reset_launch_counts()
    x = torch.zeros((1, 64, 640), device=dev, dtype=torch.bfloat16)
    try:
        fused_ffn.ffn_backward(
            x, torch.ones((1, 640), device=dev, dtype=torch.bfloat16),
            torch.zeros((640, 128), device=dev),
            torch.zeros((64, 640), device=dev), x)
    except ValueError as e:
        if "576" not in str(e):
            raise
        message = str(e)
    else:
        raise AssertionError("fused_ffn backward took d = 640")
    torch.cuda.synchronize()
    if kernels.launch_counts() != dict.fromkeys(kernels.COUNTERS, 0):
        raise AssertionError(f"fused_ffn backward at d = 640 launched "
                             f"{kernels.launch_counts()}")
    print(f"K10 width check: d = 640 raises ValueError before any launch "
          f"({message})", flush=True)


def na_plain_by_image(q, k, v, kernel_size):
    """``na2d.na2d_reference`` one image at a time: its dense (hw, hw) f32
    logits of a whole batch at 128 x 128 would take tens of GB."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    return torch.cat([na2d.na2d_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                          kernel_size)
                      for i in range(q.shape[0])])


def wide_cases(dev):
    """Phase 6's config_512_hdit levels that the flagship does not have, at
    batch 8: K1 and K6 at 16 x 16 x 768 (12 heads), K4 and K10 at 32 x 32 x
    512 (d_ff 1536, dropout 0 there), K4 at 16 x 16 x 768 (d_ff 2304) and
    K2 at the 128 x 128 x 128 NA level (2 heads, cosine-sim q and k; its
    plain version one image at a time). They count no calls: held, timed
    and printed, outside the per-call and per-step sums and the JSON
    line."""
    from k_diffusion_tpu_torch.ops import rope
    from k_diffusion_tpu_torch.ops.kernels import fused_ffn, fused_qkv, na2d

    g = torch.Generator().manual_seed(SEED + 18)
    b, bf16 = SAMPLE_BATCH, torch.bfloat16

    def normal(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g) * std).to(dev, dtype)

    h, d = 16, 768
    heads, t = d // 64, b * h * h
    args = (normal(b, h, h, d), rope.make_axial_pos(h, h, device=dev),
            (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, bf16),
            normal(d, 3 * d, std=d ** -0.5, dtype=torch.float32),
            10 * (1 + 0.1 * torch.randn(heads, generator=g)).to(dev),
            heads, *(normal(b, h, h, d) for _ in range(3)))
    label = f"{b}x{h}x{h}x{d} (config_512_hdit)"
    cases = [Case("fused_qkv", label, 0,
                  lambda a=args[:6]: fused_qkv.fused_qkv_prologue(*a),
                  lambda a=args[:6]: fused_qkv.reference(*a),
                  2 * t * d * 3 * d, args[:6]),
             Case("fused_qkv_bwd", label, 0,
                  lambda a=args: fused_qkv.prologue_backward(*a),
                  lambda a=args: fused_qkv.reference_backward(*a),
                  3 * 2 * t * d * 3 * d, args)]
    for h, d, d_ff, backward in ((32, 512, 1536, True), (16, 768, 2304, False)):
        t = b * h * h
        ffn_args = (normal(b, h * h, d),
                    (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, bf16),
                    normal(d, 2 * d_ff, std=d ** -0.5, dtype=torch.float32),
                    normal(d_ff, d, std=d_ff ** -0.5, dtype=torch.float32),
                    normal(b, h * h, d))
        label = f"{b}x{h * h}x{d} f={d_ff} (config_512_hdit)"
        cases.append(Case("fused_ffn", label, 0,
                          lambda a=ffn_args[:4]: fused_ffn.fused_geglu_ffn(*a),
                          lambda a=ffn_args[:4]: fused_ffn.reference(*a),
                          6 * t * d * d_ff, ffn_args[:4]))
        if backward:
            cases.append(Case(
                "fused_ffn_bwd", label, 0,
                lambda a=ffn_args: fused_ffn.ffn_backward(*a),
                lambda a=ffn_args: fused_ffn.reference_backward(*a),
                16 * t * d * d_ff, ffn_args))
    h, d = 128, 128
    heads, t = d // 64, b * h * h
    u = torch.randn((2, b, h, h, heads, 64), generator=g)
    q, k = (u / u.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
        2, b, h, h, d).to(dev, bf16)
    qkv = (q, k, normal(b, h, h, d))
    plain = lambda t=qkv: na_plain_by_image(
        *split_heads(t, heads), 7).reshape(b, h, h, d)
    cases.append(Case(
        "na2d", f"{b}x{h}x{h}x{d} (config_512_hdit)", 0,
        lambda t=qkv: na2d.na2d_packed(*t, heads, 7), plain,
        4 * t * d * 7 ** 2, qkv,
        library=na_library(split_heads(qkv, heads), plain=na_plain_by_image)))
    return cases


def attention_bit_check(dev):
    """K3 and K13 run the same forward (csrc/attn_fwd.cuh), K9 and K14 the
    same backward (csrc/attn_bwd.cuh): on one packed input at the
    flagship's global level (batch 8, 256 tokens, 8 heads of 64, scale 1),
    the forwards' out and lse agree bit for bit, and so do the backwards'
    dq, dk, dv from the same out and lse."""
    from k_diffusion_tpu_torch.ops.kernels import flash, global_packed

    def same(pair, names, got, want):
        for name, a, b_ in zip(names, got, want):
            b_ = b_.reshape(a.shape)
            if not torch.equal(a, b_):
                diff = (a.float() - b_.float()).abs().max().item()
                raise AssertionError(f"{pair} {name} differ by {diff:.3e}")

    g = torch.Generator().manual_seed(SEED + 14)
    b, s, heads = SAMPLE_BATCH, 256, 8
    t = torch.randn((2, b, s, heads, 64), generator=g)
    q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
        2, b, s, heads * 64).to(dev, torch.bfloat16)
    v, dout = torch.randn((2, b, s, heads * 64), generator=g).to(
        dev, torch.bfloat16)
    out, lse = global_packed.packed_forward(q, k, v, heads, save_lse=True)
    split = [x.reshape(b, s, heads, 64) for x in (q, k, v, out, dout)]
    same("K3 and K13", ("out", "lse"), (out, lse),
         flash.flash_forward(*split[:3], 1.0, save_lse=True))
    packed = global_packed.packed_backward(q, k, v, out, lse, dout, heads)
    strided = flash.flash_backward(*split[:4], lse, split[4], 1.0)
    same("K9 and K14", ("dq", "dk", "dv"), packed, strided)
    print(f"attention bit check [{b}x{s}x{heads * 64}]: K3 and K13 give "
          f"bit-identical out and lse, K9 and K14 bit-identical dq, dk, dv "
          f"on one packed input", flush=True)


def unet_attention_shapes(unet):
    """((s, heads), calls per denoiser call) of the U-Net's attention
    blocks, longest s first: heads follow each block's width, the last
    block of an up stack narrowing to the next level's."""
    m = unet["model"]
    size = m["input_size"][0]
    shapes = collections.Counter()
    for i, (depth, attn) in enumerate(zip(m["depths"], m["self_attn_depths"])):
        if attn:
            s = (size >> i) ** 2
            c, narrow = m["channels"][i], m["channels"][max(0, i - 1)]
            shapes[s, c // 64] += 2 * depth - 1
            shapes[s, narrow // 64] += 1
    return sorted(shapes.items(), reverse=True)


def forward_lse_check(dev, unet=None):
    """The training forward of the attention kernels (save_lse=True): out
    and logsumexp against the plain versions (``reference``,
    ``reference_lse``) within KERNEL_REL_BOUND. Without ``unet``, K3 at the
    flagship's global level (batch 8, 256 tokens, 8 heads) and at two other
    lengths it is routed (16, 208); with it, K13 at the U-Net's shapes
    (batch 64, strided views of one projection, scale 1/8) and, at head
    dims 64 and 32, at s in {1, 49, 65, 200}, where the last key tile is
    ragged (K3's wrapper routes only multiples of 16 to the same kernel).
    K9 and K14 recompute p from this lse, so its base (natural log)
    matters."""
    from k_diffusion_tpu_torch.ops.kernels import flash, global_packed

    g = torch.Generator().manual_seed(SEED + (15 if unet is None else 16))
    bf16 = torch.bfloat16
    worst = {"out": 0.0, "lse": 0.0}

    def hold(label, got, want):
        for name, a, b_ in zip(("out", "lse"), got, want):
            err, _ = check_close(f"{label} {name}", a, b_, KERNEL_REL_BOUND)
            worst[name] = max(worst[name], err)

    labels = []
    if unet is None:
        for b, s, heads in ((SAMPLE_BATCH, 256, 8), (2, 16, 2), (2, 208, 4)):
            t = torch.randn((2, b, s, heads, 64), generator=g)
            q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
                2, b, s, heads * 64).to(dev, bf16)
            v = torch.randn((b, s, heads * 64), generator=g).to(dev, bf16)
            label = f"{b}x{s}x{heads * 64}"
            hold(f"global_packed {label}",
                 global_packed.packed_forward(q, k, v, heads, save_lse=True),
                 (global_packed.reference(q, k, v, heads),
                  global_packed.reference_lse(q, k, v, heads)))
            labels.append(label)
        name = "K3 (global_packed)"
    else:
        shapes = [(UNET_BATCH, s, heads, 64)
                  for (s, heads), _ in unet_attention_shapes(unet)]
        shapes += [(2, s, 3, e) for e in (64, 32) for s in (1, 49, 65, 200)]
        for b, s, heads, e in shapes:
            qkv = torch.randn((b, s, 3, heads, e), generator=g) * (64 / e) ** 0.5
            q, k, v = qkv.to(dev, bf16).unbind(2)
            label = f"{b}x{s}x{heads}x{e}"
            hold(f"flash {label}",
                 flash.flash_forward(q, k, v, 0.125, save_lse=True),
                 (flash.reference(q, k, v, 0.125),
                  flash.reference_lse(q, k, v, 0.125)))
            labels.append(label)
        name = "K13 (flash)"
    print(f"forward lse: {name} with save_lse at {', '.join(labels)}: out "
          f"max abs err {worst['out']:.3e}, lse {worst['lse']:.3e}, each "
          f"within {KERNEL_REL_BOUND} x its max|plain|", flush=True)


def flash_cases(dev, unet):
    """K13 and K14 at the U-Net's shapes, batch 64 (heads follow each
    block's width, the last block of an up stack narrowing to the next
    level's), q, k, v strided views of one (b, s, 3, heads, 64) projection
    as the U-Net makes them, logits of about unit spread at scale 1/8; and
    K13 at the mnist HDiT's 7 x 7 level, batch 8, with cosine-sim q and k at
    scale 1. The HDiT's case is held and timed but counts no calls: its
    path (phase 13) is not this kernel's main path."""
    from k_diffusion_tpu_torch.ops.kernels import flash

    g = torch.Generator().manual_seed(SEED + 6)
    bf16 = torch.bfloat16
    cases = []
    for (s, heads), n in unet_attention_shapes(unet):
        b = UNET_BATCH
        label = f"{b}x{s}x{heads}x64"
        qkv = (torch.randn((b, s, 3, heads, 64), generator=g)).to(dev, bf16)
        q, k, v = qkv.unbind(2)
        dout = torch.randn((b, s, heads, 64), generator=g).to(dev, bf16)
        fwd_flops = 2 * 2 * b * heads * s * s * 64
        cases.append(Case("flash", label, n,
                          lambda t=(q, k, v): flash.flash_attention(*t, 0.125),
                          lambda t=(q, k, v): flash.reference(*t, 0.125),
                          fwd_flops, (q, k, v),
                          library=lambda t=(q, k, v): sdpa(*t, 0.125)))
        out, lse = flash.flash_forward(q, k, v, 0.125, save_lse=True)
        # the logits recomputed, then dp, dv, dk, dq
        cases.append(Case(
            "flash_bwd", label, n,
            lambda a=(q, k, v, out, lse, dout): flash.flash_backward(*a, 0.125),
            lambda a=(q, k, v, dout): flash.reference_backward(*a, 0.125),
            5 * fwd_flops // 2, (q, k, v, out, lse, dout),
            library=sdpa_backward(q, k, v, dout, 0.125)))
    b, s, heads = SAMPLE_BATCH, 49, 4
    t = torch.randn((3, b, s, heads, 64), generator=g)
    q, k, v = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).to(dev, bf16)
    cases.append(Case("flash", f"{b}x{s}x{heads}x64 (mnist HDiT)", 0,
                      lambda a=(q, k, v): flash.flash_attention(*a, 1.0),
                      lambda a=(q, k, v): flash.reference(*a, 1.0),
                      2 * 2 * b * heads * s * s * 64, (q, k, v),
                      library=lambda a=(q, k, v): sdpa(*a, 1.0)))
    return cases


def run_cases(cases, results, kernel_reps, plain_reps):
    """Holds each case's kernel against its plain version, times both (the
    kernel through its timed fn where a case has one) and the library call
    where there is one, computes the bound, and adds calls x each into
    ``results[name]``."""
    for c in cases:
        got, want = c.fn(), c.plain()
        torch.cuda.synchronize()
        outs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        checks = [check_close(f"{c.name} {c.label}", a, b_, c.rel_bound)
                  for a, b_ in outs]
        err = max(e for e, _ in checks)
        # the worst output's error as a share of its max |plain|
        share = max(e / limit * c.rel_bound if limit else 0.0
                    for e, limit in checks)
        timed = c.timed or c.fn
        op_ms, byte_ms = bound_ms(c.flops, c.inputs,
                                  timed() if c.timed else got, c.peak)
        del got, want
        ms = device_ms(timed, kernel_reps)
        plain_ms = device_ms(c.plain, plain_reps)
        lib_ms = device_ms(c.library, kernel_reps) if c.library else None
        lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        prod_ms = device_ms(c.products, kernel_reps) if c.products else None
        if prod_ms is not None:
            lib += f", its products as torch.matmul (TF32) {prod_ms:.4f} ms"
        bound = max(op_ms, byte_ms)
        print(f"kernel {c.name} [{c.label}]: max abs err {err:.3e}, worst "
              f"output {share:.2e} x its max|plain| (bound "
              f"{c.rel_bound}), {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{lib}; bound {bound:.4f} ms (operations {op_ms:.4f}, bytes "
              f"{byte_ms:.4f}); {c.flops / ms / 1e9:.2f} TFLOP/s, "
              f"{bound / ms:.1%} of the bound", flush=True)
        r = results.setdefault(c.name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "op_ms": 0.0, "byte_ms": 0.0, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r.setdefault("shapes", {})[c.label] = {"ms": ms, "library_ms": lib_ms,
                                               "bound_ms": bound}
        r["ms"] += c.calls * ms
        r["plain_ms"] += c.calls * plain_ms
        r["bound_ms"] += c.calls * max(op_ms, byte_ms)
        r["op_ms"] += c.calls * op_ms
        r["byte_ms"] += c.calls * byte_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + c.calls * lib_ms
        if prod_ms is not None:
            r["products_ms"] = r.get("products_ms", 0.0) + c.calls * prod_ms
    torch.cuda.empty_cache()


def split_heads(maps, heads):
    """(b, h, w, c) maps -> their (b, h, w, heads, c / heads) views."""
    return tuple(t.reshape(*t.shape[:3], heads, -1) for t in maps)


def heads_cases(dev):
    """Phase 14: K11 and K12 at the flagship's NA levels in the unfused
    training step, batch 8 as in phases 3 and 6, 4 calls per level and step
    (2 layers in the down and in the up stack): q and k contiguous, v a
    strided third of a (b, h, w, 3, heads, e) projection, as the model's
    unfused prologue leaves them, q and k cosine-sim. Then, counting no
    calls, head dims 32 and 128 and a level wider than K2 takes. K11 is
    timed as the training forward (with its lse); its bytes count q, k, v,
    out and lse once, its operations 4 * 49 * e per query and head; K12's
    the 5 products of 2 * 49 * e (the logits recomputed, dp, dv, dk, dq)."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 10)
    b, bf16 = SAMPLE_BATCH, torch.bfloat16
    cases = []
    for h, heads, e, n in ((64, 2, 64, 4), (32, 4, 64, 4), (32, 4, 32, 0),
                           (32, 2, 128, 0), (16, 12, 64, 0)):
        t = torch.randn((b, h, h, 3, heads, e), generator=g)
        qk = t[:, :, :, :2] / t[:, :, :, :2].norm(dim=-1, keepdim=True)
        proj = torch.cat([qk * 10 ** 0.5, t[:, :, :, 2:]], 3).to(dev, bf16)
        q, k, v = proj.unbind(3)
        q, k = q.contiguous(), k.contiguous()
        dout = torch.randn((b, h, h, heads, e), generator=g).to(dev, bf16)
        label = f"{b}x{h}x{h}x{heads}x{e}"
        flops = 4 * b * h * h * heads * e * 7 ** 2
        cases.append(Case(
            "na2d_heads", label, n,
            lambda a=(q, k, v): na2d.na2d(*a, 7),
            lambda a=(q, k, v): na2d.na2d_reference(*a, 7), flops, (q, k, v),
            timed=lambda a=(q, k, v): na2d.heads_forward(*a, 7, save_lse=True),
            library=na_library((q, k, v))))
        out, lse = na2d.heads_forward(q, k, v, 7, save_lse=True)
        cases.append(Case(
            "na2d_heads_bwd", label, n,
            lambda a=(q, k, v, out, lse, dout): na2d.heads_backward(*a, 7),
            lambda a=(q, k, v, dout): na2d.heads_reference_backward(*a, 7),
            5 * flops // 2, (q, k, v, out, lse, dout),
            library=na_library((q, k, v), dout)))
    return cases


def proj_inputs(dev):
    """K15's inputs at the flagship's NA levels, batch 8: cosine-sim q and
    k, v, the residual, w_out (c, c) bf16 and a cotangent."""
    g = torch.Generator().manual_seed(SEED + 11)
    b, bf16 = SAMPLE_BATCH, torch.bfloat16
    out = []
    for h, c in ((64, 128), (32, 256)):
        t = torch.randn((2, b, h, h, c // 64, 64), generator=g)
        q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
            2, b, h, h, c).to(dev, bf16)
        v, skip, dout = (torch.randn((b, h, h, c), generator=g).to(dev, bf16)
                         for _ in range(3))
        out.append((q, k, v, skip, lecun((c, c), g, dev), c // 64, dout))
    return out


def proj_plain_by_image(q, k, v, skip, w, heads, kernel_size):
    """``na2d.proj_reference`` one image at a time (``na_plain_by_image``)."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    return torch.cat([na2d.proj_reference(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], skip[i:i + 1], w, heads,
        kernel_size) for i in range(q.shape[0])])


def proj_cases(inputs, dev):
    """Phase 15: K15 against its plain version, one call per NA level (its
    op path, phase 15's second half); operations 4 * 49 * c for the
    attention and 2 * c * c for the projection per query. No single
    PyTorch call computes it (library null); the composition the model runs
    is timed beside it by ``proj_path``. Then, counting no calls, head dim
    32 at the flagship's 64 x 64 x 128 level (4 heads of 32, two a rank)
    and config_512_hdit's 128 x 128 x 128 NA level (its plain version one
    image at a time)."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 20)
    b, bf16 = SAMPLE_BATCH, torch.bfloat16
    extra = []
    for h, c, e in ((64, 128, 32), (128, 128, 64)):
        t = torch.randn((2, b, h, h, c // e, e), generator=g)
        q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
            2, b, h, h, c).to(dev, bf16)
        v, skip = (torch.randn((b, h, h, c), generator=g).to(dev, bf16)
                   for _ in range(2))
        extra.append(((q, k, v, skip, lecun((c, c), g, dev), c // e), 0,
                      f"{b}x{h}x{h}x{c} e={e}" + (" (config_512_hdit)"
                                                  if h == 128 else "")))
    cases = []
    for args, calls, label in [(i[:6], 1, "x".join(map(str, i[0].shape)))
                               for i in inputs] + extra:
        q, k, v, skip, w, heads = args
        b, h, _, c = q.shape
        t = b * h * h
        plain = proj_plain_by_image if h > 64 else na2d.proj_reference
        cases.append(Case(
            "na2d_proj", label, calls,
            lambda a=args: na2d.na2d_packed_proj(*a, 7),
            lambda a=args, f=plain: f(*a, 7),
            4 * t * c * 7 ** 2 + 2 * t * c * c, (q, k, v, skip, w)))
    return cases


def proj_bit_check(inputs):
    """At both flagship NA levels: K15 with w_out = I and skip = 0 gives
    K2's output bit for bit (the same attention, rounded to bf16 at the same
    point; the product with I and the add of 0 are exact)."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    labels = []
    for q, k, v, skip, _, heads, _ in inputs:
        eye = torch.eye(q.shape[-1], device=q.device)
        got = na2d.proj_forward(q, k, v, torch.zeros_like(skip), eye, heads, 7)
        want, _ = na2d.packed_forward(q, k, v, heads, 7)
        if not torch.equal(got, want):
            diff = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"K15 (w_out = I, skip = 0) and K2 differ "
                                 f"by {diff:.3e}")
        labels.append("x".join(map(str, q.shape)))
    print(f"K15 bit check [{', '.join(labels)}]: K15 with w_out = I and "
          f"skip = 0 gives K2's output bit for bit", flush=True)


def proj_path(inputs, results):
    """Phase 15's op path: na2d_packed_proj forward and backward (autograd)
    at both NA levels with the launch counts read around it (K15 forward;
    K2 recompute, K7 backward), the gradients held against autograd
    through the plain version; then K15 timed against the composition the
    model runs, K2 -> matmul with w_out -> residual add. Returns the
    counts."""
    from k_diffusion_tpu_torch.ops import kernels
    from k_diffusion_tpu_torch.ops.kernels import na2d

    got = []
    kernels.reset_launch_counts()
    for q, k, v, skip, w, heads, dout in inputs:
        leaves = [t.detach().requires_grad_() for t in (q, k, v, skip)]
        w32 = w.float().requires_grad_()
        out = na2d.na2d_packed_proj(*leaves, w32, heads, 7)
        got.append(torch.autograd.grad(out, [*leaves, w32], dout))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n = len(inputs)
    expected = dict.fromkeys(kernels.COUNTERS, 0) | {
        "na2d_proj": n, "na2d": n, "na2d_bwd": n}
    if counts != expected:
        raise AssertionError(f"na2d_packed_proj path: launch counts {counts} "
                             f"!= expected {expected}")
    comp_ms = fused_ms = 0.0
    for grads, (q, k, v, skip, w, heads, dout) in zip(got, inputs):
        label = "x".join(map(str, q.shape))
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_()
                      for t in (q, k, v, skip, w)]
            want = torch.autograd.grad(
                na2d.proj_reference(*leaves, heads, 7), leaves, dout.float())
        for name, a, b_ in zip(("q", "k", "v", "skip", "w_out"), grads, want):
            check_close(f"na2d_packed_proj backward d{name} {label}", a, b_,
                        KERNEL_REL_BOUND)
        with torch.no_grad():
            comp = device_ms(lambda: na2d.na2d_packed(q, k, v, heads, 7) @ w
                             + skip, 50)
            fused = device_ms(lambda: na2d.na2d_packed_proj(
                q, k, v, skip, w, heads, 7), 50)
        comp_ms += comp
        fused_ms += fused
        print(f"na2d_packed_proj [{label}]: K15 {fused:.4f} ms against K2 + "
              f"matmul + add {comp:.4f} ms", flush=True)
    results["na2d_proj"]["composition_ms"] = comp_ms
    print(f"na2d_packed_proj path: launches {counts}; gradients within "
          f"{KERNEL_REL_BOUND} x max|plain|; K15 {fused_ms:.4f} ms against "
          f"the composition's {comp_ms:.4f} ms per pair of calls", flush=True)
    return counts


def head32_cases(dev):
    """Phase 17: K1/K6 and K13/K14 at head dim 32, configs/config_test_
    tiny.json's shapes (8 x 8 tokens, width 64, 2 heads of 32), batch 8;
    they count no calls (the kernels' main paths are phases 5, 8, 11, 12)."""
    from k_diffusion_tpu_torch.ops import rope
    from k_diffusion_tpu_torch.ops.kernels import flash, fused_qkv

    g = torch.Generator().manual_seed(SEED + 12)
    b, h, d, heads, bf16 = SAMPLE_BATCH, 8, 64, 2, torch.bfloat16
    t = b * h * h
    normal = lambda *shape: torch.randn(shape, generator=g).to(dev, bf16)
    args = (normal(b, h, h, d), rope.make_axial_pos(h, h, device=dev),
            (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, bf16),
            (torch.randn((d, 3 * d), generator=g) * d ** -0.5).to(dev),
            10 * (1 + 0.1 * torch.randn(heads, generator=g)).to(dev), heads)
    cots = tuple(normal(b, h, h, d) for _ in range(3))
    label = f"{b}x{h}x{h}x{d} e=32"
    cases = [
        Case("fused_qkv", label, 0,
             lambda a=args: fused_qkv.fused_qkv_prologue(*a),
             lambda a=args: fused_qkv.reference(*a), 2 * t * d * 3 * d, args),
        Case("fused_qkv_bwd", label, 0,
             lambda a=args + cots: fused_qkv.prologue_backward(*a),
             lambda a=args + cots: fused_qkv.reference_backward(*a),
             3 * 2 * t * d * 3 * d, args + cots)]
    s = h * h
    u = torch.randn((3, b, s, heads, 32), generator=g)
    q, k, v = (u / u.norm(dim=-1, keepdim=True) * 10 ** 0.5).to(dev, bf16)
    dout = normal(b, s, heads, 32)
    flops = 2 * 2 * b * heads * s * s * 32
    label = f"{b}x{s}x{heads}x32"
    cases.append(Case("flash", label, 0,
                      lambda a=(q, k, v): flash.flash_attention(*a, 1.0),
                      lambda a=(q, k, v): flash.reference(*a, 1.0),
                      flops, (q, k, v),
                      library=lambda a=(q, k, v): sdpa(*a, 1.0)))
    out, lse = flash.flash_forward(q, k, v, 1.0, save_lse=True)
    cases.append(Case(
        "flash_bwd", label, 0,
        lambda a=(q, k, v, out, lse, dout): flash.flash_backward(*a, 1.0),
        lambda a=(q, k, v, dout): flash.reference_backward(*a, 1.0),
        5 * flops // 2, (q, k, v, out, lse, dout),
        library=sdpa_backward(q, k, v, dout, 1.0)))
    return cases


@contextlib.contextmanager
def train_fusion(value):
    """KDT_TRAIN_FUSION set to ``value`` inside the block, restored after."""
    old = os.environ.get("KDT_TRAIN_FUSION")
    os.environ["KDT_TRAIN_FUSION"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["KDT_TRAIN_FUSION"]
        else:
            os.environ["KDT_TRAIN_FUSION"] = old


def _na_plain(na2d, q, k, v, heads):
    b, h, w, c = q.shape
    split = (b, h, w, heads, c // heads)
    return na2d.na2d_reference(q.reshape(split), k.reshape(split),
                               v.reshape(split), 7).reshape(b, h, w, c)


def fill_zero_init(model, g):
    """Seeded noise into the HDiT's zero-initialised projections (out_proj,
    down_proj, every AdaRMSNorm mapping_linear, patch_out): a freshly
    initialised HDiT ignores every block and returns c_skip * x."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("out_proj.kernel", "down_proj.kernel",
                              "patch_out.proj.kernel")):
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[0] ** 0.5)
            elif name.endswith("mapping_linear.kernel"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1
                        / p.shape[0] ** 0.5)


def fill_zero_init_unet(model, g):
    """Seeded noise into the U-Net's zero-initialised kernels (each residual
    block's conv_2, each attention's out_proj, proj_out, every AdaGN
    mapper, the last at a tenth): a fresh U-Net returns c_skip * x too."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("conv_2.kernel", "out_proj.kernel",
                              "proj_out.kernel", "mapper.kernel")):
                gain = 0.1 if name.endswith("mapper.kernel") else 1.0
                p.copy_(torch.randn(p.shape, generator=g) * gain
                        / math.prod(p.shape[:-1]) ** 0.5)


def input_shape(config, batch):
    m = config["model"]
    return (batch, *m["input_size"], m["input_channels"])


def forward_parity(KT, config, dev, fill, g, name, batch=2, keep=None,
                   **cond):
    """One bf16 denoiser call on the card against the same weights in f32 on
    the CPU (plain versions), relative L2 of the output. Returns the card
    model (eval mode) and the launch counts of its call. ``keep``, where
    given, receives the CPU side: the weights, the inputs and the output
    (phase 27 holds the float32 model against them)."""
    from k_diffusion_tpu_torch.ops import kernels

    model = KT.config.make_model(config, dtype=torch.bfloat16, device="cpu",
                                 generator=g)
    fill(model, g)
    reference = KT.config.make_model(config, device="cpu").eval()
    reference.load_state_dict(model.state_dict())
    model.to(dev).eval()  # dropout is for training only
    x = torch.randn(input_shape(config, batch), generator=g)
    sigma = torch.linspace(0.5, 8.0, batch)
    kernels.reset_launch_counts()
    out = KT.config.make_denoiser_wrapper(config)(model)(
        x.to(dev), sigma.to(dev), **{k: v.to(dev) for k, v in cond.items()})
    counts = kernels.launch_counts()
    out = out.cpu()
    want = KT.config.make_denoiser_wrapper(config)(reference)(x, sigma, **cond)
    rel = ((out - want).norm() / want.norm()).item()
    if keep is not None:
        keep.update(state=reference.state_dict(), x=x, sigma=sigma, out=want,
                    bf16=rel)
    if not rel <= FORWARD_REL_BOUND or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: relative L2 error {rel:.3e} > "
                             f"{FORWARD_REL_BOUND}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{name}: {n_params} params, batch {batch} bf16 on the card vs f32 "
          f"on the CPU: relative L2 error {rel:.3e} (bound "
          f"{FORWARD_REL_BOUND})", flush=True)
    return model, counts


def sample(KT, config, model, dev, g, batch, per_call, fwd_flops, smi, name,
           extra=None, ops=(), report=None):
    """50-step DPM++(2M) at ``batch`` from sigma_max; the output finite and
    the launch counts ``per_call`` x STEPS. ``fwd_flops``: the model's
    FLOPs per image per forward; ``extra``: the model's other inputs (on
    the card); ``ops``: PyTorch ops the profile lists by name. Returns the
    launch counts; ``report``, where given, receives the seconds, samples/s,
    peak memory and the profile's card time per call."""
    extra = extra or {}
    from k_diffusion_tpu_torch.ops import kernels

    m = config["model"]
    denoiser = KT.config.make_denoiser_wrapper(config)(model)
    sigmas = KT.sampling.get_sigmas_karras(STEPS, m["sigma_min"],
                                           m["sigma_max"], rho=7.0, device=dev)
    x = (torch.randn(input_shape(config, batch), generator=g)
         * m["sigma_max"]).to(dev)
    with torch.no_grad():
        denoiser(x, sigmas[:1].expand(batch), **extra)  # warm up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        samples = KT.sampling.sample_dpmpp_2m(denoiser, x, sigmas,
                                              extra_args=extra)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    if samples.shape != x.shape or not torch.isfinite(samples).all():
        raise AssertionError(f"{name}: output not finite or wrong shape")
    # no backward kernel runs while sampling
    expected = dict.fromkeys(kernels.COUNTERS, 0) | {
        k: STEPS * v for k, v in per_call.items()}
    if counts != expected:
        raise AssertionError(f"{name}: launch counts {counts} != expected "
                             f"{expected}")
    tflops = fwd_flops * batch * STEPS / secs / 1e12
    print(f"{name}: {STEPS}-step DPM++(2M), batch {batch}: {secs:.3f} s, "
          f"{batch / secs:.3f} samples/s, model {tflops:.2f} TFLOP/s, peak "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated) on {smi}; "
          f"launches {counts}", flush=True)

    def calls(n):
        with torch.no_grad():
            for _ in range(n):
                denoiser(x, sigmas[:1].expand(batch), **extra)

    busy = profile(calls, name, "denoiser calls", ops)
    if report is not None:
        report.update(secs=secs, rate=batch / secs, peak=peak, busy_ms=busy)
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import k_diffusion_tpu_torch as KT
    from k_diffusion_tpu_torch.models import flops
    from k_diffusion_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    global CLOCK
    CLOCK = Clock()
    lap = CLOCK.lap
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    secs = kernels.build()
    print(f"build: {len(kernels._build.SOURCES)} libraries in {secs:.1f} s",
          flush=True)
    compiler_report(kernels._build)

    results = {}
    with torch.no_grad():
        run_cases(kernel_cases(dev), results, 50, 5)
        mapping_one_launch(dev)
        # the ViT's (phase 22), whose layer shares stream: checked here,
        # among the first profiler sessions, where the short window's
        # device events are recorded
        mapping_one_launch(dev, 768, 2048, UNET_BATCH)
        forward_lse_check(dev)

    lap("phases 1-3")
    # the flagship HDiT: phases 4-8
    config = KT.config.load_config(CONFIG)
    g = torch.Generator().manual_seed(SEED)
    # the CPU side of phases 4 and 7, which phase 27 reuses, and the bf16
    # figures of phases 5, 8 and 16, which it prints beside float32's
    cpu_ref = {"forward": {}, "gradient": {}}
    bf16_reports = {"sampling": {}, "training": {}, "unfused training": {}}
    with torch.no_grad():
        model, _ = forward_parity(KT, config, dev, fill_zero_init, g,
                                  "forward", keep=cpu_ref["forward"])
    levels = config["model"]["depths"]
    attn_layers = 2 * sum(levels[:-1]) + levels[-1]
    per_call = {"fused_qkv": attn_layers, "na2d": 2 * sum(levels[:-1]),
                "global_packed": levels[-1], "fused_ffn": attn_layers,
                "fused_mapping": 1}
    sample_counts = sample(
        KT, config, model, dev, g, SAMPLE_BATCH, per_call,
        2 * flops.analytic_transformer_flops(config, 1), smi, "sampling",
        report=bf16_reports["sampling"])
    del model
    torch.cuda.empty_cache()

    with torch.no_grad():
        cases, overlap = backward_cases(dev)
        run_cases(cases, results, 20, 3)
        del cases
        overlap_counts = overlap_path(overlap)
        del overlap
        run_cases(wide_cases(dev), {}, 20, 3)
        attention_bit_check(dev)
        na_bit_check(dev)
        ffn_width_check(dev)

    grad_parity(KT, config, dev, fill_zero_init, "gradient parity",
                keep=cpu_ref["gradient"])
    hdit_flops = 2 * flops.analytic_transformer_flops(config, 1)
    train_counts, fused_ips = train(KT, config, dev, smi, TRAIN_BATCH,
                                    hdit_layout(KT, config, True), hdit_flops,
                                    "training",
                                    report=bf16_reports["training"])

    lap("phases 4-8")
    # the U-Net (config_cifar10.json): phases 9-12
    unet = KT.config.load_config(UNET_CONFIG)
    with torch.no_grad():
        run_cases(flash_cases(dev, unet), results, 20, 5)
        forward_lse_check(dev, unet)
    g = torch.Generator().manual_seed(SEED + 7)
    unet_flops = forward_flops(KT, unet)
    with torch.no_grad():
        model, counts = forward_parity(KT, unet, dev, fill_zero_init_unet, g,
                                       "unet forward")
    n_attn = sum(2 * d for d, a in zip(unet["model"]["depths"],
                                       unet["model"]["self_attn_depths"]) if a)
    if counts != dict.fromkeys(kernels.COUNTERS, 0) | {"flash": n_attn}:
        raise AssertionError(f"unet forward: launch counts {counts}")
    unet_sample, unet_train = {}, {}
    unet_sample_counts = sample(KT, unet, model, dev, g, UNET_BATCH,
                                {"flash": n_attn}, unet_flops, smi,
                                "unet sampling", report=unet_sample)
    del model
    torch.cuda.empty_cache()
    aug = torch.randn((2, 9), generator=torch.Generator().manual_seed(SEED + 8))
    grad_parity(KT, unet, dev, fill_zero_init_unet, "unet gradient parity",
                aug_cond=aug)
    unet_train_counts, _ = train(KT, unet, dev, smi, UNET_BATCH,
                                 {"flash": n_attn, "flash_bwd": n_attn},
                                 unet_flops, "unet training",
                                 report=unet_train)

    lap("phases 9-12")
    # the HDiT config whose global level K3 does not take: phase 13
    mnist = KT.config.load_config(MNIST_TRANSFORMER)
    g = torch.Generator().manual_seed(SEED + 9)
    classes = torch.randint(0, mnist["dataset"]["num_classes"],
                            (SAMPLE_BATCH,), generator=g)
    with torch.no_grad():
        _, counts = forward_parity(KT, mnist, dev, fill_zero_init, g,
                                   "mnist transformer forward", SAMPLE_BATCH,
                                   class_cond=classes)
    depth = sum(mnist["model"]["depths"])
    expected = dict.fromkeys(kernels.COUNTERS, 0) | {
        "fused_qkv": depth, "flash": depth, "fused_ffn": depth,
        "fused_mapping": 1}
    if counts != expected:
        raise AssertionError(f"mnist transformer forward: launch counts "
                             f"{counts} != expected {expected}")
    print(f"mnist transformer forward: launches {counts} (the 7 x 7 global "
          f"level through K13, none through K3)", flush=True)

    lap("phase 13")
    # the per-head NA kernels and the fused epilogue: phases 14 and 15
    with torch.no_grad():
        run_cases(heads_cases(dev), results, 20, 3)
        inputs = proj_inputs(dev)
        run_cases(proj_cases(inputs, dev), results, 50, 5)
        proj_bit_check(inputs)
    proj_counts = proj_path(inputs, results)
    del inputs
    torch.cuda.empty_cache()

    lap("phases 14-15")
    # the unfused training step, KDT_TRAIN_FUSION=0: phase 16
    unfused = hdit_unfused_layout(config)
    with train_fusion("0"):
        counts = grad_parity(KT, config, dev, fill_zero_init,
                             "unfused gradient parity")
        if counts != dict.fromkeys(kernels.COUNTERS, 0) | unfused:
            raise AssertionError(f"unfused gradient parity: launch counts "
                                 f"{counts} != {unfused}")
        unfused_counts, unfused_ips = train(
            KT, config, dev, smi, TRAIN_BATCH, unfused, hdit_flops,
            "unfused training", report=bf16_reports["unfused training"])
    print(f"unfused training: {unfused_ips:.3f} imgs/s against the fused "
          f"step's {fused_ips:.3f} (phase 8) on {smi}", flush=True)

    lap("phase 16")
    # head dim 32, configs/config_test_tiny.json: phase 17
    with torch.no_grad():
        run_cases(head32_cases(dev), results, 20, 5)
    tiny = KT.config.load_config(TEST_TINY)
    g = torch.Generator().manual_seed(SEED + 13)
    classes = torch.randint(0, tiny["dataset"]["num_classes"], (SAMPLE_BATCH,),
                            generator=g)
    with torch.no_grad():
        _, counts = forward_parity(KT, tiny, dev, fill_zero_init, g,
                                   "test_tiny forward", SAMPLE_BATCH,
                                   class_cond=classes)
    depth = sum(tiny["model"]["depths"])
    tiny_fwd = {"fused_qkv": depth, "flash": depth, "fused_ffn": depth,
                "fused_mapping": 1}
    if counts != dict.fromkeys(kernels.COUNTERS, 0) | tiny_fwd:
        raise AssertionError(f"test_tiny forward: launch counts {counts}")
    counts = grad_parity(KT, tiny, dev, fill_zero_init,
                         "test_tiny gradient parity", class_cond=classes[:2])
    tiny_step = tiny_fwd | {"fused_qkv_bwd": depth, "flash_bwd": depth,
                            "fused_ffn_bwd": depth}
    if counts != dict.fromkeys(kernels.COUNTERS, 0) | tiny_step:
        raise AssertionError(f"test_tiny gradient parity: launch counts "
                             f"{counts} != {tiny_step}")
    print(f"test_tiny: launches per forward {tiny_fwd}, per step {tiny_step} "
          f"(head dim 32 through K1/K6 and K13/K14)", flush=True)

    lap("phase 17")
    # the entry point's defaults: phase 18
    for name, cfg in (("flagship", config), ("unet", unet)):
        default_build_check(KT, cfg, name)

    # condcache and the sampler suite: phase 19; the sample entry point:
    # phase 20
    with torch.no_grad():
        strided_scale_check(KT, config, dev)
    condcache_phase(KT, config, dev, smi)
    lap("phases 18-19")
    entry_point_phase(KT, config, unet, smi)
    lap("phase 20")

    # the training entry point: phase 21
    trainer_phase(KT, config, unet, tiny, tiny_step, n_attn, fused_ips, smi)
    lap("phase 21")

    # the shifted-window HDiT, the ViT, the cross-attention and variance
    # U-Net, the multiscale loss: phase 22
    families_phase(KT, config, unet, dev, smi)
    lap("phase 22")

    # remat policies, 8-bit AdamW and SGD, guidance, the likelihood, FID and
    # KID in the trainer: phase 23
    engine_phase(KT, config, dev, smi, fused_ips)
    lap("phase 23")

    # data parallelism: phase 24
    data_parallel_phase(KT, config, dev, smi)
    lap("phase 24")

    # float32 compute on the card, the U-Net: phase 25
    f32_sample_counts, f32_train_counts = float32_phase(
        KT, unet, dev, smi, results, n_attn, unet_flops, unet_sample,
        unet_train)
    lap("phase 25")

    # float32 compute on the card, the ViT and the HDiT without
    # neighborhood levels: phase 26
    sw_f32_sample, sw_f32_train = transformers_float32_phase(KT, dev, smi,
                                                             results)
    lap("phase 26")

    # float32 compute on the card, the neighborhood-attention configs (the
    # flagship): phase 27
    na_f32_sample, na_f32_train, na_f32_unfused, f32_reports = \
        na_float32_phase(KT, config, dev, smi, results, cpu_ref, bf16_reports)
    del cpu_ref
    lap("phase 27")

    # the flagship with head dim 128 at its neighborhood levels, in bf16 and
    # float32; K15-f32 and K8-f32: phase 28
    na128_counts = na128_phase(KT, dev, smi, results, bf16_reports,
                               f32_reports)
    lap("phase 28")

    # name -> (source, TPU kernel, launches on its main path: the sampling
    # run for a forward kernel, the timed training steps for a backward one,
    # the unfused training steps for K11/K12, the op paths for K15 and K8,
    # phase 25's float32 runs for K13's and K14's float32 forms, phase 26's
    # shifted-window float32 runs for those of K1, K3-K6, K9 and K10, phase
    # 27's flagship float32 runs for those of K2, K7 (sampling, fused
    # training) and K11, K12 (unfused training), phase 28's NA-128 flagship
    # runs for K11 and K12 at head dim 128 in each dtype (sampling,
    # training) and its op paths for K15-f32 and K8-f32; a fourth element
    # names the launch counter where it is not the kernel's name)
    paths = {
        "fused_qkv": ("fused_qkv.cu", "fused_qkv.py:82", sample_counts),
        "na2d": ("na_fwd.cuh", "na2d.py:576", sample_counts),
        "global_packed": ("attn_fwd.cuh", "global_packed.py:57",
                          sample_counts),
        "fused_ffn": ("geglu.cu", "fused_ffn.py:42", sample_counts),
        "fused_mapping": ("geglu.cu", "fused_mapping.py:28", sample_counts),
        "fused_qkv_bwd": ("fused_qkv.cu", "fused_qkv.py:246", train_counts),
        "na2d_bwd": ("na_bwd.cuh", "na2d.py:701", train_counts),
        "na2d_overlap_add": ("na2d.cu", "na2d.py:809", overlap_counts),
        "global_packed_bwd": ("attn_bwd.cuh", "global_packed.py:111",
                              train_counts),
        "fused_ffn_bwd": ("geglu.cu", "fused_ffn.py:115", train_counts),
        "flash": ("attn_fwd.cuh", "flash.py:34", unet_sample_counts),
        "flash_bwd": ("attn_bwd.cuh", "flash.py:57", unet_train_counts),
        "na2d_heads": ("na_fwd.cuh", "na2d.py:180", unfused_counts),
        "na2d_heads_bwd": ("na_bwd.cuh", "na2d.py:241", unfused_counts),
        "na2d_proj": ("na_proj.cuh", "na2d.py:991", proj_counts),
        "flash_f32": ("attn_tf32.cuh", "flash.py:34", f32_sample_counts),
        "flash_bwd_f32": ("attn_tf32_bwd.cuh", "flash.py:57",
                          f32_train_counts),
    } | {name: (src, tpu, sw_f32_train if "bwd" in name else sw_f32_sample)
         for name, (src, tpu) in F32_KERNELS.items()} | {
        "na2d_f32": (*NA_F32_KERNELS["na2d_f32"], na_f32_sample),
        "na2d_bwd_f32": (*NA_F32_KERNELS["na2d_bwd_f32"], na_f32_train),
        "na2d_heads_f32": (*NA_F32_KERNELS["na2d_heads_f32"], na_f32_unfused),
        "na2d_heads_bwd_f32": (*NA_F32_KERNELS["na2d_heads_bwd_f32"],
                               na_f32_unfused)} | {
        name: (src, tpu, na128_counts[name], counter)
        for name, (src, tpu, counter) in NA128_KERNELS.items()}
    report = []
    for name, (src, tpu, counts, *counter) in paths.items():
        r = results[name]
        launched = counts[counter[0] if counter else name]
        if not launched:
            raise AssertionError(f"{name}: no launch on its main path")
        entry = {
            "name": name, "route": "cuda",
            "source": f"k_diffusion_tpu_torch/csrc/{src}",
            "replaces": f"k_diffusion_tpu/ops/pallas/{tpu}",
            "launches": launched,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["op_ms"] > r["byte_ms"] else "bytes",
            "library_ms": r["library_ms"]}
        for extra in ("composition_ms", "products_ms"):
            if extra in r:
                entry[extra] = r[extra]
        report.append(entry)
    print(json.dumps({"kernels": report}))
    print(f"chip_smoke: {time.perf_counter() - CLOCK.start:.1f} s in all",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# the kernels phase 2 reports, by library: the attention forward and
# backward (csrc/attn_fwd.cuh, attn_bwd.cuh), the neighborhood forward of
# K2 and K11 (csrc/na_fwd.cuh) and the backward's two of K7 and K12
# (csrc/na_bwd.cuh; OWN_V false in na2d, true in na2d_heads), the forwards
# K1 and K4, K6's and K10's (their first kernels and csrc/gemm.cuh's),
# K5's cluster kernel (f32 and bf16 weights) and K15's (csrc/na_proj.cuh);
# K8 (bf16 and float32 outputs); the float32 forms: K3's (csrc/attn_
# tf32.cuh) and K9's (csrc/attn_tf32_bwd.cuh's TF32 wgmma kernels), K1's,
# K4's and K5's (their kernels on csrc/gemm_tf32.cuh), K6's and K10's
# (their first kernels and csrc/gemm_tf32_wg.cuh's), K2's and K7's (in
# na2d), K11's and K12's (in na2d_heads; csrc/na_tf32.cuh, also at head
# dim 128, the backwards on attn_tf32_bwd.cuh's bodies) and K15's
# (csrc/na_proj_tf32.cuh)
REPORTED = {
    "global_packed": ("attn_fwd_kernel", "attn_dq_kernel", "attn_dkv_kernel",
                      "tf32_fwd_kernel", "tf32_wg_dq_kernel",
                      "tf32_wg_dkv_kernel"),
    "flash": ("attn_fwd_kernel", "attn_dq_kernel", "attn_dkv_kernel",
              "tf32_fwd_kernel", "tf32_wg_dq_kernel", "tf32_wg_dkv_kernel"),
    "na2d": ("na_fwd_kernel", "na_dq_kernel", "na_dkv_kernel",
             "na_tf32_fwd_kernel", "na_tf32_wg_dq_kernel",
             "na_tf32_wg_dkv_kernel", "na2d_overlap_add_kernel"),
    "na2d_heads": ("na_fwd_kernel", "na_dq_kernel", "na_dkv_kernel",
                   "na_proj_kernel", "na_tf32_fwd_kernel",
                   "na_tf32_wg_dq_kernel", "na_tf32_wg_dkv_kernel",
                   "na_proj_tf32_kernel"),
    "fused_qkv": ("qkv_fwd_kernel", "qkv_dr_kernel", "norm_vjp_kernel",
                  "atb_kernel", "reduce_kernel", "reduce_few_kernel"),
    "geglu": ("ffn_fwd_kernel", "ffn_dup_kernel", "norm_vjp_kernel",
              "atb_kernel", "reduce_kernel", "reduce_few_kernel",
              "mapping_kernel"),
    "fused_qkv_f32": ("qkv_f32_kernel", "qkv_f32_dr_kernel", "dxn_kernel",
                      "dw_kernel", "round_weights_kernel", "reduce_kernel"),
    "geglu_f32": ("ffn_f32_up_kernel", "ffn_f32_down_kernel",
                  "add_parts_kernel", "ffn_f32_dup_kernel", "rms_rows_kernel",
                  "dxn_kernel", "dw_kernel", "round_weights_kernel",
                  "reduce_t_kernel", "reduce_kernel"),
}

# instantiations the report must list: K11 and K12 at head dim 128 (the
# forward two blocks an SM, the dk/dv kernel two warpgroups a block), the
# float32 forms of K11 and K12 at head dim 128 (two warpgroups a block),
# the float32 attention backward's one-warpgroup kernels at head dims 32
# and 64 (K14, K12), K15's at both head dims, K8's two outputs, and
# K6-f32's first kernel at both head dims with one and two panels an item,
# and the dxn kernel of the float32 backwards at both widths
REPORTED_INSTANCES = ("na_fwd_kernel<128, true>", "na_dq_kernel<128, true>",
                      "na_dkv_kernel<128, true>",
                      "na_tf32_fwd_kernel<128>", "na_tf32_wg_dq_kernel<128>",
                      "na_tf32_wg_dkv_kernel<128>", "tf32_wg_dq_kernel<32>",
                      "tf32_wg_dkv_kernel<32>", "tf32_wg_dq_kernel<64>",
                      "tf32_wg_dkv_kernel<64>", "na_tf32_wg_dq_kernel<32>",
                      "na_tf32_wg_dkv_kernel<32>", "na_proj_tf32_kernel<32>",
                      "na_proj_tf32_kernel<64>",
                      "na2d_overlap_add_kernel<false>",
                      "na2d_overlap_add_kernel<true>",
                      "qkv_f32_dr_kernel<32, 1>", "qkv_f32_dr_kernel<32, 2>",
                      "qkv_f32_dr_kernel<64, 1>", "qkv_f32_dr_kernel<64, 2>",
                      "dxn_kernel<64>", "dxn_kernel<128>")


def compiler_report(build):
    """Registers and spills of the attention kernels (K3, K13: csrc/attn_
    fwd.cuh; K2, K11: csrc/na_fwd.cuh; K9, K14: csrc/attn_bwd.cuh; K7,
    K12: csrc/na_bwd.cuh), of the forwards K1 and K4, of K6's and K10's
    (csrc/gemm.cuh's core, each backward's first kernel), of K5's, of
    K15's (csrc/na_proj.cuh) and K8's, and of the float32 forms
    (``REPORTED``; ``REPORTED_INSTANCES`` by template argument), from the
    compiler report kept beside each library; raises if one spills or is
    missing."""
    import re

    seen, missing = {}, []
    for lib, names in REPORTED.items():
        # template arguments, each an int (Li64E) or a bool (Lb0E)
        pattern = re.compile(r"Compiling entry function '\w*?(%s)"
                             r"((?:I(?:L[ib]\d+E)+E)?)" % "|".join(names))
        found, fn, spill = set(), None, None
        for line in build.library_path(lib).with_suffix(".log").read_text(
                ).splitlines():
            m = pattern.search(line)
            if m:
                name, mangled = m.groups()
                args = [value if kind == "i" else ("false", "true")[int(value)]
                        for kind, value in re.findall(r"L([ib])(\d+)E",
                                                      mangled)]
                fn = f"{name}<{', '.join(args)}>" if args else name
                found.add(name)
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                seen[fn] = (int(m.group(1)), spill)
                fn = None
        missing += [f"{lib}: {n}" for n in names if n not in found]
    missing += [fn for fn in REPORTED_INSTANCES if fn not in seen]
    if missing or any(spill for _, spill in seen.values()):
        raise AssertionError(f"compiler report: missing {missing}, {seen}")
    print("compiler report: " + ", ".join(
        f"{fn} {regs} registers, {spill} bytes spilled"
        for fn, (regs, spill) in sorted(seen.items())), flush=True)


def default_build_check(KT, config, name):
    """Phase 18: ``make_model(config)`` with no dtype and no device builds
    on the card in bfloat16 (``utils.compute_dtype``), and its denoiser
    gives a finite output of the input's shape at batch 2 (fresh weights,
    eval mode); an explicit float32 on the card builds a float32 model for
    a model whose kernels take it (``config.card_dtypes``: every model the
    port builds, the U-Net and the flagship among them) and would raise
    ValueError naming bfloat16 before anything is allocated for another."""
    takes_f32 = torch.float32 in KT.config.card_dtypes(config)[0]
    try:
        built = KT.config.make_model(config, dtype=torch.float32)
    except ValueError as e:
        if takes_f32 or "bfloat16" not in str(e):
            raise
    else:
        if not takes_f32 or built.dtype != torch.float32:
            raise AssertionError(f"{name}: float32 compute on the card built "
                                 f"a {built.dtype} model")
        del built
    model = KT.config.make_model(config).eval()
    dev = next(model.parameters()).device
    if model.dtype != torch.bfloat16 or dev.type != "cuda":
        raise AssertionError(f"{name}: default build computes in "
                             f"{model.dtype} on {dev}")
    g = torch.Generator().manual_seed(SEED + 17)
    x = torch.randn(input_shape(config, 2), generator=g).to(dev)
    with torch.no_grad():
        out = KT.config.make_denoiser_wrapper(config)(model)(
            x, torch.tensor([0.5, 8.0], device=dev))
    if out.shape != x.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: default build's forward is not "
                             f"finite or has shape {tuple(out.shape)}")
    print(f"default build ({name}): make_model(config) computes in "
          f"{model.dtype} on {dev}; forward at batch 2 finite, "
          f"{tuple(out.shape)}; float32 on the card "
          f"{'builds' if takes_f32 else 'refused by name'}", flush=True)
    del model
    torch.cuda.empty_cache()


def hdit_levels(KT, config):
    """The config's depths, widths and d_ff as level specs, for the scale
    layout (which reads no attention kind but "none", and the flagship has
    attention at every level)."""
    m = config["model"]
    itv2 = KT.models.image_transformer_v2
    return tuple(itv2.LevelSpec(depth, width, d_ff, itv2.GlobalAttentionSpec(64))
                 for depth, width, d_ff in zip(m["depths"], m["widths"],
                                               m["d_ffs"]))


def strided_scale_check(KT, config, dev):
    """Phase 19, first part: K1 and K4 at the flagship's shapes, batch 8,
    their scale a (8, d) block of a (8, total) condcache row at the level's
    first layer's offset (row stride 7168). Each against its plain version
    on the same block, and bit for bit against the kernel on the block's
    contiguous copy; both kernels timed (CUDA events), summed over a
    denoiser call's launches."""
    from k_diffusion_tpu_torch.ops import kernels, rope
    from k_diffusion_tpu_torch.ops.kernels import fused_ffn, fused_qkv

    layout, total = KT.models.image_transformer_v2.cond_scale_layout(
        hdit_levels(KT, config))
    g = torch.Generator().manual_seed(SEED + 19)
    b, bf16 = SAMPLE_BATCH, torch.bfloat16
    row = (1 + 0.1 * torch.randn((b, total), generator=g)).to(dev, bf16)
    sums = collections.Counter()
    for h, d, d_ff, n, layer in ((64, 128, 384, 4, "down_0_layer_0"),
                                 (32, 256, 768, 4, "down_1_layer_0"),
                                 (16, 512, 1536, 4, "mid_layer_0")):
        heads = d // 64
        attn_off, ff_off = layout[layer]
        x = (torch.randn((b, h, h, d), generator=g)).to(dev, bf16)
        pos = rope.make_axial_pos(h, h, device=dev)
        w_qkv = lecun((d, 3 * d), g, dev)
        a_scale = torch.full((heads,), 10.0, device=dev)
        w_up, w_down = lecun((d, 2 * d_ff), g, dev), lecun((d_ff, d), g, dev)
        xt = x.reshape(b, h * h, d)
        for name, off, call, plain in (
                ("fused_qkv", attn_off,
                 lambda s: fused_qkv.fused_qkv_prologue(x, pos, s, w_qkv,
                                                        a_scale, heads),
                 lambda s: fused_qkv.reference(x, pos, s, w_qkv, a_scale,
                                               heads)),
                ("fused_ffn", ff_off,
                 lambda s: (fused_ffn.fused_geglu_ffn(xt, s, w_up, w_down),),
                 lambda s: (fused_ffn.reference(xt, s, w_up, w_down),))):
            block = row[:, off:off + d]
            if block.is_contiguous() or block.stride(0) != total:
                raise AssertionError(f"{name}: the scale block is not a "
                                     f"strided view: {block.stride()}")
            copy = block.contiguous()
            kernels.reset_launch_counts()
            got = call(block)
            if kernels.launch_counts()[name] != 1:
                raise AssertionError(f"{name}: the strided scale did not "
                                     "launch the kernel")
            label = f"{name} strided scale {b}x{h}x{h}x{d} (offset {off})"
            err = max(check_close(label, a, p, KERNEL_REL_BOUND)[0]
                      for a, p in zip(got, plain(block)))
            if not all(torch.equal(a, c) for a, c in zip(got, call(copy))):
                raise AssertionError(f"{label}: differs from the kernel on "
                                     "the block's contiguous copy")
            strided_ms = device_ms(lambda: call(block), 50)
            contig_ms = device_ms(lambda: call(copy), 50)
            sums[name, "strided"] += n * strided_ms
            sums[name, "contiguous"] += n * contig_ms
            print(f"{label}: max abs err {err:.3e} against plain (bound "
                  f"{KERNEL_REL_BOUND}), bit-equal to the contiguous copy's; "
                  f"{strided_ms:.4f} ms, contiguous {contig_ms:.4f} ms",
                  flush=True)
    for name in ("fused_qkv", "fused_ffn"):
        print(f"{name} per denoiser call: strided scale "
              f"{sums[name, 'strided']:.4f} ms, contiguous "
              f"{sums[name, 'contiguous']:.4f} ms", flush=True)
    torch.cuda.empty_cache()


def condcache_phase(KT, config, dev, smi):
    """Phase 19: condcache on the flagship at batch 8 (seeded weights,
    zero-init projections filled with noise, bfloat16, eval), then the 13
    samplers as the sample entry point runs them."""
    from k_diffusion_tpu_torch import condcache
    from k_diffusion_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(SEED + 19)
    model = KT.config.make_model(config, dtype=torch.bfloat16, device="cpu",
                                 generator=g)
    fill_zero_init(model, g)
    model.to(dev).eval()
    m = config["model"]
    wrap = KT.config.make_denoiser_wrapper(config)
    sigmas = KT.sampling.get_sigmas_karras(STEPS, m["sigma_min"],
                                           m["sigma_max"], rho=7.0, device=dev)
    b = SAMPLE_BATCH
    # a cached call launches no K5
    per_call = {k: v for k, v in hdit_layout(KT, config, False).items()
                if k != "fused_mapping"}
    zero = dict.fromkeys(kernels.COUNTERS, 0)
    x = (torch.randn(input_shape(config, b), generator=g)
         * m["sigma_max"]).to(dev)
    uncached = wrap(model)
    with torch.no_grad():
        uncached(x, sigmas[:1].expand(b))  # warm up at this batch
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        inner = condcache.ScheduledModel(model, sigmas[:-1], b)
        torch.cuda.synchronize()
        table_secs = time.perf_counter() - start
        counts = kernels.launch_counts()
        if counts != zero | {"fused_mapping": STEPS}:
            raise AssertionError(f"condcache table: launch counts {counts}")
        cached = wrap(inner)
        print(f"condcache table: {tuple(inner.scales_table.shape)} "
              f"{inner.scales_table.dtype} in {table_secs:.3f} s, one K5 "
              f"launch per schedule sigma ({counts['fused_mapping']})",
              flush=True)
        probes = (0, STEPS // 2, STEPS - 1)
        for i in probes:
            s = sigmas[i:i + 1].expand(b)
            kernels.reset_launch_counts()
            got = cached(x, s)
            counts = kernels.launch_counts()
            want = uncached(x, s)
            if counts != zero | per_call:
                raise AssertionError(f"cached call: launch counts {counts} "
                                     f"!= {zero | per_call}")
            if not torch.equal(got, want):
                diff = (got - want).abs().max().item()
                raise AssertionError(f"cached call at sigma {s[0].item()}: "
                                     f"differs from uncached by {diff:.3e}")
        inner.check()
        print(f"condcache call: cached equals uncached bit for bit at "
              f"sigmas {[round(sigmas[i].item(), 4) for i in probes]}; "
              f"launches a cached call {counts}", flush=True)

    busy = {}
    for name, den in (("cached", cached), ("uncached", uncached)):
        def calls(n, den=den):
            with torch.no_grad():
                for _ in range(n):
                    den(x, sigmas[:1].expand(b))
        busy[name] = profile(calls, f"condcache {name}", "denoiser calls")
    print(f"condcache card time per denoiser call, batch {b}: cached "
          f"{busy['cached']:.3f} ms, uncached {busy['uncached']:.3f} ms on "
          f"{smi}", flush=True)

    with torch.no_grad():
        runs = {}
        for name, den in (("cached", cached), ("uncached", uncached)):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            start = time.perf_counter()
            out = KT.sampling.sample_dpmpp_2m(den, x, sigmas)
            torch.cuda.synchronize()
            runs[name] = (out, time.perf_counter() - start,
                          kernels.launch_counts())
        inner.check()
        want = {k: STEPS * v for k, v in per_call.items()}
        if runs["cached"][2] != zero | want:
            raise AssertionError(f"cached DPM++(2M): launch counts "
                                 f"{runs['cached'][2]} != {zero | want}")
        if runs["uncached"][2] != zero | want | {"fused_mapping": STEPS}:
            raise AssertionError(f"uncached DPM++(2M): launch counts "
                                 f"{runs['uncached'][2]}")
        if not torch.equal(runs["cached"][0], runs["uncached"][0]):
            raise AssertionError("cached DPM++(2M) differs from uncached")
        if not torch.isfinite(runs["cached"][0]).all():
            raise AssertionError("cached DPM++(2M): output not finite")
        print(f"condcache {STEPS}-step DPM++(2M), batch {b}: cached equals "
              f"uncached bit for bit; cached {b / runs['cached'][1]:.3f} "
              f"samples/s ({runs['cached'][1]:.3f} s, table excluded), "
              f"uncached {b / runs['uncached'][1]:.3f} samples/s on {smi}; "
              f"launches cached {runs['cached'][2]}", flush=True)

        for name in KT.sampling.SAMPLERS:
            use_cache = name in condcache.SCHEDULE_POINT_SAMPLERS
            calls = [0]
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            start = time.perf_counter()
            scheduled = (condcache.ScheduledModel(model, sigmas[:-1], b)
                         if use_cache else None)
            den = wrap(scheduled) if use_cache else uncached

            def counted(x, sigma, den=den):
                calls[0] += 1
                return den(x, sigma)

            out = KT.sampling.call_sampler(
                name, counted, x, sigmas,
                generator=torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            counts = kernels.launch_counts()
            if use_cache:
                scheduled.check()
            n = calls[0]
            want = zero | {k: n * v for k, v in per_call.items()} | {
                "fused_mapping": STEPS if use_cache else n}
            if counts != want:
                raise AssertionError(f"sampler {name}: launch counts {counts} "
                                     f"!= {n} calls x the layout {want}")
            if out.shape != x.shape or not torch.isfinite(out).all():
                raise AssertionError(f"sampler {name}: output not finite or "
                                     f"of shape {tuple(out.shape)}")
            print(f"sampler {name}: {n} model calls"
                  f"{' through condcache' if use_cache else ''}, "
                  f"{b / secs:.3f} samples/s at batch {b} ({secs:.3f} s, "
                  f"table included) on {smi}; launches match the layout",
                  flush=True)
    del model, inner, cached, uncached
    torch.cuda.empty_cache()


def check_png(path, size):
    """A PNG file of ``size`` x ``size`` 8-bit RGB pixels, read with zlib
    (the card's machine has no Pillow): the header and every row."""
    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path.name}: not a PNG")
    chunks, pos = {}, 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        chunks[kind] = chunks.get(kind, b"") + data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    pixels = zlib.decompress(chunks[b"IDAT"])
    if (w, h, depth, color) != (size, size, 8, 2) or \
            len(pixels) != h * (1 + 3 * w):
        raise AssertionError(f"{path.name}: {w} x {h}, depth {depth}, colour "
                             f"type {color}, {len(pixels)} bytes of rows")


def entry_point_phase(KT, config, unet, smi):
    """Phase 20: an inference checkpoint in bfloat16 (seeded weights,
    zero-init tensors filled with noise), then the sample entry point on it
    in-process on the card: 8 PNGs each for the flagship under LMS and the
    U-Net under DPM++(2M)."""
    for name, cfg, fill, sampler in (
            ("flagship", config, fill_zero_init, "lms"),
            ("unet", unet, fill_zero_init_unet, "dpmpp_2m")):
        sample_entry(KT, name, cfg, fill, sampler, smi)


def sample_entry(KT, name, cfg, fill, sampler, smi):
    """A bfloat16 inference checkpoint of ``cfg`` (seeded weights,
    zero-init tensors filled by ``fill``), then the entry point
    ``k_diffusion_tpu_torch.sample`` on it in-process on the card, which
    must write 8 PNGs."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        g = torch.Generator().manual_seed(SEED + 20)
        model = KT.config.make_model(cfg, device="cpu", generator=g)
        fill(model, g)
        ckpt = KT.checkpoint.save_inference(
            tmp / f"{name}.safetensors", model, cfg, dtype=torch.bfloat16)
        del model
        out, secs = call_entry("sample", "--checkpoint", ckpt,
                               "--sampler", sampler, "-n", 8,
                               "--batch-size", 8, "--prefix", tmp / name)
        files = sorted(tmp.glob(f"{name}_*.png"))
        if [f.name for f in files] != [f"{name}_{i:05}.png"
                                       for i in range(8)]:
            raise AssertionError(f"sample entry point ({name}) wrote "
                                 f"{[f.name for f in files]}")
        for f in files:
            check_png(f, cfg["model"]["input_size"][0])
        print(f"sample entry point ({name}, {sampler}): 8 PNGs from a "
              f"bfloat16 checkpoint of {ckpt.stat().st_size} bytes in "
              f"{secs:.1f} s in-process (model build included) on "
              f"{smi}; its output: "
              f"{' | '.join(out.strip().splitlines())}",
              flush=True)


# a custom dataset (the config's ``custom`` type): ``entries`` items
# cycling over the float32 (n, h, w, 3) images saved at ``path``
IN_MEMORY_DATASET = """import numpy as np


class InMemory:
    def __init__(self, path, entries):
        self.images = np.load(path)
        self.entries = entries

    def __len__(self):
        return self.entries

    def __getitem__(self, i):
        return {"image": self.images[i % len(self.images)]}


def get_dataset(config, size):
    return InMemory(config["path"], config["entries"])
"""


def loader_rates(KT, root, workers, repeats):
    """Images/s of the port's loader alone over the PNG folder ``root`` at
    the trainer's batch of 32 and 256 x 256 (decode and stack): one epoch
    each, ``repeats`` epochs after a first one that is not timed."""
    loader = KT.data.DataLoader(KT.data.FolderOfImages(root, 256),
                                TRAIN_BATCH, num_workers=workers)

    def epoch():
        start = time.perf_counter()
        n = sum(b["image"].shape[0] for b in loader)
        return n / (time.perf_counter() - start)

    epoch()
    return [epoch() for _ in range(repeats)]


def spread(rates):
    """'median (min-max)' of a list of rates."""
    rates = sorted(rates)
    return (f"{rates[len(rates) // 2]:.1f} ({rates[0]:.1f}-"
            f"{rates[-1]:.1f})")


def trace_syncs(trace_dir):
    """The host-blocking CUDA runtime calls (synchronisations, blocking
    copies, pinned allocations) in the one chrome trace under
    ``trace_dir``, by name: (those made while steps were in flight, before
    the trace's last kernel launch; those after it, where the trainer and
    the profiler synchronise to end the trace)."""
    (path,) = Path(trace_dir).glob("*.json")
    events = [ev for ev in json.loads(path.read_text())["traceEvents"]
              if ev.get("cat") == "cuda_runtime"]
    last = max(ev["ts"] for ev in events
               if ev["name"].startswith("cudaLaunchKernel"))
    during, after = {}, {}
    for ev in events:
        name = ev["name"]
        if ("Synchronize" in name or name in ("cudaMemcpy", "cudaMemset")
                or name.startswith(("cudaHostAlloc", "cudaFreeHost"))):
            side = during if ev["ts"] < last else after
            side[name] = side.get(name, 0) + 1
    return during, after


def run_entry(module, *args):
    """``python -m k_diffusion_tpu_torch.<module> args`` from the checkout;
    raises with its output if it fails. Returns (stdout, seconds)."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           f"k_diffusion_tpu_torch.{module}", *map(str, args)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise AssertionError(f"{module} failed:\n{proc.stdout[-3000:]}"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - start


def call_entry(module, *args, env=None):
    """``k_diffusion_tpu_torch.<module>.main(args)`` in this process: the
    entry point as run_entry runs it, without a process start, a CUDA
    context and a kernel load of its own. ``env``: variables set for the
    call. TF32 flags, which the trainer sets, are restored after it.
    Returns (its stdout, seconds)."""
    import importlib
    import io

    entry = importlib.import_module(f"k_diffusion_tpu_torch.{module}").main
    saved = {k: os.environ.get(k) for k in env or {}}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    os.environ.update(env or {})
    out = io.StringIO()
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            entry([str(a) for a in args])
    except BaseException:
        sys.stderr.write(f"{module} failed in-process; its output:\n"
                         f"{out.getvalue()[-3000:]}\n")
        raise
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - start
    torch.cuda.empty_cache()
    return out.getvalue(), secs


def flat_weights(payload, key):
    return torch.cat([t.float().flatten() for t in payload[key].values()])


def trainer_phase(KT, config, unet, tiny, tiny_step, n_attn, fused_ips, smi):
    """Phase 21: the training entry point on the card. The loader alone at
    the trainer's batch 32 (images/s at 1, 4 and 8 threads, each over
    timed epochs after an untimed one, on 1 024 entries linking 128 PNGs
    written by to_png, and at 1 thread on one batch of Paeth-filtered
    files); the flagship at full
    width as a subprocess on the 128 PNGs at 256 x 256 (6 steps at batch
    32, saves at 3 and 6, a demo at 6), resumed mid-epoch from step 3 to
    6 through the entry point in-process (its params and EMA against the
    first run's); the flagship in-process on the 1 024 entries for 26 steps,
    its launch counts against phase 8's layout and its images/s over
    steps 1-25 (the trainer's own window between its prints at 0 and 25,
    with and without the loader's waits) beside phase 8's bare step;
    config_test_tiny in-process with two microbatches and --gns (class
    dropout and the augmentation warp on the card) for 17 steps under
    --profile-dir, whose trace of steps 10-15 must hold no host-blocking
    call but the trainer's own synchronisation before the trace ends; the
    cifar10 U-Net on raw CIFAR-10 batch files, each with its launch
    counts; then convert_for_inference (in-process) and the sample entry
    point (a subprocess) on the flagship's checkpoint."""
    from k_diffusion_tpu_torch import train as train_cli
    from k_diffusion_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        g = torch.Generator().manual_seed(SEED + 21)
        # smooth seeded images: 16 x 16 noise upsampled, a little grain
        coarse = torch.rand((128, 3, 16, 16), generator=g)
        images = (F.interpolate(coarse, size=(256, 256), mode="bilinear")
                  * 0.9 + torch.rand((128, 3, 256, 256), generator=g) * 0.1)
        images = (images * 255).round().permute(0, 2, 3, 1) / 127.5 - 1
        folder, many, paeth = tmp / "flowers", tmp / "many", tmp / "paeth"
        for d in (folder, many, paeth):
            d.mkdir()
        for i, x in enumerate(images):
            KT.utils.to_png(x, folder / f"{i:04}.png")
            if i < TRAIN_BATCH:
                KT.utils.to_png(x, paeth / f"{i:04}.png", row_filter=4)
        for i in range(1024):
            (many / f"{i:04}.png").symlink_to(folder / f"{i % 128:04}.png")
        rates = {f"to_png {workers}": loader_rates(KT, many, workers, 2)
                 for workers in (1, 4, 8)}
        # Paeth-filtered rows decode in a Python loop at one rate on any
        # thread count, so one batch at one thread drives that path
        rates["paeth 1"] = loader_rates(KT, paeth, 1, 1)
        print(f"loader alone: 256 x 256 PNGs, batch {TRAIN_BATCH}, images/s "
              f"by threads, median (min-max) of timed epochs after an "
              f"untimed one (to_png: 2 epochs of 1 024 entries linking 128 "
              f"files; paeth: 1 epoch of {TRAIN_BATCH} Paeth-filtered "
              f"files, 1 batch): "
              f"{ {k: spread(r) for k, r in rates.items()} }; every epoch "
              f"{ {k: [round(x, 1) for x in r] for k, r in rates.items()} } "
              f"on the host of {smi} ({os.cpu_count()} cores)", flush=True)
        CLOCK.part("phase 21 loader")

        # the flagship, its dataset replaced by the folder
        cfg = json.loads(CONFIG.read_text())
        cfg["dataset"] = {"type": "imagefolder", "location": str(folder)}
        cfg_path = tmp / "flowers.json"
        cfg_path.write_text(json.dumps(cfg))
        run = tmp / "flag"
        out, secs = run_entry("train", "--config", cfg_path, "--batch-size",
                              32, "--end-step", 6, "--save-every", 3,
                              "--demo-every", 6, "--sample-n", 4, "--name", run)
        for f in ("flag_00000003.ckpt", "flag_00000006.ckpt",
                  "flag_state.json"):
            if not (tmp / f).exists():
                raise AssertionError(f"trainer: no {f}:\n{out}")
        check_png(tmp / "flag_demo_00000006.png", 512)
        print(f"trainer (flagship, subprocess): 6 steps at batch 32 in "
              f"{secs:.1f} s with process start, build and demo; its "
              f"output: {' | '.join(out.strip().splitlines())}", flush=True)
        resumed = tmp / "resumed"
        out, secs = call_entry("train", "--config", cfg_path,
                               "--batch-size", 32, "--end-step", 6,
                               "--save-every", 3, "--demo-every", 0,
                               "--resume", tmp / "flag_00000003.ckpt",
                               "--name", resumed)
        a = torch.load(tmp / "flag_00000006.ckpt", map_location="cpu",
                       weights_only=True)
        b = torch.load(tmp / "resumed_00000006.ckpt", map_location="cpu",
                       weights_only=True)
        mid = torch.load(tmp / "flag_00000003.ckpt", map_location="cpu",
                         weights_only=True)["host"]
        if mid["batch_in_epoch"] != 3 or b["host"]["step"] != 6:
            raise AssertionError(f"resume: saved at batch "
                                 f"{mid['batch_in_epoch']} of its epoch, "
                                 f"resumed run at step {b['host']['step']}")
        errs, equal = {}, True
        for key in ("model", "model_ema"):
            x, y = flat_weights(a, key), flat_weights(b, key)
            errs[key] = ((x - y).norm() / x.norm()).item()
            equal = equal and torch.equal(x, y)
            if not errs[key] <= 1e-3:
                raise AssertionError(f"resume: {key} relative L2 "
                                     f"{errs[key]:.3e} > 1e-3")
        print(f"trainer resume (in-process, from step 3, batch 3 of 4 in its "
              f"epoch, to 6, {secs:.1f} s): params relative L2 "
              f"{errs['model']:.3e}, EMA {errs['model_ema']:.3e} (bound "
              f"1e-3), bit-equal {equal}; its output: "
              f"{' | '.join(out.strip().splitlines())}", flush=True)
        print(f"trainer images/s from the checkpoints' elapsed (3 steps "
              f"a window: indicative only, the 25-step window below is the "
              f"measurement): {6 * 32 / a['host']['elapsed']:.3f} over steps "
              f"0-5 (the first step's warm-up included), "
              f"{3 * 32 / (a['host']['elapsed'] - mid['elapsed']):.3f} over "
              f"steps 3-5 of that run, on {smi}", flush=True)

        # in-process runs, their launches counted
        CLOCK.part("phase 21 trainer and resume")
        def counted(name, cfg, steps, per_step, *flags):
            cfg_path = tmp / f"{name}.json"
            cfg_path.write_text(json.dumps(cfg))
            kernels.reset_launch_counts()
            window = train_cli.main([
                "--config", str(cfg_path), "--end-step", str(steps),
                "--demo-every", "0", "--save-every", "0", "--name",
                str(tmp / name), *flags])
            counts = kernels.launch_counts()
            expected = dict.fromkeys(kernels.COUNTERS, 0) | {
                k: steps * v for k, v in per_step.items()}
            if counts != expected:
                raise AssertionError(f"trainer ({name}): launch counts "
                                     f"{counts} != {expected}")
            host = torch.load(tmp / f"{name}_{steps:08}.ckpt",
                              map_location="cpu", weights_only=True)["host"]
            print(f"trainer ({name}, in-process): {steps} steps, launches "
                  f"per step {per_step}; loss EMA "
                  f"{host['ema_stats']['loss']:.5f}, gns "
                  f"{(host['gns_stats'] or {}).get('gradient_noise_scale')}",
                  flush=True)
            return window

        # the same 1 024 entries from the PNGs (decoded by 8 loader
        # threads) and from memory (a custom dataset over the decoded
        # arrays): the difference is what decoding costs the step
        np.save(tmp / "images.npy", np.stack(
            [KT.data.load_image(folder / f"{i:04}.png", 256)
             for i in range(128)]))
        (tmp / "in_memory.py").write_text(IN_MEMORY_DATASET)
        sources = {
            "PNG files": {"type": "imagefolder", "location": str(many)},
            "memory": {"type": "custom",
                       "location": str(tmp / "in_memory.py"),
                       "config": {"path": str(tmp / "images.npy"),
                                  "entries": 1024}}}
        for source, dataset in sources.items():
            cfg["dataset"] = dataset
            w = counted(f"flagship_{dataset['type']}", cfg, 26,
                        hdit_layout(KT, config, True), "--batch-size",
                        str(TRAIN_BATCH))
            if w["steps"] != 25:
                raise AssertionError(f"trainer (flagship): window {w}")
            wall = w["body_s"] + w["wait_s"]
            print(f"trainer images/s (flagship, in-process, batch "
                  f"{TRAIN_BATCH}, 1 024 entries from {source}, 8 loader "
                  f"threads, steps 1-25 after the first): "
                  f"{w['images'] / w['body_s']:.3f} over the step bodies "
                  f"(what the checkpoint's elapsed adds up), "
                  f"{w['images'] / wall:.3f} with the loader's waits "
                  f"({w['wait_s'] / wall:.1%} of the wall time waiting), "
                  f"against the bare step's {fused_ips:.3f} (phase 8, 20 "
                  f"steps after 3) on {smi}", flush=True)

        CLOCK.part("phase 21 flagship in-process")
        tiny_cfg = json.loads(TEST_TINY.read_text())
        prof = tmp / "prof"
        counted("tiny", tiny_cfg, 17, {k: 2 * v for k, v in tiny_step.items()},
                "--batch-size", "8", "--grad-accum-steps", "2", "--gns",
                "--profile-dir", str(prof))
        during, after = trace_syncs(prof)
        if during:
            raise AssertionError(f"trainer (tiny): host-blocking calls while "
                                 f"steps 10-15 were in flight: {during}")
        print(f"trainer (tiny) trace of steps 10-15 (augmentation warp, class "
              f"dropout, 2 microbatches, GNS): no host-blocking call while "
              f"the steps were in flight; after the last launch {after} (the "
              f"trainer's and the profiler's, ending the trace)", flush=True)
        cifar = tmp / "cifar"
        cifar.mkdir()
        for i in range(1, 6):
            data = torch.randint(0, 256, (64, 3072), dtype=torch.uint8,
                                 generator=g)
            with open(cifar / f"data_batch_{i}", "wb") as f:
                pickle.dump({b"data": data.numpy(),
                             b"labels": torch.randint(0, 10, (64,),
                                                      generator=g).tolist()},
                            f)
        unet_cfg = json.loads(UNET_CONFIG.read_text())
        unet_cfg["dataset"]["location"] = str(cifar)
        counted("unet", unet_cfg, 3, {"flash": n_attn, "flash_bwd": n_attn},
                "--batch-size", str(UNET_BATCH))

        # the chain on the card
        inference = tmp / "flag.safetensors"
        CLOCK.part("phase 21 tiny and U-Net in-process")
        call_entry("convert_for_inference", tmp / "flag_00000006.ckpt",
                   inference)
        out, secs = run_entry("sample", "--checkpoint", inference, "-n", 8,
                              "--batch-size", 8, "--prefix", tmp / "chain")
        for i in range(8):
            check_png(tmp / f"chain_{i:05}.png", 256)
        print(f"trainer chain: convert_for_inference of the step-6 "
              f"checkpoint ({inference.stat().st_size} bytes, bfloat16), "
              f"then the sample entry point: 8 PNGs in {secs:.1f} s; its "
              f"output: {' | '.join(out.strip().splitlines())}", flush=True)


# phase 22: the rest of the model surface
SHIFTED_WINDOW = ROOT / "configs" / "config_oxford_flowers_shifted_window.json"
# the ViT at DiT-B/2's width and depth (Peebles & Xie 2023, "Scalable
# Diffusion Models with Transformers", Table 1: 12 layers, width 768, 12
# heads of 64), patch 2 on 32 x 32 x 3: 256 tokens, d_ff 2048 (the
# config's 8/3 rule); EDM's sigma range and training density
VIT_CONFIG = {"model": {"type": "image_transformer_v1", "input_channels": 3,
                        "input_size": [32, 32], "patch_size": 2, "depth": 12,
                        "width": 768, "dropout_rate": 0.0, "sigma_data": 0.5,
                        "sigma_min": 2e-3, "sigma_max": 80.0,
                        "sigma_sample_density": {"type": "lognormal",
                                                 "mean": -1.2, "std": 1.2}},
              "dataset": {"type": "imagefolder"}}
# the cross-attention sequence: CLIP's text length
CROSS_TOKENS = 77
# a checkpointed step against the plain one where the backward is allowed
# to sum in a varying order (PyTorch's memory-efficient attention backward,
# which the shifted windows run): relative L2 of the gradient and params
REMAT_REL_BOUND = 1e-3


def one_step(KT, config, dev, batch, fill, seed, cond=None, **model_kw):
    """One training step at ``batch`` from seeded weights (zero-init tensors
    filled by ``fill``), reals, noise, sigmas and dropout masks (dropout as
    the config has it): the loss, its gradient and the params after the
    optimizer, with the launch counts and the peak memory of the loss and
    its backward. ``cond``: the model's other inputs (on the card);
    ``model_kw`` go to make_model (checkpointing, remat_policy)."""
    from k_diffusion_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(seed)
    model = KT.config.make_model(config, dtype=torch.bfloat16, device="cpu",
                                 generator=g, **model_kw)
    fill(model, g)
    reals = torch.randn(input_shape(config, batch), generator=g).clamp(-1, 1)
    model.to(dev).train()
    opt = KT.training.make_optimizer(config, model)
    den = KT.config.make_denoiser_wrapper(config)(model)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    sigma = KT.config.make_sample_density(config["model"])(
        (batch,), generator=gen, device=dev)
    noise = torch.randn(reals.shape, generator=gen, device=dev)
    loss = den.loss(reals.to(dev), noise, sigma, generator=gen,
                    **(cond or {})).mean()
    grads = torch.autograd.grad(loss, opt.params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counts = kernels.launch_counts()
    for p, grad in zip(opt.params, grads):
        p.grad = grad.contiguous()
    opt.step(0)
    flat = lambda ts: torch.cat([t.detach().float().flatten() for t in ts])
    out = (loss.detach().float().cpu(), flat(grads).cpu(),
           flat(opt.params).cpu(), peak, counts)
    del model, opt, den, grads
    torch.cuda.empty_cache()
    return out


def remat_check(KT, config, dev, name, exact, fill=None, batch=TRAIN_BATCH,
                variants=(("all levels", {}), ("level 0", {"remat_levels": (0,)}))):
    """Phase 22: one step at ``batch`` with dropout on, without
    checkpointing and with it over each of ``variants``, from the same
    weights, data and generator seed: the loss, the gradient and the params
    after AdamW against the step without it, bit for bit where ``exact``
    (the flagship's kernels sum in a fixed order), else within
    REMAT_REL_BOUND, bit-equality printed; the peak memory of each.
    Returns the launch counts of the plain step and of each variant's."""
    fill = fill or fill_zero_init
    plain = one_step(KT, config, dev, batch, fill, SEED + 23)
    counts = [plain[4]]
    print(f"{name} remat: plain step at batch {batch}, dropout "
          f"{config['model']['dropout_rate']}: loss {plain[0].item():.6f}, "
          f"peak memory {plain[3] / 2**30:.3f} GiB; launches {plain[4]}",
          flush=True)
    for label, kw in variants:
        got = one_step(KT, config, dev, batch, fill, SEED + 23,
                       checkpointing=True, **kw)
        equal = all(torch.equal(a, b) for a, b in zip(got[:3], plain[:3]))
        rels = [((a - b).norm() / b.norm()).item()
                for a, b in zip(got[1:3], plain[1:3])]
        if exact and not equal:
            raise AssertionError(f"{name} remat over {label}: not bit-equal "
                                 f"to the plain step (relative L2 gradient "
                                 f"{rels[0]:.3e}, params {rels[1]:.3e})")
        if not max(rels) <= REMAT_REL_BOUND:
            raise AssertionError(f"{name} remat over {label}: relative L2 "
                                 f"{rels} > {REMAT_REL_BOUND}")
        print(f"{name} remat over {label}: bit-equal to the plain step: "
              f"{equal} (loss {got[0].item():.6f}; relative L2 gradient "
              f"{rels[0]:.3e}, params {rels[1]:.3e}; bound "
              f"{'bit-equality' if exact else REMAT_REL_BOUND}); peak memory "
              f"{got[3] / 2**30:.3f} GiB against {plain[3] / 2**30:.3f}; "
              f"launches {got[4]}", flush=True)
        counts.append(got[4])
    return counts


def shifted_window_phase(KT, flagship, dev, smi):
    """Phase 22 (a): config_oxford_flowers_shifted_window.json at full
    width and depth: forward and gradient parity, 50-step DPM++(2M) at
    batch 8 (no K2: the windows are PyTorch ops, listed by name in the
    profile), condcache, 3 + 20 training steps at batch 32, checkpointed
    steps on it and on the flagship, and the sample entry point."""
    from k_diffusion_tpu_torch import condcache
    from k_diffusion_tpu_torch.models import flops
    from k_diffusion_tpu_torch.ops import kernels

    config = KT.config.load_config(SHIFTED_WINDOW)
    zero = dict.fromkeys(kernels.COUNTERS, 0)
    per_call = hdit_layout(KT, config, False)
    per_step = hdit_layout(KT, config, True)
    g = torch.Generator().manual_seed(SEED + 22)
    with torch.no_grad():
        model, counts = forward_parity(KT, config, dev, fill_zero_init, g,
                                       "shifted-window forward")
    if counts != zero | per_call:
        raise AssertionError(f"shifted-window forward: launch counts {counts} "
                             f"!= {zero | per_call}")
    counts = grad_parity(KT, config, dev, fill_zero_init,
                         "shifted-window gradient parity")
    # dropout off: every feed-forward block fused
    want = zero | per_step | {"fused_ffn": per_call["fused_ffn"],
                              "fused_ffn_bwd": per_call["fused_ffn"]}
    if counts != want:
        raise AssertionError(f"shifted-window gradient parity: launch counts "
                             f"{counts} != {want}")
    fwd = 2 * flops.analytic_transformer_flops(config, 1)
    window_ops = ("aten::roll", "aten::scaled_dot_product_attention",
                  "aten::_scaled_dot_product_efficient_attention",
                  "aten::_scaled_dot_product_flash_attention",
                  "aten::_efficient_attention_forward",
                  "aten::_efficient_attention_backward", "aten::copy_")
    sample(KT, config, model, dev, g, SAMPLE_BATCH, per_call, fwd, smi,
           "shifted-window sampling", ops=window_ops)

    m = config["model"]
    sigmas = KT.sampling.get_sigmas_karras(STEPS, m["sigma_min"],
                                           m["sigma_max"], rho=7.0, device=dev)
    x = (torch.randn(input_shape(config, SAMPLE_BATCH), generator=g)
         * m["sigma_max"]).to(dev)
    wrap = KT.config.make_denoiser_wrapper(config)
    with torch.no_grad():
        inner = condcache.ScheduledModel(model, sigmas[:-1], SAMPLE_BATCH)
        kernels.reset_launch_counts()
        cached = KT.sampling.sample_dpmpp_2m(wrap(inner), x, sigmas)
        counts = kernels.launch_counts()
        inner.check()
        uncached = KT.sampling.sample_dpmpp_2m(wrap(model), x, sigmas)
    want = zero | {k: STEPS * v for k, v in per_call.items()
                   if k != "fused_mapping"}
    if counts != want or not torch.equal(cached, uncached):
        raise AssertionError(f"shifted-window condcache: launch counts "
                             f"{counts} (want {want}), bit-equal "
                             f"{torch.equal(cached, uncached)}")
    print(f"shifted-window condcache: {STEPS}-step DPM++(2M) at batch "
          f"{SAMPLE_BATCH}, cached equals uncached bit for bit; launches "
          f"cached {counts}", flush=True)
    del model, inner
    torch.cuda.empty_cache()

    train(KT, config, dev, smi, TRAIN_BATCH, per_step, fwd,
          "shifted-window training")
    remat_check(KT, flagship, dev, "flagship", exact=True)
    remat_check(KT, config, dev, "shifted-window", exact=False)
    sample_entry(KT, "shifted_window", config, fill_zero_init, "dpmpp_2m", smi)


def vit_cases(dev):
    """K5 at the ViT's DiT-B/2 width (d 768, d_ff 2048, depth 2, float32
    weights) at batch 64, whose layer shares stream, and at the HDiT's 256
    / 768 at batch 8 (resident; phase 3's counted case); K13 and K14 at the
    ViT's attention, (64, 256, 12, 64), q, k, v strided views of one (b,
    s, 3, heads, 64) tensor as the ViT passes them, scale 1/8. Uncounted:
    the JSON line keeps the flagship's and the U-Net's paths."""
    from k_diffusion_tpu_torch.ops.kernels import flash, fused_mapping

    g = torch.Generator().manual_seed(SEED + 26)
    bf16 = torch.bfloat16
    cases = []
    # the streamed shape also with bf16 weights: half the bytes through
    # the same tiles, which tells bytes from the ring's steps
    for batch, mw, d_ff, f32 in ((UNET_BATCH, 768, 2048, True),
                                 (UNET_BATCH, 768, 2048, False),
                                 (SAMPLE_BATCH, 256, 768, True)):
        blocks = [((1 + 0.1 * torch.randn(mw, generator=g)).to(dev),
                   lecun((mw, 2 * d_ff), g, dev), lecun((d_ff, mw), g, dev))
                  for _ in range(2)]
        if f32:
            blocks = [(ns, wu.float(), wd.float()) for ns, wu, wd in blocks]
        args = ((torch.randn((batch, mw), generator=g)).to(dev, bf16),
                torch.ones(mw, device=dev), torch.ones(mw, device=dev), blocks)
        cases.append(Case(
            "fused_mapping", f"{batch}x{mw} f={d_ff}, "
            f"{'f32' if f32 else 'bf16'} weights", 0,
            lambda a=args: fused_mapping.fused_mapping(*a),
            lambda a=args: fused_mapping.reference(*a),
            len(blocks) * 6 * batch * mw * d_ff, args))
    b, s, heads = UNET_BATCH, 256, 12
    qkv = torch.randn((b, s, 3, heads, 64), generator=g).to(dev, bf16)
    q, k, v = qkv.unbind(2)
    dout = torch.randn((b, s, heads, 64), generator=g).to(dev, bf16)
    fwd_flops = 2 * 2 * b * heads * s * s * 64
    label = f"{b}x{s}x{heads}x64 (ViT)"
    cases.append(Case("flash", label, 0,
                      lambda t=(q, k, v): flash.flash_attention(*t, 0.125),
                      lambda t=(q, k, v): flash.reference(*t, 0.125),
                      fwd_flops, (q, k, v),
                      library=lambda t=(q, k, v): sdpa(*t, 0.125)))
    out, lse = flash.flash_forward(q, k, v, 0.125, save_lse=True)
    cases.append(Case(
        "flash_bwd", label, 0,
        lambda a=(q, k, v, out, lse, dout): flash.flash_backward(*a, 0.125),
        lambda a=(q, k, v, dout): flash.reference_backward(*a, 0.125),
        5 * fwd_flops // 2, (q, k, v, out, lse, dout),
        library=sdpa_backward(q, k, v, dout, 0.125)))
    return cases


def vit_phase(KT, dev, smi):
    """Phase 22 (b): the ViT at DiT-B/2's width and depth: K5 streamed and
    resident (its one launch a call checked in phase 3), K13/K14 at its
    shapes, forward and gradient parity, 50-step
    DPM++(2M) at batch 64, 3 + 20 training steps at batch 64, and a
    checkpointed step (each block's K13 launched again in the backward)."""
    from k_diffusion_tpu_torch.ops import kernels

    with torch.no_grad():
        run_cases(vit_cases(dev), {}, 20, 5)
    config = KT.config.load_config(VIT_CONFIG)
    depth = config["model"]["depth"]
    zero = dict.fromkeys(kernels.COUNTERS, 0)
    per_call = {"flash": depth, "fused_mapping": 1}
    per_step = per_call | {"flash_bwd": depth}
    g = torch.Generator().manual_seed(SEED + 27)
    with torch.no_grad():
        model, counts = forward_parity(KT, config, dev, fill_zero_init, g,
                                       "vit forward")
    if counts != zero | per_call:
        raise AssertionError(f"vit forward: launch counts {counts}")
    counts = grad_parity(KT, config, dev, fill_zero_init,
                         "vit gradient parity")
    if counts != zero | per_step:
        raise AssertionError(f"vit gradient parity: launch counts {counts}")
    fwd = forward_flops(KT, config, "vit")
    sample(KT, config, model, dev, g, UNET_BATCH, per_call, fwd, smi,
           "vit sampling")
    del model
    torch.cuda.empty_cache()
    train(KT, config, dev, smi, UNET_BATCH, per_step, fwd, "vit training")
    plain, counts = remat_check(KT, config, dev, "vit", exact=False,
                                batch=UNET_BATCH,
                                variants=(("every block", {}),))
    # the checkpointed step launches each block's K13 again in its backward
    want = zero | per_step | {"flash": 2 * depth}
    if plain != zero | per_step or counts != want:
        raise AssertionError(f"vit steps: launch counts {plain}, "
                             f"checkpointed {counts} != {want}")
    print(f"vit checkpointing: launches per step {counts} against {plain} "
          f"without it", flush=True)


def cross_unet_phase(KT, unet, dev, smi):
    """Phase 22 (c): config_cifar10.json with cross-attention on its
    attention levels (cross_cond_dim 768, 77-token sequences with seeded
    padding lengths) and the variance head: forward and
    DenoiserWithVariance gradient parity at batch 2, 50-step DPM++(2M) at
    batch 64 (K13 for the self-attention only)."""
    from k_diffusion_tpu_torch.ops import kernels

    config = {**unet, "model": {**unet["model"],
                                "cross_attn_depths":
                                    list(unet["model"]["self_attn_depths"]),
                                "cross_cond_dim": 768, "has_variance": True}}
    g = torch.Generator().manual_seed(SEED + 28)

    def cross(batch):
        lengths = torch.randint(1, CROSS_TOKENS + 1, (batch,), generator=g)
        return {"cross_cond": torch.randn((batch, CROSS_TOKENS, 768),
                                          generator=g),
                "cross_cond_padding":
                    torch.arange(CROSS_TOKENS)[None] >= lengths[:, None],
                "aug_cond": torch.randn((batch, 9), generator=g) * 0.1}

    zero = dict.fromkeys(kernels.COUNTERS, 0)
    n_attn = sum(2 * d for d, a in zip(config["model"]["depths"],
                                       config["model"]["self_attn_depths"])
                 if a)
    with torch.no_grad():
        model, counts = forward_parity(KT, config, dev, fill_zero_init_unet,
                                       g, "cross unet forward", **cross(2))
    if counts != zero | {"flash": n_attn}:
        raise AssertionError(f"cross unet forward: launch counts {counts}")
    counts = grad_parity(KT, config, dev, fill_zero_init_unet,
                         "cross unet variance gradient parity", **cross(2))
    if counts != zero | {"flash": n_attn, "flash_bwd": n_attn}:
        raise AssertionError(f"cross unet gradient: launch counts {counts}")
    extra = {k: v.to(dev) for k, v in cross(UNET_BATCH).items()}
    fwd = forward_flops(KT, config, "cross unet",
                             **{k: v[:1] for k, v in cross(1).items()})
    sample(KT, config, model, dev, g, UNET_BATCH, {"flash": n_attn}, fwd, smi,
           "cross unet sampling", extra=extra,
           ops=("aten::scaled_dot_product_attention",))
    del model
    torch.cuda.empty_cache()


def families_phase(KT, flagship, unet, dev, smi):
    """Phase 22: the shifted-window HDiT, the ViT, the cross-attention and
    variance U-Net, and the flagship's multiscale loss."""
    shifted_window_phase(KT, flagship, dev, smi)
    CLOCK.part("phase 22 (a) shifted windows")
    vit_phase(KT, dev, smi)
    CLOCK.part("phase 22 (b) ViT")
    cross_unet_phase(KT, unet, dev, smi)
    scales = {**flagship, "model": {**flagship["model"], "loss_scales": 3}}
    grad_parity(KT, scales, dev, fill_zero_init,
                "flagship loss_scales 3 gradient parity")


# phase 23: the rest of training and the engine

# the remat policies a checkpointed HDiT takes (None: plain checkpointing)
REMAT_POLICIES = (None, "save_attn_out", "save_attn", "save_attn_qkv_raw",
                  "dots_saveable", "nothing_saveable", "everything_saveable")
# the likelihood's steps on the card: bf16 rounding in the model makes the
# error estimate noisy, and each step is 6 forwards and backwards
LIKELIHOOD_MAX_STEPS = 200
# the gaussian denoiser's likelihood on the card against its closed form
# (float32): the integrator's default tolerance; at rtol = atol = 1e-6 its
# error over 64 x 64 x 3 elements is about 1e-5
LIKELIHOOD_REL_BOUND = 1e-4
# InceptionV3 on the card (float32, TF32 off) against the CPU, relative L2
INCEPTION_REL_BOUND = 1e-4


def step_ms(KT, config, dev, batch, steps, cond=None, **model_kw):
    """(host, device) milliseconds a training step (make_train_step: loss,
    backward, clip, optimizer, EMA) at ``batch`` takes: host clock around a
    synchronised run of ``steps`` steps after 3, and the card's busy time
    a step in a profile of 3 more."""
    model = KT.config.make_model(config, dtype=torch.bfloat16, device=dev,
                                 generator=torch.Generator(dev).manual_seed(
                                     SEED + 31), **model_kw)
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(config, model))
    step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(config),
        KT.config.make_sample_density(config["model"]))
    data = {"reals": torch.randn((1, *input_shape(config, batch)),
                                 generator=torch.Generator().manual_seed(
                                     SEED + 32)).clamp(-1, 1).to(dev)}
    data.update({k: v[None] for k, v in (cond or {}).items()})
    gen = torch.Generator(dev).manual_seed(SEED + 33)
    for i in range(3 + steps):
        if i == 3:
            torch.cuda.synchronize()
            start = time.perf_counter()
        step(state, data, gen, 0.999)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) / steps * 1e3
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, data, gen, 0.999)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 3e3
    del model, state
    torch.cuda.empty_cache()
    return ms, busy


def policy_check(KT, config, dev, name, batch, attention, cond=None,
                 policies=REMAT_POLICIES, timed=(None, "save_attn_out")):
    """Phase 23 (a): one step at ``batch`` with the config's dropout,
    without checkpointing and checkpointed under each remat policy, from
    the same weights, data and generator seed: bit-equal to the plain step
    (loss, gradient, params after the optimizer); launch counts, peak
    memory, and for the plain step and the policies ``timed`` the time of
    a step (make_train_step: host clock over 5 steps, card busy time over
    3; PERF.md holds the other policies' times). The
    attention forward kernels ``attention`` launch once a layer under a
    ``save_*`` policy (the recompute reads the kept output), twice under
    plain checkpointing."""
    plain = one_step(KT, config, dev, batch, fill_zero_init, SEED + 29, cond)
    plain_ms = step_ms(KT, config, dev, batch, 5, cond)
    print(f"{name} policies: plain step at batch {batch}, dropout "
          f"{config['model']['dropout_rate']}: peak memory "
          f"{plain[3] / 2**30:.3f} GiB, {plain_ms[0]:.3f} ms a step, card "
          f"busy {plain_ms[1]:.3f} ms of it; launches {plain[4]}",
          flush=True)
    for policy in policies:
        kw = {"checkpointing": True, "remat_policy": policy}
        got = one_step(KT, config, dev, batch, fill_zero_init, SEED + 29,
                       cond, **kw)
        equal = all(torch.equal(a, b) for a, b in zip(got[:3], plain[:3]))
        if not equal:
            rels = [((a - b).norm() / b.norm()).item()
                    for a, b in zip(got[1:3], plain[1:3])]
            raise AssertionError(f"{name} under {policy}: not bit-equal to "
                                 f"the plain step (relative L2 gradient, "
                                 f"params {rels})")
        saves = policy in ("save_attn_out", "save_attn", "save_attn_qkv_raw",
                           "everything_saveable")
        for k in attention:
            want = plain[4][k] * (1 if saves else 2)
            if got[4][k] != want:
                raise AssertionError(f"{name} under {policy}: {got[4][k]} "
                                     f"{k} launches a step, not {want}")
        times = ""
        if policy in timed:
            ms = step_ms(KT, config, dev, batch, 5, cond, **kw)
            times = (f"; {ms[0]:.3f} ms a step against {plain_ms[0]:.3f}, "
                     f"card busy {ms[1]:.3f} against {plain_ms[1]:.3f}")
        print(f"{name} under {policy or 'plain checkpointing'}: bit-equal to "
              f"the plain step; peak memory {got[3] / 2**30:.3f} GiB against "
              f"{plain[3] / 2**30:.3f}{times}; launches a step {got[4]}",
              flush=True)


def optimizer_phase(KT, config, dev, smi, fused_ips):
    """Phase 23 (b): 8-bit AdamW and SGD (momentum 0.9, nesterov) on the
    flagship: the optimizer state's bytes a parameter; 3 + 20 training
    steps at batch 32 each with the checks of phase 8. (PERF.md holds
    their times a step side by side with AdamW's.)"""
    from k_diffusion_tpu_torch.models import flops
    hdit_flops = 2 * flops.analytic_transformer_flops(config, 1)
    for kind, extra in (("adamw", {}), ("adam8bit", {}),
                        ("sgd", {"momentum": 0.9, "nesterov": True})):
        cfg = json.loads(json.dumps(config))
        cfg["optimizer"].update({"type": kind, **extra})
        model = KT.config.make_model(cfg, dtype=torch.bfloat16, device=dev)
        opt = KT.training.make_optimizer(cfg, model)
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step(0)
        n = sum(p.numel() for p in model.parameters())
        size = sum(t.numel() * t.element_size()
                   for st in opt.optimizer.state.values()
                   for key, t in st.items() if key != "step")
        del model, opt
        torch.cuda.empty_cache()
        print(f"{kind}: optimizer state {size} bytes for {n} parameters, "
              f"{size / n:.4f} bytes a parameter", flush=True)
        if kind != "adamw":
            _, ips = train(KT, cfg, dev, smi, TRAIN_BATCH,
                           hdit_layout(KT, cfg, True), hdit_flops,
                           f"{kind} training")
            print(f"{kind} training: {ips:.3f} imgs/s (AdamW's phase 8: "
                  f"{fused_ips:.3f}) on {smi}", flush=True)


def cfg_sampling(KT, dev, smi):
    """Phase 23 (c): classifier-free guidance at scale 3 on
    config_mnist_transformer.json, batch 8: one guided call against its
    two halves run apart, then 50-step DPM++(2M) with its launch counts
    (each model call on the doubled batch: the mnist layout once)."""
    from k_diffusion_tpu_torch.ops import kernels

    mnist = KT.config.load_config(MNIST_TRANSFORMER)
    g = torch.Generator().manual_seed(SEED + 41)
    model = KT.config.make_model(mnist, dtype=torch.bfloat16, device="cpu",
                                 generator=g)
    fill_zero_init(model, g)
    model.to(dev).eval()
    m, n_classes = mnist["model"], mnist["dataset"]["num_classes"]
    den = KT.config.make_denoiser_wrapper(mnist)(model)
    guided = KT.guidance.make_cfg_model_fn(den, 3.0, n_classes)
    classes = torch.randint(0, n_classes, (SAMPLE_BATCH,), generator=g).to(dev)
    x = (torch.randn(input_shape(mnist, SAMPLE_BATCH), generator=g)
         * m["sigma_max"]).to(dev)
    sigmas = KT.sampling.get_sigmas_karras(STEPS, m["sigma_min"],
                                           m["sigma_max"], rho=7.0, device=dev)
    with torch.no_grad():
        s = torch.full((SAMPLE_BATCH,), 5.0, device=dev)
        out = guided(x / 16, s, class_cond=classes)
        cond = den(x / 16, s, class_cond=classes)
        uncond = den(x / 16, s, class_cond=torch.full_like(classes, n_classes))
        want = uncond + (cond - uncond) * 3.0
        rel = ((out - want).norm() / want.norm()).item()
        if not rel <= KERNEL_REL_BOUND:
            raise AssertionError(f"cfg: guided call against its halves: "
                                 f"relative L2 {rel:.3e}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        samples = KT.sampling.sample_dpmpp_2m(
            guided, x, sigmas, extra_args={"class_cond": classes})
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = kernels.launch_counts()
    depth = sum(m["depths"])
    expected = dict.fromkeys(kernels.COUNTERS, 0) | {
        "fused_qkv": STEPS * depth, "flash": STEPS * depth,
        "fused_ffn": STEPS * depth, "fused_mapping": STEPS}
    if counts != expected or not torch.isfinite(samples).all():
        raise AssertionError(f"cfg sampling: launch counts {counts} != "
                             f"{expected}, or the samples are not finite")
    print(f"cfg: mnist transformer, scale 3, batch {SAMPLE_BATCH} (the model "
          f"on {2 * SAMPLE_BATCH}): one guided call against its halves run "
          f"apart, relative L2 {rel:.3e}; {STEPS}-step DPM++(2M) {secs:.3f} "
          f"s, {SAMPLE_BATCH / secs:.3f} samples/s on {smi}; launches "
          f"{counts}", flush=True)
    del model
    torch.cuda.empty_cache()


def gaussian_denoiser(x, sigma):
    """The exact posterior mean for N(0, 1) data."""
    return x / (1 + sigma ** 2)[:, None, None, None]


def likelihood_phase(KT, config, dev, smi):
    """Phase 23 (d): the likelihood. The closed-form gaussian denoiser on
    the card at 64 x 64 x 3, batch 2, against its exact value (the flow is
    linear: log N(z; 0, sigma_max^2) + n / 2 log((1 + sigma_max^2) / (1 +
    sigma_min^2)) at z = x sqrt((1 + sigma_max^2) / (1 + sigma_min^2)));
    then config_test_tiny (f32 on the CPU, bf16 on the card) and the
    flagship (bf16 on the card) at batch 2 from seeded weights, eval mode:
    finite, the divergence's backward kernels launched, nfe and time."""
    from k_diffusion_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(SEED + 51)
    x = torch.randn((2, 64, 64, 3), generator=g).to(dev)
    lo, hi = 1 + 0.01 ** 2, 1 + 80.0 ** 2
    ll, info = KT.log_likelihood(gaussian_denoiser, x, 0.01, 80.0,
                                 probe=torch.ones_like(x), atol=1e-6,
                                 rtol=1e-6)
    z = x.double().reshape(2, -1) * (hi / lo) ** 0.5
    want = ((-0.5 * z ** 2 / 80.0 ** 2 - 0.5 * math.log(2 * math.pi * 6400))
            .sum(1) + z.shape[1] / 2 * math.log(hi / lo))
    rel = ((ll.double() - want).abs().max() / want.abs().max()).item()
    if not rel <= LIKELIHOOD_REL_BOUND:
        raise AssertionError(f"gaussian likelihood: relative error {rel:.3e}"
                             f", nfe {info['nfe']}")
    print(f"likelihood: gaussian denoiser, 64 x 64 x 3, batch 2, on the card: "
          f"ll {ll.tolist()} against the closed form {want.tolist()}, "
          f"relative {rel:.3e} (bound {LIKELIHOOD_REL_BOUND}); nfe "
          f"{info['nfe']}", flush=True)
    tiny = KT.config.load_config(TEST_TINY)
    for name, cfg, devices in (("test_tiny", tiny, ("cpu", dev)),
                               ("flagship", config, (dev,))):
        m = cfg["model"]
        g = torch.Generator().manual_seed(SEED + 53)
        model = KT.config.make_model(cfg, device="cpu", generator=g)
        fill_zero_init(model, g)
        x = torch.randn(input_shape(cfg, 2), generator=g).clamp(-1, 1)
        probe = torch.randint(0, 2, x.shape, generator=g).float() * 2 - 1
        extra = ({"class_cond": torch.zeros(2, dtype=torch.long)}
                 if cfg["dataset"]["num_classes"] else {})
        for where in devices:
            run = (KT.config.make_model(cfg, dtype=torch.bfloat16,
                                        device=where)
                   if where != "cpu" else
                   KT.config.make_model(cfg, device="cpu"))
            run.load_state_dict(model.state_dict())
            den = KT.config.make_denoiser_wrapper(cfg)(run.eval())
            kernels.reset_launch_counts()
            start = time.perf_counter()
            ll, info = KT.log_likelihood(
                den, x.to(where), m["sigma_min"], m["sigma_max"],
                extra_args={k: v.to(where) for k, v in extra.items()},
                probe=probe.to(where), max_steps=LIKELIHOOD_MAX_STEPS)
            secs = time.perf_counter() - start
            counts = kernels.launch_counts()
            if not torch.isfinite(ll).all():
                raise AssertionError(f"{name} likelihood: not finite: {ll}")
            if where != "cpu":
                missing = [k for k in ("fused_qkv_bwd", "fused_ffn_bwd")
                           if not counts[k]]
                if name == "flagship":
                    missing += [k for k in ("na2d_bwd", "global_packed_bwd")
                                if not counts[k]]
                if missing:
                    raise AssertionError(f"{name} likelihood: no launch of "
                                         f"{missing}: {counts}")
            print(f"likelihood: {name}, batch 2, "
                  f"{'f32 on the CPU' if where == 'cpu' else 'bf16 on the card'}"
                  f": ll {ll.tolist()}, nfe {info['nfe']}, steps "
                  f"{info['steps']} ({info['naccept']} accepted; at most "
                  f"{LIKELIHOOD_MAX_STEPS}), {secs:.3f} s; launches {counts}",
                  flush=True)
            del run
        torch.cuda.empty_cache()


def write_random_inception_npz(KT, path, seed):
    """Seeded random InceptionV3W weights in the layout of
    scripts/convert_inception_weights.py's .npz (architecture-ordered OIHW
    kernels, each followed by its norm's parameters): He-scaled kernels
    and identity norms, so that the features keep the input's variation
    through 94 ReLU layers."""
    rng = np.random.RandomState(seed)
    arrays = {}
    for i, (cout, cin, kh, kw) in enumerate(
            KT.models.inception_v3.conv_shape_order()):
        arrays[f"layers.{i}.weight"] = rng.normal(
            0.0, (2.0 / (kh * kw * cin)) ** 0.5,
            (cout, cin, kh, kw)).astype(np.float32)
        arrays[f"layers.{i}.scale"] = np.ones(cout, np.float32)
        arrays[f"layers.{i}.bias"] = np.zeros(cout, np.float32)
        arrays[f"layers.{i}.running_mean"] = np.zeros(cout, np.float32)
        arrays[f"layers.{i}.running_var"] = np.ones(cout, np.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)


def inception_phase(KT, dev, smi, cache):
    """Phase 23 (e): InceptionV3W at full width (299 x 299, float32, TF32
    off), seeded random weights from the cache's .npz: the extractor's
    features at batch 2 on the card against the CPU's, then images/s at
    batch 2 and 32 (CUDA events, 5 calls after one)."""
    path = Path(cache) / "k-diffusion" / "inception-2015-12-05.pt"
    card = KT.evaluation.make_extractor("inception", path=path, device=dev)
    cpu = KT.evaluation.make_extractor("inception", path=path, device="cpu")
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(
        SEED + 61)) * 2 - 1
    got = card(x.to(dev)).cpu()
    want = cpu(x)
    rel = ((got - want).norm() / want.norm()).item()
    if got.shape != (2, 2048) or not rel <= INCEPTION_REL_BOUND:
        raise AssertionError(f"inception: {tuple(got.shape)}, relative L2 "
                             f"{rel:.3e} against the CPU")
    rates = []
    for batch in (2, 32):
        images = torch.rand((batch, 299, 299, 3), device=dev) * 2 - 1
        ms = device_ms(lambda: card(images), 5)
        rates.append(f"batch {batch}: {ms:.3f} ms, {batch / ms * 1e3:.1f} "
                     f"images/s")
    print(f"inception: features at batch 2 on the card against the CPU, "
          f"relative L2 {rel:.3e} (bound {INCEPTION_REL_BOUND}); "
          f"{'; '.join(rates)} (299 x 299, float32, TF32 off) on {smi}",
          flush=True)
    del card, cpu
    torch.cuda.empty_cache()


def evaluation_entry(KT, config, cache, smi):
    """Phase 23 (f): the training entry point in-process on the flagship
    (synthetic data in place of its image folder) for 6 steps at batch 32
    with --evaluate-every 3 --evaluate-n 64 and the cache's random
    Inception weights: two rows of {name}_metrics.csv, finite FID and
    KID."""
    with tempfile.TemporaryDirectory() as tmp:
        cfg = json.loads(json.dumps(config))
        cfg["dataset"] = {"type": "synthetic", "num_classes": 0,
                          "cond_dropout_rate": 0.0}
        path = Path(tmp) / "config.json"
        path.write_text(json.dumps(cfg))
        name = Path(tmp) / "run"
        out, secs = call_entry(
            "train", "--config", path, "--batch-size", 32, "--end-step", 6,
            "--evaluate-every", 3, "--evaluate-n", 64, "--demo-every", 0,
            "--save-every", 0, "--num-workers", 4, "--name", name,
            env={"XDG_CACHE_HOME": str(cache)})
        lines = Path(f"{name}_metrics.csv").read_text().splitlines()
        rows = [[float(v) for v in line.split(",")] for line in lines[1:]]
        if (lines[0] != "step,time,loss,fid,kid" or [r[0] for r in rows]
                != [3, 6] or not all(math.isfinite(v) for r in rows
                                     for v in r[3:])):
            raise AssertionError(f"metrics csv: {lines}")
    evals = [l for l in out.splitlines() if l.startswith("FID")]
    print(f"train --evaluate-every 3 --evaluate-n 64 (flagship, batch 32, 6 "
          f"steps, random Inception weights, in-process): {secs:.1f} s; "
          f"{evals}; "
          f"metrics csv {lines}", flush=True)


def engine_phase(KT, config, dev, smi, fused_ips):
    """Phase 23: remat policies, 8-bit AdamW and SGD, classifier-free
    guidance, the likelihood, InceptionV3 and the trainer's evaluation."""
    print(f"phase 23: flagship remat policies at batch {TRAIN_BATCH}",
          flush=True)
    policy_check(KT, config, dev, "flagship", TRAIN_BATCH,
                 ("na2d", "global_packed"))
    with train_fusion("0"):
        policy_check(KT, config, dev, "flagship unfused", TRAIN_BATCH,
                     ("na2d_heads", "global_packed"),
                     policies=(None, "save_attn_out"))
    mnist = KT.config.load_config(MNIST_TRANSFORMER)
    classes = torch.randint(0, mnist["dataset"]["num_classes"],
                            (SAMPLE_BATCH,), generator=torch.Generator()
                            .manual_seed(SEED + 43)).to(dev)
    policy_check(KT, mnist, dev, "mnist transformer", SAMPLE_BATCH, ("flash",),
                 cond={"class_cond": classes}, policies=(None, "save_attn"),
                 timed=())
    CLOCK.part("phase 23 remat policies")
    optimizer_phase(KT, config, dev, smi, fused_ips)
    CLOCK.part("phase 23 optimizers")
    cfg_sampling(KT, dev, smi)
    likelihood_phase(KT, config, dev, smi)
    CLOCK.part("phase 23 guidance and likelihood")
    with tempfile.TemporaryDirectory() as cache:
        write_random_inception_npz(
            KT, Path(cache) / "k-diffusion" / "inception-2015-12-05.npz",
            SEED + 60)
        inception_phase(KT, dev, smi, cache)
        CLOCK.part("phase 23 InceptionV3")
        evaluation_entry(KT, config, cache, smi)


# phase 24: the ranks, and the steps of the comparison
DP_WORLD, DP_STEPS = 2, 3


def count_plain_calls():
    """Wraps each plain version in ``ops.kernels`` (every module's
    ``*reference*`` functions and ``residuals.plain``) to count its calls
    on CUDA tensors. Returns the counter."""
    import inspect
    from k_diffusion_tpu_torch.ops.kernels import (
        flash, fused_ffn, fused_mapping, fused_qkv, global_packed, na2d,
        residuals)

    calls = collections.Counter()
    for module in (flash, fused_ffn, fused_mapping, fused_qkv, global_packed,
                   na2d, residuals):
        for name, fn in list(vars(module).items()):
            if not inspect.isfunction(fn) or not (
                    "reference" in name or (module is residuals
                                            and name == "plain")):
                continue

            def counted(*args, _fn=fn, _name=f"{module.__name__}.{name}",
                        **kwargs):
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args):
                    calls[_name] += 1
                return _fn(*args, **kwargs)

            setattr(module, name, counted)
    return calls


def dp_setup(KT, config, dev, rank, world):
    """The flagship (dropout 0) in bfloat16 on ``dev`` from seeded weights
    (zero-init projections filled), its state, its train step for ``rank``
    of ``world``, this rank's rows of a seeded global batch of
    TRAIN_BATCH, and a list that receives step 1's gradient (the reduced
    one under data parallelism) when the optimizer takes it."""
    g = torch.Generator().manual_seed(SEED + 24)
    model = KT.config.make_model(config, dtype=torch.bfloat16, device="cpu",
                                 generator=g)
    fill_zero_init(model, g)
    model.to(dev)
    if world > 1:
        KT.parallel.replicate(model)
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(config, model))
    step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(config),
        KT.config.make_sample_density(config["model"]), world=world,
        rank=rank)
    reals = torch.randn((1, *input_shape(config, TRAIN_BATCH)),
                        generator=g).clamp(-1, 1)
    batch = {"reals": KT.parallel.local_rows(reals[0], rank, world)[None]
             .to(dev)}
    grads = []
    names = [n for n, _ in model.named_parameters()]
    optimizer_step = state.optimizer.step

    def keep_first_gradient(count):
        if count == 0:
            grads.append({n: p.grad.detach().float().cpu() for n, p in
                          zip(names, model.parameters())})
        return optimizer_step(count)

    state.optimizer.step = keep_first_gradient
    return state, step, batch, grads


def split_gradient(KT, config, model, reals, dev):
    """Step 1's gradient as the ranks compute it, in one process: the mean
    over the DP_WORLD blocks of rows of each block's mean-loss gradient,
    with step 1's global draws (``dp_steps``'s first generator, the
    step's order: sigmas, then noise)."""
    gen = torch.Generator(dev).manual_seed(KT.sampling.fold_in(SEED + 25, 0))
    sigmas = KT.config.make_sample_density(config["model"])(
        (reals.shape[0],), stratified=(0, 1), generator=gen, device=dev)
    noise = torch.randn(reals.shape, generator=gen, device=dev,
                        dtype=reals.dtype)
    den = KT.config.make_denoiser_wrapper(config)(model.train())
    total = None
    for r in range(DP_WORLD):
        rows = [KT.parallel.local_rows(t, r, DP_WORLD)
                for t in (reals, noise, sigmas)]
        grads = torch.autograd.grad(den.loss(*rows).mean(),
                                    list(model.parameters()))
        total = grads if total is None else [a + b for a, b in
                                             zip(total, grads)]
    return {n: (t / DP_WORLD).float().cpu()
            for (n, _), t in zip(model.named_parameters(), total)}


def relative_errors(got, want):
    """Each tensor's relative L2 error (its L2 where ``want``'s is 0) and
    that of all of them together."""
    errs = {n: ((got[n] - w).norm() / w.norm()).item() if w.norm() > 0
            else got[n].norm().item() for n, w in want.items()}
    flat = lambda d: torch.cat([d[n].flatten() for n in want])
    overall = ((flat(got) - flat(want)).norm() / flat(want).norm()).item()
    return errs, overall


def dp_steps(KT, state, step, batch, dev):
    """DP_STEPS steps with the generators every rank shares; returns the
    losses and each step's seconds (synchronised)."""
    losses, secs = [], []
    for i in range(DP_STEPS):
        gen = torch.Generator(dev).manual_seed(
            KT.sampling.fold_in(SEED + 25, i))
        torch.cuda.synchronize(dev)
        start = time.perf_counter()
        losses.append(float(step(state, batch, gen, 0.999)["loss"]))
        torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - start)
    return losses, secs


def digest(tensors):
    """A SHA-256 of the tensors' bytes, in order: bit equality across
    processes without moving the tensors."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def dp_rank_main(rank, port, out, config_path):
    """One rank of phase 24 (a): joins a gloo group of DP_WORLD on this
    card, trains its rows of the global batch and writes
    ``out/rank{rank}.pt``: the losses and step seconds, step 1's reduced
    gradient (rank 0), digests of it and of the params and EMA after the
    steps, the launch counts and the plain versions' calls on CUDA
    tensors."""
    sys.path.insert(0, str(ROOT))
    import k_diffusion_tpu_torch as KT
    from k_diffusion_tpu_torch.ops import kernels

    rank = int(rank)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    KT.parallel.initialize_distributed(
        backend="gloo", init_method=f"tcp://localhost:{port}",
        world_size=DP_WORLD, rank=rank)
    plain = count_plain_calls()
    config = json.loads(Path(config_path).read_text())
    state, step, batch, grads = dp_setup(KT, config, dev, rank, DP_WORLD)
    kernels.reset_launch_counts()
    losses, secs = dp_steps(KT, state, step, batch, dev)
    result = {
        "losses": losses, "secs": secs, "counts": kernels.launch_counts(),
        "plain": dict(plain),
        "grad_digest": digest(grads[0].values()),
        "params_digest": digest(state.model.parameters()),
        "ema_digest": digest(state.ema_model.parameters())}
    if rank == 0:
        result["grads"] = grads[0]
    torch.save(result, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def data_parallel_phase(KT, config, dev, smi):
    """Phase 24 (see the module docstring)."""
    import socket

    config = no_dropout(config)
    layout = hdit_layout(KT, config, True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        config_path = tmp / "flagship.json"
        config_path.write_text(json.dumps(config))
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        start = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dp-rank",
             str(r), str(port), str(tmp), str(config_path)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_WORLD)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode:
                raise AssertionError(f"data parallel rank {r} failed:\n"
                                     f"{out[-4000:]}")
        ranks_s = time.perf_counter() - start
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
                 for r in range(DP_WORLD)]

    # one process at the global batch, the same weights and draws; first
    # the ranks' gradient computed in this one process over their rows
    state, step, batch, grads = dp_setup(KT, config, dev, 0, 1)
    split = split_gradient(KT, config, state.model, batch["reals"][0], dev)
    losses, secs = dp_steps(KT, state, step, batch, dev)
    full = grads[0]
    del state, step, batch, grads
    torch.cuda.empty_cache()

    expected = dict.fromkeys(KT.ops.kernels.COUNTERS, 0) | {
        k: DP_STEPS * v for k, v in layout.items()}
    # K5 has no backward kernel, as in the JAX package: its backward is the
    # VJP of its plain version, recomputed once a step; no other plain
    # version may run on the card
    recompute = {"k_diffusion_tpu_torch.ops.kernels.fused_mapping.reference":
                 DP_STEPS * layout["fused_mapping"]}
    for r, result in enumerate(ranks):
        if result["counts"] != expected:
            raise AssertionError(f"data parallel rank {r}: launch counts "
                                 f"{result['counts']} != {expected}")
        if result["plain"] != recompute:
            raise AssertionError(f"data parallel rank {r}: plain versions "
                                 f"ran on the card: {result['plain']}, "
                                 f"expected {recompute}")
        rel = [abs(a - b) / abs(b) for a, b in zip(result["losses"], losses)]
        if not max(rel) <= 1e-3:
            raise AssertionError(f"data parallel rank {r}: losses "
                                 f"{result['losses']} vs one process "
                                 f"{losses}: relative {rel} > 1e-3")
    for key in ("losses", "grad_digest", "params_digest", "ema_digest"):
        if ranks[0][key] != ranks[1][key]:
            raise AssertionError(f"data parallel: ranks differ in {key}")
    got = ranks[0]["grads"]
    if not all(torch.isfinite(g).all() for g in got.values()):
        raise AssertionError("data parallel: step 1's gradient not finite")
    # the data-parallel step against one process over the same rows: what
    # the reduce may change is the order of one sum
    errs, overall = relative_errors(got, split)
    worst = max(errs, key=errs.get)
    bit_equal = sum(torch.equal(got[n], w) for n, w in split.items())
    if not errs[worst] <= 1e-2:
        raise AssertionError(f"data parallel: step 1's reduced gradient of "
                             f"{worst} against one process over the same "
                             f"rows: relative L2 {errs[worst]:.3e} > 1e-2")
    # against one process at batch 32: the bf16 kernels split their sums
    # by the batch (K1/K4 forward splits, K6/K10 split-K over the rows), so
    # two blocks of 16 differ from 32 rows in one process as much as the
    # two ranks do; bounded on the whole gradient
    errs32, overall32 = relative_errors(got, full)
    worst32 = max(errs32, key=errs32.get)
    split32 = relative_errors(split, full)[1]
    if not overall32 <= 1e-2:
        raise AssertionError(f"data parallel: step 1's reduced gradient "
                             f"against one process at batch {TRAIN_BATCH}: "
                             f"relative L2 {overall32:.3e} > 1e-2")
    print(f"data parallel (a): 2 gloo ranks on one card, the flagship at "
          f"full width, dropout 0, batch {TRAIN_BATCH // DP_WORLD} a rank, "
          f"{DP_STEPS} steps, against 1 process at batch {TRAIN_BATCH} with "
          f"the same weights and global draws: losses {ranks[0]['losses']} "
          f"vs {losses} (bound 1e-3 relative); step 1's reduced gradient, "
          f"{len(errs)} tensors, against one process over the ranks' two "
          f"blocks of rows: worst relative L2 {errs[worst]:.3e} ({worst}; "
          f"bound 1e-2), all together {overall:.3e}, {bit_equal} of "
          f"{len(errs)} tensors bit-equal; against one process at batch "
          f"{TRAIN_BATCH}: all together {overall32:.3e} (bound 1e-2), worst "
          f"tensor {errs32[worst32]:.3e} ({worst32}), "
          f"{sum(e > 1e-2 for e in errs32.values())} tensors above 1e-2, "
          f"where one process's two blocks of rows against its batch "
          f"{TRAIN_BATCH} give {split32:.3e} all together; the ranks' "
          f"losses, gradients, params and EMA bit for bit equal; each "
          f"rank's launches {DP_STEPS} x {layout}, and no plain version on "
          f"the card but K5's backward recompute {ranks[0]['plain']}",
          flush=True)
    print(f"data parallel (a) times: a step of the two ranks sharing the "
          f"card (gloo all-reduce through the host) {ranks[0]['secs']} s "
          f"(rank 0), {ranks[1]['secs']} s (rank 1); one process at batch "
          f"{TRAIN_BATCH} {secs} s; both ranks' processes {ranks_s:.1f} s "
          f"with start and build; on {smi}. Two ranks sharing one card "
          f"measure no scaling.", flush=True)
    CLOCK.part("phase 24 (a) gloo ranks")
    data_parallel_trainer(KT, config, dev, smi)


def data_parallel_trainer(KT, config, dev, smi):
    """Phase 24 (b): the trainer under torchrun, one NCCL rank, sharded
    checkpoints, then resumed from the state pointer through the entry
    point in-process; then a sharded round trip on the card through the
    state pointer."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = dict(config, dataset={"type": "synthetic", "num_classes": 0,
                                    "length": 1024})
        cfg_path = tmp / "flagship.json"
        cfg_path.write_text(json.dumps(cfg))
        name = tmp / "nccl"
        flags = ("--config", cfg_path, "--batch-size", 16, "--save-every", 2,
                 "--demo-every", 0, "--evaluate-every", 0,
                 "--checkpoint-format", "orbax", "--name", name)
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "k_diffusion_tpu_torch.train",
             *map(str, flags), "--end-step", "2"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"torchrun trainer failed:\n"
                                 f"{proc.stdout[-3000:]}"
                                 f"{proc.stderr[-4000:]}")
        outs = [(proc.stdout, time.perf_counter() - start),
                call_entry("train", *flags, "--end-step", 4)]
        for out, _ in outs:
            if "World: 1 process(es)" not in out:
                raise AssertionError(f"torchrun trainer: no world line:\n"
                                     f"{out}")
        if f"Resuming from {name}_00000002.orbax" not in outs[1][0]:
            raise AssertionError(f"torchrun trainer: no resume from the "
                                 f"pointer:\n{outs[1][0]}")
        pointer = KT.checkpoint.latest_checkpoint(name)
        if pointer != f"{name}_00000004.orbax":
            raise AssertionError(f"torchrun trainer: pointer {pointer}")

        def fresh():
            model = KT.config.make_model(cfg, dtype=torch.bfloat16,
                                         device=dev)
            return KT.training.init_train_state(
                model, KT.training.make_optimizer(cfg, model))

        def flat(state):
            import torch.utils._pytree as pytree
            return pytree.tree_flatten(
                {"model": state.model.state_dict(),
                 "ema": state.ema_model.state_dict(),
                 "optimizer": state.optimizer.state_dict(),
                 "step": state.step})

        saved, host = KT.checkpoint.load_checkpoint(
            f"{name}_00000002.orbax", fresh())
        again = tmp / "again"
        path = KT.checkpoint.save_checkpoint_sharded(
            f"{again}_00000002.orbax", saved, host)
        KT.checkpoint.write_state_json_after_commit(again, path)
        KT.checkpoint.wait_for_checkpoints()
        restored, host2 = KT.checkpoint.load_checkpoint(
            KT.checkpoint.latest_checkpoint(again), fresh())
        (a, spec_a), (b, spec_b) = flat(saved), flat(restored)
        devices = {t.device.type for t in a if isinstance(t, torch.Tensor)}
        tensors = sum(isinstance(t, torch.Tensor) for t in a)
        if spec_a != spec_b or host2 != host or not all(
                torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                for x, y in zip(a, b)):
            raise AssertionError("sharded round trip: the restored state "
                                 "differs from the saved one")
    print(f"data parallel (b): the trainer under torchrun, 1 NCCL rank, "
          f"flagship at batch 16, --checkpoint-format orbax: 2 steps and a "
          f"sharded save in {outs[0][1]:.1f} s (process start and model "
          f"build included), resumed from the pointer to step 4 in-process "
          f"in {outs[1][1]:.1f} s, each printing 'World: 1 process(es)'; "
          f"the step-2 checkpoint loaded on the card, saved sharded again "
          f"and loaded back through the pointer: {tensors} tensors (on "
          f"{devices}) and the host dict bit for bit equal; on {smi}",
          flush=True)


# phase 25: float32 compute on the card (--mixed-precision no), the U-Net
# family: the float32 forms of K13 and K14 (csrc/attn_tf32.cuh)
MNIST_UNET = ROOT / "configs" / "config_mnist.json"
# a float32 kernel against its plain version in float32 with TF32 off, x
# its max|plain|: the kernel rounds each product's operands to TF32 (10
# mantissa bits, 2^-11 relative), the plain version keeps 23
F32_KERNEL_REL_BOUND = 5e-3
# each float32 kernel's error against float64 at most this share of the
# bf16 kernel's on the same inputs: TF32 keeps 3 mantissa bits more than
# bf16 (8x finer), so a kernel that rounded to bf16 anywhere would not pass
TF32_SHARE = 0.25
# the float32 U-Net on the card (TF32 products) against float32 on the CPU,
# relative L2 of the output and of the gradient, at most this share of the
# bf16 card model's error against the same CPU model
F32_MODEL_SHARE = 0.25
# published dense TF32 tensor-core peak of one H100 SXM at 700 W
PEAK_TF32_FLOPS = 494.7e12
# the float32 trainer's resume against the uninterrupted run, relative L2
RESUME_REL_BOUND = 1e-3


@contextlib.contextmanager
def tf32(enabled):
    """TF32 products on (as ``--mixed-precision no`` trains) or off for
    cuBLAS and cuDNN inside; the flags as they were afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def under_tf32(enabled, fn):
    """``fn`` called with TF32 ``enabled``."""
    def call():
        with tf32(enabled):
            return fn()
    return call


def float32_shapes(unet):
    """((b, s, heads, e), calls per denoiser call or step) of phase 25: the
    cifar10 U-Net's attention at batch 64 (its main path); at batch 64
    config_mnist.json's 7 x 7 level and head dim 32 at s 256, which count
    no calls."""
    shapes = [((UNET_BATCH, s, heads, 64), n)
              for (s, heads), n in unet_attention_shapes(unet)]
    mnist = json.loads(MNIST_UNET.read_text())
    shapes += [((UNET_BATCH, s, heads, 64), 0)
               for (s, heads), _ in unet_attention_shapes(mnist)]
    return shapes + [((UNET_BATCH, 256, 4, 32), 0)]


def float32_inputs(g, dev, b, s, heads, e):
    """q, k, v strided views of one float32 (b, s, 3, heads, e) projection,
    as the U-Net makes them, logits of about unit spread at scale 1/8, and
    a contiguous dout."""
    qkv = torch.randn((b, s, 3, heads, e), generator=g) * (64 / e) ** 0.5
    dout = torch.randn((b, s, heads, e), generator=g)
    return (*qkv.to(dev).unbind(2), dout.to(dev))


def float32_cases(dev, shapes):
    """Phase 25 (a) and (c): K13 and K14 in float32 against their plain
    versions in float32 with TF32 off, within F32_KERNEL_REL_BOUND; the
    bound from TF32's peak; SDPA and its backward on the float32 inputs,
    TF32 on, as the library yardstick."""
    from k_diffusion_tpu_torch.ops.kernels import flash

    g = torch.Generator().manual_seed(SEED + 25)
    cases = []
    for (b, s, heads, e), n in shapes:
        label = f"{b}x{s}x{heads}x{e}"
        q, k, v, dout = float32_inputs(g, dev, b, s, heads, e)
        fwd_flops = 2 * 2 * b * heads * s * s * e
        cases.append(Case(
            "flash_f32", label, n,
            lambda t=(q, k, v): flash.flash_attention(*t, 0.125),
            under_tf32(False, lambda t=(q, k, v): flash.reference(*t, 0.125)),
            fwd_flops, (q, k, v),
            library=under_tf32(True, lambda t=(q, k, v): sdpa(*t, 0.125)),
            rel_bound=F32_KERNEL_REL_BOUND, peak=PEAK_TF32_FLOPS))
        out, lse = flash.flash_forward(q, k, v, 0.125, save_lse=True)
        with tf32(True):
            library = sdpa_backward(q, k, v, dout, 0.125)
        cases.append(Case(
            "flash_bwd_f32", label, n,
            lambda a=(q, k, v, out, lse, dout): flash.flash_backward(*a, 0.125),
            under_tf32(False, lambda a=(q, k, v, dout):
                       flash.reference_backward(*a, 0.125)),
            5 * fwd_flops // 2, (q, k, v, out, lse, dout),
            library=under_tf32(True, library),
            rel_bound=F32_KERNEL_REL_BOUND, peak=PEAK_TF32_FLOPS))
    return cases


def tf32_check(dev, shapes):
    """Phase 25 (b): on the same float32 inputs, each float32 kernel's and
    each bf16 kernel's (on the inputs rounded to bf16) output, dq, dk and
    dv against the plain version in float64, max abs error over max|f64|;
    the float32 kernels' at most TF32_SHARE x the bf16 kernels'. Also the
    lse of both against float64, printed."""
    from k_diffusion_tpu_torch.ops.kernels import flash

    g = torch.Generator().manual_seed(SEED + 26)
    worst = 0.0
    for (b, s, heads, e), _ in shapes:
        inputs = float32_inputs(g, dev, b, s, heads, e)
        wide = [t.double() for t in inputs]
        want = (flash.reference(*wide[:3], 0.125),
                flash.reference_lse(*wide[:3], 0.125),
                *flash.reference_backward(*wide, 0.125))
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (t.to(dtype) for t in inputs)
            out, lse = flash.flash_forward(q, k, v, 0.125, save_lse=True)
            got = (out, lse, *flash.flash_backward(q, k, v, out, lse, dout,
                                                   0.125))
            errs[dtype] = [((a.double() - w).abs().max()
                            / w.abs().max()).item() for a, w in zip(got, want)]
        shares = {name: a / c for name, a, c in zip(
            ("out", "lse", "dq", "dk", "dv"), errs[torch.float32],
            errs[torch.bfloat16]) if name != "lse"}
        label = f"{b}x{s}x{heads}x{e}"
        if not max(shares.values()) <= TF32_SHARE:
            raise AssertionError(f"tf32 check {label}: float32 kernels' "
                                 f"errors against float64 {shares} x the "
                                 f"bf16 kernels', bound {TF32_SHARE}")
        worst = max(worst, *shares.values())
        print(f"tf32 check [{label}]: against float64, max abs err over "
              f"max|f64| (out, lse, dq, dk, dv): float32 kernels "
              f"{[f'{x:.2e}' for x in errs[torch.float32]]}, bf16 kernels "
              f"{[f'{x:.2e}' for x in errs[torch.bfloat16]]}; float32 / "
              f"bf16 {({k: round(v, 3) for k, v in shares.items()})} "
              f"(bound {TF32_SHARE})", flush=True)
    print(f"tf32 check: worst float32 / bf16 error share {worst:.3f} over "
          f"{len(shapes)} shapes (bound {TF32_SHARE})", flush=True)


def float32_model_parity(KT, unet, dev, n_attn, batch):
    """Phase 25 (d): the cifar10 U-Net (dropout 0, seeded weights, zero-init
    kernels filled) at ``batch``, in float32 on the card with TF32 on and
    in bf16 on the card, against the same weights in float32 on the CPU:
    relative L2 of the denoiser output (eval) and of one loss's full
    parameter gradient (train, the same reals, noise, sigmas and
    aug_cond). The float32 model's errors at most F32_MODEL_SHARE x the
    bf16 model's; each run's launch counts: K13 twice a block (the forward,
    the loss) and K14 once, in its dtype's kernels only."""
    from k_diffusion_tpu_torch.ops import kernels

    config = no_dropout(unet)
    g = torch.Generator().manual_seed(SEED + 27)
    reference = KT.config.make_model(config, device="cpu", generator=g)
    fill_zero_init_unet(reference, g)
    x = torch.randn(input_shape(config, batch), generator=g)
    sigma = torch.linspace(0.5, 8.0, batch)
    reals, noise = (torch.randn(input_shape(config, batch), generator=g)
                    for _ in range(2))
    loss_sigma = KT.config.make_sample_density(config["model"])(
        (batch,), stratified=(0, 1), generator=g, device="cpu")
    aug = torch.randn((batch, 9), generator=g)

    def run(model, d):
        den = KT.config.make_denoiser_wrapper(config)(model)
        with torch.no_grad():
            out = den(x.to(d), sigma.to(d)).float().cpu()
        model.train()
        loss = den.loss(reals.to(d), noise.to(d), loss_sigma.to(d),
                        aug_cond=aug.to(d)).mean()
        grad = torch.cat([p.flatten() for p in torch.autograd.grad(
            loss, list(model.parameters()))]).float().cpu()
        model.eval()
        return out, loss.item(), grad

    start = time.perf_counter()
    want = run(reference.eval(), torch.device("cpu"))
    cpu_secs = time.perf_counter() - start
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    found = {}
    for dtype, flash_names in ((torch.float32, ("flash_f32", "flash_bwd_f32")),
                               (torch.bfloat16, ("flash", "flash_bwd"))):
        model = KT.config.make_model(config, dtype=dtype, device="cpu")
        model.load_state_dict(reference.state_dict())
        model.to(dev).eval()
        kernels.reset_launch_counts()
        with tf32(True):
            out, loss, grad = run(model, dev)
        counts = kernels.launch_counts()
        expected = dict.fromkeys(kernels.COUNTERS, 0) | {
            flash_names[0]: 2 * n_attn, flash_names[1]: n_attn}
        if counts != expected:
            raise AssertionError(f"float32 parity ({dtype}): launch counts "
                                 f"{counts} != {expected}")
        if not (torch.isfinite(out).all() and torch.isfinite(grad).all()):
            raise AssertionError(f"float32 parity ({dtype}): not finite")
        found[dtype] = (rel(out, want[0]), rel(grad, want[2]), loss)
        del model
        torch.cuda.empty_cache()
    (f_out, f_grad, f_loss), (b_out, b_grad, b_loss) = (
        found[torch.float32], found[torch.bfloat16])
    print(f"unet float32 parity: batch {batch}, dropout 0, against float32 "
          f"on the CPU ({cpu_secs:.1f} s): output relative L2 float32 "
          f"(TF32) {f_out:.3e}, bf16 {b_out:.3e} ({f_out / b_out:.3f}); "
          f"gradient of {want[2].numel()} params float32 {f_grad:.3e}, bf16 "
          f"{b_grad:.3e} ({f_grad / b_grad:.3f}), bound {F32_MODEL_SHARE} "
          f"x bf16's; loss {f_loss:.6f} float32, {b_loss:.6f} bf16, "
          f"{want[1]:.6f} CPU", flush=True)
    if not (f_out <= F32_MODEL_SHARE * b_out
            and f_grad <= F32_MODEL_SHARE * b_grad):
        raise AssertionError(f"unet float32 parity: float32 errors {f_out:.3e}"
                             f", {f_grad:.3e} against bf16 {b_out:.3e}, "
                             f"{b_grad:.3e}: above {F32_MODEL_SHARE} x")


def float32_trainer(KT, config_path, batch, per_step, smi, exact=True):
    """Phases 25 (f), 26 (f), 27 (f) and 28 (f): the training entry point
    ``k_diffusion_tpu_torch.train`` with ``--mixed-precision no``,
    in-process, on ``config_path`` from a custom dataset of 256 entries
    cycling over seeded images in memory (256 distinct ones at 32 x 32, 32
    at a larger size) at ``batch``: 4 steps with saves at 2 and 4 and a
    16-sample demo grid at 4 (it must log float32 compute), then resumed
    from step 2 to 4 (params and EMA bit for bit the first run's, or with
    ``exact`` False within RESUME_REL_BOUND relative L2), its 2 steps'
    launch counts ``per_step`` in float32 kernels only."""
    from k_diffusion_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        g = torch.Generator().manual_seed(SEED + 28)
        cfg = json.loads(config_path.read_text())
        size = cfg["model"]["input_size"][0]
        coarse = torch.rand((256 if size == 32 else 32, 3, 8, 8), generator=g)
        images = F.interpolate(coarse, size=(size, size),
                               mode="bilinear") * 2 - 1
        np.save(tmp / "images.npy", images.permute(0, 2, 3, 1).numpy())
        (tmp / "in_memory.py").write_text(IN_MEMORY_DATASET)
        cfg["dataset"] = {"type": "custom",
                          "location": str(tmp / "in_memory.py"),
                          "config": {"path": str(tmp / "images.npy"),
                                     "entries": 256}}
        cfg_path = tmp / "config.json"
        cfg_path.write_text(json.dumps(cfg))
        flags = ("--config", cfg_path, "--batch-size", batch,
                 "--mixed-precision", "no", "--end-step", 4, "--save-every",
                 2, "--evaluate-every", 0)
        out, secs = call_entry("train", *flags, "--demo-every", 4,
                               "--sample-n", 16, "--name", tmp / "f32")
        if "compute dtype torch.float32" not in out:
            raise AssertionError(f"float32 trainer: not float32:\n{out}")
        check_png(tmp / "f32_demo_00000004.png", 4 * size)
        kernels.reset_launch_counts()
        _, resumed_secs = call_entry(
            "train", *flags, "--demo-every", 0, "--resume",
            tmp / "f32_00000002.ckpt", "--name", tmp / "resumed")
        counts = kernels.launch_counts()
        expected = dict.fromkeys(kernels.COUNTERS, 0) | {
            k: 2 * v for k, v in per_step.items()}
        if counts != expected:
            raise AssertionError(f"float32 trainer (resumed): "
                                 f"launch counts {counts} != {expected}")
        a, b = (torch.load(tmp / f"{name}_00000004.ckpt", map_location="cpu",
                           weights_only=True) for name in ("f32", "resumed"))
        errs, equal = {}, True
        for key in ("model", "model_ema"):
            x, y = flat_weights(a, key), flat_weights(b, key)
            errs[key] = ((x - y).norm() / x.norm()).item()
            equal = equal and torch.equal(x, y)
        if not max(errs.values()) <= RESUME_REL_BOUND or \
                not math.isfinite(a["host"]["ema_stats"]["loss"]) or \
                (exact and not equal):
            raise AssertionError(f"float32 trainer resume: {errs}, bit-equal "
                                 f"{equal} (required: {exact}), loss "
                                 f"{a['host']['ema_stats']}")
        print(f"float32 trainer (in-process, --mixed-precision no, "
              f"{config_path.name} at batch {batch}): 4 steps, saves "
              f"at 2 and 4, a 16-sample demo grid, in {secs:.1f} s with "
              f"model build and demo; resumed from step 2 to 4 in "
              f"{resumed_secs:.1f} s: params relative L2 "
              f"{errs['model']:.3e}, EMA {errs['model_ema']:.3e} (bound "
              f"{RESUME_REL_BOUND}), bit-equal {equal}"
              f"{' (required)' if exact else ''}, launches "
              f"{ {k: v for k, v in counts.items() if v} } (no bf16 "
              f"kernel), on {smi}; its output: "
              f"{' | '.join(out.strip().splitlines())}", flush=True)


def float32_refusals(KT, dev):
    """Phase 26 (g): what no kernel takes on the card is refused by name
    before any launch: float16. The flagship with head dim 128 at its
    neighborhood levels (no config ships one; phase 28 runs it in bf16 and
    float32) built in float16 on the card raises ValueError naming the
    dtypes the kernels take; K11 on float16 maps of head dim 128, K15
    (``na2d_packed_proj``) on float16 maps and K8 asked to write float16
    raise ValueError naming them; no kernel launches."""
    from k_diffusion_tpu_torch.ops import kernels
    from k_diffusion_tpu_torch.ops.kernels import na2d

    named = "bfloat16 or float32"
    kernels.reset_launch_counts()
    x = torch.zeros((1, 16, 16, 2, 128), device=dev, dtype=torch.float16)
    p = torch.zeros((1, 16, 16, 128), device=dev, dtype=torch.float16)
    part = torch.zeros((1, 2, 4, na2d.HALO_KEYS, 64), device=dev)
    for what, call in (
            ("flagship, NA head dim 128", lambda: KT.config.make_model(
                na128_config(KT), dtype=torch.float16, device=dev)),
            ("K11 at head dim 128", lambda: na2d.heads_forward(x, x, x, 7)),
            ("K15", lambda: na2d.na2d_packed_proj(
                p, p, p, p, torch.eye(128, device=dev), 2, 7)),
            ("K8", lambda: na2d.overlap_add(part, part, 16, 16, 7,
                                            dtype=torch.float16))):
        try:
            call()
        except ValueError as e:
            if named not in str(e):
                raise
            print(f"float16 refusal ({what}): {e}", flush=True)
        else:
            raise AssertionError(f"{what}: took float16 on the card")
    torch.cuda.synchronize()
    if kernels.launch_counts() != dict.fromkeys(kernels.COUNTERS, 0):
        raise AssertionError(f"float16 refusals launched "
                             f"{kernels.launch_counts()}")


# The float32 attention backward's rows in PERF.md from its earlier
# mma.sync design (ms summed over each main path's calls, and by shape
# where PERF.md has them), beside which its TF32 wgmma kernels
# (csrc/attn_tf32_bwd.cuh) print their times.
F32_BWD_BEFORE = {
    "flash_bwd_f32": (2.520, {}),
    "global_packed_bwd_f32": (0.2506, {}),
    "na2d_bwd_f32": (1.5668, {"8x64x64x128": 0.2584, "8x32x32x256": 0.1333}),
    "na2d_heads_bwd_f32": (1.5684, {}),
    "na2d_heads_bwd_f32_e128": (2.1441, {"8x64x64x1x128": 0.3559,
                                         "8x32x32x2x128": 0.1839}),
}


def f32_bwd_compare(results, names):
    """Phases 25 (c), 26 (a), 27 (a) and 28 (a): the float32 attention
    backward (csrc/attn_tf32_bwd.cuh) at each shape beside its bound, SDPA's
    backward on float32 (TF32 on) and PERF.md's earlier time where it has
    one, and its sum over the main path's calls beside the earlier row
    (``F32_BWD_BEFORE``)."""
    for name in names:
        r = results[name]
        before, shapes = F32_BWD_BEFORE[name]
        parts = []
        for label, t in r["shapes"].items():
            lib = ("" if t["library_ms"] is None
                   else f", SDPA backward {t['library_ms']:.4f}")
            was = f", was {shapes[label]:.4f}" if label in shapes else ""
            parts.append(f"{label} {t['ms']:.4f} ms (bound "
                         f"{t['bound_ms']:.4f}{lib}{was})")
        print(f"float32 attention backward {name}: " + "; ".join(parts) +
              f"; on its main path {r['ms']:.4f} ms, "
              f"{r['bound_ms'] / r['ms']:.1%} of its bound "
              f"{r['bound_ms']:.4f}, against the mma.sync design's "
              f"{before:.4f} ms ({before / r['ms']:.2f}x faster)", flush=True)


def attention_f32_bit_check(dev):
    """Phase 25 (c): K9-f32 and K14-f32 run the same backward kernels
    (csrc/attn_tf32_bwd.cuh over wg::Seq): on one packed float32 input at
    the flagship's global level (batch 8, 256 tokens, 8 heads of 64, scale
    1) their dq, dk, dv from the same out and lse agree bit for bit; and a
    rerun of K14-f32 on the U-Net's strided q, k, v (batch 64, 256 tokens,
    4 heads of 64) is bit-equal (no atomics)."""
    from k_diffusion_tpu_torch.ops.kernels import flash, global_packed

    def same(what, got, want):
        for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
            b_ = b_.reshape(a.shape)
            if not torch.equal(a, b_):
                raise AssertionError(f"{what} {name} differ by "
                                     f"{(a - b_).abs().max().item():.3e}")

    g = torch.Generator().manual_seed(SEED + 27)
    b, s, heads = SAMPLE_BATCH, 256, 8
    t = torch.randn((2, b, s, heads, 64), generator=g)
    q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
        2, b, s, heads * 64).to(dev)
    v, dout = torch.randn((2, b, s, heads * 64), generator=g).to(dev)
    out, lse = global_packed.packed_forward(q, k, v, heads, save_lse=True)
    split = [x.reshape(b, s, heads, 64) for x in (q, k, v, out, dout)]
    same("K9-f32 and K14-f32",
         global_packed.packed_backward(q, k, v, out, lse, dout, heads),
         flash.flash_backward(*split[:4], lse, split[4], 1.0))
    q, k, v, dout = float32_inputs(g, dev, UNET_BATCH, 256, 4, 64)
    out, lse = flash.flash_forward(q, k, v, 0.125, save_lse=True)
    same("K14-f32 and its rerun",
         flash.flash_backward(q, k, v, out, lse, dout, 0.125),
         flash.flash_backward(q, k, v, out, lse, dout, 0.125))
    print(f"float32 attention bit check: K9-f32 and K14-f32 bit-identical "
          f"dq, dk, dv on one packed input [{b}x{s}x{heads * 64}]; a K14-f32 "
          f"rerun bit-equal [{UNET_BATCH}x256x4x64]", flush=True)


def float32_phase(KT, unet, dev, smi, results, n_attn, unet_flops,
                  bf16_sample, bf16_train):
    """Phase 25: (a)-(c) the float32 kernels at their shapes, (b) the TF32
    check, (d) the model's parity, (e) sampling and training in float32
    beside phases 11 and 12's bf16 (``bf16_sample``, ``bf16_train``), (f)
    the trainer, (g) the refusals. Returns the launch counts of the float32
    sampling and training runs."""
    print("phase 25: float32 compute on the card (--mixed-precision no), "
          "the cifar10 U-Net", flush=True)
    shapes = float32_shapes(unet)
    with torch.no_grad():
        run_cases(float32_cases(dev, shapes), results, 20, 5)
        f32_bwd_compare(results, ("flash_bwd_f32",))
        tf32_check(dev, shapes)
        attention_f32_bit_check(dev)
    CLOCK.part("phase 25 (a)-(c) kernels")
    float32_model_parity(KT, unet, dev, n_attn, F32_PARITY_BATCH)
    CLOCK.part("phase 25 (d) parity")

    g = torch.Generator().manual_seed(SEED + 29)
    model = KT.config.make_model(unet, dtype=torch.float32, device="cpu",
                                 generator=g)
    fill_zero_init_unet(model, g)
    model.to(dev).eval()
    f32_sample, f32_train = {}, {}
    with tf32(True):
        sample_counts = sample(KT, unet, model, dev, g, UNET_BATCH,
                               {"flash_f32": n_attn}, unet_flops, smi,
                               "unet sampling float32", report=f32_sample)
        del model
        torch.cuda.empty_cache()
        train_counts, _ = train(
            KT, unet, dev, smi, UNET_BATCH,
            {"flash_f32": n_attn, "flash_bwd_f32": n_attn}, unet_flops,
            "unet training float32", dtype=torch.float32, report=f32_train)
    for what, f32, bf in (("sampling (50-step DPM++(2M))", f32_sample,
                           bf16_sample),
                          ("training", f32_train, bf16_train)):
        print(f"unet {what} at batch {UNET_BATCH}, float32 against bf16 "
              f"(phases 11, 12): {f32['rate']:.3f} against {bf['rate']:.3f} "
              f"{'samples' if 'DPM' in what else 'images'}/s; card time "
              f"{f32['busy_ms']:.3f} against {bf['busy_ms']:.3f} ms a "
              f"{'call' if 'DPM' in what else 'step'} (profile); peak memory "
              f"{f32['peak'] / 2**30:.3f} against {bf['peak'] / 2**30:.3f} "
              f"GiB, on {smi}", flush=True)
    # Not bit-equal: the U-Net's convolutions run cuDNN, whose algorithms
    # are not deterministic by default (a resume differed by ~6e-9 relative
    # L2); the transformers' float32 steps run only the hand-written
    # kernels, which have no atomics, so phases 26 and 27 require it.
    float32_trainer(KT, UNET_CONFIG, UNET_BATCH,
                    {"flash_f32": n_attn, "flash_bwd_f32": n_attn}, smi,
                    exact=False)
    return sample_counts, train_counts


# phase 26: float32 compute on the card (--mixed-precision no) for the ViT
# and the HDiT without neighborhood-attention levels: the float32 forms of
# K1, K4, K5, K6, K10 (csrc/fused_qkv_f32.cu, geglu_f32.cu; the forwards on
# the TF32 core csrc/gemm_tf32.cuh, the backwards on csrc/gemm_tf32_wg.cuh)
# and of K3/K9 (csrc/attn_tf32.cuh, K13's and K14's)
CIFAR10_TRANSFORMER = ROOT / "configs" / "config_cifar10_transformer.json"
# the batch of phases 25 (d) and 26 (d)'s CPU references (the U-Net's call
# and step, the shifted-window config's step, the ViT's call and step): the
# CPU's time, not the card's, sets it
F32_PARITY_BATCH = 8
# the float32 kernels of the slice, with the TPU kernel each replaces (the
# JSON line's source and replaces)
F32_KERNELS = {
    "fused_qkv_f32": ("fused_qkv_f32.cu", "fused_qkv.py:82"),
    "fused_ffn_f32": ("geglu_f32.cu", "fused_ffn.py:42"),
    "fused_mapping_f32": ("geglu_f32.cu", "fused_mapping.py:28"),
    "global_packed_f32": ("attn_tf32.cuh", "global_packed.py:57"),
    "fused_qkv_bwd_f32": ("fused_qkv_f32.cu", "fused_qkv.py:246"),
    "fused_ffn_bwd_f32": ("geglu_f32.cu", "fused_ffn.py:115"),
    "global_packed_bwd_f32": ("attn_tf32_bwd.cuh", "global_packed.py:111"),
}

# one float32 kernel at one shape: ``make()`` gives its float32 inputs on
# the card; ``act`` the indices of the activations among them, which the
# bf16 form takes in bfloat16 (the weights stay the model's float32
# params); ``run(*inputs)`` calls the wrapper and ``plain(*inputs)`` its
# plain version, each returning a tuple; ``timed``, where given, the
# wrapper call that is timed (the backward alone); ``skip`` outputs left
# out of the TF32 check (a logsumexp, computed in f32 by both forms);
# ``reads`` tensors the timed call reads besides the inputs (a backward's
# out and lse), for the bound; ``products`` the kernel's matrix products
# alone as torch.matmul calls with TF32 on (Case's)
F32Spec = collections.namedtuple(
    "F32Spec",
    "name label calls make act run plain flops timed library skip reads "
    "products",
    defaults=(None, None, (), (), None))


def f32_specs(dev):
    """Phase 26 (a): each new float32 kernel at the shifted-window config's
    shapes (its levels are the flagship's: K1, K4 at batch 8 per call, K6,
    K10 at batch-8 step shapes, K3, K9 at 8 x 256 x 512; K10 at level 2
    counts no call, whose feed-forward blocks train with dropout, unfused),
    K5 at the HDiT's 8 x 256, f 768 (counted) and streamed in bf16 at the
    ViT's 64 x 768, f 2048, and K1, K4, K6, K10 at config_test_tiny's d 64
    (2 heads of 32), uncounted."""
    from k_diffusion_tpu_torch.ops import rope
    from k_diffusion_tpu_torch.ops.kernels import (fused_ffn, fused_mapping,
                                                   fused_qkv, global_packed)

    g = torch.Generator().manual_seed(SEED + 30)
    b = SAMPLE_BATCH

    def rnd(*shape, std=1.0, shift=0.0):
        return lambda: (torch.randn(shape, generator=g) * std + shift).to(dev)

    specs = []
    for h, d, d_ff, heads, n, n_ffn_bwd, attn in (
            (64, 128, 384, 2, 4, 4, False), (32, 256, 768, 4, 4, 4, False),
            (16, 512, 1536, 8, 4, 0, True), (8, 64, 192, 2, 0, 0, False)):
        t = b * h * h
        label = f"{b}x{h}x{h}x{d}" + (" e=32" if d // heads == 32 else "")
        pos = rope.make_axial_pos(h, h, device=dev)
        made = [rnd(b, h, h, d)(), rnd(b, d, std=0.1, shift=1.0)(),
                rnd(d, 3 * d, std=d ** -0.5)(),
                (10 * (1 + 0.1 * torch.randn(heads, generator=g))).to(dev),
                *(rnd(b, h, h, d)() for _ in range(3))]
        qkv = lambda x, ns, w, s, heads=heads, pos=pos: (x, pos, ns, w, s,
                                                         heads)
        specs.append(F32Spec(
            "fused_qkv_f32", label, n, lambda m=made: m[:4], (0, 1),
            lambda *a, f=qkv: fused_qkv.fused_qkv_prologue(*f(*a)),
            lambda *a, f=qkv: fused_qkv.reference(*f(*a)), 2 * t * d * 3 * d))
        specs.append(F32Spec(
            "fused_qkv_bwd_f32", label, n, lambda m=made: m, (0, 1, 4, 5, 6),
            lambda *a, f=qkv: fused_qkv.prologue_backward(*f(*a[:4]), *a[4:]),
            lambda *a, f=qkv: fused_qkv.reference_backward(*f(*a[:4]), *a[4:]),
            3 * 2 * t * d * 3 * d,
            products=under_tf32(True, qkv_bwd_products(t, d, dev, g))))
        ffn = [rnd(b, h * h, d)(), rnd(b, d, std=0.1, shift=1.0)(),
               rnd(d, 2 * d_ff, std=d ** -0.5)(),
               rnd(d_ff, d, std=d_ff ** -0.5)(), rnd(b, h * h, d)()]
        flabel = f"{b}x{h * h}x{d} f={d_ff}"
        specs.append(F32Spec(
            "fused_ffn_f32", flabel, n, lambda m=ffn: m[:4], (0, 1),
            lambda *a: (fused_ffn.fused_geglu_ffn(*a),),
            lambda *a: (fused_ffn.reference(*a),), 6 * t * d * d_ff))
        specs.append(F32Spec(
            "fused_ffn_bwd_f32", flabel, n_ffn_bwd, lambda m=ffn: m,
            (0, 1, 4), lambda *a: fused_ffn.ffn_backward(*a),
            lambda *a: fused_ffn.reference_backward(*a), 16 * t * d * d_ff,
            products=under_tf32(True, ffn_bwd_products(t, d, d_ff, dev, g))))
        if not attn:
            continue
        s = h * h
        gp = [rnd(b, s, d, std=0.3)() for _ in range(4)]
        split = lambda *a, heads=heads: [x.reshape(b, s, heads, 64) for x in a]
        specs.append(F32Spec(
            "global_packed_f32", f"{b}x{s}x{d}", n, lambda m=gp: m[:3],
            (0, 1, 2),
            lambda *a, heads=heads: global_packed.packed_forward(
                *a, heads, save_lse=True),
            lambda *a, heads=heads: (global_packed.reference(*a, heads),
                                     global_packed.reference_lse(*a, heads)),
            4 * b * s * s * d,
            timed=lambda m=gp, heads=heads: global_packed.packed_forward(
                *m[:3], heads),
            library=under_tf32(True, lambda m=gp: sdpa(*split(*m[:3]), 1.0)),
            skip=(1,)))
        fwd = global_packed.packed_forward(*gp[:3], heads, save_lse=True)
        with tf32(True):
            library = sdpa_backward(*split(*gp), 1.0)
        specs.append(F32Spec(
            "global_packed_bwd_f32", f"{b}x{s}x{d}", n, lambda m=gp: m,
            (0, 1, 2, 3),
            lambda q, k, v, dout, heads=heads: global_packed.packed_backward(
                q, k, v, *global_packed.packed_forward(q, k, v, heads,
                                                       save_lse=True),
                dout, heads),
            lambda *a, heads=heads: global_packed.reference_backward(*a, heads),
            5 * 2 * b * s * s * d,
            timed=lambda m=gp, f=fwd, heads=heads: global_packed.packed_backward(
                *m[:3], *f, m[3], heads),
            library=under_tf32(True, library)))
    for batch, mw, d_ff, calls in ((b, 256, 768, 1), (UNET_BATCH, 768, 2048, 0)):
        flat = [rnd(batch, mw)(), rnd(mw, std=0.1, shift=1.0)(),
                rnd(mw, std=0.1, shift=1.0)()]
        for _ in range(2):
            flat += [rnd(mw, std=0.1, shift=1.0)(),
                     rnd(mw, 2 * d_ff, std=mw ** -0.5)(),
                     rnd(d_ff, mw, std=d_ff ** -0.5)()]
        blocks = lambda a: [a[i:i + 3] for i in range(3, len(a), 3)]
        specs.append(F32Spec(
            "fused_mapping_f32", f"{batch}x{mw} f={d_ff}", calls,
            lambda m=flat: m, (0,),
            lambda *a: (fused_mapping.fused_mapping(
                *a[:3], blocks(a), dtype=a[0].dtype),),
            lambda *a: (fused_mapping.reference(*a[:3], blocks(a),
                                                dtype=a[0].dtype),),
            2 * 6 * batch * mw * d_ff))
    return specs


def qkv_bwd_products(rows, d, dev, g):
    """K6-f32's matrix products alone as torch.matmul calls on (rows, d)
    operands: the recomputed projection R = xn W, dxn = dR W^T and dW =
    xn^T dR (the yardstick ``products_ms``, used nowhere in the port)."""
    xn, w, dr = (torch.randn(shape, generator=g).to(dev)
                 for shape in ((rows, d), (d, 3 * d), (rows, 3 * d)))

    def run():
        return xn @ w, dr @ w.T, xn.T @ dr
    return run


def ffn_bwd_products(rows, d, d_ff, dev, g):
    """K10-f32's matrix products alone as torch.matmul calls: the up
    projection xn W_up, dh = g W_down^T, dxn = dup W_up^T, dW_up = xn^T dup
    and dW_down = h^T g (the yardstick ``products_ms``)."""
    xn, gr, w_up, w_down, dup, h = (
        torch.randn(shape, generator=g).to(dev) for shape in (
            (rows, d), (rows, d), (d, 2 * d_ff), (d_ff, d), (rows, 2 * d_ff),
            (rows, d_ff)))

    def run():
        return (xn @ w_up, gr @ w_down.T, dup @ w_up.T, xn.T @ dup, h.T @ gr)
    return run


# the float32 backwards redesigned on csrc/gemm_tf32_wg.cuh, held to
# bit-equal reruns and split by kernel in phase 26
F32_BACKWARDS = ("fused_qkv_bwd_f32", "fused_ffn_bwd_f32")


def f32_rerun_and_split(specs):
    """Phase 26 (c): K6-f32 and K10-f32 at each shape rerun on the same
    inputs give bit-equal gradients (every row reduction is a fixed-order
    sum of partials), and one call's device time split by kernel name
    (torch.profiler over 5 calls)."""
    import re

    from torch.profiler import ProfilerActivity

    for s in specs:
        if s.name not in F32_BACKWARDS:
            continue
        inputs = s.make()
        first, again = s.run(*inputs), s.run(*inputs)
        for i, (a, b_) in enumerate(zip(first, again)):
            if not torch.equal(a, b_):
                raise AssertionError(f"{s.name} [{s.label}]: output {i} of a "
                                     f"rerun differs by "
                                     f"{(a - b_).abs().max().item():.3e}")
        del first, again
        torch.cuda.synchronize()
        # a short profile now and then records no device activity: take
        # the first of up to three that does
        for _ in range(3):
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    s.run(*inputs)
                torch.cuda.synchronize()
            rows = sorted(((e.self_device_time_total / 5, e.count // 5, e.key)
                           for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and e.self_device_time_total > 0), reverse=True)
            if rows:
                break

        def short(key):
            m = re.search(r"\w+_kernel(?:<[^>]*>)?", key)
            return m.group(0) if m else key[:40]
        print(f"{s.name} [{s.label}]: rerun bit-equal; "
              f"{sum(r[0] for r in rows):.1f} us of device time a call: " +
              "; ".join(f"{short(key)} {us:.1f} us x {n}"
                        for us, n, key in rows), flush=True)


def f32_cases(specs):
    """Phase 26 (a), (c): each spec as a Case, the float32 kernel against its
    plain version in float32 with TF32 off, within F32_KERNEL_REL_BOUND,
    its bound from TF32's peak."""
    cases = []
    for s in specs:
        inputs = s.make()
        cases.append(Case(
            s.name, s.label, s.calls, lambda r=s.run, a=inputs: tuple(r(*a)),
            under_tf32(False, lambda p=s.plain, a=inputs: tuple(p(*a))),
            s.flops, (inputs, s.reads), timed=s.timed, library=s.library,
            rel_bound=F32_KERNEL_REL_BOUND, peak=PEAK_TF32_FLOPS,
            products=s.products))
    return cases


def f32_tf32_check(specs):
    """Phase 26 (b): on the same inputs, each float32 kernel's outputs and
    the bf16 form's (its activations rounded to bf16, the float32 weights
    as the model holds them) against the plain version in float64, max abs
    error over max|f64|; the float32 kernel's at most TF32_SHARE x the bf16
    form's, output by output."""
    worst = 0.0
    for s in specs:
        inputs = s.make()
        wide = [x.double() for x in inputs]
        with torch.no_grad():
            want = s.plain(*wide)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            cast = [x.to(dtype) if i in s.act else x
                    for i, x in enumerate(inputs)]
            got = s.run(*cast)
            errs[dtype] = [((a.double() - w).abs().max() / w.abs().max()).item()
                           for a, w in zip(got, want)]
        shares = [a / c for i, (a, c) in enumerate(zip(errs[torch.float32],
                                                       errs[torch.bfloat16]))
                  if i not in s.skip]
        label = f"{s.name} [{s.label}]"
        print(f"tf32 check {label}: against float64, max abs err over "
              f"max|f64| by output: float32 kernel "
              f"{[f'{x:.2e}' for x in errs[torch.float32]]}, bf16 form "
              f"{[f'{x:.2e}' for x in errs[torch.bfloat16]]}; float32 / bf16 "
              f"{[round(x, 3) for x in shares]} (bound {TF32_SHARE})",
              flush=True)
        if not max(shares) <= TF32_SHARE:
            raise AssertionError(f"tf32 check {label}: float32 / bf16 error "
                                 f"shares {shares}, bound {TF32_SHARE}")
        worst = max(worst, *shares)
    print(f"tf32 check: worst float32 / bf16 error share {worst:.3f} over "
          f"{len(specs)} kernels and shapes (bound {TF32_SHARE})", flush=True)


def as_f32(counts):
    """Launch counts under the float32 kernels' counter names."""
    return {f"{k}_f32": v for k, v in counts.items()}


def f32_model_parity(KT, config, dev, name, call_batch, step_batch, per_call,
                     per_step, unfused=None):
    """Phases 26 (d) and 27 (g): a model (dropout 0, seeded weights,
    zero-init kernels filled) in float32 on the card with TF32 on and in
    bf16 on the card, against the same weights in float32 on the CPU:
    relative L2 of the denoiser output at ``call_batch`` (eval) and of one
    loss's full parameter gradient at ``step_batch`` (train, the same
    reals, noise and sigmas), through ``f32_parity``; where ``unfused``
    (the unfused step's launches) is given, the same again with
    KDT_TRAIN_FUSION=0 against the same CPU side."""
    config = no_dropout(config)
    g = torch.Generator().manual_seed(SEED + 31)
    reference = KT.config.make_model(config, device="cpu", generator=g)
    fill_zero_init(reference, g)
    x = torch.randn(input_shape(config, call_batch), generator=g)
    sigma = torch.linspace(0.5, 8.0, call_batch)
    reals, noise = (torch.randn(input_shape(config, step_batch), generator=g)
                    for _ in range(2))
    loss_sigma = KT.config.make_sample_density(config["model"])(
        (step_batch,), stratified=(0, 1), generator=g, device="cpu")
    start = time.perf_counter()
    den = KT.config.make_denoiser_wrapper(config)(reference.eval())
    with torch.no_grad():
        out = den(x, sigma)
    reference.train()
    loss = den.loss(reals, noise, loss_sigma).mean()
    grad = torch.cat([p.flatten() for p in torch.autograd.grad(
        loss, list(reference.parameters()))])
    state = reference.state_dict()
    cpu_secs = time.perf_counter() - start
    fwd = {"state": state, "x": x, "sigma": sigma, "out": out}
    grads = {"state": state, "reals": reals, "noise": noise,
             "sigma": loss_sigma, "loss": loss.item(), "grad": grad}
    f32_parity(KT, config, dev, name, fwd, grads, per_call, per_step,
               cpu_secs)
    if unfused is not None:
        with train_fusion("0"):
            f32_parity(KT, config, dev, f"{name} unfused", fwd, grads,
                       per_call, unfused, cpu_secs)


def f32_parity(KT, config, dev, name, fwd, grad, per_call, per_step,
               cpu_secs=None):
    """Phases 26 (d) and 27 (c): a model (dropout 0) in float32 on the card
    with TF32 on and in bf16 on the card, against float32 on the CPU:
    relative L2 of the denoiser output from ``fwd``'s weights and inputs
    (eval) against its CPU output, and of one loss's full parameter
    gradient from ``grad``'s weights, reals, noise and sigmas (train)
    against its CPU gradient. The float32 model's errors at most
    F32_MODEL_SHARE x the bf16 model's; each run's launch counts
    ``per_call`` (the forward) plus ``per_step`` (the loss's forward and
    backward), in its dtype's kernels only. ``cpu_secs``: what the CPU side
    took, where it was computed here."""
    from k_diffusion_tpu_torch.ops import kernels

    config = no_dropout(config)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    found = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = KT.config.make_model(config, dtype=dtype, device="cpu")
        model.load_state_dict(fwd["state"])
        model.to(dev).eval()
        den = KT.config.make_denoiser_wrapper(config)(model)
        kernels.reset_launch_counts()
        with tf32(True):
            with torch.no_grad():
                out = den(fwd["x"].to(dev), fwd["sigma"].to(dev)).float().cpu()
            if grad["state"] is not fwd["state"]:
                model.load_state_dict(grad["state"])
            model.train()
            loss = den.loss(grad["reals"].to(dev), grad["noise"].to(dev),
                            grad["sigma"].to(dev)).mean()
            flat = torch.cat([p.flatten() for p in torch.autograd.grad(
                loss, list(model.parameters()))]).float().cpu()
        counts = kernels.launch_counts()
        total = collections.Counter(per_call) + collections.Counter(per_step)
        expected = dict.fromkeys(kernels.COUNTERS, 0) | (
            as_f32(total) if dtype == torch.float32 else dict(total))
        if counts != expected:
            raise AssertionError(f"{name} float32 parity ({dtype}): launch "
                                 f"counts {counts} != {expected}")
        if not (torch.isfinite(out).all() and torch.isfinite(flat).all()):
            raise AssertionError(f"{name} float32 parity ({dtype}): not "
                                 f"finite")
        found[dtype] = (rel(out, fwd["out"]), rel(flat, grad["grad"]),
                        loss.item())
        del model, den
        torch.cuda.empty_cache()
    (f_out, f_grad, f_loss), (b_out, b_grad, b_loss) = (
        found[torch.float32], found[torch.bfloat16])
    cpu = (f"{cpu_secs:.1f} s" if cpu_secs is not None else
           "the CPU side of phases 4 and 7, reused")
    print(f"{name} float32 parity: forward at batch {fwd['x'].shape[0]}, "
          f"gradient at batch {grad['reals'].shape[0]}, dropout 0, against "
          f"float32 on the CPU ({cpu}): output relative L2 float32 (TF32) "
          f"{f_out:.3e}, bf16 {b_out:.3e} ({f_out / b_out:.3f}); gradient of "
          f"{grad['grad'].numel()} params float32 {f_grad:.3e}, bf16 "
          f"{b_grad:.3e} ({f_grad / b_grad:.3f}), bound {F32_MODEL_SHARE} x "
          f"bf16's; loss {f_loss:.6f} float32, {b_loss:.6f} bf16, "
          f"{grad['loss']:.6f} CPU", flush=True)
    if not (f_out <= F32_MODEL_SHARE * b_out
            and f_grad <= F32_MODEL_SHARE * b_grad):
        raise AssertionError(f"{name} float32 parity: float32 errors "
                             f"{f_out:.3e}, {f_grad:.3e} against bf16 "
                             f"{b_out:.3e}, {b_grad:.3e}: above "
                             f"{F32_MODEL_SHARE} x")


def condcache_check(KT, config, model, dev, g, per_call,
                        dtype=torch.float32):
    """Phases 26 (e), 27 (d) and 28 (e): an HDiT's 50-step DPM++(2M) at
    batch 8 in ``dtype`` (by default float32) through condcache, K1's and
    K4's forms (and the plain prologue where K1 does not take a level)
    reading each layer's scale out of the schedule's table row through its
    row stride, against the uncached run: equal (the strided scale is read
    as the contiguous one is; printed whether bit for bit), launches in
    ``dtype``'s kernels only, no K5 a cached call."""
    from k_diffusion_tpu_torch import condcache
    from k_diffusion_tpu_torch.ops import kernels

    m = config["model"]
    sigmas = KT.sampling.get_sigmas_karras(STEPS, m["sigma_min"],
                                           m["sigma_max"], rho=7.0, device=dev)
    x = (torch.randn(input_shape(config, SAMPLE_BATCH), generator=g)
         * m["sigma_max"]).to(dev)
    wrap = KT.config.make_denoiser_wrapper(config)
    with torch.no_grad():
        inner = condcache.ScheduledModel(model, sigmas[:-1], SAMPLE_BATCH)
        kernels.reset_launch_counts()
        cached = KT.sampling.sample_dpmpp_2m(wrap(inner), x, sigmas)
        counts = kernels.launch_counts()
        inner.check()
        uncached = KT.sampling.sample_dpmpp_2m(wrap(model), x, sigmas)
    f32 = dtype == torch.float32
    want = dict.fromkeys(kernels.COUNTERS, 0) | {
        k: STEPS * v for k, v in (as_f32(per_call) if f32 else per_call).items()
        if not k.startswith("fused_mapping")}
    err = ((cached.float() - uncached.float()).abs().max()
           / uncached.float().abs().max()).item()
    what = "float32" if f32 else "bf16"
    if counts != want or not err <= 1e-5:
        raise AssertionError(f"{what} condcache: launch counts {counts} "
                             f"(want {want}), relative error {err:.3e}")
    print(f"{what} condcache: {STEPS}-step DPM++(2M) at batch "
          f"{SAMPLE_BATCH}, cached against uncached: max abs err over "
          f"max|uncached| {err:.3e} (bound 1e-5), bit-equal "
          f"{torch.equal(cached, uncached)}; launches cached {counts}",
          flush=True)


def model_runs(KT, config, dev, smi, name, batch_call, batch_step,
                   per_call, per_step, fwd_flops, reports=(None, None),
                   dtype=torch.float32):
    """Phases 26 (e), 27 (d), (e) and 28 (e): 50-step DPM++(2M) at
    ``batch_call`` (for an HDiT also through condcache) and 3 + 20 training
    steps at ``batch_step`` in ``dtype`` (by default float32, TF32 on),
    each with its launch counts in ``dtype``'s kernels only; ``reports``
    receive the sampling and the training runs' figures. Returns the
    sampling and the training runs' counts."""
    f32 = dtype == torch.float32
    named = as_f32 if f32 else dict
    what = "float32" if f32 else "bf16"
    g = torch.Generator().manual_seed(SEED + 32)
    model = KT.config.make_model(config, dtype=dtype, device="cpu",
                                 generator=g)
    fill_zero_init(model, g)
    model.to(dev).eval()
    with tf32(f32):
        sample_counts = sample(KT, config, model, dev, g, batch_call,
                               named(per_call), fwd_flops, smi,
                               f"{name} sampling {what}", report=reports[0])
        if config["model"]["type"] == "image_transformer_v2":
            condcache_check(KT, config, model, dev, g, per_call, dtype)
        del model
        torch.cuda.empty_cache()
        train_counts, _ = train(KT, config, dev, smi, batch_step,
                                named(per_step), fwd_flops,
                                f"{name} training {what}",
                                dtype=dtype, report=reports[1])
    return sample_counts, train_counts


def transformers_float32_phase(KT, dev, smi, results):
    """Phase 26: (a)-(c) the new float32 kernels at their shapes (K6's and
    K10's also beside their products as torch.matmul), (b) the TF32 check,
    (c) K6's and K10's reruns bit-equal and their time split by kernel, (d)
    the shifted-window config and the ViT against the CPU
    beside bf16, (e) their float32 sampling and training, (f) the trainer
    on config_cifar10_transformer.json, (g) the refusals that remain
    (``float32_refusals``). Returns
    the launch counts of the shifted-window config's float32 sampling and
    training runs (the main path of K1-K5's and K6, K9, K10's float32
    forms)."""
    from k_diffusion_tpu_torch.models import flops

    print("phase 26: float32 compute on the card (--mixed-precision no), the "
          "ViT and the HDiT without neighborhood levels", flush=True)
    specs = f32_specs(dev)
    with torch.no_grad():
        run_cases(f32_cases(specs), results, 20, 3)
        f32_bwd_compare(results, ("global_packed_bwd_f32",))
        f32_tf32_check(specs)
        f32_rerun_and_split(specs)
    del specs
    torch.cuda.empty_cache()
    CLOCK.part("phase 26 (a)-(c) kernels")

    sw = KT.config.load_config(SHIFTED_WINDOW)
    sw_call, sw_step = hdit_layout(KT, sw, False), hdit_layout(KT, sw, True)
    f32_model_parity(KT, sw, dev, "shifted-window", SAMPLE_BATCH,
                     F32_PARITY_BATCH, sw_call,
                     hdit_layout(KT, no_dropout(sw), True))
    vit = KT.config.load_config(VIT_CONFIG)
    depth = vit["model"]["depth"]
    vit_call = {"flash": depth, "fused_mapping": 1}
    vit_step = vit_call | {"flash_bwd": depth}
    f32_model_parity(KT, vit, dev, "vit", F32_PARITY_BATCH, F32_PARITY_BATCH,
                     vit_call, vit_step)
    CLOCK.part("phase 26 (d) parity")

    counts = model_runs(
        KT, sw, dev, smi, "shifted-window", SAMPLE_BATCH, TRAIN_BATCH,
        sw_call, sw_step, 2 * flops.analytic_transformer_flops(sw, 1))
    model_runs(KT, vit, dev, smi, "vit", UNET_BATCH, UNET_BATCH, vit_call,
                   vit_step, forward_flops(KT, vit, "vit"))
    CLOCK.part("phase 26 (e) sampling and training")

    cifar = KT.config.load_config(CIFAR10_TRANSFORMER)
    per_step = as_f32(hdit_layout(KT, cifar, True))
    float32_trainer(KT, CIFAR10_TRANSFORMER, TRAIN_BATCH, per_step, smi)
    float32_refusals(KT, dev)
    return counts


# phase 27: float32 compute on the card for the neighborhood-attention
# configs (the flagship, config_512_hdit, config_256_p8_wide): the float32
# forms of K2, K7, K11 and K12 (csrc/na_tf32.cuh, csrc/attn_tf32.cuh's TF32
# bodies over csrc/na2d.cuh's neighborhood geometry)
HDIT_512 = ROOT / "configs" / "config_512_hdit.json"
P8_WIDE = ROOT / "configs" / "config_256_p8_wide.json"
NA_F32_KERNELS = {
    "na2d_f32": ("na_tf32.cuh", "na2d.py:576"),
    "na2d_bwd_f32": ("na_tf32.cuh", "na2d.py:701"),
    "na2d_heads_f32": ("na_tf32.cuh", "na2d.py:180"),
    "na2d_heads_bwd_f32": ("na_tf32.cuh", "na2d.py:241"),
}


def na_lse_plain(q, k, kernel_size):
    """The logsumexp of each query's masked logits, (b, heads, h, w), from
    (b, h, w, heads, e) q and k, one image at a time: the plain version of
    what the NA forwards save for the backward."""
    from k_diffusion_tpu_torch.ops.attention import neighborhood_mask_2d

    b, h, w, heads, e = q.shape
    mask = neighborhood_mask_2d(h, w, kernel_size, q.device)
    return torch.stack([torch.logsumexp(torch.einsum(
        "qne,kne->nqk", q[i].reshape(h * w, heads, e),
        k[i].reshape(h * w, heads, e)).masked_fill(~mask, float("-inf")),
        -1).reshape(heads, h, w) for i in range(b)])


def na_backward_by_image(q, k, v, dout, kernel_size):
    """``na2d.heads_reference_backward`` one image at a time (its dense
    (hw, hw) logits of a whole batch at 128 x 128 would take tens of GB)."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    grads = [na2d.heads_reference_backward(
        *(t[i:i + 1] for t in (q, k, v, dout)), kernel_size)
        for i in range(q.shape[0])]
    return tuple(torch.cat(g) for g in zip(*grads))


def na_f32_specs(dev):
    """Phase 27 (a): the float32 forms of K2 and K7 on packed maps at the
    flagship's NA levels (batch 8: 64 x 64 x 128 and 32 x 32 x 256, 4
    calls a level per denoiser call or fused step) and, uncounted, at
    config_512_hdit's 128 x 128 x 128 level (plain versions one image at a
    time); of K11 and K12 on per-head maps at the flagship's NA levels (q
    and k contiguous, v a strided third of the projection, as the unfused
    step leaves them; 4 calls a level per unfused step) and, uncounted, at
    head dim 32 (32 x 32, 4 heads of 32). q and k cosine-sim. K2 is timed
    as sampling runs it (no lse), K11 as the unfused step's forward (with
    its lse), each backward alone from its forward's out and lse."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 33)
    b = SAMPLE_BATCH

    def maps(h, heads, e):
        t = torch.randn((b, h, h, 3, heads, e), generator=g)
        qk = t[:, :, :, :2] / t[:, :, :, :2].norm(dim=-1, keepdim=True)
        q, k, v = torch.cat([qk * 10 ** 0.5, t[:, :, :, 2:]], 3).to(
            dev).unbind(3)
        dout = torch.randn((b, h, h, heads, e), generator=g).to(dev)
        return [q.contiguous(), k.contiguous(), v, dout]

    def packed_plain(q, k, v, heads, wide):
        split = split_heads((q, k, v), heads)
        out = (na_plain_by_image if wide else na2d.na2d_reference)(*split, 7)
        return out.reshape(q.shape), na_lse_plain(*split[:2], 7)

    def packed_plain_bwd(q, k, v, dout, heads, wide):
        if not wide:
            return na2d.reference_backward(q, k, v, dout, heads, 7)
        grads = na_backward_by_image(*split_heads((q, k, v, dout), heads), 7)
        return tuple(t.reshape(q.shape) for t in grads)

    def packed_vjp(q, k, v, dout, heads):
        fwd = na2d.packed_forward(q, k, v, heads, 7, save_lse=True)
        return na2d.packed_backward(q, k, v, *fwd, dout, heads, 7)

    def heads_vjp(q, k, v, dout):
        fwd = na2d.heads_forward(q, k, v, 7, save_lse=True)
        return na2d.heads_backward(q, k, v, *fwd, dout, 7)

    specs = []
    for h, heads, n, wide in ((64, 2, 4, False), (32, 4, 4, False),
                              (128, 2, 0, True)):
        c = heads * 64
        m = [t.reshape(b, h, h, c).contiguous() for t in maps(h, heads, 64)]
        label = f"{b}x{h}x{h}x{c}" + (" (config_512_hdit)" if wide else "")
        flops = 4 * b * h * h * c * 7 ** 2
        split = split_heads(m, heads)
        specs.append(F32Spec(
            "na2d_f32", label, n, lambda m=m: m[:3], (0, 1, 2),
            lambda q, k, v, heads=heads: na2d.packed_forward(
                q, k, v, heads, 7, save_lse=True),
            lambda q, k, v, heads=heads, wide=wide: packed_plain(
                q, k, v, heads, wide), flops,
            timed=lambda m=m, heads=heads: na2d.packed_forward(*m[:3], heads,
                                                               7),
            library=None if wide else under_tf32(
                True, na_library(split[:3])), skip=(1,)))
        fwd = na2d.packed_forward(*m[:3], heads, 7, save_lse=True)
        specs.append(F32Spec(
            "na2d_bwd_f32", label, n, lambda m=m: m, (0, 1, 2, 3),
            lambda q, k, v, dout, heads=heads: packed_vjp(q, k, v, dout,
                                                          heads),
            lambda q, k, v, dout, heads=heads, wide=wide: packed_plain_bwd(
                q, k, v, dout, heads, wide), 5 * flops // 2,
            timed=lambda m=m, f=fwd, heads=heads: na2d.packed_backward(
                *m[:3], *f, m[3], heads, 7),
            library=None if wide else under_tf32(
                True, na_library(split[:3], split[3])), reads=fwd))
    for h, heads, e, n in ((64, 2, 64, 4), (32, 4, 64, 4), (32, 4, 32, 0)):
        m = maps(h, heads, e)
        label = f"{b}x{h}x{h}x{heads}x{e}"
        flops = 4 * b * h * h * heads * e * 7 ** 2
        specs.append(F32Spec(
            "na2d_heads_f32", label, n, lambda m=m: m[:3], (0, 1, 2),
            lambda q, k, v: na2d.heads_forward(q, k, v, 7, save_lse=True),
            lambda q, k, v: (na2d.na2d_reference(q, k, v, 7),
                             na_lse_plain(q, k, 7)), flops,
            timed=lambda m=m: na2d.heads_forward(*m[:3], 7, save_lse=True),
            library=under_tf32(True, na_library(m[:3])), skip=(1,)))
        fwd = na2d.heads_forward(*m[:3], 7, save_lse=True)
        specs.append(F32Spec(
            "na2d_heads_bwd_f32", label, n, lambda m=m: m, (0, 1, 2, 3),
            heads_vjp,
            lambda q, k, v, dout: na2d.heads_reference_backward(q, k, v, dout,
                                                                7),
            5 * flops // 2,
            timed=lambda m=m, f=fwd: na2d.heads_backward(*m[:3], *f, m[3], 7),
            library=under_tf32(True, na_library(m[:3], m[3])), reads=fwd))
    return specs


def na_f32_bit_check(dev):
    """Phase 27 (b): at both flagship NA levels (batch 8, cosine-sim q and
    k, float32): K2-f32 and K11-f32 run one kernel (csrc/na_tf32.cuh), so
    on one packed input, read by K11 as its (b, h, w, heads, 64) views,
    they give the same out and lse bit for bit; K7-f32 and K12-f32 the
    same dq, dk, dv; no partials and no atomics, so a rerun of each gives
    bit-identical outputs."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 34)

    def same(pair, names, got, want):
        for name, a, b_ in zip(names, got, want):
            a = a.reshape(b_.shape)
            if not torch.equal(a, b_):
                diff = (a - b_).abs().max().item()
                raise AssertionError(f"{pair} {name} differ by {diff:.3e}")

    labels = []
    for h, c in ((64, 128), (32, 256)):
        b, heads = SAMPLE_BATCH, c // 64
        t = torch.randn((2, b, h, h, heads, 64), generator=g)
        q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
            2, b, h, h, c).to(dev)
        v, dout = torch.randn((2, b, h, h, c), generator=g).to(dev)
        fwd = na2d.packed_forward(q, k, v, heads, 7, save_lse=True)
        split = split_heads((q, k, v, dout), heads)
        fwd11 = na2d.heads_forward(*split[:3], 7, save_lse=True)
        same("K2-f32 and K11-f32", ("out", "lse"), fwd11, fwd)
        same("K2-f32 rerun", ("out", "lse"),
             na2d.packed_forward(q, k, v, heads, 7, save_lse=True), fwd)
        same("K11-f32 rerun", ("out", "lse"),
             na2d.heads_forward(*split[:3], 7, save_lse=True), fwd11)
        k7 = na2d.packed_backward(q, k, v, *fwd, dout, heads, 7)
        k12 = na2d.heads_backward(*split[:3], *fwd11, split[3], 7)
        names = ("dq", "dk", "dv")
        same("K12-f32 and K7-f32", names, k12, k7)
        same("K7-f32 rerun", names,
             na2d.packed_backward(q, k, v, *fwd, dout, heads, 7), k7)
        same("K12-f32 rerun", names,
             na2d.heads_backward(*split[:3], *fwd11, split[3], 7), k12)
        labels.append(f"{b}x{h}x{h}x{c}")
    print(f"NA float32 bit check [{', '.join(labels)}]: K2-f32 = K11-f32 "
          f"(out, lse) and K7-f32 = K12-f32 (dq, dk, dv) bit for bit on one "
          f"packed input, and a rerun of each bit-identical", flush=True)


def na_float32_phase(KT, config, dev, smi, results, cpu_ref, bf16_reports):
    """Phase 27: (a) the float32 NA kernels at their shapes against their
    plain versions, timed beside them, the TF32 bound and masked SDPA on
    float32, and against float64 beside their bf16 forms; (b) the bit
    checks; (c) the flagship at batch 2 in float32 and in bf16 against the
    float32 CPU side of phases 4 and 7 (``cpu_ref``), forward and
    gradient; (d) 50-step DPM++(2M) at batch 8 in float32, (e) 3 + 20
    training steps at batch 32, fused and unfused, each with its launch
    counts in float32 kernels only and beside phases 5, 8 and 16's bf16
    figures (``bf16_reports``); (f) the trainer with --mixed-precision no
    on the flagship, its resume bit-equal; (g) config_512_hdit at full
    size in float32 against bf16 (``f32_full_size``), and cut to 256 x 256
    (unfused) and config_256_p8_wide (fused and unfused) against the CPU
    (``f32_model_parity``), and 3 + 20 float32 training steps of each as
    shipped. Returns the launch counts of the flagship's float32 sampling,
    fused and unfused training runs, and the figures of those runs (rates,
    card time, peak memory), which phase 28 prints its own beside."""
    from k_diffusion_tpu_torch.models import flops

    print("phase 27: float32 compute on the card (--mixed-precision no), the "
          "neighborhood-attention configs", flush=True)
    specs = na_f32_specs(dev)
    with torch.no_grad():
        run_cases(f32_cases(specs), results, 20, 2)
        f32_bwd_compare(results, ("na2d_bwd_f32", "na2d_heads_bwd_f32"))
        f32_tf32_check(specs)
    del specs
    torch.cuda.empty_cache()
    na_f32_bit_check(dev)
    CLOCK.part("phase 27 (a)-(b) kernels")

    per_call = hdit_layout(KT, config, False)
    f32_parity(KT, config, dev, "flagship", cpu_ref["forward"],
               cpu_ref["gradient"], per_call,
               hdit_layout(KT, no_dropout(config), True))
    CLOCK.part("phase 27 (c) parity")

    hdit_flops = 2 * flops.analytic_transformer_flops(config, 1)
    f32_reports = {"sampling": {}, "training": {}, "unfused training": {}}
    sample_counts, train_counts = model_runs(
        KT, config, dev, smi, "flagship", SAMPLE_BATCH, TRAIN_BATCH, per_call,
        hdit_layout(KT, config, True), hdit_flops,
        (f32_reports["sampling"], f32_reports["training"]))
    with tf32(True), train_fusion("0"):
        unfused_counts, _ = train(
            KT, config, dev, smi, TRAIN_BATCH,
            as_f32(hdit_unfused_layout(config)), hdit_flops,
            "flagship unfused training float32", dtype=torch.float32,
            report=f32_reports["unfused training"])
    for what, f32 in f32_reports.items():
        bf, call = bf16_reports[what], what == "sampling"
        print(f"flagship {what} at batch "
              f"{SAMPLE_BATCH if call else TRAIN_BATCH}, float32 against "
              f"bf16 (phase {5 if call else 8 if what == 'training' else 16})"
              f": {f32['rate']:.3f} against {bf['rate']:.3f} "
              f"{'samples' if call else 'images'}/s (host clock); card time "
              f"{f32['busy_ms']:.3f} against {bf['busy_ms']:.3f} ms a "
              f"{'call' if call else 'step'} (profile); peak memory "
              f"{f32['peak'] / 2**30:.3f} against {bf['peak'] / 2**30:.3f} "
              f"GiB, on {smi}", flush=True)
    CLOCK.part("phase 27 (d)-(e) sampling and training")

    float32_trainer(KT, CONFIG, TRAIN_BATCH,
                    as_f32(hdit_layout(KT, config, True)), smi)
    CLOCK.part("phase 27 (f) trainer")

    other_na_configs_f32(KT, dev, smi)
    CLOCK.part("phase 27 (g) config_512_hdit and config_256_p8_wide")
    return sample_counts, train_counts, unfused_counts, f32_reports


def other_na_configs_f32(KT, dev, smi):
    """Phase 27 (g): config_512_hdit at full size in float32 against bf16
    (``f32_full_size``); config_512_hdit cut to 256 x 256 (unfused) and
    config_256_p8_wide (fused and unfused) against the CPU
    (``f32_model_parity``); 3 + 20 float32 training steps of each as
    shipped."""
    from k_diffusion_tpu_torch.models import flops

    hdit_512 = no_dropout(KT.config.load_config(HDIT_512))
    f32_full_size(KT, hdit_512, dev, HDIT_512.stem, 2)
    # cut to 256 x 256 for the CPU side; unfused only, as f32_full_size
    # says why (bf16's K10 at d 768)
    cut = copy.deepcopy(hdit_512)
    cut["model"]["input_size"] = [256, 256]
    with train_fusion("0"):
        f32_model_parity(KT, cut, dev, f"{HDIT_512.stem} at 256 x 256 "
                         f"unfused", 2, 2, hdit_layout(KT, cut, False),
                         hdit_unfused_layout(cut))
    p8_wide = no_dropout(KT.config.load_config(P8_WIDE))
    f32_model_parity(KT, p8_wide, dev, P8_WIDE.stem, F32_PARITY_BATCH,
                     F32_PARITY_BATCH, hdit_layout(KT, p8_wide, False),
                     hdit_layout(KT, p8_wide, True),
                     hdit_unfused_layout(p8_wide))
    for path, batch in ((HDIT_512, SAMPLE_BATCH), (P8_WIDE, TRAIN_BATCH)):
        shipped = KT.config.load_config(path)
        with tf32(True):
            train(KT, shipped, dev, smi, batch,
                  as_f32(hdit_layout(KT, shipped, True)),
                  2 * flops.analytic_transformer_flops(shipped, 1),
                  f"{path.stem} training float32", dtype=torch.float32)


def f32_full_size(KT, config, dev, name, batch):
    """Phase 27 (g): ``config`` (dropout 0) at its full size, the same
    seeded weights in float32 on the card with TF32 on and in bf16 on the
    card: a denoiser call (eval) and one loss's full parameter gradient,
    unfused (KDT_TRAIN_FUSION=0) in both dtypes and fused in float32, each
    with its launch counts in its dtype's kernels only and finite. bf16
    takes no fused step here: its K10 takes d up to 576 and
    config_512_hdit's 768-wide level runs its feed-forward block fused once
    its dropout is 0. float32 within FORWARD_REL_BOUND (the call) and
    GRAD_REL_BOUND (both gradients) relative L2 of bf16 (the call, the
    unfused gradient), and the fused float32 gradient within
    F32_MODEL_SHARE x that distance of the unfused float32 one. No CPU side
    at this size: the plain neighborhood attention is dense masked
    attention, O((h w)^2) at 128 x 128."""
    from k_diffusion_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(SEED + 33)
    reference = KT.config.make_model(config, device="cpu", generator=g)
    fill_zero_init(reference, g)
    state = reference.state_dict()
    del reference
    x, reals, noise = (torch.randn(input_shape(config, batch), generator=g)
                       for _ in range(3))
    sigma = torch.linspace(0.5, 8.0, batch)
    loss_sigma = KT.config.make_sample_density(config["model"])(
        (batch,), stratified=(0, 1), generator=g, device="cpu")
    runs = {"call": (hdit_layout(KT, config, False), "1"),
            "fused step": (hdit_layout(KT, config, True), "1"),
            "unfused step": (hdit_unfused_layout(config), "0")}
    found = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = KT.config.make_model(config, dtype=dtype, device="cpu")
        model.load_state_dict(state)
        model.to(dev).eval()
        den = KT.config.make_denoiser_wrapper(config)(model)
        for what, (per, fusion) in runs.items():
            if dtype == torch.bfloat16 and what == "fused step":
                continue
            kernels.reset_launch_counts()
            with tf32(True), train_fusion(fusion):
                if what == "call":
                    with torch.no_grad():
                        got = den(x.to(dev), sigma.to(dev))
                else:
                    loss = den.loss(reals.to(dev), noise.to(dev),
                                    loss_sigma.to(dev)).mean()
                    got = torch.cat([p.flatten() for p in torch.autograd.grad(
                        loss, list(model.parameters()))])
            got = got.float().cpu()
            counts = kernels.launch_counts()
            expected = dict.fromkeys(kernels.COUNTERS, 0) | (
                as_f32(per) if dtype == torch.float32 else per)
            if counts != expected:
                raise AssertionError(f"{name} {what} ({dtype}): launch "
                                     f"counts {counts} != {expected}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {what} ({dtype}): not finite")
            found[dtype, what] = got
            model.train()
        del model, den
        torch.cuda.empty_cache()
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    bf = lambda what: found[torch.bfloat16, what]
    f32 = lambda what: found[torch.float32, what]
    errs = {"call": rel(f32("call"), bf("call")),
            "fused": rel(f32("fused step"), bf("unfused step")),
            "unfused": rel(f32("unfused step"), bf("unfused step")),
            "routes": rel(f32("fused step"), f32("unfused step"))}
    print(f"{name} float32 at full size ({tuple(x.shape)}), dropout 0, "
          f"against bf16 on the card, same weights and inputs: relative L2 "
          f"call {errs['call']:.3e} (bound {FORWARD_REL_BOUND}); gradient "
          f"of {f32('fused step').numel()} params, against bf16's unfused: "
          f"float32 fused {errs['fused']:.3e}, unfused {errs['unfused']:.3e} "
          f"(bound {GRAD_REL_BOUND}), float32 fused against float32 unfused "
          f"{errs['routes']:.3e} (bound {F32_MODEL_SHARE} x "
          f"{errs['unfused']:.3e}); launches in each dtype's kernels only, "
          f"float32: call {as_f32(runs['call'][0])}, fused step "
          f"{as_f32(runs['fused step'][0])}, unfused step "
          f"{as_f32(runs['unfused step'][0])}", flush=True)
    if not (errs["call"] <= FORWARD_REL_BOUND
            and max(errs["fused"], errs["unfused"]) <= GRAD_REL_BOUND
            and errs["routes"] <= F32_MODEL_SHARE * errs["unfused"]):
        raise AssertionError(f"{name} float32 against bf16: {errs}")


# phase 28: the flagship with head dim 128 at its neighborhood levels (no
# config ships one; ``na128_config``), sampled and trained in bf16 and in
# float32: its NA levels take the plain prologue (``fused_qkv.takes``) and
# K11/K12 at head dim 128, in bf16 the wgmma kernels of csrc/na_fwd.cuh and
# csrc/na_bwd.cuh (as at head dims 32 and 64), in float32
# csrc/na_tf32.cuh's (two warpgroups a block); K15-f32
# (csrc/na_proj_tf32.cuh) and K8-f32 on their op paths.
# name -> (source, TPU kernel, the launch counter its main path reads)
NA128_KERNELS = {
    "na2d_heads_e128": ("na_fwd.cuh", "na2d.py:180", "na2d_heads"),
    "na2d_heads_bwd_e128": ("na_bwd.cuh", "na2d.py:241", "na2d_heads_bwd"),
    "na2d_heads_f32_e128": ("na_tf32.cuh", "na2d.py:180", "na2d_heads_f32"),
    "na2d_heads_bwd_f32_e128": ("na_tf32.cuh", "na2d.py:241",
                                "na2d_heads_bwd_f32"),
    "na2d_proj_f32": ("na_proj_tf32.cuh", "na2d.py:991", "na2d_proj_f32"),
    "na2d_overlap_add_f32": ("na2d.cu", "na2d.py:809", "na2d_overlap_add_f32"),
}
# K15-f32 with w_out = I and skip = 0 against the float32 forward's output,
# element by element: one TF32 rounding (2^-11) of the attention output
PROJ_IDENTITY_REL_BOUND = 2.0 ** -10


def with_na_head_dim_128(config):
    """``config`` (config_oxford_flowers.json, as JSON or loaded) with head
    dim 128 at its neighborhood levels: one head of 128 at 64 x 64 tokens,
    two at 32 x 32; the global level keeps eight heads of 64 at 16 x 16."""
    for attn in config["model"]["self_attns"]:
        if attn["type"] == "neighborhood":
            attn["d_head"] = 128
    return config


def na128_config(KT):
    """The NA-128 flagship's config, loaded as the port loads a config."""
    return with_na_head_dim_128(KT.config.load_config(CONFIG))


def na128_specs(dev):
    """Phase 28 (a): K11 and K12 at head dim 128 at the NA-128 flagship's
    NA levels, batch 8 (8 x 64 x 64 x 1 x 128 and 8 x 32 x 32 x 2 x 128, 4
    calls a level per denoiser call or step), q and k cosine-sim and
    contiguous, v a strided third of the projection, as the plain prologue
    leaves them: their float32 forms (``F32Spec``, timed beside the plain
    version, the TF32 bound and masked SDPA on float32) and their bf16
    forms on the same maps (``Case``). The forward is timed as sampling
    runs it (no lse), each backward alone from its forward's out and lse."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 40)
    b, bf16 = SAMPLE_BATCH, torch.bfloat16

    def vjp(q, k, v, dout):
        fwd = na2d.heads_forward(q, k, v, 7, save_lse=True)
        return na2d.heads_backward(q, k, v, *fwd, dout, 7)

    specs, cases = [], []
    for h, heads in ((64, 1), (32, 2)):
        t = torch.randn((b, h, h, 3, heads, 128), generator=g)
        qk = t[:, :, :, :2] / t[:, :, :, :2].norm(dim=-1, keepdim=True)
        q, k, v = torch.cat([qk * 10 ** 0.5, t[:, :, :, 2:]], 3).to(
            dev).unbind(3)
        m = [q.contiguous(), k.contiguous(), v,
             torch.randn((b, h, h, heads, 128), generator=g).to(dev)]
        label = f"{b}x{h}x{h}x{heads}x128"
        flops = 4 * b * h * h * heads * 128 * 7 ** 2
        specs.append(F32Spec(
            "na2d_heads_f32_e128", label, 4, lambda m=m: m[:3], (0, 1, 2),
            lambda q, k, v: na2d.heads_forward(q, k, v, 7, save_lse=True),
            lambda q, k, v: (na2d.na2d_reference(q, k, v, 7),
                             na_lse_plain(q, k, 7)), flops,
            timed=lambda m=m: na2d.heads_forward(*m[:3], 7),
            library=under_tf32(True, na_library(m[:3])), skip=(1,)))
        fwd = na2d.heads_forward(*m[:3], 7, save_lse=True)
        specs.append(F32Spec(
            "na2d_heads_bwd_f32_e128", label, 4, lambda m=m: m, (0, 1, 2, 3),
            vjp,
            lambda q, k, v, dout: na2d.heads_reference_backward(q, k, v, dout,
                                                                7),
            5 * flops // 2,
            timed=lambda m=m, f=fwd: na2d.heads_backward(*m[:3], *f, m[3], 7),
            library=under_tf32(True, na_library(m[:3], m[3])), reads=fwd))
        q, k, v, dout = (x.to(bf16) for x in m)
        cases.append(Case(
            "na2d_heads_e128", label, 4,
            lambda a=(q, k, v): na2d.na2d(*a, 7),
            lambda a=(q, k, v): na2d.na2d_reference(*a, 7), flops, (q, k, v),
            timed=lambda a=(q, k, v): na2d.heads_forward(*a, 7),
            library=na_library((q, k, v))))
        out, lse = na2d.heads_forward(q, k, v, 7, save_lse=True)
        cases.append(Case(
            "na2d_heads_bwd_e128", label, 4,
            lambda a=(q, k, v, out, lse, dout): na2d.heads_backward(*a, 7),
            lambda a=(q, k, v, dout): na2d.heads_reference_backward(*a, 7),
            5 * flops // 2, (q, k, v, out, lse, dout),
            library=na_library((q, k, v), dout)))
    return specs, cases


def na128_rerun_check(specs):
    """Phase 28 (a): K11 and K12 at head dim 128 have no partials and no
    atomics, in float32 and in bf16: a rerun of each on the same maps (the
    float32 specs', and the same maps in bf16) is bit-equal (out, lse; dq,
    dk, dv)."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    labels = []
    for s in specs:
        if s.name != "na2d_heads_bwd_f32_e128":
            continue
        maps = s.make()
        for tag, dtype in (("-f32", torch.float32), ("", torch.bfloat16)):
            q, k, v, dout = (t.to(dtype) for t in maps)
            fwd = na2d.heads_forward(q, k, v, 7, save_lse=True)
            grads = na2d.heads_backward(q, k, v, *fwd, dout, 7)
            for what, first, again in (
                    (f"K11{tag}", fwd, na2d.heads_forward(q, k, v, 7,
                                                         save_lse=True)),
                    (f"K12{tag}", grads, na2d.heads_backward(q, k, v, *fwd,
                                                            dout, 7))):
                for a, b_ in zip(first, again):
                    if not torch.equal(a, b_):
                        raise AssertionError(f"{what} at head dim 128 "
                                             f"[{s.label}]: a rerun differs")
        labels.append(s.label)
    print(f"NA-128 rerun check [{', '.join(labels)}]: K11 and K11-f32 (out, "
          f"lse), K12 and K12-f32 (dq, dk, dv) at head dim 128 bit-identical "
          f"on a rerun", flush=True)


def na128_compare(results):
    """Phase 28 (a): the bf16 forms of K11 and K12 at head dim 128 at each
    NA-128 shape against masked SDPA (the same shapes; hw / 49 times the
    work), and their sums a call or step against their float32 forms'."""
    for bf, f32 in (("na2d_heads_e128", "na2d_heads_f32_e128"),
                    ("na2d_heads_bwd_e128", "na2d_heads_bwd_f32_e128")):
        r = results[bf]
        shapes = "; ".join(
            f"{label} {t['ms']:.4f} ms, masked SDPA {t['library_ms']:.4f} "
            f"({t['library_ms'] / t['ms']:.2f}x)"
            for label, t in r["shapes"].items())
        print(f"NA-128 {bf}: {shapes}; a call or step {r['ms']:.4f} ms, "
              f"{r['bound_ms'] / r['ms']:.1%} of its bound, against its "
              f"float32 form's {results[f32]['ms']:.4f} ms", flush=True)


def proj_f32_specs(dev):
    """Phase 28 (b): K15-f32 at one op call at each flagship NA level
    (batch 8: 8 x 64 x 64 x 128 and 8 x 32 x 32 x 256, head dim 64) and,
    counting no call, at head dim 32 (8 x 64 x 64 x 128, two heads a
    rank); operations 4 * 49 * c for the attention and 2 * c * c for the
    projection per query. No single PyTorch call computes it (library
    null)."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 41)
    b = SAMPLE_BATCH
    specs = []
    for h, c, e, n in ((64, 128, 64, 1), (32, 256, 64, 1), (64, 128, 32, 0)):
        t = torch.randn((2, b, h, h, c // e, e), generator=g)
        q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
            2, b, h, h, c).to(dev)
        v, skip = (torch.randn((b, h, h, c), generator=g).to(dev)
                   for _ in range(2))
        w = (torch.randn((c, c), generator=g) * c ** -0.5).to(dev)
        m, heads, rows = [q, k, v, skip, w], c // e, b * h * h
        specs.append(F32Spec(
            "na2d_proj_f32", f"{b}x{h}x{h}x{c} e={e}", n, lambda m=m: m,
            (0, 1, 2, 3),
            lambda *a, heads=heads: (na2d.na2d_packed_proj(*a, heads, 7),),
            lambda *a, heads=heads: (na2d.proj_reference(*a, heads, 7),),
            4 * rows * c * 7 ** 2 + 2 * rows * c * c))
    return specs


def proj_f32_identity_check(specs):
    """Phase 28 (b): K15-f32 with w_out = I and skip = 0 against the float32
    forward on the same maps (K2-f32 at head dim 64, K11-f32 on the
    per-head views at 32): one TF32 rounding of the attention output
    apart, within PROJ_IDENTITY_REL_BOUND of it element by element."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    worst = 0.0
    for s in specs:
        q, k, v, skip, _ = s.make()
        c, e = q.shape[-1], int(s.label.split("e=")[1])
        heads = c // e
        got = na2d.proj_forward(q, k, v, torch.zeros_like(skip),
                                torch.eye(c, device=q.device), heads, 7)
        if e == 64:
            want, _ = na2d.packed_forward(q, k, v, heads, 7)
        else:
            split = split_heads((q, k, v), heads)
            want = na2d.heads_forward(*split, 7)[0].reshape(q.shape)
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30))
        rel = torch.where(want == 0, (got != 0).float(), rel).max().item()
        if not rel <= PROJ_IDENTITY_REL_BOUND:
            raise AssertionError(f"K15-f32 identity [{s.label}]: {rel:.3e} "
                                 f"of the float32 forward's output")
        worst = max(worst, rel)
    print(f"K15-f32 identity check [{', '.join(s.label for s in specs)}]: "
          f"w_out = I, skip = 0 against K2-f32 (e = 64) and K11-f32 (e = "
          f"32): worst {worst:.3e} of each element (bound 2^-10)", flush=True)


def proj_f32_path(specs):
    """Phase 28 (b): K15-f32's op path, forward and backward (autograd) at
    both flagship NA levels with the launch counts read around it (K15-f32
    forward; the attention recomputed by K2-f32 and its gradients by
    K7-f32), the gradients held against autograd through the plain
    version in float32 (TF32 off) within F32_KERNEL_REL_BOUND. Returns the
    counts."""
    from k_diffusion_tpu_torch.ops import kernels
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 42)
    calls = [s for s in specs if s.calls]
    got, cots = [], []
    kernels.reset_launch_counts()
    with tf32(False):
        for s in calls:
            q = s.make()[0]
            heads = q.shape[-1] // int(s.label.split("e=")[1])
            leaves = [t.detach().requires_grad_() for t in s.make()]
            dout = torch.randn(q.shape, generator=g).to(q.device)
            out = na2d.na2d_packed_proj(*leaves, heads, 7)
            got.append(torch.autograd.grad(out, leaves, dout))
            cots.append((heads, dout))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        n = len(calls)
        expected = dict.fromkeys(kernels.COUNTERS, 0) | {
            "na2d_proj_f32": n, "na2d_f32": n, "na2d_bwd_f32": n}
        if counts != expected:
            raise AssertionError(f"na2d_packed_proj float32 path: launch "
                                 f"counts {counts} != expected {expected}")
        for s, grads, (heads, dout) in zip(calls, got, cots):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in s.make()]
                want = torch.autograd.grad(
                    na2d.proj_reference(*leaves, heads, 7), leaves, dout)
            for name, a, b_ in zip(("q", "k", "v", "skip", "w_out"), grads,
                                   want):
                check_close(f"na2d_packed_proj float32 backward d{name} "
                            f"{s.label}", a, b_, F32_KERNEL_REL_BOUND)
    print(f"na2d_packed_proj float32 path: launches {counts}; gradients "
          f"within {F32_KERNEL_REL_BOUND} x max|plain| (TF32 off)", flush=True)
    return counts


def overlap_f32_cases(dev):
    """Phase 28 (c): K8-f32 at one op call at each flagship NA level, batch
    8, on seeded float32 halo partials (b, heads, tiles, 208, 64) (K8
    sums them, so any partials hold it to its plain version), against the
    plain overlap-add in float32; the library call one ``index_add_`` of
    the dk and dv halo rows, as phase 6's. Returns the cases and the op
    path's arguments."""
    from k_diffusion_tpu_torch.ops.kernels import na2d

    g = torch.Generator().manual_seed(SEED + 43)
    b, halo = SAMPLE_BATCH, na2d.TILE + na2d.MAX_KERNEL - 1
    cases, overlap = [], []
    for h, heads in ((64, 2), (32, 4)):
        parts = tuple(torch.randn((b, heads, (h // na2d.TILE) ** 2,
                                   na2d.HALO_KEYS, 64), generator=g).to(dev)
                      for _ in range(2))
        overlap.append((*parts, h, h, 7))
        rows = torch.cat([p[:, :, :, :halo * halo].reshape(b, heads, -1, 64)
                          for p in parts], -1)
        sums = torch.zeros((b, heads, h * h + 1, 128), device=dev)
        cases.append(Case(
            "na2d_overlap_add_f32", f"{b}x{h}x{h}x{heads * 64}", 1,
            lambda p=parts, h=h: na2d.overlap_add(*p, h, h, 7,
                                                  dtype=torch.float32),
            lambda p=parts, h=h: na2d.overlap_add_reference(
                *p, h, h, 7, dtype=torch.float32),
            0, parts,
            library=lambda s=sums, t=na2d.overlap_add_targets(h, h, 7, dev),
            r=rows: s.index_add_(2, t, r),
            rel_bound=F32_KERNEL_REL_BOUND, peak=PEAK_TF32_FLOPS))
    return cases, overlap


def na128_phase(KT, dev, smi, results, bf16_reports, f32_reports):
    """Phase 28: the flagship with head dim 128 at its NA levels. (a) K11
    and K12 at head dim 128 in float32 and bf16 at its NA levels against
    their plain versions, the float32 forms against float64 beside the bf16
    ones and rerun bit-equal; (b) K15-f32 against its plain version, its
    identity check and its op path; (c) K8-f32 and its op path; (d) the
    model at batch 2 in bf16 and float32 from the same weights against
    float32 on the CPU, forward and gradient; (e) 50-step DPM++(2M) at
    batch 8 (also through condcache) and 3 + 20 training steps at batch 32
    in each dtype, beside the flagship's (phases 5, 8 and 27:
    ``bf16_reports``, ``f32_reports``); (f) the trainer with
    --mixed-precision no on it, its resume bit-equal. Returns the launch
    counts of each kernel's main path, by kernel name."""
    from k_diffusion_tpu_torch.models import flops

    print("phase 28: the flagship with head dim 128 at its neighborhood "
          "levels, bf16 and float32", flush=True)
    specs, cases = na128_specs(dev)
    with torch.no_grad():
        run_cases(f32_cases(specs), results, 20, 2)
        run_cases(cases, results, 20, 2)
        na128_compare(results)
        f32_bwd_compare(results, ("na2d_heads_bwd_f32_e128",))
        f32_tf32_check(specs)
        na128_rerun_check(specs)
    del specs, cases
    torch.cuda.empty_cache()
    CLOCK.part("phase 28 (a) K11, K12 at head dim 128")

    specs = proj_f32_specs(dev)
    with torch.no_grad():
        run_cases(f32_cases(specs), results, 50, 3)
        f32_tf32_check(specs)
        proj_f32_identity_check(specs)
    proj_counts = proj_f32_path(specs)
    del specs
    cases, overlap = overlap_f32_cases(dev)
    with torch.no_grad():
        run_cases(cases, results, 20, 3)
    overlap_counts = overlap_path(overlap, torch.float32)
    del cases, overlap
    torch.cuda.empty_cache()
    CLOCK.part("phase 28 (b)-(c) K15-f32, K8-f32")

    config = na128_config(KT)
    per_call = hdit_layout(KT, config, False)
    f32_model_parity(KT, config, dev, "NA-128 flagship", 2, 2, per_call,
                     hdit_layout(KT, no_dropout(config), True))
    CLOCK.part("phase 28 (d) parity")

    hdit_flops = 2 * flops.analytic_transformer_flops(config, 1)
    per_step = hdit_layout(KT, config, True)
    reports, counts = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        reports[dtype] = ({}, {})
        counts[dtype] = model_runs(
            KT, config, dev, smi, "NA-128 flagship", SAMPLE_BATCH,
            TRAIN_BATCH, per_call, per_step, hdit_flops, reports[dtype],
            dtype)
    flagship = {torch.bfloat16: (bf16_reports["sampling"],
                                 bf16_reports["training"]),
                torch.float32: (f32_reports["sampling"],
                                f32_reports["training"])}
    for dtype, (s, t) in reports.items():
        fs, ft = flagship[dtype]
        what = "float32" if dtype == torch.float32 else "bf16"
        print(f"NA-128 flagship {what} against the flagship's {what} (phase "
              f"{27 if dtype == torch.float32 else '5 and 8'}): sampling at "
              f"batch {SAMPLE_BATCH} {s['rate']:.3f} against {fs['rate']:.3f} "
              f"samples/s (host clock), card time {s['busy_ms']:.3f} against "
              f"{fs['busy_ms']:.3f} ms a call, peak {s['peak'] / 2**30:.3f} "
              f"against {fs['peak'] / 2**30:.3f} GiB; training at batch "
              f"{TRAIN_BATCH} {t['rate']:.3f} against {ft['rate']:.3f} "
              f"images/s, card time {t['busy_ms']:.3f} against "
              f"{ft['busy_ms']:.3f} ms a step, peak {t['peak'] / 2**30:.3f} "
              f"against {ft['peak'] / 2**30:.3f} GiB; launches per call "
              f"{per_call}, per step {per_step}, on {smi}", flush=True)
    CLOCK.part("phase 28 (e) sampling and training")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "config_oxford_flowers_na128.json"
        path.write_text(json.dumps(with_na_head_dim_128(json.loads(
            CONFIG.read_text()))))
        float32_trainer(KT, path, TRAIN_BATCH, as_f32(per_step), smi)
    CLOCK.part("phase 28 (f) trainer")
    (bf_sample, bf_train), (f_sample, f_train) = (counts[torch.bfloat16],
                                                  counts[torch.float32])
    return {"na2d_heads_e128": bf_sample, "na2d_heads_bwd_e128": bf_train,
            "na2d_heads_f32_e128": f_sample,
            "na2d_heads_bwd_f32_e128": f_train, "na2d_proj_f32": proj_counts,
            "na2d_overlap_add_f32": overlap_counts}


def forward_flops(KT, config, name="unet", **cond):
    """A model's FLOPs per image per forward: torch.utils.flop_counter
    over the plain forward on the CPU at batch 1 (convolutions, matmuls and
    the attention products), with ``cond`` (batch 1) as its other
    inputs."""
    from torch.utils.flop_counter import FlopCounterMode

    model = KT.config.make_model(config, device="cpu").eval()
    x = torch.zeros(input_shape(config, 1))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        KT.config.make_denoiser_wrapper(config)(model)(x, torch.ones(1),
                                                       **cond)
    total = counter.get_total_flops()
    print(f"{name} flops: {total} per image per forward (FlopCounterMode, "
          f"plain CPU forward at batch 1)", flush=True)
    return total


def no_dropout(config):
    model = dict(config["model"])
    for key in ("dropout_rate", "mapping_dropout_rate"):
        rate = model.get(key)
        if isinstance(rate, list):
            model[key] = [0.0] * len(rate)
        elif rate is not None:
            model[key] = 0.0
    return dict(config, model=model)


def grad_parity(KT, config, dev, fill, name, keep=None, **cond):
    """Phases 7, 12, 16 and 17: one step's loss and full parameter gradient,
    bf16 on the card against f32 on the CPU, from the same weights, reals,
    noise, sigmas and ``cond`` (batch 2). Dropout is off: the two devices'
    generators draw different masks. Returns the launch counts of the
    card's step. ``keep``, where given, receives the CPU side: the
    weights, the draws, the loss and the gradient."""
    from k_diffusion_tpu_torch.ops import kernels

    config = no_dropout(config)
    g = torch.Generator().manual_seed(SEED + 3)
    model = KT.config.make_model(config, dtype=torch.bfloat16, device="cpu",
                                 generator=g)
    fill(model, g)
    reference = KT.config.make_model(config, device="cpu")
    reference.load_state_dict(model.state_dict())
    model.to(dev).train()
    reference.train()
    reals = torch.randn(input_shape(config, 2), generator=g)
    noise = torch.randn(input_shape(config, 2), generator=g)
    sigma = KT.config.make_sample_density(config["model"])(
        (2,), stratified=(0, 1), generator=g, device="cpu")
    grads = []
    kernels.reset_launch_counts()
    for m, d in ((model, dev), (reference, torch.device("cpu"))):
        den = KT.config.make_denoiser_wrapper(config)(m)
        loss = den.loss(reals.to(d), noise.to(d), sigma.to(d),
                        **{k: v.to(d) for k, v in cond.items()}).mean()
        flat = torch.cat([p.flatten() for p in torch.autograd.grad(
            loss, list(m.parameters()))])
        grads.append((loss.item(), flat.float().cpu()))
    counts = kernels.launch_counts()  # the CPU side launches nothing
    (loss, got), (ref_loss, want) = grads
    rel = ((got - want).norm() / want.norm()).item()
    if keep is not None:
        keep.update(state=reference.state_dict(), reals=reals, noise=noise,
                    sigma=sigma, loss=ref_loss, grad=want, bf16=rel)
    if not (rel <= GRAD_REL_BOUND and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: relative L2 error {rel:.3e} "
                             f"> {GRAD_REL_BOUND}")
    print(f"{name}: batch 2, dropout 0 (the card's and the CPU's mask "
          f"generators differ), sigmas {sigma.tolist()}: loss {loss:.6f} "
          f"bf16 on the card vs {ref_loss:.6f} f32 on the CPU; gradient of "
          f"{want.numel()} params: relative L2 error {rel:.3e} (bound "
          f"{GRAD_REL_BOUND}); launches {counts}", flush=True)
    del model, reference
    torch.cuda.empty_cache()
    return counts


def hdit_layout(KT, config, training):
    """An HDiT config's launches per denoiser call (``training`` False) or
    per fused training step (True, dropout as configured) on its kernels,
    by level, routed as the model routes: K1 at each attention layer whose
    width and head dim it takes (``fused_qkv.takes``; the plain prologue
    elsewhere), at a neighborhood one K2 where the prologue ran fused and
    ``na2d.packed_takes`` the level, else K11, K3 (or the flash kernel
    where K3 does not take the level) at a global one, none at a
    shifted-window one (PyTorch ops); K4 where the feed-forward block runs
    fused (in training where its dropout is 0), K5 once (in training where
    the mapping network's dropout is 0); in training also each kernel's
    backward."""
    from k_diffusion_tpu_torch.ops.kernels import fused_qkv, global_packed, na2d

    m = config["model"]
    side = m["input_size"][0] // m["patch_size"][0]
    last = len(m["depths"]) - 1
    counts = collections.Counter()
    for i, (depth, width, attn, p) in enumerate(zip(
            m["depths"], m["widths"], m["self_attns"], m["dropout_rate"])):
        layers = depth if i == last else 2 * depth
        s = (side >> i) ** 2
        kinds = []
        e = attn.get("d_head", 64)
        fused = attn["type"] != "none" and fused_qkv.takes(width, width // e)
        if fused:
            kinds.append("fused_qkv")
        if attn["type"] == "neighborhood":
            kinds.append("na2d" if fused and na2d.packed_takes(width, e)
                         else "na2d_heads")
        if attn["type"] == "global":
            kinds.append("global_packed" if global_packed.takes(
                s, width, width // e) else "flash")
        if not (training and p):
            kinds.append("fused_ffn")
        for kind in kinds:
            counts[kind] += layers
            if training:
                counts[kind + "_bwd"] += layers
    if not (training and m["mapping_dropout_rate"]):
        counts["fused_mapping"] += 1
    return dict(counts)


def hdit_unfused_layout(config):
    """An HDiT config's kernel launches per training step with
    KDT_TRAIN_FUSION=0, for neighborhood levels under one global level
    (the flagship, config_512_hdit, config_256_p8_wide): the NA levels
    through K11/K12, the global level through K3/K9, the mapping network through K5; the prologue and the
    feed-forward blocks unfused (no K1/K4/K6/K10), no K2/K7/K8."""
    levels = config["model"]["depths"]
    na = 2 * sum(levels[:-1])
    return {"na2d_heads": na, "na2d_heads_bwd": na,
            "global_packed": levels[-1], "global_packed_bwd": levels[-1],
            "fused_mapping": int(config["model"]["mapping_dropout_rate"] == 0)}


def train(KT, config, dev, smi, batch, per_step, fwd_flops, name,
          dtype=torch.bfloat16, report=None):
    """Phases 8, 12, 16 and 25-27: the config as it is (dropout on) at
    ``batch``, computing in ``dtype``, on seeded synthetic reals (and a
    seeded aug_cond where the model takes one) through
    training.make_train_step; launch counts ``per_step`` per step.
    ``fwd_flops``: the model's FLOPs per image per forward. Returns the
    launch counts of the timed steps and the images per second;
    ``report``, where given, receives the seconds, images/s, peak memory
    and the profile's card time per step."""
    from k_diffusion_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(SEED + 4)
    model = KT.config.make_model(config, dtype=dtype, device=dev,
                                 generator=torch.Generator(dev).manual_seed(
                                     SEED + 4))
    state = KT.training.init_train_state(
        model, KT.training.make_optimizer(config, model))
    ema_sched = KT.config.make_ema_sched(config)
    step = KT.training.make_train_step(
        KT.config.make_denoiser_wrapper(config),
        KT.config.make_sample_density(config["model"]))
    data = {"reals": torch.randn((1, *input_shape(config, batch)),
                                 generator=g).clamp(-1, 1).to(dev)}
    if config["model"].get("augment_wrapper"):
        data["aug_cond"] = torch.randn((1, batch, 9), generator=g).to(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    params0 = [p.detach().clone() for p in model.parameters()]
    ema0 = [p.detach().clone() for p in state.ema_model.parameters()]

    def run(n):
        losses = []
        for _ in range(n):
            metrics = step(state, data, gen, ema_sched.get_value())
            ema_sched.step()
            losses.append(metrics["loss"])
        return torch.stack(losses)

    warm = run(WARMUP_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    losses = run(TRAIN_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat([warm, losses]).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{name}: losses not finite: {losses}")
    moved = lambda now, before: max((a - b).abs().max().item()
                                    for a, b in zip(now, before))
    p_moved = moved(model.parameters(), params0)
    ema_moved = moved(state.ema_model.parameters(), ema0)
    if not (p_moved > 0 and ema_moved > 0):
        raise AssertionError(f"{name}: params moved {p_moved}, EMA moved "
                             f"{ema_moved}")
    expected = dict.fromkeys(kernels.COUNTERS, 0) | {
        k: TRAIN_STEPS * v for k, v in per_step.items()}
    if counts != expected:
        raise AssertionError(f"{name}: launch counts {counts} != expected "
                             f"{expected}")
    ips = batch * TRAIN_STEPS / secs
    tflops = 3 * fwd_flops * ips / 1e12
    print(f"{name}: {dtype}, batch {batch}, dropout "
          f"{config['model']['dropout_rate']}, "
          f"{WARMUP_STEPS} warm-up + {TRAIN_STEPS} timed steps: "
          f"{secs:.3f} s, {ips:.3f} imgs/s, model {tflops:.2f} TFLOP/s "
          f"(3 x forward), peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated), on {smi}; losses first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; params moved "
          f"{p_moved:.3e}, EMA {ema_moved:.3e}; launches per step "
          f"{per_step}", flush=True)
    busy = profile(run, name, "training steps")
    if report is not None:
        report.update(secs=secs, rate=ips, peak=peak, busy_ms=busy,
                      losses=losses)
    return counts, ips


def profile(run, name, what, ops=()):
    """``run(3)`` (3 training steps or denoiser calls) under torch.profiler:
    prints the host time and the device time by kernel (the rows with the
    most device time), and the device time of each PyTorch op named in
    ``ops`` (the kernels it launched)."""
    from torch.profiler import ProfilerActivity
    # the host's operator events only where ``ops`` asks for them: reading
    # them back takes seconds a profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ops
                                            else [])
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        run(3)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
    events = prof.key_averages()
    # the device's own events (kernels, copies); an operator's row repeats
    # the time of the kernels it launched
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation) / 3e3
    print(f"{name} profile: 3 {what} in {secs:.3f} s under the profiler, "
          f"device busy {device_ms:.3f} ms each; by device time:")
    busy = device_ms
    print(events.table(sort_by="self_cuda_time_total", row_limit=25,
                       max_name_column_width=70), flush=True)
    # the attention kernels (the forward of K3, K13 and of K2, K11; the
    # backward's two of K9, K14 and of K7), the forwards K1 and K4, and K6's
    # and K10's, which
    # the table may leave out: device time per launch and per step or call
    kinds = {k for names in REPORTED.values() for k in names}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
                k in e.key for k in kinds):
            print(f"{name} profile: {e.key[:60]}: {e.count // 3} launches a "
                  f"step or call, {e.self_device_time_total / e.count:.1f} us "
                  f"each, {e.self_device_time_total / 3e3:.3f} ms a step or "
                  f"call", flush=True)
    # the float32 attention backward (csrc/attn_tf32_bwd.cuh): its share of
    # a float32 step's card time
    wg_ms = sum(e.self_device_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "tf32_wg_d" in e.key) / 3e3
    if wg_ms:
        print(f"{name} profile: the float32 attention backward "
              f"(tf32_wg_dq_kernel, tf32_wg_dkv_kernel) {wg_ms:.3f} ms of the "
              f"{device_ms:.3f} ms a step ({wg_ms / device_ms:.1%})",
              flush=True)
    for e in events:
        if e.key in ops:
            print(f"{name} profile: {e.key}: {e.count // 3} calls a step or "
                  f"call, {e.device_time_total / 3e3:.3f} ms of device time "
                  f"a step or call", flush=True)
    return busy


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(*sys.argv[2:])
    else:
        main()
