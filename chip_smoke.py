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
   64); none may spill or be missing;
3. kernels: each forward kernel K1-K5 against its plain PyTorch version at
   the flagship shapes (batch 8, bfloat16), with the bound stated, and the
   kernel's, the plain version's and, where one PyTorch call computes the
   same function, that call's times from CUDA events (K5 with the model's
   float32 weights; uncounted, with bfloat16 weights and at batch 32);
   a profile showing that one K5 call runs one device kernel and nothing
   else; then K3's training forward, out and logsumexp, against the plain
   versions;
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
   finite forward at batch 2; an explicit float32 there raises ValueError;
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
   bfloat16, then ``python -m k_diffusion_tpu_torch.sample --sampler lms
   -n 8`` on it as a subprocess on the card, which must write 8 PNGs; then
   the cifar10 U-Net the same way under dpmpp_2m.

Each kernel line also gives the kernel's achieved TFLOP/s (the operations
its function needs over its time) and its time's share of the bound.

Then one JSON line of per-kernel results and last ``{"ok": true, "device":
{...}}``. A kernel's ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms``
are summed over its calls in one denoiser call (forward kernels) or one
training step (backward kernels) on its main path: the flagship at batch 8
for K1-K10 and, in the unfused step, K11 and K12; the U-Net at batch 64 for
K13 and K14; one op call at each flagship NA level for K15 and K8.
``launches`` is its count in that path's sampling (forward) or timed
training (backward) run, for K11 and K12 the unfused training run, for K15
and K8 their op paths. Any
failure raises: exit code non-zero, no result line. Imports nothing of JAX.
"""

import collections
import contextlib
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

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
# each returning a tensor or a tuple of tensors; ``flops`` the bf16
# operations the function needs at this shape and ``inputs`` the tensors it
# reads, for the bound; ``timed`` what is timed and counted as the kernel
# where that is not ``fn``; ``library`` one PyTorch call that computes the
# same function, timed as a yardstick and used nowhere in the port
Case = collections.namedtuple(
    "Case", "name label calls fn plain flops inputs timed library",
    defaults=(None, None))


def device_ms(fn, reps):
    """Median over 5 trials of the mean device time of ``fn`` in ms, from
    CUDA events. Each trial first queues a sleep on the card so that the
    host enqueues all ``reps`` calls before the card reaches them: the
    events then time the card, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    trials = []
    for _ in range(5):
        torch.cuda._sleep(50_000_000)
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


def bound_ms(flops, inputs, outputs):
    """(ms from the operations at the bf16 peak, ms from the bytes at the
    memory rate): each input read once, each output written once."""
    moved = sum(t.numel() * t.element_size()
                for t in tensors(inputs, outputs))
    return flops / PEAK_BF16_FLOPS * 1e3, moved / PEAK_BYTES_PER_S * 1e3


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


def mapping_one_launch(dev):
    """One fused_mapping call with the model's float32 params runs one
    device kernel, K5's, and nothing else (no stack, no cast), counted by
    torch.profiler."""
    from torch.profiler import ProfilerActivity
    from k_diffusion_tpu_torch.ops.kernels import fused_mapping

    g = torch.Generator().manual_seed(SEED + 20)
    mw = 256
    blocks = [((1 + 0.1 * torch.randn(mw, generator=g)).to(dev),
               (torch.randn((mw, 6 * mw), generator=g) / mw ** 0.5).to(dev),
               (torch.randn((3 * mw, mw), generator=g)
                / (3 * mw) ** 0.5).to(dev)) for _ in range(2)]
    emb = torch.randn((SAMPLE_BATCH, mw), generator=g).to(dev, torch.bfloat16)
    ones = torch.ones(mw, device=dev)
    fused_mapping.fused_mapping(emb, ones, ones, blocks)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_mapping.fused_mapping(emb, ones, ones, blocks)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(names) != 1 or "mapping_kernel" not in names[0]:
        raise AssertionError(f"fused_mapping: one call ran {names}")
    print(f"fused_mapping: one call with float32 weights runs one device "
          f"kernel ({names[0][:60]})", flush=True)


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


def overlap_path(overlap):
    """K8's op path: ``na2d.overlap_add`` once on each NA level's plain
    partials (``backward_cases``), with the launch counts read around it:
    since K7 writes dk and dv itself, no model path runs K8. Each result is
    held against the plain overlap-add again. Returns the counts."""
    from k_diffusion_tpu_torch.ops import kernels
    from k_diffusion_tpu_torch.ops.kernels import na2d

    kernels.reset_launch_counts()
    got = [na2d.overlap_add(*args) for args in overlap]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    expected = dict.fromkeys(kernels.COUNTERS, 0) | {
        "na2d_overlap_add": len(overlap)}
    if counts != expected:
        raise AssertionError(f"overlap-add path: launch counts {counts} != "
                             f"expected {expected}")
    for sums, args in zip(got, overlap):
        for name, a, b_ in zip(("dk", "dv"), sums,
                               na2d.overlap_add_reference(*args)):
            check_close(f"overlap-add path {name}", a, b_, KERNEL_REL_BOUND)
    print(f"overlap-add path: launches {counts}; dk, dv within "
          f"{KERNEL_REL_BOUND} x max|plain|", flush=True)
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
        checks = [check_close(f"{c.name} {c.label}", a, b_, KERNEL_REL_BOUND)
                  for a, b_ in outs]
        err = max(e for e, _ in checks)
        # the worst output's error as a share of its max |plain|
        share = max(e / limit * KERNEL_REL_BOUND if limit else 0.0
                    for e, limit in checks)
        timed = c.timed or c.fn
        op_ms, byte_ms = bound_ms(c.flops, c.inputs,
                                  timed() if c.timed else got)
        del got, want
        ms = device_ms(timed, kernel_reps)
        plain_ms = device_ms(c.plain, plain_reps)
        lib_ms = device_ms(c.library, kernel_reps) if c.library else None
        lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        bound = max(op_ms, byte_ms)
        print(f"kernel {c.name} [{c.label}]: max abs err {err:.3e}, worst "
              f"output {share:.2e} x its max|plain| (bound "
              f"{KERNEL_REL_BOUND}), {ms:.4f} ms, plain {plain_ms:.4f} ms"
              f"{lib}; bound {bound:.4f} ms (operations {op_ms:.4f}, bytes "
              f"{byte_ms:.4f}); {c.flops / ms / 1e9:.2f} TFLOP/s, "
              f"{bound / ms:.1%} of the bound", flush=True)
        r = results.setdefault(c.name, {
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "op_ms": 0.0, "byte_ms": 0.0, "library_ms": None})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += c.calls * ms
        r["plain_ms"] += c.calls * plain_ms
        r["bound_ms"] += c.calls * max(op_ms, byte_ms)
        r["op_ms"] += c.calls * op_ms
        r["byte_ms"] += c.calls * byte_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + c.calls * lib_ms
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


def forward_parity(KT, config, dev, fill, g, name, batch=2, **cond):
    """One bf16 denoiser call on the card against the same weights in f32 on
    the CPU (plain versions), relative L2 of the output. Returns the card
    model (eval mode) and the launch counts of its call."""
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
    if not rel <= FORWARD_REL_BOUND or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: relative L2 error {rel:.3e} > "
                             f"{FORWARD_REL_BOUND}")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{name}: {n_params} params, batch {batch} bf16 on the card vs f32 "
          f"on the CPU: relative L2 error {rel:.3e} (bound "
          f"{FORWARD_REL_BOUND})", flush=True)
    return model, counts


def sample(KT, config, model, dev, g, batch, per_call, fwd_flops, smi, name):
    """50-step DPM++(2M) at ``batch`` from sigma_max; the output finite and
    the launch counts ``per_call`` x STEPS. ``fwd_flops``: the model's
    FLOPs per image per forward. Returns the launch counts."""
    from k_diffusion_tpu_torch.ops import kernels

    m = config["model"]
    denoiser = KT.config.make_denoiser_wrapper(config)(model)
    sigmas = KT.sampling.get_sigmas_karras(STEPS, m["sigma_min"],
                                           m["sigma_max"], rho=7.0, device=dev)
    x = (torch.randn(input_shape(config, batch), generator=g)
         * m["sigma_max"]).to(dev)
    with torch.no_grad():
        denoiser(x, sigmas[:1].expand(batch))  # warm up at this batch
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        samples = KT.sampling.sample_dpmpp_2m(denoiser, x, sigmas)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = kernels.launch_counts()
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
          f"{batch / secs:.3f} samples/s, model {tflops:.2f} TFLOP/s on "
          f"{smi}; launches {counts}", flush=True)

    def calls(n):
        with torch.no_grad():
            for _ in range(n):
                denoiser(x, sigmas[:1].expand(batch))

    profile(calls, name, "denoiser calls")
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
        forward_lse_check(dev)

    # the flagship HDiT: phases 4-8
    config = KT.config.load_config(CONFIG)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        model, _ = forward_parity(KT, config, dev, fill_zero_init, g,
                                  "forward")
    levels = config["model"]["depths"]
    attn_layers = 2 * sum(levels[:-1]) + levels[-1]
    per_call = {"fused_qkv": attn_layers, "na2d": 2 * sum(levels[:-1]),
                "global_packed": levels[-1], "fused_ffn": attn_layers,
                "fused_mapping": 1}
    sample_counts = sample(
        KT, config, model, dev, g, SAMPLE_BATCH, per_call,
        2 * flops.analytic_transformer_flops(config, 1), smi, "sampling")
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

    grad_parity(KT, config, dev, fill_zero_init, "gradient parity")
    hdit_flops = 2 * flops.analytic_transformer_flops(config, 1)
    train_counts, fused_ips = train(KT, config, dev, smi, TRAIN_BATCH,
                                    hdit_train_layout(config), hdit_flops,
                                    "training")

    # the U-Net (config_cifar10.json): phases 9-12
    unet = KT.config.load_config(UNET_CONFIG)
    with torch.no_grad():
        run_cases(flash_cases(dev, unet), results, 20, 5)
        forward_lse_check(dev, unet)
    g = torch.Generator().manual_seed(SEED + 7)
    unet_flops = unet_forward_flops(KT, unet)
    with torch.no_grad():
        model, counts = forward_parity(KT, unet, dev, fill_zero_init_unet, g,
                                       "unet forward")
    n_attn = sum(2 * d for d, a in zip(unet["model"]["depths"],
                                       unet["model"]["self_attn_depths"]) if a)
    if counts != dict.fromkeys(kernels.COUNTERS, 0) | {"flash": n_attn}:
        raise AssertionError(f"unet forward: launch counts {counts}")
    unet_sample_counts = sample(KT, unet, model, dev, g, UNET_BATCH,
                                {"flash": n_attn}, unet_flops, smi,
                                "unet sampling")
    del model
    torch.cuda.empty_cache()
    aug = torch.randn((2, 9), generator=torch.Generator().manual_seed(SEED + 8))
    grad_parity(KT, unet, dev, fill_zero_init_unet, "unet gradient parity",
                aug_cond=aug)
    unet_train_counts, _ = train(KT, unet, dev, smi, UNET_BATCH,
                                 {"flash": n_attn, "flash_bwd": n_attn},
                                 unet_flops, "unet training")

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

    # the per-head NA kernels and the fused epilogue: phases 14 and 15
    with torch.no_grad():
        run_cases(heads_cases(dev), results, 20, 3)
        inputs = proj_inputs(dev)
        run_cases(proj_cases(inputs, dev), results, 50, 5)
        proj_bit_check(inputs)
    proj_counts = proj_path(inputs, results)
    del inputs
    torch.cuda.empty_cache()

    # the unfused training step, KDT_TRAIN_FUSION=0: phase 16
    unfused = hdit_unfused_layout(config)
    with train_fusion("0"):
        counts = grad_parity(KT, config, dev, fill_zero_init,
                             "unfused gradient parity")
        if counts != dict.fromkeys(kernels.COUNTERS, 0) | unfused:
            raise AssertionError(f"unfused gradient parity: launch counts "
                                 f"{counts} != {unfused}")
        unfused_counts, unfused_ips = train(KT, config, dev, smi, TRAIN_BATCH,
                                            unfused, hdit_flops,
                                            "unfused training")
    print(f"unfused training: {unfused_ips:.3f} imgs/s against the fused "
          f"step's {fused_ips:.3f} (phase 8) on {smi}", flush=True)

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

    # the entry point's defaults: phase 18
    for name, cfg in (("flagship", config), ("unet", unet)):
        default_build_check(KT, cfg, name)

    # condcache and the sampler suite: phase 19; the sample entry point:
    # phase 20
    with torch.no_grad():
        strided_scale_check(KT, config, dev)
    condcache_phase(KT, config, dev, smi)
    entry_point_phase(KT, config, unet, smi)

    # name -> (source, TPU kernel, launches on its main path: the sampling
    # run for a forward kernel, the timed training steps for a backward one,
    # the unfused training steps for K11/K12, the op paths for K15 and K8)
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
    }
    report = []
    for name, (src, tpu, counts) in paths.items():
        r = results[name]
        if not counts[name]:
            raise AssertionError(f"{name}: no launch on its main path")
        entry = {
            "name": name, "route": "cuda",
            "source": f"k_diffusion_tpu_torch/csrc/{src}",
            "replaces": f"k_diffusion_tpu/ops/pallas/{tpu}",
            "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["op_ms"] > r["byte_ms"] else "bytes",
            "library_ms": r["library_ms"]}
        if "composition_ms" in r:
            entry["composition_ms"] = r["composition_ms"]
        report.append(entry)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# the kernels phase 2 reports, by library: the attention forward and
# backward (csrc/attn_fwd.cuh, attn_bwd.cuh), the neighborhood forward of
# K2 and K11 (csrc/na_fwd.cuh) and the backward's two of K7 and K12
# (csrc/na_bwd.cuh; OWN_V false in na2d, true in na2d_heads), the forwards
# K1 and K4, K6's and K10's (their first kernels and csrc/gemm.cuh's),
# K5's cluster kernel (f32 and bf16 weights) and K15's (csrc/na_proj.cuh)
REPORTED = {
    "global_packed": ("attn_fwd_kernel", "attn_dq_kernel", "attn_dkv_kernel"),
    "flash": ("attn_fwd_kernel", "attn_dq_kernel", "attn_dkv_kernel"),
    "na2d": ("na_fwd_kernel", "na_dq_kernel", "na_dkv_kernel"),
    "na2d_heads": ("na_fwd_kernel", "na_dq_kernel", "na_dkv_kernel",
                   "na_proj_kernel"),
    "fused_qkv": ("qkv_fwd_kernel", "qkv_dr_kernel", "norm_vjp_kernel",
                  "atb_kernel", "reduce_kernel", "reduce_few_kernel"),
    "geglu": ("ffn_fwd_kernel", "ffn_dup_kernel", "norm_vjp_kernel",
              "atb_kernel", "reduce_kernel", "reduce_few_kernel",
              "mapping_kernel"),
}


def compiler_report(build):
    """Registers and spills of the attention kernels (K3, K13: csrc/attn_
    fwd.cuh; K2, K11: csrc/na_fwd.cuh; K9, K14: csrc/attn_bwd.cuh; K7,
    K12: csrc/na_bwd.cuh), of the forwards K1 and K4, of K6's and K10's
    (csrc/gemm.cuh's core, each backward's first kernel), of K5's and of
    K15's (csrc/na_proj.cuh), from the compiler report kept beside each
    library; raises if one spills or is missing."""
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
    if missing or any(spill for _, spill in seen.values()):
        raise AssertionError(f"compiler report: missing {missing}, {seen}")
    print("compiler report: " + ", ".join(
        f"{fn} {regs} registers, {spill} bytes spilled"
        for fn, (regs, spill) in sorted(seen.items())), flush=True)


def default_build_check(KT, config, name):
    """Phase 18: ``make_model(config)`` with no dtype and no device builds
    on the card in bfloat16 (``utils.compute_dtype``), and its denoiser
    gives a finite output of the input's shape at batch 2 (fresh weights,
    eval mode); an explicit float32 on the card raises ValueError naming
    bfloat16 before anything is allocated."""
    try:
        KT.config.make_model(config, dtype=torch.float32)
    except ValueError as e:
        if "bfloat16" not in str(e):
            raise
    else:
        raise AssertionError(f"{name}: float32 compute on the card built")
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
          f"{tuple(out.shape)}; float32 on the card refused by name",
          flush=True)
    del model
    torch.cuda.empty_cache()


def flagship_layout(config):
    """The flagship's kernel launches per denoiser call, mapping network
    (K5) aside."""
    depths = config["model"]["depths"]
    layers = 2 * sum(depths[:-1]) + depths[-1]
    return {"fused_qkv": layers, "na2d": 2 * sum(depths[:-1]),
            "global_packed": depths[-1], "fused_ffn": layers}


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
    per_call = flagship_layout(config)
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
    as a subprocess on the card: 8 PNGs each for the flagship under LMS and
    the U-Net under DPM++(2M)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, cfg, fill, sampler in (
                ("flagship", config, fill_zero_init, "lms"),
                ("unet", unet, fill_zero_init_unet, "dpmpp_2m")):
            g = torch.Generator().manual_seed(SEED + 20)
            model = KT.config.make_model(cfg, device="cpu", generator=g)
            fill(model, g)
            ckpt = KT.checkpoint.save_inference(
                tmp / f"{name}.safetensors", model, cfg, dtype=torch.bfloat16)
            del model
            cmd = [sys.executable, "-m", "k_diffusion_tpu_torch.sample",
                   "--checkpoint", str(ckpt), "--sampler", sampler, "-n", "8",
                   "--batch-size", "8", "--prefix", str(tmp / name)]
            start = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=600)
            secs = time.perf_counter() - start
            if proc.returncode:
                raise AssertionError(f"sample entry point ({name}) failed:\n"
                                     f"{proc.stdout[-2000:]}"
                                     f"{proc.stderr[-4000:]}")
            files = sorted(tmp.glob(f"{name}_*.png"))
            if [f.name for f in files] != [f"{name}_{i:05}.png"
                                           for i in range(8)]:
                raise AssertionError(f"sample entry point ({name}) wrote "
                                     f"{[f.name for f in files]}")
            for f in files:
                check_png(f, cfg["model"]["input_size"][0])
            print(f"sample entry point ({name}, {sampler}): 8 PNGs from a "
                  f"bfloat16 checkpoint of {ckpt.stat().st_size} bytes in "
                  f"{secs:.1f} s (process start and model build included) on "
                  f"{smi}; its output: "
                  f"{' | '.join(proc.stdout.strip().splitlines())}",
                  flush=True)


def unet_forward_flops(KT, config):
    """The U-Net's FLOPs per image per forward: torch.utils.flop_counter
    over the plain forward on the CPU at batch 1 (convolutions, matmuls and
    the attention products)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = KT.config.make_model(config, device="cpu").eval()
    x = torch.zeros(input_shape(config, 1))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        KT.config.make_denoiser_wrapper(config)(model)(x, torch.ones(1))
    total = counter.get_total_flops()
    print(f"unet flops: {total} per image per forward (FlopCounterMode, "
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


def grad_parity(KT, config, dev, fill, name, **cond):
    """Phases 7, 12, 16 and 17: one step's loss and full parameter gradient,
    bf16 on the card against f32 on the CPU, from the same weights, reals,
    noise, sigmas and ``cond`` (batch 2). Dropout is off: the two devices'
    generators draw different masks. Returns the launch counts of the
    card's step."""
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


def hdit_train_layout(config):
    """The flagship's kernel launches per training step."""
    levels = config["model"]["depths"]
    drops = config["model"]["dropout_rate"]
    attn = 2 * sum(levels[:-1]) + levels[-1]
    na = 2 * sum(levels[:-1])
    # the fused feed-forward block runs where the level's dropout is 0
    ffn = sum((2 if i < len(levels) - 1 else 1) * depth
              for i, (depth, p) in enumerate(zip(levels, drops)) if p == 0)
    mapping = int(config["model"]["mapping_dropout_rate"] == 0)
    return {"fused_qkv": attn, "na2d": na, "global_packed": levels[-1],
            "fused_ffn": ffn, "fused_mapping": mapping,
            "fused_qkv_bwd": attn, "na2d_bwd": na,
            "global_packed_bwd": levels[-1], "fused_ffn_bwd": ffn}


def hdit_unfused_layout(config):
    """The flagship's kernel launches per training step with
    KDT_TRAIN_FUSION=0: the NA levels through K11/K12, the global level
    through K3/K9, the mapping network through K5; the prologue and the
    feed-forward blocks unfused (no K1/K4/K6/K10), no K2/K7/K8."""
    levels = config["model"]["depths"]
    na = 2 * sum(levels[:-1])
    return {"na2d_heads": na, "na2d_heads_bwd": na,
            "global_packed": levels[-1], "global_packed_bwd": levels[-1],
            "fused_mapping": int(config["model"]["mapping_dropout_rate"] == 0)}


def train(KT, config, dev, smi, batch, per_step, fwd_flops, name):
    """Phases 8, 12 and 16: the config as it is (dropout on) at ``batch`` on
    seeded synthetic reals (and a seeded aug_cond where the model takes
    one) through training.make_train_step; launch counts ``per_step`` per
    step. ``fwd_flops``: the model's FLOPs per image per forward. Returns
    the launch counts of the timed steps and the images per second."""
    from k_diffusion_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(SEED + 4)
    model = KT.config.make_model(config, dtype=torch.bfloat16, device=dev,
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
    print(f"{name}: batch {batch}, dropout {config['model']['dropout_rate']}, "
          f"{WARMUP_STEPS} warm-up + {TRAIN_STEPS} timed steps: "
          f"{secs:.3f} s, {ips:.3f} imgs/s, model {tflops:.2f} TFLOP/s "
          f"(3 x forward), peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated), on {smi}; losses first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; params moved "
          f"{p_moved:.3e}, EMA {ema_moved:.3e}; launches per step "
          f"{per_step}", flush=True)
    profile(run, name, "training steps")
    return counts, ips


def profile(run, name, what):
    """``run(3)`` (3 training steps or denoiser calls) under torch.profiler:
    prints the host time and the device time by kernel (the rows with the
    most device time)."""
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
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
    return busy


if __name__ == "__main__":
    main()
