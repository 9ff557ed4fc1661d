#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (k_diffusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (the kernel phase one per kernel and shape):
1. device: needs a CUDA device; prints nvidia-smi's name and power limit;
2. build: compiles every kernel from csrc/ with nvcc;
3. kernels: each kernel against its plain PyTorch version at the flagship
   shapes (batch 8, bfloat16), with the bound stated, and both times from
   CUDA events;
4. forward: the flagship HDiT (configs/config_oxford_flowers.json, seeded
   weights, zero-init tensors filled with noise) at batch 2 in bfloat16 on
   the card against the same weights in float32 on the CPU (plain versions);
5. sampling: 50-step DPM++(2M) at batch 8 on the card; the output must be
   finite and every kernel's launch count must match the model's layout;
6. backward kernels: K6-K10 against their plain versions (autograd through
   the forward's plain version; a plain overlap-add for K8) at the flagship
   training shapes, batch 8, each output within the kernel bound, both
   times from CUDA events;
7. gradient parity: one training step's loss and full parameter gradient,
   the flagship at batch 2 in bfloat16 on the card against the same
   weights, reals, noise and sigmas in float32 on the CPU, dropout off;
8. training: the flagship config as it is (dropout on) at batch 32 on
   synthetic seeded reals, a few warm-up steps then 20 timed steps through
   training.make_train_step; losses finite, params and EMA moved, and
   every kernel's launch count per step equal to the model's layout.

   Then 3 more steps under torch.profiler: the device time by kernel.

Then one JSON line of per-kernel results, and last
``{"ok": true, "device": {...}}``. Any failure raises: exit code non-zero,
no result line. Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config_oxford_flowers.json"
SEED = 0
SAMPLE_BATCH, STEPS = 8, 50
TRAIN_BATCH, WARMUP_STEPS, TRAIN_STEPS = 32, 3, 20
# a kernel may differ from its plain version by a few bf16 roundings of its
# output: the plain version rounds intermediates (the raw projection, the
# GEGLU halves, the residual stream) to bf16 where the kernel keeps f32
KERNEL_REL_BOUND = 3e-2
# the bf16 model on the card against the f32 model on the CPU, relative L2
# error of the denoiser output: ~100 bf16 roundings in sequence
FORWARD_REL_BOUND = 5e-2
# the same for the full parameter gradient of one training step, relative
# L2 of the flattened gradient: the forward's bound
GRAD_REL_BOUND = 5e-2


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


def lecun(shape, g, dev):
    return (torch.randn(shape, generator=g) / shape[0] ** 0.5).to(
        dev, torch.bfloat16)


def kernel_cases(dev):
    """(kernel name, shape label, calls per forward, kernel fn, plain fn)
    at the flagship eval shapes, batch 8. Inputs are seeded."""
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
        heads = d // 64
        x = normal(b, h, h, d)
        ns = (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, bf16)
        w_qkv = lecun((d, 3 * d), g, dev)
        a_scale = torch.full((heads,), 10.0, device=dev)
        pos = rope.make_axial_pos(h, h, device=dev)
        label = f"{b}x{h}x{h}x{d}"
        args = (x, pos, ns, w_qkv, a_scale, heads)
        cases.append(("fused_qkv", label, n,
                      lambda a=args: fused_qkv.fused_qkv_prologue(*a),
                      lambda a=args: fused_qkv.reference(*a)))
        qkv = (unit_heads(b, h, h, d), unit_heads(b, h, h, d),
               normal(b, h, h, d))
        if attn == "na":
            cases.append(("na2d", label, n,
                          lambda t=qkv, nh=heads: na2d.na2d_packed(*t, nh, 7),
                          lambda t=qkv, nh=heads: _na_plain(na2d, *t, nh)))
        else:
            flat = tuple(t.reshape(b, h * h, d) for t in qkv)
            cases.append(("global_packed", f"{b}x{h * h}x{d}", n,
                          lambda t=flat, nh=heads:
                          global_packed.packed_global_attention(*t, nh),
                          lambda t=flat, nh=heads:
                          global_packed.reference(*t, nh)))
        xt = x.reshape(b, h * h, d)
        ffn_args = (xt, ns, lecun((d, 2 * d_ff), g, dev),
                    lecun((d_ff, d), g, dev))
        cases.append(("fused_ffn", f"{b}x{h * h}x{d} f={d_ff}", n,
                      lambda a=ffn_args: fused_ffn.fused_geglu_ffn(*a),
                      lambda a=ffn_args: fused_ffn.reference(*a)))
    mw = 256
    blocks = [((1 + 0.1 * torch.randn(mw, generator=g)).to(dev),
               lecun((mw, 2 * 3 * mw), g, dev), lecun((3 * mw, mw), g, dev))
              for _ in range(2)]
    map_args = (normal(b, mw), torch.ones(mw, device=dev),
                torch.ones(mw, device=dev), blocks)
    cases.append(("fused_mapping", f"{b}x{mw} f={3 * mw}", 1,
                  lambda a=map_args: fused_mapping.fused_mapping(*a),
                  lambda a=map_args: fused_mapping.reference(*a)))
    return cases


def backward_cases(dev):
    """(kernel name, shape label, calls per training step, kernel fn, plain
    fn[, timed fn]) for the backward kernels at the flagship training shapes, batch 8:
    K6 at every level, K7, K8 and K10 at the two NA levels (the mid
    level's feed-forward blocks have dropout and run unfused), K9 at the
    global level. Each fn returns a tuple of gradients; K7's dk and dv are
    its halo partials summed by the plain overlap-add, so that each of
    K7's outputs is held against the plain backward. Inputs are seeded;
    the weights are float32, as the model's parameters."""
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

    cases = []
    for h, d, d_ff, attn, n in ((64, 128, 384, "na", 4),
                                (32, 256, 768, "na", 4),
                                (16, 512, 1536, "global", 4)):
        heads = d // 64
        label = f"{b}x{h}x{h}x{d}"
        args = (normal(b, h, h, d), rope.make_axial_pos(h, h, device=dev),
                (1 + 0.1 * torch.randn((b, d), generator=g)).to(dev, bf16),
                normal(d, 3 * d, std=d ** -0.5, dtype=torch.float32),
                10 * (1 + 0.1 * torch.randn(heads, generator=g)).to(dev),
                heads, *(normal(b, h, h, d) for _ in range(3)))
        cases.append(("fused_qkv_bwd", label, n,
                      lambda a=args: fused_qkv.prologue_backward(*a),
                      lambda a=args: fused_qkv.reference_backward(*a)))
        q, k, v, dout = (unit_heads(b, h, h, d), unit_heads(b, h, h, d),
                         normal(b, h, h, d), normal(b, h, h, d))
        if attn == "na":
            out, lse = na2d.packed_forward(q, k, v, heads, 7, save_lse=True)
            fwd = (q, k, v, out, lse, dout, heads, 7)
            parts = na2d.packed_backward_partials(*fwd)

            def k7(a=fwd, h=h):
                dq, dk_part, dv_part = na2d.packed_backward_partials(*a)
                return (dq, *na2d.overlap_add_reference(dk_part, dv_part, h,
                                                        h, 7))

            # timed alone; its plain time is the whole plain backward
            cases.append(("na2d_bwd", label, n, k7,
                          lambda a=(q, k, v, dout, heads, 7):
                          na2d.reference_backward(*a),
                          lambda a=fwd: na2d.packed_backward_partials(*a)))
            cases.append(("na2d_overlap_add", label, n,
                          lambda p=parts[1:], h=h: na2d.overlap_add(*p, h, h, 7),
                          lambda p=parts[1:], h=h:
                          na2d.overlap_add_reference(*p, h, h, 7)))
            xt = normal(b, h * h, d)
            ffn_args = (xt, (1 + 0.1 * torch.randn((b, d), generator=g)).to(
                dev, bf16), normal(d, 2 * d_ff, std=d ** -0.5,
                                   dtype=torch.float32),
                normal(d_ff, d, std=d_ff ** -0.5, dtype=torch.float32),
                normal(b, h * h, d))
            cases.append(("fused_ffn_bwd", f"{b}x{h * h}x{d} f={d_ff}", n,
                          lambda a=ffn_args: fused_ffn.ffn_backward(*a),
                          lambda a=ffn_args: fused_ffn.reference_backward(*a)))
        else:
            q, k, v, dout = (t.reshape(b, h * h, d) for t in (q, k, v, dout))
            out, lse = global_packed.packed_forward(q, k, v, heads,
                                                    save_lse=True)
            cases.append(("global_packed_bwd", f"{b}x{h * h}x{d}", n,
                          lambda a=(q, k, v, out, lse, dout, heads):
                          global_packed.packed_backward(*a),
                          lambda a=(q, k, v, dout, heads):
                          global_packed.reference_backward(*a)))
    return cases


def run_cases(cases, results, kernel_reps, plain_reps):
    """Holds each case's kernel against its plain version, times both (the
    kernel through its timed fn where a case has one) and adds calls x ms
    into ``results[name]``."""
    for name, label, calls, fn, plain, *timed in cases:
        got, want = fn(), plain()
        torch.cuda.synchronize()
        outs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        checks = [check_close(f"{name} {label}", a, b_, KERNEL_REL_BOUND)
                  for a, b_ in outs]
        err = max(e for e, _ in checks)
        # the worst output's error as a share of its max |plain|
        share = max(e / limit * KERNEL_REL_BOUND if limit else 0.0
                    for e, limit in checks)
        del got, want
        ms = device_ms(timed[0] if timed else fn, kernel_reps)
        plain_ms = device_ms(plain, plain_reps)
        print(f"kernel {name} [{label}]: max abs err {err:.3e}, worst "
              f"output {share:.2e} x its max|plain| (bound "
              f"{KERNEL_REL_BOUND}), {ms:.4f} ms, plain {plain_ms:.4f} ms",
              flush=True)
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                      "plain_ms": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += calls * ms
        r["plain_ms"] += calls * plain_ms
    torch.cuda.empty_cache()


def _na_plain(na2d, q, k, v, heads):
    b, h, w, c = q.shape
    split = (b, h, w, heads, c // heads)
    return na2d.na2d_reference(q.reshape(split), k.reshape(split),
                               v.reshape(split), 7).reshape(b, h, w, c)


def fill_zero_init(model, g):
    """Seeded noise into the zero-initialised projections (out_proj,
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

    results = {}
    with torch.no_grad():
        run_cases(kernel_cases(dev), results, 50, 5)

        config = KT.config.load_config(CONFIG)
        g = torch.Generator().manual_seed(SEED)
        model = KT.config.make_model(config, dtype=torch.bfloat16,
                                     generator=g)
        fill_zero_init(model, g)
        reference = KT.config.make_model(config).eval()
        reference.load_state_dict(model.state_dict())
        model.to(dev).eval()  # the level dropout is for training only
        denoiser = KT.config.make_denoiser_wrapper(config)(model)
        ref_denoiser = KT.config.make_denoiser_wrapper(config)(reference)
        size = config["model"]["input_size"]
        x = torch.randn((2, *size, 3), generator=g)
        sigma = torch.tensor([0.5, 8.0])
        out = denoiser(x.to(dev), sigma.to(dev)).cpu()
        want = ref_denoiser(x, sigma)
        rel = ((out - want).norm() / want.norm()).item()
        if not rel <= FORWARD_REL_BOUND or not torch.isfinite(out).all():
            raise AssertionError(f"forward: relative L2 error {rel:.3e} > "
                                 f"{FORWARD_REL_BOUND}")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"forward: {n_params} params, batch 2 bf16 on the card vs f32 "
              f"on the CPU: relative L2 error {rel:.3e} (bound "
              f"{FORWARD_REL_BOUND})", flush=True)

        sigmas = KT.sampling.get_sigmas_karras(
            STEPS, config["model"]["sigma_min"], config["model"]["sigma_max"],
            rho=7.0, device=dev)
        x = (torch.randn((SAMPLE_BATCH, *size, 3), generator=g)
             * config["model"]["sigma_max"]).to(dev)
        denoiser(x, sigmas[:1].expand(SAMPLE_BATCH))  # warm up at batch 8
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start = time.perf_counter()
        samples = KT.sampling.sample_dpmpp_2m(denoiser, x, sigmas)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        counts = kernels.launch_counts()
    if samples.shape != x.shape or not torch.isfinite(samples).all():
        raise AssertionError("sampling: output not finite or wrong shape")
    levels = config["model"]["depths"]
    attn_layers = 2 * sum(levels[:-1]) + levels[-1]
    na_layers = 2 * sum(levels[:-1])
    # no backward kernel runs while sampling
    expected = dict.fromkeys(kernels.COUNTERS, 0) | {
        "fused_qkv": STEPS * attn_layers, "na2d": STEPS * na_layers,
        "global_packed": STEPS * levels[-1],
        "fused_ffn": STEPS * attn_layers, "fused_mapping": STEPS}
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    tflops = (2 * flops.analytic_transformer_flops(config, SAMPLE_BATCH)
              * STEPS / secs / 1e12)
    print(f"sampling: {STEPS}-step DPM++(2M), batch {SAMPLE_BATCH}: "
          f"{secs:.3f} s, {SAMPLE_BATCH / secs:.3f} samples/s, model "
          f"{tflops:.2f} TFLOP/s on {smi}; launches {counts}", flush=True)

    sample_counts = counts
    del model, reference, denoiser, ref_denoiser, samples, x
    torch.cuda.empty_cache()

    with torch.no_grad():
        run_cases(backward_cases(dev), results, 20, 3)

    grad_parity(KT, config, dev)
    train_counts = train(KT, config, dev, smi)

    sources = {
        "fused_qkv": ("fused_qkv.cu", "fused_qkv.py:82"),
        "na2d": ("na2d.cu", "na2d.py:576"),
        "global_packed": ("global_packed.cu", "global_packed.py:57"),
        "fused_ffn": ("geglu.cu", "fused_ffn.py:42"),
        "fused_mapping": ("geglu.cu", "fused_mapping.py:28"),
        "fused_qkv_bwd": ("fused_qkv.cu", "fused_qkv.py:246"),
        "na2d_bwd": ("na2d.cu", "na2d.py:701"),
        "na2d_overlap_add": ("na2d.cu", "na2d.py:809"),
        "global_packed_bwd": ("global_packed.cu", "global_packed.py:111"),
        "fused_ffn_bwd": ("geglu.cu", "fused_ffn.py:115"),
    }
    report = []
    for name, (src, tpu) in sources.items():
        r = results[name]
        # launches: the forward kernels' from the sampling run, the
        # backward kernels' from the timed training steps
        report.append({
            "name": name, "route": "cuda",
            "source": f"k_diffusion_tpu_torch/csrc/{src}",
            "replaces": f"k_diffusion_tpu/ops/pallas/{tpu}",
            "launches": (train_counts if name.endswith(("_bwd", "_add"))
                         else sample_counts)[name],
            "train_launches": train_counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def no_dropout(config):
    model = dict(config["model"], dropout_rate=[0.0] * len(
        config["model"]["dropout_rate"]), mapping_dropout_rate=0.0)
    return dict(config, model=model)


def grad_parity(KT, config, dev):
    """Phase 7: one step's loss and full parameter gradient, bf16 on the
    card against f32 on the CPU, from the same weights, reals, noise and
    sigmas. Dropout is off: the two devices' generators draw different
    masks."""
    config = no_dropout(config)
    g = torch.Generator().manual_seed(SEED + 3)
    model = KT.config.make_model(config, dtype=torch.bfloat16, generator=g)
    fill_zero_init(model, g)
    reference = KT.config.make_model(config)
    reference.load_state_dict(model.state_dict())
    model.to(dev).train()
    reference.train()
    size = config["model"]["input_size"]
    reals = torch.randn((2, *size, 3), generator=g)
    noise = torch.randn((2, *size, 3), generator=g)
    sigma = KT.config.make_sample_density(config["model"])(
        (2,), stratified=(0, 1), generator=g)
    grads = []
    for m, d in ((model, dev), (reference, torch.device("cpu"))):
        den = KT.config.make_denoiser_wrapper(config)(m)
        loss = den.loss(reals.to(d), noise.to(d), sigma.to(d)).mean()
        flat = torch.cat([p.flatten() for p in torch.autograd.grad(
            loss, list(m.parameters()))])
        grads.append((loss.item(), flat.float().cpu()))
    (loss, got), (ref_loss, want) = grads
    rel = ((got - want).norm() / want.norm()).item()
    if not (rel <= GRAD_REL_BOUND and torch.isfinite(got).all()):
        raise AssertionError(f"gradient parity: relative L2 error {rel:.3e} "
                             f"> {GRAD_REL_BOUND}")
    print(f"gradient parity: batch 2, dropout 0 (the card's and the CPU's "
          f"mask generators differ), sigmas {sigma.tolist()}: loss "
          f"{loss:.6f} bf16 on the card vs {ref_loss:.6f} f32 on the CPU; "
          f"gradient of {want.numel()} params: relative L2 error {rel:.3e} "
          f"(bound {GRAD_REL_BOUND})", flush=True)
    del model, reference
    torch.cuda.empty_cache()


def train(KT, config, dev, smi):
    """Phase 8: the flagship as configured (dropout on) at batch 32 on
    seeded synthetic reals through training.make_train_step. Returns the
    launch counts of the timed steps."""
    from k_diffusion_tpu_torch.models import flops
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
    size = config["model"]["input_size"]
    reals = torch.randn((1, TRAIN_BATCH, *size, 3), generator=g).clamp(
        -1, 1).to(dev)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    params0 = [p.detach().clone() for p in model.parameters()]
    ema0 = [p.detach().clone() for p in state.ema_model.parameters()]

    def run(n):
        losses = []
        for _ in range(n):
            metrics = step(state, {"reals": reals}, gen, ema_sched.get_value())
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
        raise AssertionError(f"training: losses not finite: {losses}")
    moved = lambda now, before: max((a - b).abs().max().item()
                                    for a, b in zip(now, before))
    p_moved = moved(model.parameters(), params0)
    ema_moved = moved(state.ema_model.parameters(), ema0)
    if not (p_moved > 0 and ema_moved > 0):
        raise AssertionError(f"training: params moved {p_moved}, EMA moved "
                             f"{ema_moved}")
    levels = config["model"]["depths"]
    drops = config["model"]["dropout_rate"]
    attn = 2 * sum(levels[:-1]) + levels[-1]
    na = 2 * sum(levels[:-1])
    # the fused feed-forward block runs where the level's dropout is 0
    ffn = sum((2 if i < len(levels) - 1 else 1) * depth
              for i, (depth, p) in enumerate(zip(levels, drops)) if p == 0)
    mapping = int(config["model"]["mapping_dropout_rate"] == 0)
    per_step = {"fused_qkv": attn, "na2d": na, "global_packed": levels[-1],
                "fused_ffn": ffn, "fused_mapping": mapping,
                "fused_qkv_bwd": attn, "na2d_bwd": na, "na2d_overlap_add": na,
                "global_packed_bwd": levels[-1], "fused_ffn_bwd": ffn}
    expected = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if counts != expected:
        raise AssertionError(f"training launch counts {counts} != expected "
                             f"{expected}")
    ips = TRAIN_BATCH * TRAIN_STEPS / secs
    tflops = 3 * 2 * flops.analytic_transformer_flops(config, 1) * ips / 1e12
    print(f"training: batch {TRAIN_BATCH}, dropout {drops}, "
          f"{WARMUP_STEPS} warm-up + {TRAIN_STEPS} timed steps: "
          f"{secs:.3f} s, {ips:.3f} imgs/s, model {tflops:.2f} TFLOP/s "
          f"(3 x forward), peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated), on {smi}; losses first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; params moved "
          f"{p_moved:.3e}, EMA {ema_moved:.3e}; launches per step "
          f"{per_step}", flush=True)
    profile(run)
    return counts


def profile(run):
    """3 training steps under torch.profiler: prints the host time and the
    device time by kernel (the rows with the most device time)."""
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
    print(f"profile: 3 training steps in {secs:.3f} s under the profiler, "
          f"device busy {device_ms:.3f} ms per step; by device time:")
    print(events.table(sort_by="self_cuda_time_total", row_limit=25,
                       max_name_column_width=70), flush=True)


if __name__ == "__main__":
    main()
