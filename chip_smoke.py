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
   finite and every kernel's launch count must match the model's layout.

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
# a kernel may differ from its plain version by a few bf16 roundings of its
# output: the plain version rounds intermediates (the raw projection, the
# GEGLU halves, the residual stream) to bf16 where the kernel keeps f32
KERNEL_REL_BOUND = 3e-2
# the bf16 model on the card against the f32 model on the CPU, relative L2
# error of the denoiser output: ~100 bf16 roundings in sequence
FORWARD_REL_BOUND = 5e-2


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
        for name, label, calls, fn, plain in kernel_cases(dev):
            got, want = fn(), plain()
            torch.cuda.synchronize()
            outs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            err = max(check_close(f"{name} {label}", a, b_, KERNEL_REL_BOUND)[0]
                      for a, b_ in outs)
            ms = device_ms(fn, 50)
            plain_ms = device_ms(plain, 5)
            print(f"kernel {name} [{label}]: max abs err {err:.3e} (bound "
                  f"{KERNEL_REL_BOUND} x max|plain|), {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms", flush=True)
            r = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                          "plain_ms": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"] += calls * ms
            r["plain_ms"] += calls * plain_ms
        torch.cuda.empty_cache()

        config = KT.config.load_config(CONFIG)
        g = torch.Generator().manual_seed(SEED)
        model = KT.config.make_model(config, dtype=torch.bfloat16,
                                     generator=g)
        fill_zero_init(model, g)
        reference = KT.config.make_model(config)
        reference.load_state_dict(model.state_dict())
        model.to(dev)
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
    expected = {"fused_qkv": STEPS * attn_layers, "na2d": STEPS * na_layers,
                "global_packed": STEPS * levels[-1],
                "fused_ffn": STEPS * attn_layers, "fused_mapping": STEPS}
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    tflops = (2 * flops.analytic_transformer_flops(config, SAMPLE_BATCH)
              * STEPS / secs / 1e12)
    print(f"sampling: {STEPS}-step DPM++(2M), batch {SAMPLE_BATCH}: "
          f"{secs:.3f} s, {SAMPLE_BATCH / secs:.3f} samples/s, model "
          f"{tflops:.2f} TFLOP/s on {smi}; launches {counts}", flush=True)

    sources = {"fused_qkv": ("fused_qkv.cu", "fused_qkv.py:82"),
               "na2d": ("na2d.cu", "na2d.py:576"),
               "global_packed": ("global_packed.cu", "global_packed.py:57"),
               "fused_ffn": ("geglu.cu", "fused_ffn.py:42"),
               "fused_mapping": ("geglu.cu", "fused_mapping.py:28")}
    report = []
    for name, (src, tpu) in sources.items():
        r = results[name]
        report.append({
            "name": name, "route": "cuda",
            "source": f"k_diffusion_tpu_torch/csrc/{src}",
            "replaces": f"k_diffusion_tpu/ops/pallas/{tpu}",
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
