"""Card time of the float32 forwards of the attention prologue (K1-f32,
csrc/fused_qkv_f32.cu), the feed-forward block (K4-f32, csrc/geglu_f32.cu,
in one launch and on its wide route) and the mapping network (K5-f32, the
same file) at the shapes their main paths give them, each held against its
plain version with TF32 off and against a rerun of itself.

Imports k_diffusion_tpu_torch from ``--root`` (by default this checkout),
so that two trees can be timed in one run on one card: unpack the other
tree into a directory that .gitignore lists and time them in turns, for
example

    git archive HEAD~1 k_diffusion_tpu_torch | tar -x -C .scratch/parent
    for r in .scratch/parent . . .scratch/parent; do
        python scripts/time_f32_forwards.py --root $r; done

Each shape's forward (one wrapper call, its weight-rounding passes
included) is timed by CUDA events over 20 calls queued behind a sleep on
the card, so that the events time the card and not the host's launch
rate; the median of 5 trials. ``--only K5`` (or K1, K4) times those
kernels' shapes alone, ``--only hdit512`` a float32 denoiser call of
config_512_hdit at batch 8 (TF32 on). With ``--check`` each kernel's
output is also held within 5e-3 x max|plain| of the plain version (TF32
off) and a rerun to bit-equality. Prints one JSON line: the root, the
card's name and power limit, and ms per call by shape (and the worst error
share with ``--check``).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

# the float32 kernels' bound against their plain versions, TF32 off
REL_BOUND = 5e-3
# (label, b, h, w, d, heads): the flagship's three levels at batch 8,
# config_test_tiny's head dim 32 and a ragged 7 x 7 image at d = 256
QKV_SHAPES = (("8x64x64x128", 8, 64, 64, 128, 2),
              ("8x32x32x256", 8, 32, 32, 256, 4),
              ("8x16x16x512", 8, 16, 16, 512, 8),
              ("8x8x8x64 e=32", 8, 8, 8, 64, 2),
              ("8x7x7x256", 8, 7, 7, 256, 4))
# (label, b, tokens, d, d_ff): the same levels, config_mnist_transformer's
# 49 tokens at d = 256, config_512_hdit's 768 level and a width of 960 (the
# wide route)
FFN_SHAPES = (("8x4096x128 f=384", 8, 4096, 128, 384),
              ("8x1024x256 f=768", 8, 1024, 256, 768),
              ("8x256x512 f=1536", 8, 256, 512, 1536),
              ("8x64x64 f=192", 8, 64, 64, 192),
              ("8x49x256 f=768", 8, 49, 256, 768),
              ("8x256x768 f=2304", 8, 256, 768, 2304),
              ("8x256x960 f=1920", 8, 256, 960, 1920))
# the batch of the config_512_hdit call (``--only hdit512``)
CALL_BATCH = 8
# (label, b, d, d_ff, blocks): the HDiT's mapping network at batch 8 and
# the ViT's (DiT-B/2's width) at 64
MAP_SHAPES = (("8x256 f=768", 8, 256, 768, 2),
              ("64x768 f=2048", 64, 768, 2048, 2))


def device_ms(fn, reps=20):
    import torch

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


def check(label, run, plain):
    """The worst output's max abs error over its max|plain| (TF32 off);
    raises past REL_BOUND or if a rerun differs."""
    import torch

    got, again = run(), run()
    torch.backends.cuda.matmul.allow_tf32 = False
    want = plain()
    worst = 0.0
    for i, (a, b, w) in enumerate(zip(got, again, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: output {i} of a rerun differs")
        share = ((a - w).abs().max() / w.abs().max()).item()
        if not share <= REL_BOUND:
            raise AssertionError(f"{label}: output {i} off by {share:.3e} "
                                 f"x max|plain|")
        worst = max(worst, share)
    return worst


def hdit512_call(dev, g):
    """One denoiser call of configs/config_512_hdit.json (this checkout's)
    built in float32 on the card from seeded weights at batch CALL_BATCH,
    TF32 on: its 768-wide level runs K4-f32's wide route, its mapping
    network K5-f32."""
    import torch

    import k_diffusion_tpu_torch as KT

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "configs", "config_512_hdit.json")
    config = KT.config.load_config(path)
    model = KT.config.make_model(config, dtype=torch.float32, device=dev,
                                 generator=torch.Generator(dev).manual_seed(0))
    den = KT.config.make_denoiser_wrapper(config)(model.eval())
    size = config["model"]["input_size"]
    x = torch.randn((CALL_BATCH, *size, config["model"]["input_channels"]),
                    generator=g).to(dev)
    sigma = torch.linspace(0.5, 8.0, CALL_BATCH).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return lambda: den(x, sigma)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--only", nargs="*", default=["K1", "K4", "K5"],
                    help="what to time: K1, K4, K5 (their shapes), hdit512 "
                         "(a config_512_hdit call)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from k_diffusion_tpu_torch.ops import rope
    from k_diffusion_tpu_torch.ops.kernels import (fused_ffn, fused_mapping,
                                                   fused_qkv)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, std=1.0, shift=0.0):
        return (torch.randn(shape, generator=g) * std + shift).to(dev)

    times, errors = {}, {}
    with torch.no_grad():
        if "K1" in args.only:
            for label, b, h, w, d, heads in QKV_SHAPES:
                x, ns = rnd(b, h, w, d), rnd(b, d, std=0.1, shift=1.0)
                wq = rnd(d, 3 * d, std=d ** -0.5)
                scale = (10 * (1 + 0.1 * torch.randn(heads, generator=g))
                         ).to(dev)
                pos = rope.make_axial_pos(h, w, device=dev)
                call = (x, pos, ns, wq, scale, heads)
                run = lambda c=call: fused_qkv.prologue_forward(*c)
                if args.check:
                    errors[f"K1-f32 {label}"] = check(
                        label, run, lambda c=call: fused_qkv.reference(*c))
                times[f"K1-f32 {label}"] = device_ms(run)
        if "K4" in args.only:
            for label, b, t, d, d_ff in FFN_SHAPES:
                call = (rnd(b, t, d), rnd(b, d, std=0.1, shift=1.0),
                        rnd(d, 2 * d_ff, std=d ** -0.5),
                        rnd(d_ff, d, std=d_ff ** -0.5))
                run = lambda c=call: (fused_ffn.ffn_forward(*c),)
                if args.check:
                    errors[f"K4-f32 {label}"] = check(
                        label, run, lambda c=call: (fused_ffn.reference(*c),))
                times[f"K4-f32 {label}"] = device_ms(run)
        if "K5" in args.only:
            for label, b, d, d_ff, n in MAP_SHAPES:
                blocks = [(rnd(d, std=0.1, shift=1.0),
                           rnd(d, 2 * d_ff, std=d ** -0.5),
                           rnd(d_ff, d, std=d_ff ** -0.5)) for _ in range(n)]
                call = (rnd(b, d), rnd(d, std=0.1, shift=1.0),
                        rnd(d, std=0.1, shift=1.0), blocks)
                run = lambda c=call: (fused_mapping.mapping_forward(
                    *c, dtype=torch.float32),)
                if args.check:
                    errors[f"K5-f32 {label}"] = check(
                        label, run, lambda c=call: (fused_mapping.reference(
                            *c, dtype=torch.float32),))
                times[f"K5-f32 {label}"] = device_ms(run)
        if "hdit512" in args.only:
            times[f"config_512_hdit call at {CALL_BATCH}"] = device_ms(
                hdit512_call(dev, g), reps=5)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = {"root": root, "card": smi, "ms": times}
    if args.check:
        line["max_err_over_max_plain"] = errors
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
