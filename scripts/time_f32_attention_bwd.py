"""Card time of the float32 attention backward (K14-f32, K9-f32, K7-f32 and
K12-f32: csrc/attn_tf32_bwd.cuh) at every shape its main paths give it.

Imports k_diffusion_tpu_torch from ``--root`` (by default this checkout),
so that two trees can be timed in one run on one card: unpack the other
tree into a directory that .gitignore lists and time them in turns, for
example

    git archive HEAD~1 k_diffusion_tpu_torch | tar -x -C .scratch/parent
    for r in .scratch/parent . . .scratch/parent; do
        python scripts/time_f32_attention_bwd.py --root $r; done

Each shape's backward (one wrapper call: the dq kernel, then the dk/dv
kernel) is timed by CUDA events over 20 calls queued behind a sleep on the
card, so that the events time the card and not the host's launch rate;
the median of 5 trials. Prints one JSON line: the root, the card's name
and power limit, and ms per call by shape.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch

    from k_diffusion_tpu_torch.ops.kernels import flash, global_packed, na2d

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    times = {}
    # K14-f32: the cifar10 U-Net's attention at batch 64 (16 x 16 and 8 x
    # 8), config_mnist.json's 7 x 7 and head dim 32; q, k, v strided thirds
    # of one projection
    for s, heads, e in ((256, 4, 64), (256, 2, 64), (64, 8, 64), (64, 4, 64),
                        (49, 4, 64), (256, 4, 32)):
        qkv = torch.randn((64, s, 3, heads, e), generator=g) * (64 / e) ** 0.5
        q, k, v = qkv.to(dev).unbind(2)
        dout = torch.randn((64, s, heads, e), generator=g).to(dev)
        out, lse = flash.flash_forward(q, k, v, 0.125, save_lse=True)
        times[f"K14-f32 64x{s}x{heads}x{e}"] = device_ms(
            lambda: flash.flash_backward(q, k, v, out, lse, dout, 0.125))
    # K9-f32: the shifted-window config's global level at batch 8
    q, k, v, dout = (torch.randn((8, 256, 512), generator=g).to(dev) * 0.3
                     for _ in range(4))
    out, lse = global_packed.packed_forward(q, k, v, 8, save_lse=True)
    times["K9-f32 8x256x512"] = device_ms(
        lambda: global_packed.packed_backward(q, k, v, out, lse, dout, 8))

    def maps(h, heads, e):
        t = torch.randn((8, h, h, 3, heads, e), generator=g)
        qk = t[:, :, :, :2] / t[:, :, :, :2].norm(dim=-1, keepdim=True)
        q, k, v = torch.cat([qk * 10 ** 0.5, t[:, :, :, 2:]], 3).to(
            dev).unbind(3)
        return (q.contiguous(), k.contiguous(), v,
                torch.randn((8, h, h, heads, e), generator=g).to(dev))

    # K7-f32 on the flagship's packed NA levels at batch 8; K12-f32 on
    # per-head maps (v strided) at head dims 64, 32 and 128
    for h, heads in ((64, 2), (32, 4)):
        m = [t.reshape(8, h, h, heads * 64).contiguous()
             for t in maps(h, heads, 64)]
        out, lse = na2d.packed_forward(*m[:3], heads, 7, save_lse=True)
        times[f"K7-f32 8x{h}x{h}x{heads * 64}"] = device_ms(
            lambda: na2d.packed_backward(*m[:3], out, lse, m[3], heads, 7))
    for h, heads, e in ((64, 2, 64), (32, 4, 64), (32, 4, 32), (64, 1, 128),
                        (32, 2, 128)):
        m = maps(h, heads, e)
        out, lse = na2d.heads_forward(*m[:3], 7, save_lse=True)
        times[f"K12-f32 8x{h}x{h}x{heads}x{e}"] = device_ms(
            lambda: na2d.heads_backward(*m[:3], out, lse, m[3], 7))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"root": root, "card": smi,
                      "ms": {k: round(v, 4) for k, v in times.items()}}))


if __name__ == "__main__":
    main()
