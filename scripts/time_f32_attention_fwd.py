"""Card time of the float32 attention forward (K13-f32, K3-f32, K2-f32,
K11-f32 and K15-f32: csrc/attn_tf32.cuh's body) at every shape its main
paths give it.

Imports k_diffusion_tpu_torch from ``--root`` (by default this checkout),
so that two trees can be timed in one run on one card: unpack the other
tree into a directory that .gitignore lists and time them in turns, for
example

    git archive HEAD~1 k_diffusion_tpu_torch | tar -x -C .scratch/parent
    for r in .scratch/parent . . .scratch/parent; do
        python scripts/time_f32_attention_fwd.py --root $r; done

Each shape's forward (one wrapper call, with or without the lse as its
main path calls it) is timed by CUDA events over 20 calls queued behind a
sleep on the card, the median of 5 trials. With ``--check`` each output
(out, and lse where the call writes it) is first held against the plain
version in float32 with TF32 off, within 5e-3 x max|plain|, and a rerun
against the first call bit for bit. Prints one JSON line: the root, the
card's name and power limit, ms per call by shape and, with ``--check``,
the worst error by shape as a share of max|plain|.
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
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from k_diffusion_tpu_torch.ops.attention import neighborhood_mask_2d
    from k_diffusion_tpu_torch.ops.kernels import flash, global_packed, na2d

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    times, errors = {}, {}

    def dense_lse(q, k, scale):
        logits = torch.einsum("bqne,bkne->bnqk", q, k) * scale
        return torch.logsumexp(logits, -1)

    def na_lse(q, k):
        b, h, w, heads, e = q.shape
        mask = neighborhood_mask_2d(h, w, 7, q.device)
        return torch.stack([torch.logsumexp(torch.einsum(
            "qne,kne->nqk", q[i].reshape(h * w, heads, e),
            k[i].reshape(h * w, heads, e)).masked_fill(~mask, float("-inf")),
            -1).reshape(heads, h, w) for i in range(b)])

    def case(name, timed, checked=None, plain=None):
        """Times ``timed``; with --check first holds ``checked`` (the same
        call with its lse) against ``plain`` and a rerun of itself."""
        if args.check and plain is not None:
            got, want, again = checked(), plain(), checked()
            worst = 0.0
            for a, b_, c in zip(got, want, again):
                a = a.reshape(b_.shape)
                share = ((a - b_).abs().max() / b_.abs().max()).item()
                if not share <= 5e-3:
                    raise AssertionError(f"{name}: {share:.3e} x max|plain|")
                if not torch.equal(a, c.reshape(b_.shape)):
                    raise AssertionError(f"{name}: a rerun differs")
                worst = max(worst, share)
            errors[name] = worst
            del got, want, again
        times[name] = device_ms(timed)

    # K13-f32: the cifar10 U-Net's attention at batch 64 (16 x 16 and 8 x
    # 8), config_mnist.json's 7 x 7 and head dim 32; q, k, v strided thirds
    # of one projection; no lse (sampling)
    for s, heads, e in ((256, 4, 64), (256, 2, 64), (64, 8, 64), (64, 4, 64),
                        (49, 4, 64), (256, 4, 32)):
        qkv = torch.randn((64, s, 3, heads, e), generator=g) * (64 / e) ** 0.5
        q, k, v = qkv.to(dev).unbind(2)
        case(f"K13-f32 64x{s}x{heads}x{e}",
             lambda: flash.flash_forward(q, k, v, 0.125),
             lambda: flash.flash_forward(q, k, v, 0.125, save_lse=True),
             lambda: (flash.reference(q, k, v, 0.125),
                      dense_lse(q, k, 0.125)))
    # K3-f32: the shifted-window config's global level at batch 8
    q, k, v = (torch.randn((8, 256, 512), generator=g).to(dev) * 0.3
               for _ in range(3))
    split = [t.reshape(8, 256, 8, 64) for t in (q, k, v)]
    case("K3-f32 8x256x512",
         lambda: global_packed.packed_forward(q, k, v, 8),
         lambda: global_packed.packed_forward(q, k, v, 8, save_lse=True),
         lambda: (global_packed.reference(q, k, v, 8),
                  dense_lse(*split[:2], 1.0)))

    def maps(h, heads, e):
        t = torch.randn((8, h, h, 3, heads, e), generator=g)
        qk = t[:, :, :, :2] / t[:, :, :, :2].norm(dim=-1, keepdim=True)
        q, k, v = torch.cat([qk * 10 ** 0.5, t[:, :, :, 2:]], 3).to(
            dev).unbind(3)
        return q.contiguous(), k.contiguous(), v

    # K2-f32 on the flagship's packed NA levels at batch 8 (sampling: no
    # lse) and config_512_hdit's 128 x 128 level (no check: the plain
    # version's dense logits); K11-f32 on per-head maps (v strided) at head
    # dims 64 and 32 (the unfused step: with lse) and 128 (no lse)
    for h, heads, check in ((64, 2, True), (32, 4, True), (128, 2, False)):
        m = [t.reshape(8, h, h, heads * 64).contiguous()
             for t in maps(h, heads, 64)]
        sp = [t.reshape(8, h, h, heads, 64) for t in m]
        case(f"K2-f32 8x{h}x{h}x{heads * 64}",
             lambda: na2d.packed_forward(*m, heads, 7),
             lambda: na2d.packed_forward(*m, heads, 7, save_lse=True),
             (lambda: (na2d.reference(*m, heads, 7), na_lse(*sp[:2])))
             if check else None)
    for h, heads, e in ((64, 2, 64), (32, 4, 64), (32, 4, 32), (64, 1, 128),
                        (32, 2, 128)):
        m = maps(h, heads, e)
        checked = lambda: na2d.heads_forward(*m, 7, save_lse=True)
        case(f"K11-f32 8x{h}x{h}x{heads}x{e}",
             checked if e < 128 else lambda: na2d.heads_forward(*m, 7),
             checked, lambda: (na2d.na2d_reference(*m, 7), na_lse(*m[:2])))
    # K15-f32: one op call at each flagship NA level and at head dim 32
    for h, c, e in ((64, 128, 64), (32, 256, 64), (64, 128, 32)):
        t = torch.randn((2, 8, h, h, c // e, e), generator=g)
        q, k = (t / t.norm(dim=-1, keepdim=True) * 10 ** 0.5).reshape(
            2, 8, h, h, c).to(dev)
        v, skip = (torch.randn((8, h, h, c), generator=g).to(dev)
                   for _ in range(2))
        w = (torch.randn((c, c), generator=g) * c ** -0.5).to(dev)
        call = lambda: (na2d.proj_forward(q, k, v, skip, w, c // e, 7),)
        case(f"K15-f32 8x{h}x{h}x{c} e={e}", call, call,
             lambda: (na2d.proj_reference(q, k, v, skip, w, c // e, 7),))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    line = {"root": root, "card": smi,
            "ms": {k: round(v, 4) for k, v in times.items()}}
    if args.check:
        line["err"] = {k: float(f"{v:.3e}") for k, v in errors.items()}
    print(json.dumps(line))


if __name__ == "__main__":
    main()
