"""Samples images from an inference checkpoint (counterpart of the JAX
package's ``sample.py``).

    python -m k_diffusion_tpu_torch.sample --checkpoint model.safetensors \\
        -n 64 --sampler lms --prefix out

Loads the safetensors checkpoint and its config (``checkpoint.py``; or
``--config``), builds the model on the card (bfloat16 compute), draws
random classes for a class-conditional model, runs the sampler by name
(``sampling.call_sampler``; LMS by default) on a Karras schedule and
writes ``{prefix}_{i:05}.png``. The HDiT runs on precomputed conditioning
(``condcache``) under the samplers that evaluate it only at schedule
sigmas; the U-Net goes through ``config.make_denoiser_wrapper``. It runs
on the card unless ``--device cpu`` asks for the CPU, and falls back to
nothing: with no card it raises, as it does where a kernel fails to build.
"""

import argparse
from pathlib import Path

import torch

from . import checkpoint, condcache, config, sampling, utils


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--batch-size", type=int, default=64,
                   help="the batch size")
    p.add_argument("--checkpoint", type=Path, required=True,
                   help="the (safetensors inference) checkpoint to use")
    p.add_argument("--config", type=Path,
                   help="the model config (default: the checkpoint's)")
    p.add_argument("-n", type=int, default=64,
                   help="the number of images to sample")
    p.add_argument("--prefix", type=str, default="out",
                   help="the output prefix")
    p.add_argument("--sampler", type=str, default="lms",
                   choices=sampling.SAMPLERS, help="the sampler")
    p.add_argument("--steps", type=int, default=50,
                   help="the number of denoising steps")
    p.add_argument("--seed", type=int, default=0, help="the random seed")
    p.add_argument("--device", type=str, default=None,
                   help="the device (default: the current CUDA device)")
    return p.parse_args(argv)


@torch.no_grad()
def sample(args):
    """Writes ``args.n`` PNGs; returns their paths."""
    device = utils.default_device(args.device)
    cfg = config.load_config(args.config or args.checkpoint)
    model_config = cfg["model"]
    h, w = model_config["input_size"]
    if h != w:
        raise ValueError(f"sample takes square images; the config's input "
                         f"size is {h} x {w}")
    model = config.make_model(cfg, device=device)
    state, _ = checkpoint.load_inference(args.checkpoint)
    model.load_state_dict(state)
    model.eval()
    print("Parameters:", f"{sum(p.numel() for p in model.parameters()):,}")
    wrap = config.make_denoiser_wrapper(cfg)
    sigma_max = model_config["sigma_max"]
    sigmas = sampling.get_sigmas_karras(args.steps, model_config["sigma_min"],
                                        sigma_max, rho=7.0, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    num_classes = cfg["dataset"]["num_classes"]
    use_condcache = (model_config["type"] == "image_transformer_v2"
                     and args.sampler in condcache.SCHEDULE_POINT_SAMPLERS)
    shape = (args.batch_size, h, w, model_config["input_channels"])

    print("Sampling...")
    paths = []
    while len(paths) < args.n:
        x = torch.randn(shape, generator=generator, device=device) * sigma_max
        # a class-conditional model: random classes, as the JAX sample.py
        classes = (torch.randint(0, num_classes, (args.batch_size,),
                                 generator=generator, device=device)
                   if num_classes else None)
        if use_condcache:
            # the classes are baked into the table
            inner = condcache.ScheduledModel(model, sigmas[:-1],
                                             args.batch_size,
                                             class_cond=classes)
            out = sampling.call_sampler(args.sampler, wrap(inner), x, sigmas,
                                        generator=generator)
            inner.check()
        else:
            extra = {} if classes is None else {"class_cond": classes}
            out = sampling.call_sampler(args.sampler, wrap(model), x, sigmas,
                                        extra_args=extra, generator=generator)
        for image in out[:args.n - len(paths)]:
            paths.append(utils.to_png(image, f"{args.prefix}_{len(paths):05}.png"))
    print(f"Wrote {len(paths)} images to {args.prefix}_*.png")
    return paths


def main(argv=None):
    return sample(parse_args(argv))


if __name__ == "__main__":
    main()
