"""Converts a training checkpoint to a safetensors inference checkpoint of
its EMA weights, with the config in the metadata (counterpart of the JAX
package's convert_for_inference.py).

    python -m k_diffusion_tpu_torch.convert_for_inference \\
        model_00010000.ckpt model.safetensors
"""

import argparse
from pathlib import Path

import torch

from . import checkpoint


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("checkpoint", type=Path, help="the training checkpoint")
    p.add_argument("output", type=Path, help="the output safetensors file")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float16", "bfloat16", "float32"],
                   help="the output dtype")
    args = p.parse_args(argv)

    payload = torch.load(args.checkpoint, map_location="cpu",
                         weights_only=True)
    config = payload["host"].get("config")
    if not config:
        raise ValueError(f"{args.checkpoint} has no config in its host "
                         "state")
    checkpoint.save_inference(args.output, payload["model_ema"], config,
                              dtype=args.dtype)
    print(f"Wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
