"""Writes the config JSON out of an inference checkpoint's safetensors
metadata (counterpart of the JAX package's config_from_inference.py).

    python -m k_diffusion_tpu_torch.config_from_inference \\
        model.safetensors config.json
"""

import argparse
import json
from pathlib import Path

from .utils import get_safetensors_metadata


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("checkpoint", type=Path, help="the inference checkpoint")
    p.add_argument("output", type=Path, help="the output JSON file")
    args = p.parse_args(argv)

    metadata = get_safetensors_metadata(args.checkpoint)
    if "config" not in metadata:
        raise ValueError("no config found in checkpoint metadata")
    config = json.loads(metadata["config"])
    args.output.write_text(json.dumps(config, indent=4))
    print(f"Wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
