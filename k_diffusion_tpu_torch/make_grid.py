"""Tiles PNG images into one grid PNG (counterpart of the JAX package's
make_grid.py).

    python -m k_diffusion_tpu_torch.make_grid out_*.png -o grid.png
"""

import argparse
import math
from pathlib import Path

import numpy as np

from .utils import image


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("images", type=Path, nargs="+", help="the input images")
    p.add_argument("--output", "-o", type=Path, default=Path("grid.png"),
                   help="the output image")
    p.add_argument("--nrow", type=int, help="the number of images per row")
    args = p.parse_args(argv)

    x = np.stack([image.to_rgb(image.from_png(path)).astype(np.float32)
                  / 127.5 - 1 for path in args.images])
    nrow = args.nrow if args.nrow else math.ceil(len(x) ** 0.5)
    image.to_png(image.make_grid(x, nrow=nrow), args.output)
    print(f"Wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main()
