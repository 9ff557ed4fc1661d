"""Images in [-1, 1] to PNG files, written with the standard library
(counterpart of ``to_pil_image`` in k_diffusion_tpu/utils/image.py, which
goes through Pillow).

Values map as the JAX package maps them: clip to [-1, 1], then
``round((x + 1) / 2 * 255)`` in float32, rounding half to even.
"""

import struct
import zlib
from pathlib import Path

import torch

# PNG colour types by channel count: grey, grey + alpha, RGB, RGBA
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}


def _to_uint8(x):
    """Float (h, w, c), (1, h, w, c) or (h, w) in [-1, 1] -> uint8 (h, w,
    c) on the CPU, as ``to_pil_image`` computes it."""
    x = torch.as_tensor(x).detach().to("cpu", torch.float32)
    if x.ndim == 4:
        if x.shape[0] != 1:
            raise ValueError(f"one image at a time; got a batch of {x.shape[0]}")
        x = x[0]
    if x.ndim == 2:
        x = x[..., None]
    x = (x.clamp(-1, 1) + 1) / 2
    return (x * 255).round().to(torch.uint8)


def _chunk(kind, data):
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def to_png(x, path):
    """Writes an image in [-1, 1] (HWC, 1HWC or HW; 1 to 4 channels) to
    ``path`` as an 8-bit PNG. Returns the path."""
    pixels = _to_uint8(x)
    h, w, c = pixels.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"PNG takes 1 to 4 channels; got {c}")
    rows = torch.cat([torch.zeros((h, 1), dtype=torch.uint8),
                      pixels.reshape(h, w * c)], dim=1)  # filter 0 a row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", zlib.compress(rows.numpy().tobytes(), 6))
           + _chunk(b"IEND", b""))
    Path(path).write_bytes(png)
    return Path(path)
