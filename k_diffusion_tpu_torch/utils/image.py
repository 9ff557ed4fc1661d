"""PNG files read and written with the standard library, and image grids
(counterpart of k_diffusion_tpu/utils/image.py, which goes through
Pillow; the port needs no Pillow).

``to_png`` maps values as the JAX package's ``to_pil_image`` does: clip to
[-1, 1], then ``round((x + 1) / 2 * 255)`` in float32, rounding half to
even. ``from_png`` reads 8-bit grey, grey + alpha, RGB and RGBA files,
not interlaced, under each of the five row filters.
"""

import struct
import zlib
from pathlib import Path

import numpy as np
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


def _filter_rows(pixels, kind):
    """(h, w, c) uint8 pixels -> (h, 1 + w * c) uint8 PNG rows, each under
    row filter ``kind`` (0 None, 1 Sub, 2 Up, 3 Avg, 4 Paeth) computed from
    the original bytes, as an encoder does."""
    h, w, c = pixels.shape
    x = pixels.reshape(h, w * c).int()
    if kind == 0:
        pred = torch.zeros_like(x)
    else:
        left = lambda t: torch.cat([torch.zeros_like(t[:, :c]), t[:, :-c]], 1)
        up = torch.cat([torch.zeros_like(x[:1]), x[:-1]])
        a, b, ul = left(x), up, left(up)
        if kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        elif kind == 4:
            pa, pb, pc = (b - ul).abs(), (a - ul).abs(), (a + b - 2 * ul).abs()
            pred = torch.where((pa <= pb) & (pa <= pc), a,
                               torch.where(pb <= pc, b, ul))
        else:
            raise ValueError(f"row filter {kind}: PNG defines 0 to 4")
    return torch.cat([torch.full((h, 1), kind, dtype=torch.int32),
                      (x - pred) % 256], 1).to(torch.uint8)


def to_png(x, path, row_filter=0):
    """Writes an image in [-1, 1] (HWC, 1HWC or HW; 1 to 4 channels) to
    ``path`` as an 8-bit PNG, every row under ``row_filter`` (0 None, 1
    Sub, 2 Up, 3 Avg, 4 Paeth). Returns the path."""
    pixels = _to_uint8(x)
    h, w, c = pixels.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"PNG takes 1 to 4 channels; got {c}")
    rows = _filter_rows(pixels, row_filter)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", zlib.compress(rows.numpy().tobytes(), 6))
           + _chunk(b"IEND", b""))
    Path(path).write_bytes(png)
    return Path(path)


_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {c: n for n, c in _COLOR_TYPES.items()}


def _chunks(data, path):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(kind, row, prior, bpp):
    """One row's bytes (uint8) reconstructed from its filtered bytes and
    the reconstructed row above. None, Sub and Up are numpy operations;
    Avg and Paeth, each byte depending on the one ``bpp`` to its left, are
    a Python loop."""
    if kind == 0:
        return row
    if kind == 1:  # Sub: a running sum mod 256 per byte of the pixel
        return (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint64)
                % 256).astype(np.uint8).reshape(-1)
    if kind == 2:  # Up
        return row + prior
    if kind not in (3, 4):
        raise ValueError(f"row filter {kind}: PNG defines 0 to 4")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if kind == 3:  # Avg
            out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, up[i], c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def from_png(path):
    """Reads a PNG file as a (h, w, c) uint8 numpy array, c = 1 (grey), 2
    (grey + alpha), 3 (RGB) or 4 (RGBA). Other bit depths, palettes and
    interlaced files raise ``ValueError`` naming what the file is."""
    data = Path(path).read_bytes()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} "
                         f"({'palette' if color == 3 else 'unknown'}); this "
                         f"reader takes grey, grey + alpha, RGB and RGBA")
    if depth != 8:
        raise ValueError(f"{path}: PNG of bit depth {depth}; this reader "
                         "takes 8 bits a sample")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG; this reader "
                         "takes non-interlaced files")
    c = _CHANNELS[color]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of rows for {w} x {h} "
                         f"x {c}")
    raw = raw.reshape(h, stride + 1)
    kinds = raw[:, 0]
    if not kinds.any():  # every row unfiltered, as to_png writes them
        return raw[:, 1:].reshape(h, w, c).copy()
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(kinds[y]), raw[y, 1:], prior, c)
    return out.reshape(h, w, c)


def to_rgb(pixels):
    """(h, w, c) pixels of 1 to 4 channels -> (h, w, 3), as Pillow's
    ``convert("RGB")``: grey repeated, alpha dropped."""
    if pixels.shape[-1] in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return pixels[..., :3]


def make_grid(x, nrow=8, padding=0, pad_value=0.0):
    """Tiles a (n, h, w, c) batch into one (h', w', c) image, ``nrow``
    images a row, as the JAX package's ``make_grid``."""
    x = torch.as_tensor(x)
    n, h, w, c = x.shape
    ncol = (n + nrow - 1) // nrow
    grid = torch.full((ncol * (h + padding) - padding,
                       nrow * (w + padding) - padding, c), pad_value,
                      dtype=x.dtype, device=x.device)
    for i in range(n):
        r, col = divmod(i, nrow)
        grid[r * (h + padding):r * (h + padding) + h,
             col * (w + padding):col * (w + padding) + w] = x[i]
    return grid
