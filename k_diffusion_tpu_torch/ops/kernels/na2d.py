"""K2: channel-packed 2-D neighborhood attention (counterpart of
k_diffusion_tpu/ops/pallas/na2d.py: ``na2d_packed`` forward and
``na2d_reference``).

Each query attends to exactly kernel_size x kernel_size keys, its window
clamped inward at the edges (NATTEN's contract). CUDA tensors go to the
hand-written kernel in ``csrc/na2d.cu``; CPU tensors to the plain version.
"""

import ctypes

import torch

from ..attention import neighborhood_attention
from . import _build

launches = 0  # kernel launches since the last reset

TILE = 8          # query tile edge of the kernel
MAX_KERNEL = 7    # the kernel's halo holds windows up to 7 x 7

# q, k, v, out, batch, h, w, heads, kernel_size, scale, stream
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p]


def na2d_reference(q, k, v, kernel_size, scale=1.0):
    """Plain version: masked dense attention, q/k/v (b, h, w, heads, e)."""
    return neighborhood_attention(q, k, v, kernel_size, scale=scale)


def na2d_packed(q, k, v, n_heads, kernel_size, scale=1.0):
    """Neighborhood attention on channel-packed maps: q, k, v
    (b, h, w, heads * e) -> (b, h, w, heads * e). The kernel takes bfloat16,
    e == 64, h and w multiples of 8 and kernel_size <= min(7, h, w)."""
    b, h, w, c = q.shape
    e = c // n_heads
    if q.device.type == "cpu":
        split = (b, h, w, n_heads, e)
        out = na2d_reference(q.reshape(split), k.reshape(split),
                             v.reshape(split), kernel_size, scale)
        return out.reshape(b, h, w, c)
    _build.require_cuda(q, "na2d_packed")
    if e != 64 or h % TILE or w % TILE or not (
            1 <= kernel_size <= min(MAX_KERNEL, h, w)):
        raise ValueError(
            f"na2d kernel takes head dim 64, h and w multiples of {TILE} and "
            f"kernel_size <= min({MAX_KERNEL}, h, w); got {tuple(q.shape)} "
            f"with {n_heads} heads, kernel_size {kernel_size}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.device, torch.bfloat16, (b, h, w, c))
    out = torch.empty_like(q)
    lib = _build.load("na2d", kdt_na2d_packed=_SIGNATURE)
    status = lib.kdt_na2d_packed(*map(_build.ptr, (q, k, v, out)), b, h, w,
                                 n_heads, kernel_size, scale,
                                 _build.stream_ptr(q.device))
    _build.check_launch(lib, status, "na2d_packed")
    global launches
    launches += 1
    return out
