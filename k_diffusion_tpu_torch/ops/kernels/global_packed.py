"""K3: exact global attention on channel-packed maps (counterpart of
k_diffusion_tpu/ops/pallas/global_packed.py, forward only).

CUDA tensors go to the hand-written kernel in ``csrc/global_packed.cu``; CPU
tensors to ``reference``, the plain version.
"""

import ctypes

import torch

from ..attention import global_attention
from . import _build

launches = 0  # kernel launches since the last reset

MAX_SEQ = 512  # the kernel keeps a query strip's logits and K or V in smem

# q, k, v, out, batch, seq, heads, scale, stream
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_void_p]


def reference(q, k, v, n_heads, scale=1.0):
    """Plain version: softmax attention per head, q/k/v (b, s, heads * e)."""
    b, s, c = q.shape
    split = (b, s, n_heads, c // n_heads)
    out = global_attention(q.reshape(split), k.reshape(split),
                           v.reshape(split), scale)
    return out.reshape(b, s, c)


def packed_global_attention(q, k, v, n_heads, scale=1.0):
    """q, k, v (b, s, heads * e) -> (b, s, heads * e). The kernel takes
    bfloat16, e == 64 and s a multiple of 16 up to MAX_SEQ."""
    b, s, c = q.shape
    if q.device.type == "cpu":
        return reference(q, k, v, n_heads, scale)
    _build.require_cuda(q, "packed_global_attention")
    if c != 64 * n_heads or s % 16 or not 16 <= s <= MAX_SEQ:
        raise ValueError(
            f"global_packed kernel takes head dim 64 and s a multiple of 16 "
            f"up to {MAX_SEQ}; got {tuple(q.shape)} with {n_heads} heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.device, torch.bfloat16, (b, s, c))
    out = torch.empty_like(q)
    lib = _build.load("global_packed", kdt_global_packed=_SIGNATURE)
    status = lib.kdt_global_packed(*map(_build.ptr, (q, k, v, out)), b, s,
                                   n_heads, scale,
                                   _build.stream_ptr(q.device))
    _build.check_launch(lib, status, "global_packed")
    global launches
    launches += 1
    return out
