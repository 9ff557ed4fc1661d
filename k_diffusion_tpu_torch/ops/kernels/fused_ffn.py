"""K4: the fused AdaRMSNorm + GEGLU feed-forward block (counterpart of
k_diffusion_tpu/ops/pallas/fused_ffn.py, forward only).

``x + down(GEGLU(up(AdaRMSNorm(x, scale))))``. On CUDA tensors this is two
launches of the kernels in ``csrc/geglu.cu``: norm -> up -> GEGLU writes the
bfloat16 hidden activation, then down + residual reads it back. CPU tensors
go to ``reference``, the plain version.
"""

import ctypes

import torch

from ..geglu import linear_geglu
from ..norms import rms_norm
from . import _build

launches = 0  # wrapper calls that launched the kernels, since the last reset

# x, scale, w_up, h, rows, tokens, d, d_ff, eps, stream
_UP = [ctypes.c_void_p] * 4 + [ctypes.c_long] + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_void_p]
# h, w_down, x, out, rows, d, d_ff, stream
_DOWN = [ctypes.c_void_p] * 4 + [ctypes.c_long] + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]


def reference(x, scale, w_up, w_down, eps=1e-6):
    """Plain version. x (b, t, d); scale (b, d); w_up (d, 2 d_ff);
    w_down (d_ff, d)."""
    xn = rms_norm(x, scale[:, None, :], eps)
    return x + linear_geglu(xn, w_up.to(x.dtype)) @ w_down.to(x.dtype)


def fused_geglu_ffn(x, scale, w_up, w_down, eps=1e-6):
    """x (b, t, d); scale (b, d) = AdaRMSNorm proj(cond) + 1; w_up
    (d, 2 d_ff); w_down (d_ff, d). Returns x + FFN(norm(x)). The kernels
    take bfloat16 x and scale with d and d_ff multiples of 64; the weights
    are cast to x's dtype, as the JAX dispatcher does."""
    if x.device.type == "cpu":
        return reference(x, scale, w_up, w_down, eps)
    _build.require_cuda(x, "fused_geglu_ffn")
    b, t, d = x.shape
    d_ff = w_down.shape[0]
    if d % 64 or d_ff % 64:
        raise ValueError(f"fused_ffn kernels take d and d_ff multiples of 64; "
                         f"got d={d}, d_ff={d_ff}")
    dev, bf16 = x.device, torch.bfloat16
    w_up, w_down = w_up.to(bf16), w_down.to(bf16)
    _build.require(x, "x", dev, bf16, (b, t, d))
    _build.require(scale, "scale", dev, bf16, (b, d))
    _build.require(w_up, "w_up", dev, bf16, (d, 2 * d_ff))
    _build.require(w_down, "w_down", dev, bf16, (d_ff, d))
    hidden = torch.empty((b, t, d_ff), device=dev, dtype=bf16)
    out = torch.empty_like(x)
    lib = _build.load("geglu", kdt_ffn_up=_UP, kdt_ffn_down=_DOWN)
    stream = _build.stream_ptr(dev)
    status = lib.kdt_ffn_up(*map(_build.ptr, (x, scale, w_up, hidden)),
                            b * t, t, d, d_ff, eps, stream)
    _build.check_launch(lib, status, "fused_ffn up")
    status = lib.kdt_ffn_down(*map(_build.ptr, (hidden, w_down, x, out)),
                              b * t, d, d_ff, stream)
    _build.check_launch(lib, status, "fused_ffn down")
    global launches
    launches += 1
    return out
